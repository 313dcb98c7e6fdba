"""Every arch x shape cell of the dry run on ``pod16x16`` (256 fake ranks)
at reduced size: ``tests/_dryrun_sweep.py`` (sizes, the one known
error)."""
import importlib.util
import os

import pytest

from repro_torch.configs import ARCH_IDS
from repro_torch.launch import dryrun

_spec = importlib.util.spec_from_file_location(
    "_dryrun_sweep", os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "_dryrun_sweep.py"))
sweep = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sweep)


@pytest.fixture(scope="module", autouse=True)
def _fake_world_torn_down():
    yield
    dryrun.end_fake_world()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_cell(arch):
    sweep.check_every_cell(arch, multi_pod=False)
