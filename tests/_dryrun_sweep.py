"""Every arch x shape cell of the dry run on a production mesh
(``pod16x16``, 256 fake ranks: ``tests/test_torch_dryrun_sweep.py``;
``pod2x16x16``, 512: ``tests/test_torch_dryrun_sweep_multipod.py``), at
reduced width and depth on small cells of the same kinds: each record
``ok`` or ``skipped`` exactly as ``cell_supported`` says, with FLOPs,
bytes and a memory split where ``ok``.

``KNOWN_ERRORS`` holds a record that stops, by its cell and a piece of
its error, so that a fix shows here (``"fixed: update"``); it is empty.
The reduced Whisper's training step on the 512-rank mesh stopped there
until its token embedding moved to the vocabulary-parallel lookup (its
backward asked DTensor to move a gradient from ``Partial(avg)`` to
``Partial(sum)``).

The sizes: the reduced configs (``ModelConfig.reduced``) at one unit of
depth (zamba2 at its two units, xLSTM at two layers, one of them sLSTM,
Whisper at one encoder and one decoder layer), SSM chunks of one, and
cells of 16 tokens (32 rows; one for ``long_500k``): the sequence dim is
split 16 ways on the model axis in training.  About three minutes
serial a mesh, two of them zamba2's (its 16 one-token SSD chunks).
"""
import dataclasses

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import CELLS, cell_supported
from repro_torch.models.registry import ShapeCell, family_impl

SMALL = {name: ShapeCell(name, 16, 1 if name == "long_500k" else 32,
                         cell.kind) for name, cell in CELLS.items()}
KNOWN_ERRORS: dict = {}


def shrink(cfg):
    r = cfg.reduced()
    fam = family_impl(r)
    if fam == "transformer":
        r = dataclasses.replace(r, n_layers=r.unit)
    elif fam == "xlstm":
        r = dataclasses.replace(r, n_layers=2, slstm_layers=(1,))
    elif fam == "whisper":
        r = dataclasses.replace(r, n_layers=1, encoder_layers=1)
    if r.ssm is not None:
        r = dataclasses.replace(r, ssm=dataclasses.replace(r.ssm, chunk=1))
    return r


def check_every_cell(arch, multi_pod):
    for name, cell in CELLS.items():
        cfg = dryrun.VARIANTS["baseline"](dryrun._cfg_for(arch, name))
        supported = cell_supported(cfg, cell)[0]
        try:
            rec = dryrun.lower_cell(arch, name, multi_pod, shrink=shrink,
                                    cell=SMALL[name])
        except Exception as e:              # main records it as an error
            known = KNOWN_ERRORS.get((arch, name, multi_pod))
            assert known is not None and known in str(e), (arch, name, e)
            continue
        assert (arch, name, multi_pod) not in KNOWN_ERRORS, "fixed: update"
        assert rec["status"] == ("ok" if supported else "skipped"), (
            arch, name, rec)
        if not supported:
            assert rec["reason"] == cell_supported(cfg, cell)[1]
            continue
        assert rec["mesh"] == ("pod2x16x16" if multi_pod else "pod16x16")
        assert rec["flops_per_device"] > 0, (arch, name)
        assert rec["bytes_per_device"] > 0
        assert rec["memory"]["peak_bytes"] >= \
            rec["memory"]["argument_size_in_bytes"] > 0
        assert get_config(arch).arch == arch
