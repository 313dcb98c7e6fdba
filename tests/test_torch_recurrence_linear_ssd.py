"""zamba2's training step is linear in the sequence on a mesh: Mamba2's
SSD takes its per-chunk states from one ``unbind`` (see
``tests/test_torch_recurrence_linear.py``).  The reduced zamba2 (two
units, SSM chunks of one token, as the sweep reduces it) traced on a
fake 16x16 world at 16, 32 and 64 tokens: the liveness peak and the
bytes a device grow by at most 2.3x per doubling."""
import pytest

from repro_torch.launch import dryrun

from test_torch_recurrence_linear import GROWTH, growth


@pytest.fixture(scope="module", autouse=True)
def _fake_world_torn_down():
    yield
    dryrun.end_fake_world()


def test_zamba2_training_step_grows_linearly():
    for name, g in growth("zamba2-7b", (16, 32, 64)).items():
        assert max(g) <= GROWTH, (name, g)
