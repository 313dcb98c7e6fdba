"""The dry run's lowering (``repro_torch.launch.dryrun``) on fake worlds
of 256 and 512 ranks: the counterpart of the reference's
``test_production_mesh_lowering_subprocess`` and
``test_dryrun_results_complete_and_clean``.

* A reduced yi-9b train step lowered on the real 16x16 and 2x16x16
  meshes: FLOPs above 0, the memory split present, the traced graph's
  argument bytes equal to ``cell_record``'s bytes per device, and
  collectives of the kinds FSDP and TP issue.
* The depth and sequence plans (``depth_plan``, ``seq_plan``); the
  extensions themselves are held in ``tests/test_torch_dryrun_extend.py``.
* ``lower_stencil`` for every paper stencil on both stencil meshes, and
  the plan's exchange bytes and rounds per rank equal to what a gloo
  world of eight CPU ranks counts in ``halo.EXCHANGE`` on small grids
  (``tests/_dist_world.py`` suite ``exchange``).
* ``load_results``/``save_results`` resuming a sweep through ``main``.

Every arch x cell on both meshes is ``tests/test_torch_dryrun_sweep.py``.
The fake world is this process's and is torn down when the module ends.
"""
import dataclasses
import importlib.util
import json
import os

import pytest
import torch

from repro_torch.core import PAPER_PIPELINES, PAPER_STENCILS
from repro_torch.launch import dryrun
from repro_torch.sharding import MeshShape

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _fake_world_torn_down():
    yield
    dryrun.end_fake_world()


def _one_unit(cfg):
    return dataclasses.replace(cfg.reduced(), n_layers=cfg.unit)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_yi9b_train_step_on_production_mesh(multi_pod):
    rec = dryrun.lower_cell("yi-9b", "train_4k", multi_pod,
                            shrink=_one_unit)
    assert rec["status"] == "ok"
    assert rec["devices"] == (512 if multi_pod else 256)
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    mem = rec["memory"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "alias_size_in_bytes", "temp_size_in_bytes",
                        "peak_bytes"}
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"] > 0
    # the params and optimizer state are updated in place: aliases
    assert mem["alias_size_in_bytes"] > 0
    want = dryrun.cell_record("yi-9b", "train_4k", multi_pod,
                              shrink=_one_unit)["bytes_per_device"]
    assert mem["argument_size_in_bytes"] == want["total"]
    assert rec["resident_bytes"] == want
    ops = rec["collective_ops"]
    assert {"all-gather", "reduce-scatter"} <= set(ops)
    assert rec["collective_bytes_per_device"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    for k in ("t_compute_s", "t_memory_s", "t_collective_s", "trace_s",
              "walk_s", "model_flops", "useful_flops_ratio"):
        assert rec[k] > 0, k


def test_depth_plan():
    from repro_torch.configs import get_config
    assert dryrun.depth_plan(get_config("qwen3-14b")) == (1, 2, 39)
    assert dryrun.depth_plan(get_config("gemma2-27b")) == (2, 4, 22)
    assert dryrun.depth_plan(get_config("zamba2-7b")) == (9, 15, 12)
    assert dryrun.depth_plan(get_config("xlstm-125m")) is None
    assert dryrun.depth_plan(get_config("whisper-tiny")) is None
    pod = dryrun.production_mesh_shape()
    cfg = get_config("xlstm-125m")
    assert dryrun.seq_plan(cfg, dryrun.CELLS["train_4k"], pod) == (128, 32)
    assert dryrun.seq_plan(cfg, dryrun.CELLS["prefill_32k"], pod) == \
        (128, 256)
    assert dryrun.seq_plan(cfg, dryrun.CELLS["decode_32k"], pod) is None
    assert dryrun.seq_plan(get_config("qwen3-14b"), dryrun.CELLS[
        "train_4k"], pod) is None


@pytest.mark.parametrize("name", list(PAPER_STENCILS))
@pytest.mark.parametrize("multi_pod", [False, True])
def test_lower_stencil_every_paper_stencil(name, multi_pod):
    rec = dryrun.lower_stencil(name, multi_pod)
    spec = PAPER_STENCILS[name]
    mesh = dryrun.stencil_mesh_shape(spec.ndim, multi_pod=multi_pod)
    assert rec["status"] == "ok" and rec["devices"] == mesh.size
    assert rec["cell"] == "x".join(map(str, dryrun.STENCIL_DOMAINS[
        spec.ndim]))
    points = 1
    for n in rec["shard"]:
        points *= n
    assert rec["flops_per_device"] == \
        spec.structured_flops_per_point() * points * 2
    assert rec["bytes_per_device"] >= 2 * 2 * points * 4
    assert rec["exchange_rounds"] > 0
    assert rec["collective_bytes_per_device"] == \
        rec["exchange_bytes_by_rank"]["max"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")


@pytest.fixture(scope="module")
def gloo_exchange(tmp_path_factory):
    world = _load("_dist_world")
    out = str(tmp_path_factory.mktemp("exchange"))
    return world, world.run_world("exchange", 8, out, timeout=300)


def test_exchange_bytes_match_a_gloo_world(gloo_exchange):
    import repro_torch as rt
    world, ranks = gloo_exchange
    covered = set()
    for key, desc, shape, mshape, axes, sweeps in world.EXCHANGE_CASES:
        spec = world.build_spec(desc, rt)
        if desc[0] == "stencil":
            covered.add(desc[1])
        mesh = MeshShape(mshape, ("sx", "sy", "sz")[:len(mshape)])
        counts = dryrun.stencil_counts(spec, shape, mesh, axes, 2,
                                       sweeps=sweeps)
        by_rank = {x["rank"]: x for x in counts["per_rank"]}
        for rec in ranks:
            got = rec["cases"][key]
            want = by_rank[rec["rank"]]
            assert got["coord"] == {a: c for a, c in zip(
                mesh.axis_names, divmod_coords(rec["rank"], mshape))}
            assert (got["rounds"], got["bytes_sent"]) == \
                (want["rounds"], want["bytes_sent"]), (key, rec["rank"])
    assert covered == set(PAPER_STENCILS)
    assert "reaction_diffusion2d" in PAPER_PIPELINES


def divmod_coords(rank, shape):
    out = []
    for n in reversed(shape):
        rank, c = divmod(rank, n)
        out.append(c)
    return out[::-1]


def test_main_resumes(tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "dry.json")
    dryrun.main(["--arch", "stencils", "--mesh", "pod", "--out", out])
    first = dryrun.load_results(out)
    assert len(first) == len(PAPER_STENCILS)
    assert all(r["status"] == "ok" for r in first.values())
    calls = []
    monkeypatch.setattr(dryrun, "lower_stencil",
                        lambda *a, **k: calls.append(a) or {})
    dryrun.main(["--arch", "stencils", "--mesh", "pod", "--out", out])
    assert calls == []                     # every record kept
    assert dryrun.load_results(out) == first
    # an error record is retried, and a failing job exits 1
    key = sorted(first)[0]
    first[key] = {**first[key], "status": "error", "error": "x"}
    dryrun.save_results(out, first)

    def boom(*a, **k):
        raise RuntimeError("no plan")
    monkeypatch.setattr(dryrun, "lower_stencil", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "stencils", "--mesh", "pod", "--out", out])
    assert e.value.code == 1
    again = dryrun.load_results(out)
    assert again[key]["status"] == "error"
    assert "no plan" in again[key]["error"]
    assert sum(r["status"] == "ok" for r in again.values()) == \
        len(PAPER_STENCILS) - 1
    with open(out) as f:
        assert [dryrun._key(r) for r in json.load(f)] == sorted(again)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("variant", ["baseline", "flashdecode"])
def test_resume_key_matches_cell_record(multi_pod, variant):
    # main skips a job by its probe's key, so the probe must name the mesh
    # as the records do
    rec = dryrun.cell_record("yi-9b", "decode_32k", multi_pod, variant)
    probe = dryrun._probe(("lm", "yi-9b", "decode_32k", multi_pod, variant,
                           False))
    assert dryrun._key(probe) == dryrun._key(rec)
    assert rec["mesh"].startswith("pod2x16x16" if multi_pod else "pod16x16")
    assert rec["mesh"].endswith("" if variant == "baseline"
                                else f"+{variant}")


def test_fake_world_refuses_a_real_group_and_resizes():
    import torch.distributed as dist
    dryrun.fake_world(8)
    assert dist.get_world_size() == 8 and dist.get_backend() == "fake"
    dryrun.fake_world(16)
    assert dist.get_world_size() == 16
    dryrun.end_fake_world()
    assert not dist.is_initialized()
    assert torch.distributed.is_available()
