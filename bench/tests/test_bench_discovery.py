"""Cells, configurations, traffic kinds and readers are found by name."""
import json
import shutil

import pytest

import _tiny
import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = harness.find_cell(name)
    assert cell.params["config"] == cell.entry["config"]
    assert cell.config["name"] == cell.entry["config"]
    for fn in ("setup", "window", "finish", "verify", "inputs", "answers"):
        assert callable(getattr(cell.traffic, fn))
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]).read)


def test_every_name_keeps_to_the_contract():
    ok = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
             "0123456789_.-")
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert 0 < len(n) <= 64 and set(n) <= ok, n
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
    metrics = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in metrics
        assert set(m["workloads"]) <= set(CELLS)


def test_a_cell_added_as_files_only_runs(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    new = dict(bench["workloads"][0], name="jacobi2d-f64.solve_l3",
               traffic="solve.l3")
    bench["workloads"].append(new)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "jacobi2d-f64.solve" in m.get("workloads", ()):
            m["workloads"].append(new["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    params = json.loads((root / "bench/workloads/jacobi2d-f64.solve.json")
                        .read_text())
    params.update(level="L3", iters=12)
    (root / "bench/workloads/jacobi2d-f64.solve_l3.json").write_text(
        json.dumps(params))
    cell = _tiny.cell("jacobi2d-f64.solve_l3", root)
    assert cell.root == root and cell.params["level"] == "L3"
    assert cell.traffic.__file__ == str(root / "bench/traffic/solve.py")
    line = _tiny.run(cell, trace=True)
    assert line["correct"] is True
    assert {"mfu", "host_issue_ms"} <= set(line["metrics"])


def test_a_cell_of_another_config_than_its_file_is_refused(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    path = root / "bench/workloads/heat3d-f64.solve.json"
    params = json.loads(path.read_text())
    path.write_text(json.dumps(dict(params, config="jacobi2d-f64")))
    with pytest.raises(ValueError):
        harness.find_cell("heat3d-f64.solve", root)


def test_a_card_without_its_peaks_is_refused(monkeypatch, capsys):
    import torch

    import run
    for var in run.CACHES:
        monkeypatch.setenv(var, "")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA A100-SXM4-80GB")
    rc = run.main(["--workload", "jacobi2d-f64.solve", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "NVIDIA H100 80GB HBM3" in out.err


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell("nope.solve")
