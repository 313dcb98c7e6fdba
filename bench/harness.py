"""The harness: finds a cell's files by name, runs the cell once and
builds its result line.

Everything that belongs to one cell, configuration, traffic kind or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``bench/workloads/<cell>.json``: the cell's configuration, chips,
  why and the parameters of its traffic kind;
* ``bench/configs/<config>.json``: the stencil as it is run (taps,
  dtype, boundary, engine options, grid sizes), with its source and cuts;
* ``bench/traffic/<kind>.py``: the generator and window of one traffic
  kind (``setup``, ``window``, ``finish``, ``verify``).  The kind is
  the cell's ``traffic`` in ``BENCHMARK.json`` up to its first dot:
  ``solve`` and ``solve.l3`` are two mixes of the kind ``solve``, each
  cell's mix given by the parameters in its own file;
* ``bench/metrics/<metric>.py``: one reader per per-layer metric
  (``read(record)``, ``None`` where it finds nothing to read);
* ``bench/reference/``: the plain reference and the comparison.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: Top-level module names that may not be loaded in a run's process:
#: JAX and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: How much of a traced run's window the profiler records (its first
#: seconds): a whole window holds tens of thousands of launches, whose
#: trace takes minutes to write and read.
TRACE_S = 12.0


def load_module(path: Path, name: str | None = None) -> ModuleType:
    """Import the Python file at ``path`` as a module of its own."""
    name = name or "bench_" + "_".join(
        path.relative_to(BENCH).with_suffix("").parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    """One cell with everything its run reads."""

    name: str
    root: Path             # the checkout that holds BENCHMARK.json
    entry: dict            # its entry in BENCHMARK.json's workloads
    params: dict           # bench/workloads/<name>.json
    config: dict           # bench/configs/<config>.json
    traffic: ModuleType    # bench/traffic/<kind>.py
    end_to_end: list       # BENCHMARK.json metrics this cell reports
    per_layer: list

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files."""
    bench = read_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(sorted(entries))})")
    entry = entries[name]
    bdir = root / "bench"
    params = read_json(bdir / "workloads" / f"{name}.json")
    for key in ("config", "chips"):
        if params[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {params[key]!r} in its "
                             f"file, {entry[key]!r} in BENCHMARK.json")
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(bdir / configs[entry["config"]]["file"]
                       .removeprefix("bench/"))
    kind = entry["traffic"].split(".")[0]
    traffic = load_module(bdir / "traffic" / f"{kind}.py",
                          f"bench_traffic_{kind}")
    return Cell(name, root, entry, params, config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / "bench" / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_"))


def stencil_spec(config: dict):
    """The program's spec for ``config``: ``PAPER_STENCILS[stencil]``
    under the configuration's boundary, refused unless its taps are the
    configuration's, in the same order (the order the sums are pinned
    to), and it sums them in that order (a star or a dense tap set)."""
    from repro_torch.core.stencil import PAPER_STENCILS
    spec = PAPER_STENCILS[config["stencil"]].with_boundary(config["boundary"])
    want = tuple((tuple(int(o) for o in off), float(c))
                 for off, c in config["taps"])
    if spec.taps != want or spec.ndim != config["ndim"]:
        raise ValueError(f"{config['name']}: the program's "
                         f"{config['stencil']} taps {spec.taps} are not "
                         f"the configuration's {want}")
    if spec.factorization.compute_terms is not None:
        raise ValueError(f"{config['name']}: the program sums "
                         f"{config['stencil']} in factored order; the "
                         "reference sums taps in the listed order")
    return spec


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is one of
    :data:`FORBIDDEN` (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit_w() -> float | None:
    """``nvidia-smi``'s power limit of the first card, in watts."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


@dataclasses.dataclass
class Context:
    """What a traffic kind's ``setup`` is given."""

    cell: Cell
    spec: object
    seed: int
    seconds: float
    device: object         # torch.device
    log: object = print


@dataclasses.dataclass
class Record:
    """What a per-layer metric's reader is given: the cell, the
    traffic's counters and the trace (``None`` without one)."""

    cell: Cell
    counters: dict
    trace: object = None


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seeded_rand(ctx: Context, shape):
    """Uniform [0, 1) values of the configuration's dtype, made on the
    device from the run's seed in one call."""
    import torch
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.seed)
    return torch.rand(tuple(shape), generator=gen,
                      dtype=getattr(torch, ctx.cell.config["dtype"]),
                      device=ctx.device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, chips: int = 1, log=log) -> dict:
    """Run ``cell`` once on ``device`` (a ``torch.device``) and return its
    result line, ``checks`` last.  ``t_start`` is the host clock at the
    start of the process: set-up runs from there to the window."""
    import torch

    import devtrace

    cuda = device.type == "cuda"
    ctx = Context(cell, stencil_spec(cell.config), seed, seconds, device,
                  log)
    state = cell.traffic.setup(ctx)
    sync(device)
    setup_s = time.perf_counter() - t_start
    tracer = devtrace.Tracer(trace, TRACE_S)
    cell.traffic.window(state, seconds, tracer)
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    out = cell.traffic.finish(state)
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checked = cell.traffic.verify(state)
    log(f"reference and comparison: {time.perf_counter() - t_ref:.3f} s")
    del state

    from reference import compare
    correct = compare.passed(checked)
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": checked["missing"]["value"]
            + checked["wrong"]["value"]}
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else device.type),
                   "count": chips, "memory_peak_bytes": int(peak)}
    if cuda:
        device_info["power_limit_w"] = power_limit_w()
    metrics, breakdown = {}, None
    if trace:
        tr = devtrace.Trace(devtrace.events(tracer.prof))
        record = Record(cell, out["counters"], tr)
        for m in cell.per_layer:
            value = metric_reader(m["name"], cell.root).read(record)
            if _finite(value) is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps()}
    else:
        values = dict(out["end_to_end"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": _finite(values[m["name"]]),
                                  "unit": m["unit"]}
    line["metrics"] = metrics
    line["device"] = device_info
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": _finite(c["value"]),
                          "limit": c["limit"]}
                      for k, c in checked.items()}
    for k, c in checked.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return line
