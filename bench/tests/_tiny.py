"""Cells of ``BENCHMARK.json`` cut to sizes a CPU test run holds: each
keeps its configuration and traffic kind, with small grids and few
iterations."""
import time

import torch

import harness

LEVELS = {2: {"DRAM": [40, 36], "L3": [24, 20]},
          3: {"DRAM": [12, 10, 9], "L3": [8, 10, 6]}}
PARAMS = {"solve": {"iters": 10}}


def cell(name: str, root=harness.ROOT):
    c = harness.find_cell(name, root)
    c.config = dict(c.config, levels=LEVELS[c.config["ndim"]])
    c.params = dict(c.params, **PARAMS[c.entry["traffic"].split(".")[0]])
    return c


def run(c, seed: int = 2 ** 31 + 5, seconds: float = 0.5,
        trace: bool = False) -> dict:
    return harness.run_cell(c, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), log=lambda *a: None)
