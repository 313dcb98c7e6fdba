"""Parameter and FLOP counts of a model configuration, and the
three-term roofline of a dry-run step at an H100's data-sheet rates.

    compute term    = FLOPs per device / peak bf16 FLOP/s
    memory term     = bytes per device / HBM bytes/s
    collective term = sum over links of wire bytes / the link's rate

The per-device FLOPs, bytes and wire bytes come from a traced step's
graph of local ops (:mod:`.graph_walk`, ``launch/dryrun.py``), so no
division by the device count is applied; the model FLOPs (6ND) are
divided by it to compare.  Each collective's wire bytes go to the
slowest link its group crosses (NVLink inside a node of eight, the
network across nodes).  The rates are the data sheets' (``HARDWARE``):
the dry run's seconds are model outputs at those rates, not
measurements.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..models.config import ModelConfig

#: One H100 SXM in a DGX H100 node, dense rates without sparsity.
#: NVIDIA H100 Tensor Core GPU data sheet: HBM3 3.35 TB/s, 80 GB; FP64
#: 34 TFLOP/s and FP32 67 TFLOP/s outside the tensor cores; BF16 989.4,
#: TF32 494.7 and FP16 989.4 TFLOP/s on them.  NVLink 4: 900 GB/s per GPU,
#: 450 GB/s each way, inside a node of 8 (DGX H100 user guide).  Across
#: nodes one 400 Gb/s ConnectX-7 port per GPU: 50 GB/s (DGX H100 user
#: guide).  ``chip_smoke.card_rates`` reads its H100 row from here.
HARDWARE = {
    "H100": {
        "hbm_bw": 3.35e12, "f64": 34e12, "f32": 67e12, "bf16": 989e12,
        "tf32": 494.7e12, "f16": 989e12, "hbm_bytes": 80 * (1 << 30),
        "nvlink_bw": 450e9, "network_bw": 50e9, "ranks_per_node": 8,
    },
}
_H100 = HARDWARE["H100"]
PEAK_FLOPS_BF16 = _H100["bf16"]
HBM_BW = _H100["hbm_bw"]
HBM_BYTES = _H100["hbm_bytes"]
NVLINK_BW = _H100["nvlink_bw"]
NETWORK_BW = _H100["network_bw"]
RANKS_PER_NODE = _H100["ranks_per_node"]
LINK_BW = {"nvlink": NVLINK_BW, "network": NETWORK_BW}


def n_params(cfg: ModelConfig) -> float:
    """Total parameter count, from the arch's PSpec tree."""
    from ..models import make_arch
    from ..models.common import param_count
    arch = make_arch(cfg)
    return float(param_count(arch.param_specs(cfg)))


def n_active_params(cfg: ModelConfig) -> float:
    """Parameters a token touches: MoE's unrouted experts left out."""
    total = n_params(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    expert = 3 * cfg.d_model * m.d_expert       # gate+up+down per expert
    inactive = cfg.n_layers * (m.n_experts - m.top_k) * expert
    return total - inactive


def model_flops(cfg: ModelConfig, cell: Any) -> float:
    """6 * N_active * D for training; 2 * N_active * D for inference."""
    n = n_active_params(cfg)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    mult = 6.0 if cell.kind == "train" else 2.0
    return mult * n * tokens


@dataclasses.dataclass
class Roofline:
    arch: str
    cell: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float          # per-device wire bytes
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float               # 6ND (or 6 N_active D), whole step
    useful_flops_ratio: float        # model_flops/devices / walked flops
    memory_per_device: dict
    collective_ops: dict
    t_collective_by_link: dict = dataclasses.field(default_factory=dict)

    @property
    def step_time_lower_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the step spent on the compute roofline if perfectly
        overlapped = compute / max(all terms)."""
        lb = self.step_time_lower_bound
        return self.t_compute / lb if lb > 0 else 0.0

    def summary(self) -> dict:
        return {
            "arch": self.arch, "cell": self.cell, "mesh": self.mesh,
            "devices": self.n_devices,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_collective_by_link_s": self.t_collective_by_link,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "memory": self.memory_per_device,
            "collective_ops": self.collective_ops,
        }


def roofline_terms(flops: float, byts: float, wire_by_link: dict, *,
                   peak_flops: float = PEAK_FLOPS_BF16,
                   hbm_bw: float = HBM_BW,
                   link_bw: dict | None = None) -> dict:
    """The three terms (seconds) and the collective term per link."""
    link_bw = LINK_BW if link_bw is None else link_bw
    by_link = {k: v / link_bw[k] for k, v in wire_by_link.items()}
    return {"compute": flops / peak_flops, "memory": byts / hbm_bw,
            "collective": sum(by_link.values()), "by_link": by_link}


def bottleneck_of(terms: dict) -> str:
    """The largest of the three terms (the first listed on a tie)."""
    three = {k: terms[k] for k in ("compute", "memory", "collective")}
    return max(three, key=three.get)


def build_roofline(arch_id: str, cell, mesh_name: str, n_devices: int,
                   totals, memory: dict, cfg: ModelConfig) -> Roofline:
    """``totals``: a :class:`~.graph_walk.Totals` (per device)."""
    flops = float(totals.flops)
    byts = float(totals.bytes)
    wire = float(totals.collective_wire_bytes)
    terms = roofline_terms(flops, byts, totals.coll_link)
    mf = model_flops(cfg, cell)
    ratio = (mf / n_devices) / flops if flops else 0.0
    return Roofline(
        arch=arch_id, cell=cell.name, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=flops, bytes_per_device=byts,
        collective_bytes=wire, t_compute=terms["compute"],
        t_memory=terms["memory"], t_collective=terms["collective"],
        bottleneck=bottleneck_of(terms), model_flops=mf,
        useful_flops_ratio=ratio, memory_per_device=memory,
        collective_ops=totals.collective_ops(),
        t_collective_by_link=terms["by_link"])


def stencil_roofline(*, flops: float, bytes_moved: float, measured_s: float,
                     measured_bw: float, peak_flops: float) -> dict:
    """Achieved-vs-peak roofline placement of one *measured* stencil
    kernel run (the single-device analogue of :func:`build_roofline`).
    ``measured_s`` comes from the wall clock, ``measured_bw`` from a
    bandwidth measurement in the same process and ``peak_flops`` from a
    data sheet or a calibration.  ``roofline_fraction`` is the fraction
    of the measured time the roofline lower bound accounts for; it can
    pass 1 slightly where the working set stays in cache."""
    t_mem = bytes_moved / measured_bw if measured_bw > 0 else 0.0
    t_comp = flops / peak_flops if peak_flops > 0 else 0.0
    lower_bound = max(t_mem, t_comp)
    return {
        "hlo_flops": float(flops),
        "hlo_bytes": float(bytes_moved),
        "measured_s": float(measured_s),
        "achieved_bw": bytes_moved / measured_s if measured_s > 0 else 0.0,
        "t_memory_s": t_mem,
        "t_compute_s": t_comp,
        "bound": "memory" if t_mem >= t_comp else "compute",
        "roofline_fraction": (lower_bound / measured_s
                              if measured_s > 0 else 0.0),
    }
