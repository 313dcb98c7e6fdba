from .analysis import (HARDWARE, HBM_BW, NETWORK_BW, NVLINK_BW,
                       PEAK_FLOPS_BF16, Roofline, build_roofline, model_flops,
                       n_active_params, n_params, stencil_roofline)

__all__ = ["HARDWARE", "HBM_BW", "NETWORK_BW", "NVLINK_BW",
           "PEAK_FLOPS_BF16", "Roofline", "build_roofline", "model_flops",
           "n_active_params", "n_params", "stencil_roofline"]
