from .analysis import model_flops, n_active_params, n_params

__all__ = ["model_flops", "n_active_params", "n_params"]
