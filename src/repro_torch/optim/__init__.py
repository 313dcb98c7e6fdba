"""The optimizer: AdamW with f32 master weights and optional 8-bit
moments, and int8 gradient compression with error feedback."""
from .adamw import (AdamWConfig, apply_updates, global_norm, init_opt_state,
                    opt_state_specs, schedule)
from . import compress

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_opt_state",
           "opt_state_specs", "schedule", "compress"]
