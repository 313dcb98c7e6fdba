"""Model zoo of the port: the transformer family (dense, MoE and the VLM
backbone) on a shared substrate, in plain PyTorch."""
from .config import ModelConfig, SsmCfg
from .moe import MoeCfg
from .registry import (ArchDef, CELLS, ShapeCell, cell_supported,
                       input_specs, make_arch, make_batch)

__all__ = ["ModelConfig", "SsmCfg", "MoeCfg", "ArchDef", "CELLS",
           "ShapeCell", "cell_supported", "input_specs", "make_arch",
           "make_batch"]
