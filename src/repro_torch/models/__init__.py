"""Model zoo of the port on a shared substrate, in plain PyTorch: the
transformer family (dense, MoE and the VLM backbone), zamba2 (Mamba2
blocks with a shared attention block), xLSTM (mLSTM and sLSTM blocks)
and Whisper (encoder-decoder)."""
from . import mamba2, whisper, xlstm, zamba2
from .config import ModelConfig, SsmCfg
from .moe import MoeCfg
from .registry import (ArchDef, CELLS, ShapeCell, cell_supported,
                       input_specs, make_arch, make_batch)

__all__ = ["ModelConfig", "SsmCfg", "MoeCfg", "ArchDef", "CELLS",
           "ShapeCell", "cell_supported", "input_specs", "make_arch",
           "make_batch", "mamba2", "whisper", "xlstm", "zamba2"]
