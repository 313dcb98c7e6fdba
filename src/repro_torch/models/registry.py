"""Architecture registry: uniform API over the ported architectures.

Every arch exposes, as in the reference:
  param_specs(cfg)                         -> PSpec tree
  loss(params, batch, cfg, ctx)            -> (scalar, metrics)
  prefill(params, batch, cfg, ctx, max_len)-> (state, len, logits)
  decode(params, state, len, tok, cfg, ctx)-> (state, len, logits)
  decode_state_specs(cfg, batch, max_len)  -> PSpec tree
  decode_state_init(cfg, batch, max_len)   -> tensors
and ``input_specs(cfg, cell, mesh)`` gives the batch a shape cell feeds
it, with its shardings on ``mesh``.

All four families are ported: the transformer (dense, MoE, the VLM
backbone), zamba2 (Mamba2 with a shared attention block), xLSTM and
Whisper.  Every decode-state initializer defaults to the card and
raises where CUDA is missing, unless given ``device``.  The entry points
``make_arch`` gives run under :func:`~repro_torch.sharding.on_mesh`, so
that on a mesh the plain tensors model code makes count as replicated.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from ..sharding import NamedSharding, on_mesh, resolve
from .common import AbstractTensor
from .config import ModelConfig
from . import transformer as tf
from . import whisper as wh
from . import xlstm as xl
from . import zamba2 as zb


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


CELLS: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    if cell.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention arch: 500k-token replay is quadratic;"
                       " skipped per DESIGN.md §4")
    return True, ""


@dataclasses.dataclass(frozen=True)
class ArchDef:
    cfg: ModelConfig
    param_specs: Callable[[ModelConfig], Any]
    loss: Callable
    prefill: Callable
    decode: Callable
    decode_state_specs: Callable   # (cfg, batch, max_len) -> PSpec tree
    decode_state_init: Callable    # (cfg, batch, max_len) -> tensors


def _xlstm_state_specs(cfg, batch, max_len):
    return xl.xlstm_state_specs(cfg, batch)


def _xlstm_state_init(cfg, batch, max_len, device=None):
    return xl.xlstm_state_init(cfg, batch, device)


_FAMILY_DEFS = {
    "transformer": dict(
        param_specs=tf.lm_param_specs, loss=tf.lm_loss,
        prefill=tf.lm_prefill, decode=tf.lm_decode,
        decode_state_specs=tf.cache_specs,
        decode_state_init=tf.init_caches),
    "zamba": dict(
        param_specs=zb.zamba_param_specs, loss=zb.zamba_loss,
        prefill=zb.zamba_prefill, decode=zb.zamba_decode,
        decode_state_specs=zb.zamba_state_specs,
        decode_state_init=zb.zamba_state_init),
    "xlstm": dict(
        param_specs=xl.xlstm_param_specs, loss=xl.xlstm_loss,
        prefill=xl.xlstm_prefill, decode=xl.xlstm_decode,
        decode_state_specs=_xlstm_state_specs,
        decode_state_init=_xlstm_state_init),
    "whisper": dict(
        param_specs=wh.whisper_param_specs, loss=wh.whisper_loss,
        prefill=wh.whisper_prefill, decode=wh.whisper_decode,
        decode_state_specs=wh.whisper_state_specs,
        decode_state_init=wh.whisper_state_init),
}


def family_impl(cfg: ModelConfig) -> str:
    if cfg.family == "hybrid":
        return "zamba"
    if cfg.family == "ssm":
        return "xlstm"
    if cfg.family == "audio":
        return "whisper"
    return "transformer"


def _in_mesh_scope(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with on_mesh():
            return fn(*args, **kwargs)
    return run


def make_arch(cfg: ModelConfig) -> ArchDef:
    defs = dict(_FAMILY_DEFS[family_impl(cfg)])
    for k in ("loss", "prefill", "decode"):
        defs[k] = _in_mesh_scope(defs[k])
    return ArchDef(cfg=cfg, **defs)


# ---------------------------------------------------------------------------
# batch construction per shape cell
# ---------------------------------------------------------------------------
def _sds(shape, dtype, mesh, logical) -> AbstractTensor:
    if mesh is None:
        return AbstractTensor(tuple(shape), dtype)
    return AbstractTensor(tuple(shape), dtype, NamedSharding(
        mesh, resolve(mesh, logical, shape)))


def input_specs(cfg: ModelConfig, cell: ShapeCell, mesh=None) -> dict:
    """Abstract model inputs for one shape cell: shape, dtype and, on
    ``mesh`` (a ``DeviceMesh`` or a ``MeshShape``), sharding."""
    b, s = cell.global_batch, cell.seq_len
    bax = "dp" if b > 1 else None
    if cell.kind in ("train", "prefill"):
        if cfg.family == "audio":
            return {
                "frames": _sds((b, s, cfg.d_model), torch.bfloat16, mesh,
                               (bax, "sp" if b == 1 else None, None)),
                "tokens": _sds((b, min(s, cfg.max_seq)), torch.int32, mesh,
                               (bax, None)),
            }
        batch = {"tokens": _sds((b, s - (cfg.n_patches or 0)), torch.int32,
                                mesh, (bax, None))}
        if cfg.n_patches:
            batch["patch_embeds"] = _sds(
                (b, cfg.n_patches, cfg.d_model), torch.bfloat16, mesh,
                (bax, None, None))
        return batch
    # decode: one token per sequence
    return {"tokens": _sds((b, 1), torch.int32, mesh, (bax, None))}


def make_batch(cfg: ModelConfig, cell: ShapeCell,
               gen: torch.Generator) -> dict:
    """A random batch for the cell, drawn from ``gen`` on its device."""
    out = {}
    for name, spec in input_specs(cfg, cell).items():
        if spec.dtype.is_floating_point:
            out[name] = torch.randn(spec.shape, generator=gen,
                                    device=gen.device).to(spec.dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab, spec.shape, generator=gen,
                                      device=gen.device, dtype=spec.dtype)
    return out
