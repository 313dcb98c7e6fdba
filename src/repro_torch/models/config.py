"""ModelConfig: one declarative record drives every architecture."""
from __future__ import annotations

import dataclasses
from typing import Optional

from .moe import MoeCfg


@dataclasses.dataclass(frozen=True)
class SsmCfg:
    """Mamba2/SSD block configuration."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                       # dense|moe|hybrid|ssm|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    act: str = "swiglu"               # swiglu|geglu|sqrelu|gelu
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    window: Optional[int] = None      # sliding-window size for local layers
    layer_pattern: tuple[str, ...] = ("global",)   # attention kind per unit
    rope_theta: Optional[float] = 10000.0
    norm_eps: float = 1e-6
    norm_plus_one: bool = False       # gemma (1+scale) RMSNorm
    post_norm: bool = False           # gemma2 post-block RMSNorms
    attn_scale: Optional[float] = None
    tie_embeddings: bool = False
    embed_scale: bool = False         # gemma: scale embeddings by sqrt(d)
    # MoE
    moe: Optional[MoeCfg] = None
    # SSM / hybrid (zamba2, xlstm use their own modules)
    ssm: Optional[SsmCfg] = None
    attn_every: int = 0               # zamba2: shared attn every N ssm blocks
    lora_rank: int = 0                # zamba2 per-invocation LoRA on shared blk
    # xLSTM
    slstm_layers: tuple[int, ...] = ()
    # whisper (enc-dec)
    encoder_layers: int = 0
    max_source_positions: int = 1500
    # vlm
    n_patches: int = 0
    # impl knobs
    block_q: int = 512
    block_k: int = 1024
    attn_impl: str = "auto"
    remat: bool = True          # recompute each unit's body in backward
    accum_steps: int = 1        # gradient-accumulation microbatches
    decode_kv_seq_shard: bool = False   # flash-decode: KV cache seq over TP
    fuse_qkv: bool = False      # single fused qkv projection einsum
    max_seq: int = 4096
    # which shape cells this arch supports (DESIGN.md §4 skips)
    supports_long_context: bool = False

    @property
    def unit(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_units(self) -> int:
        assert self.n_layers % self.unit == 0, (
            f"{self.arch}: n_layers {self.n_layers} not divisible by "
            f"pattern {self.layer_pattern}")
        return self.n_layers // self.unit

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        changes = dict(
            n_layers=max(2 * self.unit, 2),
            d_model=64,
            n_heads=4,
            n_kv=max(1, min(self.n_kv, 2)),
            d_head=16,
            d_ff=128,
            vocab=256,
            window=8 if self.window else None,
            block_q=16,
            block_k=32,
            attn_impl="dense",
            max_seq=64,
        )
        if self.n_kv == self.n_heads:   # MHA archs keep kv == heads
            changes["n_kv"] = 4
        if self.moe is not None:
            # capacity_factor 4: dropless at smoke scale so that the
            # decode==prefill invariant is exact (drops are load-dependent)
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_expert=32,
                n_shared=min(self.moe.n_shared, 1), n_groups=2,
                capacity_factor=4.0)
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, d_state=8, head_dim=8, chunk=8)
        if self.attn_every:
            changes["attn_every"] = 3          # fire every other 3-block unit
            changes["n_layers"] = 6            # 2 units x 3 layers
            changes["lora_rank"] = 4
        if self.encoder_layers:
            changes["encoder_layers"] = 2
            changes["max_source_positions"] = 64
        if self.slstm_layers:
            changes["n_layers"] = 4
            changes["slstm_layers"] = (1,)
        if self.n_patches:
            changes["n_patches"] = 4
        return dataclasses.replace(self, **changes)
