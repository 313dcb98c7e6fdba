"""gemma2-27b [dense]: local/global alternating attention + logit softcaps
[arXiv:2408.00118; hf].

46L, d_model=4608, 32 heads (GQA kv=16, head_dim=128), d_ff=36864 (GeGLU),
vocab=256000, sliding window 4096 on local layers, attn softcap 50, final
softcap 30, pre+post RMSNorm (1+scale), embeddings scaled by sqrt(d),
attention scale 1/sqrt(d_model/n_heads)=1/12.
"""
import math

from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch="gemma2-27b", family="dense",
        n_layers=46, d_model=4608, n_heads=32, n_kv=16, d_head=128,
        d_ff=36864, vocab=256000, act="geglu",
        layer_pattern=("local", "global"), window=4096,
        attn_softcap=50.0, final_softcap=30.0,
        post_norm=True, norm_plus_one=True, embed_scale=True,
        attn_scale=1.0 / math.sqrt(4608 / 32),
        tie_embeddings=True, rope_theta=10000.0)
