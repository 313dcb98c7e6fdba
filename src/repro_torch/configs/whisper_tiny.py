"""whisper-tiny [audio]: enc-dec, conv frontend STUB
[arXiv:2212.04356; unverified].

4 encoder + 4 decoder layers, d_model=384, 6 heads, d_ff=1536, vocab=51865.
input_specs() supplies precomputed frame embeddings.  max_seq raised to
cover the (structural) decode_32k cell — see DESIGN.md §4.
"""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        arch="whisper-tiny", family="audio",
        n_layers=4, encoder_layers=4, d_model=384, n_heads=6, n_kv=6,
        d_head=64, d_ff=1536, vocab=51865, act="gelu",
        rope_theta=None, tie_embeddings=True,
        max_seq=32800, max_source_positions=1500)
