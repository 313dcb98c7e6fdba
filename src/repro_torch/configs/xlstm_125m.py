"""xlstm-125m [ssm]: sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12 blocks, d_model=768, 4 heads (head_dim=192), vocab=50304.  d_ff=0 in the
assignment: blocks carry their own projections, no separate FFN.  sLSTM at
block indices (3, 9), mLSTM elsewhere (the paper's ~[7:1] mix).  Recurrent
=> long_500k supported.
"""
from ..models.config import ModelConfig, SsmCfg


def config() -> ModelConfig:
    return ModelConfig(
        arch="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv=4, d_head=192,
        d_ff=0, vocab=50304, slstm_layers=(3, 9),
        ssm=SsmCfg(chunk=64, head_dim=192),
        rope_theta=None, supports_long_context=True, scan_layers=False,
        remat=False,
        tie_embeddings=True)
