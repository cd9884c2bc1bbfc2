"""xlstm-125m [ssm]: alternating sLSTM / mLSTM blocks.

12L, d_model=768, 4 heads (kv=4), vocab=50304; d_ff=0 in the assignment =>
mLSTM blocks carry the expansion (block pattern msmsmsmsmsms)
[arXiv:2405.04517; unverified].  Pure recurrent state: long_500k runs.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=2048,
    vocab=50304, head_dim=192,
    ssm_state=64, ssm_head_dim=96,
    block_pattern=("m", "s") * 6,
    subquadratic=True,
)
