"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention blocks.

54 Mamba2 layers (state=64), d_model=2560, shared attention block (32H,
kv=32) applied every 6 layers with shared weights [arXiv:2411.15242; hf].
Recurrent state + periodic shared attention => sub-quadratic: long_500k
runs with the shared block's KV capped at a 4096 window.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, head_dim=80,
    ssm_state=64, ssm_head_dim=64, attn_every=6, window=4096,
    subquadratic=True,
)
