"""deepseek-moe-16b [moe]: fine-grained MoE decoder.

28L, d_model=2048, 16H (kv=16), per-expert d_ff=1408, vocab=102400,
64 routed experts top-6 + 2 shared [arXiv:2401.06066; hf].
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102400, head_dim=128,
    n_experts=64, n_shared_experts=2, moe_top_k=6,
    subquadratic=False,
)
