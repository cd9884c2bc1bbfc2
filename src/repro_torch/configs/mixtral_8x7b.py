"""mixtral-8x7b [moe]: 8-expert top-2 MoE with sliding-window attention.

32L, d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=32000, SWA 4096
[arXiv:2401.04088; hf].  SWA everywhere => KV bounded => sub-quadratic:
long_500k runs (DESIGN.md §5).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, head_dim=128,
    n_experts=8, moe_top_k=2, window=4096,
    subquadratic=True,
)
