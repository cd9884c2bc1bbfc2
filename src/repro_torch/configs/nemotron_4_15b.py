"""nemotron-4-15b [dense]: squared-ReLU MLP decoder.

32L, d_model=6144, 48H (GQA kv=8), d_ff=24576, vocab=256000
[arXiv:2402.16819; unverified].
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=24576,
    vocab=256000, head_dim=128, mlp="relu2",
    subquadratic=False,
)
