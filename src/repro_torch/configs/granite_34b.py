"""granite-34b [dense]: deep MQA code model.

88L, d_model=6144, 48H (GQA kv=1 == MQA), d_ff=24576, vocab=49152
[arXiv:2405.04324; hf].
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab=49152, head_dim=128, mlp="gelu",  # gpt-bigcode 2-matrix MLP
    subquadratic=False,
)
