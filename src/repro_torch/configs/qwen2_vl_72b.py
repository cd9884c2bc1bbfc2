"""qwen2-vl-72b [vlm]: M-RoPE decoder backbone; vision frontend is a STUB.

80L, d_model=8192, 64H (GQA kv=8), d_ff=29568, vocab=152064, M-RoPE
[arXiv:2409.12191; hf].  input_specs() provides precomputed patch
embeddings prepended to the token stream (DESIGN.md §5).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, head_dim=128, mrope=True,
    frontend="patches", frontend_len=256,
    subquadratic=False,
)
