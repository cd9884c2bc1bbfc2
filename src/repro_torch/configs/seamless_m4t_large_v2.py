"""seamless-m4t-large-v2 [audio]: enc-dec multimodal transformer backbone.

24L enc + 24L dec, d_model=1024, 16H (GQA kv=16 == MHA), d_ff=8192,
vocab=256206  [arXiv:2308.11596; hf].  The speech frontend is a STUB:
input_specs() provides precomputed frame embeddings (DESIGN.md §5).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, head_dim=64,
    frontend="frames", frontend_len=1024,
    subquadratic=False,  # full attention: long_500k skipped
)
