"""gemma3-4b [dense]: 5:1 local:global attention, 128k context.

34L, d_model=2560, 8H (GQA kv=4), d_ff=10240, vocab=262144, head_dim=256
[hf:google/gemma-3-1b-pt; unverified].  5 sliding-window (1024) layers per
1 global layer => sub-quadratic; long_500k keeps full KV only for the ~1/6
global layers.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
    vocab=262144, head_dim=256,
    local_global_ratio=5, local_window=1024,
    subquadratic=True,
)
