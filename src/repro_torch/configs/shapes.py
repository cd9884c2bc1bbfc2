"""The four assigned input shapes (same set for every LM arch)."""

from .base import ShapeConfig

TRAIN_4K = ShapeConfig(name="train_4k", kind="train", seq_len=4_096,
                       global_batch=256)
PREFILL_32K = ShapeConfig(name="prefill_32k", kind="prefill", seq_len=32_768,
                          global_batch=32)
DECODE_32K = ShapeConfig(name="decode_32k", kind="decode", seq_len=32_768,
                         global_batch=128)
LONG_500K = ShapeConfig(name="long_500k", kind="decode", seq_len=524_288,
                        global_batch=1)

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shapes_for(cfg) -> dict:
    """Applicable shapes for an arch: long_500k only for sub-quadratic
    attention (DESIGN.md §5); decode applies to all (none is encoder-only)."""
    out = {k: v for k, v in SHAPES.items()}
    if not cfg.subquadratic:
        out.pop("long_500k")
    return out
