"""Model registry: config -> model instance.

The port of ``repro.models.registry.build_model``.  Only the dense
decoder is ported; every other family raises, naming its ROADMAP item,
rather than running as something it is not.  ``input_specs`` (the
dry-run's shape stand-ins) waits for the dry-run port.
"""

from __future__ import annotations

from .transformer import DecoderModel

_NOT_PORTED = {
    "moe": "MoE (models/moe.py)",
    "vlm": "VLM / M-RoPE",
    "hybrid": "hybrid and SSM (models/hybrid.py, models/ssm.py)",
    "ssm": "hybrid and SSM (models/hybrid.py, models/ssm.py)",
    "encdec": "enc-dec (models/encdec.py)",
}


def build_model(cfg, *, device=None) -> DecoderModel:
    """The port's model for ``cfg`` on ``device`` (CUDA unless the caller
    says otherwise).  The int8 KV cache (the reference's ``kv_quant``) is
    not ported yet (ROADMAP Queue 1 item 15)."""
    family = "encdec" if cfg.is_encdec else \
        ("moe" if cfg.n_experts else cfg.family)
    if family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: {_NOT_PORTED[family]} is not ported yet: ROADMAP "
            f"Queue 1 item 15")
    return DecoderModel(cfg, device=device)
