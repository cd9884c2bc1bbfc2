"""Model registry: config -> model instance.

The port of ``repro.models.registry.build_model``: every family of the
zoo (dense, MoE and VLM decoders, zamba2, xLSTM, the encoder-decoder).
``input_specs`` (the dry-run's shape stand-ins) waits for the dry-run
port (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

from .encdec import EncDecModel
from .hybrid import XLSTMModel, Zamba2Model
from .transformer import DecoderModel


def build_model(cfg, *, kv_quant: bool = False, device=None):
    """The port's model for ``cfg`` on ``device`` (CUDA unless the caller
    says otherwise).  ``kv_quant=True`` gives a decoder-only transformer
    int8 KV caches; the other families ignore it, as in the reference."""
    if cfg.is_encdec:
        return EncDecModel(cfg, device=device)
    if cfg.family == "hybrid":
        return Zamba2Model(cfg, device=device)
    if cfg.family == "ssm":
        return XLSTMModel(cfg, device=device)
    return DecoderModel(cfg, kv_quant=kv_quant, device=device)
