"""Model registry: config -> model instance, and the inputs of a cell.

The port of ``repro.models.registry``: ``build_model`` for every family
of the zoo (dense, MoE and VLM decoders, zamba2, xLSTM, the
encoder-decoder), and ``input_specs``, the shape stand-ins of a
(arch, shape) cell's inputs as meta tensors (no allocation), for the
dry run and ``dist.sharding.batch_specs``.
"""

from __future__ import annotations

import torch

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


def input_specs(cfg, shape, *, kind=None) -> dict:
    """Meta tensors for an (arch x shape) cell's inputs.

    train:   {"tokens", "targets"[, "frontend"]}
    prefill: {"tokens"[, "frontend"]}
    decode:  {"token" (B,), "pos" ()}; the KV cache or state is the
             serving engine's.

    A decoder-only model with a frontend prepends F patch or frame
    embeddings, so its token stream is T - F long and the sequence T;
    the encoder-decoder's frontend is the encoder's memory and does not
    shorten the tokens."""
    kind = kind or shape.kind
    B, T = shape.global_batch, shape.seq_len
    i32 = torch.int32
    f32 = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    F = cfg.frontend_len if (cfg.frontend != "none"
                             and not cfg.is_encdec) else 0
    specs = {}
    if kind == "train":
        specs["tokens"] = sds((B, T - F), i32)
        specs["targets"] = sds((B, T - F), i32)
        if cfg.frontend != "none":
            specs["frontend"] = sds((B, cfg.frontend_len, cfg.d_model), f32)
    elif kind == "prefill":
        specs["tokens"] = sds((B, T - F), i32)
        if cfg.frontend != "none":
            specs["frontend"] = sds((B, cfg.frontend_len, cfg.d_model), f32)
    elif kind == "decode":
        specs["token"] = sds((B,), i32)
        specs["pos"] = sds((), i32)
    else:
        raise ValueError(kind)
    return specs
