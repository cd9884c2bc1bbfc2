"""Shared layers of the decoder zoo, as plain functions on tensors.

The port of ``repro.models.layers``.  Parameters are plain nested dicts
of tensors, as in the reference, and every weight is ``(d_in, d_out)``
used as ``x @ W``.  Initialisers draw from an explicit
``torch.Generator`` on the device the weights live on; the numbers
differ from ``jax.random``'s, so the parity tests carry the reference's
weights over with ``interop.params_from_jax``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..dist import hints
from ..dist import tensor_parallel as tp_mod

MLP_KINDS = ("swiglu", "relu2", "gelu")


def dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    """(d_in, d_out) normal weights scaled by 1/sqrt(d_in), on gen's device."""
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype: torch.dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., T, H, hd); positions: (..., T) integers."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (hd/2,)
    angles = positions[..., None].float() * freqs             # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., T, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                theta: float = 10_000.0,
                sections=(0.25, 0.375, 0.375)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the frequencies of hd/2 are split into
    (temporal, h, w) sections, each rotated by its own position stream
    (the last section takes the remainder).

    x: (B, T, H, hd); positions3: (3, B, T).  For text all three streams
    are equal and M-RoPE is RoPE exactly."""
    half = x.shape[-1] // 2
    secs = [int(round(s * half)) for s in sections]
    secs[-1] = half - secs[0] - secs[1]
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (half,)
    sec_id = torch.cat([torch.full((n,), i, dtype=torch.long,
                                   device=x.device)
                        for i, n in enumerate(secs)])         # (half,)
    pos_bt3 = positions3.movedim(0, -1).float()               # (B, T, 3)
    angles = pos_bt3[..., sec_id] * freqs                     # (B, T, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, ff: int, kind: str,
             dtype: torch.dtype) -> dict:
    if kind not in MLP_KINDS:
        raise ValueError(f"unknown mlp {kind!r}; have {MLP_KINDS}")
    if kind == "swiglu":
        return {"wg": dense_init(gen, d, ff, dtype),
                "wu": dense_init(gen, d, ff, dtype),
                "wd": dense_init(gen, ff, d, dtype)}
    return {"w1": dense_init(gen, d, ff, dtype),
            "w2": dense_init(gen, ff, d, dtype)}


def mlp_apply(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    """The MLP of x (..., d).  Under ``model_ranks`` ``p`` holds this
    rank's blocks (:func:`mlp_blocks`): column-parallel up, row-parallel
    down, the partial outputs summed over the model ranks."""
    x = tp_mod.enter(x)
    if kind == "swiglu":
        out = (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    else:
        h = x @ p["w1"]
        if kind == "relu2":                  # nemotron squared-ReLU
            h = torch.square(F.relu(h))
        else:                                # jax.nn.gelu's default: tanh
            h = F.gelu(h, approximate="tanh")
        out = h @ p["w2"]
    return tp_mod.leave(out)


def mlp_blocks(kind: str, ff: int) -> dict:
    """Each MLP leaf's compute block over the model ranks: d_ff split,
    the up projections on their columns, the down one on its rows."""
    up, down = tp_mod.split(1, ff), tp_mod.split(0, ff)
    if kind == "swiglu":
        return {"wg": up, "wu": up, "wd": down}
    return {"w1": up, "w2": down}


def mlp_flops(cfg, tokens: int) -> int:
    """The MLP's matmul flops for ``tokens`` tokens: 2 per
    multiply-add, three (d_model, d_ff) products for SwiGLU, two else."""
    mats = 3 if cfg.mlp == "swiglu" else 2
    return 2 * mats * cfg.d_model * cfg.d_ff * tokens


def mask_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mask padded vocab logits (cfg.vocab_padded > cfg.vocab) to -1e30."""
    V = logits.shape[-1]
    if V == vocab:
        return logits
    keep = torch.arange(V, device=logits.device) < vocab
    return torch.where(keep, logits, -1e30)


def token_ce(logits: torch.Tensor, targets, vocab: int) -> torch.Tensor:
    """Mean next-token cross entropy of fp32 logits (..., vocab_padded)
    against integer targets (...), the padded vocab masked: the
    reference's logsumexp minus the gold logit, averaged.  Under
    ``model_ranks`` of degree t > 1 the logits are this rank's block of
    vocab_padded / t (``tensor_parallel.vocab_ce``)."""
    targets = torch.as_tensor(targets, device=logits.device).long()
    if tp_mod.degree() > 1:
        return tp_mod.vocab_ce(logits, targets, vocab)
    logits = mask_vocab(logits, vocab)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


def remat(fn, *args, enabled: bool = True):
    """``fn(*args)``, its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant) where ``enabled`` and
    autograd records: the port's ``jax.checkpoint`` of one layer.  The
    recomputation runs under the hints of the forward (``dist.hints``):
    on the card the backward runs in autograd's own thread, which sees
    no binding of its own."""
    if enabled and torch.is_grad_enabled():
        scope = hints.current()

        def run(*a):
            with hints.hints(**scope):
                return fn(*a)

        return checkpoint(run, *args, use_reentrant=False)
    return fn(*args)
