"""GQA attention: flash prefill through the CUDA kernel, cached decode.

The port of the dense paths of ``repro.models.attention``:

  * ``attention_full``   -- full-sequence (prefill) attention through
    ``ops.flash_attention``: the hand-written kernels
    (``kernels/csrc/flash_attention_wgmma.cu`` in bf16,
    ``flash_attention.cu`` in fp32) for tensors on the card, the
    plain ``ref.flash_attention_ref`` for tensors on the CPU.  It takes
    the place of the reference's XLA ``_flash`` and scales q where that
    does: in q's dtype, before the fp32 products.
  * ``attention_decode`` -- one-token query against a (ring-buffer) KV
    cache with per-slot positions, in plain PyTorch, as the reference
    computes it outside any Pallas kernel.

Sliding-window layers keep a ring buffer of W slots; each slot stores
its absolute position (``slot_pos``), so masking is exact whatever the
rotation (RoPE is applied at write time with absolute positions).

Unlike the reference, whose arrays are immutable, the cache functions
write into the cache's tensors in place and return the same cache: a
copy per decode step would double the cache's memory traffic.
The int8 cache, M-RoPE and cross attention are not ported yet
(ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels import ops
from ..kernels.ref import ATTN_NEG
from .layers import apply_rope, dense_init


def attn_init(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": dense_init(gen, d, H * hd, dtype),
        "wk": dense_init(gen, d, KV * hd, dtype),
        "wv": dense_init(gen, d, KV * hd, dtype),
        "wo": dense_init(gen, H * hd, d, dtype),
    }


def _project_qkv(p, x: torch.Tensor, cfg, positions: torch.Tensor):
    if cfg.mrope:
        raise NotImplementedError(
            "M-RoPE (qwen2-vl) is not ported yet: ROADMAP Queue 1 item 15")
    B, T, _ = x.shape
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(B, T, H, hd)
    k = (x @ p["wk"]).reshape(B, T, KV, hd)
    v = (x @ p["wv"]).reshape(B, T, KV, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_full(p, x: torch.Tensor, positions: torch.Tensor, *, cfg,
                   window: int, backend: str = "auto"):
    """Causal full-sequence attention of x (B, T, d) at positions (B, T);
    returns (out (B, T, d), (k, v)) with k, v (B, T, KV, hd) for the
    cache."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    # q scaled in its own dtype before the kernel's fp32 products, as the
    # reference's _flash scales it: the scale is rounded to that dtype (a
    # host float), and the product of two bf16 values is exact in fp32, so
    # q * scale rounds once, as in JAX
    scale = float(torch.tensor(1.0 / math.sqrt(cfg.head_dim), dtype=q.dtype))
    out = ops.flash_attention(q * scale, k, v, causal=True, window=window,
                              scale=1.0, backend=backend)
    B, T = x.shape[0], x.shape[1]
    return out.reshape(B, T, -1).to(x.dtype) @ p["wo"], (k, v)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S, KV, hd)
    v: torch.Tensor          # (B, S, KV, hd)
    slot_pos: torch.Tensor   # (B, S) absolute position per slot (-1 empty)


def cache_init(cfg, batch: int, capacity: int, dtype: torch.dtype,
               device) -> KVCache:
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return KVCache(
        k=torch.zeros((batch, capacity, KV, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, capacity, KV, hd), dtype=dtype, device=device),
        slot_pos=torch.full((batch, capacity), -1, dtype=torch.int32,
                            device=device),
    )


def cache_fill_from_prefill(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                            positions: torch.Tensor) -> KVCache:
    """Write prefill keys/values (B, T, KV, hd) into the cache, in place.

    Global layers: capacity >= T, slot = position.  Window layers: a ring
    of S slots; only the last S positions are written (distinct slots)."""
    T = k.shape[1]
    S = cache.k.shape[1]
    pos = positions[0] if positions.dim() >= 2 else positions   # (T,)
    pos = pos.to(torch.int32)
    if S >= T:
        cache.k[:, :T] = k
        cache.v[:, :T] = v
        cache.slot_pos[:, :T] = pos[None, :]
        return cache
    tail_p = pos[T - S:]
    idx = (tail_p % S).long()
    cache.k[:, idx] = k[:, T - S:]
    cache.v[:, idx] = v[:, T - S:]
    cache.slot_pos[:, idx] = tail_p[None, :]
    return cache


def attention_decode(p, x: torch.Tensor, cache: KVCache, pos, *, cfg,
                     window: int):
    """One-token decode.  x: (B, 1, d); pos: an int, or a (B,) tensor of
    per-sequence positions (continuous batching serves sequences at
    different depths in one batched step).  Writes the new key and value
    into the cache in place; returns (out (B, 1, d), cache)."""
    B = x.shape[0]
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    S = cache.k.shape[1]
    pos_b = torch.as_tensor(pos, dtype=torch.int32,
                            device=x.device).expand(B)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos_b[:, None])

    slot = (pos_b % S).long()
    bidx = torch.arange(B, device=x.device)
    cache.k[bidx, slot] = k_new[:, 0]
    cache.v[bidx, slot] = v_new[:, 0]
    cache.slot_pos[bidx, slot] = pos_b

    qh = q.reshape(B, KV, G, hd) / math.sqrt(hd)
    s = torch.einsum("bKgh,bsKh->bKgs", qh.float(), cache.k.float())
    sp = cache.slot_pos
    valid = (sp >= 0) & (sp <= pos_b[:, None])
    if window > 0:
        valid &= sp > (pos_b[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, ATTN_NEG)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bKgs,bsKh->bKgh", w, cache.v.float())
    out = out.reshape(B, 1, H * hd).to(x.dtype)
    return out @ p["wo"], cache
