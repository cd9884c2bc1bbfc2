"""GQA attention: flash prefill through the CUDA kernel, cached decode.

The port of the dense paths of ``repro.models.attention``:

  * ``attention_full``   -- full-sequence (prefill) attention, causal
    or not (the encoder's), through
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

  * ``attention_decode_quant`` -- the same against the int8 cache
    (``QuantKVCache``: per-(slot, head) symmetric int8 K/V with fp32
    scales, dequantized on read).
  * ``cross_attention`` -- encoder-decoder cross attention (a dense
    softmax over the encoder memory, as in the reference).

Unlike the reference, whose arrays are immutable, the cache functions
write into the cache's tensors in place and return the same cache: a
copy per decode step would double the cache's memory traffic.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..kernels import ops
from ..kernels.ref import ATTN_NEG
from .layers import apply_mrope, apply_rope, dense_init


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
    """q (B, T, H, hd), k and v (B, T, KV, hd), RoPE applied at
    ``positions``: (B, T), or (3, B, T) M-RoPE streams (a (B, T) array
    broadcasts to three equal streams under M-RoPE, and a (3, B, T) one
    gives its first stream to plain RoPE)."""
    B, T, _ = x.shape
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(B, T, H, hd)
    k = (x @ p["wk"]).reshape(B, T, KV, hd)
    v = (x @ p["wv"]).reshape(B, T, KV, hd)
    if cfg.mrope:
        pos3 = positions if positions.dim() == 3 else \
            positions.expand((3,) + tuple(positions.shape))
        q = apply_mrope(q, pos3, cfg.rope_theta)
        k = apply_mrope(k, pos3, cfg.rope_theta)
    else:
        pos = positions if positions.dim() == 2 else positions[0]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def attention_full(p, x: torch.Tensor, positions: torch.Tensor, *, cfg,
                   window: int, causal: bool = True, backend: str = "auto"):
    """Full-sequence attention of x (B, T, d) at positions (B, T) (or
    M-RoPE's (3, B, T)), causal unless ``causal=False`` (the encoder);
    returns (out (B, T, d), (k, v)) with k, v (B, T, KV, hd) for the
    cache."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    # q scaled in its own dtype before the kernel's fp32 products, as the
    # reference's _flash scales it: the scale is rounded to that dtype (a
    # host float), and the product of two bf16 values is exact in fp32, so
    # q * scale rounds once, as in JAX
    scale = float(torch.tensor(1.0 / math.sqrt(cfg.head_dim), dtype=q.dtype))
    out = ops.flash_attention(q * scale, k, v, causal=causal, window=window,
                              scale=1.0, backend=backend)
    B, T = x.shape[0], x.shape[1]
    return out.reshape(B, T, -1).to(x.dtype) @ p["wo"], (k, v)


def _decode_positions(pos, B: int, cfg, device):
    """(pos_b (B,) int32, the positions _project_qkv takes for one token:
    (B, 1), or (3, B, 1) equal streams under M-RoPE)."""
    pos_b = torch.as_tensor(pos, dtype=torch.int32, device=device).expand(B)
    pos_arr = pos_b[:, None]
    return pos_b, (pos_arr.expand(3, B, 1) if cfg.mrope else pos_arr)


def _valid_slots(slot_pos: torch.Tensor, pos_b: torch.Tensor,
                 window: int) -> torch.Tensor:
    valid = (slot_pos >= 0) & (slot_pos <= pos_b[:, None])
    if window > 0:
        valid &= slot_pos > (pos_b[:, None] - window)
    return valid


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
    pos_b, pos_q = _decode_positions(pos, B, cfg, x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos_q)

    slot = (pos_b % S).long()
    bidx = torch.arange(B, device=x.device)
    cache.k[bidx, slot] = k_new[:, 0]
    cache.v[bidx, slot] = v_new[:, 0]
    cache.slot_pos[bidx, slot] = pos_b

    qh = q.reshape(B, KV, G, hd) / math.sqrt(hd)
    s = torch.einsum("bKgh,bsKh->bKgs", qh.float(), cache.k.float())
    valid = _valid_slots(cache.slot_pos, pos_b, window)
    s = torch.where(valid[:, None, None, :], s, ATTN_NEG)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bKgs,bsKh->bKgh", w, cache.v.float())
    out = out.reshape(B, 1, H * hd).to(x.dtype)
    return out @ p["wo"], cache


# ---------------------------------------------------------------------------
# int8-quantized KV cache
# ---------------------------------------------------------------------------

class QuantKVCache(NamedTuple):
    """Per-(slot, head) symmetric int8 K/V with fp32 scales: decode reads
    about half the bytes of a bf16 cache."""

    k: torch.Tensor          # (B, S, KV, hd) int8
    v: torch.Tensor          # (B, S, KV, hd) int8
    k_scale: torch.Tensor    # (B, S, KV) f32
    v_scale: torch.Tensor    # (B, S, KV) f32
    slot_pos: torch.Tensor   # (B, S) int32


def quant_cache_init(cfg, batch: int, capacity: int, device) -> QuantKVCache:
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return QuantKVCache(
        k=torch.zeros((batch, capacity, KV, hd), dtype=torch.int8,
                      device=device),
        v=torch.zeros((batch, capacity, KV, hd), dtype=torch.int8,
                      device=device),
        k_scale=torch.zeros((batch, capacity, KV), dtype=torch.float32,
                            device=device),
        v_scale=torch.zeros((batch, capacity, KV), dtype=torch.float32,
                            device=device),
        slot_pos=torch.full((batch, capacity), -1, dtype=torch.int32,
                            device=device),
    )


def _quant(x: torch.Tensor):
    """(..., hd) -> (int8 values, per-head fp32 scale).  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def quant_cache_fill_from_prefill(cache: QuantKVCache, k: torch.Tensor,
                                  v: torch.Tensor,
                                  positions: torch.Tensor) -> QuantKVCache:
    """Quantize prefill keys/values (B, T, KV, hd) into the cache, in
    place: slot = position mod S, only the last S positions when T > S."""
    T = k.shape[1]
    S = cache.k.shape[1]
    pos = positions[0] if positions.dim() >= 2 else positions
    pos = pos.to(torch.int32)
    if S < T:
        k, v, pos = k[:, T - S:], v[:, T - S:], pos[T - S:]
    qk, sk = _quant(k)
    qv, sv = _quant(v)
    idx = (pos % S).long()
    cache.k[:, idx] = qk
    cache.v[:, idx] = qv
    cache.k_scale[:, idx] = sk
    cache.v_scale[:, idx] = sv
    cache.slot_pos[:, idx] = pos[None, :]
    return cache


def attention_decode_quant(p, x: torch.Tensor, cache: QuantKVCache, pos, *,
                           cfg, window: int):
    """One-token decode against an int8 cache (dequantized on read): the
    new key and value quantized into the cache in place; returns (out
    (B, 1, d), cache)."""
    B = x.shape[0]
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    S = cache.k.shape[1]
    pos_b, pos_q = _decode_positions(pos, B, cfg, x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, pos_q)

    qk, sk = _quant(k_new[:, 0])
    qv, sv = _quant(v_new[:, 0])
    slot = (pos_b % S).long()
    bidx = torch.arange(B, device=x.device)
    cache.k[bidx, slot] = qk
    cache.v[bidx, slot] = qv
    cache.k_scale[bidx, slot] = sk
    cache.v_scale[bidx, slot] = sv
    cache.slot_pos[bidx, slot] = pos_b

    qh = q.reshape(B, KV, G, hd) / math.sqrt(hd)
    # the int8 product, then the per-slot rescale
    s = torch.einsum("bKgh,bsKh->bKgs", qh.float(), cache.k.float())
    s = s * cache.k_scale.movedim(1, 2)[:, :, None, :]       # (B, KV, 1, S)
    valid = _valid_slots(cache.slot_pos, pos_b, window)
    s = torch.where(valid[:, None, None, :], s, ATTN_NEG)
    w = torch.softmax(s, dim=-1)
    wv = w * cache.v_scale.movedim(1, 2)[:, :, None, :]
    out = torch.einsum("bKgs,bsKh->bKgh", wv, cache.v.float())
    out = out.reshape(B, 1, H * hd).to(x.dtype)
    return out @ p["wo"], cache


# ---------------------------------------------------------------------------
# cross attention (encoder-decoder)
# ---------------------------------------------------------------------------

def cross_attention(p, x: torch.Tensor, enc_kv, *, cfg) -> torch.Tensor:
    """x: (B, T, d) decoder states; enc_kv: (k, v) from ``encoder_kv``,
    each (B, Te, KV, hd).  A dense fp32 softmax over the encoder memory,
    as the reference computes it outside any Pallas kernel."""
    B, T, _ = x.shape
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    k, v = enc_kv
    q = (x @ p["wq"]).reshape(B, T, KV, G, hd) / math.sqrt(hd)
    s = torch.einsum("bqKgh,bsKh->bKgqs", q.float(), k.float())
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bKgqs,bsKh->bKgqh", w, v.float())
    out = out.movedim(3, 1).reshape(B, T, H * hd).to(x.dtype)
    return out @ p["wo"]


def encoder_kv(p, enc_out: torch.Tensor, cfg):
    """Cross-attention (k, v), each (B, Te, KV, hd), from the encoder's
    output."""
    B, Te, _ = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    k = (enc_out @ p["wk"]).reshape(B, Te, KV, hd)
    v = (enc_out @ p["wv"]).reshape(B, Te, KV, hd)
    return k, v
