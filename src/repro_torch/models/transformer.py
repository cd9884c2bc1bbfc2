"""Decoder-only LM assembly for ``family`` "dense", "moe" and "vlm".

The port of ``repro.models.transformer``.  The reference scans over
layers stacked on a leading axis (one block in HLO); PyTorch runs
eagerly, so the port keeps a list of per-layer parameter dicts and a
Python loop over it, for prefill and decode alike.  Local (window)
layers keep W-slot ring buffers and global layers full-length caches, as
in the reference; ``kv_quant=True`` keeps them as int8
(``attention.QuantKVCache``).  MoE layers (``cfg.n_experts``) take
``moe.moe_apply`` in place of the MLP and sum its aux loss; the VLM
(``cfg.mrope``, ``cfg.frontend``) prepends projected frontend embeddings
and rotates with M-RoPE's stub (t, h, w) streams.

The embedding lookup is the gather ``embed[tokens]``, or under the
``onehot_embed`` hint (``dist.hints``) the reference's chunked one-hot
matmul :func:`_onehot_embed`, bitwise the gather; the embedded
activations and the logits carry the ``activations`` and ``logits``
layout hints, as in the reference.  ``forward`` is the training
form (each layer rematerialised in the backward, ``remat=True``) unless
``for_grad=False``, the reference's prefill form, which records no
gradient; ``loss`` is the training objective.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..core.pipeline import resolve_device
from ..dist import hints
from . import attention as attn
from . import moe as moe_mod
from .layers import (dense_init, dtype_of, embed_init, mlp_apply, mlp_init,
                     remat as remat_call, rmsnorm, rmsnorm_init, token_ce)


def _onehot_embed(tokens: torch.Tensor, embed: torch.Tensor,
                  chunk: int = 512) -> torch.Tensor:
    """The embedding lookup as a one-hot matmul in chunks of ``chunk``
    positions (the reference's collective-friendly lookup): each row is
    one weight times 1 plus zeros, so it is bitwise ``embed[tokens]``."""
    B, T = tokens.shape
    V, d = embed.shape
    c = min(chunk, T)
    pad = (-T) % c
    if pad:
        tokens = torch.nn.functional.pad(tokens, (0, pad))
    nc = (T + pad) // c
    toks = tokens.reshape(B, nc, c).transpose(0, 1)          # (nc, B, c)
    xs = [torch.einsum("bcv,vd->bcd",
                       torch.nn.functional.one_hot(t, V).to(embed.dtype),
                       embed) for t in toks]
    x = torch.stack(xs).transpose(0, 1).reshape(B, nc * c, d)
    return x[:, :T]


def layer_windows(cfg) -> list:
    """Static per-layer window sizes (0 = full attention)."""
    if cfg.local_global_ratio > 0:
        period = cfg.local_global_ratio + 1
        return [cfg.local_window if (i % period) != cfg.local_global_ratio
                else 0 for i in range(cfg.n_layers)]
    return [cfg.window] * cfg.n_layers


class DecoderModel:
    """Dense, MoE or VLM decoder-only language model on one device.

    ``device`` is CUDA unless the caller says otherwise (``"cpu"`` runs
    the plain PyTorch path); with no card and no ``device="cpu"`` the
    constructor raises.  ``params`` are the dict that :meth:`init` (or
    ``interop.params_from_jax``) returns: ``embed`` (vocab_padded, d),
    ``ln_f``, ``layers``, a list of per-layer dicts (``mlp`` or ``moe``),
    and ``frontend_proj`` where the config has a frontend.
    ``kv_quant=True`` serves from int8 KV caches.
    """

    # the keys whose per-layer lists the reference stacks into (L, ...)
    # arrays (gradient compression takes one scale across their layers)
    stacked = ("layers",)

    def __init__(self, cfg, *, kv_quant: bool = False, device=None):
        if cfg.family not in ("dense", "moe", "vlm") or cfg.is_encdec:
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a "
                             f"decoder-only transformer")
        self.cfg = cfg
        self.kv_quant = kv_quant
        self.windows = layer_windows(cfg)
        self.device = resolve_device(device)
        self.dtype = dtype_of(cfg)

    # -- params ------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Dict[str, object]:
        """Random weights drawn from ``gen``, a generator on the model's
        device (its device type must match)."""
        check_generator(gen, self.device)
        cfg, dt, dev = self.cfg, self.dtype, self.device
        params = {"embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, dt)}
        layers = []
        for _ in range(cfg.n_layers):
            lp = {"ln1": rmsnorm_init(cfg.d_model, dt, dev),
                  "attn": attn.attn_init(gen, cfg, dt),
                  "ln2": rmsnorm_init(cfg.d_model, dt, dev)}
            if cfg.n_experts:
                lp["moe"] = moe_mod.moe_init(gen, cfg, dt)
            else:
                lp["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dt)
            layers.append(lp)
        params["layers"] = layers
        params["ln_f"] = rmsnorm_init(cfg.d_model, dt, dev)
        if cfg.frontend != "none":
            # the multimodal stub adapter: precomputed frontend embeddings
            # in d_model pass through one learned projection
            params["frontend_proj"] = dense_init(gen, cfg.d_model,
                                                 cfg.d_model, dt)
        return params

    # -- shared pieces -------------------------------------------------------
    def _positions(self, B: int, T: int) -> torch.Tensor:
        pos = torch.arange(T, dtype=torch.int32, device=self.device)
        pos = pos[None, :].expand(B, T)
        if not self.cfg.mrope:
            return pos
        # M-RoPE stub streams: the first frontend_len positions get (t, h,
        # w) grid ids on a 16-wide grid, the rest equal streams (plain
        # RoPE), whether or not the sequence has a frontend
        Fl = self.cfg.frontend_len
        h_ids = torch.where(pos < Fl, pos // 16, pos)
        w_ids = torch.where(pos < Fl, pos % 16, pos)
        return torch.stack([pos, h_ids, w_ids])                 # (3, B, T)

    def _ffn(self, p, m):
        """(the layer's MLP or MoE output, its aux loss or 0.0)."""
        if self.cfg.n_experts:
            return moe_mod.moe_apply(p["moe"], m, self.cfg)
        return mlp_apply(p["mlp"], m, self.cfg.mlp), 0.0

    def _block(self, p, x, positions, window, backend):
        h = rmsnorm(p["ln1"], x)
        a, kv = attn.attention_full(p["attn"], h, positions, cfg=self.cfg,
                                    window=window, backend=backend)
        x = x + a
        f, aux = self._ffn(p, rmsnorm(p["ln2"], x))
        return x + f, kv, aux

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed(self, params, tokens, extra_embeds) -> torch.Tensor:
        if hints.get("onehot_embed"):
            x = _onehot_embed(self._tokens(tokens), params["embed"])
        else:
            x = params["embed"][self._tokens(tokens)]
        if self.cfg.frontend != "none" and extra_embeds is not None:
            fe = torch.as_tensor(extra_embeds, device=self.device)
            fe = fe.to(x.dtype) @ params["frontend_proj"]
            x = torch.cat([fe, x], dim=1)
        return hints.constrain(x, "activations")

    # -- full-sequence forward (train / prefill) -----------------------------
    def forward(self, params, tokens, extra_embeds=None, *,
                remat: bool = True, collect_kv: bool = False,
                backend: str = "auto", for_grad: bool = True, **_chunks):
        """tokens: (B, T) integers; ``extra_embeds``: (B, F, d) frontend
        embeddings, prepended (VLM).  Returns (logits (B, F + T,
        vocab_padded) f32, [(k, v) per layer] or None, aux), as the
        reference's (logits, stacked_kv, aux) with the layer axis as a
        list; aux is the MoE layers' summed load-balance loss (0.0 for a
        dense model).  ``remat``: each layer's activations recomputed in
        the backward; ``for_grad=False``: no gradient recorded (prefill).
        The reference's chunk sizes are taken and ignored."""
        with torch.set_grad_enabled(for_grad and torch.is_grad_enabled()):
            x = self._embed(params, tokens, extra_embeds)
            B, T, _ = x.shape
            positions = self._positions(B, T)
            kvs: Optional[List] = [] if collect_kv else None
            aux_total = 0.0
            for p, w in zip(params["layers"], self.windows):
                x, kv, aux = remat_call(self._block, p, x, positions, w,
                                        backend, enabled=remat)
                aux_total = aux_total + aux
                if collect_kv:
                    kvs.append(kv)
            x = rmsnorm(params["ln_f"], x)
            logits = hints.constrain(x @ params["embed"].T,   # tied head
                                     "logits").float()
        return logits, kvs, aux_total

    def loss(self, params, batch, *, remat: bool = True,
             aux_weight: float = 0.01, backend: str = "auto", **_chunks):
        """batch: {"tokens": (B, T), "targets": (B, T), optional
        "frontend": (B, F, d)}.  Returns (ce + aux_weight * aux, {"ce",
        "aux"}), 0-d fp32 tensors; the frontend positions are left out
        of the loss."""
        cfg = self.cfg
        logits, _, aux = self.forward(params, batch["tokens"],
                                      batch.get("frontend"), remat=remat,
                                      backend=backend)
        F = cfg.frontend_len if (cfg.frontend != "none"
                                 and "frontend" in batch) else 0
        ce = token_ce(logits[:, F:], batch["targets"], cfg.vocab)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
        return ce + aux_weight * aux, {"ce": ce.detach(),
                                       "aux": aux.detach()}

    # -- serving --------------------------------------------------------------
    def cache_capacities(self, max_len: int) -> list:
        return [min(w, max_len) if w > 0 else max_len for w in self.windows]

    def _cache_init(self, batch: int, capacity: int):
        if self.kv_quant:
            return attn.quant_cache_init(self.cfg, batch, capacity,
                                         self.device)
        return attn.cache_init(self.cfg, batch, capacity, self.dtype,
                               self.device)

    @torch.no_grad()
    def prefill(self, params, tokens, extra_embeds=None, *, max_len: int,
                backend: str = "auto"):
        """Run the full prompt (after the frontend embeddings, if any) and
        build per-layer caches sized for max_len.  Returns (last-token
        logits (B, vocab), caches, next_pos)."""
        logits, kvs, _ = self.forward(params, tokens, extra_embeds,
                                      collect_kv=True, backend=backend,
                                      for_grad=False)
        B, T = logits.shape[0], logits.shape[1]
        positions = torch.arange(T, dtype=torch.int32,
                                 device=self.device)[None]
        fill = attn.quant_cache_fill_from_prefill if self.kv_quant \
            else attn.cache_fill_from_prefill
        caches = [fill(self._cache_init(B, cap), k, v, positions)
                  for (k, v), cap in zip(kvs, self.cache_capacities(max_len))]
        return logits[:, -1, :self.cfg.vocab], caches, T

    def decode_state(self, batch: int, max_len: int) -> list:
        """Empty decode caches (slot_pos -1 everywhere)."""
        return [self._cache_init(batch, cap)
                for cap in self.cache_capacities(max_len)]

    @torch.no_grad()
    def decode_step(self, params, caches, token, pos):
        """token: (B,) integers; pos: an int or a (B,) tensor.  Updates
        ``caches`` in place; returns (logits (B, vocab) f32, caches)."""
        cfg = self.cfg
        dec = attn.attention_decode_quant if self.kv_quant \
            else attn.attention_decode
        x = params["embed"][self._tokens(token)][:, None, :]   # (B, 1, d)
        for li, p in enumerate(params["layers"]):
            h = rmsnorm(p["ln1"], x)
            a, _ = dec(p["attn"], h, caches[li], pos, cfg=cfg,
                       window=self.windows[li])
            x = x + a
            f, _ = self._ffn(p, rmsnorm(p["ln2"], x))
            x = x + f
        x = rmsnorm(params["ln_f"], x)
        logits = (x @ params["embed"].T).float()
        return logits[:, 0, :cfg.vocab], caches


def check_generator(gen: torch.Generator, device: torch.device) -> None:
    """Raise unless ``gen`` draws on the model's device type."""
    if torch.device(gen.device).type != device.type:
        raise ValueError(f"generator on {gen.device}, model on {device}")
