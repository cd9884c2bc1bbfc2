"""Decoder-only LM assembly for ``family="dense"``.

The port of the dense paths of ``repro.models.transformer``.  The
reference scans over layers stacked on a leading axis (one block in
HLO); PyTorch runs eagerly, so the port keeps a list of per-layer
parameter dicts and a Python loop over it, for prefill and decode
alike.  Local (window) layers keep W-slot ring buffers and global layers
full-length caches, as in the reference.

The reference's ``dist.hints.constrain`` calls and its ``_onehot_embed``
lookup do nothing without a device mesh and the ``onehot_embed`` hint,
which a single card never has, so the port takes the plain gather
``embed[tokens]`` and no layout constraint.  ``forward`` is the prefill
form (no remat, no gradient): training waits for its own slice
(ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..core.pipeline import resolve_device
from . import attention as attn
from .layers import (dtype_of, embed_init, mlp_apply, mlp_init, rmsnorm,
                     rmsnorm_init)


def layer_windows(cfg) -> list:
    """Static per-layer window sizes (0 = full attention)."""
    if cfg.local_global_ratio > 0:
        period = cfg.local_global_ratio + 1
        return [cfg.local_window if (i % period) != cfg.local_global_ratio
                else 0 for i in range(cfg.n_layers)]
    return [cfg.window] * cfg.n_layers


class DecoderModel:
    """Dense decoder-only language model on one device.

    ``device`` is CUDA unless the caller says otherwise (``"cpu"`` runs
    the plain PyTorch path); with no card and no ``device="cpu"`` the
    constructor raises.  ``params`` are the dict that :meth:`init` (or
    ``interop.params_from_jax``) returns: ``embed`` (vocab_padded, d),
    ``ln_f``, and ``layers``, a list of per-layer dicts.
    """

    def __init__(self, cfg, *, device=None):
        if cfg.n_experts:
            raise NotImplementedError(
                f"{cfg.name}: MoE layers (models/moe.py) are not ported yet: "
                f"ROADMAP Queue 1 item 15")
        if cfg.family != "dense" or cfg.mrope or cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet; "
                f"DecoderModel serves family='dense' (ROADMAP Queue 1 "
                f"item 15)")
        self.cfg = cfg
        self.windows = layer_windows(cfg)
        self.device = resolve_device(device)
        self.dtype = dtype_of(cfg)

    # -- params ------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Dict[str, object]:
        """Random weights drawn from ``gen``, a generator on the model's
        device (its device type must match)."""
        if torch.device(gen.device).type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        cfg, dt, dev = self.cfg, self.dtype, self.device
        params = {"embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, dt)}
        layers = []
        for _ in range(cfg.n_layers):
            layers.append({
                "ln1": rmsnorm_init(cfg.d_model, dt, dev),
                "attn": attn.attn_init(gen, cfg, dt),
                "ln2": rmsnorm_init(cfg.d_model, dt, dev),
                "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dt),
            })
        params["layers"] = layers
        params["ln_f"] = rmsnorm_init(cfg.d_model, dt, dev)
        return params

    # -- shared pieces -------------------------------------------------------
    def _positions(self, B: int, T: int) -> torch.Tensor:
        pos = torch.arange(T, dtype=torch.int32, device=self.device)
        return pos[None, :].expand(B, T)

    def _block(self, p, x, positions, window, backend):
        h = rmsnorm(p["ln1"], x)
        a, kv = attn.attention_full(p["attn"], h, positions, cfg=self.cfg,
                                    window=window, backend=backend)
        x = x + a
        m = rmsnorm(p["ln2"], x)
        return x + mlp_apply(p["mlp"], m, self.cfg.mlp), kv

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    # -- full-sequence forward (prefill) -------------------------------------
    @torch.no_grad()
    def forward(self, params, tokens, *, collect_kv: bool = False,
                backend: str = "auto"):
        """tokens: (B, T) integers.  Returns (logits (B, T, vocab_padded)
        f32, [(k, v) per layer] or None, aux = 0.0), as the reference's
        (logits, stacked_kv, aux) with the layer axis as a list."""
        tokens = self._tokens(tokens)
        x = params["embed"][tokens]
        B, T, _ = x.shape
        positions = self._positions(B, T)
        kvs: Optional[List] = [] if collect_kv else None
        for p, w in zip(params["layers"], self.windows):
            x, kv = self._block(p, x, positions, w, backend)
            if collect_kv:
                kvs.append(kv)
        x = rmsnorm(params["ln_f"], x)
        logits = (x @ params["embed"].T).float()         # tied head
        return logits, kvs, 0.0

    # -- serving --------------------------------------------------------------
    def cache_capacities(self, max_len: int) -> list:
        return [min(w, max_len) if w > 0 else max_len for w in self.windows]

    @torch.no_grad()
    def prefill(self, params, tokens, *, max_len: int,
                backend: str = "auto"):
        """Run the full prompt and build per-layer caches sized for
        max_len.  Returns (last-token logits (B, vocab), caches,
        next_pos)."""
        logits, kvs, _ = self.forward(params, tokens, collect_kv=True,
                                      backend=backend)
        B, T = logits.shape[0], logits.shape[1]
        positions = torch.arange(T, dtype=torch.int32,
                                 device=self.device)[None]
        caches = []
        for (k, v), cap in zip(kvs, self.cache_capacities(max_len)):
            c = attn.cache_init(self.cfg, B, cap, self.dtype, self.device)
            caches.append(attn.cache_fill_from_prefill(c, k, v, positions))
        return logits[:, -1, :self.cfg.vocab], caches, T

    def decode_state(self, batch: int, max_len: int) -> list:
        """Empty decode caches (slot_pos -1 everywhere)."""
        return [attn.cache_init(self.cfg, batch, cap, self.dtype, self.device)
                for cap in self.cache_capacities(max_len)]

    @torch.no_grad()
    def decode_step(self, params, caches, token, pos):
        """token: (B,) integers; pos: an int or a (B,) tensor.  Updates
        ``caches`` in place; returns (logits (B, vocab) f32, caches)."""
        cfg = self.cfg
        x = params["embed"][self._tokens(token)][:, None, :]   # (B, 1, d)
        for li, p in enumerate(params["layers"]):
            h = rmsnorm(p["ln1"], x)
            a, _ = attn.attention_decode(p["attn"], h, caches[li], pos,
                                         cfg=cfg, window=self.windows[li])
            x = x + a
            m = rmsnorm(p["ln2"], x)
            x = x + mlp_apply(p["mlp"], m, cfg.mlp)
        x = rmsnorm(params["ln_f"], x)
        logits = (x @ params["embed"].T).float()
        return logits[:, 0, :cfg.vocab], caches
