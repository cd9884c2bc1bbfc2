"""Encoder-decoder assembly (the seamless-m4t family).

The port of ``repro.models.encdec``.  The encoder is a bidirectional
transformer over precomputed frontend frame embeddings (the speech
frontend is a stub, as in the reference), its attention the flash
kernels with ``causal=False``; the decoder is causal self-attention
(flash, then a KV cache) plus cross attention to the encoder memory.
Parameters keep the reference's names: ``enc_layers`` and
``dec_layers`` are lists of per-layer dicts.  The decode caches are a
dict ``{"self": [KVCache per layer], "cross": [(k, v) per layer]}``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.pipeline import resolve_device
from ..dist import hints
from . import attention as attn
from .layers import (dense_init, dtype_of, embed_init, mlp_apply, mlp_init,
                     remat as remat_call, rmsnorm, rmsnorm_init, token_ce)
from .transformer import check_generator


class EncDecModel:
    """Encoder-decoder LM on one device (CUDA unless ``device="cpu"``)."""

    # the keys whose per-layer lists the reference stacks into (L, ...)
    # arrays (gradient compression takes one scale across their layers)
    stacked = ("enc_layers", "dec_layers")

    def __init__(self, cfg, *, device=None):
        if not cfg.enc_layers > 0:
            raise ValueError(f"{cfg.name}: no encoder layers")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype_of(cfg)

    # -- params ------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        check_generator(gen, self.device)
        cfg, dt, dev = self.cfg, self.dtype, self.device
        d = cfg.d_model

        def ln():
            return rmsnorm_init(d, dt, dev)

        params = {"embed": embed_init(gen, cfg.vocab_padded, d, dt),
                  "frontend_proj": dense_init(gen, d, d, dt)}
        params["enc_layers"] = [
            {"ln1": ln(), "attn": attn.attn_init(gen, cfg, dt), "ln2": ln(),
             "mlp": mlp_init(gen, d, cfg.d_ff, cfg.mlp, dt)}
            for _ in range(cfg.enc_layers)]
        params["enc_ln_f"] = ln()
        params["dec_layers"] = [
            {"ln1": ln(), "attn": attn.attn_init(gen, cfg, dt), "lnx": ln(),
             "xattn": attn.attn_init(gen, cfg, dt), "ln2": ln(),
             "mlp": mlp_init(gen, d, cfg.d_ff, cfg.mlp, dt)}
            for _ in range(cfg.n_layers)]
        params["ln_f"] = ln()
        return params

    def _positions(self, B: int, T: int) -> torch.Tensor:
        return torch.arange(T, dtype=torch.int32,
                            device=self.device)[None].expand(B, T)

    # -- encoder -------------------------------------------------------------
    def _enc_layer(self, p, x, pos, backend):
        a, _ = attn.attention_full(p["attn"], rmsnorm(p["ln1"], x), pos,
                                   cfg=self.cfg, window=0, causal=False,
                                   backend=backend)
        x = x + a
        return x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x), self.cfg.mlp)

    def encode(self, params, frames, *, remat: bool = True,
               backend: str = "auto", for_grad: bool = True, **_chunks):
        """frames: (B, Te, d) precomputed frontend embeddings (the stub)
        -> the encoder memory (B, Te, d).  ``remat``: each layer
        recomputed in the backward; ``for_grad=False`` records no
        gradient."""
        with torch.set_grad_enabled(for_grad and torch.is_grad_enabled()):
            frames = torch.as_tensor(frames, device=self.device)
            x = frames.to(self.dtype) @ params["frontend_proj"]
            pos = self._positions(x.shape[0], x.shape[1])
            for p in params["enc_layers"]:
                x = remat_call(self._enc_layer, p, x, pos, backend,
                               enabled=remat)
            return rmsnorm(params["enc_ln_f"], x)

    # -- decoder -------------------------------------------------------------
    def _dec_layer(self, p, x, pos, enc_out, backend):
        cfg = self.cfg
        a, kv = attn.attention_full(p["attn"], rmsnorm(p["ln1"], x), pos,
                                    cfg=cfg, window=cfg.window,
                                    backend=backend)
        x = x + a
        enc_kv = attn.encoder_kv(p["xattn"], enc_out, cfg)
        x = x + attn.cross_attention(p["xattn"], rmsnorm(p["lnx"], x),
                                     enc_kv, cfg=cfg)
        x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x), cfg.mlp)
        return x, kv, enc_kv

    def _decode_stack(self, params, tokens, enc_out, backend,
                      remat: bool = False):
        """The decoder over the whole prompt: (final hidden states, per
        layer the self-attention (k, v) and the cross (k, v))."""
        x = params["embed"][torch.as_tensor(tokens, device=self.device)
                            .long()]
        pos = self._positions(x.shape[0], x.shape[1])
        kvs, cross = [], []
        for p in params["dec_layers"]:
            x, kv, enc_kv = remat_call(self._dec_layer, p, x, pos, enc_out,
                                       backend, enabled=remat)
            kvs.append(kv)
            cross.append(enc_kv)
        return rmsnorm(params["ln_f"], x), kvs, cross

    def forward(self, params, tokens, frames, *, remat: bool = True,
                backend: str = "auto", for_grad: bool = True, **_chunks):
        """Logits (B, T, vocab_padded) f32 of the decoder over tokens
        (B, T), given the frames (B, Te, d)."""
        with torch.set_grad_enabled(for_grad and torch.is_grad_enabled()):
            enc_out = self.encode(params, frames, remat=remat,
                                  backend=backend)
            x, _, _ = self._decode_stack(params, tokens, enc_out, backend,
                                         remat=remat)
            return hints.constrain(x @ params["embed"].T,
                                   "logits").float()

    def loss(self, params, batch, *, remat: bool = True,
             backend: str = "auto", **_chunks):
        """Mean next-token cross entropy of batch {"tokens", "targets",
        "frontend": the frames}: (ce, {"ce", "aux": 0}), as the
        reference's."""
        logits = self.forward(params, batch["tokens"], batch["frontend"],
                              remat=remat, backend=backend)
        ce = token_ce(logits, batch["targets"], self.cfg.vocab)
        return ce, {"ce": ce.detach(),
                    "aux": torch.zeros((), device=ce.device)}

    # -- serving ---------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, tokens, frames, *, max_len: int,
                backend: str = "auto"):
        """Encode, run the prompt through the decoder, fill the
        self-attention caches (capacity max_len) and keep each layer's
        cross (k, v).  Returns (last-token logits (B, vocab), caches,
        next_pos)."""
        cfg = self.cfg
        enc_out = self.encode(params, frames, remat=False, backend=backend)
        x, kvs, cross = self._decode_stack(params, tokens, enc_out, backend)
        B, T = x.shape[0], x.shape[1]
        logits = (x[:, -1] @ params["embed"].T).float()[:, :cfg.vocab]
        positions = torch.arange(T, dtype=torch.int32,
                                 device=self.device)[None]
        caches = [attn.cache_fill_from_prefill(
            attn.cache_init(cfg, B, max_len, self.dtype, self.device),
            k, v, positions) for k, v in kvs]
        return logits, {"self": caches, "cross": cross}, T

    def decode_state(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        shape = (batch, cfg.frontend_len, cfg.n_kv_heads, cfg.head_dim)

        def zeros():
            return torch.zeros(shape, dtype=self.dtype, device=self.device)

        return {"self": [attn.cache_init(cfg, batch, max_len, self.dtype,
                                         self.device)
                         for _ in range(cfg.n_layers)],
                "cross": [(zeros(), zeros()) for _ in range(cfg.n_layers)]}

    @torch.no_grad()
    def decode_step(self, params, caches, token, pos):
        """token: (B,); pos: an int or a (B,) tensor.  Writes the
        self-attention caches in place; returns (logits (B, vocab) f32,
        caches)."""
        cfg = self.cfg
        x = params["embed"][torch.as_tensor(token, device=self.device)
                            .long()][:, None, :]
        for li, p in enumerate(params["dec_layers"]):
            a, _ = attn.attention_decode(p["attn"], rmsnorm(p["ln1"], x),
                                         caches["self"][li], pos, cfg=cfg,
                                         window=cfg.window)
            x = x + a
            x = x + attn.cross_attention(p["xattn"], rmsnorm(p["lnx"], x),
                                         caches["cross"][li], cfg=cfg)
            x = x + mlp_apply(p["mlp"], rmsnorm(p["ln2"], x), cfg.mlp)
        x = rmsnorm(params["ln_f"], x)
        logits = (x @ params["embed"].T).float()
        return logits[:, 0, :cfg.vocab], caches
