"""Hybrid (zamba2) and recurrent (xLSTM) model assemblies.

The port of ``repro.models.hybrid``.

zamba2: a backbone of Mamba2 layers with one weight-shared attention
block (and its own MLP) applied after every ``attn_every`` layers, with
a sliding-window KV cache per application.  Its decode state is the
reference's dict: ``mamba_S``, a list per group of the group's states
stacked (attn_every, B, H, N, P) -- the batch axis second --, ``conv``,
one (B, K-1, C) history per layer, and ``kv``, one cache per group.  As
in the reference, prefill does not carry the conv history through: decode
restarts it at zeros (a documented simplification of the stub serving
path).

xLSTM: a per-layer block pattern ("m" an mLSTM block, "s" an sLSTM
block and an MLP); ``layers`` is a heterogeneous list, and decode carries
one recurrent state per layer and no KV cache.

The Mamba2 and xLSTM states are new tensors each decode step (a
stacked ``mamba_S`` of batch 1, as the serving engine leaves it,
broadcasts to the batch on the first step, as in the reference); the
attention caches are written in place, as in ``transformer``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..core.pipeline import resolve_device
from . import attention as attn
from . import ssm
from .layers import (dtype_of, embed_init, mlp_apply, mlp_init, rmsnorm,
                     rmsnorm_init)
from .transformer import check_generator


class Zamba2Model:
    """zamba2 on one device (CUDA unless ``device="cpu"``)."""

    def __init__(self, cfg, *, device=None):
        if not (cfg.attn_every > 0 and cfg.ssm_state > 0):
            raise ValueError(f"{cfg.name}: zamba2 needs attn_every and "
                             f"ssm_state")
        if cfg.n_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not "
                             f"a multiple of attn_every {cfg.attn_every}")
        self.cfg = cfg
        self.n_groups = cfg.n_layers // cfg.attn_every
        self.device = resolve_device(device)
        self.dtype = dtype_of(cfg)

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        check_generator(gen, self.device)
        cfg, dt, dev = self.cfg, self.dtype, self.device
        embed = embed_init(gen, cfg.vocab_padded, cfg.d_model, dt)
        layers = [{"ln": rmsnorm_init(cfg.d_model, dt, dev),
                   "mamba": ssm.mamba2_init(gen, cfg, dt)}
                  for _ in range(cfg.n_layers)]
        return {
            "embed": embed,
            "layers": layers,
            # the single shared attention block, with its own MLP
            "shared": {
                "ln1": rmsnorm_init(cfg.d_model, dt, dev),
                "attn": attn.attn_init(gen, cfg, dt),
                "ln2": rmsnorm_init(cfg.d_model, dt, dev),
                "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dt),
            },
            "ln_f": rmsnorm_init(cfg.d_model, dt, dev),
        }

    def _group(self, params, g: int) -> list:
        a = self.cfg.attn_every
        return params["layers"][g * a:(g + 1) * a]

    def _cap(self, max_len: int) -> int:
        w = self.cfg.window
        return min(w, max_len) if w > 0 else max_len

    def _shared_block(self, sp, x, pos, backend):
        a, kv = attn.attention_full(sp["attn"], rmsnorm(sp["ln1"], x), pos,
                                    cfg=self.cfg, window=self.cfg.window,
                                    backend=backend)
        x = x + a
        return x + mlp_apply(sp["mlp"], rmsnorm(sp["ln2"], x),
                             self.cfg.mlp), kv

    def _run(self, params, tokens, backend):
        """The full-sequence pass: (final hidden states, per group the
        stacked last Mamba2 states and the shared block's (k, v))."""
        x = params["embed"][torch.as_tensor(tokens, device=self.device)
                            .long()]
        B, T, _ = x.shape
        pos = torch.arange(T, dtype=torch.int32,
                           device=self.device)[None].expand(B, T)
        groups = []
        for g in range(self.n_groups):
            Ss = []
            for p in self._group(params, g):
                h, S = ssm.mamba2_forward(p["mamba"], rmsnorm(p["ln"], x),
                                          self.cfg)
                x = x + h
                Ss.append(S)
            x, kv = self._shared_block(params["shared"], x, pos, backend)
            groups.append((torch.stack(Ss), kv))
        return rmsnorm(params["ln_f"], x), groups

    @torch.no_grad()
    def forward(self, params, tokens, extra_embeds=None, *,
                collect_kv: bool = False, backend: str = "auto"):
        """tokens: (B, T).  Returns (logits (B, T, vocab_padded) f32,
        [(k, v) per group] or [], 0.0), as the reference's."""
        x, groups = self._run(params, tokens, backend)
        logits = (x @ params["embed"].T).float()
        return logits, [kv for _, kv in groups] if collect_kv else [], 0.0

    # -- serving -----------------------------------------------------------
    def _conv_zeros(self, batch: int) -> list:
        cfg = self.cfg
        C = cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_state
        return [torch.zeros((batch, cfg.ssm_conv - 1, C), dtype=self.dtype,
                            device=self.device)
                for _ in range(cfg.n_layers)]

    @torch.no_grad()
    def prefill(self, params, tokens, extra_embeds=None, *, max_len: int,
                backend: str = "auto"):
        """A forward pass that also keeps each group's last Mamba2 states
        and fills the shared block's cache per group.  Returns
        (last-token logits (B, vocab), state, next_pos)."""
        cfg = self.cfg
        x, groups = self._run(params, tokens, backend)
        B, T = x.shape[0], x.shape[1]
        positions = torch.arange(T, dtype=torch.int32,
                                 device=self.device)[None]
        caches = []
        for _, (k, v) in groups:
            c = attn.cache_init(cfg, B, self._cap(max_len), self.dtype,
                                self.device)
            caches.append(attn.cache_fill_from_prefill(c, k, v, positions))
        logits = (x[:, -1] @ params["embed"].T).float()[:, :cfg.vocab]
        state = {"mamba_S": [S for S, _ in groups],
                 "conv": self._conv_zeros(B), "kv": caches}
        return logits, state, T

    def decode_state(self, batch: int, max_len: int) -> dict:
        cfg = self.cfg
        din = cfg.ssm_expand * cfg.d_model
        H = din // cfg.ssm_head_dim
        return {
            "mamba_S": [torch.zeros((cfg.attn_every, batch, H, cfg.ssm_state,
                                     cfg.ssm_head_dim), dtype=torch.float32,
                                    device=self.device)
                        for _ in range(self.n_groups)],
            "conv": self._conv_zeros(batch),
            "kv": [attn.cache_init(cfg, batch, self._cap(max_len),
                                   self.dtype, self.device)
                   for _ in range(self.n_groups)],
        }

    @torch.no_grad()
    def decode_step(self, params, state, token, pos):
        """token: (B,); pos: an int or a (B,) tensor.  Returns (logits
        (B, vocab) f32, the new state dict)."""
        cfg = self.cfg
        x = params["embed"][torch.as_tensor(token, device=self.device)
                            .long()][:, None, :]
        sp = params["shared"]
        new_S, new_conv, new_kv = [], [], []
        for g in range(self.n_groups):
            S_stack, S_new = state["mamba_S"][g], []
            for j, p in enumerate(self._group(params, g)):
                li = g * cfg.attn_every + j
                ms = ssm.MambaState(S=S_stack[j], conv=state["conv"][li])
                h, ms2 = ssm.mamba2_decode(p["mamba"], rmsnorm(p["ln"], x),
                                           ms, cfg)
                x = x + h
                S_new.append(ms2.S)
                new_conv.append(ms2.conv)
            new_S.append(torch.stack(S_new))
            a, c = attn.attention_decode(sp["attn"], rmsnorm(sp["ln1"], x),
                                         state["kv"][g], pos, cfg=cfg,
                                         window=cfg.window)
            new_kv.append(c)
            x = x + a
            x = x + mlp_apply(sp["mlp"], rmsnorm(sp["ln2"], x), cfg.mlp)
        x = rmsnorm(params["ln_f"], x)
        logits = (x @ params["embed"].T).float()
        return logits[:, 0, :cfg.vocab], {"mamba_S": new_S,
                                          "conv": new_conv, "kv": new_kv}


class XLSTMModel:
    """xLSTM on one device (CUDA unless ``device="cpu"``)."""

    def __init__(self, cfg, *, device=None):
        if not cfg.block_pattern:
            raise ValueError(f"{cfg.name}: xLSTM needs a block pattern")
        self.cfg = cfg
        pattern = list(cfg.block_pattern)
        while len(pattern) < cfg.n_layers:
            pattern += list(cfg.block_pattern)
        self.pattern = pattern[:cfg.n_layers]
        self.device = resolve_device(device)
        self.dtype = dtype_of(cfg)

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        check_generator(gen, self.device)
        cfg, dt, dev = self.cfg, self.dtype, self.device
        embed = embed_init(gen, cfg.vocab_padded, cfg.d_model, dt)
        layers = []
        for kind in self.pattern:
            if kind == "m":
                layers.append({"kind_m": {
                    "ln": rmsnorm_init(cfg.d_model, dt, dev),
                    "cell": ssm.mlstm_init(gen, cfg, dt)}})
            else:
                layers.append({"kind_s": {
                    "ln": rmsnorm_init(cfg.d_model, dt, dev),
                    "cell": ssm.slstm_init(gen, cfg, dt),
                    "ln2": rmsnorm_init(cfg.d_model, dt, dev),
                    "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp,
                                    dt)}})
        return {"embed": embed,
                "layers": layers,   # heterogeneous: a list, not stacked
                "ln_f": rmsnorm_init(cfg.d_model, dt, dev)}

    def _apply_layer(self, p, kind, x, state=None):
        """One block over x; ``state`` given: one decode step from it.
        Returns (x, the block's new state)."""
        cfg = self.cfg
        if kind == "m":
            q = p["kind_m"]
            h_in = rmsnorm(q["ln"], x)
            h, st = ssm.mlstm_forward(q["cell"], h_in, cfg) if state is None \
                else ssm.mlstm_decode(q["cell"], h_in, state, cfg)
            return x + h, st
        q = p["kind_s"]
        h_in = rmsnorm(q["ln"], x)
        h, st = ssm.slstm_forward(q["cell"], h_in, cfg) if state is None \
            else ssm.slstm_decode(q["cell"], h_in, state, cfg)
        x = x + h
        return x + mlp_apply(q["mlp"], rmsnorm(q["ln2"], x), cfg.mlp), st

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    @torch.no_grad()
    def forward(self, params, tokens, extra_embeds=None, **_):
        """tokens: (B, T).  Returns (logits (B, T, vocab_padded) f32, the
        per-layer states, 0.0), as the reference's."""
        x = params["embed"][self._tokens(tokens)]
        states = []
        for p, kind in zip(params["layers"], self.pattern):
            x, st = self._apply_layer(p, kind, x)
            states.append(st)
        x = rmsnorm(params["ln_f"], x)
        return (x @ params["embed"].T).float(), states, 0.0

    def prefill(self, params, tokens, extra_embeds=None, *, max_len: int,
                **_):
        logits, states, _ = self.forward(params, tokens)
        return logits[:, -1, :self.cfg.vocab], states, int(logits.shape[1])

    def decode_state(self, batch: int, max_len: int) -> list:
        return [ssm.mlstm_state_init(self.cfg, batch, self.device)
                if kind == "m" else
                ssm.slstm_state_init(self.cfg, batch, self.device)
                for kind in self.pattern]

    @torch.no_grad()
    def decode_step(self, params, states, token, pos):
        x = params["embed"][self._tokens(token)][:, None, :]
        new_states = []
        for p, kind, st in zip(params["layers"], self.pattern, states):
            x, st = self._apply_layer(p, kind, x, st)
            new_states.append(st)
        x = rmsnorm(params["ln_f"], x)
        logits = (x @ params["embed"].T).float()
        return logits[:, 0, :self.cfg.vocab], new_states
