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

On a device mesh (``model_ranks`` bound, ``dist/tensor_parallel.py``)
the model takes its leaves as stored (DTensors laid out by
``param_specs``) and splits its work over the ``model`` ranks as the
reference's GSPMD program does: each layer's compute blocks gathered
inside the function ``remat`` checkpoints (attention heads, MLP and
expert d_ff, ``attention.tp_blocks``, ``moe.tp_blocks``), the
vocabulary split for the lookup, the head and the cross entropy,
``prefill``'s logits vocabulary-split until the last position's are
gathered, and decode caches split by sequence over the model ranks
where their placements say so.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from torch.distributed.tensor import DTensor, Replicate, Shard

from ..core.pipeline import resolve_device
from ..dist import hints
from ..dist import tensor_parallel as tp_mod
from . import attention as attn
from . import moe as moe_mod
from .layers import (dense_init, dtype_of, embed_init, mlp_apply, mlp_blocks,
                     mlp_init, remat as remat_call, rmsnorm, rmsnorm_init,
                     token_ce)


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
    # splits its work over a mesh's model ranks (dist/tensor_parallel.py)
    model_parallel = True

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

    def _compute_blocks(self, p, decode: bool = False):
        """One layer's leaves as this rank computes with them (the leaves
        themselves unless ``model_ranks`` is bound)."""
        if tp_mod.current() is None:
            return p
        spec = {"ln1": {"scale": tp_mod.WHOLE},
                "attn": attn.tp_blocks(self.cfg, decode),
                "ln2": {"scale": tp_mod.WHOLE}}
        if self.cfg.n_experts:
            spec["moe"] = moe_mod.tp_blocks(self.cfg)
        else:
            spec["mlp"] = mlp_blocks(self.cfg.mlp, self.cfg.d_ff)
        return tp_mod.blocks(p, spec)

    def _vocab(self, params) -> torch.Tensor:
        """The embedding rows this rank computes with (all of them unless
        ``model_ranks`` is bound)."""
        if tp_mod.current() is None:
            return params["embed"]
        return tp_mod.weight(params["embed"],
                             tp_mod.split(0, self.cfg.vocab_padded))

    def _head(self, params, E, x) -> torch.Tensor:
        """The final norm and the tied head's fp32 logits of x (the
        rank's vocabulary block under ``model_ranks``)."""
        x = rmsnorm(tp_mod.blocks(params["ln_f"], {"scale": tp_mod.WHOLE}),
                    x)
        return hints.constrain(tp_mod.enter(x) @ E.T, "logits").float()

    def _block(self, p, x, positions, window, backend):
        p = self._compute_blocks(p)
        h = rmsnorm(p["ln1"], x)
        a, kv = attn.attention_full(p["attn"], h, positions, cfg=self.cfg,
                                    window=window, backend=backend)
        x = x + a
        f, aux = self._ffn(p, rmsnorm(p["ln2"], x))
        return x + f, kv, aux

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, DTensor):
            tokens = tokens.to_local()
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed(self, params, E, tokens, extra_embeds) -> torch.Tensor:
        """The embedded tokens (E: the embedding rows this rank holds),
        after the projected frontend embeddings where given."""
        if tp_mod.degree() > 1:
            x = tp_mod.embed_lookup(E, self._tokens(tokens))
        elif hints.get("onehot_embed"):
            x = _onehot_embed(self._tokens(tokens), E)
        else:
            x = E[self._tokens(tokens)]
        if self.cfg.frontend != "none" and extra_embeds is not None:
            if isinstance(extra_embeds, DTensor):
                extra_embeds = extra_embeds.to_local()
            fe = torch.as_tensor(extra_embeds, device=self.device)
            if tp_mod.current() is None:
                fe = fe.to(x.dtype) @ params["frontend_proj"]
            else:
                # column-parallel, the columns gathered over the ranks
                w = tp_mod.weight(params["frontend_proj"],
                                  tp_mod.split(1, self.cfg.d_model))
                fe = tp_mod.gather_last(tp_mod.enter(fe.to(x.dtype)) @ w)
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
        The reference's chunk sizes are taken and ignored.  Under
        ``model_ranks`` the logits are this rank's block of vocab_padded
        / t and each (k, v) its kv heads."""
        with torch.set_grad_enabled(for_grad and torch.is_grad_enabled()):
            E = self._vocab(params)
            x, kvs, aux_total = self._trunk(params, E, tokens, extra_embeds,
                                            remat, collect_kv, backend)
            logits = self._head(params, E, x)              # tied head
        return logits, kvs, aux_total

    def _trunk(self, params, E, tokens, extra_embeds, remat, collect_kv,
               backend):
        """(the last layer's output (B, F + T, d), [(k, v) per layer] or
        None, aux) of the embedded tokens."""
        x = self._embed(params, E, tokens, extra_embeds)
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
        return x, kvs, aux_total

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
        logits (B, vocab), caches, next_pos).  Under ``model_ranks``
        (the leaves stored DTensors, ``tokens`` this rank's rows or a
        DTensor of the batch) only the last position's logits are formed
        and gathered over the vocabulary, and the caches are DTensors
        split by sequence over the model ranks where t divides their
        capacity (:meth:`_placed_cache`)."""
        if tp_mod.current() is not None:
            return self._prefill_split(params, tokens, extra_embeds,
                                       max_len, backend)
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

    def _prefill_split(self, params, tokens, extra_embeds, max_len, backend):
        E = self._vocab(params)
        x, kvs, _ = self._trunk(params, E, tokens, extra_embeds, False, True,
                                backend)
        logits = tp_mod.gather_last(self._head(params, E, x[:, -1:]))
        T = x.shape[1]
        del x
        caches = []
        for li, cap in enumerate(self.cache_capacities(max_len)):
            k, v = (self._whole_heads(t_) for t_ in kvs[li])
            kvs[li] = None
            caches.append(self._placed_cache(k, v, T, cap, tokens))
            del k, v
        return logits[:, -1, :self.cfg.vocab], caches, T

    def _whole_heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, KV, hd) from the ranks' kv heads (B, T, KV_l, hd):
        gathered over the model ranks, each head taken from the first
        rank that holds it."""
        if tp_mod.degree() == 1:
            return x
        t = tp_mod.degree()
        both = tp_mod.gather_last(x.movedim(2, -1).contiguous())
        KVl = x.shape[2]
        heads = []
        for r in range(t):
            k0 = attn.head_plan(self.cfg, t, r)[2]
            heads += [r * KVl + j for j in range(KVl)
                      if k0 + j == len(heads)]
        idx = torch.tensor(heads, device=x.device)
        return both.index_select(-1, idx).movedim(-1, 2).contiguous()

    def _placed_cache(self, k, v, T: int, S: int, tokens):
        """The prefill's (k, v) (B, T, KV, hd) written into a cache of S
        slots (positions from 0) as DTensors on the binding's mesh: this
        rank's rows of the batch (split over the data dims as ``tokens``
        is, where it is a DTensor) and, where t divides S, its S / t
        slots."""
        tp = tp_mod.current()
        mesh = tp.mesh
        t = tp.size
        split = t > 1 and S % t == 0
        S_l = S // t if split else S
        first = tp.index * S_l if split else 0
        B = k.shape[0]
        cache = self._cache_init(B, S_l)
        # the position each of this rank's slots holds: slot s holds
        # position s (S >= T) or the last of [T - S, T) that is s mod S
        slots = torch.arange(first, first + S_l, device=k.device)
        if S >= T:
            pos = torch.where(slots < T, slots, -1)
        else:
            pos = T - S + (slots - (T - S)) % S
        have = (pos >= 0)
        src = pos.clamp(min=0)
        kk, vv = k[:, src], v[:, src]
        if self.kv_quant:
            (qk, sk), (qv, sv) = attn._quant(kk), attn._quant(vv)
            new = (qk, qv, sk, sv)
        else:
            new = (kk, vv)
        for f, val in zip(cache[:-1], new):
            keep = have.reshape((1, S_l) + (1,) * (val.dim() - 2))
            f.copy_(torch.where(keep, val, f))
        cache.slot_pos.copy_(torch.where(have, pos, -1).to(torch.int32)
                             .expand(B, S_l))
        lay = [Replicate()] * mesh.ndim
        if isinstance(tokens, DTensor):
            for i, p_ in enumerate(tokens.placements):
                if i != tp.dim and isinstance(p_, Shard):
                    lay[i] = Shard(0)
        if split:
            lay[tp.dim] = Shard(1)
        B_all = tokens.shape[0] if isinstance(tokens, DTensor) else B

        def placed(x):
            shape = (B_all, S) + tuple(x.shape[2:])
            return DTensor.from_local(
                x, mesh, tuple(lay), run_check=False, shape=shape,
                stride=torch.empty(shape, device="meta").stride())

        return type(cache)(*(placed(x) for x in cache))

    def decode_state(self, batch: int, max_len: int) -> list:
        """Empty decode caches (slot_pos -1 everywhere)."""
        return [self._cache_init(batch, cap)
                for cap in self.cache_capacities(max_len)]

    @torch.no_grad()
    def decode_step(self, params, caches, token, pos):
        """token: (B,) integers; pos: an int or a (B,) tensor.  Updates
        ``caches`` in place; returns (logits (B, vocab) f32, caches).
        Under ``model_ranks`` the leaves are stored DTensors, ``token``
        this rank's rows (or a DTensor of them) and a cache whose leaves
        are DTensors split by sequence over the model ranks (dim 1) is
        read over this rank's slots."""
        cfg = self.cfg
        dec = attn.attention_decode_quant if self.kv_quant \
            else attn.attention_decode
        E = self._vocab(params)
        if tp_mod.degree() > 1:
            x = tp_mod.embed_lookup(E, self._tokens(token))[:, None, :]
        else:
            x = E[self._tokens(token)][:, None, :]           # (B, 1, d)
        for li, p in enumerate(params["layers"]):
            p = self._compute_blocks(p, decode=True)
            cache, seq = _local_cache(caches[li])
            h = rmsnorm(p["ln1"], x)
            a, _ = dec(p["attn"], h, cache, pos, cfg=cfg,
                       window=self.windows[li], seq=seq)
            x = x + a
            f, _ = self._ffn(p, rmsnorm(p["ln2"], x))
            x = x + f
        logits = tp_mod.gather_last(self._head(params, E, x))
        return logits[:, 0, :cfg.vocab], caches


def _local_cache(cache):
    """(the cache's local tensors, seq): seq = (first slot, S) where its
    leaves are DTensors split by sequence over the model ranks, else
    None."""
    if not isinstance(cache.k, DTensor):
        return cache, None
    local = type(cache)(*(x.to_local() for x in cache))
    tp = tp_mod.current()
    if tp is None or tp.dim is None \
            or not isinstance(cache.k.placements[tp.dim], Shard):
        return local, None
    S_l = local.k.shape[1]
    return local, (tp.index * S_l, cache.k.shape[1])


def check_generator(gen: torch.Generator, device: torch.device) -> None:
    """Raise unless ``gen`` draws on the model's device type."""
    if torch.device(gen.device).type != device.type:
        raise ValueError(f"generator on {gen.device}, model on {device}")
