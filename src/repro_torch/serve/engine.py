"""Batched serving engine with continuous batching.

The port of ``repro.serve.engine``: a slot-based scheduler over the
model's (prefill, decode_step) pair.

  * ``n_slots`` concurrent sequences share one decode batch;
  * finished and empty slots are refilled from the request queue by a
    single-sequence prefill whose cache is spliced into the batched
    cache at the slot index (``_splice``);
  * every engine step is one batched ``decode_step``, with a (B,) vector
    of per-slot positions, so sequences at different depths share it.

Caches are lists of ``KVCache`` tuples on the model's device; splicing
copies a batch-1 cache into one slot of the batched tensors in place.
Each step reads the next tokens back to the host once (the reference's
``np.asarray``), which is where the engine waits for the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch


@dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (T,) int32
    max_new_tokens: int = 16
    # filled by the engine
    output: List[int] = field(default_factory=list)
    done: bool = False


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in _leaves(sub)]


def _splice(batch_tree: Any, single_tree: Any, slot: int) -> Any:
    """Write a batch-1 cache tree into slot ``slot`` of a batched one, in
    place; leaves whose shapes do not match (batch-free) are kept."""
    for b, s in zip(_leaves(batch_tree), _leaves(single_tree)):
        if b.dim() >= 1 and s.dim() == b.dim() and s.shape[0] == 1 \
                and b.shape[1:] == s.shape[1:]:
            b[slot:slot + 1].copy_(s)
    return batch_tree


def _tile(tree: Any, n: int) -> Any:
    """A batch-n copy of a batch-1 cache tree (the first request's cache,
    repeated over every slot)."""
    if isinstance(tree, torch.Tensor):
        return torch.cat([tree] * n, dim=0) \
            if tree.dim() >= 1 and tree.shape[0] == 1 else tree
    return type(tree)(*(_tile(t, n) for t in tree)) \
        if hasattr(tree, "_fields") else [_tile(t, n) for t in tree]


class ServeEngine:
    def __init__(self, model, params, *, n_slots: int = 4,
                 max_len: int = 256, eos_id: int = -1):
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * n_slots
        self.tokens = torch.zeros((n_slots,), dtype=torch.long,
                                  device=model.device)
        self.caches = None           # batched cache tree
        self.slot_pos = [0] * n_slots
        self.steps = 0

    # -- queue management ---------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _prefill_one(self, req: Request):
        tokens = torch.as_tensor(np.asarray(req.prompt),
                                 device=self.model.device)[None]
        logits, cache, pos = self.model.prefill(self.params, tokens,
                                                max_len=self.max_len)
        next_tok = torch.argmax(logits[:, :self.cfg.vocab], -1)[0]
        return int(next_tok), cache, int(pos)

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.active[slot] is None and self.queue:
                req = self.queue.pop(0)
                tok, cache, pos = self._prefill_one(req)
                req.output.append(tok)
                self.active[slot] = req
                self.slot_pos[slot] = pos
                self.tokens[slot] = tok
                if self.caches is None:
                    self.caches = _tile(cache, self.n_slots)
                else:
                    _splice(self.caches, cache, slot)

    # -- stepping -------------------------------------------------------------
    def step(self) -> int:
        """One continuous-batching step; returns #active sequences."""
        self._admit()
        live = [s for s in range(self.n_slots) if self.active[s] is not None]
        if not live:
            return 0
        # one batched decode: empty slots step too and their outputs are
        # discarded; per-slot positions let sequences at different depths
        # share the batch
        pos = torch.tensor(self.slot_pos, dtype=torch.int32,
                           device=self.model.device)
        logits, self.caches = self.model.decode_step(
            self.params, self.caches, self.tokens, pos)
        next_tokens = torch.argmax(logits, -1).cpu().numpy()
        for s in live:
            req = self.active[s]
            tok = int(next_tokens[s])
            req.output.append(tok)
            self.slot_pos[s] += 1
            if tok == self.eos_id or len(req.output) >= req.max_new_tokens:
                req.done = True
                self.active[s] = None
            else:
                self.tokens[s] = tok
        self.steps += 1
        return len(live)

    def run(self, max_steps: int = 10_000) -> None:
        while (self.queue or any(self.active)) and self.steps < max_steps:
            self.step()
