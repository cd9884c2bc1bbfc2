"""AdamW with a warmup-cosine schedule and global-norm clipping.

The port of ``repro.train.optimizer``: plain functions over parameter
trees (``train/tree.py``).  The moments are fp32 whatever the parameter
dtype (the mixed-precision convention); the update is computed in fp32
and cast back to each parameter's dtype.  Each call returns new tensors:
nothing is updated in place, so the train step's inputs stay valid.  The
update is elementwise, so the train step on a mesh applies it to each
rank's shards as they are, with the norm taken over every shard
(``gnorm=``).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from .tree import leaves, tree_map, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor    # 0-d int32
    mu: Any
    nu: Any


def schedule(step: torch.Tensor, *, lr: float, warmup_steps: int,
             total_steps: int) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine decay to 10% of it."""
    warm = torch.clamp(step.float() / max(warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - warmup_steps).float()
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return lr * warm * (0.1 + 0.9 * cos)


def init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, summed in leaf
    order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


def apply(params, grads, state: AdamWState, run_cfg, *, b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8,
          gnorm: Optional[torch.Tensor] = None):
    """One AdamW update; returns (new_params, new_state, metrics
    {"grad_norm", "lr"}).  ``gnorm`` is the gradients' global norm where
    the caller holds only shards of them (the train step on a mesh);
    by default :func:`global_norm` of ``grads``."""
    step = state.step + 1
    lr = schedule(step, lr=run_cfg.lr, warmup_steps=run_cfg.warmup_steps,
                  total_steps=run_cfg.total_steps)
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.clamp(run_cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if run_cfg.grad_clip > 0 else 1.0
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())

    def upd(p, g, m, v):
        g = g.float() * clip
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        p32 = p.float()
        delta = delta + run_cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in
           zip(leaves(params), leaves(grads), leaves(state.mu),
               leaves(state.nu))]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v), \
        {"grad_norm": gnorm, "lr": lr}
