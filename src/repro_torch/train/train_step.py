"""The train step: microbatched fp32 gradient accumulation and AdamW.

The port of ``repro.train.train_step``.  The reference's jitted step
becomes a plain function: ``torch.autograd.grad`` of ``model.loss`` with
respect to detached copies of the parameter leaves (the parameters
passed in are never modified), the microbatches taken one after another
(the reference's ``lax.scan``) with their gradients summed in fp32 and
divided by their count, then ``compress_grads`` (int8
quantize-dequantize) where the run asks for it, then AdamW.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..dist import compression
from . import optimizer
from .tree import leaves, tree_map, unflatten


def _microbatch(batch: Dict[str, Any], m: int, i: int) -> Dict[str, Any]:
    """Microbatch i of m: rows [i B/m, (i + 1) B/m) of every entry."""
    def leaf(x):
        B = x.shape[0]
        if B % m:
            raise ValueError(f"batch {B} % microbatches {m} != 0")
        return x[i * (B // m):(i + 1) * (B // m)]

    return {k: leaf(v) for k, v in batch.items()}


def value_and_grad(model, params, batch, loss_kwargs=None):
    """(loss, metrics, grads) of ``model.loss(params, batch,
    **loss_kwargs)``: grads in the parameters' dtypes, zeros for a leaf
    the loss does not reach (as JAX gives)."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, metrics = model.loss(unflatten(params, flat), batch,
                               **(loss_kwargs or {}))
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, flat)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        unflatten(params, grads)


def make_train_step(model, run_cfg, *, loss_kwargs: Optional[dict] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {"loss", "grad_norm", "lr", and the model's metrics at one
    microbatch}), each metric a 0-d tensor on the model's device."""
    loss_kwargs = dict(loss_kwargs or {})
    m = max(1, run_cfg.microbatches)

    def train_step(params, opt_state, batch):
        if m == 1:
            loss, metrics, grads = value_and_grad(model, params, batch,
                                                   loss_kwargs)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = None
            for i in range(m):
                l, _, g = value_and_grad(model, params,
                                          _microbatch(batch, m, i),
                                          loss_kwargs)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss = l if loss is None else loss + l
            grads = tree_map(lambda g: g / m, grads)
            loss = loss / m
            metrics = {}
        if run_cfg.compress_grads:
            grads = compression.compress_tree(grads, model.stacked)
        params, opt_state, opt_metrics = optimizer.apply(
            params, grads, opt_state, run_cfg)
        return params, opt_state, {"loss": loss, **opt_metrics, **metrics}

    return train_step


def make_eval_step(model, *, loss_kwargs: Optional[dict] = None):
    """Returns eval_step(params, batch) -> {"loss", and the model's
    metrics}, with no gradient recorded."""
    loss_kwargs = dict(loss_kwargs or {})

    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = model.loss(params, batch, **loss_kwargs)
        return {"loss": loss, **metrics}

    return eval_step
