"""The train step: microbatched fp32 gradient accumulation and AdamW, on
one device or on a device mesh.

The port of ``repro.train.train_step``.  The reference's jitted step
becomes a plain function: ``torch.autograd.grad`` of ``model.loss`` with
respect to detached copies of the parameter leaves (the parameters
passed in are never modified), the microbatches taken one after another
(the reference's ``lax.scan``) with their gradients summed in fp32 and
divided by their count, then ``compress_grads`` (int8
quantize-dequantize) where the run asks for it, then AdamW.

``make_train_step(model, run_cfg, mesh)`` is the counterpart of the
reference's ``jax.jit`` with ``in_shardings`` from ``dist/sharding.py``.
Its parameters and AdamW moments are DTensors laid out by
``param_shardings`` and its batch is laid out by ``batch_shardings``.
Each rank

  1. takes the loss and gradients of its own rows of the batch.  A
     dense, MoE or VLM model (``model_parallel``) gets the leaves as
     stored and splits its work over the mesh's ``model`` ranks as the
     reference's GSPMD program does (``dist/tensor_parallel.py``, bound
     as ``model_ranks``): each layer's leaves gathered over the data
     ranks inside the function ``layers.remat`` checkpoints (so one
     layer's at a time, and again in the backward's recomputation), the
     rank's heads, d_ff columns and vocabulary rows cut from them, and
     each gradient summed over the data ranks back into the leaf's
     stored layout by the gather's backward (a reduce-scatter).  Any
     other model gets each leaf gathered whole (``full_tensor``:
     ZeRO-3) and its gradients summed over the data ranks after;
  2. divides the gradients by the number of data ranks and keeps its
     block of each leaf under the moments' placements (with
     microbatches, each microbatch's gradients in fp32 as they come,
     their blocks added up in fp32), and averages the loss and the
     model's metrics over the data ranks;
  3. takes the quantities that span every shard of a leaf globally: the
     int8 scale of ``compress_grads`` (a max of the shards' maxima,
     shared across a stack's layers as in ``compression.compress_tree``)
     and the clip's gradient norm (a sum of the shards' sums of squares,
     each block counted once);
  4. applies AdamW to its blocks and returns new DTensors of the
     inputs' placements.

Where a leaf's parameters are placed otherwise than its moments
(``weights_mode="tp_only"``: replicated over data), its gradient comes
out of the gathers summed over the data ranks whole and the rank keeps
the moments' block of it.

With ``m`` microbatches the reference's microbatch i is rows [i B/m,
(i + 1) B/m) of the global batch; one all-gather of the batch at the
start of the step gives each rank its share of every one of them, rank
r holding the r-th block of each.  Its loss is the mean of the data
ranks' per-row means, which is the global batch's mean for a loss that
averages over rows.  An MoE's load-balance loss is not such a mean: its
dispatch groups, their capacity and the aux loss of each group are the
global batch's, which the step tells ``models/moe.py`` by binding
``moe_data`` (``dist.hints.DataRanks``: the data ranks, this rank's
place among them and a sum over them); the mean over the data ranks of
the ranks' aux values and gradients is the reference's.  On a mesh of
one rank every collective is a copy and the step is bitwise the step
without a mesh.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..dist import compression, hints
from ..dist import sharding as sh
from ..dist import tensor_parallel
from . import optimizer
from .tree import leaves, unflatten


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


def _loss_and_grads(model, params, batch, m: int, loss_kwargs,
                    reduce=None):
    """(loss, metrics, grads) over ``m`` microbatches: their fp32
    gradient sums and losses divided by m, and no model metrics when
    m > 1, as the reference gives.  ``reduce(j, g)``, where given, maps
    leaf j's gradient of each microbatch (at m > 1 in fp32) before it is
    added up, and each gradient is dropped once it is mapped."""
    if reduce is None:
        def reduce(j, g):
            return g
    acc, loss, metrics = None, None, {}
    for i in range(m):
        l, met, g = value_and_grad(
            model, params, batch if m == 1 else _microbatch(batch, m, i),
            loss_kwargs)
        g = leaves(g)
        part = []
        for j in range(len(g)):
            part.append(reduce(j, g[j] if m == 1 else g[j].float()))
            g[j] = None
        if acc is None:
            acc = part
        else:
            # leaf by leaf: one set of fp32 sums, not two; a new tensor the
            # first time (a gradient may be a view autograd shares), then
            # in place
            for j, b in enumerate(part):
                acc[j] = acc[j] + b if i == 1 else acc[j].add_(b)
        del part
        loss, metrics = (l, met) if loss is None else (loss + l, {})
    if m > 1:
        acc = [a.div_(m) for a in acc]
        loss = loss / m
    return loss, metrics, unflatten(params, acc)


def make_train_step(model, run_cfg, mesh=None, *,
                    loss_kwargs: Optional[dict] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {"loss", "grad_norm", "lr", and the model's metrics at one
    microbatch}), each metric a 0-d tensor on the model's device.

    With ``mesh`` (a ``DeviceMesh`` with the data axes of
    ``dist.sharding``), the parameters, the AdamW moments and the batch
    are laid out over it (DTensors; a plain tensor is taken as
    replicated) and the step runs as the module's docstring says."""
    loss_kwargs = dict(loss_kwargs or {})
    m = max(1, run_cfg.microbatches)
    if mesh is not None:
        return _placed_step(model, run_cfg, mesh, m, loss_kwargs)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = _loss_and_grads(model, params, batch, m,
                                               loss_kwargs)
        if run_cfg.compress_grads:
            grads = compression.compress_tree(grads, model.stacked)
        params, opt_state, opt_metrics = optimizer.apply(
            params, grads, opt_state, run_cfg)
        return params, opt_state, {"loss": loss, **opt_metrics, **metrics}

    return train_step


def _all_reduce(t: torch.Tensor, mesh, dims, op=dist.ReduceOp.SUM):
    """``t`` reduced in place over the ranks of mesh dims ``dims``, one
    collective a dim."""
    for i in dims:
        dist.all_reduce(t, op=op, group=mesh.get_group(i))
    return t


def _placed_step(model, run_cfg, mesh, m: int, loss_kwargs):
    names = mesh.mesh_dim_names
    # the batch's axes, as dist.sharding.batch_specs lays the batch out
    data = [names.index(a) for a in (sh.data_axes(mesh) or names[:1])]
    n_data = math.prod(mesh.size(i) for i in data)
    every = range(mesh.ndim)
    partial = tuple(Partial() if i in data else Replicate() for i in every)

    def reduced(g: torch.Tensor, placements) -> torch.Tensor:
        """This rank's block under ``placements`` of the gradient summed
        over the data ranks, divided by their number."""
        d = DTensor.from_local(g, mesh, partial, run_check=False,
                               shape=g.shape, stride=g.stride())
        return d.redistribute(mesh, placements).to_local() / n_data

    def counted_once(placements) -> bool:
        """Whether this rank's block of a leaf so placed is the one that
        counts for it in a sum over every rank: the first of the ranks
        that hold the same block (coordinate 0 on each dim where the
        leaf is replicated)."""
        coords = mesh.get_coordinate()
        return all(not isinstance(p, Replicate) or coords[i] == 0
                   for i, p in enumerate(placements))

    def layout(x) -> tuple:
        """A leaf's placements (a plain tensor's: replicated)."""
        if isinstance(x, DTensor):
            return tuple(x.placements)
        return (Replicate(),) * mesh.ndim

    def block(x, placements) -> torch.Tensor:
        """This rank's block of leaf ``x`` under ``placements``."""
        if not isinstance(x, DTensor):
            return sh.shard_of(x, mesh, placements)
        if tuple(x.placements) == placements:
            return x.to_local()
        return x.redistribute(mesh, placements).to_local()

    def data_rows(batch):
        """(this rank's rows of the batch, microbatch-major: its block of
        each of the reference's m microbatches in turn; the DataRanks
        they are split over)."""
        first = next(iter(batch.values()))
        if not (isinstance(first, DTensor) and any(
                isinstance(p, Shard) for p in first.placements)):
            # a batch replicated on every rank: each rank takes it whole
            return {k: sh.local(v) for k, v in batch.items()}, \
                hints.DataRanks(1, 0, lambda t: t)
        coords = mesh.get_coordinate()
        q = 0
        for i in data:
            q = q * mesh.size(i) + coords[i]
        ranks = hints.DataRanks(n_data, q,
                                lambda t: _all_reduce(t, mesh, data))
        if m == 1 or n_data == 1:
            return {k: sh.local(v) for k, v in batch.items()}, ranks

        def mine(x):
            B = x.shape[0]
            if B % (m * n_data):
                raise ValueError(f"batch {B} % (microbatches {m} x data "
                                 f"ranks {n_data}) != 0")
            b = B // (m * n_data)
            return torch.cat([x[i * (B // m) + q * b:][:b] for i in range(m)])

        with torch.no_grad():
            return {k: mine(sh.whole(v)) for k, v in batch.items()}, ranks

    split_model = getattr(model, "model_parallel", False)

    def train_step(params, opt_state, batch):
        flat_p = leaves(params)
        dev = sh.local(flat_p[0]).device
        rows, ranks = data_rows(batch)
        mu = leaves(opt_state.mu)
        nu = leaves(opt_state.nu)
        lay_p = [layout(p) for p in flat_p]
        lay_o = [layout(u) for u in mu]
        # each microbatch's gradients summed over the data ranks into this
        # rank's blocks as they come (the reference's reduce-scatter a
        # microbatch), added up in fp32 there at m > 1: no whole fp32 sums
        if split_model:
            # the leaves as stored: the model gathers a layer's over the
            # data ranks as it reaches it and computes its share over the
            # model ranks (dist/tensor_parallel.py)
            model_params = unflatten(params, [
                p if isinstance(p, DTensor)
                else sh.from_whole(p, mesh, lay) for p, lay in
                zip(flat_p, lay_p)])
            scope = tensor_parallel.bind(mesh)

            def reduce(j, g):
                # the gradient of leaf j as stored, summed over the data
                # ranks by the model's gathers: this rank's block of the
                # moments' placements, divided by their number
                if lay_p[j] != lay_o[j]:
                    g = g.redistribute(mesh, lay_o[j])
                return g.to_local() / n_data
        else:
            # ZeRO-3: each leaf whole for the model
            with torch.no_grad():
                model_params = unflatten(params, [sh.whole(p)
                                                  for p in flat_p])

            def reduce(j, g):
                return reduced(g, lay_o[j])

            scope = contextlib.nullcontext()
        with hints.hints(moe_data=ranks), scope:
            loss, metrics, g_loc = _loss_and_grads(
                model, model_params, rows, m, loss_kwargs, reduce=reduce)
        del model_params
        g_loc = leaves(g_loc)

        # the loss and the model's metrics: means over the data ranks
        keys = list(metrics)
        stats = torch.stack([loss.float()] + [metrics[k].float()
                                              for k in keys])
        stats = _all_reduce(stats, mesh, data) / n_data
        loss = stats[0].to(loss.dtype)
        metrics = {k: stats[1 + i].to(metrics[k].dtype)
                   for i, k in enumerate(keys)}

        if run_cfg.compress_grads:
            # the int8 scale of each leaf: a max over all of its blocks
            amax = leaves(compression._amax(unflatten(params, g_loc),
                                            model.stacked))
            amax = _all_reduce(torch.stack(amax), mesh, every,
                               dist.ReduceOp.MAX)
            g_loc = [compression.quantize_dequantize(g, a)
                     for g, a in zip(g_loc, amax.unbind())]
        # the clip's norm: each block's sum of squares counted once
        sq = torch.stack([
            torch.sum(torch.square(g.float())) if counted_once(lay)
            else torch.zeros((), dtype=torch.float32, device=dev)
            for g, lay in zip(g_loc, lay_o)])
        sq = _all_reduce(sq, mesh, every)
        gnorm = torch.sqrt(sum(sq.unbind()))

        # AdamW on this rank's blocks, in the moments' layout
        p_loc = [block(p, lo) for p, lo in zip(flat_p, lay_o)]
        state = optimizer.AdamWState(
            step=sh.local(opt_state.step),
            mu=unflatten(opt_state.mu, [sh.local(u) for u in mu]),
            nu=unflatten(opt_state.nu, [sh.local(v) for v in nu]))
        new_p, new_state, opt_metrics = optimizer.apply(
            unflatten(params, p_loc), unflatten(params, g_loc), state,
            run_cfg, gnorm=gnorm)

        def placed(x, like, lay):
            return DTensor.from_local(x, mesh, lay, run_check=False,
                                      shape=like.shape, stride=like.stride())

        new_params = []
        for x, p, lp, lo in zip(leaves(new_p), flat_p, lay_p, lay_o):
            d = placed(x, p, lo)
            new_params.append(d if lp == lo else d.redistribute(mesh, lp))
        step = new_state.step
        if isinstance(opt_state.step, DTensor):
            step = placed(step, opt_state.step, opt_state.step.placements)
        new_state = optimizer.AdamWState(
            step=step,
            mu=unflatten(opt_state.mu, [placed(x, u, lo) for x, u, lo in
                                        zip(leaves(new_state.mu), mu,
                                            lay_o)]),
            nu=unflatten(opt_state.nu, [placed(x, v, lo) for x, v, lo in
                                        zip(leaves(new_state.nu), nu,
                                            lay_o)]))
        return unflatten(params, new_params), new_state, \
            {"loss": loss, **opt_metrics, **metrics}

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
