"""Dynamically scoped logical-axis annotations (DESIGN.md §7.3).

The port of ``repro.dist.hints``.  Model code marks logical tensors by
name -- ``constrain(x, "kv_cache")``, ``constrain(buf, "moe_expert")`` --
and stays mesh-agnostic.  The launcher decides what those names mean for
a concrete mesh and scopes the decision with :func:`hints`::

    with hints(kv_cache=NamedSharding(mesh, (Shard(0), Shard(1))),
               onehot_embed=True):
        out = step(params, batch)

A binding is a ``dist.sharding.NamedSharding`` (or any object with
``mesh`` and ``placements``) or, for a value hint such as
``onehot_embed``, any value read with :func:`get`.  The reference's hints
act when ``jax.jit`` traces; the port runs eagerly, so a binding acts on
every call made inside its scope.

:func:`constrain` redistributes a ``DTensor`` to the placements bound to
its name.  On a plain tensor it is the identity: the port's models
compute on local tensors (``dist/tensor_parallel.py``), and a
constraint changes a layout, never a value.  Contexts nest; inner
bindings shadow outer ones, and binding a name to ``None`` un-pins it
for the inner scope.

Two bindings carry no layout: ``moe_data``, a :class:`DataRanks` set by
the mesh train step (``train/train_step.py``), tells ``models/moe.py``
that the batch's rows are split over data ranks, so that it forms the
reference's dispatch groups over the global batch; ``model_ranks``, a
:class:`ModelRanks` (``dist.tensor_parallel.bind``), tells the dense,
MoE and VLM models that their work is split over the mesh's ``model``
ranks (``dist/tensor_parallel.py``).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional

import torch
from torch.distributed.tensor import DTensor

_local = threading.local()


@dataclass(frozen=True)
class DataRanks:
    """The data ranks a batch's rows are split over: ``size`` ranks, each
    holding the same number of rows, rank r's rows before rank r + 1's in
    the global batch; this rank is the ``index``-th.  ``all_reduce(t)``
    sums ``t`` over them in place and returns it."""
    size: int
    index: int
    all_reduce: Callable[[torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class ModelRanks:
    """The ranks of a mesh's ``model`` dim, over which a layer's work is
    split: ``size`` ranks (the degree t), this rank the ``index``-th,
    ``group`` their process group (None at size 1), ``dim`` the model dim
    of ``mesh`` (None where the mesh has none)."""
    size: int
    index: int
    group: Any
    mesh: Any
    dim: Optional[int]


def _stack() -> list:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def current() -> Dict[str, Any]:
    """The merged hint namespace visible at this point (inner wins)."""
    merged: Dict[str, Any] = {}
    for frame in _stack():
        merged.update(frame)
    return merged


def get(name: str, default: Any = None) -> Any:
    """Look up a hint by logical name; ``default`` when unbound."""
    for frame in reversed(_stack()):
        if name in frame:
            return frame[name]
    return default


@contextmanager
def hints(**bindings: Any) -> Iterator[None]:
    """Bind logical-name -> sharding (or value) hints for the dynamic
    scope."""
    _stack().append(dict(bindings))
    try:
        yield
    finally:
        _stack().pop()


def constrain(x, name: str):
    """``x`` redistributed to the sharding bound to ``name`` when ``x`` is
    a DTensor and the name is bound; otherwise ``x`` unchanged."""
    h = get(name)
    if h is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(h.mesh, tuple(h.placements))


def sharding_of(name: str) -> Optional[Any]:
    """The raw hint value for ``name`` (None when unbound): for launchers
    that want to co-locate derived buffers."""
    return get(name)
