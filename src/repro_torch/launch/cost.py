"""Per-device cost of a PyTorch function, for the dry-run roofline.

The counterpart of ``repro.launch.hlo_cost``.  The reference walks the
compiled, SPMD-partitioned HLO text of a jitted step, because XLA's own
``cost_analysis()`` counts each while-loop body once.  The port has no
HLO: it runs eagerly, so this module counts the aten operations that the
dispatcher sees while the function runs, under one ``TorchDispatchMode``
(its name differs from the reference's for that reason).  It keeps the
reference's accounting:

  * FLOPs -- products 2 M N K (``torch.utils.flop_counter``'s formulas:
    mm, addmm, bmm, baddbmm, convolutions); one a result element for the
    reference's ``ELEMENTWISE`` and ``TRANSCENDENTAL`` operations (their
    aten names below; ``logistic`` is ``sigmoid`` and ``silu``, XLA's
    ``convert`` a dtype cast); one an input element for a reduction.
  * HBM bytes -- each aten operation reads its tensor operands and writes
    its result once.  Eager PyTorch fuses nothing, so this is the port's
    own traffic model, not an approximation of a fused program; views
    (``OpOverload.is_view``), metadata reads (``prim``) and allocations
    without a fill move nothing.  A gather (``index``, ``index_select``)
    moves its rows and indices, not its whole source, and a scatter
    (``index_put_``, ``index_copy_``, ...) its indices and values, read,
    and the values, written, not its whole destination: the
    reference's dynamic-slice and in-place update rules.
  * Collectives -- the reference's ring formulas on the group's size S
    and bytes b: all-reduce 2 (S - 1) / S b, all-gather (S - 1) / S b of
    the gathered result, reduce-scatter (S - 1) b of the shard,
    all-to-all (S - 1) / S b, a broadcast, send or receive b; from the
    c10d operations (``dist.all_reduce`` and the like) and DTensor's
    functional collectives, the two kinds ``CommDebugMode`` sees.
  * Loops -- Python loops (layers, microbatches) unroll as they run, so
    every trip is counted: there is no trip count to recover.

The hand-written kernels are pybind calls the dispatcher does not see:
``kernels/ops.py`` charges each call by its kernel's formula
(``kernels/charges.py``), on the kernel's route and on the plain one
alike, and nothing inside the charge is counted, so a function counts the
same work on the card and on the meta device.

Costs are per device (per rank), as the reference's: under a process
group of N ranks, this rank's operations on its own blocks.  Operations
on DTensors are counted as DTensor runs them, on the local tensors; the
fake tensors of DTensor's sharding propagation (not the caller's) are
not counted.
"""

from __future__ import annotations

import contextlib
import gzip
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import charges

# the reference's sets (hlo_cost.py), as aten operation names
ELEMENTWISE = {
    "add", "sub", "mul", "div", "maximum", "minimum", "abs", "neg",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_xor", "logical_not", "where",
    "eq", "ne", "lt", "le", "gt", "ge", "clamp", "clamp_min", "clamp_max",
    "floor", "ceil", "round", "sign", "_to_copy", "pow", "remainder",
    "fmod", "__lshift__", "__rshift__", "bitwise_left_shift",
    "bitwise_right_shift", "atan2", "masked_fill", "lerp", "addcmul",
    "addcdiv", "reciprocal", "square",
}
TRANSCENDENTAL = {"exp", "exp2", "log", "log2", "tanh", "rsqrt", "sqrt",
                  "sigmoid", "silu", "sin", "cos", "expm1", "log1p", "erf",
                  "gelu", "_softmax", "_log_softmax"}
REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
              "argmax", "argmin", "cumsum", "logsumexp", "norm",
              "linalg_vector_norm", "var", "std", "any", "all"}
# reads of some rows of a source: the output and the indices move
GATHERS = {"index", "index_select", "gather", "take", "embedding"}
# writes of some rows into a destination: the indices and values are read
# and the values written
SCATTERS = {"index_put", "index_copy", "index_add", "index_fill", "scatter",
            "scatter_add", "scatter_reduce", "masked_scatter"}
# allocations that fill nothing, and the collectives' bookkeeping
FREE = {"empty", "empty_strided", "empty_like", "new_empty",
        "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd",
        "detach", "lift_fresh", "_local_scalar_dense", "_unsafe_view"}
COLLECTIVES = {
    # c10d (in place, on a list of tensors or one)
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast", "send": "send", "recv_": "recv",
    # functional
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}


@dataclass
class CostTotals:
    """The reference's totals (``hlo_cost.CostTotals``), per device."""
    flops: float = 0.0
    transcendentals: float = 0.0
    hbm_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_counts: Dict[str, int] = field(
        default_factory=lambda: defaultdict(int))
    collective_bytes_by_op: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))

    def add(self, other: "CostTotals", times: float = 1.0):
        self.flops += other.flops * times
        self.transcendentals += other.transcendentals * times
        self.hbm_bytes += other.hbm_bytes * times
        self.collective_wire_bytes += other.collective_wire_bytes * times
        for k, v in other.collective_counts.items():
            self.collective_counts[k] += int(v * times)
        for k, v in other.collective_bytes_by_op.items():
            self.collective_bytes_by_op[k] += v * times


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_size(args) -> int:
    """The size of the process group a collective's arguments name (a
    c10d ProcessGroup object, or a functional collective's group name)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except (RuntimeError, TypeError):
                continue
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (RuntimeError, ValueError, KeyError):
                continue
    return 1


class Walker(TorchDispatchMode):
    """Counts the aten operations run under it into ``totals`` and a
    per-operation ``table`` (name -> [calls, flops, bytes]); the kernels'
    charges come in through :meth:`charged`."""

    def __init__(self):
        super().__init__()
        self.totals = CostTotals()
        self.table: Dict[str, list] = defaultdict(lambda: [0, 0.0, 0.0])
        self._paused = 0
        from torch._guards import detect_fake_mode
        self._fake = detect_fake_mode()

    @contextlib.contextmanager
    def paused(self) -> Iterator[None]:
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def _add(self, name: str, flops: float, nbytes: float) -> None:
        self.totals.flops += flops
        self.totals.hbm_bytes += nbytes
        row = self.table[name]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    @contextlib.contextmanager
    def charged(self, name: str, flops: float, nbytes: float):
        """One call of hand-written kernel ``name``, nothing inside it
        counted (``kernels/charges.py``)."""
        if not self._paused:
            self._add(f"kernel.{name}", float(flops), float(nbytes))
        with self.paused():
            yield

    def _foreign(self, ts) -> bool:
        """Whether ``ts`` holds fake tensors of another fake mode than the
        caller's (DTensor's sharding propagation)."""
        from torch._subclasses.fake_tensor import FakeTensor
        return any(isinstance(t, FakeTensor) and t.fake_mode is not self._fake
                   for t in ts)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(isinstance(t, DTensor) for t in ins):
            # let DTensor run it: its local operations come back here
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._paused and not self._foreign(ins):
            self._count(func, args, kwargs, ins, out)
        return out

    def _count(self, func, args, kwargs, ins, out) -> None:
        name = func.overloadpacket.__name__
        outs = _tensors(out)
        if name in COLLECTIVES:
            self._collective(COLLECTIVES[name], args, ins, outs)
            return
        if name in FREE or func.namespace == "prim" \
                or getattr(func, "is_view", False):
            return
        flops = 0.0
        packet = func.overloadpacket
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
        elif name.rstrip("_") in ELEMENTWISE:
            flops = float(sum(t.numel() for t in outs))
        elif name.rstrip("_") in TRANSCENDENTAL:
            flops = float(sum(t.numel() for t in outs))
            self.totals.transcendentals += flops
        elif name in REDUCTIONS:
            flops = float(sum(t.numel() for t in ins))
        base = name.rstrip("_")
        if base in GATHERS:
            nbytes = _bytes(outs) + _bytes(t for t in ins
                                           if not t.is_floating_point())
        elif base in SCATTERS:
            nbytes = 2 * _bytes(ins[1:])
        else:
            nbytes = _bytes(ins) + _bytes(outs)
        self._add(str(func), flops, nbytes)

    def _collective(self, op: str, args, ins, outs) -> None:
        size = max(_group_size(args), 1)
        if op == "all-gather":
            b = _bytes(outs) or _bytes(ins)
            wire = (size - 1) / size * (b if outs else b * size)
        elif op == "reduce-scatter":
            b = _bytes(outs) if outs else _bytes(ins) / size
            wire = (size - 1) * b
        elif op == "all-reduce":
            wire = 2.0 * (size - 1) / size * _bytes(ins)
        elif op == "all-to-all":
            wire = (size - 1) / size * _bytes(ins)
        else:                              # broadcast, send, receive
            wire = float(_bytes(ins))
        t = self.totals
        t.collective_wire_bytes += wire
        t.collective_counts[op] += 1
        t.collective_bytes_by_op[op] += wire
        t.hbm_bytes += _bytes(ins) + _bytes(outs)
        row = self.table[f"collective.{op}"]
        row[0] += 1
        row[2] += wire


def walk(fn, *args, **kwargs):
    """(fn(*args, **kwargs), the :class:`Walker` that counted it): every
    aten operation it runs counted, its backward's too, and each
    hand-written kernel's call charged."""
    if charges.METER is not None:
        raise RuntimeError("a cost walk is already in progress")
    walker = Walker()
    charges.METER = walker
    try:
        with walker:
            out = fn(*args, **kwargs)
    finally:
        charges.METER = None
    return out, walker


def analyze(fn, *args, **kwargs) -> CostTotals:
    """Per-device totals of ``fn(*args, **kwargs)``, as the reference's
    ``analyze`` gives them for a compiled module."""
    return walk(fn, *args, **kwargs)[1].totals


def write_table(table: dict, path: str) -> None:
    """The per-op table as gzipped JSON lines, the costliest first:
    {"op", "calls", "flops", "bytes"} (a collective's "bytes" are its
    wire bytes)."""
    rows = sorted(table.items(), key=lambda kv: -(kv[1][1] + kv[1][2]))
    with gzip.open(path, "wt") as f:
        for op, (calls, flops, nbytes) in rows:
            f.write(json.dumps(dict(op=op, calls=calls, flops=flops,
                                    bytes=nbytes)) + "\n")
