"""Int8 error-feedback gradient compression, the value half.

The port of ``repro.dist.compression``'s ``quantize_dequantize``,
``compress_tree``, ``ef_init`` and ``compress_with_feedback``: each
gradient leaf goes through symmetric per-tensor int8 (scale =
max|g| / 127, round half to even, clipped at +-127) and back, computed
in fp32 and cast back to the leaf's dtype.  A non-finite or zero scale
passes the leaf through unchanged.  Where the reference stacks a list
of layers into one (L, ...) array per leaf, the port keeps a list of
per-layer trees: the keys named by ``stacked`` (a model's ``stacked``)
take one scale per leaf across their layers, the stacked array's.
:func:`psum_compressed` quantizes each rank's gradients so and sums them
over one axis of a device mesh, as the reference's does inside a
``shard_map`` body.  As in the reference, these helpers model the noise
of int8 gradients and not their wire format: the all-reduce carries the
dequantized values in the leaves' own dtype.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..train.tree import leaves, tree_map, unflatten

_QMAX = 127.0  # symmetric int8 range


def quantize_dequantize(g: torch.Tensor,
                        amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``g`` round-tripped through symmetric per-tensor int8; the error
    is at most scale / 2 per element (0 for an all-zero tensor).  The
    scale is ``amax`` / 127, ``amax`` the largest |g| of the tensor it
    covers (default: ``g`` itself)."""
    g32 = g.float()
    scale = (g32.abs().amax() if amax is None else amax) / _QMAX
    ok = torch.isfinite(scale) & (scale > 0)
    safe = torch.where(ok, scale, 1.0)
    q = torch.clamp(torch.round(g32 / safe), -_QMAX, _QMAX)
    return torch.where(ok, q * safe, g32).to(g.dtype)


def _amax(grads: Any, stacked: Sequence[str]) -> Any:
    """The largest |g| of each leaf, shared by the layers of each key in
    ``stacked``."""
    amax = tree_map(lambda g: g.float().abs().amax(), grads)
    if not stacked:
        return amax
    amax = dict(amax)
    for k in stacked:
        shared = [torch.stack(col).amax()
                  for col in zip(*(leaves(layer) for layer in amax[k]))]
        amax[k] = [unflatten(layer, shared) for layer in amax[k]]
    return amax


def compress_tree(grads: Any, stacked: Sequence[str] = ()) -> Any:
    """Every leaf of a gradient tree quantize-dequantized (stateless):
    the train step's ``run_cfg.compress_grads`` hook."""
    return tree_map(quantize_dequantize, grads, _amax(grads, stacked))


def ef_init(grads: Any) -> Any:
    """Zero error-feedback state shaped like the gradient tree (fp32)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compress_with_feedback(grads: Any, ef: Any,
                           stacked: Sequence[str] = ()) -> Tuple[Any, Any]:
    """One error-feedback step: (compressed, new_ef), where compressed is
    what goes into the optimizer and new_ef = (g + ef) - compressed, the
    compressed value read after its cast back to the gradient dtype (so
    a bf16 cast's rounding is fed back too)."""
    corrected = tree_map(lambda g, e: g.float() + e, grads, ef)
    compressed = tree_map(
        lambda c, a, g: quantize_dequantize(c, a).to(g.dtype),
        corrected, _amax(corrected, stacked), grads)
    new_ef = tree_map(lambda c, q: c - q.float(), corrected, compressed)
    return compressed, new_ef


def psum_compressed(grads: Any, axis_name: str, mesh,
                    stacked: Sequence[str] = ()) -> Any:
    """Every leaf of this rank's gradient tree quantize-dequantized (one
    scale per leaf, shared across the layers of each key in ``stacked``,
    as :func:`compress_tree` takes it), then summed over the ranks of
    ``mesh``'s ``axis_name`` dim: one all-reduce a leaf.  The leaves are
    the rank's own (plain) tensors, as in a ``shard_map`` body; the result
    is new tensors."""
    group = mesh.get_group(axis_name)

    def reduce(g, a):
        q = quantize_dequantize(g, a)
        dist.all_reduce(q, group=group)
        return q

    return tree_map(reduce, grads, _amax(grads, stacked))
