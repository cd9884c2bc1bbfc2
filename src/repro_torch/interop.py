"""Carry the reference's intermediate state and weights into the port.

The clustering system has no weights: its state is data and
intermediate graphs.  The parity tests feed the JAX package's own
intermediates (S, the TMFG, W, D, the top-K table, the CSR graph) into
the port's next stage, so that a last-ulp difference in one stage cannot
hide or fake a difference in the next.  The LM zoo's tests carry the
JAX model's parameters over (``params_from_jax``), so that both compute
the same function.  Arrays cross as numpy; this module only converts.
"""

from __future__ import annotations

import numpy as np
import torch

from .approx.knn import TopKTable
from .core.tmfg import TMFGResult
from .kernels.sparse_apsp import CSRGraph


def tmfg_from_numpy(obj, device) -> TMFGResult:
    """The port's TMFGResult from any object with ``TMFGResult``'s field
    names (for example a JAX result), each field converted with
    ``np.asarray`` and moved to ``device`` with its dtype kept."""
    return TMFGResult(**{
        f: torch.from_numpy(np.array(getattr(obj, f))).to(device)
        for f in TMFGResult._fields})


def table_from_numpy(obj, device) -> TopKTable:
    """The port's TopKTable from any object with ``values`` and
    ``indices`` (for example a JAX ``repro.approx.knn.TopKTable``)."""
    return TopKTable(
        values=torch.from_numpy(np.array(obj.values, np.float32)).to(device),
        indices=torch.from_numpy(np.array(obj.indices, np.int32)).to(device))


def csr_from_numpy(obj, device) -> CSRGraph:
    """The port's CSRGraph from any object with ``CSRGraph``'s field
    names (for example a JAX ``repro.kernels.sparse_apsp.CSRGraph``)."""
    return CSRGraph(**{
        f: torch.from_numpy(np.array(getattr(obj, f))).to(device)
        for f in CSRGraph._fields})


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A tensor copy of the array ``a`` on ``device``, its dtype kept.

    ``np.asarray`` of a JAX bfloat16 array is an ``ml_dtypes.bfloat16``
    array, which ``torch.from_numpy`` refuses: it crosses as its uint16
    bits and is viewed as ``torch.bfloat16`` again."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(params, device="cpu") -> dict:
    """The port's model parameters from a JAX model's nested dict, for
    every family: each leaf converted with :func:`tensor_from_numpy`, and
    each stack of layers (``layers``, ``enc_layers``, ``dec_layers``: a
    leading (L, ...) axis on every leaf) split into a list of L per-layer
    dicts.  xLSTM's ``layers`` is a list already and is converted layer
    by layer."""
    def convert(tree, index=None):
        if isinstance(tree, dict):
            return {k: convert(v, index) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [convert(v, index) for v in tree]
        a = np.asarray(tree)
        return tensor_from_numpy(a if index is None else a[index], device)

    def depth(tree):
        while isinstance(tree, dict):
            tree = next(iter(tree.values()))
        return len(np.asarray(tree))

    out = {}
    for k, v in params.items():
        if k in _STACKS and isinstance(v, dict):
            out[k] = [convert(v, i) for i in range(depth(v))]
        else:
            out[k] = convert(v)
    return out


# the keys whose dicts hold layers stacked on a leading axis
_STACKS = ("layers", "enc_layers", "dec_layers")
