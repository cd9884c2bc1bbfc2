"""Carry the reference's intermediate state into the port.

The system has no weights: its state is data and intermediate graphs.
The parity tests feed the JAX package's own intermediates (S, the TMFG,
W, D, the top-K table, the CSR graph) into the port's next stage, so
that a last-ulp difference in one stage cannot hide or fake a
difference in the next.  Arrays cross as
numpy; this module only converts.
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
