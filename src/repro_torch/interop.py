"""Carry the reference's intermediate state into the port.

The system has no weights: its state is data and intermediate graphs.
The parity tests feed the JAX package's own intermediates (S, the TMFG,
W, D) into the port's next stage, so that a last-ulp difference in one
stage cannot hide or fake a difference in the next.  Arrays cross as
numpy; this module only converts.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.tmfg import TMFGResult


def tmfg_from_numpy(obj, device) -> TMFGResult:
    """The port's TMFGResult from any object with ``TMFGResult``'s field
    names (for example a JAX result), each field converted with
    ``np.asarray`` and moved to ``device`` with its dtype kept."""
    return TMFGResult(**{
        f: torch.from_numpy(np.array(getattr(obj, f))).to(device)
        for f in TMFGResult._fields})
