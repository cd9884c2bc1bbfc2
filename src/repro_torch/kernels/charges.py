"""What each hand-written kernel's call costs, for the cost walker.

``launch/cost.py`` counts a function's work from the aten operations that
PyTorch's dispatcher sees.  The CUDA kernels are pybind calls that it
does not see, so each entry point of ``kernels/ops.py`` charges its call
here by formula, on either route: the kernel's, and the plain version's,
whose own operations go uncounted inside the charge.  A step then counts
the same work on the card as on the meta device.

The formulas are PERF.md's: the operations a kernel must do and the
bytes it must move, each input read once and each output written once.

  * flash attention: 4 hd flops a live (query, key) pair in the forward
    (two products of hd multiply-adds), 14 hd in the two-launch backward
    (S and dP again, dV, dQ and dK);
  * Pearson (n, L): the (n, n) product, 2 n^2 L;
  * top-K (n, L) over a row range of r rows: 2 r n L;
  * min-plus (M, K) x (K, N): an add and a min a (i, k, j), 2 M N K;
  * masked argmax (m, n): a compare an entry, m n;
  * sparse relaxation of s sources over nnz CSR entries: an add and a
    min an (entry, source), 2 s nnz.

While no walk is on (``METER`` None) a charge costs one attribute read:
its formula is not evaluated.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch

# the cost walk in progress (``launch.cost.walk`` sets it for the
# function it walks; autograd's own threads see it too); None: no walk
METER = None


_NO_WALK = contextlib.nullcontext()


def charged(name: str, work):
    """A context in which one call of kernel ``name`` is charged to the
    walk in progress and nothing of what runs inside (either route's own
    operations) is counted; a no-op while no walk is on.  ``work()``
    gives the call's (flops, bytes), and is called only under a walk."""
    meter = METER
    return _NO_WALK if meter is None else meter.charged(name, *work())


def shapes_only(t: torch.Tensor) -> bool:
    """Whether a charged call on ``t`` should only give outputs of its
    shape: under a walk, on a tensor without data (meta or fake), where
    the plain version's work would be counted nowhere and its temporaries
    (attention's (T, T) scores) are not the kernel's."""
    if METER is None:
        return False
    from torch._subclasses.fake_tensor import FakeTensor
    return t.device.type == "meta" or isinstance(t, FakeTensor)


def nbytes(*ts: Optional[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


@functools.lru_cache(maxsize=256)
def live_pairs(Tq: int, Tk: int, causal: bool, window: int) -> int:
    """Live (query, key) pairs of one head: key j < Tk for query i < Tq,
    j <= i where causal, i - j < window where a window is set (0 =
    none), as the kernels' masks are."""
    total = 0
    for i in range(Tq):
        hi = min(i, Tk - 1) if causal else Tk - 1
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def flash(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int,
          backward: bool) -> float:
    """Flops of one flash call on q (B, Tq, H, hd), k (B, Tk, KV, hd)."""
    B, Tq, H, hd = q.shape
    pairs = B * H * live_pairs(Tq, k.shape[1], causal, int(window))
    return (14 if backward else 4) * hd * pairs
