"""Elastic scaling, straggler detection and liveness bookkeeping.

The port of ``repro.train.elastic``:

* :func:`remesh` -- move a parameter or optimizer-state tree onto another
  device mesh (the device count changed after a failure) by the standard
  placement rules.  With ``checkpoint.restore(..., shardings=)`` this is
  the restart path: a job saved on one mesh resumes on another.
* :class:`StragglerMonitor` -- per-host step times, robust median / MAD
  outliers, data-shard rebalancing weights (host-side).
* :class:`HeartbeatRegistry` -- hosts missing beats for ``timeout``
  seconds are dead (``launch/cluster.py``'s supervisor reads it).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..dist import sharding as sh
from .tree import leaves, unflatten


def remesh(tree: Any, new_mesh) -> Any:
    """The tree laid out on ``new_mesh`` by ``dist.sharding.param_shardings``.
    DTensor cannot redistribute between two meshes, so each leaf goes
    through its whole tensor: gathered (``full_tensor``) on the old mesh,
    then each rank keeps its block on the new one.  Every rank of both
    meshes calls it."""
    shardings = leaves(sh.param_shardings(tree, new_mesh))
    return unflatten(tree, [s.place(sh.whole(x))
                            for x, s in zip(leaves(tree), shardings)])


@dataclass
class StragglerMonitor:
    """Flags hosts whose step time is a robust outlier."""

    window: int = 32
    threshold: float = 4.0           # MAD multiples
    history: Dict[int, deque] = field(default_factory=dict)

    def record(self, host: int, step_time: float) -> None:
        self.history.setdefault(host, deque(maxlen=self.window)).append(
            step_time)

    def medians(self) -> Dict[int, float]:
        out = {}
        for h, times in self.history.items():
            s = sorted(times)
            out[h] = s[len(s) // 2]
        return out

    def stragglers(self) -> List[int]:
        meds = self.medians()
        if len(meds) < 2:
            return []
        vals = sorted(meds.values())
        global_med = vals[len(vals) // 2]
        mad = sorted(abs(v - global_med) for v in vals)[len(vals) // 2]
        scale = max(mad, 0.05 * global_med, 1e-9)
        return [h for h, v in meds.items()
                if (v - global_med) / scale > self.threshold]

    def rebalance_weights(self, n_hosts: int) -> List[float]:
        """Relative data-shard weights: stragglers get proportionally less
        work."""
        meds = self.medians()
        if not meds:
            return [1.0] * n_hosts
        fallback = sorted(meds.values())[len(meds) // 2]
        inv = [1.0 / meds.get(h, fallback) for h in range(n_hosts)]
        s = sum(inv)
        return [w * n_hosts / s for w in inv]


@dataclass
class HeartbeatRegistry:
    timeout: float = 60.0
    last_seen: Dict[int, float] = field(default_factory=dict)

    def beat(self, host: int, now: Optional[float] = None) -> None:
        self.last_seen[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        t = time.monotonic() if now is None else now
        return [h for h, seen in self.last_seen.items()
                if t - seen > self.timeout]

    def alive_count(self, now: Optional[float] = None) -> int:
        return len(self.last_seen) - len(self.dead_hosts(now))
