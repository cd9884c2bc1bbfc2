"""Straggler detection and liveness bookkeeping (host-side).

The port of ``repro.train.elastic``'s :class:`StragglerMonitor` (per-host
step times, robust median / MAD outliers, data-shard rebalancing weights)
and :class:`HeartbeatRegistry` (hosts missing beats for ``timeout``
seconds are dead).  ``remesh``, which moves a parameter tree onto a new
device mesh, waits for the LM half of the sharding rules (ROADMAP Queue 1
item 15.6b).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional


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
