"""Multi-host launch and the fault-tolerance runbook.

The port of ``repro.launch.cluster``: the per-host launch command, the
supervision loop (heartbeats -> straggler detection -> elastic restart)
and a deterministic simulation of it, as pure Python on
``train/elastic.py``'s :class:`StragglerMonitor` and
:class:`HeartbeatRegistry`.

On a cluster every host runs::

    python -m repro_torch.launch.cluster worker \\
        --coordinator <host0>:29500 --num-hosts 128 --host-id $ID \\
        -- python -m repro_torch.launch.train --arch mixtral-8x7b ...

The worker joins a ``torch.distributed`` group of ``--num-hosts`` ranks
at the coordinator (the reference calls ``jax.distributed.initialize``),
then runs the inner command with the ``env://`` rendezvous of a second
group at the coordinator's next port (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), which the driver's
``launch.mesh.ensure_process_group`` joins; the worker leaves its own
group when the command ends.  The supervisor (in-process here) watches
heartbeats; on a dead or straggling host it recomputes the mesh for the
surviving hosts (the largest (pods, data, model) grid that fits: the
model axis is kept, data shrinks) and restarts the step from
``checkpoint.restore(..., shardings=)`` on the new mesh.

    PYTHONPATH=src python -m repro_torch.launch.cluster simulate
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
from typing import List, Optional, Sequence

from repro_torch.train.elastic import HeartbeatRegistry, StragglerMonitor


@dataclasses.dataclass
class HostSpec:
    host_id: int
    addr: str
    n_devices: int = 4          # cards per host


def worker_cmd(coordinator: str, num_hosts: int, host_id: int,
               inner: Sequence[str]) -> List[str]:
    """The per-host launch command."""
    return [
        "python", "-m", "repro_torch.launch.cluster", "worker",
        "--coordinator", coordinator,
        "--num-hosts", str(num_hosts),
        "--host-id", str(host_id),
        "--", *inner,
    ]


def largest_mesh(n_chips: int, *, model: int = 16,
                 pod_size: int = 256) -> tuple:
    """Largest (pod, data, model) grid for a surviving device count.

    Model parallelism is preserved (resharding TP is the expensive path);
    data shrinks; pods = floor over full pods, the remainder merged into
    the data axis."""
    assert n_chips >= model, "cannot keep model axis"
    usable = (n_chips // model) * model
    pods = max(1, usable // pod_size)
    data = usable // (pods * model)
    return (pods, data, model)


class Supervisor:
    """Heartbeat -> straggler -> elastic-restart state machine."""

    def __init__(self, hosts: List[HostSpec], *, heartbeat_timeout=60.0,
                 model_axis: int = 16):
        self.hosts = {h.host_id: h for h in hosts}
        self.registry = HeartbeatRegistry(timeout=heartbeat_timeout)
        self.monitor = StragglerMonitor()
        self.model_axis = model_axis
        self.generation = 0                 # bumps on every remesh
        self.evicted: List[int] = []
        self.events: List[dict] = []

    # -- feeds (called by the transport layer / tests) ----------------------
    def heartbeat(self, host_id: int, step_time: Optional[float] = None,
                  now: Optional[float] = None):
        self.registry.beat(host_id, now=now)
        if step_time is not None:
            self.monitor.record(host_id, step_time)

    # -- supervision tick -----------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """Returns a restart plan when the fleet must be re-meshed."""
        dead = [h for h in self.registry.dead_hosts(now)
                if h not in self.evicted]
        stragglers = [h for h in self.monitor.stragglers()
                      if h not in self.evicted and h not in dead]
        if not dead and not stragglers:
            return None
        # policy: evict dead hosts at once; evict stragglers only if the
        # fleet stays >= 75% (otherwise rebalance the data shards)
        to_evict = list(dead)
        survivors = [h for h in self.hosts if h not in self.evicted
                     and h not in to_evict]
        if stragglers and (len(survivors) - len(stragglers)
                           >= 0.75 * len(self.hosts)):
            to_evict += stragglers
        if not to_evict:
            weights = self.monitor.rebalance_weights(len(self.hosts))
            plan = {"action": "rebalance", "weights": weights}
            self.events.append(plan)
            return plan
        self.evicted += to_evict
        survivors = [h for h in self.hosts if h not in self.evicted]
        n_chips = sum(self.hosts[h].n_devices for h in survivors)
        self.generation += 1
        plan = {
            "action": "remesh",
            "generation": self.generation,
            "evicted": to_evict,
            "survivors": survivors,
            "mesh": largest_mesh(n_chips, model=self.model_axis),
        }
        self.events.append(plan)
        return plan


def simulate_failure_recovery(n_hosts: int = 16, chips_per_host: int = 32,
                              kill: Sequence[int] = (3,),
                              straggle: Sequence[int] = (7,)) -> List[dict]:
    """Deterministic simulation of the supervision loop: host ``kill``
    stops beating at step 10, host ``straggle`` runs 9x slower from step
    5; returns the plans, each with its step."""
    hosts = [HostSpec(i, f"host{i}", chips_per_host) for i in range(n_hosts)]
    sup = Supervisor(hosts, heartbeat_timeout=5.0, model_axis=16)
    t = 0.0
    plans = []
    for step in range(40):
        t += 1.0
        for h in range(n_hosts):
            if h in kill and step >= 10:
                continue                      # dead: stops beating
            st = 1.0 + (8.0 if (h in straggle and step >= 5) else 0.0) \
                + 0.01 * (h % 3)
            sup.heartbeat(h, step_time=st, now=t)
        plan = sup.tick(now=t)
        if plan:
            plans.append({"step": step, **plan})
    return plans


def run_worker(coordinator: str, num_hosts: int, host_id: int,
               inner: Sequence[str]) -> int:
    """Join the hosts' group at ``coordinator`` (host:port), run ``inner``
    with the ``env://`` rendezvous of the driver's group at the next
    port, leave the group; returns the command's exit code."""
    import torch.distributed as dist

    host, port = coordinator.rsplit(":", 1)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_hosts, rank=host_id)
    try:
        env = dict(os.environ, MASTER_ADDR=host,
                   MASTER_PORT=str(int(port) + 1),
                   WORLD_SIZE=str(num_hosts), RANK=str(host_id),
                   LOCAL_RANK=os.environ.get("LOCAL_RANK", "0"))
        code = subprocess.call(list(inner), env=env)
        dist.barrier()
        return code
    finally:
        dist.destroy_process_group()


def main(argv=None):
    import argparse
    import sys

    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("worker")
    w.add_argument("--coordinator", required=True)
    w.add_argument("--num-hosts", type=int, required=True)
    w.add_argument("--host-id", type=int, required=True)
    w.add_argument("inner", nargs=argparse.REMAINDER)
    sub.add_parser("simulate")
    args = ap.parse_args(argv)

    if args.cmd == "simulate":
        for p in simulate_failure_recovery():
            print(p)
        return
    inner = args.inner[1:] if args.inner and args.inner[0] == "--" \
        else args.inner
    sys.exit(run_worker(args.coordinator, args.num_hosts, args.host_id,
                        inner))


if __name__ == "__main__":
    main()
