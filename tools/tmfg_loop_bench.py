#!/usr/bin/env python3
"""Time the lazy TMFG loop at Crop size on one GPU, dense and table-first.

Usage, from the root of a checkout, on a machine with a CUDA device::

    python3 tools/tmfg_loop_bench.py                           # this checkout
    python3 tools/tmfg_loop_bench.py --src OTHER/src --label parent
    python3 tools/tmfg_loop_bench.py --steps 16,64,256         # the T sweep

``--src`` points at the ``src/`` directory of another checkout (for
example the parent commit unpacked with ``git archive``), so two versions
of the loop can be timed in one call on the same card: run parent,
change, change, parent.

Two builds on ``make_ucr_like(--dataset, seed=--seed)`` (Crop: n=19412,
L=46):

  * dense: the OPT lazy build (``topk=64``) on the Pearson kernel's S,
    timed from ``prepare_similarity`` to the result (the staged
    pipeline's ``tmfg`` stage);
  * approx: the table-first build (``build_tmfg_sparse``) on the top-K
    kernel's table (K = 64) with the standardized series as its value
    source.

Each prints its pops, host syncs, TMFG seconds and microseconds per pop
(host clock around work that ends in a device synchronise), and the
SHA-256 of its edges, insertion order, edge sum and pop count.  The
hashes go into ``--hashes`` (default ``build/tmfg_loop_hashes.json``)
under the run's label; a run whose hash differs from another label's, or
from another T of its own sweep, fails.  ``--steps`` rebuilds both with
each T (``STEPS_PER_SYNC``, the lazy steps per captured CUDA graph) and
prints the same numbers for each.  The card's name and power limit are
printed before the last line, one JSON object.  It exits non-zero on a
mismatch, or without a card.

``--profile R`` (this checkout's loop only) then traces R graph replays
of each loop 50 replays into a build with ``torch.profiler``: the
kernels' summed device time over the window's wall time (the device's
busy share), the kernels per pop, and the kernels that take the most
time, by name.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
K = 64


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def digest(res) -> str:
    h = hashlib.sha256()
    for t in (res.edges, res.insert_order, res.edge_sum, res.pops):
        h.update(t.cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def profile_loop(tmfg, source, replays: int, warm: int = 50) -> dict:
    """Trace ``replays`` graph replays of one lazy loop, ``warm`` replays
    into its build: device busy share, kernels per pop, top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    d = source()
    st = tmfg._init_state(d)
    T = tmfg.STEPS_PER_SYNC
    graph = tmfg.capture(lambda: tmfg.lazy_step(st, d), T, d.device)
    for _ in range(warm):
        graph.replay()
    p0 = int(st.pops)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    pops = int(st.pops) - p0
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us()
    busy_us = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    return dict(steps=replays * T, pops=pops, wall_s=wall,
                us_per_pop=1e6 * wall / max(pops, 1),
                device_busy_share=busy_us / (1e6 * wall),
                kernels_per_step=sum(v[0] for v in kernels.values())
                / (replays * T),
                top=[dict(name=k[:90], per_step=v[0] / (replays * T),
                          us_per_step=v[1] / (replays * T))
                     for k, v in top])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(HERE / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--dataset", default="Crop")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", default="",
                    help="comma-separated T values to sweep")
    ap.add_argument("--profile", type=int, default=0,
                    help="graph replays of each loop to trace")
    ap.add_argument("--hashes",
                    default=str(HERE / "build" / "tmfg_loop_hashes.json"))
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("tmfg_loop_bench: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from repro_torch.approx import knn, sparse_tmfg
    from repro_torch.core import tmfg
    from repro_torch.data.timeseries import make_ucr_like
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    name, X_np, _, _ = make_ucr_like(args.dataset, seed=args.seed)
    X = torch.from_numpy(X_np).to(dev)
    n, L = X.shape
    S = ops.pearson(X)
    table, Z = knn.topk_pearson_and_z(X, K)
    torch.cuda.synchronize()

    def dense():
        Sp = tmfg.prepare_similarity(S)
        if hasattr(tmfg, "_build"):
            return tmfg._build(Sp, "lazy", topk=K)
        return tmfg._build_lazy(Sp, K)

    def approx():
        st = {}
        res, _, _ = sparse_tmfg.build_tmfg_sparse(table, Xn=Z, stats=st)
        return res, st["host_syncs"]

    def timed(build, what, T):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, syncs = build()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        pops = int(res.pops)
        row = dict(path=what, T=T, pops=pops, host_syncs=int(syncs),
                   tmfg_s=s, us_per_pop=1e6 * s / max(pops, 1),
                   edge_sum=float(res.edge_sum), sha256=digest(res))
        print(f"[{args.label}] {what} T={T}: pops {pops}, host syncs "
              f"{syncs}, {s:.3f} s, {row['us_per_pop']:.2f} us per pop, "
              f"sha256 {row['sha256'][:16]}", flush=True)
        del res
        torch.cuda.empty_cache()
        return row

    T0 = getattr(tmfg, "STEPS_PER_SYNC", None)
    rows = [timed(dense, "dense", T0), timed(approx, "approx", T0)]
    for T in [int(t) for t in args.steps.split(",") if t]:
        if T0 is None:
            print("tmfg_loop_bench: this tree has no STEPS_PER_SYNC",
                  file=sys.stderr)
            sys.exit(1)
        tmfg.STEPS_PER_SYNC = T
        rows += [timed(dense, "dense", T), timed(approx, "approx", T)]
        tmfg.STEPS_PER_SYNC = T0

    profiles = {}
    if args.profile:
        def dense_source():
            Sp = tmfg.prepare_similarity(S)
            return tmfg._Device(Sp, tmfg.candidate_table(Sp, K))

        def approx_source():
            return sparse_tmfg._TableSource(table.values, table.indices, Z,
                                            True)

        for what, source in (("dense", dense_source),
                             ("approx", approx_source)):
            profiles[what] = profile_loop(tmfg, source, args.profile)
            print(f"[{args.label}] {what} profile: "
                  f"{json.dumps(profiles[what])}", flush=True)

    ok = True
    mine = {}
    for r in rows:
        prev = mine.setdefault(r["path"], r["sha256"])
        if prev != r["sha256"]:
            print(f"tmfg_loop_bench: {r['path']} at T={r['T']} differs from "
                  f"the first build of this run", file=sys.stderr)
            ok = False
    path = Path(args.hashes)
    path.parent.mkdir(parents=True, exist_ok=True)
    seen = json.loads(path.read_text()) if path.exists() else {}
    for label, hashes in seen.items():
        for case, h in hashes.items():
            if case in mine and mine[case] != h:
                print(f"tmfg_loop_bench: {case} differs from {label}'s",
                      file=sys.stderr)
                ok = False
    seen[args.label] = mine
    path.write_text(json.dumps(seen, indent=1))
    print(smi("name,power.limit"))
    print(json.dumps({"label": args.label, "dataset": name, "n": n, "L": L,
                      "sim_k": K, "rows": rows, "profiles": profiles,
                      "hashes_agree": ok}))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
