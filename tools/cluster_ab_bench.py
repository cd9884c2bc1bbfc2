#!/usr/bin/env python3
"""Time whole ``cluster()`` calls at Crop size on one GPU, for an A/B of
two checkouts on one card.

Usage, from the root of a checkout, on a machine with a CUDA device::

    python3 tools/cluster_ab_bench.py                          # this checkout
    python3 tools/cluster_ab_bench.py --src OTHER/src --label parent

``--src`` points at the ``src/`` directory of another checkout (for
example the parent commit unpacked with ``git archive``), so two versions
of the pipeline can be timed in one call on the same card: run parent,
change, change, parent.

On ``make_ucr_like(--dataset, seed=--seed)`` (Crop: n=19412, L=46) it
runs ``cluster(X, k, config=PipelineConfig.opt())`` ``--dense`` times
and ``cluster(X, k, config=PipelineConfig.approx(sim_k=64))``
``--approx`` times, fused, in one process: the first call of each pays
what a process pays once (the kernel library's load and, where the tree
caches them, the lazy loop's buffers and CUDA-graph capture), the later
ones what a serving process pays per call.  Each call prints its seconds
(host clock around a call that ends in a device synchronise), its peak
device memory (``max_memory_allocated`` after a reset), the bytes
allocated before it and after its result is dropped (what the process
keeps between calls, the cached loop program included) and the SHA-256
of its linkage and labels.  The hashes go into ``--hashes`` (default
``build/cluster_ab_hashes.json``) under the run's label; a linkage that
differs from another label's, or from another call of its own run,
fails.  The card's name and power limit are printed before the last
line, one JSON object.  It exits non-zero on a mismatch, or without a
card.
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


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(HERE / "src"),
                    help="the src/ directory of the tree to time")
    ap.add_argument("--label", default="change")
    ap.add_argument("--dataset", default="Crop")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dense", type=int, default=2,
                    help="dense OPT calls (default 2)")
    ap.add_argument("--approx", type=int, default=1,
                    help="approx (sim_k=64) calls (default 1)")
    ap.add_argument("--hashes",
                    default=str(HERE / "build" / "cluster_ab_hashes.json"))
    args = ap.parse_args()

    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("cluster_ab_bench: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    from repro_torch.core import PipelineConfig, cluster
    from repro_torch.data.timeseries import make_ucr_like

    name, X, _, k = make_ucr_like(args.dataset, seed=args.seed)
    n, L = X.shape
    rows = []
    mine = {}
    ok = True
    plan = ([("dense", PipelineConfig.opt())] * args.dense
            + [("approx", PipelineConfig.approx(sim_k=64))] * args.approx)
    for i, (what, cfg) in enumerate(plan):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = cluster(X, k=k, config=cfg)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(res.linkage).tobytes())
        h.update(np.ascontiguousarray(res.labels).tobytes())
        row = dict(path=what, call=sum(r["path"] == what for r in rows) + 1,
                   seconds=s, peak_bytes=torch.cuda.max_memory_allocated(),
                   allocated_before=before, sha256=h.hexdigest())
        rows.append(row)
        del res
        row["allocated_after"] = torch.cuda.memory_allocated()
        print(f"[{args.label}] {what} call {row['call']}: {s:.3f} s, peak "
              f"{row['peak_bytes']} B, allocated {before} B before and "
              f"{row['allocated_after']} B after, sha256 "
              f"{row['sha256'][:16]}", flush=True)
        if mine.setdefault(what, row["sha256"]) != row["sha256"]:
            print(f"cluster_ab_bench: {what} call {row['call']} differs "
                  f"from its first call", file=sys.stderr)
            ok = False
        torch.cuda.empty_cache()
    path = Path(args.hashes)
    path.parent.mkdir(parents=True, exist_ok=True)
    seen = json.loads(path.read_text()) if path.exists() else {}
    for label, hashes in seen.items():
        for case, hv in hashes.items():
            if case in mine and mine[case] != hv:
                print(f"cluster_ab_bench: {case} differs from {label}'s",
                      file=sys.stderr)
                ok = False
    seen[args.label] = mine
    path.write_text(json.dumps(seen, indent=1))
    print(smi("name,power.limit"))
    print(json.dumps({"label": args.label, "dataset": name, "n": n, "L": L,
                      "k": k, "rows": rows, "hashes_agree": ok}))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
