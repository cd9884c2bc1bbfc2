#!/usr/bin/env python3
"""Time the multi-device funnel against the single-card call, whole
``cluster()`` calls at Crop size on one GPU (a world-1 NCCL group).

Usage, from the root of a checkout, on a machine with a CUDA device::

    python3 tools/funnel_bench.py                  # approx, 4 calls
    python3 tools/funnel_bench.py --then-profile   # + one after profile()
    python3 tools/funnel_bench.py --dense          # OPT on one S, 4 calls

On ``make_ucr_like(--dataset, seed=--seed)`` (Crop: n=19412, L=46) it
runs ``cluster(X, k, config=PipelineConfig.approx(sim_k=64))`` fused, in
one process, in the order single card, funnel (``mesh=data_mesh()``),
funnel, single card; the first call builds the kernel library and the
lazy loop's program, so it is reported apart.  ``--dense`` runs
``PipelineConfig.opt()`` on the Pearson kernel's S instead (the dense
funnel: the column-sharded lazy loop with its collectives in the
captured steps, the row-sharded hub APSP).  Each call prints its
seconds (host clock around a call that ends in a device synchronise)
and the SHA-256 of its linkage; a linkage that differs from the first
call's fails.  ``--then-profile`` then runs ``obs.profile()`` over a
small ``cluster()`` call and one more single-card call, to show whether
a process that has run the profiler launches slower afterwards (as
``chip_smoke.py``'s phase 11 runs after phase 10's ``profile()``).  The
card's name and power limit are printed before the last line, one JSON
object.  It exits non-zero on a mismatch, or without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="Crop")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--then-profile", action="store_true")
    ap.add_argument("--dense", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE / "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("funnel_bench: needs a CUDA device")
    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.core import PipelineConfig, cluster
    from repro_torch.data.timeseries import make_ucr_like
    from repro_torch.dist.sharding import data_mesh
    from repro_torch.kernels import ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    name, X, _, k = make_ucr_like(args.dataset, seed=args.seed)
    cfg = PipelineConfig.approx(sim_k=64)
    data = dict(X=X)
    if args.dense:
        cfg = PipelineConfig.opt()
        data = dict(S=ops.pearson(torch.from_numpy(X).cuda()))
    mesh = data_mesh()
    rows, first = [], None

    def run(label, m):
        nonlocal first
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = cluster(k=k, config=cfg, mesh=m, **data)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        digest = hashlib.sha256(r.linkage.tobytes()).hexdigest()
        first = first or digest
        row = dict(call=len(rows), label=label, seconds=sec, sha256=digest)
        rows.append(row)
        print(f"[funnel_bench] {json.dumps(row)}", flush=True)
        if digest != first:
            sys.exit(f"funnel_bench: {label} linkage differs from the first "
                     f"call's")

    for label in ("single", "funnel", "funnel", "single"):
        run(label, mesh if label == "funnel" else None)
    if args.then_profile:
        logdir = HERE / "build" / "funnel-bench-profile"
        with obs.profile(str(logdir)):
            cluster(X[:64], k=4, config=PipelineConfig.opt())
        torch.cuda.synchronize()
        shutil.rmtree(logdir, ignore_errors=True)
        run("single after profile()", None)
    dist.destroy_process_group()
    print(smi)
    print(json.dumps(dict(dataset=name, n=int(X.shape[0]),
                          config="opt on S" if args.dense else "approx",
                          calls=rows)))


if __name__ == "__main__":
    main()
