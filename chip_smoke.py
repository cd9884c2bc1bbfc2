#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Usage, from the root of a checkout, on a machine with one NVIDIA GPU::

    python3 chip_smoke.py                  # the main path at Crop size
    python3 chip_smoke.py --dataset CBF    # a smaller Table-1 size

Phases (any failure exits non-zero; no phase is skipped):

1. Environment: the card's name and power limit, torch and CUDA
   versions, and the build of every kernel from ``kernels/csrc/``.
2. Kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the shapes the main path gives it (Pearson at (n, L); the
   hub Bellman-Ford round (h, n) x (n, n) and the hub composition
   (n, h) x (h, n) for min-plus; the (n, n) HAC scan for masked argmax),
   with times from CUDA events.
3. Main path: ``cluster(X, k, config=PipelineConfig.opt())`` on the
   dataset (random-free: ``make_ucr_like`` from a seed), once as the
   default back-to-back run, with every kernel's launch count reset
   just before and read just after, and once with ``fused=False`` for
   per-stage seconds; the two linkages must be bitwise equal.
4. Parity: at n = 2000, the ``cuda`` and ``torch`` backends give a
   bitwise-equal linkage on one S (OPT, and HEAP with its exact
   (n, n) x (n, n) squarings), and agreeing labels (ARI >= 0.99) from
   one X.

The line before the last is the JSON object of per-kernel numbers; the
last line is ``{"ok": true, "device": {...}}``.  The script needs the
repository's ``src/`` beside it and a CUDA device, and exits non-zero
without printing a result when either is missing.  It imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

PARITY_N = 2000


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def bound(bytes_moved: float, ops: float):
    """(bound_ms, bound_by): the larger of the memory and compute times."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="Crop",
                    help="UCR_SIZES entry for the main path (default Crop)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not (SRC / "repro_torch" / "__init__.py").exists():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")

    import numpy as np

    from repro_torch.core import PipelineConfig, adjusted_rand_index, cluster
    from repro_torch.core.apsp import hub_count
    from repro_torch.data.timeseries import make_dataset, make_ucr_like
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.gainscan import masked_argmax_cuda
    from repro_torch.kernels.minplus import minplus_cuda
    from repro_torch.kernels.pearson import pearson_cuda

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    # ---- 1. environment ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"[env] {smi_line}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {_build.BUILD_INFO['path']} in "
        f"{time.perf_counter() - t0:.2f} s (cached={_build.BUILD_INFO['cached']})")
    for line in str(_build.BUILD_INFO.get("ptxas", "")).splitlines():
        if "registers" in line or "spill" in line:
            log(f"[ptxas] {line.strip()}")

    def cuda_ms(fn, reps: int) -> float:
        fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / reps

    # ---- 2. kernels at the main path's shapes --------------------------
    name, X_np, y, k = make_ucr_like(args.dataset, seed=args.seed)
    n, L = X_np.shape
    h = hub_count(n)
    log(f"[data] {name}: n={n} L={L} classes={k} hubs={h}")
    X = torch.from_numpy(X_np).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    entries = {}

    # Pearson
    S_k = pearson_cuda(X)
    S_p = ref.pearson_ref(X)
    sync()
    err = float((S_k - S_p).abs().max())
    check(err <= 1e-5, f"pearson kernel vs plain: max abs err {err} > 1e-5")
    check(bool(torch.equal(S_k, S_k.T)), "pearson kernel output not symmetric")
    del S_k, S_p
    # the output is symmetric: n (n + 1) / 2 dot products of length L
    b_ms, b_by = bound(4 * (n * L + 2 * n + n * n), n * (n + 1) * L)
    entries["pearson"] = dict(
        name="pearson", route="cuda",
        source="src/repro_torch/kernels/csrc/pearson.cu",
        replaces="src/repro/kernels/pearson.py:35",
        shape=[n, L], max_abs_err=err,
        ms=cuda_ms(lambda: pearson_cuda(X), 10),
        plain_ms=cuda_ms(lambda: ref.pearson_ref(X), 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.corrcoef(X), 10))
    log(f"[kernel] pearson ok: {entries['pearson']}")

    # min-plus: the hub Bellman-Ford round and the hub composition
    def dist(rows, cols, inf_frac=0.3):
        a = torch.rand((rows, cols), generator=gen, device=dev) * 2.0
        a.masked_fill_(torch.rand((rows, cols), generator=gen, device=dev)
                       < inf_frac, float("inf"))
        return a

    Wm = dist(n, n)
    Dh = dist(h, n)
    out_k = minplus_cuda(Dh, Wm)
    out_p = ref.minplus_ref(Dh, Wm)
    check(bool(torch.equal(out_k, out_p)),
          "minplus kernel vs plain differ at (h, n) x (n, n)")
    round_ms = cuda_ms(lambda: minplus_cuda(Dh, Wm), 3)
    round_plain = cuda_ms(lambda: ref.minplus_ref(Dh, Wm), 1)
    del Wm, out_k, out_p
    DhT = Dh.T.contiguous()
    out_k = minplus_cuda(DhT, Dh)
    out_p = ref.minplus_ref(DhT, Dh)
    check(bool(torch.equal(out_k, out_p)),
          "minplus kernel vs plain differ at (n, h) x (h, n)")
    del out_k, out_p
    comp_ms = cuda_ms(lambda: minplus_cuda(DhT, Dh), 3)
    comp_plain = cuda_ms(lambda: ref.minplus_ref(DhT, Dh), 1)
    del DhT, Dh
    b_ms, b_by = bound(4 * (h * n + n * n + h * n), 2 * h * n * n)
    c_ms, c_by = bound(4 * (n * h + h * n + n * n), 2 * n * h * n)
    entries["minplus"] = dict(
        name="minplus", route="cuda",
        source="src/repro_torch/kernels/csrc/minplus.cu",
        replaces="src/repro/kernels/minplus.py:39",
        shape=[h, n, n], max_abs_err=0.0, ms=round_ms, plain_ms=round_plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        compose=dict(shape=[n, h, n], ms=comp_ms, plain_ms=comp_plain,
                     bound_ms=c_ms, bound_by=c_by, max_abs_err=0.0))
    log(f"[kernel] minplus ok (bitwise): {entries['minplus']}")

    # masked argmax: the HAC scan; values on a 1/1000 grid give many ties
    Sm = torch.randint(0, 1000, (n, n), generator=gen, device=dev).float()
    Sm /= 1000.0
    mask = torch.rand(n, generator=gen, device=dev) < 0.5
    vk, ik = masked_argmax_cuda(Sm, mask)
    vp, ip = ref.masked_argmax_ref(Sm, mask)
    check(bool(torch.equal(vk, vp)) and bool(torch.equal(ik, ip)),
          "masked_argmax kernel vs plain differ")
    full = torch.ones(n, dtype=torch.bool, device=dev)
    vk, ik = masked_argmax_cuda(Sm[:64], full)
    vp, ip = ref.masked_argmax_ref(Sm[:64], full)
    check(bool(torch.equal(vk, vp)) and bool(torch.equal(ik, ip))
          and bool((ik == 0).all()), "masked_argmax fully masked rows differ")
    b_ms, b_by = bound(4 * n * n + n + 8 * n, n * n)
    entries["masked_argmax"] = dict(
        name="masked_argmax", route="cuda",
        source="src/repro_torch/kernels/csrc/masked_argmax.cu",
        replaces="src/repro/kernels/gainscan.py:46",
        shape=[n, n], max_abs_err=0.0,
        ms=cuda_ms(lambda: masked_argmax_cuda(Sm, mask), 20),
        plain_ms=cuda_ms(lambda: ref.masked_argmax_ref(Sm, mask), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    del Sm, mask, vk, ik, vp, ip
    log(f"[kernel] masked_argmax ok (bitwise): {entries['masked_argmax']}")
    torch.cuda.empty_cache()

    # ---- 3. the main path ----------------------------------------------
    cfg = PipelineConfig.opt()
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = cluster(X_np, k=k, config=cfg, collect_timings=True)
    sync()
    total = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(launches["pearson"] == 1, f"pearson launches {launches}")
    check(launches["minplus"] >= 2, f"minplus launches {launches}")
    check(launches["masked_argmax"] == n - 1,
          f"masked_argmax launches {launches} != n-1 = {n - 1}")
    Z = res.linkage
    check(res.labels.shape == (n,), f"labels shape {res.labels.shape}")
    check(Z.shape == (n - 1, 4) and Z.dtype == np.float32,
          f"linkage {Z.shape} {Z.dtype}")
    check(bool(np.isfinite(Z).all()), "non-finite linkage entries")
    check(bool((np.diff(Z[:, 2]) >= 0).all()),
          "complete-linkage heights are not monotone")
    check(int(Z[-1, 3]) == n, "last merge does not hold all n points")
    check(len(np.unique(res.labels)) == k, "labels do not have k clusters")
    ari = adjusted_rand_index(y, res.labels)
    t = res.timings
    log(f"[main] {name} n={n} L={L}: total {total:.3f} s, pops "
        f"{int(t['tmfg_pops'])}, tmfg host syncs {int(t['tmfg_host_syncs'])}, "
        f"hub Bellman-Ford rounds {int(t['apsp_rounds'])}, launches "
        f"{launches}, peak memory {peak} B, ARI vs generator labels {ari:.4f}")

    res2 = cluster(X_np, k=k, config=cfg, fused=False, collect_timings=True)
    check(np.array_equal(res2.linkage, Z), "fused=False linkage differs")
    check(np.array_equal(res2.labels, res.labels), "fused=False labels differ")
    stages = {s: res2.timings[s] for s in
              ("similarity", "tmfg", "apsp", "dbht", "hac", "total")}
    log(f"[main] per-stage seconds (fused=False): {json.dumps(stages)}")
    main = dict(dataset=name, n=n, L=L, k=k, total_s=total, stages_s=stages,
                pops=int(t["tmfg_pops"]),
                tmfg_host_syncs=int(t["tmfg_host_syncs"]),
                bf_rounds=int(t["apsp_rounds"]), launches=launches,
                peak_bytes=peak, ari=ari)
    del res, res2
    torch.cuda.empty_cache()

    # ---- 4. cuda vs torch backends at n = 2000 --------------------------
    Xp, yp = make_dataset(PARITY_N, 46, 8, noise=0.5, seed=args.seed + 1)
    Sp = ops.pearson(torch.from_numpy(Xp).to(dev), backend="torch")
    rc = cluster(S=Sp, config=PipelineConfig.opt(backend="cuda"), k=8)
    rt = cluster(S=Sp, config=PipelineConfig.opt(backend="torch"), k=8)
    check(np.array_equal(rc.linkage, rt.linkage),
          "cuda and torch backends: linkage differs on one S")
    check(np.array_equal(rc.labels, rt.labels),
          "cuda and torch backends: labels differ on one S")
    # HEAP-TDBHT shares the lazy construction and squares D exactly with the
    # (n, n) x (n, n) min-plus kernel
    hc = cluster(S=Sp, config=PipelineConfig.heap(backend="cuda"), k=8)
    ht = cluster(S=Sp, config=PipelineConfig.heap(backend="torch"), k=8)
    check(np.array_equal(hc.linkage, ht.linkage),
          "heap: cuda and torch backends: linkage differs on one S")
    lc = cluster(Xp, config=PipelineConfig.opt(backend="cuda"), k=8).labels
    lt = cluster(Xp, config=PipelineConfig.opt(backend="torch"), k=8).labels
    ari_x = adjusted_rand_index(lc, lt)
    check(ari_x >= 0.99, f"cuda vs torch labels from X: ARI {ari_x} < 0.99")
    log(f"[parity] n={PARITY_N}: opt and heap linkage bitwise equal on one "
        f"S; labels "
        f"from X ARI {ari_x:.4f}; ARI vs generator "
        f"{adjusted_rand_index(yp, lc):.4f}")

    for e in entries.values():
        e["launches"] = launches[e["name"]]
    log(f"[main] {json.dumps(main)}")
    log(smi_line)
    log(json.dumps({"kernels": list(entries.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
