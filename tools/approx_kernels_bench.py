#!/usr/bin/env python3
"""Time and check the approx path's two kernels, top-K Pearson and the
sparse relaxation round, on one GPU.

Usage, from the root of a checkout, on a machine with a CUDA device::

    python3 tools/approx_kernels_bench.py                     # this checkout
    python3 tools/approx_kernels_bench.py --src OTHER/src --label parent

``--src`` points at the ``src/`` directory of another checkout (for
example the parent commit unpacked with ``git archive``), so two
versions of the kernels can be timed in one process each on the same
card: run parent, change, change, parent.  The Apollonian generator and
the probe sources always come from this checkout.

Top-K (``topk_pearson_cuda``) at Crop's shape (n = 19412, L = 46,
k = 64), at k = 5000 (the candidate lists in device memory) and at
Mallat's (2400, 1024, 64) (a series longer than one shared-memory
chunk); each output held bitwise against a stable descending sort of
``pearson_cuda``'s rows with the diagonal excluded.  ``--probes`` adds
the probe split at Crop's shape: the FMA loop alone, the FMA loop with
the filter at its steady state (every row's threshold preset to its
final k-th pair, so nothing is compacted before the end), and the full
kernel.  For this checkout's kernel the probes are builds of
``csrc/topk.cu`` with ``-DTOPK_PROBE=1`` and ``2``; ``--baseline-probes``
runs the same split on ``tools/topk_baseline_probe.cu``, a copy of the
first design (row panels with per-row candidate buffers).

Relaxation (one round per launch) at Crop's size, 140 sources, on two
graphs of 3n - 6 edges: a path plus random chords (near-uniform
degrees, random sources) and a seeded random Apollonian network (a
TMFG's degree shape) with the hubs chosen by strength as
``core/apsp.hub_factor_sparse`` chooses them; one round timed on the
Bellman-Ford state three rounds in (the device's time, from a CUDA
graph of 50 launches replayed, and the time per host call), and the
whole fixed point (host loop, one flag read back per round) timed on
the host clock.  Every round and fixed point is held bitwise against
the plain version.

It prints each kernel's ptxas line and the count of LDL and STL (spills)
in its SASS (``cuobjdump -sass``).  The last line is one JSON object.
It exits non-zero on any mismatch or without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
CROP = (19412, 46)            # Crop's n and L
TOPK_K = 64                   # the approx path's sim_k
BIG_K = 5000                  # candidate lists in device memory
LONG = (2400, 1024)           # Mallat's n and L
SOURCES = 140                 # hub_count(19412)
REPS = 5                      # launches per top-K timing
RELAX_REPS = 50               # launches per relaxation timing
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def sass_counts(lib: str, kernels, nvcc: str) -> dict:
    tool = Path(nvcc).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                         text=True, timeout=300)
    counts = {}
    for fn in out.stdout.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        if any(k in name for k in kernels):
            counts[name] = {op: fn.count(op) for op in
                            ("FFMA", "LDS.128", "LDL", "STL")}
    return counts


def build_probe(nvcc: str, src: Path, name: str, defines=()) -> ctypes.CDLL:
    """nvcc one source into its own shared library under build/probes/,
    printing ptxas's register and spill lines."""
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *defines]
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    out_dir = HERE / "build" / "probes" / h.hexdigest()[:16]
    lib = out_dir / f"lib{name}.so"
    if not lib.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        out = subprocess.run([nvcc, *flags, "-shared", "-o", str(lib),
                              str(src)], capture_output=True, text=True,
                             timeout=600)
        if out.returncode != 0:
            sys.exit(f"probe build {name} failed:\n{out.stderr}")
        for ln in (out.stdout + out.stderr).splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[probe {name}] {ln.strip()}", flush=True)
    return ctypes.CDLL(str(lib))


def load_graphs_module():
    path = HERE / "src" / "repro_torch" / "data" / "graphs.py"
    spec = importlib.util.spec_from_file_location("bench_graphs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(HERE / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--probes", action="store_true",
                    help="the probe split of this source's top-K kernel")
    ap.add_argument("--baseline-probes", action="store_true",
                    help="the probe split of tools/topk_baseline_probe.cu "
                         "(needs the first design's plan: --src of a "
                         "checkout with that kernel)")
    args = ap.parse_args()

    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("approx_kernels_bench: needs a CUDA device")
    from repro_torch.core.apsp import hub_factor_sparse
    from repro_torch.data.timeseries import make_dataset, make_ucr_like
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import sparse_apsp as sp
    from repro_torch.kernels import topk as topk_mod
    from repro_torch.kernels.pearson import pearson_cuda
    graphs = load_graphs_module()

    dev = torch.device("cuda")
    label = args.label
    card = smi("name,power.limit")
    _build.library()
    lib = _build.BUILD_INFO["path"]
    nvcc = _build.nvcc_path()
    print(f"[{label}] {card}; {lib}", flush=True)
    ptxas = [" | ".join(ln.strip().splitlines()) for ln in
             str(_build.BUILD_INFO.get("ptxas", ""))
             .split("Compiling entry function")
             if "topk" in ln or "relax" in ln]
    for ln in ptxas:
        print(f"[{label}] ptxas: {ln}", flush=True)
    sass = sass_counts(lib, ("topk", "relax"), nvcc)
    print(f"[{label}] sass: {sass}", flush=True)

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(fn, reps):
        """Device time per call: reps calls captured in one CUDA graph and
        replayed, so the host's time per call (checks, allocations, the
        ctypes call) does not hide a kernel shorter than it."""
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    bad = []
    res = dict(label=label, card=card, src=str(src), sass=sass,
               ptxas=ptxas)

    # ---- top-K ------------------------------------------------------------
    def check_topk(X, k):
        """Bitwise against the full Pearson kernel's matrix, sorted."""
        v, i = topk_mod.topk_pearson_cuda(X, k)
        S = pearson_cuda(X)
        S.fill_diagonal_(float("-inf"))
        n = X.shape[0]
        ok = True
        for r0 in range(0, n, 2048):
            sv, si = torch.sort(S[r0:r0 + 2048], dim=1, descending=True,
                                stable=True)
            ok &= bool(torch.equal(v[r0:r0 + 2048], sv[:, :k])) and bool(
                torch.equal(i[r0:r0 + 2048], si[:, :k].int()))
        del S
        torch.cuda.empty_cache()
        return ok, v, i

    topk_rows = []
    _, X_np, _, _ = make_ucr_like("Crop", seed=0)
    Xc = torch.from_numpy(X_np).to(dev)
    cases = [("crop", Xc, TOPK_K), ("crop_big_k", Xc, BIG_K)]
    Xl, _ = make_dataset(LONG[0], LONG[1], 8, seed=0)
    cases.append(("mallat_long_L", torch.from_numpy(Xl).to(dev), TOPK_K))
    crop_out = None
    for name, X, k in cases:
        n, L = X.shape
        ok, v, i = check_topk(X, k)
        if name == "crop":
            crop_out = (v, i)
        t = ms(lambda: topk_mod.topk_pearson_cuda(X, k),
               REPS if k < 1000 else 1)
        flops = n * (n + 1) * L
        bound = max(flops / FP32_OPS_PER_S,
                    (4 * (n * L + 2 * n) + 8 * n * k) / HBM_BYTES_PER_S) * 1e3
        row = dict(case=name, shape=[n, L, k], ms=t, bound_ms=bound,
                   share=bound / t, bitwise=ok)
        topk_rows.append(row)
        print(f"[{label}] topk {json.dumps(row)}", flush=True)
        if not ok:
            bad.append(f"topk {name}")
    res["topk"] = topk_rows

    if args.probes or args.baseline_probes:
        v, i = crop_out
        thr_v = v[:, -1].contiguous()
        thr_i = i[:, -1].contiguous()
        probes = {}
        if args.probes:
            csrc = src / "repro_torch" / "kernels" / "csrc" / "topk.cu"
            kern = topk_mod.KERNEL
            saved = kern._bind()
            try:
                probes["probe0"] = ms(
                    lambda: topk_mod.topk_pearson_cuda(Xc, TOPK_K), REPS)
                counts = torch.zeros(8, dtype=torch.int64, device=dev)
                for p in (1, 2, 3):
                    plib = build_probe(nvcc, csrc, f"topkprobe{p}",
                                       [f"-DTOPK_PROBE={p}"])
                    fn = getattr(plib, kern.symbol)
                    fn.argtypes = saved.argtypes
                    fn.restype = ctypes.c_int
                    if p >= 2:
                        setter = plib.repro_topk_probe_buffer
                        setter.argtypes = [ctypes.c_void_p]
                        setter((thr_v if p == 2 else counts).data_ptr())
                    kern._fn = fn
                    if p == 3:
                        topk_mod.topk_pearson_cuda(Xc, TOPK_K)
                        torch.cuda.synchronize()
                        c = counts.tolist()
                        probes["counts"] = dict(
                            tiles=c[0], compaction_rounds=c[1],
                            rows_merged=c[2], pairs_staged=c[3],
                            round_cycles=c[4], block_cycles_sum=c[5],
                            block_cycles_max=c[6])
                        continue
                    probes[f"probe{p}"] = ms(
                        lambda: topk_mod.topk_pearson_cuda(Xc, TOPK_K), REPS)
            finally:
                kern._fn = saved
        if args.baseline_probes:
            n, L = CROP
            rows, cap, Lc, smem, in_memory = topk_mod.plan(n, L, TOPK_K)
            blib = build_probe(nvcc, HERE / "tools" / "topk_baseline_probe.cu",
                               "topkbaseline")
            fn = blib.topk_baseline_probe
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            from repro_torch.kernels.pearson import row_stats
            mu, rs = row_stats(Xc)
            vo = torch.empty((n, TOPK_K), device=dev)
            io = torch.empty((n, TOPK_K), dtype=torch.int32, device=dev)
            stream = torch.cuda.current_stream().cuda_stream
            for p in (0, 1, 2):
                def run(p=p):
                    err = fn(Xc.data_ptr(), mu.data_ptr(), rs.data_ptr(),
                             vo.data_ptr(), io.data_ptr(), thr_v.data_ptr(),
                             thr_i.data_ptr(), n, L, TOPK_K, rows, cap, Lc,
                             smem, p, stream)
                    if err:
                        sys.exit(f"baseline probe {p}: cudaError {err}")
                probes[f"baseline_probe{p}"] = ms(run, REPS)
                if p == 0 and not (torch.equal(vo, v) and torch.equal(io, i)):
                    bad.append("baseline probe 0 differs from the kernel")
        res["topk_probes"] = probes
        print(f"[{label}] topk probes (ms; 0 full, 1 FMA alone, 2 FMA and "
              f"steady filter): {json.dumps(probes)}", flush=True)
    del Xc, crop_out
    torch.cuda.empty_cache()

    # ---- sparse relaxation ------------------------------------------------
    n = CROP[0]
    rng = np.random.default_rng(0)
    E = 3 * n - 6
    pairs = {(i, i + 1) for i in range(n - 1)}
    while len(pairs) < E:
        a, b = (int(x) for x in rng.integers(0, n, 2))
        if a != b:
            pairs.add((min(a, b), max(a, b)))
    path_edges = np.array(sorted(pairs), dtype=np.int32)
    apo_edges = graphs.apollonian_edges(n, seed=0)
    relax_rows = []
    for gname, edges in (("path_chords", path_edges),
                         ("apollonian", apo_edges)):
        w = rng.uniform(0.1, 2.0, edges.shape[0]).astype(np.float32)
        g = sp.csr_from_edges(n, torch.from_numpy(edges).to(dev),
                              torch.from_numpy(w).to(dev))
        deg = (g.indptr[1:] - g.indptr[:-1])
        if gname == "path_chords":
            src_v = torch.from_numpy(rng.permutation(n)[:SOURCES]).to(dev)
        else:
            strength = sp.hub_strength(g)
            src_v = torch.sort(strength, descending=True,
                               stable=True)[1][:SOURCES]
        s = SOURCES
        D = torch.full((s, n), float("inf"), device=dev)
        D[torch.arange(s, device=dev), src_v.long()] = 0.0
        for _ in range(3):
            D = ref.sparse_relax_ref(D, g.indptr, g.cols, g.vals)
        want = ref.sparse_relax_ref(D, g.indptr, g.cols, g.vals)
        got, ch = ops.sparse_relax(D, g, backend="cuda")
        ok_round = bool(torch.equal(got, want)) and int(ch.item()) == int(
            bool((want < D).any()))
        if hasattr(sp, "sparse_relax_t_cuda"):
            plan = sp.relax_plan(g.indptr)
            Dt = sp.to_sources_minor(D)
            one = lambda: sp.sparse_relax_t_cuda(  # noqa: E731
                Dt, s, g.indptr, g.cols, g.vals, plan)
        else:
            one = lambda: sp.sparse_relax_cuda(  # noqa: E731
                D, g.indptr, g.cols, g.vals)
        # the device's time (graph replay) and the time per host call
        t_round = graph_ms(one, RELAX_REPS)
        t_call = ms(one, RELAX_REPS)
        # the fixed point from the same sources, and the hub factor
        fk, fp = {}, {}
        Dk = sp.sparse_apsp_sources(g, src_v, backend="cuda", stats=fk)
        Dp = sp.sparse_apsp_sources(g, src_v, backend="torch", stats=fp)
        ok_fix = bool(torch.equal(Dk, Dp)) and fk == fp
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        hs = {}
        t0 = time.perf_counter()
        hubs, _ = hub_factor_sparse(g, backend="cuda", stats=hs)
        torch.cuda.synchronize()
        t_fix = (time.perf_counter() - t0) * 1e3
        launches = ops.launch_counts()["sparse_relax"]
        m = int(g.cols.shape[0])
        bound = (4 * 2 * s * n + 4 * (n + 1) + 8 * m) / HBM_BYTES_PER_S * 1e3
        row = dict(graph=gname, s=s, n=n, entries=m,
                   max_degree=int(deg.max()), round_ms=t_round,
                   round_ms_per_host_call=t_call,
                   bound_ms=bound, share=bound / t_round,
                   round_bitwise=ok_round, fixed_point_bitwise=ok_fix,
                   fixed_point_rounds=fk["bf_rounds"],
                   hub_factor_ms=t_fix, hub_factor_rounds=hs["bf_rounds"],
                   hub_factor_launches=launches)
        relax_rows.append(row)
        print(f"[{label}] relax {json.dumps(row)}", flush=True)
        if not (ok_round and ok_fix and launches == hs["bf_rounds"]):
            bad.append(f"relax {gname}")
    res["relax"] = relax_rows
    res["mismatches"] = bad
    print(json.dumps(res), flush=True)
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
