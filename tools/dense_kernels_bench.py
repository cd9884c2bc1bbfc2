#!/usr/bin/env python3
"""Time and check the Pearson kernel and the fp32 flash-attention kernel
on one GPU.

Usage, from the root of a checkout, on a machine with a CUDA device::

    python3 tools/dense_kernels_bench.py                     # this checkout
    python3 tools/dense_kernels_bench.py --src OTHER/src --label parent

``--src`` points at the ``src/`` directory of another checkout (for
example the parent commit unpacked with ``git archive``), so two
versions of the kernels can be timed in one process each on the same
card: run parent, change, change, parent.

Pearson (``pearson_cuda``) at Crop's shape (19412, 46), at Mallat's
(2400, 1024) and at two ragged n (n % 4 != 0, n % 128 != 0): Crop's
first 19411 rows and (2911, 46),
each output held within 1e-5 of the plain version, bitwise symmetric,
and bitwise equal to every other run's output of the same case: the
SHA-256 of each output goes into ``--hashes`` (default
``build/dense_kernels_hashes.json`` in this checkout) under the run's
label, and a run whose hash differs from another label's fails.

fp32 flash attention (``flash_attention_cuda`` on float32) at the MQA
shape (1, 1000, 48, 1, 128) causal, at granite-3-8b's fp32 prefill
(1, 1024, 32, 8, 128) causal and at hd 256 with window 64
(1, 1024, 8, 4, 256), each within 1e-5 of ``ref.flash_attention_ref``.

It also builds ``tools/dense_store_probe.cu`` and times four ways of
writing an (n, n) fp32 array (a memset's grid-stride stores; 128 x 128
tiles written in 512-byte row pieces, in 4 rows x 128 bytes or in 8
rows x 64 bytes per warp store) at Crop's n = 19412, whose odd rows
start 16 bytes into a 32-byte sector, and at n = 19464, whose rows all
start on a sector.

Each time is CUDA events over repeated launches, beside its bound (the
larger of the bytes each input read once and each output written once
at 3.35 TB/s and the fp32 operations at 67 TFLOP/s).  It prints each
kernel's ptxas line and the count of FFMA, LDS.128, LDL and STL in its
SASS (``cuobjdump -sass``), the card's name and power limit, and as the
last line one JSON object.  It exits non-zero on any mismatch or spill,
or without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
PEARSON_CASES = [("crop", 19412, 46), ("crop_ragged", 19411, 46),
                 ("mallat", 2400, 1024), ("ragged", 2911, 46)]
FLASH_CASES = [("mqa", (1, 1000, 48, 1, 128), 0),
               ("granite_fp32_prefill", (1, 1024, 32, 8, 128), 0),
               ("hd256_window64", (1, 1024, 8, 4, 256), 64)]
REPS = 10
STORE_SIZES = (19412, 19464)   # Crop's n (n % 8 == 4), and n % 8 == 0
STORE_MODES = ("memset", "tile_rows_512B", "tile_4rows_128B",
               "tile_8rows_64B")
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
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


def store_probe(nvcc: str, ms) -> list:
    """Build tools/dense_store_probe.cu into build/probes/ and time each
    write pattern at STORE_SIZES on a grid of two blocks per SM."""
    import torch
    src = HERE / "tools" / "dense_store_probe.cu"
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC"]
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    lib = HERE / "build" / "probes" / h.hexdigest()[:16] / "libstore.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        out = subprocess.run([nvcc, *flags, "-shared", "-o", str(lib),
                              str(src)], capture_output=True, text=True,
                             timeout=600)
        if out.returncode != 0:
            sys.exit(f"store probe build failed:\n{out.stderr}")
    fn = ctypes.CDLL(str(lib)).dense_store_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    grid = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for n in STORE_SIZES:
        out = torch.empty((n, n), device="cuda")
        for mode, name in enumerate(STORE_MODES):
            def run(mode=mode):
                err = fn(out.data_ptr(), n, mode, grid,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    sys.exit(f"store probe {name}: cudaError {err}")
            t = ms(run, REPS)
            rows.append(dict(n=n, pattern=name, ms=t,
                             tb_per_s=4 * n * n / t / 1e9))
        del out
        torch.cuda.empty_cache()
    return rows


def bound_ms(bytes_moved: float, ops: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(HERE / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--hashes",
                    default=str(HERE / "build" / "dense_kernels_hashes.json"))
    args = ap.parse_args()

    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        sys.exit("dense_kernels_bench: needs a CUDA device")
    from repro_torch.data.timeseries import make_dataset, make_ucr_like
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.pearson import pearson_cuda

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
             if "pearson" in ln or "flash_kernel" in ln]
    for ln in ptxas:
        print(f"[{label}] ptxas: {ln}", flush=True)
    sass = sass_counts(lib, ("pearson_kernel", "flash_kernel"), nvcc)
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

    bad = [f"spill in {k}" for k, c in sass.items()
           if c["LDL"] or c["STL"]]
    hashes = {}
    pearson_rows = []
    for name, n, L in PEARSON_CASES:
        if name.startswith("crop"):
            X_np = make_ucr_like("Crop", seed=0)[1][:n]
        else:
            X_np = make_dataset(n, L, 8, seed=0)[0]
        X = torch.from_numpy(X_np).to(dev)
        assert X.shape == (n, L), X.shape
        S = pearson_cuda(X)
        torch.cuda.synchronize()
        err = float((S - ref.pearson_ref(X)).abs().max())
        symmetric = bool(torch.equal(S, S.T))
        hashes[f"pearson_{name}"] = hashlib.sha256(
            S.cpu().numpy().tobytes()).hexdigest()
        del S
        torch.cuda.empty_cache()
        t = ms(lambda: pearson_cuda(X), REPS)
        b = bound_ms(4 * (n * L + 2 * n + n * n), n * (n + 1) * L)
        row = dict(case=name, shape=[n, L], ms=t, bound_ms=b, share=b / t,
                   write_tb_per_s=4 * n * n / t / 1e9, max_abs_err=err,
                   symmetric=symmetric, sha256=hashes[f"pearson_{name}"])
        pearson_rows.append(row)
        print(f"[{label}] pearson {json.dumps(row)}", flush=True)
        if err > 1e-5 or not symmetric:
            bad.append(f"pearson {name}: err {err}, symmetric {symmetric}")
        del X

    flash_rows = []
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for name, (B, T, H, KV, hd), win in FLASH_CASES:
        q = torch.randn((B, T, H, hd), generator=gen, device=dev)
        k = torch.randn((B, T, KV, hd), generator=gen, device=dev)
        v = torch.randn((B, T, KV, hd), generator=gen, device=dev)
        got = flash_attention_cuda(q, k, v, causal=True, window=win)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=win)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        del got, want
        t = ms(lambda: flash_attention_cuda(q, k, v, causal=True,
                                            window=win), REPS)
        pairs = B * H * sum(min(i + 1, win) if win else i + 1
                            for i in range(T))
        b = bound_ms(4 * (2 * q.numel() + 2 * k.numel()), 4 * hd * pairs)
        row = dict(case=name, shape=[B, T, H, KV, hd], window=win, ms=t,
                   bound_ms=b, share=b / t, max_abs_err=err)
        flash_rows.append(row)
        print(f"[{label}] flash_fp32 {json.dumps(row)}", flush=True)
        if err > 1e-5:
            bad.append(f"flash {name}: err {err}")
        del q, k, v
        torch.cuda.empty_cache()

    stores = store_probe(nvcc, ms)
    for row in stores:
        print(f"[{label}] store {json.dumps(row)}", flush=True)

    # hold this run's Pearson outputs bitwise against every other run's
    path = Path(args.hashes)
    seen = json.loads(path.read_text()) if path.exists() else {}
    for other, hs in seen.items():
        if other == label:
            continue
        for case, h in hashes.items():
            if case in hs and hs[case] != h:
                bad.append(f"{case}: output differs from run {other!r}")
    seen[label] = hashes
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(seen, indent=1))

    res = dict(label=label, card=card, src=str(src), ptxas=ptxas, sass=sass,
               pearson=pearson_rows, flash_fp32=flash_rows, stores=stores,
               compared_with=sorted(o for o in seen if o != label),
               mismatches=bad)
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
