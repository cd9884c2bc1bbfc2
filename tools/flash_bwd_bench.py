#!/usr/bin/env python3
"""Check and time the flash-attention backward kernels on one GPU.

Usage, from the root of a checkout, on a machine with a CUDA device::

    python3 tools/flash_bwd_bench.py               # checks, then the A/B
    python3 tools/flash_bwd_bench.py --check-only  # checks alone
    python3 tools/flash_bwd_bench.py --src OTHER/src --label parent
    python3 tools/flash_bwd_bench.py --cases gemma3   # only those A/B cases
    python3 tools/flash_bwd_bench.py --dtype float32  # the fp32 routes
    python3 tools/flash_bwd_bench.py --probe   # mma.sync TF32's issue rate

``--src`` points at the ``src/`` directory of another checkout (for
example the parent commit unpacked with ``git archive``), so two
versions of the kernels can be timed in one process each on the same
card: run parent, change, change, parent.

Checks, each against the plain version on the same inputs: the bf16
forward's ``o`` bitwise the same with and without the lse output, the
saved lse within 1e-5 * max(1, |lse|) of ``torch.logsumexp`` of the
plain masked scores (+inf on rows with no live key), and the bf16
backward of the checkout's route (``bwd_route``: up to hd 128
``csrc/flash_attention_bwd_wgmma.cu``, above it
``csrc/flash_attention_bwd_wgmma_wide.cu``, each with the saved lse and
without it) within 2^-7 of each gradient's largest magnitude of
``ref.flash_attention_bwd_ref`` with cosine >= 0.9999, a second run
bitwise the first, at ragged, windowed, bidirectional and GQA shapes,
at granite-3-8b's heads (1, 512, 32, 8, 128) and at hd 136 to 256.

The A/B times, in the order old, new, new, old, the CUDA-core
backward (``csrc/flash_attention_bwd.cu``, forced onto bf16) and the
checkout's bf16 route at the bf16 shapes of phase 13a of
``chip_smoke.py`` (gemma3-4b's local and global layers at hd 256
among them), beside the bound (10 hd flops per unmasked pair
and head at the 989 TFLOP/s bf16 peak, or q, k, v, o, dO read and dQ,
dK, dV written once at 3.35 TB/s), the plain backward and SDPA's
backward, with SDPA's own error against the plain backward given
SDPA's output (a rounding witness); and the bf16 forward with and
without the lse output.  Times are CUDA events over repeated launches.

With ``--dtype float32`` the same checks and A/B run in fp32: the fp32
forward's ``o`` bitwise with and without its lse output, that lse
against ``torch.logsumexp``, the fp32 backward of the checkout's route
(``csrc/flash_attention_bwd_tf32x3.cu``, split TF32 on the tensor
cores; a checkout before it has the CUDA-core one) within 1e-5 of each
gradient's largest magnitude of the plain backward, bitwise repeatable;
the A/B of the CUDA-core backward (old) against that route (new) at the
fp32 shapes of phase 13a beside both bounds (3 TF32 products of 10 hd
flops a pair at 495 TFLOP/s, and 10 hd flops at the 67 TFLOP/s fp32
FMA peak), the plain backward and SDPA's fp32 backward
(``allow_tf32`` off), the fp32 forward with and without the lse; and
the fp32 forward above hd 128 (``flash_kernel_wide``) beside SDPA's
fp32 forward at FWD_WIDE_CASES.  ``--probe`` runs ``tools/tf32_mma_probe.cu``
alone: the rate of mma.sync TF32 products from registers at 8 and 16
warps an SM, the ceiling of the fp32 route, against 495 TFLOP/s.

It prints the ptxas lines of the new kernels, the count of HGMMA,
UTMALDG (bf16) or TF32 HMMA (fp32), LDL and STL in their SASS, the
card's name and power limit, and as the last line one JSON object.  It
exits non-zero on any failed check, on a spill, or without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

CHECK_CASES = [  # (B, T, H, KV, hd, causal, window)
    (1, 200, 8, 2, 64, True, 70),
    (2, 130, 4, 4, 80, False, 0),
    (1, 100, 6, 2, 128, True, 30),
    (1, 333, 4, 1, 128, True, 0),
    (1, 257, 6, 3, 40, False, 0),
    (1, 512, 32, 8, 128, True, 0),
    (1, 333, 8, 4, 256, True, 0),
    (2, 200, 4, 1, 136, True, 0),
    (1, 256, 8, 4, 256, True, 2),
    (2, 130, 4, 4, 200, False, 0),
    (1, 300, 8, 2, 192, True, 64),
]
AB_CASES = [
    ("granite-3-8b causal", (1, 4096, 32, 8, 128), 0, True),
    ("gemma3-4b local", (1, 4096, 8, 4, 256), 1024, True),
    ("gemma3-4b global", (1, 4096, 8, 4, 256), 0, True),
    ("zamba2-2.7b shared block", (1, 2048, 32, 32, 80), 4096, True),
    ("seamless-m4t encoder", (1, 1024, 16, 16, 64), 0, False),
]
# the fp32 forward above hd 128 beside SDPA's fp32 forward: PERF.md's
# fp32 row at hd 256, and gemma3-4b's local and global layers
FWD_WIDE_CASES = [
    ("hd 256 window 64", (1, 1024, 8, 4, 256), 64, True),
    ("gemma3-4b local", (1, 4096, 8, 4, 256), 1024, True),
    ("gemma3-4b global", (1, 4096, 8, 4, 256), 0, True),
]
BF16_PEAK = 989e12
TF32_PEAK = 495e12
FP32_PEAK = 67e12
HBM = 3.35e12
KERNELS = ("flash_bwd_wgmma_dq_kernel", "flash_bwd_wgmma_dkdv_kernel",
           "flash_bwd_wide_dq_kernel", "flash_bwd_wide_dkdv_kernel")
FP32_KERNELS = ("flash_bwd_tf32x3_dq_kernel", "flash_bwd_tf32x3_dkdv_kernel",
                "flash_kernel")
# each route's launches, as ops.launch_counts() names them
ROUTE_LAUNCHES = {
    "wgmma": ("flash_attention_bwd_wgmma_dq", "flash_attention_bwd_wgmma_dkdv"),
    "wgmma_wide": ("flash_attention_bwd_wide_dq",
                   "flash_attention_bwd_wide_dkdv"),
    "cuda_core": ("flash_attention_bwd_rows", "flash_attention_bwd_dkdv",
                  "flash_attention_bwd_dq"),
    "tf32x3": ("flash_attention_bwd_tf32x3_dq",
               "flash_attention_bwd_tf32x3_dkdv"),
}


def fail(msg):
    print(f"flash_bwd_bench: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(*parts):
    print(*parts, flush=True)


def cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def gates(got, want):
    """(max |g - w| / max |w| per gradient, cosine per gradient)."""
    rel, cos = [], []
    for g, w in zip(got, want):
        rel.append(float((g.float() - w.float()).abs().max())
                   / float(w.float().abs().max()))
        cos.append(cosine(g, w))
    return rel, cos


def plain_lse(q, k, causal, window):
    """torch.logsumexp of the plain masked scaled scores, (B, H, Tq),
    -inf on rows with no live key."""
    import torch
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    qh = q.reshape(B, Tq, KV, H // KV, hd).float() / math.sqrt(hd)
    s = torch.einsum("bqKgh,bsKh->bKgqs", qh, k.float())
    ti = torch.arange(Tq, device=q.device)[:, None]
    tj = torch.arange(Tk, device=q.device)[None, :]
    live = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        live &= tj <= ti
    if window > 0:
        live &= ti - tj < window
    s = torch.where(live, s, float("-inf"))
    return torch.logsumexp(s, -1).reshape(B, H, Tq)


def sass(lib: str, kernels) -> dict:
    """Per instance of each kernel: HGMMA, UTMALDG, TF32 HMMA (lines
    holding both HMMA and TF32), LDL and STL in its SASS."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                         text=True, timeout=300)
    if out.returncode:
        fail(f"cuobjdump: {out.stderr.strip()}")
    counts = {}
    for fn in out.stdout.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        if any(k in name for k in kernels):
            counts[name] = {op: fn.count(op)
                            for op in ("HGMMA", "UTMALDG", "LDL", "STL")}
            counts[name]["HMMA_TF32"] = sum(
                "HMMA" in ln and "TF32" in ln for ln in fn.splitlines())
    return counts


def probe(nvcc: str, sms: int) -> dict:
    """tools/tf32_mma_probe.cu at 1 and 2 blocks of 8 warps an SM: TF32
    TFLOP/s of mma.sync products from registers, and their share of
    TF32_PEAK."""
    import torch
    src = HERE / "tools" / "tf32_mma_probe.cu"
    out_dir = HERE / "build" / "probe" / hashlib.sha256(
        src.read_bytes()).hexdigest()[:16]
    lib_path = out_dir / "libprobe.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-shared", "-o", str(lib_path), str(src)],
                       check=True, timeout=600)
    fn = ctypes.CDLL(str(lib_path)).probe_run
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(4 * sms * 256, device="cuda")
    res = {}
    for per_sm, iters in ((1, 20000), (2, 20000)):
        n = ctypes.c_int(0)
        blocks = per_sm * sms
        if fn(out.data_ptr(), blocks, 10, ctypes.byref(n)) != 0:
            fail("the mma.sync probe failed to launch")
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(out.data_ptr(), blocks, iters, ctypes.byref(n))
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b)
        flops = blocks * 8 * iters * n.value * 2 * 16 * 8 * 8
        res[f"{8 * per_sm}_warps_per_sm"] = dict(
            ms=ms, tflops=flops / (ms * 1e-3) / 1e12,
            share_of_tf32_peak=flops / (ms * 1e-3) / TF32_PEAK)
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--src", default=str(HERE / "src"),
                    help="the src/ directory whose kernels are run")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--cases", default="",
                    help="run only the A/B cases whose label holds this")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--probe", action="store_true",
                    help="time tools/tf32_mma_probe.cu alone")
    args = ap.parse_args()
    fp32 = args.dtype == "float32"
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    log(f"[env] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    if args.probe:
        res = probe(_build.nvcc_path(),
                    torch.cuda.get_device_properties(0).multi_processor_count)
        log(f"[probe] {json.dumps(res)}")
        log(smi)
        log(json.dumps({"probe": res, "device": smi}))
        return
    _build.library()
    log(f"[build] {_build.BUILD_INFO['seconds']:.2f} s "
        f"(cached={_build.BUILD_INFO['cached']})")
    # the ptxas lines of the files that hold the new kernels
    ptx = str(_build.BUILD_INFO.get("ptxas", ""))
    names = FP32_KERNELS if fp32 else KERNELS + ("flash_wgmma_kernel",)
    keep = False
    for line in ptx.splitlines():
        if "Compiling entry function" in line:
            keep = any(k in line for k in names)
        if keep:
            log(f"[ptxas] {line.strip()}")
    counts = sass(_build.BUILD_INFO["path"], names)
    log(f"[sass] {json.dumps(counts)}")
    spills = [n for n, c in counts.items() if c["LDL"] or c["STL"]]
    if fp32:
        bwd = {n: c for n, c in counts.items() if "tf32x3" in n}
        if fa.bwd_route(torch.float32, 128) == "tf32x3" and (
                len(bwd) != 11 or any(c["HMMA_TF32"] == 0
                                     for c in bwd.values())):
            fail(f"a tf32x3 kernel lacks TF32 HMMA: {bwd}")
    elif any(c["HGMMA"] == 0 or c["UTMALDG"] == 0 for c in counts.values()):
        fail(f"a kernel lacks HGMMA or UTMALDG: {counts}")
    if spills:
        fail(f"local memory (spills) in {spills}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    sync = torch.cuda.synchronize
    out = {"label": args.label, "src": args.src, "dtype": args.dtype,
           "checks": [], "ab": [], "device": smi}
    dt = getattr(torch, args.dtype)
    # SDPA's fp32 yardstick in full fp32 (these are the defaults, set so)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gate = 1e-5 if fp32 else 2.0 ** -7

    def inputs(B, T, H, KV, hd):
        return [torch.randn(s, generator=gen, device=dev).to(dt)
                for s in ((B, T, H, hd), (B, T, KV, hd), (B, T, KV, hd),
                          (B, T, H, hd))]

    def forward(q, k, v, route, **kw):
        """(o, lse): the lse None where the checkout's fp32 route is the
        CUDA-core backward, whose forward saves none."""
        if route == "cuda_core":
            return fa.flash_attention_cuda(q, k, v, **kw), None
        return fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)

    for B, T, H, KV, hd, causal, win in CHECK_CASES:
        q, k, v, do = inputs(B, T, H, KV, hd)
        kw = dict(causal=causal, window=win)
        route = fa.bwd_route(dt, hd)
        o_plain = fa.flash_attention_cuda(q, k, v, **kw)
        o, lse = forward(q, k, v, route, **kw)
        want_lse = plain_lse(q, k, causal, win)
        sync()
        if not torch.equal(o, o_plain):
            fail(f"o differs with the lse output at {(B, T, H, KV, hd)}")
        lse_err = None
        if lse is not None:
            got_lse = lse[..., :T]
            fin = torch.isfinite(want_lse)
            lse_err = float(((got_lse - want_lse).abs()
                             / want_lse.abs().clamp_min(1))[fin].max())
            if lse_err > 1e-5 or not bool(
                    torch.isinf(got_lse[~fin]).all()) \
                    or not bool(torch.isinf(lse[..., T:]).all()):
                fail(f"lse at {(B, T, H, KV, hd)}: {lse_err}")
        ops.reset_launch_counts()
        got = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse=lse, **kw)
        c1 = ops.launch_counts()
        again = fa.flash_attention_bwd_cuda(q, k, v, o, do, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o, do, **kw)
        sync()
        rel, cos = gates(got, want)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        row = dict(shape=[B, T, H, KV, hd], causal=causal, window=win,
                   route=route, lse_rel_err=lse_err, max_rel_err=rel,
                   cosine=cos,
                   bitwise_repeat=same,
                   launches={n: c for n, c in c1.items() if c})
        log(f"[check] {json.dumps(row)}")
        out["checks"].append(row)
        if not (same and max(rel) <= gate and min(cos) >= 0.9999):
            fail(f"backward at {(B, T, H, KV, hd, causal, win)}: {row}")
        want_c = ROUTE_LAUNCHES[route]
        if any(c1.get(n) != 1 for n in want_c) or \
                sum(c1.values()) != len(want_c):
            fail(f"launches {c1}")
    if args.check_only:
        log(json.dumps(out))
        return

    def cuda_ms(fn, reps):
        fn()
        sync()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        sync()
        return a.elapsed_time(b) / reps

    def run_all(launches):
        return lambda: [launch() for _, launch in launches]

    for label, (B, T, H, KV, hd), win, causal in AB_CASES:
        if args.cases not in label:
            continue
        q, k, v, do = inputs(B, T, H, KV, hd)
        kw = dict(causal=causal, window=win)
        route = fa.bwd_route(dt, hd)
        o, lse = forward(q, k, v, route, **kw)
        new, l_new = fa.bwd_launches(q, k, v, o, do, lse=lse, **kw)
        old, l_old = fa.bwd_launches(q, k, v, o, do, route="cuda_core", **kw)
        reps = 5 if T >= 4096 else 10
        t_old = [cuda_ms(run_all(l_old), reps)]
        t_new = [cuda_ms(run_all(l_new), reps), cuda_ms(run_all(l_new), reps)]
        t_old.append(cuda_ms(run_all(l_old), reps))
        per = {n: cuda_ms(f, reps) for n, f in l_new}
        want = ref.flash_attention_bwd_ref(q, k, v, o, do, **kw)
        rel, cos = gates(new, want)
        rel_old, cos_old = gates(old, want)
        plain_ms = cuda_ms(lambda: ref.flash_attention_bwd_ref(
            q, k, v, o, do, **kw), 2)
        del want
        fwd = [cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw), 20),
               cuda_ms(lambda: forward(q, k, v, route, **kw), 20)]
        # SDPA's backward, its forward excluded, and its error against the
        # plain backward given SDPA's own output
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        mask = None
        if win and win < T:
            ti = torch.arange(T, device=dev)
            mask = (ti[:, None] - ti[None, :] < win) & \
                (ti[:, None] >= ti[None, :])
        ot = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
        dot = do.transpose(1, 2)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), reps)
        g_sdpa = [g.transpose(1, 2) for g in torch.autograd.grad(
            ot, (qt, kt, vt), dot)]
        o_sdpa = ot.detach().transpose(1, 2).contiguous()
        w_sdpa = ref.flash_attention_bwd_ref(q, k, v, o_sdpa, do, **kw)
        rel_sdpa, cos_sdpa = gates(g_sdpa, w_sdpa)
        del ot, qt, kt, vt, g_sdpa, w_sdpa, mask
        pairs = B * H * (sum(min(t + 1, win) if win > 0 else t + 1
                             for t in range(T)) if causal else T * T)
        nbytes = q.element_size() * (4 * B * T * H * hd + 4 * B * T * KV * hd)
        if fp32:
            bounds = dict(
                bound_ms=max(3 * 10 * hd * pairs / TF32_PEAK,
                             nbytes / HBM) * 1e3,
                fma_bound_ms=max(10 * hd * pairs / FP32_PEAK,
                                 nbytes / HBM) * 1e3)
        else:
            bounds = dict(bound_ms=max(10 * hd * pairs / BF16_PEAK,
                                       nbytes / HBM) * 1e3)
        row = dict(case=label, shape=[B, T, H, KV, hd], window=win,
                   causal=causal, dtype=args.dtype, route=route,
                   old_ms=t_old, new_ms=t_new, new_launch_ms=per,
                   **bounds, plain_ms=plain_ms,
                   sdpa_ms=lib_ms, fwd_ms=fwd[0], fwd_lse_ms=fwd[1],
                   max_rel_err=rel, cosine=cos, old_max_rel_err=rel_old,
                   sdpa_max_rel_err=rel_sdpa, sdpa_cosine=cos_sdpa)
        log(f"[ab] {args.label}: {json.dumps(row)}")
        out["ab"].append(row)
        del q, k, v, do, o, lse, new, old, l_new, l_old
        torch.cuda.empty_cache()
    if fp32:
        out["fwd_wide"] = fwd_wide(args, fa, cuda_ms, inputs, forward)
    log(smi)
    log(json.dumps(out))


def fwd_wide(args, fa, cuda_ms, inputs, forward) -> list:
    """The fp32 forward above hd 128 (``flash_kernel_wide``), with and
    without the lse, beside SDPA's fp32 forward (a boolean window mask
    built outside the timed call) at FWD_WIDE_CASES."""
    import torch
    import torch.nn.functional as F
    rows = []
    for label, (B, T, H, KV, hd), win, causal in FWD_WIDE_CASES:
        if args.cases not in label:
            continue
        q, k, v, _ = inputs(B, T, H, KV, hd)
        kw = dict(causal=causal, window=win)
        route = fa.bwd_route(q.dtype, hd)
        ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw), 20)
        lse_ms = cuda_ms(lambda: forward(q, k, v, route, **kw), 20)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if win and win < T:
            ti = torch.arange(T, device=q.device)
            mask = (ti[:, None] - ti[None, :] < win) & \
                (ti[:, None] >= ti[None, :])
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True), 20)
        pairs = B * H * sum(min(t + 1, win) if win > 0 else t + 1
                            for t in range(T))
        nbytes = 4 * (2 * B * T * H * hd + 2 * B * T * KV * hd)
        row = dict(case=label, shape=[B, T, H, KV, hd], window=win,
                   causal=causal, fwd_ms=ms, fwd_lse_ms=lse_ms,
                   sdpa_ms=sdpa_ms,
                   bound_ms=max(4 * hd * pairs / FP32_PEAK,
                                nbytes / HBM) * 1e3)
        log(f"[fwd_wide] {args.label}: {json.dumps(row)}")
        rows.append(row)
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
