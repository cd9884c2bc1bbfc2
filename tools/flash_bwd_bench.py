#!/usr/bin/env python3
"""Check and time the bf16 flash-attention backward kernels on one GPU.

Usage, from the root of a checkout, on a machine with a CUDA device::

    python3 tools/flash_bwd_bench.py               # checks, then the A/B
    python3 tools/flash_bwd_bench.py --check-only  # checks alone
    python3 tools/flash_bwd_bench.py --src OTHER/src --label parent
    python3 tools/flash_bwd_bench.py --cases gemma3   # only those A/B cases

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

It prints the ptxas lines of the new kernels, the count of HGMMA,
UTMALDG, LDL and STL in their SASS, the card's name and power limit,
and as the last line one JSON object.  It exits non-zero on any failed
check, on a spill, or without a card.
"""

from __future__ import annotations

import argparse
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
BF16_PEAK = 989e12
HBM = 3.35e12
KERNELS = ("flash_bwd_wgmma_dq_kernel", "flash_bwd_wgmma_dkdv_kernel",
           "flash_bwd_wide_dq_kernel", "flash_bwd_wide_dkdv_kernel")
# each route's launches, as ops.launch_counts() names them
ROUTE_LAUNCHES = {
    "wgmma": ("flash_attention_bwd_wgmma_dq", "flash_attention_bwd_wgmma_dkdv"),
    "wgmma_wide": ("flash_attention_bwd_wide_dq",
                   "flash_attention_bwd_wide_dkdv"),
    "cuda_core": ("flash_attention_bwd_rows", "flash_attention_bwd_dkdv",
                  "flash_attention_bwd_dq"),
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


def sass(lib: str) -> dict:
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                         text=True, timeout=300)
    if out.returncode:
        fail(f"cuobjdump: {out.stderr.strip()}")
    counts = {}
    for fn in out.stdout.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        if any(k in name for k in KERNELS + ("flash_wgmma_kernel",)):
            counts[name] = {op: fn.count(op)
                            for op in ("HGMMA", "UTMALDG", "LDL", "STL")}
    return counts


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--src", default=str(HERE / "src"),
                    help="the src/ directory whose kernels are run")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--cases", default="",
                    help="run only the A/B cases whose label holds this")
    args = ap.parse_args()
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
    _build.library()
    log(f"[build] {_build.BUILD_INFO['seconds']:.2f} s "
        f"(cached={_build.BUILD_INFO['cached']})")
    # the ptxas lines of the files that hold the new kernels
    ptx = str(_build.BUILD_INFO.get("ptxas", ""))
    keep = False
    for line in ptx.splitlines():
        if "Compiling entry function" in line:
            keep = any(k in line for k in KERNELS) \
                or "flash_wgmma_kernel" in line
        if keep:
            log(f"[ptxas] {line.strip()}")
    counts = sass(_build.BUILD_INFO["path"])
    log(f"[sass] {json.dumps(counts)}")
    spills = [n for n, c in counts.items() if c["LDL"] or c["STL"]]
    if not all(counts.get(n) for n in counts) or any(
            c["HGMMA"] == 0 or c["UTMALDG"] == 0 for c in counts.values()):
        fail(f"a kernel lacks HGMMA or UTMALDG: {counts}")
    if spills:
        fail(f"local memory (spills) in {spills}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    sync = torch.cuda.synchronize
    out = {"label": args.label, "src": args.src, "checks": [], "ab": [],
           "device": smi}

    def inputs(B, T, H, KV, hd):
        return [torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
                for s in ((B, T, H, hd), (B, T, KV, hd), (B, T, KV, hd),
                          (B, T, H, hd))]

    for B, T, H, KV, hd, causal, win in CHECK_CASES:
        q, k, v, do = inputs(B, T, H, KV, hd)
        kw = dict(causal=causal, window=win)
        route = fa.bwd_route(torch.bfloat16, hd)
        o_plain = fa.flash_attention_cuda(q, k, v, **kw)
        o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        want_lse = plain_lse(q, k, causal, win)
        sync()
        if not torch.equal(o, o_plain):
            fail(f"o differs with the lse output at {(B, T, H, KV, hd)}")
        got_lse = lse[..., :T]
        fin = torch.isfinite(want_lse)
        lse_err = float(((got_lse - want_lse).abs()
                         / want_lse.abs().clamp_min(1))[fin].max())
        if lse_err > 1e-5 or not bool(torch.isinf(got_lse[~fin]).all()) \
                or not bool(torch.isinf(lse[..., T:]).all()):
            fail(f"lse at {(B, T, H, KV, hd)}: {lse_err}")
        ops.reset_launch_counts()
        # an older checkout's hd 256 route takes no lse
        got = fa.flash_attention_bwd_cuda(
            q, k, v, o, do, lse=None if route == "cuda_core" else lse, **kw)
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
        if not (same and max(rel) <= 2.0 ** -7 and min(cos) >= 0.9999):
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
        route = fa.bwd_route(torch.bfloat16, hd)
        o, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        new, l_new = fa.bwd_launches(
            q, k, v, o, do, lse=None if route == "cuda_core" else lse, **kw)
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
               cuda_ms(lambda: fa.flash_attention_cuda(
                   q, k, v, return_lse=True, **kw), 20)]
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
        nbytes = 2 * (4 * B * T * H * hd + 4 * B * T * KV * hd)
        bound_ms = max(10 * hd * pairs / BF16_PEAK, nbytes / HBM) * 1e3
        row = dict(case=label, shape=[B, T, H, KV, hd], window=win,
                   causal=causal, route=route, old_ms=t_old, new_ms=t_new,
                   new_launch_ms=per, bound_ms=bound_ms, plain_ms=plain_ms,
                   sdpa_ms=lib_ms, fwd_ms=fwd[0], fwd_lse_ms=fwd[1],
                   max_rel_err=rel, cosine=cos, old_max_rel_err=rel_old,
                   sdpa_max_rel_err=rel_sdpa, sdpa_cosine=cos_sdpa)
        log(f"[ab] {args.label}: {json.dumps(row)}")
        out["ab"].append(row)
        del q, k, v, do, o, lse, new, old, l_new, l_old
        torch.cuda.empty_cache()
    log(smi)
    log(json.dumps(out))


if __name__ == "__main__":
    main()
