#!/usr/bin/env python3
"""Time and check the port's min-plus kernel on one GPU.

Usage, from the root of a checkout, on a machine with a CUDA device::

    python3 tools/minplus_bench.py                       # this checkout
    python3 tools/minplus_bench.py --src OTHER/src --label parent

``--src`` points at the ``src/`` directory of another checkout (for
example the parent commit unpacked with ``git archive``), so two
versions of ``csrc/minplus.cu`` can be timed in one process each on the
same card: run parent, change, change, parent.  It also builds
``tools/minplus_ceiling.cu`` (from this checkout) and reports the issue
rate of FADD alone, FMNMX alone, the FADD + FMNMX pair from registers,
and the kernel's hot loop alone (operands from shared memory, no copies,
no barriers), each as a share of 128 lanes per SM per clock.

It builds the checkout's kernels, prints the min-plus kernel's ptxas
line and its SASS counts (FMNMX, FADD, LDS.128, all LDS, LDL, STL), holds
``minplus_cuda`` bitwise against ``ref.minplus_ref`` at edge shapes and
at Crop's two APSP shapes, the hub round (h, n) x (n, n) and the hub
composition (n, h) x (h, n) (n = 19412, h = 140), and times both with
CUDA events against the bound (an add and a min per (i, k, j), two fp32
instructions at 128 lanes per SM per clock).  The last line is one JSON
object.  It exits non-zero on any mismatch or without a card.
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
CROP_N, CROP_HUBS = 19412, 140     # Crop's n and hub_count(n)
REPS = 5                           # launches per timing

# bitwise cases: every tile edge, the 4-byte copy path (k or n not a
# multiple of 4), k a multiple of the 16-deep panel, and split-k shapes
EDGE_SHAPES = [(1, 1, 1), (1, 1, 5), (1, 300, 1), (17, 33, 9),
               (130, 7, 127), (140, 300, 300), (300, 140, 300),
               (140, 4099, 4099), (2000, 140, 2003), (140, 4096, 4096),
               (145, 48, 129), (299, 299, 299), (512, 140, 4097)]


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def sass_counts(lib: str, kernel: str, nvcc: str) -> dict:
    tool = Path(nvcc).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                         text=True, timeout=300)
    counts = {}
    for fn in out.stdout.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        if kernel in name:
            counts[name] = {op: fn.count(op) for op in
                            ("FMNMX", "FADD", "LDS.128", "LDS", "LDL",
                             "STL")}
    return counts


def ceiling(nvcc: str, sms: int, issue_per_s: float) -> dict:
    """Run the probes of tools/minplus_ceiling.cu; shares of the issue
    rate (128 lanes per SM per clock at the maximum SM clock)."""
    import torch
    src = HERE / "tools" / "minplus_ceiling.cu"
    out_dir = HERE / "build" / "ceiling" / hashlib.sha256(
        src.read_bytes()).hexdigest()[:16]
    lib_path = out_dir / "libceiling.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                        "-shared", "-o", str(lib_path), str(src)],
                       check=True, timeout=600)
    fn = ctypes.CDLL(str(lib_path)).ceiling_run
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(1 << 20, device="cuda")
    res = {}
    for which, name, blocks, iters in ((0, "fadd", 8 * sms, 20000),
                                      (1, "fmnmx", 8 * sms, 10000),
                                      (2, "fadd_fmnmx", 8 * sms, 10000),
                                      (3, "hot_loop", 4 * sms, 1500)):
        th, per = ctypes.c_int(0), ctypes.c_int(0)
        args = (ctypes.byref(th), ctypes.byref(per))
        if fn(which, out.data_ptr(), blocks, 10, *args) != 0:
            sys.exit(f"minplus_bench: ceiling probe {name} failed to launch")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(which, out.data_ptr(), blocks, iters, *args)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        work = blocks * th.value * iters * per.value
        # results: one instruction each; triples: two instructions each
        instr = work * (2 if which >= 2 else 1)
        res[name] = dict(ms=ms, share=instr / (ms * 1e-3) / issue_per_s)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(HERE / "src"))
    ap.add_argument("--label", default="change")
    args = ap.parse_args()

    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        sys.exit("minplus_bench: needs a CUDA device")
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.minplus import minplus_cuda

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    sm_mhz = float(smi("clocks.max.sm"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_per_s = 128 * sms * sm_mhz * 1e6
    _build.library()
    lib = _build.BUILD_INFO["path"]
    ptxas = [ln.strip() for ln in str(_build.BUILD_INFO.get("ptxas", ""))
             .split("Compiling entry function")
             if "minplus" in ln]
    print(f"[{args.label}] {card}; {sms} SMs at {sm_mhz:.0f} MHz; {lib}",
          flush=True)
    for ln in ptxas:
        print(f"[{args.label}] ptxas: {' | '.join(ln.splitlines())}")
    sass = sass_counts(lib, "minplus", _build.nvcc_path())
    print(f"[{args.label}] sass: {sass}", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def dist(rows, cols, inf_frac=0.3):
        a = torch.rand((rows, cols), generator=gen, device=dev) * 2.0
        a.masked_fill_(torch.rand((rows, cols), generator=gen, device=dev)
                       < inf_frac, float("inf"))
        return a

    def same(a, b) -> bool:
        na, nb = torch.isnan(a), torch.isnan(b)
        return bool(torch.equal(na, nb)) and bool(torch.equal(
            torch.where(na, 0.0, a), torch.where(nb, 0.0, b)))

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

    bad = []
    for m, k, n in EDGE_SHAPES:
        A, B = dist(m, k), dist(k, n)
        A.view(-1)[::97] = float("-inf")          # -inf + inf = NaN
        A.view(-1)[3::101] = -1.25                # mixed signs
        B.view(-1)[5::89] = float("nan")
        A0, B0 = A.clone(), B.clone()
        if not (same(minplus_cuda(A, B), ref.minplus_ref(A, B))
                and torch.equal(A, A0) and same(B, B0)):
            bad.append((m, k, n))
    print(f"[{args.label}] edge shapes: {len(EDGE_SHAPES) - len(bad)} of "
          f"{len(EDGE_SHAPES)} bitwise; mismatches {bad}", flush=True)

    n, h = CROP_N, CROP_HUBS
    W, Dh = dist(n, n), dist(h, n)
    ok_round = same(minplus_cuda(Dh, W), ref.minplus_ref(Dh, W))
    round_ms = ms(lambda: minplus_cuda(Dh, W), REPS)
    del W
    DhT = Dh.T.contiguous()
    ok_comp = same(minplus_cuda(DhT, Dh), ref.minplus_ref(DhT, Dh))
    comp_ms = ms(lambda: minplus_cuda(DhT, Dh), REPS)
    bound_ms = 2.0 * h * n * n / issue_per_s * 1e3
    res = dict(label=args.label, card=card, sms=sms, max_sm_mhz=sm_mhz,
               round_shape=[h, n, n], round_ms=round_ms,
               round_bitwise=ok_round, compose_shape=[n, h, n],
               compose_ms=comp_ms, compose_bitwise=ok_comp,
               bound_ms=bound_ms, round_share=bound_ms / round_ms,
               compose_share=bound_ms / comp_ms, edge_mismatches=bad,
               sass=sass)
    res["ceiling"] = ceiling(_build.nvcc_path(), sms, issue_per_s)
    print(json.dumps(res), flush=True)
    if bad or not (ok_round and ok_comp):
        sys.exit(1)


if __name__ == "__main__":
    main()
