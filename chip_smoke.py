#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Usage, from the root of a checkout, on a machine with one NVIDIA GPU::

    python3 chip_smoke.py                  # the main paths at Crop size
    python3 chip_smoke.py --dataset CBF    # a smaller Table-1 size

Phases (any failure exits non-zero; no phase is skipped):

1. Environment: the card's name and power limit, its SM count and
   maximum SM clock (the min-plus bound counts an add and a min per
   (i, k, j) as two fp32 instructions at 128 lanes per SM per clock),
   torch and CUDA versions, and the build of every kernel from
   ``kernels/csrc/``.
2. Kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the shapes the main paths give it (Pearson at (n, L), and at
   a ragged n (n % 4 != 0) bitwise symmetric; the
   hub Bellman-Ford round (h, n) x (n, n) and the hub composition
   (n, h) x (h, n) for min-plus, min-plus with NaN and -inf inputs, at
   an odd n (rows not 16-byte aligned: the kernel's 4-byte copy path)
   and at split-k shapes whose k is and is not a multiple of the
   32-deep panel, with the count of FMNMX, FADD, LDS.128, all LDS, LDL
   and STL in the SASS of both instances of the min-plus kernel, no
   spill and FMNMX and LDS.128 in each; the
   (n, n) HAC scan for masked argmax; top-K at (n, L, 64) and at a
   small n with k = n-1, bitwise a stable top-k of the Pearson kernel's
   rows; one sparse relaxation round and its fixed point from h sources
   over two graphs of 3n-6 edges, a path plus random chords and a random
   Apollonian network (a TMFG's degree shape, the hubs by strength), NaN
   entries included, the round timed on each; no LDL or STL in the SASS
   of the Pearson, top-K, relaxation and fp32 flash kernels; flash
   attention in bf16, the wgmma kernel, at granite-3-8b's prefill shape,
   gemma3-4b's local layer and the serving zoo's prefills (zamba2-2.7b's
   shared block at hd 80 and window 4096, seamless-m4t's encoder
   non-causal at hd 64, deepseek-moe-16b's MHA and qwen2-vl-72b's GQA
   64/8), and in fp32, the CUDA-core kernel, at an
   MQA shape with ragged T and at the fp32 prefill path's shape
   (granite-3-8b, 1024 tokens), the bf16 cases under ``bf16_gate``'s
   three gates and those without a window shorter than T
   also in the serve path's form, q scaled in bf16 and scale 1;
   SDPA beside each, the window as a boolean mask), with times from
   CUDA events; the count of HGMMA and UTMALDG instructions in the SASS
   of every instance of the wgmma kernel (``cuobjdump -sass``), none of
   them 0.
3. Serve path: granite-3-8b at full width and depth in bf16, its weights
   drawn on the card from a seeded ``torch.Generator``; a ``ServeEngine``
   with 4 slots serves 8 requests (prompts of 128, 512, 2048 and 4096
   tokens, two each, 16 new tokens each), counts reset just before and
   read just after: one launch of the bf16 (wgmma) flash kernel per
   layer per prefill and no other kernel, every request done with 16
   tokens below the vocabulary, each first token the argmax of its
   prefill's logits, all logits finite; then the 4096-token prompt's
   logits with ``backend="cuda"`` against ``backend="torch"`` (cosine of
   the last position >= 0.999).  Then the fp32 prefill path: the same
   model at full width in fp32, cut to 2 layers, prefills a 1024-token
   prompt, counts reset just before and read just after: one fp32 flash
   launch per layer and no other kernel, logits within 1e-3 of
   ``backend="torch"``.
4. Dense main path: ``cluster(X, k, config=PipelineConfig.opt())`` on
   the dataset (``make_ucr_like`` from a seed), once as the default
   back-to-back run, with every kernel's launch count reset just before
   and read just after, then ``fused=False`` for per-stage seconds and
   the lazy TMFG's microseconds per pop (at CBF size, with its own
   default run, where a repeat at the dataset's size would take the
   script past 600 s); the two linkages must be bitwise equal, and every
   TMFG build makes at most ceil(pops / T) + 3 host syncs (T the lazy
   steps per CUDA-graph replay, ``STEPS_PER_SYNC``).
5. Approx path: ``cluster(X, k, config=PipelineConfig.approx(sim_k=64))``
   fused, counts reset just before and read just after: one top-K
   launch, one sparse-relaxation launch per Bellman-Ford round, masked
   argmax in the per-cluster HAC, no slot overflow, the call evicting
   phase 4's cached dense program, peak device memory below one (n, n)
   float32 matrix (beside that program until its eviction, and after
   it), k labels, a monotone finite
   linkage, ARI against the generator and the dense labels; then
   ``fused=False`` for per-stage seconds, counts and microseconds per
   pop, and whether its linkage equals the fused one (at CBF size, with
   its own fused run, where a repeat at the dataset's size would take
   the script past 600 s); the same host-sync cap as phase 4.
6. Parity at n = 2000: the ``cuda`` and ``torch`` backends give a
   bitwise-equal linkage on one S (OPT, HEAP with its exact squarings,
   and approx), agreeing labels (ARI >= 0.99) from one X, and at
   sim_k = n-1 the sparse TMFG from X is bitwise the dense OPT TMFG.
7. TMFG loops at n = 2000: for the dense source with the top-64 table,
   without it, and the table-first source from Z, the cached loop
   program (the main path's: ``dense_program``, ``sparse_lazy_tmfg``)
   on one input, then replayed on a second input bitwise the same step
   run eagerly (``lazy_build``) and building nothing, then replayed on
   the first input bitwise its first run, each within the host-sync
   cap; CORR and PAR-10 through
   ``cluster()`` on the ``cuda`` backend bitwise the ``torch`` backend
   (the masked-argmax kernel in every CORR step and ORIG round against
   ``masked_argmax_ref``), counts reset just before and read just after
   each ``cuda`` run.
8. Sparse tail and batch: (a) at full width, the staged sparse tail
   (``apsp_method="sparse"``) on phase 4's Crop TMFG and a fresh S,
   through ``cluster(S=..., reuse_tmfg=..., fused=False)``, counts reset
   just before and read just after: one sparse-relaxation launch per
   Bellman-Ford round, at least ceil(n / 512) min-plus launches, masked
   argmax in the per-cluster HAC; the device memory the tail allocates
   above S and the TMFG below one (n, n) float32 matrix (from n = 4096
   up, as in phase 5); k labels and a monotone finite linkage; the
   fused tail on the same TMFG and edge weights with the same labels
   and the same merges (rows of equal height may sit in another order);
   the ARI against phase 4's labels logged.  (b) at n = 2000 (at CBF's
   n where the projected finish passes 600 s): fused against staged
   from X; the host oracle (``dbht_impl="host"``) against the staged
   sparse tail, labels bitwise and the same merges (rows of equal
   height in two clusters may sit in another order, as in the
   reference); ``approx(apsp_method="sparse")`` fused against staged,
   the staged run's peak and the sparse tail's own logged; approx with
   ``method="corr"`` fused against staged (the non-lazy repair); the
   tree mode above hac_max = 64 as a full dendrogram; ``cluster_batch``
   on 4 series sets, each entry bitwise ``cluster(X[b])`` on OPT, and
   on the sparse config with ``limit=2`` (2 results; the other two
   entries run as pads); on one S, the staged sparse tail, the host
   oracle, the approx CORR run and the tree mode through the ``cuda``
   backend bitwise the ``torch`` backend (the torch runs of a lazy-TMFG
   config take the cuda run's TMFG: that builder launches no kernel).
   The phase's seconds are logged.

9. Filters and sketch pools: (a) at full width on phase 4's X,
   ``cluster`` with ``PipelineConfig.mst(clean="rmt")`` and with
   ``filter="ag"``, fused, counts reset just before and read just after
   each: exactly n - 1 (a spanning tree, by a host union-find) or 3n - 6
   distinct canonical edges, the AG's m-th weight at or above every
   unpicked upper-triangle entry (one device count), one Pearson launch,
   n - 1 masked-argmax launches and one relaxation launch per
   Bellman-Ford round; k labels and a monotone finite linkage; the
   stage seconds (the eigh's as "clean"), the peak bytes and the ARI
   logged; then ``candidate_pools(X, 256, dim=64)`` (one top-K launch)
   and ``rescore_pools(X, pools, 64)``, the rescored table's index recall
   against the exact top-64 table logged, and the top-K kernel timed at
   the sketch's shape.  (b) at n = 2000 (at CBF's n where the projected
   finish passes 600 s): fused against staged from X, bitwise, for mst
   and ag with and without RMT and the TMFG with RMT; on one S the
   ``cuda`` backend bitwise the ``torch`` backend for each filter under
   each APSP method; ``cluster_batch`` on 4 series sets with mst and ag,
   each entry bitwise ``cluster(X[b])``; ``candidate_pools`` on the card
   a stable top-k of the Pearson kernel's rows of its sketch and sharing
   at least 99.9% of its candidates with the same call on the CPU (one
   seed's R comes from a CPU generator; the two sketches round otherwise
   in the last bits); ``compare_to_dense`` logged.  PMFG needs networkx,
   which the GPU machine lacks, and is held on the CPU only.  The
   phase's seconds are logged.

10. Streaming tier: ``ClusterService(n=1000, window=512, k=4,
   config=PipelineConfig.opt(), recluster_every=16)`` (the paper-sized
   window of ``benchmarks/bench_stream.py``; at n = 400, its service
   scenario's n, where the projected finish passes 600 s) on ticks from
   ``make_dataset``: the window filled and reclustered, one warm-up
   cadence, then 96 ticks (6 reclusters) in which no loop program is
   built and the watchdog stays silent; microseconds per tick (and of
   the push alone), milliseconds per recluster, warm hits, cache hits;
   ``window_similarity`` within 1e-5 of the Pearson kernel on the
   materialized window; the fused ``cluster(moments=state)`` bitwise
   ``cluster(S=window_similarity(state))``; a replayed
   ``run_pipeline_device`` building nothing and ``clear_compiled()``
   lowering ``torch.cuda.memory_allocated()``; an admission service at
   n = 256 whose ``cluster_batch`` fails twice (an injected clock): the
   breaker opens, the degraded lane answers with labels, ``healthz()``
   says so, and after the cooldown one probe closes it; ``profile()``
   writing a non-empty trace file; and a replayed fused ``cluster()``
   with tracing off making no ``device_wait`` and no
   ``torch.cuda.synchronize`` call.  Phase 4 also logs the Crop loop
   program's bytes, its build and capture times, and the bytes the
   cache holds after the Crop calls.
11. Multi-device funnel, on a world-1 NCCL group (``data_mesh()``): (a)
   at full width, the top-K table of ``topk_pearson_sharded`` (a row
   range per rank) bitwise the single-device kernel's, a quarter-rows
   range launch bitwise those rows and timed, then ``cluster(X, k,
   config=PipelineConfig.approx(sim_k=64), mesh=mesh)``, counts reset
   just before and read just after: one top-K launch, one relaxation
   launch per Bellman-Ford round, masked argmax in the per-cluster HAC,
   no slot overflow, labels and linkage bitwise phase 5's fused run (at
   n = 2000, bitwise a single-device run there, where the projected
   finish with phases 11 and 12 passes 600 s; at world size 1 the funnel
   is the single-device program), its seconds and peak bytes logged; (b) the dense funnel (``cluster(S=,
   mesh=)``, the column-sharded lazy TMFG with its collectives inside the
   captured steps, the row-sharded hub APSP) on the Pearson kernel's S,
   bitwise phase 4's TMFG and linkage (at n = 2000, against a
   single-device run there, where the projected finish passes 600 s),
   counts reset just before and read just after, and the sharded loop's
   host syncs and microseconds per pop (a replay of the cached program
   the funnel built, which must build nothing) beside the single-device
   loop's at that n; (c) at n = 2000, ``pearson_shardmap`` within 1e-5 of the
   Pearson kernel, ``minplus_shardmap`` and ``masked_argmax_shardmap``
   bitwise the kernels, ``apsp_hub_sharded`` bitwise ``apsp_hub``,
   ``cluster_batch(mesh=)`` on 4 series sets with each entry bitwise
   ``cluster(X[b])``, and ``cluster_sequences`` and ``expert_affinity``
   equal to ``cluster()`` on the arrays they pool or transpose.
12. The serving zoo (``ZOO_MODELS``), each model in bf16 with its
   weights drawn on the card from a seeded ``torch.Generator`` and freed
   before the next, a ``ServeEngine`` over it, counts reset just before
   the engine run and read just after: exactly the bf16 flash launches
   per prefill the model's attention makes and no other kernel, every
   request done with its new tokens below the vocabulary, each first
   token the argmax of its prefill's logits, all logits finite; peak
   bytes, prefill seconds per length and ms per decode step logged.
   (a) deepseek-moe-16b at full width and depth (28 layers, 64 routed
   experts top-6 and 2 shared, about 16.7e9 parameters): 4 slots serve
   prompts of 128, 512, 2048 and 4096 tokens (the last in two dispatch
   groups), 8 new tokens each, 28 flash launches a prefill; the
   4096-token prompt with ``backend="cuda"`` against ``"torch"``: the
   last position's cosine >= 0.999 with the plain run given the kernel
   run's expert routing, and with free routing its distance from 1 at
   most MOE_FREE_FACTOR times that of two rounding witnesses (the plain
   run with its attention output moved by one bf16 ulp, and with SDPA),
   whose routing flips are logged beside the kernel's, as are the pairs
   the dispatches drop by capacity; then the same requests and weights
   through ``build_model(cfg, kv_quant=True)``: the same first tokens,
   the int8 caches at most 0.55x the bf16 caches' bytes, the first
   decode step's logits at cosine >= 0.99 of the bf16 cache's under the
   bf16 run's routing and >= KVQ_FREE_COSINE with free routing.
   (b) mixtral-8x7b at
   full width, 4 of 32 layers: a 4096-token prompt and 16 new tokens
   (the decode passes the 4096-slot window's ring).  (c) qwen2-vl-72b at
   full width, 8 of 80 layers: two requests of 256 patch embeddings and
   768 tokens, 8 new tokens each, M-RoPE, the cosine gate.  (d)
   zamba2-2.7b at full width and depth: 4 slots, prompts of 128 to 2048
   tokens, 9 shared-block flash launches (hd 80) a prefill, the cosine
   gate at 2048.  (e) xlstm-125m at full width and depth: 4 prompts of
   64 to 512 tokens and no flash launch.  (f) seamless-m4t-large-v2 at
   full width and depth: two requests of 1024 frame embeddings and 128
   tokens, 24 non-causal (the encoder) and 24 causal flash launches a
   prefill, the cosine gate.

The line before the last is the JSON object of per-kernel numbers (with
each kernel's launches on phase 11's approx and dense funnels and on
each of phase 12's engine runs); the
last line is ``{"ok": true, "device": {...}}``.  The script needs the
repository's ``src/`` beside it and a CUDA device, and exits non-zero
without printing a result when either is missing.  It imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12

# the serve phase: granite-3-8b, 4 slots, prompts of these lengths (two
# each), 16 new tokens each, caches sized for the longest prompt
SERVE_ARCH = "granite-3-8b"
SERVE_LENGTHS = (128, 512, 2048, 4096)
SERVE_NEW = 16
SERVE_SLOTS = 4
SERVE_MAX_LEN = 4112
# the fp32 prefill path: the serve model at full width, this many
# layers, one prompt of this many tokens
FP32_LAYERS = 2
FP32_TOKENS = 1024

PARITY_N = 2000

# phase 12, the serving zoo: each model in bf16, its depth (None: full),
# its prompts (one request each), new tokens per request, engine slots,
# bf16 flash launches per prefill (non-causal ones among them), the
# prompt held against backend="torch" (cos_T) and whether the int8 KV
# cache serves the same requests again
ZOO_MODELS = {
    "deepseek-moe-16b": dict(layers=None, lengths=(128, 512, 2048, 4096),
                             new=8, slots=4, flash=28, cos_T=4096,
                             kv_quant=True),
    # 46.7e9 parameters whole: full width, 4 of 32 layers; the decode
    # passes the 4096-slot window's ring
    "mixtral-8x7b": dict(layers=4, lengths=(4096,), new=16, slots=1,
                         flash=4),
    # 72e9 parameters whole: full width, 8 of 80 layers; each prompt 256
    # patch embeddings and 768 tokens
    "qwen2-vl-72b": dict(layers=8, lengths=(768, 768), new=8, slots=2,
                         flash=8, cos_T=768),
    "zamba2-2.7b": dict(layers=None, lengths=(128, 512, 1024, 2048), new=8,
                        slots=4, flash=9, cos_T=2048),
    "xlstm-125m": dict(layers=None, lengths=(64, 128, 256, 512), new=8,
                       slots=4, flash=0),
    # each prompt 1024 frame embeddings (the encoder) and 128 tokens
    "seamless-m4t-large-v2": dict(layers=None, lengths=(128, 128), new=8,
                                  slots=2, flash=48, non_causal=24,
                                  cos_T=128),
}

# The fused=False repeats run at the main dataset's size unless the
# script would then pass half its 1200 s limit: the projection adds 1.1x
# the path's fused run (the staged run's share measured at Crop), for the
# dense repeat APPROX_PER_DENSE times the dense run for the approx phase
# still to come, and PARITY_S for the n=2000 phases; past the budget the
# repeat runs at REPEAT_DATASET size, with its own fused run
REPEAT_DATASET = "CBF"
STAGED_BUDGET_S = 600.0
APPROX_PER_DENSE = 3.0
PARITY_S = 190.0
# phase 8 (the sparse tail and the batch entry points): its expected
# seconds in all, and those of its n = PARITY_N part (8b), which runs at
# REPEAT_DATASET's n where it would take the script past the budget
SPARSE_S = 90.0
SPARSE_B_S = 100.0
# phase 9 (the filters and the sketch pools): its expected seconds in all
# (two Crop runs with a full HAC each, about 15 s, the eigh about 4 s, and
# about 50 s at n = PARITY_N), and
# those of its n = PARITY_N part (9b), which runs at REPEAT_DATASET's n
# where it would take the script past the budget
FILTER_S = 90.0
FILTER_B_S = 60.0
# the sketch pools at full width: pool size and sketch width
POOL = 256
POOL_DIM = 64
# phase 10 (the streaming tier): its expected seconds in all, added to
# every projection above; the paper-sized scenario of
# benchmarks/bench_stream.py (n series, a rolling window of STREAM_W
# ticks, a recluster every STREAM_EVERY ticks, STREAM_TICKS timed ticks),
# at STREAM_N_SMALL (its service scenario's n) where the projected finish
# passes the budget; the admission service's n
STREAM_S = 45.0
STREAM_N = 1000
STREAM_N_SMALL = 400
STREAM_W = 512
STREAM_EVERY = 16
STREAM_TICKS = 96
ADMISSION_N = 256
# phase 11 (the multi-device funnel on a world-1 NCCL group): its expected
# seconds in all with the approx funnel at the dataset's size (about
# phase 5's fused run), the dense funnel at n = PARITY_N and the
# n = PARITY_N checks (163.9-179.1 s on an H100 at 700 W; 82.2-85.8 s
# with the approx funnel at n = PARITY_N), not charged to the
# projections above, so that phase 11 shrinks no earlier phase; and the
# dense funnel's expected seconds at the dataset's size beside phase 4's
# run: with the third of MESH_S that follows it, it moves the dense
# funnel to n = PARITY_N where the projected finish passes the budget
MESH_S = 175.0
MESH_DENSE_PER_DENSE = 1.3
# phase 12 (the serving zoo): its expected seconds (12.1-16.8 s on an
# H100 at 700 W, and about 4 s more for deepseek's rounding witnesses),
# charged to no earlier projection but phase 11a's: past the budget its
# approx funnel runs at n = PARITY_N against a single-device run there
ZOO_S = 30.0
# phase 12's MoE gates with free routing, beside those taken under one
# routing (the top-k flips under rounding).  The cuda-against-torch
# cosine's distance from 1 is at most MOE_FREE_FACTOR times the larger
# of the rounding witnesses' (``_rounding_witnesses``): on an H100 at
# 700 W, deepseek-moe-16b at 4096 tokens, seeds 0 and 1, the kernel's
# distance was 0.95 and 0.85 of the witnesses' larger one, and the
# witnesses flipped 27.6-33.7% of routes against the kernel's 27.1-29.7%.
# The int8 caches' first decode step with free routing is at least
# KVQ_FREE_COSINE of the bf16 cache's (0.9707-0.9996 there)
MOE_FREE_FACTOR = 2.0
KVQ_FREE_COSINE = 0.95


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of the memory and compute times."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_gate(got, want) -> tuple:
    """The bf16 flash kernel's gates against the plain output; returns
    (ok, numbers).  The kernel rounds one thing more than the plain
    version, P to bf16 (2^-9 relative per probability), and both round
    the output once, so: the largest error within one bf16 ulp of the
    largest |want| (the card tests' gate); each element within one ulp of
    its own magnitude plus 2^-5 of its (b, t, h) row's rms; and each row's
    rms error within 2^-6 of the row's rms, so an error confined to the
    late rows of small magnitude (a dropped K/V tile, a window edge off by
    one) shows."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    err = float(d.max())
    tol = min(2.0 ** (math.floor(math.log2(float(w.abs().max()))) - 7), 2e-2)
    ulp = g.abs().maximum(w.abs()).clamp_min(2.0 ** -126).log2().floor() \
        .sub(7).exp2()
    rms = w.square().mean(-1, keepdim=True).sqrt()
    elem = float((d / (ulp + 2.0 ** -5 * rms)).max())
    row = float((d.square().mean(-1, keepdim=True).sqrt()
                 / rms.clamp_min(1e-30)).max())
    ok = err <= tol and elem <= 1.0 and row <= 2.0 ** -6
    return ok, dict(max_abs_err=err, tol=tol, elem_ratio=elem,
                    row_rel_rms_err=row, row_tol=2.0 ** -6)


def causal_pairs(T: int, window: int) -> int:
    """Unmasked (query, key) pairs of one head of causal attention over T
    positions, within ``window`` keys of the query (0 = no window)."""
    return sum(min(t + 1, window) if window > 0 else t + 1
               for t in range(T))


def sass_counts(lib: str, kernel: str, opcodes) -> dict:
    """Count each opcode in the SASS of every instance of ``kernel`` in
    the built library (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    counts = {}
    for fn in out.stdout.split("Function : ")[1:]:
        name = fn.split("\n", 1)[0].strip()
        if kernel in name:
            counts[name] = {op: fn.count(op) for op in opcodes}
    return counts


def same_nan(a, b) -> bool:
    """Bitwise equal, NaN entries at the same places."""
    import torch
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, 0.0, a), torch.where(nb, 0.0, b)))


def _nbytes(tree) -> int:
    """Bytes of every tensor in a (nested) cache or parameter tree."""
    from repro_torch.serve.engine import _leaves
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _cosine(a, b) -> float:
    import torch
    return float(torch.nn.functional.cosine_similarity(
        a.double(), b.double(), dim=0))


def _recording_route(moe_mod, into: list):
    """``moe.route`` that appends each call's top-k experts to ``into``."""
    real = moe_mod.route

    def route(p, xf, cfg):
        out = real(p, xf, cfg)
        into.append(out[2])
        return out
    return route


def _replayed_route(moe_mod, recorded: list):
    """``moe.route`` whose calls take the recorded top-k experts in turn,
    their weights this call's probabilities renormalised."""
    import torch
    real, it = moe_mod.route, iter(recorded)

    def route(p, xf, cfg):
        probs, _, _ = real(p, xf, cfg)
        topi = next(it)
        topv = probs.gather(1, topi)
        return probs, topv / torch.clamp(topv.sum(-1, keepdim=True),
                                         min=1e-9), topi
    return route


def _rounding_witnesses(real_flash, seed: int):
    """(name, flash_attention) pairs that differ from the plain attention
    by rounding alone: its output moved by one bf16 ulp with a seeded
    sign per element, and SDPA (the library's attention)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)

    def ulp(q, k, v, **kw):
        o = real_flash(q, k, v, **kw)
        of = o.float()
        step = of.abs().clamp_min(2.0 ** -126).log2().floor().sub(7).exp2()
        sign = torch.randint(0, 2, o.shape, generator=gen,
                             device=o.device).mul(2).sub(1)
        return (of + sign * step).to(o.dtype)

    def sdpa(q, k, v, *, causal=True, window=0, scale=None, backend="auto"):
        check(window == 0, "the SDPA witness takes no window")
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, scale=scale,
            enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)

    return (("plain_one_ulp", ulp), ("sdpa", sdpa))


def serve_zoo(seed: int) -> dict:
    """Phase 12: each model of ZOO_MODELS served on the card in bf16, its
    weights drawn there from a seeded generator, freed before the next.
    Returns the per-model numbers, each with its bf16 flash launches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.registry import build_model
    from repro_torch.serve import engine
    from repro_torch.serve.engine import Request, ServeEngine

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    real_route = moe_mod.route
    real_flash = ops.flash_attention
    out = {}
    for arch, spec in ZOO_MODELS.items():
        t_model = time.perf_counter()
        cfg = get_config(arch)
        if spec.get("layers"):
            cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
        lengths, new = spec["lengths"], spec["new"]
        Fl = cfg.frontend_len if cfg.frontend != "none" else 0
        # a decoder-only model's frontend comes before its tokens
        extra = 0 if cfg.is_encdec else Fl
        max_len = max(lengths) + extra + new
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = build_model(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = model.init(gen)
        sync()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in engine._leaves(params))
        check(params["embed"].dtype == torch.bfloat16,
              f"zoo {arch}: weights not bf16")
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab, T_, dtype=np.int32)
                   for T_ in lengths]
        frontends = [rng.normal(size=(Fl, cfg.d_model)).astype(np.float32)
                     if Fl else None for _ in lengths]

        def fe_of(i):
            f = frontends[i]
            return None if f is None else torch.as_tensor(f, device=dev)[None]

        # warm-up (cuBLAS handles, first-call allocations): not counted
        model.prefill(params, torch.as_tensor(prompts[0][:64], device=dev)
                      [None], fe_of(0), max_len=max_len)
        sync()

        def serve(m, label, before_first_decode=None, first_route=None):
            """The requests through a ServeEngine over ``m``, counts reset
            just before and read just after: (engine, requests, launches,
            seconds, prefill log, decode ms, first decode step's logits).
            ``before_first_decode(decode_step, args)`` runs, untimed, just
            before the first decode step, and ``first_route`` stands in
            for ``moe.route`` during that step."""
            plog, dms, first = [], [], []
            pf, ds = m.prefill, m.decode_step

            def timed_prefill(*a, **kw):
                sync()
                t_ = time.perf_counter()
                o = pf(*a, **kw)
                sync()
                plog.append((int(a[1].shape[1]), time.perf_counter() - t_,
                             bool(torch.isfinite(o[0]).all()),
                             int(torch.argmax(o[0], -1)[0])))
                return o

            def timed_decode(*a, **kw):
                if not first and before_first_decode is not None:
                    before_first_decode(ds, a)
                if not first and first_route is not None:
                    moe_mod.route = first_route
                sync()
                t_ = time.perf_counter()
                try:
                    o = ds(*a, **kw)
                    sync()
                finally:
                    moe_mod.route = real_route
                dms.append((time.perf_counter() - t_) * 1e3)
                check(bool(torch.isfinite(o[0]).all()),
                      f"zoo {label}: decode logits not finite")
                if not first:
                    first.append(o[0].float().clone())
                return o

            # the attention calls that launch the flash kernels, by their
            # causal flag (the kernel's own count is the launch count)
            calls = {True: 0, False: 0}

            def flash_by_flag(*a, **kw):
                calls[bool(kw.get("causal", True))] += 1
                return real_flash(*a, **kw)

            m.prefill, m.decode_step = timed_prefill, timed_decode
            ops.flash_attention = flash_by_flag
            try:
                eng = ServeEngine(m, params, n_slots=spec["slots"],
                                  max_len=max_len)
                reqs = [Request(uid=i, prompt=p_, max_new_tokens=new,
                                frontend=frontends[i])
                        for i, p_ in enumerate(prompts)]
                for r_ in reqs:
                    eng.submit(r_)
                sync()
                ops.reset_launch_counts()
                t_ = time.perf_counter()
                eng.run()
                sync()
                run_s = time.perf_counter() - t_
                launches = ops.launch_counts()
            finally:
                m.prefill, m.decode_step = pf, ds
                ops.flash_attention = real_flash
            launches["non_causal_calls"] = calls[False]
            check(calls[False] == spec.get("non_causal", 0) * len(prompts)
                  and calls[True] + calls[False] == spec["flash"]
                  * len(prompts), f"zoo {label}: flash calls by causal "
                  f"flag {calls}")
            check(all(r_.done and len(r_.output) == new
                      and all(0 <= t_ < cfg.vocab for t_ in r_.output)
                      for r_ in reqs),
                  f"zoo {label}: a request is not done with {new} tokens "
                  f"below the vocabulary")
            check([e_[0] for e_ in plog] == [len(p_) for p_ in prompts]
                  and all(e_[2] for e_ in plog),
                  f"zoo {label}: prefills {plog}")
            check(all(r_.output[0] == e_[3] for r_, e_ in zip(reqs, plog)),
                  f"zoo {label}: a first token is not the argmax of its "
                  f"prefill's logits")
            want = spec["flash"] * len(reqs)
            check(launches["flash_attention_wgmma"] == want
                  and sum(v_ for k_, v_ in launches.items()
                          if k_ != "non_causal_calls") == want,
                  f"zoo {label}: launches {launches}, want {want} bf16 "
                  f"flash launches and no other kernel")
            return eng, reqs, launches, run_s, plog, dms, first[0]

        # an MoE model's routing in its first decode step, kept for the
        # int8 cache's comparison under the same routing
        first_routes = []
        eng, reqs, launches, run_s, plog, dms, first = serve(
            model, arch, first_route=_recording_route(moe_mod, first_routes)
            if cfg.n_experts else None)
        row = dict(arch=arch, n_layers=cfg.n_layers,
                   full_depth=cfg.n_layers == get_config(arch).n_layers,
                   params=n_params, param_bytes=_nbytes(params),
                   init_s=init_s, slots=spec["slots"], max_len=max_len,
                   prompt_lengths=list(lengths), frontend_len=Fl,
                   new_tokens=new, run_s=run_s, engine_steps=eng.steps,
                   prefill_s=[[e_[0], e_[1]] for e_ in plog],
                   decode_ms_mean=float(np.mean(dms)),
                   decode_ms_median=float(np.median(dms)),
                   decode_steps=len(dms), launches=launches,
                   cache_bytes=_nbytes(eng.caches))

        if spec.get("cos_T"):
            # the longest prompt through the kernels and through the plain
            # attention.  An MoE model routes each token to its top-k
            # experts, a discrete choice that the kernel's last-bit
            # differences flip for near-tied tokens (and a flip moves other
            # pairs past an expert's capacity): its gate is taken with the
            # plain run given the kernel run's routing, and the free run's
            # cosine, the flips and the pairs dropped by capacity are logged
            i = lengths.index(spec["cos_T"])
            tok = torch.as_tensor(prompts[i], device=dev)[None]
            drops, routes = [], {"cuda": [], "torch": []}
            real_dispatch = moe_mod.dispatch

            def counting_dispatch(topi, C, E):
                o = real_dispatch(topi, C, E)
                drops.append(int((~o[2]).sum()))
                return o

            def last_logits(backend, route_fn=None):
                if route_fn is not None:
                    moe_mod.route = route_fn
                try:
                    lo = model.forward(params, tok, fe_of(i), backend=backend)
                finally:
                    moe_mod.route = real_route
                lo = lo if torch.is_tensor(lo) else lo[0]
                return lo[0, -1, :cfg.vocab].clone()

            moe_mod.dispatch = counting_dispatch
            try:
                lc = last_logits("cuda", _recording_route(moe_mod,
                                                          routes["cuda"]))
            finally:
                moe_mod.dispatch = real_dispatch
            lt = last_logits("torch", _recording_route(moe_mod,
                                                       routes["torch"]))

            cos = _cosine(lc, lt)
            row["cuda_vs_torch"] = dict(prompt=spec["cos_T"],
                                        last_cosine=cos, max_abs_dlogit=float(
                                            (lc - lt).abs().max()))
            gate = cos
            if cfg.n_experts:
                def flips_of(ra, rb):
                    return [float((a_.sort(-1).values != b_.sort(-1).values)
                                  .any(-1).float().mean())
                            for a_, b_ in zip(ra, rb)]

                flips = flips_of(routes["cuda"], routes["torch"])
                ls = last_logits("torch", _replayed_route(moe_mod,
                                                          routes["cuda"]))
                gate = _cosine(lc, ls)
                # the rounding witnesses: the plain run again with its
                # attention output moved by one bf16 ulp (a seeded sign
                # per element), and with SDPA in place of the plain
                # attention; each free, against the plain run
                wit = {}
                for name, fn in _rounding_witnesses(real_flash, seed):
                    rw = []
                    ops.flash_attention = fn
                    try:
                        lw = last_logits("torch",
                                         _recording_route(moe_mod, rw))
                    finally:
                        ops.flash_attention = real_flash
                    fw = flips_of(rw, routes["torch"])
                    wit[name] = dict(last_cosine=_cosine(lw, lt),
                                     flip_share_mean=float(np.mean(fw)),
                                     routing_flip_share_per_dispatch=fw)
                    del lw, rw
                worst = min(w_["last_cosine"] for w_ in wit.values())
                free_lim = 1.0 - MOE_FREE_FACTOR * (1.0 - worst)
                row["cuda_vs_torch"].update(
                    shared_routing_cosine=gate,
                    flip_share_mean=float(np.mean(flips)),
                    routing_flip_share_per_dispatch=flips,
                    rounding_witnesses=wit, free_cosine_limit=free_lim)
                check(cos >= free_lim, f"zoo {arch}: cuda vs torch at "
                      f"T={spec['cos_T']} with free routing: last-position "
                      f"cosine {cos} < {free_lim}, {MOE_FREE_FACTOR}x the "
                      f"rounding witnesses' distance from 1 "
                      f"({row['cuda_vs_torch']})")
                pairs = spec["cos_T"] * cfg.moe_top_k * cfg.n_layers
                row["moe_dropped_pairs"] = dict(
                    prompt=spec["cos_T"], dispatches=len(drops),
                    pairs=pairs, dropped=sum(drops),
                    dropped_share=sum(drops) / pairs, per_dispatch=drops)
                del ls
            check(bool(torch.isfinite(lc).all()) and gate >= 0.999,
                  f"zoo {arch}: cuda vs torch at T={spec['cos_T']}: "
                  f"last-position cosine {gate} < 0.999 "
                  f"({row['cuda_vs_torch']})")
            del lc, lt, tok, routes

        if spec.get("kv_quant"):
            # the same requests and weights through int8 KV caches
            qmodel = build_model(cfg, kv_quant=True)
            shared = []

            def shared_first_step(ds_, a_):
                # the first decode step on a copy of the int8 caches, with
                # the bf16 run's routing (untimed; the engine's own step
                # then routes freely)
                moe_mod.route = _replayed_route(moe_mod, first_routes)
                try:
                    o_ = ds_(a_[0], engine._map(a_[1], torch.Tensor.clone),
                             *a_[2:])
                finally:
                    moe_mod.route = real_route
                shared.append(o_[0].float().clone())

            qeng, qreqs, qlaunch, qrun_s, qplog, qdms, qfirst = serve(
                qmodel, f"{arch} kv_quant", before_first_decode=(
                    shared_first_step if cfg.n_experts else None))
            check([r_.output[0] for r_ in qreqs]
                  == [r_.output[0] for r_ in reqs],
                  f"zoo {arch} kv_quant: first tokens differ from the bf16 "
                  f"cache's")
            ratio = _nbytes(qeng.caches) / _nbytes(eng.caches)
            check(ratio <= 0.55, f"zoo {arch} kv_quant: the int8 caches "
                  f"hold {ratio:.4f} of the bf16 caches' bytes > 0.55")
            qcos = [_cosine(a_, b_) for a_, b_ in zip(qfirst, first)]
            gate = [_cosine(a_, b_) for a_, b_ in zip(shared[0], first)] \
                if shared else qcos
            check(min(gate) >= 0.99, f"zoo {arch} kv_quant: first decode "
                  f"step's logits at cosine {gate} of the bf16 cache's "
                  f"(free routing: {qcos})")
            check(min(qcos) >= KVQ_FREE_COSINE, f"zoo {arch} kv_quant: "
                  f"first decode step's logits with free routing at cosine "
                  f"{qcos} of the bf16 cache's < {KVQ_FREE_COSINE}")
            row["kv_quant"] = dict(
                cache_bytes=_nbytes(qeng.caches), bytes_ratio=ratio,
                first_decode_cosine=gate, first_decode_cosine_free=qcos,
                run_s=qrun_s,
                prefill_s=[[e_[0], e_[1]] for e_ in qplog],
                decode_ms_mean=float(np.mean(qdms)),
                decode_ms_median=float(np.median(qdms)),
                launches=qlaunch, same_first_tokens=True)
            del qeng, qreqs, qmodel, qfirst
        row["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        del eng, reqs, params, model, first
        torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t_model
        log(f"[zoo] {json.dumps(row)}")
        out[arch] = row
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="Crop",
                    help="UCR_SIZES entry for the main paths (default Crop)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not (SRC / "repro_torch" / "__init__.py").exists():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")

    import numpy as np

    from repro_torch.approx import knn, project, sparse_tmfg
    from repro_torch.approx.quality import compare_to_dense
    from repro_torch.core import (PipelineConfig, adjusted_rand_index,
                                  clear_compiled, cluster, cluster_batch,
                                  cut_linkage, jitcache, run_pipeline_device)
    from repro_torch.core import fused_approx as fa_mod
    from repro_torch.core import sparse_dbht
    from repro_torch.core import tmfg as tmfg_mod
    from repro_torch.core.apsp import hub_count
    from repro_torch.data.graphs import apollonian_edges
    from repro_torch.data.timeseries import (UCR_SIZES, make_dataset,
                                             make_ucr_like)
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import sparse_apsp as sp
    from repro_torch.kernels.gainscan import masked_argmax_cuda
    from repro_torch.kernels.minplus import minplus_cuda
    from repro_torch.kernels.pearson import pearson_cuda
    from repro_torch.kernels.topk import topk_pearson_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    t_start = time.perf_counter()

    # ---- 1. environment ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"[env] {smi_line}")
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    check(clk.returncode == 0, f"nvidia-smi failed: {clk.stderr.strip()}")
    sm_mhz = float(clk.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # fp32 instructions other than FMA (add, min): one per lane per clock,
    # 128 lanes per SM; the 67 TFLOP/s peak counts an FMA as two flops
    fp32_issue_per_s = 128 * sms * sm_mhz * 1e6
    log(f"[env] {sms} SMs, max SM clock {sm_mhz:.0f} MHz: "
        f"{fp32_issue_per_s / 1e12:.2f} T fp32 instructions/s")
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

    def graph_ms(fn, reps: int) -> float:
        """cuda_ms for a call shorter than the host's time per call: reps
        calls captured in one CUDA graph, the replay timed."""
        fn()
        sync()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        sync()
        return start.elapsed_time(end) / reps

    # ---- 2. kernels at the main paths' shapes --------------------------
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
    del S_p
    # the ragged instance (n % 4 != 0: rows not 16-byte aligned, tiles
    # owning 120 rows)
    n_r = n if n % 4 else n - 1
    S_r = pearson_cuda(X[:n_r].contiguous())
    err_r = float((S_r - ref.pearson_ref(X[:n_r])).abs().max())
    check(n_r % 4 != 0 and err_r <= 1e-5 and bool(torch.equal(S_r, S_r.T)),
          f"pearson kernel at ragged n={n_r}: max abs err {err_r}, or not "
          f"bitwise symmetric")
    del S_r
    # the output is symmetric: n (n + 1) / 2 dot products of length L
    b_ms, b_by = bound(4 * (n * L + 2 * n + n * n), n * (n + 1) * L)
    entries["pearson"] = dict(
        name="pearson", route="cuda",
        source="src/repro_torch/kernels/csrc/pearson.cu",
        replaces="src/repro/kernels/pearson.py:35",
        shape=[n, L], max_abs_err=err, ragged_n=n_r,
        max_abs_err_ragged=err_r,
        ms=cuda_ms(lambda: pearson_cuda(X), 10),
        plain_ms=cuda_ms(lambda: ref.pearson_ref(X), 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.corrcoef(X), 10))
    log(f"[kernel] pearson ok: {entries['pearson']}")

    # top-K: bitwise a stable top-k of the Pearson kernel's rows
    K = 64
    tv, ti = topk_pearson_cuda(X, K)
    pv, _ = ref.topk_pearson_ref(X, K)
    sync()
    S_k.fill_diagonal_(float("-inf"))
    for r0 in range(0, n, 2048):
        sv, si = torch.sort(S_k[r0:r0 + 2048], dim=1, descending=True,
                            stable=True)
        check(bool(torch.equal(tv[r0:r0 + 2048], sv[:, :K]))
              and bool(torch.equal(ti[r0:r0 + 2048], si[:, :K].int())),
              f"topk kernel is not a stable top-{K} of pearson_cuda rows "
              f"(rows {r0}..)")
    del sv, si, S_k
    err = float((tv - pv).abs().max())
    check(err <= 1e-6, f"topk kernel vs plain: max abs err {err} > 1e-6")
    ns = 700
    Xs = X[:ns].contiguous()
    sv_, si_ = topk_pearson_cuda(Xs, ns - 1)
    P = pearson_cuda(Xs)
    P.fill_diagonal_(float("-inf"))
    wv, wi = torch.sort(P, dim=1, descending=True, stable=True)
    check(bool(torch.equal(sv_, wv[:, :ns - 1]))
          and bool(torch.equal(si_, wi[:, :ns - 1].int())),
          f"topk kernel at k = n-1 (n={ns}) is not a stable sort of rows")
    err_s = float((sv_ - ref.topk_pearson_ref(Xs, ns - 1)[0]).abs().max())
    check(err_s <= 1e-6, f"topk kernel vs plain at k = n-1: {err_s} > 1e-6")
    del P, wv, wi, sv_, si_, Xs, tv, ti, pv
    b_ms, b_by = bound(4 * (n * L + 2 * n) + 8 * n * K, n * (n + 1) * L)
    entries["topk"] = dict(
        name="topk", route="cuda",
        source="src/repro_torch/kernels/csrc/topk.cu",
        replaces="src/repro/kernels/topk.py:99",
        shape=[n, L, K], max_abs_err=err, max_abs_err_full_k=err_s,
        ms=cuda_ms(lambda: topk_pearson_cuda(X, K), 5),
        plain_ms=cuda_ms(lambda: ref.topk_pearson_ref(X, K), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"[kernel] topk ok (bitwise vs a stable top-k of pearson_cuda): "
        f"{entries['topk']}")
    torch.cuda.empty_cache()

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
    # NaN operands: the kernel keeps them where the plain version does
    An, Bn = dist(h, 4096), dist(4096, 4096)
    idx = torch.randint(0, An.numel(), (3,), generator=gen, device=dev)
    An.view(-1)[idx] = float("nan")
    idx = torch.randint(0, Bn.numel(), (3,), generator=gen, device=dev)
    Bn.view(-1)[idx] = float("nan")
    nk, npl = minplus_cuda(An, Bn), ref.minplus_ref(An, Bn)
    check(bool(torch.isnan(npl).any()) and same_nan(nk, npl),
          "minplus kernel vs plain differ with NaN inputs")
    del An, Bn, nk, npl
    # the hub round's form at k a multiple of the 32-deep panel and not,
    # split over k (fewer tiles than SMs), the composition's form at an
    # odd n (rows not 16-byte aligned: 4-byte copies and scalar stores),
    # -inf entries (-inf + inf = NaN) and negative ones in the split's
    # atomic fold
    mp_cases = []
    for mm, kk, nn in ((h, 4096, 4096), (h, 4099, 4099), (2000, h, 2003)):
        Ae, Be = dist(mm, kk), dist(kk, nn)
        Ae.view(-1)[::97] = float("-inf")
        Ae.view(-1)[3::101] = -1.25
        A0, B0 = Ae.clone(), Be.clone()
        ok = same_nan(minplus_cuda(Ae, Be), ref.minplus_ref(Ae, Be))
        check(ok and torch.equal(Ae, A0) and torch.equal(Be, B0),
              f"minplus kernel vs plain differ at ({mm}, {kk}) x "
              f"({kk}, {nn}), or an operand changed")
        mp_cases.append([mm, kk, nn])
        del Ae, Be, A0, B0
    mp_sass = sass_counts(_build.BUILD_INFO["path"], "minplus_kernel",
                          ("FMNMX", "FADD", "LDS.128", "LDS", "LDL", "STL"))
    log(f"[sass] minplus_kernel instances: {mp_sass}")
    check(len(mp_sass) == 2 and all(
        c["FMNMX"] > 0 and c["LDS.128"] > 0 and c["LDL"] == 0
        and c["STL"] == 0 for c in mp_sass.values()),
        f"minplus_kernel SASS: a spill, or no FMNMX or LDS.128: {mp_sass}")
    # an add and a min per (i, k, j), each an fp32 instruction
    b_ms, b_by = bound(4 * (h * n + n * n + h * n), 2 * h * n * n,
                       fp32_issue_per_s)
    c_ms, c_by = bound(4 * (n * h + h * n + n * n), 2 * n * h * n,
                       fp32_issue_per_s)
    entries["minplus"] = dict(
        name="minplus", route="cuda",
        source="src/repro_torch/kernels/csrc/minplus.cu",
        replaces="src/repro/kernels/minplus.py:39",
        shape=[h, n, n], max_abs_err=0.0, ms=round_ms, plain_ms=round_plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        compose=dict(shape=[n, h, n], ms=comp_ms, plain_ms=comp_plain,
                     bound_ms=c_ms, bound_by=c_by, max_abs_err=0.0),
        bitwise_cases=mp_cases, sass=mp_sass)
    log(f"[kernel] minplus ok (bitwise, NaN included): {entries['minplus']}")

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

    # sparse relaxation: h sources over two connected graphs of 3n-6 edges,
    # a path plus random chords (near-uniform degrees, random sources) and
    # a random Apollonian network (a TMFG's degree shape, hubs chosen by
    # strength as hub_factor_sparse chooses them); on each, one round with
    # NaN entries and the fixed point, bitwise, and the round timed on the
    # sources-minor layout (the transposes outside the timed window)
    E = 3 * n - 6
    r = np.random.default_rng(args.seed)
    pairs = {(i, i + 1) for i in range(n - 1)}
    while len(pairs) < E:
        a, b = (int(v) for v in r.integers(0, n, 2))
        if a != b:
            pairs.add((min(a, b), max(a, b)))
    relax = {}
    for gname, edges_np in (("path_chords", np.array(sorted(pairs))),
                            ("tmfg_like", apollonian_edges(n, args.seed))):
        edges = torch.tensor(edges_np, dtype=torch.int32, device=dev)
        wts = torch.rand(E, generator=gen, device=dev) * 1.9 + 0.1
        g = sp.csr_from_edges(n, edges, wts)
        m = int(g.cols.shape[0])
        if gname == "path_chords":
            src = torch.randperm(n, generator=gen, device=dev)[:h]
        else:
            src = torch.sort(sp.hub_strength(g), descending=True,
                             stable=True)[1][:h]
        fk, fp = {}, {}
        Dk = sp.sparse_apsp_sources(g, src, backend="cuda", stats=fk)
        Dp = sp.sparse_apsp_sources(g, src, backend="torch", stats=fp)
        check(bool(torch.equal(Dk, Dp)) and fk == fp and bool(
            torch.isfinite(Dk).all()),
            f"sparse_relax fixed point differs on {gname} ({fk} vs {fp} "
            f"rounds)")
        D1 = torch.full((h, n), float("inf"), device=dev)
        D1[torch.arange(h, device=dev), src] = 0.0
        for _ in range(3):
            D1 = ops.sparse_relax(D1, g, backend="torch")[0]
        D1.view(-1)[torch.randint(0, h * n, (h,), generator=gen,
                                  device=dev)] = float("nan")
        ok, ck = ops.sparse_relax(D1, g, backend="cuda")
        op, cp = ops.sparse_relax(D1, g, backend="torch")
        check(same_nan(ok, op) and bool(torch.isnan(op).any())
              and int(ck.item()) == int(bool(cp.item())),
              f"sparse_relax kernel vs plain differ on one round with NaN "
              f"({gname})")
        del D1, ok, op
        plan = sp.relax_plan(g.indptr)
        Dt = sp.to_sources_minor(Dk)
        sync()
        t0 = time.perf_counter()
        sp.sparse_apsp_sources(g, src, backend="cuda")
        sync()
        fix_ms = (time.perf_counter() - t0) * 1e3
        relax[gname] = dict(
            shape=[h, n, m],
            max_degree=int((g.indptr[1:] - g.indptr[:-1]).max()),
            split_rows=plan.n_slots, fixed_point_rounds=fk["bf_rounds"],
            fixed_point_ms=fix_ms,
            ms=graph_ms(lambda: sp.sparse_relax_t_cuda(
                Dt, h, g.indptr, g.cols, g.vals, plan), 20),
            plain_ms=cuda_ms(lambda: ref.sparse_relax_ref(
                Dk, g.indptr, g.cols, g.vals), 5))
        log(f"[kernel] sparse_relax on {gname}: {relax[gname]}")
        del Dk, Dp, Dt, g, edges, wts
    # h x n distances read and written once, the CSR read once
    b_ms, b_by = bound(4 * 2 * h * n + 4 * (n + 1) + 8 * m, 2 * h * m)
    pc, tl = relax["path_chords"], relax["tmfg_like"]
    entries["sparse_relax"] = dict(
        name="sparse_relax", route="cuda",
        source="src/repro_torch/kernels/csrc/sparse_relax.cu",
        replaces="src/repro/kernels/sparse_apsp.py:114",
        shape=pc["shape"], max_abs_err=0.0,
        fixed_point_rounds=pc["fixed_point_rounds"],
        fixed_point_ms=pc["fixed_point_ms"], ms=pc["ms"],
        plain_ms=pc["plain_ms"], bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape_tmfg_like=tl["shape"],
        ms_tmfg_like=tl["ms"], fixed_point_ms_tmfg_like=tl["fixed_point_ms"],
        fixed_point_rounds_tmfg_like=tl["fixed_point_rounds"],
        max_degree_tmfg_like=tl["max_degree"], graphs=relax)
    log(f"[kernel] sparse_relax ok (bitwise, NaN included, both graphs): "
        f"{entries['sparse_relax']}")
    # the SASS of the Pearson, top-K, relaxation and fp32 flash kernels:
    # no spill (the fp32 flash kernel is checked here, its times below)
    ax_sass = {}
    for kern in ("pearson_kernel", "topk_kernel", "sparse_relax_kernel",
                 "flash_kernel"):
        ax_sass.update(sass_counts(_build.BUILD_INFO["path"], kern,
                                   ("FFMA", "LDS.128", "LDL", "STL")))
    log(f"[sass] pearson, topk, sparse_relax and fp32 flash kernels: "
        f"{ax_sass}")
    check(all(any(k_ in name_ for name_ in ax_sass) for k_ in
              ("pearson_kernel", "topk", "relax", "flash_kernel"))
          and all(c["LDL"] == 0 and c["STL"] == 0 for c in ax_sass.values()),
          f"pearson, topk, sparse_relax or fp32 flash kernel SASS: missing, "
          f"or a spill: {ax_sass}")
    for kname, key in (("pearson", "pearson_kernel"), ("topk", "topk"),
                       ("sparse_relax", "relax")):
        entries[kname]["sass"] = {k_: v_ for k_, v_ in ax_sass.items()
                                  if key in k_}
    del X
    torch.cuda.empty_cache()

    # flash attention: granite-3-8b's per-sequence prefill (the serve
    # path's shape) and gemma3-4b's local layer in bf16 (the wgmma kernel),
    # and MQA in fp32 with ragged T (the CUDA-core kernel)
    # and the serving zoo's prefills (phase 12) in bf16: zamba2's shared
    # block (hd 80, window 4096), seamless's encoder (non-causal),
    # deepseek (MHA) and qwen2-vl (GQA 64/8)
    flash_cases = [
        ("granite-3-8b causal", (1, 4096, 32, 8, 128), 0, True,
         torch.bfloat16),
        ("gemma3-4b local", (1, 4096, 8, 4, 256), 1024, True,
         torch.bfloat16),
        ("zamba2-2.7b shared block", (1, 2048, 32, 32, 80), 4096, True,
         torch.bfloat16),
        ("seamless-m4t encoder", (1, 1024, 16, 16, 64), 0, False,
         torch.bfloat16),
        ("deepseek-moe-16b causal", (1, 4096, 16, 16, 128), 0, True,
         torch.bfloat16),
        ("qwen2-vl-72b causal", (1, 1024, 64, 8, 128), 0, True,
         torch.bfloat16),
        ("MQA ragged", (1, 1000, 48, 1, 128), 0, True, torch.float32),
        ("granite-3-8b fp32 prefill", (1, FP32_TOKENS, 32, 8, 128), 0, True,
         torch.float32),
    ]
    fcases = []
    for label, (B, T, H, KV, hd), win, causal, dt in flash_cases:
        fq = torch.randn((B, T, H, hd), generator=gen, device=dev).to(dt)
        fk = torch.randn((B, T, KV, hd), generator=gen, device=dev).to(dt)
        fv = torch.randn((B, T, KV, hd), generator=gen, device=dev).to(dt)
        got = flash_attention_cuda(fq, fk, fv, causal=causal, window=win)
        want = ref.flash_attention_ref(fq, fk, fv, causal=causal,
                                       window=win)
        sync()
        gates = {}
        if dt == torch.float32:
            err, tol = float((got - want).abs().max()), 1e-5
            ok = err <= tol
        else:
            ok, gates = bf16_gate(got, want)
            err, tol = gates["max_abs_err"], gates["tol"]
        check(got.dtype == dt and got.shape == fq.shape and ok,
              f"flash kernel vs plain at {label}: max abs err {err} "
              f"(tol {tol}), {gates}")
        del got, want
        if dt == torch.bfloat16 and (win == 0 or win >= T):
            # the serve path's form: q scaled in bf16 first, scale = 1
            qs = fq * torch.tensor(hd ** -0.5, dtype=dt, device=dev)
            got = flash_attention_cuda(qs, fk, fv, causal=causal,
                                       window=win, scale=1.0)
            want = ref.flash_attention_ref(qs, fk, fv, causal=causal,
                                           window=win, scale=1.0)
            ok, gates["prescaled"] = bf16_gate(got, want)
            check(ok, f"flash kernel vs plain at {label}, q pre-scaled, "
                      f"scale 1: {gates['prescaled']}")
            del got, want, qs
        pairs = B * H * (causal_pairs(T, win) if causal else T * T)
        elem = fq.element_size()
        b_ms, b_by = bound(elem * (2 * fq.numel() + 2 * fk.numel()),
                           4 * hd * pairs,
                           BF16_TENSOR_OPS_PER_S if dt == torch.bfloat16
                           else FP32_OPS_PER_S)
        # one PyTorch call computes the same function: SDPA, causal, or
        # with the window as a boolean mask built outside the timed call
        qt, kt_, vt = (x.transpose(1, 2) for x in (fq, fk, fv))
        if win == 0 or (causal and win >= T):
            lib_ms = cuda_ms(lambda: torch.nn.functional.
                             scaled_dot_product_attention(
                                 qt, kt_, vt, is_causal=causal,
                                 enable_gqa=True), 10)
        else:
            ti = torch.arange(T, device=dev)
            live = (ti[:, None] >= ti[None, :]) & \
                (ti[:, None] - ti[None, :] < win)
            lib_ms = cuda_ms(lambda: torch.nn.functional.
                             scaled_dot_product_attention(
                                 qt, kt_, vt, attn_mask=live,
                                 enable_gqa=True), 10)
            del live
        fcases.append(dict(
            case=label, shape=[B, T, H, KV, hd], window=win, causal=causal,
            dtype=str(dt).replace("torch.", ""), max_abs_err=err, tol=tol,
            gates=gates,
            ms=cuda_ms(lambda: flash_attention_cuda(
                fq, fk, fv, causal=causal, window=win), 20),
            plain_ms=cuda_ms(lambda: ref.flash_attention_ref(
                fq, fk, fv, causal=causal, window=win), 2),
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
        log(f"[kernel] flash_attention ok at {label}: {fcases[-1]}")
        del fq, fk, fv, qt, kt_, vt
        torch.cuda.empty_cache()

    # the bf16 kernel's SASS holds tensor-core products and TMA loads
    sass = sass_counts(_build.BUILD_INFO["path"], "flash_wgmma_kernel",
                       ("HGMMA", "UTMALDG"))
    log(f"[sass] flash_wgmma_kernel instances: {sass}")
    check(len(sass) > 0 and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0
                                for c in sass.values()),
          f"flash_wgmma_kernel SASS lacks HGMMA or UTMALDG: {sass}")
    for kname, dtn in (("flash_attention_wgmma", "bfloat16"),
                       ("flash_attention", "float32")):
        cases = [c_ for c_ in fcases if c_["dtype"] == dtn]
        head = cases[0]
        entries[kname] = dict(
            name=kname, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{kname}.cu",
            replaces="src/repro/kernels/flash_attention.py:87",
            shape=head["shape"], max_abs_err=head["max_abs_err"],
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], cases=cases)
    entries["flash_attention_wgmma"]["sass"] = sass
    entries["flash_attention"]["sass"] = {k_: v_ for k_, v_ in ax_sass.items()
                                          if "flash_kernel" in k_}
    log(f"[time] kernels phase done at {time.perf_counter() - t_start:.1f} s")

    # ---- 3. the serve path ---------------------------------------------
    cfg_lm = get_config(SERVE_ARCH)
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg_lm)
    lm_gen = torch.Generator(device=dev)
    lm_gen.manual_seed(args.seed)
    params = model.init(lm_gen)
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in [params["embed"], params["ln_f"]["scale"]]
                   ) + sum(t.numel() for lp in params["layers"]
                           for d in lp.values() for t in d.values())
    padding = (cfg_lm.vocab_padded - cfg_lm.vocab) * cfg_lm.d_model
    check(n_params - padding == cfg_lm.param_count(),
          f"serve: {n_params} parameters, param_count "
          f"{cfg_lm.param_count()} + padding {padding}")
    check(params["embed"].dtype == torch.bfloat16
          and len(params["layers"]) == cfg_lm.n_layers,
          "serve: not bf16 at full depth")

    rng_lm = np.random.default_rng(args.seed)
    lengths = list(SERVE_LENGTHS) * 2
    prompts = [rng_lm.integers(0, cfg_lm.vocab, T_, dtype=np.int32)
               for T_ in lengths]
    # warm-up (cuBLAS handles, first-call allocations): not counted
    model.prefill(params, prompts[0][None], max_len=SERVE_MAX_LEN)
    sync()

    # time every prefill and decode step the engine makes, and keep each
    # prefill's logits for the checks
    prefill_log, decode_ms = [], []
    prefill_fn, decode_fn = model.prefill, model.decode_step

    def timed_prefill(*a, **kw):
        sync()
        t_ = time.perf_counter()
        out = prefill_fn(*a, **kw)
        sync()
        prefill_log.append((int(a[1].shape[1]), time.perf_counter() - t_,
                            bool(torch.isfinite(out[0]).all()),
                            int(torch.argmax(out[0], -1)[0])))
        return out

    def timed_decode(*a, **kw):
        sync()
        t_ = time.perf_counter()
        out = decode_fn(*a, **kw)
        sync()
        decode_ms.append((time.perf_counter() - t_) * 1e3)
        check(bool(torch.isfinite(out[0]).all()), "serve: decode logits "
              "not finite")
        return out

    model.prefill, model.decode_step = timed_prefill, timed_decode
    engine = ServeEngine(model, params, n_slots=SERVE_SLOTS,
                         max_len=SERVE_MAX_LEN)
    reqs = [Request(uid=i, prompt=pr, max_new_tokens=SERVE_NEW)
            for i, pr in enumerate(prompts)]
    for r_ in reqs:
        engine.submit(r_)
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    engine.run()
    sync()
    run_s = time.perf_counter() - t0
    launches_s = ops.launch_counts()
    peak_s = torch.cuda.max_memory_allocated()
    model.prefill, model.decode_step = prefill_fn, decode_fn
    check(launches_s["flash_attention_wgmma"] == cfg_lm.n_layers * len(reqs),
          f"serve: bf16 flash launches {launches_s} != "
          f"{cfg_lm.n_layers} x {len(reqs)}")
    check(sum(launches_s.values()) == launches_s["flash_attention_wgmma"],
          f"serve: other kernels ran {launches_s}")
    check(all(r_.done and len(r_.output) == SERVE_NEW
              and all(0 <= t_ < cfg_lm.vocab for t_ in r_.output)
              for r_ in reqs), "serve: a request is not done with "
          f"{SERVE_NEW} tokens below the vocabulary")
    check(len(prefill_log) == len(reqs)
          and [e_[0] for e_ in prefill_log] == lengths,
          f"serve: prefills {[e_[0] for e_ in prefill_log]}")
    check(all(e_[2] for e_ in prefill_log), "serve: prefill logits not finite")
    check(all(r_.output[0] == e_[3] for r_, e_ in zip(reqs, prefill_log)),
          "serve: a first token is not the argmax of its prefill's logits")
    n_tokens = sum(len(r_.output) for r_ in reqs)
    prefill_s = {T_: [e_[1] for e_ in prefill_log if e_[0] == T_]
                 for T_ in SERVE_LENGTHS}

    # the 4096-token prompt through the kernel and through the plain version
    long_T = max(SERVE_LENGTHS)
    long_prompt = torch.as_tensor(prompts[lengths.index(long_T)],
                                  device=dev)[None]
    lc = model.forward(params, long_prompt, backend="cuda")[0][0]
    lt = model.forward(params, long_prompt, backend="torch")[0][0]
    V = cfg_lm.vocab
    lc, lt = lc[:, :V], lt[:, :V]
    dlogit = float((lc - lt).abs().max())
    top1 = float((lc.argmax(-1) == lt.argmax(-1)).float().mean())
    cos = float(torch.nn.functional.cosine_similarity(
        lc[-1].double(), lt[-1].double(), dim=0))
    check(bool(torch.isfinite(lc).all()) and cos >= 0.999,
          f"serve: cuda vs torch prefill: last-position cosine {cos} < 0.999")
    serve = dict(arch=SERVE_ARCH, dtype="bfloat16", n_layers=cfg_lm.n_layers,
                 params=n_params, init_s=init_s, slots=SERVE_SLOTS,
                 max_len=SERVE_MAX_LEN, requests=len(reqs),
                 prompt_lengths=lengths, new_tokens=SERVE_NEW,
                 prefill_s=prefill_s, decode_ms_mean=float(np.mean(decode_ms)),
                 decode_ms_median=float(np.median(decode_ms)),
                 decode_steps=len(decode_ms), engine_steps=engine.steps,
                 run_s=run_s, ms_per_engine_step=run_s * 1e3 / engine.steps,
                 tokens=n_tokens, tokens_per_s=n_tokens / run_s,
                 launches=launches_s, peak_bytes=peak_s,
                 cuda_vs_torch=dict(prompt=long_T, max_abs_dlogit=dlogit,
                                    top1_agreement=top1, last_cosine=cos))
    log(f"[serve] {json.dumps(serve)}")
    del lc, lt, long_prompt, engine, reqs, params, model
    torch.cuda.empty_cache()
    log(f"[time] serve phase done at {time.perf_counter() - t_start:.1f} s")

    # ---- 3b. the fp32 prefill path -------------------------------------
    # the same model at full width in fp32, depth cut to FP32_LAYERS: one
    # prefill of an FP32_TOKENS prompt through the CUDA-core flash kernel,
    # against backend="torch"
    cfg_32 = dataclasses.replace(cfg_lm, n_layers=FP32_LAYERS,
                                 dtype="float32")
    model = build_model(cfg_32)
    params = model.init(lm_gen)
    toks32 = torch.as_tensor(prompts[lengths.index(2048)][:FP32_TOKENS],
                             device=dev)[None]
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    l32, _, _ = model.prefill(params, toks32, max_len=toks32.shape[1])
    sync()
    fp32_s = time.perf_counter() - t0
    launches_32 = ops.launch_counts()
    check(launches_32["flash_attention"] == FP32_LAYERS
          and sum(launches_32.values()) == FP32_LAYERS,
          f"fp32 prefill: launches {launches_32} != {FP32_LAYERS} fp32 "
          f"flash launches")
    lt32, _, _ = model.prefill(params, toks32, max_len=toks32.shape[1],
                               backend="torch")
    d32 = float((l32 - lt32).abs().max())
    check(bool(torch.isfinite(l32).all()) and d32 <= 1e-3,
          f"fp32 prefill: cuda vs torch logits differ by {d32} > 1e-3")
    fp32_path = dict(arch=SERVE_ARCH, dtype="float32", n_layers=FP32_LAYERS,
                     tokens=int(toks32.shape[1]), prefill_s=fp32_s,
                     launches=launches_32, max_abs_dlogit=d32)
    log(f"[fp32] {json.dumps(fp32_path)}")
    del l32, lt32, params, model
    torch.cuda.empty_cache()

    def check_syncs(tm, what):
        """Fail if the TMFG made more than ceil(pops / T) + 3 host syncs;
        the TMFG stage's microseconds per pop where it was timed."""
        pops_, syncs_ = int(tm["tmfg_pops"]), int(tm["tmfg_host_syncs"])
        cap = math.ceil(pops_ / tmfg_mod.STEPS_PER_SYNC) + 3
        check(syncs_ <= cap, f"{what}: {syncs_} tmfg host syncs > "
              f"ceil({pops_} / {tmfg_mod.STEPS_PER_SYNC}) + 3 = {cap}")
        return 1e6 * tm["tmfg"] / max(pops_, 1) if "tmfg" in tm else None

    def check_linkage(Z, nn, kk, labels, what):
        check(labels.shape == (nn,), f"{what}: labels shape {labels.shape}")
        check(Z.shape == (nn - 1, 4) and Z.dtype == np.float32,
              f"{what}: linkage {Z.shape} {Z.dtype}")
        check(bool(np.isfinite(Z).all()), f"{what}: non-finite linkage")
        check(bool((np.diff(Z[:, 2]) >= 0).all()),
              f"{what}: complete-linkage heights are not monotone")
        check(int(Z[-1, 3]) == nn, f"{what}: last merge does not hold all")
        check(len(np.unique(labels)) == kk,
              f"{what}: labels do not have {kk} clusters")

    # ---- 4. the dense main path ----------------------------------------
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
    check_linkage(Z, n, k, res.labels, "dense")
    ari = adjusted_rand_index(y, res.labels)
    dense_labels = res.labels
    t = res.timings
    check_syncs(t, "dense")
    log(f"[main] {name} n={n} L={L}: total {total:.3f} s, pops "
        f"{int(t['tmfg_pops'])}, tmfg host syncs {int(t['tmfg_host_syncs'])}, "
        f"hub Bellman-Ford rounds {int(t['apsp_rounds'])}, launches "
        f"{launches}, peak memory {peak} B, ARI vs generator labels {ari:.4f}")
    # the cached lazy program at Crop: its buffers' bytes, its build and
    # the capture that a replay no longer pays
    crop_prog = tmfg_mod.dense_program(n, tmfg_mod.table_width(cfg.topk, n),
                                       dev)
    check(crop_prog.runs == 1 and crop_prog.graph is not None,
          f"dense: the Crop loop program ran {crop_prog.runs} times")
    cache_main = dict(program_bytes=crop_prog.nbytes(),
                      jitcache_bytes=jitcache.nbytes(),
                      s_buffer_bytes=n * n * 4,
                      build_ms=crop_prog.build_s * 1e3,
                      capture_ms=crop_prog.capture_s * 1e3,
                      peak_bytes=peak)
    log(f"[cache] Crop dense: {json.dumps(cache_main)}")
    del crop_prog

    # the staged repeat, at the dataset's size unless the projection passes
    # the budget, then at REPEAT_DATASET size (with its own default run)
    rep = name
    projected = (time.perf_counter() - t_start
                 + (1.1 + APPROX_PER_DENSE) * total + PARITY_S + SPARSE_S
                 + FILTER_S + STREAM_S)
    if projected > STAGED_BUDGET_S:
        rep = REPEAT_DATASET
        log(f"[main] projected finish {projected:.1f} s > {STAGED_BUDGET_S}"
            f" s: the fused=False repeat runs at {rep} size")
    if rep == name:
        Xr, Zr, lr = X_np, Z, res.labels
    else:
        _, Xr, _, kr = make_ucr_like(rep, seed=args.seed)
        r0_ = cluster(Xr, k=kr, config=cfg)
        Zr, lr = r0_.linkage, r0_.labels
        del r0_
    tm_crop = res.tmfg                         # phase 8's TMFG
    tm4, Z4 = res.tmfg, Z                      # phase 11's reference
    del res
    res2 = cluster(Xr, k=len(np.unique(lr)), config=cfg, fused=False,
                   collect_timings=True)
    check(np.array_equal(res2.linkage, Zr), "fused=False linkage differs")
    check(np.array_equal(res2.labels, lr), "fused=False labels differ")
    stages = {s_: res2.timings[s_] for s_ in
              ("similarity", "tmfg", "apsp", "dbht", "hac", "total")}
    us_pop = check_syncs(res2.timings, "dense staged")
    log(f"[main] per-stage seconds (fused=False, {rep} n={Xr.shape[0]}): "
        f"{json.dumps(stages)}; tmfg {us_pop:.2f} us per pop over "
        f"{int(res2.timings['tmfg_pops'])} pops, "
        f"{int(res2.timings['tmfg_host_syncs'])} host syncs")
    main = dict(dataset=name, n=n, L=L, k=k, total_s=total,
                stages_dataset=rep, stages_n=int(Xr.shape[0]),
                stages_s=stages, tmfg_us_per_pop=us_pop,
                pops=int(t["tmfg_pops"]),
                tmfg_host_syncs=int(t["tmfg_host_syncs"]),
                bf_rounds=int(t["apsp_rounds"]), launches=launches,
                peak_bytes=peak, ari=ari)
    del res2
    # the bytes the program cache holds after the Crop calls (the program
    # of the last call's shape; phase 10 reads clear_compiled())
    sync()
    cache_main.update(jitcache_bytes_end=jitcache.nbytes(),
                      entries_end=jitcache.size(),
                      allocated_end=torch.cuda.memory_allocated())
    main["cache"] = cache_main
    log(f"[cache] after the Crop calls: {json.dumps(cache_main)}")
    torch.cuda.empty_cache()
    log(f"[time] dense phase done at {time.perf_counter() - t_start:.1f} s")

    # ---- 5. the approx path --------------------------------------------
    # the cache still holds phase 4's last dense program; the approx
    # call's program miss evicts it (jitcache.evict, wrapped here to read
    # the peak from that point on as well as over the whole call)
    cfg_a = PipelineConfig.approx(sim_k=K)
    sync()
    held_a = jitcache.nbytes()
    real_evict = jitcache.evict
    peaks_a = []

    def evict_and_read(pred):
        gone = real_evict(pred)
        peaks_a.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return gone
    jitcache.evict = evict_and_read
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        ra = cluster(X_np, k=k, config=cfg_a, collect_timings=True)
        sync()
    finally:
        jitcache.evict = real_evict
    Z5, labels5 = ra.linkage, ra.labels        # phase 11's reference
    total_a = time.perf_counter() - t0
    launches_a = ops.launch_counts()
    peaks_a.append(torch.cuda.max_memory_allocated())
    # before the eviction the call's own bytes sit on the held program's;
    # after it, the peak is the call's alone
    peak_a = max(peaks_a[:-1], default=0) - held_a
    peak_a_after = peaks_a[-1]
    left_a = [k[1] for k in jitcache.keys()]
    check(len(peaks_a) == 2 and left_a == ["table"],
          f"approx: {len(peaks_a) - 1} program misses, cache left holding "
          f"{left_a}, not the call's table program alone")
    ta = ra.timings
    check_syncs(ta, "approx")
    # a slot-grid overflow reruns staged, whose timings carry the stages
    check("tmfg" not in ta and ra.dbht.hubs is not None,
          "approx: the fused run overflowed its slot caps and reran staged")
    check(launches_a["topk"] == 1, f"approx: topk launches {launches_a}")
    check(launches_a["sparse_relax"] == int(ta["apsp_rounds"]) > 0,
          f"approx: sparse_relax launches {launches_a} != rounds "
          f"{ta['apsp_rounds']}")
    check(launches_a["masked_argmax"] > 0,
          f"approx: masked_argmax launches {launches_a}")
    check(launches_a["pearson"] == 0, f"approx: pearson ran {launches_a}")
    # below a few panels' worth of rows the (512, n) sweep panels are
    # themselves a large share of (n, n); the bound is checked from there
    if n >= 8 * 512:
        check(max(peak_a, peak_a_after) < n * n * 4, f"approx: peak memory "
              f"{peak_a} B beside the cached program, {peak_a_after} B "
              f"after its eviction, >= one (n, n) f32 {n * n * 4} B")
    Za = ra.linkage
    check_linkage(Za, n, k, ra.labels, "approx")
    ari_a = adjusted_rand_index(y, ra.labels)
    ari_ad = adjusted_rand_index(dense_labels, ra.labels)
    log(f"[approx] {name} n={n} sim_k={K}: total {total_a:.3f} s, pops "
        f"{int(ta['tmfg_pops'])}, tmfg host syncs "
        f"{int(ta['tmfg_host_syncs'])}, sparse Bellman-Ford rounds "
        f"{int(ta['apsp_rounds'])}, fallbacks {int(ta['sim_fallbacks'])} "
        f"(rate {ta['sim_fallback_rate']:.4f}), pair misses "
        f"{int(ta['sim_pair_misses'])}, launches {launches_a}, peak memory "
        f"{peak_a} B beside the cached dense program ({held_a} B, evicted "
        f"by the call), {peak_a_after} B after, ARI vs generator "
        f"{ari_a:.4f}, vs dense {ari_ad:.4f}")
    Xs, ks, rep_a = X_np, k, name
    projected = (time.perf_counter() - t_start + 1.1 * total_a + PARITY_S
                 + SPARSE_S + FILTER_S + STREAM_S)
    if projected > STAGED_BUDGET_S and name != REPEAT_DATASET:
        rep_a = REPEAT_DATASET
        _, Xs, _, ks = make_ucr_like(rep_a, seed=args.seed)
        log(f"[approx] projected finish {projected:.1f} s > "
            f"{STAGED_BUDGET_S} s: the fused=False repeat runs at {rep_a} "
            f"size")
        del ra
        ra = cluster(Xs, k=ks, config=cfg_a)
        Za = ra.linkage
    ra_dir = ra.dbht.direction.cpu().numpy()
    ra_labels = ra.labels
    del ra
    torch.cuda.empty_cache()
    rs = cluster(Xs, k=ks, config=cfg_a, fused=False, collect_timings=True)
    ts = rs.timings
    us_pop_a = check_syncs(ts, "approx staged")
    same_link = bool(np.array_equal(rs.linkage, Za))
    same_merges = bool(np.array_equal(rs.linkage[:, [0, 1, 3]],
                                      Za[:, [0, 1, 3]]))
    height_diff = float(np.abs(rs.linkage[:, 2] - Za[:, 2]).max())
    # the per-cluster assembly orders equal heights of two clusters by a
    # stable sort, the one global run by its flat-argmin scan: with equal
    # sorted heights, a difference in row order lies in such ties
    same_heights = bool(np.array_equal(np.sort(rs.linkage[:, 2]),
                                       np.sort(Za[:, 2])))
    _, hcount = np.unique(Za[:, 2], return_counts=True)
    tied_rows = int(hcount[hcount > 1].sum())
    rows_differ = int((rs.linkage != Za).any(axis=1).sum())
    dir_diff = int((rs.dbht.direction.cpu().numpy() != ra_dir).sum())
    ari_fs = adjusted_rand_index(rs.labels, ra_labels)
    stages_a = {s_: ts[s_] for s_ in
                ("similarity", "tmfg", "apsp", "dbht", "hac", "total")}
    log(f"[approx] per-stage seconds (fused=False, {rep_a} n={Xs.shape[0]}):"
        f" {json.dumps(stages_a)}; tmfg {us_pop_a:.2f} us per pop over "
        f"{int(ts['tmfg_pops'])} pops, {int(ts['tmfg_host_syncs'])} host "
        f"syncs; "
        f"linkage equal to the fused run: {same_link} (merges equal: "
        f"{same_merges}, max height difference {height_diff}, rows that "
        f"differ {rows_differ}, sorted heights equal {same_heights}, rows "
        f"in tied heights {tied_rows}); ARI fused vs staged {ari_fs:.4f}; "
        f"directions that differ {dir_diff}")
    approx = dict(dataset=name, n=n, L=L, k=k, sim_k=K, total_s=total_a,
                  stages_dataset=rep_a, stages_n=int(Xs.shape[0]),
                  stages_s=stages_a, tmfg_us_per_pop=us_pop_a,
                  pops=int(ta["tmfg_pops"]),
                  tmfg_host_syncs=int(ta["tmfg_host_syncs"]),
                  bf_rounds=int(ta["apsp_rounds"]),
                  staged_pops=int(ts["tmfg_pops"]),
                  staged_host_syncs=int(ts["tmfg_host_syncs"]),
                  staged_bf_rounds=int(ts["apsp_rounds"]),
                  fallbacks=int(ta["sim_fallbacks"]),
                  fallback_rate=ta["sim_fallback_rate"],
                  pair_misses=int(ta["sim_pair_misses"]),
                  launches=launches_a, peak_bytes=peak_a,
                  peak_bytes_after_eviction=peak_a_after,
                  cached_bytes_evicted=held_a, ari=ari_a,
                  ari_vs_dense=ari_ad, staged_equal=same_link,
                  staged_merges_equal=same_merges,
                  staged_max_height_diff=height_diff,
                  staged_rows_differ=rows_differ,
                  staged_sorted_heights_equal=same_heights,
                  tied_height_rows=tied_rows,
                  ari_fused_vs_staged=ari_fs, directions_differ=dir_diff)
    del rs
    torch.cuda.empty_cache()
    log(f"[time] approx phase done at {time.perf_counter() - t_start:.1f} s")

    # ---- 6. cuda vs torch backends at n = 2000 --------------------------
    Xp, yp = make_dataset(PARITY_N, 46, 8, noise=0.5, seed=args.seed + 1)
    Xpd = torch.from_numpy(Xp).to(dev)
    Sp = ops.pearson(Xpd, backend="torch")
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
    # approx: the sparse tail through the relaxation, min-plus and
    # masked-argmax kernels against the plain path
    ac = cluster(S=Sp, config=PipelineConfig.approx(sim_k=K, backend="cuda"),
                 k=8)
    at = cluster(S=Sp, config=PipelineConfig.approx(sim_k=K,
                                                    backend="torch"), k=8)
    check(ac.dbht.hubs is not None and np.array_equal(ac.linkage, at.linkage),
          "approx: cuda and torch backends: linkage differs on one S")
    lc = cluster(Xp, config=PipelineConfig.opt(backend="cuda"), k=8).labels
    lt = cluster(Xp, config=PipelineConfig.opt(backend="torch"), k=8).labels
    ari_x = adjusted_rand_index(lc, lt)
    check(ari_x >= 0.99, f"cuda vs torch labels from X: ARI {ari_x} < 0.99")
    # at sim_k = n-1 the top-K kernel's table holds the Pearson kernel's
    # values, so the sparse TMFG is the dense OPT one, bit for bit
    dense_tm = tmfg_mod.build_tmfg(ops.pearson(Xpd, backend="cuda"), topk=64)
    table, Zp = knn.topk_pearson_and_z(Xpd, PARITY_N - 1, backend="cuda")
    sparse_tm, w_e, cnt = sparse_tmfg.build_tmfg_sparse(table, Xn=Zp)
    for f in dense_tm._fields:
        check(bool(torch.equal(getattr(dense_tm, f), getattr(sparse_tm, f))),
              f"full-K sparse TMFG differs from the dense one in {f}")
    Sc = ops.pearson(Xpd, backend="cuda")
    e_ = dense_tm.edges.long()
    check(bool(torch.equal(w_e, Sc[e_[:, 0], e_[:, 1]])),
          "full-K sparse TMFG edge weights differ from S")
    log(f"[parity] n={PARITY_N}: opt, heap and approx linkage bitwise equal "
        f"on one S; labels from X ARI {ari_x:.4f}; ARI vs generator "
        f"{adjusted_rand_index(yp, lc):.4f}; sim_k=n-1 sparse TMFG bitwise "
        f"the dense OPT TMFG ({int(dense_tm.pops)} pops, "
        f"{cnt.fallbacks} fallbacks, {cnt.pair_misses} misses)")

    log(f"[time] parity phase done at {time.perf_counter() - t_start:.1f} s")

    # ---- 7. the TMFG device loops at n = 2000 ---------------------------
    # the main path's cached loop program (T steps a CUDA-graph replay)
    # for each value source: a first run on one input, a replay on a
    # second input against the same step run eagerly on it, and a replay
    # on the first input against the first run
    from repro_torch.obs import trace as obs_trace

    def loop_inputs(Xd):
        Sq = tmfg_mod.prepare_similarity(ops.pearson(Xd, backend="cuda"))
        tq, Zq = knn.topk_pearson_and_z(Xd, K, backend="cuda")
        return {"dense, top-64 table": (Sq, tmfg_mod.candidate_table(Sq, 64)),
                "dense, full scans": (Sq, None),
                "table-first from Z": (tq.values, tq.indices, Zq)}

    def cached_run(what, inp):
        if what.startswith("table"):
            st_ = {}
            r_, w_, c_ = sparse_tmfg.sparse_lazy_tmfg(*inp, from_x=True,
                                                      stats=st_)
            return r_, st_["host_syncs"], w_, c_
        S_, tab_ = inp
        prog = tmfg_mod.dense_program(PARITY_N, 0 if tab_ is None else 64,
                                      dev)
        with prog.lock:
            prog.d.S.copy_(S_)
            if tab_ is not None:
                prog.d.table.copy_(tab_)
            return prog.run()

    def eager_run(what, inp):
        d_ = (sparse_tmfg._TableSource(*inp, True) if what.startswith("table")
              else tmfg_mod._Device(*inp))
        return tmfg_mod.lazy_build(d_)

    def same_build(a_, b_, what, against):
        for f in a_[0]._fields:
            check(bool(torch.equal(getattr(a_[0], f), getattr(b_[0], f))),
                  f"{what}: the cached program differs from {against} in {f}")
        check(bool(torch.equal(a_[2], b_[2])) and a_[3] == b_[3],
              f"{what}: edge values or counters differ from {against}")

    X2, _ = make_dataset(PARITY_N, 46, 8, noise=0.5, seed=args.seed + 2)
    inputs = (loop_inputs(Xpd), loop_inputs(torch.from_numpy(X2).to(dev)))
    loops = {}
    for what in inputs[0]:
        sync()
        t0 = time.perf_counter()
        first = cached_run(what, inputs[0][what])
        sync()
        t1 = time.perf_counter()
        with obs_trace.watch_recompiles() as w7:
            got = cached_run(what, inputs[1][what])
            sync()
            t2 = time.perf_counter()
            again = cached_run(what, inputs[0][what])
        check(w7.count == 0, f"{what}: a replay built {w7.count} programs")
        sync()
        t3 = time.perf_counter()
        want = eager_run(what, inputs[1][what])
        sync()
        t4 = time.perf_counter()
        same_build(got, want, what, "eager steps on the second input")
        same_build(again, first, what, "its first run on the first input")
        check(not torch.equal(got[2], first[2]),
              f"{what}: the two inputs gave the same edge values")
        pq = int(got[0].pops)
        check(got[1] <= math.ceil(pq / tmfg_mod.STEPS_PER_SYNC) + 3,
              f"{what}: {got[1]} host syncs for {pq} pops")
        loops[what] = dict(pops=pq, first_s=t1 - t0, replay_s=t2 - t1,
                           eager_s=t4 - t3, graph_syncs=got[1],
                           eager_syncs=want[1], fallbacks=got[3].fallbacks,
                           pair_misses=got[3].pair_misses)
    log(f"[loops] n={PARITY_N}, T={tmfg_mod.STEPS_PER_SYNC}: the cached "
        f"program's replay on a second input bitwise the eager steps, and "
        f"its replay on the first input bitwise its first run, for every "
        f"source: {json.dumps(loops)}")
    del inputs, first, got, again, want
    # CORR and PAR-10 end to end: the masked-argmax kernel in every CORR
    # step and ORIG round against masked_argmax_ref, min-plus and HAC as
    # on the other paths
    builders = {}
    for what, make in (("corr", PipelineConfig.corr),
                       ("par-10", lambda **kw: PipelineConfig.par(10, **kw))):
        ops.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        bc = cluster(S=Sp, config=make(backend="cuda"), k=8,
                     collect_timings=True)
        sync()
        t1 = time.perf_counter()
        launches_b = ops.launch_counts()
        bt = cluster(S=Sp, config=make(backend="torch"), k=8)
        check(np.array_equal(bc.linkage, bt.linkage)
              and np.array_equal(bc.labels, bt.labels),
              f"{what}: cuda and torch backends: linkage differs on one S")
        check(launches_b["masked_argmax"] >= int(bc.timings["tmfg_pops"]),
              f"{what}: masked_argmax launches {launches_b}")
        check_linkage(bc.linkage, PARITY_N, 8, bc.labels, what)
        builders[what] = dict(
            cuda_s=t1 - t0, pops=int(bc.timings["tmfg_pops"]),
            host_syncs=int(bc.timings["tmfg_host_syncs"]),
            edge_sum=bc.edge_sum, launches=launches_b,
            ari_vs_generator=adjusted_rand_index(yp, bc.labels))
    log(f"[loops] corr and par-10 bitwise equal across backends on one S: "
        f"{json.dumps(builders)}")
    log(f"[time] loop phase done at {time.perf_counter() - t_start:.1f} s")

    # ---- 8. the sparse tail and the batch entry points ------------------
    t8 = time.perf_counter()
    cfg_sp = PipelineConfig.opt().replace(apsp_method="sparse")

    def same_up_to_ties(Za, Zb, nn):
        """(equal, rows that differ in place): the two linkages hold the
        same merges (each child named by its smallest leaf and its size,
        which no two clusters of one hierarchy share) at the same
        heights, whatever the order of the rows of equal height."""
        def canon(Z_):
            lo = np.arange(2 * nn - 1)
            size = np.ones(2 * nn - 1, np.int64)
            rows = []
            for g, (a, b, hgt, _) in enumerate(Z_):
                a, b = int(a), int(b)
                lo[nn + g] = min(lo[a], lo[b])
                size[nn + g] = size[a] + size[b]
                kids = sorted([(int(lo[a]), int(size[a])),
                               (int(lo[b]), int(size[b]))])
                rows.append((float(hgt), *kids))
            return sorted(rows)
        return (canon(Za) == canon(Zb),
                int((Za != Zb).any(axis=1).sum()))

    # 8a. the staged sparse tail at full width on phase 4's Crop TMFG
    S8 = ops.pearson(torch.from_numpy(X_np).to(dev))
    sync()
    base8 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    r8 = cluster(S=S8, reuse_tmfg=tm_crop, config=cfg_sp, fused=False, k=k,
                 collect_timings=True)
    sync()
    tail_s = time.perf_counter() - t0
    launches8 = ops.launch_counts()
    tail_bytes = torch.cuda.max_memory_allocated() - base8
    check(r8.reused_tmfg and r8.dbht.hubs is not None,
          "sparse tail: not the reused TMFG's sparse tail")
    check(launches8["sparse_relax"] == int(r8.timings["apsp_rounds"]) > 0,
          f"sparse tail: sparse_relax launches {launches8} != rounds "
          f"{r8.timings['apsp_rounds']}")
    check(launches8["minplus"] >= math.ceil(n / 512),
          f"sparse tail: minplus launches {launches8} < ceil(n / 512)")
    check(launches8["masked_argmax"] > 0,
          f"sparse tail: masked_argmax launches {launches8}")
    check(launches8["pearson"] == 0 and launches8["topk"] == 0,
          f"sparse tail: pearson or topk ran {launches8}")
    # the bound is checked from a few panels' rows up, as in phase 5
    if n >= 8 * 512:
        check(tail_bytes < n * n * 4, f"sparse tail: {tail_bytes} B above "
              f"S and the TMFG >= one (n, n) f32 {n * n * 4} B")
    check_linkage(r8.linkage, n, k, r8.labels, "sparse tail")
    C8 = int(r8.dbht.converging.shape[0])
    # the fused tail on the same TMFG and edge weights
    e8 = tm_crop.edges.long()
    fz8 = fa_mod._sparse_tail(cfg_sp, n, tm_crop, S8[e8[:, 0], e8[:, 1]])
    check(not fz8["overflow"], "sparse tail: the fused tail overflowed its "
          "slot caps on the Crop TMFG")
    Zf8 = fz8["Z"].cpu().numpy()
    equal8, rows8 = same_up_to_ties(r8.linkage, Zf8, n)
    check(np.array_equal(cut_linkage(Zf8, n, k), r8.labels) and equal8,
          f"sparse tail: the fused tail's labels or merges differ from the "
          f"staged tail's ({rows8} rows differ in place)")
    ari8 = adjusted_rand_index(dense_labels, r8.labels)
    sparse_a = dict(n=n, clusters=C8, tail_s=tail_s,
                    stages_s={s_: r8.timings[s_]
                              for s_ in ("apsp", "dbht", "hac")},
                    bf_rounds=int(r8.timings["apsp_rounds"]),
                    launches=launches8, tail_bytes=tail_bytes,
                    nn_f32_bytes=n * n * 4, fused_rows_differ=rows8,
                    ari_vs_hub_tail=ari8)
    log(f"[sparse] {name} n={n}: staged sparse tail on the phase-4 TMFG "
        f"{json.dumps(sparse_a)}")
    del S8, r8, fz8, e8, tm_crop
    torch.cuda.empty_cache()

    # 8b. n = PARITY_N, at REPEAT_DATASET's n where the budget needs it
    n8 = PARITY_N
    projected = (time.perf_counter() - t_start + SPARSE_B_S + FILTER_S
                 + STREAM_S)
    if projected > STAGED_BUDGET_S:
        n8 = [e for e in UCR_SIZES if e[0] == REPEAT_DATASET][0][1]
        log(f"[sparse] projected finish {projected:.1f} s > "
            f"{STAGED_BUDGET_S} s: phase 8b runs at n={n8} "
            f"({REPEAT_DATASET} size)")
    X8 = Xp if n8 == PARITY_N else make_dataset(n8, 46, 8, noise=0.5,
                                                seed=args.seed + 1)[0]
    X8d = torch.from_numpy(X8).to(dev)
    S8t = ops.pearson(X8d, backend="torch")
    parity8 = {}

    def on_S(cfg_, be, **kw):
        return cluster(S=S8t, k=8, config=cfg_.replace(backend=be), **kw)

    def same_run(what, rc_, rt_):
        """A cuda run against the torch backend's on one S: linkage and
        labels bitwise."""
        check(np.array_equal(rc_.linkage, rt_.linkage)
              and np.array_equal(rc_.labels, rt_.labels),
              f"{what}: cuda and torch backends differ on one S")
        parity8[what] = True

    # fused against staged, from X; the staged run reruns the similarity
    # and the tail on the fused run's TMFG (the lazy builder launches no
    # kernel, so a rebuild would repeat the same steps)
    ops.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    fx = cluster(X8, k=8, config=cfg_sp, collect_timings=True)
    sync()
    fused8_s = time.perf_counter() - t0
    launches_f8 = ops.launch_counts()
    check(launches_f8["pearson"] == 1
          and launches_f8["sparse_relax"] == int(fx.timings["apsp_rounds"])
          and launches_f8["minplus"] >= math.ceil(n8 / 512)
          and launches_f8["masked_argmax"] > 0,
          f"sparse fused n={n8}: launches {launches_f8}")
    sx = cluster(X8, k=8, config=cfg_sp, fused=False, reuse_tmfg=fx.tmfg)
    eq_fs, rows_fs = same_up_to_ties(fx.linkage, sx.linkage, n8)
    check(np.array_equal(fx.labels, sx.labels) and eq_fs,
          f"sparse n={n8}: fused and staged differ ({rows_fs} rows)")
    check_linkage(fx.linkage, n8, 8, fx.labels, "sparse fused")
    # the staged tail on one S, through the kernels and the plain path
    # (the torch runs take the cuda run's TMFG), its own memory, and the
    # host oracle against it: labels bitwise and the same merges; the
    # oracle's one global run orders merges of exactly equal height in
    # two clusters by its flat scan, the tail's assembly by cluster (the
    # reference's own caveat, DESIGN.md §14.5)
    st8 = on_S(cfg_sp, "cuda", fused=False)
    same_run("opt-sparse staged", st8,
             on_S(cfg_sp, "torch", reuse_tmfg=st8.tmfg))
    sync()
    base_t8 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sr8 = on_S(cfg_sp, "cuda", reuse_tmfg=st8.tmfg)
    sync()
    peak_tail8 = torch.cuda.max_memory_allocated() - base_t8
    check(np.array_equal(sr8.linkage, st8.linkage),
          f"sparse n={n8}: the tail on a reused TMFG differs")
    cfg_ho = cfg_sp.replace(dbht_impl="host")
    ho = on_S(cfg_ho, "cuda", reuse_tmfg=st8.tmfg)
    same_run("opt-sparse host oracle", ho,
             on_S(cfg_ho, "torch", reuse_tmfg=st8.tmfg))
    eq_ho, rows_ho = same_up_to_ties(ho.linkage, st8.linkage, n8)
    check(np.array_equal(ho.labels, st8.labels) and eq_ho,
          f"host oracle n={n8}: labels or merges differ from the staged "
          f"sparse tail ({rows_ho} rows differ in place)")
    # approx with the sparse tail, fused and staged from X, the staged
    # run's peak logged: at these n one (n, n) f32 (16 MB at n = 2000) is
    # below the fixed workspaces of the top-K kernel and the lazy loop's
    # graph pool, so the bound is checked from 8 panels' rows up
    cfg_as = PipelineConfig.approx(sim_k=K, apsp_method="sparse")
    ax = cluster(X8, k=8, config=cfg_as)
    sync()
    base_a8 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    axs = cluster(X8, k=8, config=cfg_as, fused=False)
    sync()
    peak_as = torch.cuda.max_memory_allocated() - base_a8
    eq_as, rows_as = same_up_to_ties(ax.linkage, axs.linkage, n8)
    check(np.array_equal(ax.labels, axs.labels) and eq_as,
          f"approx sparse n={n8}: fused and staged differ ({rows_as} rows)")
    if n8 >= 8 * 512:
        check(peak_as < n8 * n8 * 4, f"approx sparse staged n={n8}: peak "
              f"{peak_as} B >= one (n, n) f32 {n8 * n8 * 4} B")
    # the repair: approx with a non-lazy method, fused against staged;
    # CORR's steps launch the masked-argmax kernel, so the torch run
    # builds its own TMFG
    cfg_ac = PipelineConfig.approx(sim_k=K, method="corr", topk=0)
    acf = on_S(cfg_ac, "cuda")
    same_run("approx-corr fused", acf, on_S(cfg_ac, "torch"))
    acs = on_S(cfg_ac, "cuda", fused=False)
    check(np.array_equal(acf.linkage, acs.linkage),
          f"approx corr n={n8}: fused and staged linkage differ")
    # the tree mode above hac_max = 64 (half the largest cluster where
    # none is that large), on the staged run's TMFG
    tm8 = st8.tmfg
    big8 = int(np.bincount(st8.dbht.cluster_of.cpu().numpy()).max())
    hac_max8 = 64 if big8 > 64 else max(1, big8 // 2)
    trees = {}
    for be in ("cuda", "torch"):
        rt8 = sparse_dbht.dbht_sparse(S8t, tm8, backend=be, hac_max=hac_max8)
        trees[be] = rt8.linkage.cpu().numpy()
    Zt8 = trees["cuda"]
    refs8 = np.sort(np.concatenate([Zt8[:, 0], Zt8[:, 1]]).astype(np.int64))
    check(Zt8.shape == (n8 - 1, 4) and np.array_equal(refs8,
                                                      np.arange(2 * n8 - 2))
          and bool(np.isfinite(Zt8).all()) and int(Zt8[-1, 3]) == n8,
          f"tree mode n={n8}: not a full dendrogram")
    check(np.array_equal(Zt8, trees["torch"]),
          f"tree mode n={n8}: cuda and torch backends differ")
    parity8["tree mode"] = True
    # cluster_batch: each entry the single cluster(X[b])
    Xb8 = np.stack([X8] + [make_dataset(n8, 46, 8, noise=0.5,
                                        seed=args.seed + 2 + b)[0]
                           for b in range(3)])
    # OPT in full; the sparse batch with limit=2, its other two entries
    # pads that run on the device only
    batch8 = {}
    for what, cfg_b, lim in (("opt", PipelineConfig.opt(), None),
                             ("opt-sparse", cfg_sp, 2)):
        sync()
        t0 = time.perf_counter()
        bb = cluster_batch(Xb8, k=8, config=cfg_b, limit=lim)
        sync()
        batch8[what] = time.perf_counter() - t0
        check(len(bb) == (lim or 4) and bb.labels.shape == (lim or 4, n8),
              f"cluster_batch {what} limit={lim}: {len(bb)} results")
        for b in range(lim or 4):
            one = (fx if what == "opt-sparse" and b == 0 else
                   cluster(Xb8[b], k=8, config=cfg_b))
            check(np.array_equal(bb[b].linkage, one.linkage)
                  and np.array_equal(bb.labels[b], one.labels),
                  f"cluster_batch {what} entry {b} differs from cluster()")
    sparse_b = dict(n=n8, fused_s=fused8_s, launches=launches_f8,
                    fused_staged_rows_differ=rows_fs,
                    host_staged_rows_differ=rows_ho,
                    approx_fused_staged_rows_differ=rows_as,
                    approx_staged_peak_bytes=peak_as,
                    staged_tail_peak_bytes=peak_tail8,
                    nn_f32_bytes=n8 * n8 * 4,
                    tree_largest_cluster=big8, tree_hac_max=hac_max8,
                    batch_s=batch8,
                    backends_bitwise=parity8)
    sparse_s = time.perf_counter() - t8
    log(f"[sparse] n={n8}: {json.dumps(sparse_b)}")
    log(f"[time] sparse phase done at {time.perf_counter() - t_start:.1f} s"
        f" ({sparse_s:.1f} s)")

    # ---- 9. the filters and the sketch pools ----------------------------
    t9 = time.perf_counter()
    X = torch.from_numpy(X_np).to(dev)

    def union_find_tree(E_, nn):
        """Whether the (nn - 1, 2) host edges form a spanning tree."""
        par = list(range(nn))

        def find(x):
            while par[x] != x:
                par[x] = par[par[x]]
                x = par[x]
            return x
        for a, b in E_:
            ra, rb = find(int(a)), find(int(b))
            if ra == rb:
                return False
            par[ra] = rb
        return len(E_) == nn - 1

    # 9a. at full width on phase 4's X: the MST with RMT cleaning and the
    # AG, fused, counts reset just before and read just after each
    filt_runs, filt_launches = {}, {}
    for what, cfg9 in (("mst-rmt", PipelineConfig.mst(clean="rmt")),
                       ("ag", PipelineConfig.opt().replace(filter="ag"))):
        sync()
        base9 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        r9 = cluster(X_np, k=k, config=cfg9, collect_timings=True)
        sync()
        run_s = time.perf_counter() - t0
        l9 = ops.launch_counts()
        peak9 = torch.cuda.max_memory_allocated() - base9
        t9m = r9.timings
        E9 = r9.tmfg.edges.long()
        m9 = n - 1 if cfg9.filter == "mst" else 3 * n - 6
        check(tuple(E9.shape) == (m9, 2)
              and bool((E9[:, 0] < E9[:, 1]).all())
              and int(torch.unique(E9[:, 0] * n + E9[:, 1]).numel()) == m9,
              f"{what}: not {m9} distinct canonical edges")
        extra = {}
        if cfg9.filter == "mst":
            check(union_find_tree(E9.cpu().numpy().tolist(), n),
                  f"{what}: the edges are not a spanning tree")
        else:
            # the m-th weight is >= every unpicked upper-triangle entry:
            # S is bitwise symmetric (phase 2), so the upper triangle's
            # count above it is half the off-diagonal count
            S9 = ops.pearson(X)
            wm = r9.tmfg.weights.min()
            above = int((S9 > wm).sum()) - int((S9.diagonal() > wm).sum())
            check(above % 2 == 0 and above // 2
                  == int((r9.tmfg.weights > wm).sum()),
                  f"{what}: an unpicked pair lies above the {m9}-th weight")
            extra["components"] = int(r9.dbht.converging.shape[0])
            del S9
        check(l9["pearson"] == 1, f"{what}: pearson launches {l9}")
        check(l9["masked_argmax"] == n - 1,
              f"{what}: masked_argmax launches {l9} != n-1 = {n - 1}")
        check(l9["sparse_relax"] == int(t9m["apsp_rounds"]) > 0,
              f"{what}: sparse_relax launches {l9} != Bellman-Ford rounds "
              f"{t9m['apsp_rounds']}")
        check(l9["minplus"] >= 1 and l9["topk"] == 0,
              f"{what}: launches {l9}")
        check_linkage(r9.linkage, n, k, r9.labels, what)
        filt_launches[what] = l9
        filt_runs[what] = dict(
            total_s=run_s, stages_s={s_: t9m[s_] for s_ in (
                "similarity", "clean", "tmfg", "apsp", "dbht", "hac")
                if s_ in t9m},
            tail_s=t9m["apsp"] + t9m["dbht"] + t9m["hac"],
            bf_rounds=int(t9m["apsp_rounds"]),
            mst_rounds=int(t9m.get("mst_rounds", 0)), launches=l9,
            peak_bytes=peak9, edge_sum=r9.edge_sum,
            ari=adjusted_rand_index(y, r9.labels),
            ari_vs_dense=adjusted_rand_index(dense_labels, r9.labels),
            **extra)
        log(f"[filters] {name} n={n} {what}: {json.dumps(filt_runs[what])}")
        del r9, E9
        torch.cuda.empty_cache()

    # the sketch pools and their exact rescoring at full width, against
    # the exact top-K table (phase 5's table, the top-K kernel at (n, L))
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pools = project.candidate_pools(X, POOL, dim=POOL_DIM, seed=args.seed)
    sync()
    pools_s = time.perf_counter() - t0
    l_pool = ops.launch_counts()
    check(l_pool["topk"] == 1 and sum(l_pool.values()) == 1,
          f"candidate_pools: launches {l_pool}")
    check(tuple(pools.shape) == (n, POOL) and not bool(
        (pools == torch.arange(n, device=dev)[:, None]).any()),
          "candidate_pools: wrong shape or a self-candidate")
    t0 = time.perf_counter()
    table9 = knn.rescore_pools(X, pools, K)
    sync()
    rescore_s = time.perf_counter() - t0
    _, exact_i = topk_pearson_cuda(X, K)
    hits = sum(int((table9.indices[r0:r0 + 2048, :, None]
                    == exact_i[r0:r0 + 2048, None, :]).any(-1).sum())
               for r0 in range(0, n, 2048))
    recall9 = hits / (n * K)
    # the rescored values are the exact Pearson values of their pairs,
    # value descending (checked on the first rows)
    Zs = ref.standardize_rows(X)
    r_chk = table9.indices[:2048].long()
    v_chk = torch.clamp((Zs[:2048, None, :] * Zs[r_chk]).sum(-1), -1.0, 1.0)
    err9 = float((v_chk - table9.values[:2048]).abs().max())
    check(err9 <= 1e-5 and bool((table9.values[:, :-1]
                                 >= table9.values[:, 1:]).all()),
          f"rescored pools: values off the exact Pearson by {err9}, or "
          f"not descending")
    del Zs, r_chk, v_chk
    filt_launches["pools"] = l_pool
    # the top-K kernel at the sketch's shape, timed
    sk9 = project.sketch(X, dim=POOL_DIM, seed=args.seed)
    b_ms, b_by = bound(4 * (n * POOL_DIM + 2 * n) + 8 * n * POOL,
                       n * (n + 1) * POOL_DIM)
    entries["topk"]["at_sketch"] = dict(
        shape=[n, POOL_DIM, POOL],
        ms=cuda_ms(lambda: topk_pearson_cuda(sk9, POOL), 5),
        plain_ms=cuda_ms(lambda: ref.topk_pearson_ref(sk9, POOL), 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    pools_a = dict(n=n, pool=POOL, dim=POOL_DIM, k=K, pools_s=pools_s,
                   rescore_s=rescore_s, index_recall_vs_exact=recall9,
                   rescore_max_abs_err=err9,
                   launches=l_pool, topk_at_sketch=entries["topk"][
                       "at_sketch"])
    log(f"[filters] {name} n={n} pools: {json.dumps(pools_a)}")
    del pools, table9, exact_i, sk9, X
    torch.cuda.empty_cache()
    log(f"[time] filters (a) done at {time.perf_counter() - t_start:.1f} s")

    # 9b. n = PARITY_N, at REPEAT_DATASET's n where the budget needs it
    n9 = PARITY_N
    projected = time.perf_counter() - t_start + FILTER_B_S + STREAM_S
    if projected > STAGED_BUDGET_S:
        n9 = [e for e in UCR_SIZES if e[0] == REPEAT_DATASET][0][1]
        log(f"[filters] projected finish {projected:.1f} s > "
            f"{STAGED_BUDGET_S} s: phase 9b runs at n={n9} "
            f"({REPEAT_DATASET} size)")
    X9 = Xp if n9 == PARITY_N else make_dataset(n9, 46, 8, noise=0.5,
                                                seed=args.seed + 1)[0]
    X9d = torch.from_numpy(X9).to(dev)
    S9t = ops.pearson(X9d, backend="torch")
    P9 = PipelineConfig
    cfgs9 = {"mst": P9.mst(), "ag": P9.opt().replace(filter="ag"),
             "mst-rmt": P9.mst(clean="rmt"),
             "ag-rmt": P9.opt().replace(filter="ag", clean="rmt"),
             "tmfg-rmt": P9.opt(clean="rmt")}
    # fused against staged from X, bitwise
    for what, cfg9 in cfgs9.items():
        f9 = cluster(X9, k=8, config=cfg9)
        s9 = cluster(X9, k=8, config=cfg9, fused=False)
        check(np.array_equal(f9.linkage, s9.linkage)
              and np.array_equal(f9.labels, s9.labels),
              f"{what} n={n9}: fused and staged differ")
        check_linkage(f9.linkage, n9, 8, f9.labels, f"{what} n={n9}")
    # the cuda backend against the torch backend on one S, for each
    # filter under each APSP method
    back9 = {}
    for what in ("mst", "ag"):
        for am in ("exact", "hub", "sparse"):
            cfg9 = cfgs9[what].replace(apsp_method=am)
            ops.reset_launch_counts()
            rc9 = cluster(S=S9t, k=8, config=cfg9.replace(backend="cuda"))
            lc9 = ops.launch_counts()
            rt9 = cluster(S=S9t, k=8, config=cfg9.replace(backend="torch"))
            check(np.array_equal(rc9.linkage, rt9.linkage)
                  and np.array_equal(rc9.labels, rt9.labels)
                  and bool(torch.equal(rc9.tmfg.edges, rt9.tmfg.edges)),
                  f"{what} {am} n={n9}: cuda and torch backends differ on "
                  f"one S")
            check(lc9["masked_argmax"] == n9 - 1 and lc9["minplus"] >= 1
                  and (lc9["sparse_relax"] > 0) == (am != "exact"),
                  f"{what} {am} n={n9}: launches {lc9}")
            back9[f"{what}-{am}"] = lc9
    # cluster_batch on 4 series sets, each entry the single cluster(X[b])
    Xb9 = np.stack([X9] + [make_dataset(n9, 46, 8, noise=0.5,
                                        seed=args.seed + 2 + b)[0]
                           for b in range(3)])
    batch9 = {}
    for what in ("mst", "ag"):
        sync()
        t0 = time.perf_counter()
        bb9 = cluster_batch(Xb9, k=8, config=cfgs9[what])
        sync()
        batch9[what] = time.perf_counter() - t0
        for b in range(4):
            one = cluster(Xb9[b], k=8, config=cfgs9[what])
            check(np.array_equal(bb9[b].linkage, one.linkage)
                  and np.array_equal(bb9.labels[b], one.labels),
                  f"cluster_batch {what} entry {b} differs from cluster()")
    # candidate_pools on the card against the same call on the CPU: one R
    # (the seed's threefry stream, drawn on the host); the card's pools a
    # stable top-k of the Pearson kernel's rows of its sketch; the CPU's
    # sketch rounds otherwise in the last bits, which can reorder a
    # near-tie
    pc9 = project.candidate_pools(X9d, POOL, dim=POOL_DIM, seed=args.seed)
    pt9 = project.candidate_pools(torch.from_numpy(X9), POOL, dim=POOL_DIM,
                                  seed=args.seed)
    sk9 = project.sketch(X9d, dim=POOL_DIM, seed=args.seed)
    sk_err = float((sk9.cpu() - project.sketch(
        torch.from_numpy(X9), dim=POOL_DIM, seed=args.seed)).abs().max())
    P9s = pearson_cuda(sk9)
    P9s.fill_diagonal_(float("-inf"))
    want9 = torch.sort(P9s, dim=1, descending=True, stable=True)[1]
    check(bool(torch.equal(pc9, want9[:, :POOL].int())),
          f"candidate_pools n={n9}: not a stable top-k of the sketch's "
          f"Pearson kernel rows")
    pools_equal = bool(torch.equal(pc9.cpu(), pt9))
    rows_differ9 = int((pc9.cpu() != pt9).any(dim=1).sum())
    same9 = sum(len(set(a) & set(b)) for a, b in zip(
        pc9.cpu().numpy().tolist(), pt9.numpy().tolist()))
    check(sk_err <= 1e-5 and same9 >= 0.999 * n9 * POOL,
          f"candidate_pools n={n9}: card and CPU differ (sketch "
          f"{sk_err}, {same9} of {n9 * POOL} candidates shared)")
    del P9s, want9, sk9
    q9 = compare_to_dense(X9, sim_k=K, k=8)
    filters_b = dict(n=n9, fused_staged_bitwise=sorted(cfgs9),
                     backends_bitwise=back9, batch_s=batch9,
                     pools_card_cpu_equal=pools_equal,
                     pools_rows_differ=rows_differ9,
                     pools_shared=same9, sketch_max_abs_err=sk_err,
                     compare_to_dense=q9)
    filter_s = time.perf_counter() - t9
    log(f"[filters] n={n9}: {json.dumps(filters_b)}")
    log(f"[time] filter phase done at {time.perf_counter() - t_start:.1f} s"
        f" ({filter_s:.1f} s)")

    # ---- 10. the streaming tier ----------------------------------------
    import shutil

    from repro_torch import obs
    from repro_torch.stream import AdmissionConfig, ClusterService
    from repro_torch.stream import scheduler as sched_mod
    from repro_torch.stream import window as win

    t10 = time.perf_counter()
    n10 = STREAM_N
    projected = time.perf_counter() - t_start + STREAM_S
    if projected > STAGED_BUDGET_S:
        n10 = STREAM_N_SMALL
        log(f"[stream] projected finish {projected:.1f} s > "
            f"{STAGED_BUDGET_S} s: phase 10 runs at n={n10}")
    X10, _ = make_dataset(n10, STREAM_W + STREAM_EVERY + STREAM_TICKS, 4,
                          noise=0.7, seed=1)
    cfg10 = PipelineConfig.opt()
    svc = ClusterService(n=n10, window=STREAM_W, k=4, config=cfg10,
                         recluster_every=STREAM_EVERY)
    check(svc.state.buf.is_cuda, "stream: the window state is not on the "
          "card")
    # fill the window, recluster it, then one warm-up cadence
    t0 = time.perf_counter()
    for t_ in range(STREAM_W):
        svc.tick(X10[:, t_])
    svc.recluster()
    for t_ in range(STREAM_W, STREAM_W + STREAM_EVERY):
        req = svc.tick(X10[:, t_])
        if req is not None and not req.done:
            svc.drain()
    sync()
    warm_s = time.perf_counter() - t0
    # the steady state: STREAM_TICKS ticks, a recluster every STREAM_EVERY
    hits0 = jitcache.stats()["hits"]
    warm0 = svc.warm_hits
    tick_s, recl_s = [], []
    t0 = time.perf_counter()
    with obs_trace.watch_recompiles() as w10:
        for t_ in range(STREAM_W + STREAM_EVERY,
                        STREAM_W + STREAM_EVERY + STREAM_TICKS):
            a = time.perf_counter()
            req = svc.tick(X10[:, t_])
            if req is None:
                tick_s.append(time.perf_counter() - a)
                continue
            if not req.done:
                svc.drain()
            check(req.done and req.result.labels.shape == (n10,),
                  "stream: a recluster did not resolve")
            recl_s.append(time.perf_counter() - a)
    sync()
    steady_s = time.perf_counter() - t0
    check(w10.count == 0 and w10.recompile_events == 0,
          f"stream: {w10.count} programs built, {w10.recompile_events} "
          f"watchdog alarms in the steady state")
    check(len(recl_s) == STREAM_TICKS // STREAM_EVERY,
          f"stream: {len(recl_s)} reclusters in {STREAM_TICKS} ticks")
    check(svc.healthz()["status"] == "ok", f"stream: {svc.healthz()}")
    svc_hits = jitcache.stats()["hits"] - hits0
    prog10 = tmfg_mod.dense_program(n10, tmfg_mod.table_width(cfg10.topk,
                                                              n10), dev)
    prog_info = dict(program_capture_ms=prog10.capture_s * 1e3,
                     program_build_ms=prog10.build_s * 1e3,
                     program_bytes=prog10.nbytes(), program_runs=prog10.runs)
    del prog10                         # clear_compiled() below frees it
    # the co-moment similarity against the Pearson kernel on the window
    st10 = svc._flush_ticks()
    # the push alone: one block of STREAM_EVERY ticks on the card
    blk = X10[:, -STREAM_EVERY:]
    win.window_push_block(st10, blk)
    sync()
    a = time.perf_counter()
    win.window_push_block(st10, blk)
    sync()
    push_us = (time.perf_counter() - a) / STREAM_EVERY * 1e6
    Sw = win.window_similarity(st10)
    Pw = pearson_cuda(torch.from_numpy(win.materialize(st10).copy()).to(dev))
    win_err = float((Sw - Pw).abs().max())
    check(win_err <= 1e-5, f"stream: window_similarity differs from the "
          f"Pearson kernel by {win_err}")
    # cluster(moments=) fused is bitwise cluster(S=window_similarity)
    rm = cluster(moments=st10, k=4, config=cfg10)
    rs10 = cluster(S=Sw, k=4, config=cfg10)
    check(np.array_equal(rm.linkage, rs10.linkage)
          and np.array_equal(rm.labels, rs10.labels),
          "stream: cluster(moments=) differs from cluster(S=)")
    # a replayed run_pipeline_device builds nothing; clear_compiled()
    # gives the programs' memory back
    run_pipeline_device(Sw, cfg10, is_similarity=True)
    with obs_trace.watch_recompiles() as w_rpd:
        out10 = run_pipeline_device(Sw, cfg10, is_similarity=True)
    sync()
    check(w_rpd.count == 0, f"stream: a replayed run_pipeline_device "
          f"built {w_rpd.count} programs")
    check(bool(torch.equal(out10.linkage.cpu(),
                           torch.from_numpy(rs10.linkage))),
          "stream: run_pipeline_device's linkage differs from cluster()'s")
    del out10, rm, rs10
    cache_bytes10 = jitcache.nbytes()
    mem_held10 = torch.cuda.memory_allocated()
    clear_compiled()
    mem_cleared10 = torch.cuda.memory_allocated()
    check(mem_cleared10 < mem_held10, f"stream: clear_compiled() left "
          f"{mem_cleared10} of {mem_held10} B allocated")

    # the admission front door at ADMISSION_N: a scripted primary-lane
    # failure run opens the breaker; the degraded lane answers
    class Clock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            return self.t

    clk = Clock()
    real_batch = sched_mod.pipeline.cluster_batch
    fails = {"left": 2, "calls": 0}

    def flaky_batch(*a_, **kw_):
        fails["calls"] += 1
        if fails["left"] > 0:
            fails["left"] -= 1
            raise RuntimeError("scripted compute failure")
        return real_batch(*a_, **kw_)

    pool = [ops.pearson(torch.from_numpy(make_dataset(
        ADMISSION_N, 64, 4, noise=0.7, seed=40 + i)[0]).to(dev)).cpu()
        .numpy() for i in range(4)]
    asvc = ClusterService(n=ADMISSION_N, window=64, k=4, max_batch=2,
                          admission=AdmissionConfig(
                              breaker_failures=2, breaker_cooldown=5.0,
                              degraded_sim_k=16),
                          clock=clk)
    sched_mod.pipeline.cluster_batch = flaky_batch
    try:
        tk = [asvc.submit(pool[0])]
        asvc.drain()
        tk.append(asvc.submit(pool[1]))
        asvc.drain()
        check(asvc.admission.breaker.state == "open",
              f"admission: breaker {asvc.admission.breaker.state} after "
              f"two failures")
        h10 = asvc.healthz()
        check(h10["status"] == "degraded" and h10["breaker"] == "open",
              f"admission: healthz {h10}")
        tk.append(asvc.submit(pool[2]))
        check(all(t_.done and t_.degraded and t_.mode == "approx"
                  and t_.result.labels.shape == (ADMISSION_N,)
                  for t_ in tk), "admission: the degraded lane did not "
              "answer with labels")
        clk.t += 5.0
        tk.append(asvc.submit(pool[3]))
        asvc.drain()
        check(tk[-1].done and not tk[-1].degraded
              and asvc.admission.breaker.state == "closed",
              "admission: the half-open probe did not close the breaker")
    finally:
        sched_mod.pipeline.cluster_batch = real_batch
    adm10 = dict(n=ADMISSION_N, healthz_open=h10,
                 degraded_modes=[t_.mode for t_ in tk[:3]],
                 primary_calls=fails["calls"],
                 stats=asvc.admission.stats())

    # profile() writes a trace file (of a small call: the trace holds
    # every launch); the fused cluster() with tracing off waits no more
    # often than with the tracer's hooks stubbed out
    Sa = torch.from_numpy(pool[0]).to(dev)
    prof_dir = HERE / "build" / "obs-profile"
    with obs.profile(str(prof_dir)) as prof:
        cluster(S=Sa[:64, :64].contiguous(), k=4, config=cfg10)
    prof_bytes = Path(prof.trace_path).stat().st_size
    shutil.rmtree(prof_dir, ignore_errors=True)
    check(prof_bytes > 0, "profile(): empty trace file")
    n_spans = len(obs_trace.spans())
    obs_trace.clear()

    # a replayed fused cluster() with tracing off: its waits counted
    # through the one wait function and torch's synchronize calls (the
    # linkage's download is a copy, not one of these)
    waits = {"device_wait": 0, "synchronize": 0}

    def counted(fn, what):
        def inner(*a_, **kw_):
            waits[what] += 1
            return fn(*a_, **kw_)
        return inner

    cluster(S=Sa, k=4, config=cfg10)
    check(not obs_trace.enabled(), "stream: tracing is on")
    saved = (torch.cuda.synchronize, torch.cuda.Stream.synchronize,
             torch.cuda.Event.synchronize, obs_trace.device_wait)
    torch.cuda.synchronize = counted(saved[0], "synchronize")
    torch.cuda.Stream.synchronize = counted(saved[1], "synchronize")
    torch.cuda.Event.synchronize = counted(saved[2], "synchronize")
    obs_trace.device_wait = counted(saved[3], "device_wait")
    try:
        cluster(S=Sa, k=4, config=cfg10)
    finally:
        (torch.cuda.synchronize, torch.cuda.Stream.synchronize,
         torch.cuda.Event.synchronize, obs_trace.device_wait) = saved
    check(waits == {"device_wait": 0, "synchronize": 0},
          f"stream: the fused cluster() with tracing off waits {waits}")
    render_lines = len(obs.render().splitlines())
    stream_s = time.perf_counter() - t10
    stream = dict(
        n=n10, window=STREAM_W, every=STREAM_EVERY, ticks=STREAM_TICKS,
        warmup_s=warm_s, steady_s=steady_s,
        us_per_tick=steady_s / STREAM_TICKS * 1e6,
        us_per_buffered_tick=float(np.mean(tick_s)) * 1e6,
        push_us_per_tick=push_us,
        ms_per_recluster=float(np.mean(recl_s)) * 1e3,
        reclusters=len(recl_s), warm_hits=svc.warm_hits - warm0,
        programs_built_steady=w10.count, jitcache_hits_steady=svc_hits,
        watchdog_alarms_steady=w10.recompile_events,
        **prog_info,
        window_sim_max_abs_err=win_err,
        jitcache_bytes_before_clear=cache_bytes10,
        allocated_before_clear=mem_held10,
        allocated_after_clear=mem_cleared10,
        admission=adm10, profile_trace_bytes=prof_bytes,
        profile_spans=n_spans, waits_tracing_off=waits,
        render_lines=render_lines,
        phase_s=stream_s)
    del svc, asvc, st10, Sw, Pw, Sa
    torch.cuda.empty_cache()
    log(f"[stream] n={n10}: {json.dumps(stream)}")
    log(f"[time] stream phase done at {time.perf_counter() - t_start:.1f} s"
        f" ({stream_s:.1f} s)")

    # ---- 11. the multi-device funnel (a world-1 NCCL group) -------------
    import torch.distributed as tdist

    from repro_torch.core import distributed as dist_mod
    from repro_torch.core import integration
    from repro_torch.core.apsp import apsp_hub, edge_lengths
    from repro_torch.dist import sharding as dist_sh

    t11 = time.perf_counter()
    mesh = dist_sh.data_mesh()
    check(tdist.get_backend() == "nccl" and tdist.get_world_size() == 1
          and mesh.size() == 1, f"mesh: {mesh}, backend "
          f"{tdist.get_backend()}, world {tdist.get_world_size()}")

    # 11a. the approx funnel at full width: the row-range top-K table,
    # then the single-device approx body after it
    Xd = torch.from_numpy(X_np).to(dev)
    tv1, ti1 = topk_pearson_cuda(Xd, K)
    sv11, si11, z11 = dist_sh.topk_pearson_sharded(Xd, K, mesh)
    check(bool(torch.equal(sv11.full_tensor(), tv1))
          and bool(torch.equal(si11.full_tensor(), ti1)),
          "mesh: the sharded top-K table differs from the single-device "
          "kernel's")
    del sv11, si11, z11
    # a row range alone: a quarter of the rows, bitwise those rows
    q0, qn = n // 4, n // 4
    qv, qi = topk_pearson_cuda(Xd, K, row_range=(q0, qn))
    check(bool(torch.equal(qv, tv1[q0:q0 + qn]))
          and bool(torch.equal(qi, ti1[q0:q0 + qn])),
          f"mesh: top-K rows {q0}..{q0 + qn} differ from the whole launch")
    qb_ms, qb_by = bound(4 * (n * L + 2 * n) + 8 * qn * K, 2 * qn * n * L)
    entries["topk"]["row_range"] = dict(
        rows=[q0, qn], ms=cuda_ms(lambda: topk_pearson_cuda(
            Xd, K, row_range=(q0, qn)), 5), bound_ms=qb_ms, bound_by=qb_by,
        bitwise=True)
    del qv, qi, tv1, ti1, Xd
    torch.cuda.empty_cache()
    # the funnel itself at the dataset's size, bitwise phase 5's fused run,
    # unless the projected finish (phase 11 and phase 12 still to come)
    # passes the budget: then at n = PARITY_N, bitwise a single-device run
    # there (at world size 1 the two calls are the same program)
    na, Xa_np, ka = n, X_np, k
    Za_ref, labels_a_ref = Z5, labels5
    projected = time.perf_counter() - t_start + MESH_S + ZOO_S
    if projected > STAGED_BUDGET_S:
        na, ka = PARITY_N, 8
        Xa_np, _ = make_dataset(na, 46, 8, noise=0.5, seed=args.seed + 1)
        log(f"[mesh] projected finish {projected:.1f} s > "
            f"{STAGED_BUDGET_S} s: the approx funnel runs at n={na}")
        ra_ref = cluster(Xa_np, k=ka, config=cfg_a)
        Za_ref, labels_a_ref = ra_ref.linkage, ra_ref.labels
        del ra_ref
    sync()
    base_m = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rm11 = cluster(Xa_np, k=ka, config=cfg_a, mesh=mesh,
                   collect_timings=True)
    sync()
    mesh_a_s = time.perf_counter() - t0
    launches_m = ops.launch_counts()
    peak_m = torch.cuda.max_memory_allocated() - base_m
    tm11 = rm11.timings
    check_syncs(tm11, "mesh approx")
    check("tmfg" not in tm11 and rm11.dbht.hubs is not None,
          "mesh approx: the fused run overflowed its slot caps")
    check(launches_m["topk"] == 1, f"mesh approx: topk launches {launches_m}")
    check(launches_m["sparse_relax"] == int(tm11["apsp_rounds"]) > 0,
          f"mesh approx: sparse_relax launches {launches_m} != rounds "
          f"{tm11['apsp_rounds']}")
    check(launches_m["masked_argmax"] > 0 and launches_m["pearson"] == 0,
          f"mesh approx: launches {launches_m}")
    check(np.array_equal(rm11.linkage, Za_ref)
          and np.array_equal(rm11.labels, labels_a_ref),
          f"mesh approx: linkage or labels differ from the single-device "
          f"fused run (n={na})")
    mesh_a = dict(n=na, sim_k=K, total_s=mesh_a_s, phase5_total_s=total_a,
                  pops=int(tm11["tmfg_pops"]),
                  tmfg_host_syncs=int(tm11["tmfg_host_syncs"]),
                  bf_rounds=int(tm11["apsp_rounds"]), launches=launches_m,
                  peak_bytes=peak_m, allocated_before=base_m,
                  bitwise_table=True, bitwise_single=True)
    log(f"[mesh] approx funnel: {json.dumps(mesh_a)}")
    log(f"[time] mesh 11a done at {time.perf_counter() - t_start:.1f} s"
        f" ({time.perf_counter() - t11:.1f} s into phase 11)")
    del rm11, Xa_np
    torch.cuda.empty_cache()

    # 11b. the dense funnel on the Pearson kernel's S, at the dataset's
    # size unless the projected finish passes the budget (then PARITY_N)
    nb = n
    projected = (time.perf_counter() - t_start
                 + MESH_DENSE_PER_DENSE * total + MESH_S / 3)
    if projected > STAGED_BUDGET_S:
        nb = PARITY_N
        log(f"[mesh] projected finish {projected:.1f} s > "
            f"{STAGED_BUDGET_S} s: the dense funnel runs at n={nb}")
    if nb == n:
        Xb_np, kb = X_np, k
    else:
        Xb_np, _ = make_dataset(nb, 46, 8, noise=0.5, seed=args.seed + 1)
        kb = 8
    Sb = ops.pearson(torch.from_numpy(Xb_np).to(dev))
    if nb == n:
        Zb_ref, tmb_ref = Z4, tm4
    else:
        rb = cluster(S=Sb, k=kb, config=cfg)
        Zb_ref, tmb_ref = rb.linkage, rb.tmfg
        del rb
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rd11 = cluster(S=Sb, k=kb, config=cfg, mesh=mesh, collect_timings=True)
    sync()
    mesh_b_s = time.perf_counter() - t0
    launches_mb = ops.launch_counts()
    check_syncs(rd11.timings, "mesh dense")
    check(np.array_equal(rd11.linkage, Zb_ref),
          f"mesh dense: linkage differs from the single-device run (n={nb})")
    check(all(bool(torch.equal(a_, b_)) for a_, b_ in zip(rd11.tmfg,
                                                         tmb_ref)),
          f"mesh dense: TMFG differs from the single-device run (n={nb})")
    check(launches_mb["pearson"] == 0 and launches_mb["minplus"] >= 2
          and launches_mb["masked_argmax"] == nb - 1,
          f"mesh dense: launches {launches_mb}")
    del rd11
    # the two TMFG loops at this n, one after the other: the sharded one
    # (a column block, collectives inside the captured steps), a replay
    # of the program the funnel built, and the single-device dense
    # program (the top-64 table)
    prog_sh = dist_mod.sharded_program(nb, mesh, dev=dev)
    sync()
    t0 = time.perf_counter()
    with obs_trace.watch_recompiles() as w11:
        tsh, syncs_sh = dist_mod.build_sharded(Sb, mesh)
    sync()
    sh_s = time.perf_counter() - t0
    check(w11.count == 0 and prog_sh.runs >= 2,
          f"mesh dense: the replayed sharded loop built {w11.count} "
          f"programs ({prog_sh.runs} runs)")
    t0 = time.perf_counter()
    tsd, syncs_sd = tmfg_mod._build(Sb, "lazy", cfg.prefix, cfg.topk,
                                    cfg.backend)
    sync()
    sd_s = time.perf_counter() - t0
    check(bool(torch.equal(tsh.insert_order, tsd.insert_order))
          and int(tsh.pops) == int(tsd.pops),
          "mesh dense: the sharded loop's insertion order differs")
    pops_b = int(tsd.pops)
    for syncs_, what in ((syncs_sh, "sharded loop"), (syncs_sd, "loop")):
        check_syncs(dict(tmfg_pops=pops_b, tmfg_host_syncs=syncs_), what)
    mesh_b = dict(n=nb, total_s=mesh_b_s, launches=launches_mb,
                  pops=pops_b, sharded_tmfg_s=sh_s,
                  sharded_us_per_pop=1e6 * sh_s / pops_b,
                  sharded_host_syncs=syncs_sh,
                  sharded_build_s=prog_sh.build_s,
                  sharded_capture_s=prog_sh.capture_s, single_tmfg_s=sd_s,
                  single_us_per_pop=1e6 * sd_s / pops_b,
                  single_host_syncs=syncs_sd,
                  phase4_host_syncs=int(t["tmfg_host_syncs"]),
                  phase4_staged_us_per_pop=us_pop, phase4_stages_n=int(
                      Xr.shape[0]), bitwise_single=True)
    log(f"[mesh] dense funnel: {json.dumps(mesh_b)}")
    log(f"[time] mesh 11b done at {time.perf_counter() - t_start:.1f} s"
        f" ({time.perf_counter() - t11:.1f} s into phase 11)")
    del tsh, tsd, prog_sh
    torch.cuda.empty_cache()

    # 11c. n = PARITY_N: the sharded entry points against the kernels
    Xc_np, _ = make_dataset(PARITY_N, 46, 8, noise=0.5, seed=args.seed + 1)
    Xc = torch.from_numpy(Xc_np).to(dev)
    Sc = pearson_cuda(Xc)
    err_p = float((dist_sh.pearson_shardmap(Xc, mesh).full_tensor()
                   - Sc).abs().max())
    check(err_p <= 1e-5, f"mesh: pearson_shardmap differs from the Pearson "
          f"kernel by {err_p} > 1e-5")
    Am, Bm = dist(PARITY_N, PARITY_N), dist(PARITY_N, PARITY_N)
    check(bool(torch.equal(dist_sh.minplus_shardmap(Am, Bm, mesh)
                           .full_tensor(), minplus_cuda(Am, Bm))),
          "mesh: minplus_shardmap differs from the min-plus kernel")
    mk = torch.rand(PARITY_N, generator=gen, device=dev) < 0.5
    sv_, si_ = dist_sh.masked_argmax_shardmap(Sc, mk, mesh)
    kv_, ki_ = masked_argmax_cuda(Sc, mk)
    check(bool(torch.equal(sv_.full_tensor(), kv_))
          and bool(torch.equal(si_.full_tensor(), ki_)),
          "mesh: masked_argmax_shardmap differs from the kernel")
    del Am, Bm, sv_, si_, kv_, ki_
    tmc, _ = tmfg_mod._build(Sc, "lazy", cfg.prefix, cfg.topk, cfg.backend)
    Wc = edge_lengths(PARITY_N, tmc.edges, Sc)
    hs = {}
    Dsh = dist_mod.apsp_hub_sharded(Wc, mesh, stats=hs).full_tensor()
    hd = {}
    Dsd = apsp_hub(Wc, stats=hd)
    check(bool(torch.equal(Dsh, Dsd)) and hs == hd,
          f"mesh: apsp_hub_sharded differs from apsp_hub ({hs} vs {hd} "
          f"rounds)")
    del Dsh, Dsd, Wc, tmc
    Xbs = np.stack([make_dataset(PARITY_N, 46, 8, noise=0.5,
                                 seed=args.seed + 60 + b)[0]
                    for b in range(4)])
    bm11 = cluster_batch(Xbs, k=8, config=cfg, mesh=mesh)
    for b in range(4):
        one = cluster(Xbs[b], k=8, config=cfg)
        check(np.array_equal(bm11[b].linkage, one.linkage)
              and np.array_equal(bm11.labels[b], one.labels),
              f"mesh: cluster_batch entry {b} differs from cluster()")
    del bm11, one
    # the integration wrappers on the card, against cluster() on the
    # arrays they pool (sequence embeddings) or transpose (router stats)
    centers = torch.randn((8, 1, 64), generator=gen, device=dev)
    emb = torch.randn((PARITY_N, 16, 64), generator=gen, device=dev) \
        + centers[torch.arange(PARITY_N, device=dev) % 8]
    lab_seq, _ = integration.cluster_sequences(emb, k=8)
    want_seq = cluster(emb.mean(dim=1), k=8, config=cfg).labels
    router = torch.softmax(torch.randn((4096, 64), generator=gen,
                                       device=dev), dim=1)
    lab_exp, _ = integration.expert_affinity(router, k=4)
    want_exp = cluster(router.T.contiguous(), k=4, config=cfg).labels
    check(np.array_equal(lab_seq, want_seq)
          and np.array_equal(lab_exp, want_exp),
          "mesh: cluster_sequences or expert_affinity differ from cluster()")
    tdist.destroy_process_group()
    mesh_s = time.perf_counter() - t11
    mesh_c = dict(n=PARITY_N, pearson_shardmap_err=err_p,
                  batch_entries=4, seq_clusters=int(len(np.unique(lab_seq))),
                  expert_clusters=int(len(np.unique(lab_exp))),
                  phase_s=mesh_s)
    del Xc, Sc, Sb, emb, router, centers
    torch.cuda.empty_cache()
    log(f"[mesh] n={PARITY_N}: {json.dumps(mesh_c)}")
    log(f"[time] mesh phase done at {time.perf_counter() - t_start:.1f} s"
        f" ({mesh_s:.1f} s)")

    # ---- 12. the serving zoo ---------------------------------------------
    clear_compiled()
    torch.cuda.empty_cache()
    t12 = time.perf_counter()
    log(f"[zoo] {torch.cuda.memory_allocated()} B allocated before phase 12")
    zoo = serve_zoo(args.seed)
    zoo_s = time.perf_counter() - t12
    log(f"[time] zoo phase done at {time.perf_counter() - t_start:.1f} s"
        f" ({zoo_s:.1f} s)")

    dense_kernels = ("pearson", "minplus", "masked_argmax")
    for e in entries.values():
        e["launches"] = (launches_s if e["name"] == "flash_attention_wgmma"
                         else launches_32 if e["name"] == "flash_attention"
                         else launches if e["name"] in dense_kernels
                         else launches_a)[e["name"]]
        e["filter_launches"] = {w: c[e["name"]]
                                for w, c in filt_launches.items()}
        e["mesh_launches"] = {"approx": launches_m[e["name"]],
                              "dense": launches_mb[e["name"]]}
        e["zoo_launches"] = {a_: r_["launches"][e["name"]]
                             for a_, r_ in zoo.items()}
        e["zoo_kv_quant_launches"] = {
            a_: r_["kv_quant"]["launches"][e["name"]]
            for a_, r_ in zoo.items() if "kv_quant" in r_}
    main["seconds_in_all"] = time.perf_counter() - t_start
    main["sparse_phase_s"] = sparse_s
    main["filter_phase_s"] = filter_s
    main["stream_phase_s"] = stream_s
    main["mesh_phase_s"] = mesh_s
    main["zoo_phase_s"] = zoo_s
    log(f"[main] {json.dumps(main)}")
    log(f"[approx] {json.dumps(approx)}")
    log(f"[serve] {json.dumps(serve)}")
    log(f"[fp32] {json.dumps(fp32_path)}")
    log(f"[filters] {json.dumps(filt_runs)}")
    log(f"[stream] {json.dumps(stream)}")
    log(f"[mesh] {json.dumps(dict(approx=mesh_a, dense=mesh_b, parity=mesh_c))}")
    log(f"[zoo] {json.dumps(zoo)}")
    log(smi_line)
    log(json.dumps({"kernels": list(entries.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
