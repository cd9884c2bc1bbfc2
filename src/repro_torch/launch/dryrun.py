"""Multi-pod dry run of the port: every (arch x shape x mesh) cell traced.

The twin of ``repro.launch.dryrun``, with its CLI, cells, shape knobs,
variants and record keys.  For each cell it traces one step -- the train
step (microbatches and AdamW), ``prefill`` or ``decode_step`` -- of rank
0 of the production mesh (16 x 16 single-pod, 2 x 16 x 16 multi-pod),
under the cost walker (``launch/cost.py``, the counterpart of
``hlo_cost.py``) for the roofline terms and under
``torch.distributed._tools.mem_tracker.MemTracker`` for the rank's peak
bytes, and writes one JSON per cell under ``--out`` (resumable: cells
already written are skipped unless ``--force``) beside the walker's
per-operation table (``<cell>.ops.jsonl.gz``, in place of the
reference's ``.hlo.gz``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
        --shape train_4k --mesh both --out results/dryrun_torch

The reference makes 512 fake XLA devices before it imports jax.  Here a
fake process group (``torch.testing._internal.distributed.fake_pg``:
backend ``"fake"``, world 256 or 512, this process rank 0) is started
for each cell before anything is built, in the dry run's own process
(none may be running), and ended after it: its collectives do nothing
and return at once, and the walker counts them.  Parameters, AdamW
state and batch are fake tensors (``FakeTensorMode``: shapes, dtypes
and devices without storage) laid out by ``dist.sharding``'s
``param_shardings`` and ``batch_shardings`` from
``registry.input_specs``; the traced step is the port's own, as it runs
on a mesh, on the rank's rows of the batch.  The dense, MoE and VLM
families split their work over ``model`` as the reference's GSPMD
program does (``dist/tensor_parallel.py``): each layer's leaves
gathered over the data axes as the forward (and the backward's
recomputation) reaches it, the rank's heads, d_ff columns and
vocabulary rows, the gradients reduce-scattered back into the stored
layout; ``prefill`` forms the last position's logits only, and
``decode_step`` reads caches split by sequence over ``model`` on the
rank's slots.  The other families gather each leaf whole (ZeRO-3) and
decode on caches gathered over ``model``.  The hand-written kernels are
charged by formula (``kernels/charges.py``) and, under the walk, give
outputs of their shapes without running their plain versions, whose
(T, T) attention scores the card never holds.  ``trace_s`` takes the
place of the reference's ``lower_s`` and ``compile_s``;
``xla_cost`` holds the dispatcher's own count (the walk without the
kernels' charges), as the reference's holds XLA's own.

The roofline's figures are an NVIDIA H100 80GB HBM3 (SXM)'s, not the
TPU v5e's of the reference: 989 TFLOP/s dense bf16 on the tensor cores,
3.35 TB/s of HBM3, 80 GB of it a card.  The link: a 256- or 512-card
mesh spans 32 or 64 DGX/HGX H100 nodes of 8 cards, each card with
NVLink 4 to the others of its node (18 links, 450 GB/s a direction,
through NVSwitch) and one 400 Gb/s NDR InfiniBand NIC to the other
nodes (50 GB/s a direction): a ring over the data axes crosses nodes,
so ``link_bw`` is the NIC's 50 GB/s (NVIDIA's DGX H100 and ConnectX-7
data sheets).

The paper's own workload is the arch id ``paper-tmfg`` (cells "cluster",
the batched per-step collectives, and "cluster-naive", one collective a
row and a value): the column-sharded similarity and lazy TMFG
(``core/distributed.py``) on n = 19456 series of L = 64.  The lazy
loop reads its inserted count every 64 steps, a read of data that fake
tensors refuse, so the step body is traced once and counted
``tmfg_trips`` = 19456 times: the trip count the reference's walker
reads from the same loop (the largest constant of its condition,
``n_inserted < n``).  The sharded hub APSP (``apsp_hub_sharded``, two
rounds, its fixed-point test taken as true) is traced too and recorded
beside it (``apsp``), apart from the roofline, whose terms cover the
reference's cell: the similarity and the construction.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from unittest import mock

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..configs import ARCH_IDS, RunConfig, get_config
from ..configs.shapes import shapes_for
from ..dist import hints as hints_mod
from ..dist import sharding as sh
from ..dist import tensor_parallel
from ..models.registry import build_model, input_specs
from ..train import optimizer
from ..train.train_step import make_train_step
from ..train.tree import leaves, tree_map
from . import cost
from .mesh import make_production_mesh

HW = dict(name="NVIDIA H100 80GB HBM3", peak_flops_bf16=989e12,
          hbm_bw=3.35e12, link_bw=50e9, hbm_bytes=80e9)

# per-shape execution knobs (microbatching keeps the logits buffer in HBM;
# chunk sizes bound the attention working set)
SHAPE_KNOBS = {
    "train_4k": dict(microbatches=8, q_chunk=512, kv_chunk=1024),
    "prefill_32k": dict(microbatches=1, q_chunk=1024, kv_chunk=2048),
    "decode_32k": dict(),
    "long_500k": dict(),
}
VARIANTS = ["baseline", "opt", "opt-noact", "opt-vdata", "opt-mb2",
            "opt-zero1", "opt-mb2-zero1"]
TMFG_N, TMFG_L = 19456, 64
APSP_ROUNDS = 2         # the hub APSP's Bellman-Ford rounds in the cell
DEVICE = "cpu"          # the fake tensors' device: the walk needs no card


def dp_axes(mesh):
    return sh.data_axes(mesh)


def _state_sharding_tree(state, mesh, batch: int):
    """Generic decode-state sharding: batch dims over (pod, data); the
    longest remaining dim >= 4096 (sequence) over model (SP)."""
    axes = dp_axes(mesh)
    dp_total = sh.axis_size(mesh, axes)
    model = sh.axis_size(mesh, "model")

    def leaf(x):
        spec = [None] * x.dim()
        for i, s in enumerate(x.shape):
            if s == batch and batch > 1 and batch % dp_total == 0:
                spec[i] = axes
                break
        cand = [(s, i) for i, s in enumerate(x.shape)
                if spec[i] is None and s >= 4096 and s % model == 0]
        if cand:
            spec[max(cand)[1]] = "model"
        return sh.NamedSharding(mesh, sh.placements_of(spec, mesh))

    return tree_map(leaf, state)


def _fits(mem) -> bool:
    return not mem or mem["peak_bytes"] < HW["hbm_bytes"]


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS for the whole step (all chips)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def roofline(totals: cost.CostTotals, n_dev: int, cfg, shape) -> dict:
    t_compute = totals.flops / HW["peak_flops_bf16"]
    t_memory = totals.hbm_bytes / HW["hbm_bw"]
    t_coll = totals.collective_wire_bytes / HW["link_bw"]
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, shape) / n_dev if cfg is not None else 0.0
    return dict(
        t_compute_s=t_compute, t_memory_s=t_memory, t_collective_s=t_coll,
        dominant=dominant,
        hlo_flops_per_dev=totals.flops,
        hbm_bytes_per_dev=totals.hbm_bytes,
        wire_bytes_per_dev=totals.collective_wire_bytes,
        collective_counts=dict(totals.collective_counts),
        model_flops_per_dev=mf,
        useful_flops_ratio=(mf / totals.flops) if totals.flops else 0.0,
    )


# ---------------------------------------------------------------------------
# cell builders: (fn, args) of rank 0's step, args fake and placed
# ---------------------------------------------------------------------------

def _place(tree, shardings):
    """``tree`` laid out by ``shardings``, each rank's block a tensor of
    its own: not a view of the whole leaf, which no rank holds (the
    memory tracker counts a view's whole storage)."""
    def one(x, s):
        d = s.place(x)
        return DTensor.from_local(d.to_local().clone(), s.mesh,
                                  s.placements, run_check=False,
                                  shape=d.shape, stride=d.stride())
    return tree_map(one, tree, shardings)


def _fake_inputs(specs: dict) -> dict:
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=DEVICE)
            for k, v in specs.items()}


def _init(model):
    return model.init(torch.Generator().manual_seed(0))


def build_train(cfg, shape, mesh, knobs, variant: str = "baseline"):
    """variant "opt*": one-hot embedding and the activation / logits
    layout hints; "-mb2" 2 microbatches instead of 8; "-zero1" the
    parameters TP-sharded only (the moments stay 2-D); "opt-vdata" the
    embedding's vocab over data."""
    model = build_model(cfg, device=DEVICE)
    mb = knobs.get("microbatches", 1)
    if "-mb2" in variant:
        mb = 2
    params = _init(model)
    opt_state = optimizer.init(params)
    batch = _fake_inputs(input_specs(cfg, shape, kind="train"))

    embed_mode = "dmodel" if variant.startswith("opt") else "2d"
    if variant == "opt-vdata":
        embed_mode = "vdata"
    weights_mode = "tp_only" if variant.endswith("zero1") else "2d"
    params = _place(params, sh.param_shardings(
        params, mesh, embed_mode=embed_mode, weights_mode=weights_mode))
    opt_state = _place(opt_state, sh.param_shardings(opt_state, mesh,
                                                     embed_mode=embed_mode))
    batch = _place(batch, sh.batch_shardings(mesh, batch))

    lk = dict(q_chunk=knobs.get("q_chunk", 512),
              kv_chunk=knobs.get("kv_chunk", 1024))
    if cfg.family in ("ssm",):
        lk = {}
    step = make_train_step(model, RunConfig(microbatches=mb), mesh,
                           loss_kwargs=lk)
    if variant.startswith("opt"):
        axes = dp_axes(mesh)
        logits_hint = sh.NamedSharding(mesh, sh.placements_of(
            (axes, None, "model"), mesh))
        act_hint = None if variant == "opt-noact" else sh.NamedSharding(
            mesh, sh.placements_of((axes, None, None), mesh))
        inner = step

        def step(params, opt_state, batch):
            with hints_mod.hints(logits=logits_hint, activations=act_hint,
                                 onehot_embed=True):
                return inner(params, opt_state, batch)

    return step, (params, opt_state, batch)


def _whole_params(params):
    """Each parameter leaf gathered whole: the serving steps of the
    families that do not split their work over ``model``."""
    with torch.no_grad():
        return tree_map(sh.whole, params)


def build_prefill(cfg, shape, mesh, knobs, variant: str = "baseline"):
    model = build_model(cfg, device=DEVICE)
    params = _init(model)
    embed_mode = "dmodel" if variant.startswith("opt") else "2d"
    params = _place(params, sh.param_shardings(params, mesh,
                                               embed_mode=embed_mode))
    batch = _fake_inputs(input_specs(cfg, shape, kind="prefill"))
    batch = _place(batch, sh.batch_shardings(mesh, batch))
    extra = dict(onehot_embed=True) if variant.startswith("opt") else {}
    split = getattr(model, "model_parallel", False)

    def serve_prefill(params, batch):
        if split:
            # the stored leaves and the placed batch: the model takes its
            # rows and splits its work over model
            with hints_mod.hints(**extra), tensor_parallel.bind(mesh):
                return model.prefill(params, batch["tokens"],
                                     batch.get("frontend"),
                                     max_len=shape.seq_len)
        whole = _whole_params(params)
        rows = {k: sh.local(v) for k, v in batch.items()}
        with hints_mod.hints(**extra):
            if cfg.is_encdec:
                return model.prefill(whole, rows["tokens"], rows["frontend"],
                                     max_len=shape.seq_len)
            return model.prefill(whole, rows["tokens"],
                                 max_len=shape.seq_len)

    return serve_prefill, (params, batch)


def build_decode(cfg, shape, mesh, knobs, variant: str = "baseline"):
    """variant "opt": int8 KV caches (dense, MoE and VLM archs)."""
    kv_quant = variant.startswith("opt") and cfg.family in ("dense", "moe",
                                                            "vlm")
    model = build_model(cfg, kv_quant=kv_quant, device=DEVICE)
    B = shape.global_batch
    params = _init(model)
    params = _place(params, sh.param_shardings(params, mesh))
    state = model.decode_state(B, shape.seq_len)
    state_sh = _state_sharding_tree(state, mesh, B)
    state = _place(state, state_sh)
    axes = dp_axes(mesh)
    dp_total = sh.axis_size(mesh, axes)
    tok_spec = (axes,) if B % dp_total == 0 and B > 1 else (None,)
    token = sh.NamedSharding(mesh, sh.placements_of(tok_spec, mesh)).place(
        torch.zeros((B,), dtype=torch.int32, device=DEVICE))
    pos = shape.seq_len - 1              # the cache's last position

    if getattr(model, "model_parallel", False):
        def serve_decode(params, state, token, pos):
            # the caches' sequence stays split over model: each rank reads
            # its slots and writes the slot it owns
            with tensor_parallel.bind(mesh):
                return model.decode_step(params, state, token, pos)

        return serve_decode, (params, state, token, pos)

    model_dim = mesh.mesh_dim_names.index("model")

    def rows_only(placements) -> tuple:
        """A state leaf's placements with only its batch dim split: the
        sequence gathered from the model ranks."""
        return tuple(sh.Replicate() if i == model_dim else p
                     for i, p in enumerate(placements))

    def serve_decode(params, state, token, pos):
        whole = _whole_params(params)
        local = tree_map(
            lambda x: x.redistribute(mesh, rows_only(x.placements))
            .to_local(), state)
        logits, new = model.decode_step(whole, local, sh.local(token), pos)
        new = tree_map(lambda x, s: DTensor.from_local(
            x, mesh, rows_only(s.placements), run_check=False
        ).redistribute(mesh, s.placements), new, state_sh)
        return logits, new

    return serve_decode, (params, state, token, pos)


def build_tmfg(mesh, n=TMFG_N, L=TMFG_L, collectives="batched"):
    """The paper's pipeline on the production mesh (arch id paper-tmfg):
    (the similarity and the construction's start, one lazy step, the hub
    APSP) as three functions of X, each traced once."""
    from ..core import distributed as DD
    from ..core import tmfg as tmfg_mod

    flat = _flat_mesh(mesh, dp_axes(mesh))
    axis = flat.mesh_dim_names[0]
    X = torch.zeros((n, L), dtype=torch.float32, device=DEVICE)
    state = {}

    def start(X):
        S = DD.pearson_sharded(X, flat, axis)
        col0, ncol = sh.my_block(n, flat, axis)
        d = DD._ColumnShard(sh.local(S).contiguous(), n, col0,
                            sh.group(flat, axis), sh.axis_size(flat, axis),
                            collectives)
        state["d"], state["st"] = d, tmfg_mod._init_state(d)

    def step():
        tmfg_mod.lazy_step(state["st"], state["d"])

    def apsp():
        # the rounds' fixed-point test reads data, which fake tensors
        # refuse: it is taken as true, so the loop runs its cap of
        # rounds, as the reference's walker counts it
        W = torch.zeros((n, n), dtype=torch.float32, device=DEVICE)
        with mock.patch.object(DD, "_lowered", lambda new, old: True):
            return DD.apsp_hub_sharded(W, flat, axis=axis,
                                       rounds=APSP_ROUNDS)

    return start, step, apsp, (X,)


def _flat_mesh(mesh, axes):
    """A 1-D mesh over the ranks of the data axes (the clustering
    funnel's axis): the single-pod mesh's "data", the multi-pod mesh's
    ("pod", "data") flattened into "pod_data"."""
    if len(axes) == 1:
        return mesh[axes[0]]
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():         # the mesh's own rank tensors
        return mesh[axes]._flatten("pod_data")


# ---------------------------------------------------------------------------
# running the cells
# ---------------------------------------------------------------------------

def _local_bytes(tree) -> int:
    return sum(sh.local(x).numel() * sh.local(x).element_size()
               for x in leaves(tree) if isinstance(x, torch.Tensor))


def _traced(fn, args):
    """(out, walker, peak bytes of rank 0) of fn(*args): the walk and the
    memory tracker's, the inputs counted as held."""
    from torch.distributed._tools.mem_tracker import MemTracker
    mt = MemTracker()
    mt.track_external(*[sh.local(x) for x in leaves(args)
                        if isinstance(x, torch.Tensor)])
    with mt:
        out, walker = cost.walk(fn, *args)
    peak = mt.get_tracker_snapshot("peak")
    return out, walker, max((d.get("Total", 0) for d in peak.values()),
                            default=0)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             force: bool = False, variant: str = "baseline") -> dict:
    tag = f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}"
    if variant != "baseline":
        tag += f"__{variant}"
    out_path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    os.makedirs(out_dir, exist_ok=True)
    rec = dict(arch=arch, shape=shape_name,
               mesh="2x16x16" if multi_pod else "16x16", ok=False,
               hw=HW["name"])
    t0 = time.time()
    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group: "
                           "run it in a process without one")
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n_dev = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_dev)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device=DEVICE)
        with FakeTensorMode(allow_non_fake_inputs=True):
            if arch == "paper-tmfg":
                coll = "per-element" if "naive" in shape_name else "batched"
                cfg, shape = None, None
                start, step, apsp, args = build_tmfg(mesh, collectives=coll)
                _, walker, peak = _traced(start, args)
                _, w_step, _ = _traced(step, ())
                _, w_apsp, _ = _traced(apsp, ())
                totals = walker.totals
                totals.add(w_step.totals, times=TMFG_N)
                table = {k: [v[0], v[1], v[2]] for k, v in
                         walker.table.items()}
                for k, v in w_step.table.items():
                    row = table.setdefault(k, [0, 0.0, 0.0])
                    for i in range(3):
                        row[i] += v[i] * TMFG_N
                rec.update(tmfg_trips=TMFG_N, apsp=dict(
                    rounds=APSP_ROUNDS, flops=w_apsp.totals.flops,
                    hbm_bytes=w_apsp.totals.hbm_bytes,
                    wire_bytes=w_apsp.totals.collective_wire_bytes))
                # X's rows over the data ranks
                arg_bytes = TMFG_N * TMFG_L * 4 // sh.axis_size(
                    mesh, dp_axes(mesh))
                out_bytes = 0
            else:
                cfg = get_config(arch)
                shape = shapes_for(cfg).get(shape_name)
                assert shape is not None, \
                    f"{shape_name} not applicable to {arch} (see DESIGN.md §5)"
                knobs = SHAPE_KNOBS.get(shape_name, {})
                build = dict(train=build_train, prefill=build_prefill,
                             decode=build_decode)[shape.kind]
                fn, args = build(cfg, shape, mesh, knobs, variant)
                out, walker, peak = _traced(fn, args)
                totals, table = walker.totals, walker.table
                arg_bytes, out_bytes = _local_bytes(args), _local_bytes(out)
        t_trace = time.time() - t0
        cost.write_table(table, os.path.join(out_dir, tag + ".ops.jsonl.gz"))
        kernels = sum(v[1] for k, v in table.items()
                      if k.startswith("kernel."))
        kernel_bytes = sum(v[2] for k, v in table.items()
                           if k.startswith("kernel."))
        mem = dict(arg_bytes=arg_bytes, out_bytes=out_bytes,
                   temp_bytes=max(0, peak - arg_bytes), peak_bytes=peak)
        print(f"[{tag}] memory: {mem}")
        print(f"[{tag}] cost flops={totals.flops} bytes={totals.hbm_bytes} "
              f"wire={totals.collective_wire_bytes}")
        rec.update(
            ok=True, trace_s=t_trace, memory=mem, fits_hbm=_fits(mem),
            xla_cost=dict(flops=totals.flops - kernels,
                          bytes=totals.hbm_bytes - kernel_bytes),
            roofline=roofline(totals, n_dev, cfg, shape),
            n_devices=n_dev,
        )
    except Exception as e:  # noqa: BLE001 -- record the failure, keep going
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[{tag}] FAILED: {rec['error']}")
    finally:
        dist.destroy_process_group()
    rec["wall_s"] = time.time() - t0

    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    status = "OK" if rec["ok"] else "FAIL"
    print(f"[{tag}] {status} in {rec['wall_s']:.1f}s")
    return rec


def cells(arch_filter=None, shape_filter=None, mesh_filter="both"):
    out = []
    archs = [arch_filter] if arch_filter and arch_filter != "all" \
        else ARCH_IDS + ["paper-tmfg"]
    for arch in archs:
        if arch == "paper-tmfg":
            shapes = ["cluster", "cluster-naive"]
        else:
            shapes = list(shapes_for(get_config(arch)))
        if shape_filter and shape_filter != "all":
            shapes = [s for s in shapes if s == shape_filter]
        for s in shapes:
            if mesh_filter in ("single", "both"):
                out.append((arch, s, False))
            if mesh_filter in ("multi", "both"):
                out.append((arch, s, True))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    # not the reference's results/dryrun: its records have the same names
    # and a resumed run would take them for this one's
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=VARIANTS)
    args = ap.parse_args(argv)

    todo = cells(args.arch, args.shape, args.mesh)
    print(f"dry-run: {len(todo)} cells")
    n_ok = 0
    for arch, shape, multi in todo:
        rec = run_cell(arch, shape, multi, args.out, force=args.force,
                       variant=args.variant)
        n_ok += bool(rec.get("ok"))
    print(f"dry-run complete: {n_ok}/{len(todo)} cells OK")
    if n_ok < len(todo):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
