"""The ranks of the multi-process tests of ``repro_torch``'s funnel
(tests/test_torch_dist.py) and of its distributed training
(tests/test_torch_dist_train.py, tests/test_torch_moe_mesh.py): each joins a gloo group from a
``file://`` store, runs one task on the CPU and saves its outputs for
the test process to compare.  It imports torch, numpy and
``repro_torch`` only: the test process computes the JAX reference and
hands the inputs over as ``.npy`` files.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

DEADLINE_S = 240.0


def spawn(task: str, world: int, tmp: Path) -> list:
    """Run ``task`` on ``world`` ranks (one spawned group); returns each
    rank's saved outputs."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(_rank, args=(world, str(tmp), task), nprocs=world,
                   join=False)
    t0 = time.monotonic()
    while not ctx.join(timeout=5):
        if time.monotonic() - t0 > DEADLINE_S:
            for p in ctx.processes:
                p.terminate()
            raise TimeoutError(f"{task} on {world} ranks passed "
                               f"{DEADLINE_S} s")
    return [dict(np.load(tmp / f"{task}-{r}.npz")) for r in range(world)]


def _rank(rank: int, world: int, tmp: str, task: str) -> None:
    import os

    # the ranks talk over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store-{task}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.dist.sharding import data_mesh
        mesh = data_mesh(device="cpu")
        out = TASKS[task](mesh, Path(tmp))
        np.savez(Path(tmp) / f"{task}-{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _np(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy()


def world4(mesh, tmp: Path) -> dict:
    """The reference's multi-device checks (tests/test_distributed.py) on
    the port, plus the funnel and a sharded batch."""
    import torch

    from repro_torch.core import (PipelineConfig, apsp_hub, cluster_batch,
                                  distributed as D, edge_lengths)
    from repro_torch.dist import sharding as sh

    X = torch.from_numpy(np.load(tmp / "X.npy"))
    S = torch.from_numpy(np.load(tmp / "S.npy"))
    out = {"pearson": _np(D.pearson_sharded(X, mesh))}
    S24 = torch.from_numpy(np.load(tmp / "S24.npy"))
    for coll, Sc in (("batched", S), ("per-element", S24)):
        tm = D.build_tmfg_sharded(Sc, mesh, collectives=coll)
        out[f"insert_order_{coll}"] = _np(tm.insert_order)
        out[f"edge_sum_{coll}"] = _np(tm.edge_sum)
        out[f"edges_{coll}"] = _np(tm.edges)
    edges = torch.from_numpy(np.load(tmp / "edges.npy"))
    W = edge_lengths(64, edges, S)
    out["apsp_sharded"] = _np(D.apsp_hub_sharded(W, mesh, n_hubs=8,
                                                 rounds=16))
    out["apsp_single"] = _np(apsp_hub(W, n_hubs=8, rounds=16))
    Sq = torch.from_numpy(np.load(tmp / "Sq.npy"))
    mask = torch.from_numpy(np.load(tmp / "mask.npy"))
    v, i = sh.masked_argmax_shardmap(Sq, mask, mesh)
    out["argmax_v"], out["argmax_i"] = _np(v), _np(i)
    A = torch.from_numpy(np.load(tmp / "A.npy"))
    Bm = torch.from_numpy(np.load(tmp / "Bm.npy"))
    out["minplus"] = _np(sh.minplus_shardmap(A, Bm, mesh))
    for name, cfg in (("opt", PipelineConfig.opt()),
                      ("approx", PipelineConfig.approx())):
        for kind, arr in (("S", S), ("X", X)):
            o = D.run_pipeline_sharded(arr, cfg, mesh,
                                       is_similarity=kind == "S",
                                       device="cpu")
            out[f"link_{name}_{kind}"] = _np(o.linkage)
    Xb = torch.from_numpy(np.load(tmp / "Xb.npy"))
    res = cluster_batch(Xb, k=3, config=PipelineConfig.opt(), mesh=mesh,
                        device="cpu")
    out["batch_linkage"] = np.stack([r.linkage for r in res.results])
    out["batch_labels"] = res.labels
    return out


def world3(mesh, tmp: Path) -> dict:
    """The sharded top-K table at n = 50 over 3 ranks (rows padded to
    51), the uneven column blocks (17, 17, 16) of the TMFG, and the
    approx funnel from X."""
    import torch

    from repro_torch.core import PipelineConfig, cluster
    from repro_torch.core import distributed as D
    from repro_torch.dist import sharding as sh

    X = torch.from_numpy(np.load(tmp / "X50.npy"))
    v, i, z = sh.topk_pearson_sharded(X, 7, mesh)
    S = torch.from_numpy(np.load(tmp / "S50.npy"))
    tm = D.build_tmfg_sharded(S, mesh)
    res = cluster(X, k=4, config=PipelineConfig.approx(sim_k=16), mesh=mesh,
                  device="cpu")
    return {"topk_v": _np(v), "topk_i": _np(i), "z": _np(z),
            "local_rows": np.array([v.to_local().shape[0]]),
            "insert_order": _np(tm.insert_order),
            "approx_linkage": res.linkage, "approx_labels": res.labels}


def _place(tree, shardings):
    from repro_torch.train.tree import tree_map
    return tree_map(lambda x, s: s.place(x), tree, shardings)


def _flat(tree) -> list:
    from repro_torch.dist import sharding as sh
    from repro_torch.train.tree import leaves
    return [_np(sh.whole(x)) for x in leaves(tree)]


def train4(mesh, tmp: Path) -> dict:
    """Distributed training over 4 ranks: the placed train step on (4, 1)
    and (2, 2) ("data", "model") meshes (with and without int8
    compression; on (2, 2) also with the parameters TP-sharded only;
    leaves of 512 elements and up sharded, so that the reduced model's
    layout is not all replicated) and on (1, 4) (more model ranks than kv
    heads; and a granite of 2 heads and 1 kv head, fewer heads than
    model ranks), the q and kv heads of each flash call and the columns
    of each MLP's up projection a rank sees; placed prefill and decode
    on (2, 2) against the unplaced model (``_serve_split``); ``remesh`` and
    ``restore(shardings=)`` from (4, 1) to (2, 2), checkpoints read
    across a plain run and a mesh run, ``psum_compressed`` over the data
    axis, and the block each rank holds of a leaf sharded over
    ("pod", "data")."""
    import torch
    from torch.distributed.tensor import Shard

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.dist import compression
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.train import checkpoint, elastic, optimizer
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.tree import leaves, tree_map

    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    sh._MIN_SHARD_ELEMS = 512
    cfg = get_config("granite-3-8b").reduced(n_layers=2)
    model = build_model(cfg, device="cpu")
    p0 = model.init(torch.Generator().manual_seed(0))
    state0 = (p0, optimizer.init(p0))
    # fewer heads than model ranks: 2 heads, 1 kv head over 4
    model_h2 = build_model(get_config("granite-3-8b").reduced(
        n_layers=2, n_heads=2, n_kv_heads=1), device="cpu")
    p0_h2 = model_h2.init(torch.Generator().manual_seed(0))
    data = np.load(tmp / "train4.npz")
    batches = [{k: torch.from_numpy(data[f"{k}{s}"])
                for k in ("tokens", "targets")} for s in range(2)]
    out = {}
    meshes = {"4x1": make_mesh((4, 1), ("data", "model"), device="cpu"),
              "2x2": make_mesh((2, 2), ("data", "model"), device="cpu"),
              "1x4": make_mesh((1, 4), ("data", "model"), device="cpu")}
    # what a rank's kernel and products see: each flash call's (q heads,
    # kv heads) and each MLP's d_ff columns
    seen = {"heads": set(), "ff": set()}
    flash, mlp = ops.flash_attention, transformer.mlp_apply

    def flash_seen(q, k, v, **kw):
        seen["heads"].add((q.shape[2], k.shape[2]))
        return flash(q, k, v, **kw)

    def mlp_seen(p, x, kind):
        seen["ff"].add(p["wg"].shape[1])
        return mlp(p, x, kind)

    ops.flash_attention, transformer.mlp_apply = flash_seen, mlp_seen
    # "2x2tp": ZeRO-1, the parameters TP-sharded only, the moments 2-D
    for name, m, mode, mdl, start in (
            ("4x1", meshes["4x1"], "2d", model, state0),
            ("2x2", meshes["2x2"], "2d", model, state0),
            ("2x2tp", meshes["2x2"], "tp_only", model, state0),
            ("1x4", meshes["1x4"], "2d", model, state0),
            ("h2_1x4", meshes["1x4"], "2d", model_h2,
             (p0_h2, optimizer.init(p0_h2)))):
        layout = (sh.param_shardings(start[0], m, weights_mode=mode),
                  sh.param_shardings(start[1], m))
        out[f"sharded_{name}"] = np.array([
            any(isinstance(pl, Shard) for pl in s.placements)
            for s in leaves(layout)])
        out[f"zero1_{name}"] = np.array(sum(
            a.placements != b.placements for a, b in
            zip(leaves(layout[0]), leaves(layout[1].mu))))
        for compress in (False, True) if name in ("4x1", "2x2") \
                else (False,):
            rc = RunConfig(lr=1e-5, warmup_steps=1, total_steps=10,
                           compress_grads=compress)
            step = make_train_step(mdl, rc, m)
            p, o = _place(start, layout)
            losses, norms = [], []
            seen["heads"].clear()
            seen["ff"].clear()
            for b in batches:
                p, o, met = step(p, o, _place(b, sh.batch_shardings(m, b)))
                losses.append(float(met["loss"]))
                norms.append(float(met["grad_norm"]))
            key = f"{name}_{int(compress)}"
            out[f"heads_{key}"] = np.array(sorted(seen["heads"]))
            out[f"ff_{key}"] = np.array(sorted(seen["ff"]))
            out[f"loss_{key}"] = np.array(losses)
            out[f"gnorm_{key}"] = np.array(norms)
            out[f"layout_kept_{key}"] = np.array(all(
                tuple(x.placements) == s.placements
                for x, s in zip(leaves((p, o)), leaves(layout))))
            for i, a in enumerate(_flat(p)):
                out[f"p_{key}_{i}"] = a
            if name == "4x1" and not compress:
                trained = (p, o)
    ops.flash_attention, transformer.mlp_apply = flash, mlp
    out.update(_serve_split(meshes["2x2"], tmp))

    # from (4, 1) to (2, 2): remesh, and a checkpoint saved on one and
    # restored on the other; the plain run's checkpoint onto (4, 1)
    new = meshes["2x2"]
    moved = elastic.remesh(trained, new)
    ck = str(tmp / "ckpt_mesh")
    checkpoint.save(trained, ck, 2)
    got, step_read, _ = checkpoint.restore(
        trained, ck, shardings=sh.param_shardings(trained, new))
    want = _flat(trained)
    out["remesh_bitwise"] = np.array(all(
        np.array_equal(a, b) for a, b in zip(_flat(moved), want)))
    out["restore_bitwise"] = np.array(step_read == 2 and all(
        np.array_equal(a, b) for a, b in zip(_flat(got), want)))
    lay_new = [s.placements for s in leaves(sh.param_shardings(trained,
                                                               new))]
    out["placed_on_new"] = np.array(all(
        x.device_mesh == new and tuple(x.placements) == tuple(pl)
        for x, pl in zip(leaves(moved) + leaves(got), lay_new + lay_new)))
    plain, _, _ = checkpoint.restore(
        state0, str(tmp / "ckpt_plain"),
        shardings=sh.param_shardings(state0, meshes["4x1"]))
    out["plain_read_bitwise"] = np.array(all(
        np.array_equal(a, b) for a, b in zip(_flat(plain), _flat(state0))))

    # psum_compressed over the data axis of (4, 1): each rank its own
    # gradients, from the rank's seed
    rank = meshes["4x1"].get_coordinate()[0]
    r = np.random.default_rng(100 + rank)
    g = {"w": torch.from_numpy((r.normal(size=(33, 17)) * 1e-2)
                               .astype(np.float32)),
         "b": torch.from_numpy(r.normal(size=(9,)).astype(np.float32))}
    summed = compression.psum_compressed(g, "data", meshes["4x1"])
    out["psum_w"], out["psum_b"] = _np(summed["w"]), _np(summed["b"])

    # the block of a leaf sharded over ("pod", "data") on each rank
    pod = make_mesh((2, 2), ("pod", "data"), device="cpu")
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    d = sh.from_whole(x, pod, sh.placements_of((("pod", "data"), None),
                                                pod))
    out["nested_block"] = _np(d.to_local())
    out["nested_coords"] = np.array(pod.get_coordinate())
    out["nested_whole"] = _np(d.full_tensor())
    return out


def _serve_split(mesh, tmp: Path) -> dict:
    """Placed prefill and decode on a (2, 2) mesh: 4 prompts (two rows a
    data rank), their work over the 2 model ranks, caches split by
    sequence over them (granite-3-8b reduced, its caches of 24 slots
    holding the prompt's 20 positions, also as int8; gemma3-4b reduced,
    its window layers' rings of 16 slots), prefilled then 3 steps
    decoded, against the unplaced model on the whole batch: the largest
    logit difference over the ranks, the filled slots a model rank holds
    after the prefill, and whether the caches are split over model."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as sh
    from repro_torch.dist import tensor_parallel
    from repro_torch.models.registry import build_model
    from repro_torch.train.tree import leaves

    data = np.load(tmp / "serve4.npz")
    prompts = torch.from_numpy(data["prompts"]).long()
    nexts = torch.from_numpy(data["nexts"]).long()
    B, T = prompts.shape
    q = mesh.get_coordinate()[0]
    rows = slice(q * B // 2, (q + 1) * B // 2)
    out = {}
    for tag, arch, kv_quant in (("granite", "granite-3-8b", False),
                                ("granite_int8", "granite-3-8b", True),
                                ("gemma", "gemma3-4b", False)):
        model = build_model(get_config(arch).reduced(n_layers=2),
                            kv_quant=kv_quant, device="cpu")
        p0 = model.init(torch.Generator().manual_seed(0))
        want, caches, _ = model.prefill(p0, prompts, max_len=T + 4)
        wants = [want]
        for i in range(len(nexts)):
            want, caches = model.decode_step(p0, caches, nexts[i], T + i)
            wants.append(want)
        placed = _place(p0, sh.param_shardings(p0, mesh))

        def on_rows(x):
            return _place({"x": x}, sh.batch_shardings(mesh, {"x": x}))["x"]

        with tensor_parallel.bind(mesh):
            got, caches, _ = model.prefill(placed, on_rows(prompts),
                                           max_len=T + 4)
            filled = sum(int((c.slot_pos.to_local() >= 0).sum())
                         for c in caches)
            gots = [got]
            for i in range(len(nexts)):
                got, caches = model.decode_step(placed, caches,
                                                on_rows(nexts[i]), T + i)
                gots.append(got)
        diff = torch.tensor([max(float((g - w[rows]).abs().max())
                                 for g, w in zip(gots, wants))])
        dist.all_reduce(diff, op=dist.ReduceOp.MAX)
        model_group = mesh.get_group(1)
        per_rank = torch.zeros(2, dtype=torch.long)
        per_rank[mesh.get_coordinate()[1]] = filled
        dist.all_reduce(per_rank, group=model_group)
        out[f"serve_diff_{tag}"] = diff.numpy()
        out[f"serve_filled_{tag}"] = per_rank.numpy()
        out[f"serve_split_{tag}"] = np.array(all(
            isinstance(x.placements[1], sh.Shard) for c in caches
            for x in leaves(c)))
    return out


MOE_CASES = ("small1", "small2", "large1", "large2")


# the cases also run on a ("data", "model") (2, 2) mesh at world 4
MOE_TP_CASES = ("small1", "small2", "large1")


def moe_mesh(mesh, tmp: Path) -> dict:
    """One train step of a reduced deepseek-moe-16b (1 layer, capacity
    factor 0.5, aux weight 1) on a ("data",) mesh of the group's ranks,
    for each case of ``moe_mesh.npz`` (its microbatches and global
    batch): the metrics, the updated parameters and AdamW moments whole,
    and the pairs this rank's dispatches dropped in the forward (not in
    the backward's recomputation).  At world 4 also the MOE_TP_CASES on
    a ("data", "model") (2, 2) mesh, under keys ``tp_<case>``: the
    experts' d_ff split over the model ranks, the routing replicated
    over them (the drops counted on model rank 0 only)."""
    import torch

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    from repro_torch.train import optimizer
    from repro_torch.train.train_step import make_train_step

    sh._MIN_SHARD_ELEMS = 512
    cfg = get_config("deepseek-moe-16b").reduced(n_layers=1,
                                                 capacity_factor=0.5)
    model = build_model(cfg, device="cpu")
    p0 = model.init(torch.Generator().manual_seed(0))
    state0 = (p0, optimizer.init(p0))
    data = np.load(tmp / "moe_mesh.npz")
    dispatch, drops = moe.dispatch, [0]
    counting = [True]

    def counted(*args):
        got = dispatch(*args)
        if counting[0] and torch._C._current_graph_task_id() == -1:
            drops[0] += int((~got[2]).sum())     # not a recompute
        return got

    runs = [("", mesh, MOE_CASES)]
    if mesh.size() == 4:
        tp = make_mesh((2, 2), ("data", "model"), device="cpu")
        runs.append(("tp_", tp, MOE_TP_CASES))
    moe.dispatch = counted
    out = {}
    try:
        for prefix, m, cases in runs:
            layout = sh.param_shardings(state0, m)
            counting[0] = "model" not in m.mesh_dim_names \
                or m.get_coordinate()[1] == 0
            for case in cases:
                rc = RunConfig(lr=1e-5, warmup_steps=1, total_steps=10,
                               microbatches=int(data[f"{case}_m"]))
                step = make_train_step(model, rc, m,
                                       loss_kwargs={"aux_weight": 1.0})
                b = {k: torch.from_numpy(data[f"{case}_{k}"])
                     for k in ("tokens", "targets")}
                p, o = _place(state0, layout)
                drops[0] = 0
                p, o, met = step(p, o, _place(b, sh.batch_shardings(m, b)))
                key = prefix + case
                out[f"{key}_drops"] = np.array(drops[0])
                for k, v in met.items():
                    out[f"{key}_met_{k}"] = _np(v)
                for name, tree in (("p", p), ("mu", o.mu), ("nu", o.nu)):
                    for i, a in enumerate(_flat(tree)):
                        out[f"{key}_{name}_{i}"] = a
    finally:
        moe.dispatch = dispatch
    return out


TASKS = {"world4": world4, "world3": world3, "train4": train4,
         "moe_mesh": moe_mesh}
