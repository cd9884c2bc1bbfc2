"""The ranks of the multi-process tests of ``repro_torch``'s funnel
(tests/test_torch_dist.py): each joins a gloo group from a ``file://``
store, runs one task on the CPU and saves its outputs for the test
process to compare.  It imports torch, numpy and ``repro_torch`` only:
the test process computes the JAX reference and hands the inputs over as
``.npy`` files.
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


TASKS = {"world4": world4, "world3": world3}
