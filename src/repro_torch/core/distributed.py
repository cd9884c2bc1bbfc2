"""Multi-device TMFG-DBHT over ``torch.distributed``: the port of
``repro.core.distributed``.

Sharding plan (DESIGN.md §4.4) over a 1-D ``DeviceMesh`` axis
(``dist.sharding.data_mesh``):

  * X (n, L) time series      -- row-sharded
  * S (n, n) similarity       -- column-sharded
  * TMFG state                -- replicated (O(n) integers)
  * top-K candidate table     -- replicated (n x K) after one gather
  * hub distance rows (h, n)  -- replicated; W row-sharded

The reference runs one controller over global arrays.  The port runs
SPMD: every rank calls an entry point with the same full input (or a
``DTensor`` already so laid out), the stage functions return the rank's
shard as a ``DTensor`` (``full_tensor()`` is the reference's global
array), and :func:`run_pipeline_sharded` returns the same replicated
outputs on every rank.

Column-sharding S makes every row scan of the lazy TMFG a local scan
over the rank's n/d columns followed by one small all-gather of the
ranks' (value, index) candidates, the lowest index winning among equal
maxima; an element S[r, c] is computed by its owner and summed with the
others' zeros in one all-reduce.  :class:`_ColumnShard` is that value
source; ``tmfg.lazy_step`` and ``tmfg.run_loop`` drive it unchanged, so
the construction is the single-device one (bitwise at world size 1,
where every collective is a copy; at larger sizes the clique's row sums
are added across ranks in another order).  ``collectives="batched"``
makes two all-gathers (the stale face's 3 corners and the insert's 4)
and three all-reduces (the new edges' values, the refresh's 9 and the
insert's 27 gains) a step; ``"per-element"`` makes one collective per
row and per value, the reference's baseline.  The loop is a cached
``tmfg.LoopProgram`` (:func:`sharded_program`), as the single-device
loop is: on a card it replays T captured steps per CUDA graph with the
collectives inside (one flag read per replay), and a replayed call
builds nothing; on the CPU (gloo) it steps eagerly.

Hub APSP (:func:`apsp_hub_sharded`) gives each rank a row block of W:
each Bellman-Ford round's local product ``D_h[:, local] (x) W_local``
goes through ``ops.minplus`` and one all-reduce MIN combines it; the
local rows' composition goes through ``ops.minplus`` too.  A minimum is
exact, so D is bitwise the single-device ``apsp_hub``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.dist import sharding as dist_sh
from repro_torch.kernels import ops

from . import apsp as apsp_mod
from . import config as config_mod
from . import tmfg as tmfg_mod
from .config import PipelineConfig
from .tmfg import NEG, TMFGResult, _Source, panel_row_sums

COLLECTIVES = ("batched", "per-element")


# ---------------------------------------------------------------------------
# sharded similarity
# ---------------------------------------------------------------------------

def pearson_sharded(X, mesh, axis: str = "data"):
    """Pearson correlation with X row-sharded; S returned column-sharded
    (a DTensor), through ``dist.sharding.pearson_shardmap``."""
    return dist_sh.pearson_shardmap(X, mesh, axis)


# ---------------------------------------------------------------------------
# sharded TMFG construction
# ---------------------------------------------------------------------------

class _ColumnShard(_Source):
    """The lazy construction's values over this rank's column block
    ``S[:, col0:col0 + ncol]`` (its diagonal entries at -inf), the
    reference's ``_sharded_lookup_many_factory`` and
    ``_sharded_gather_many_factory``.  Like the reference's sharded loop
    it takes no candidate table: a table lookup picks the same vertex as
    the full scan."""

    def __init__(self, S_local: torch.Tensor, n: int, col0: int, grp,
                 world: int, collectives: str):
        self.S = S_local
        self.col0, self.ncol = col0, S_local.shape[1]
        self.group, self.world = grp, world
        self.batched = collectives == "batched"
        super().__init__(n, S_local.device)
        self.local_mask = self.inserted[col0:col0 + self.ncol]

    def row_sums(self) -> torch.Tensor:
        """The local block's finite row sums (``panel_row_sums``), summed
        across ranks by one all-reduce."""
        part = panel_row_sums(lambda r0, r1: self.S[r0:r1], self.n)
        dist.all_reduce(part, group=self.group)
        return part

    def _best_of_ranks(self, cand: torch.Tensor) -> torch.Tensor:
        """All-gather (2, w) float64 (value, global index) candidates and
        keep, per column, the first rank's among the largest values: the
        lowest index, the ranks' blocks being in column order."""
        out = cand.new_empty((self.world * 2, cand.shape[1]))
        dist_sh.all_gather_flat(out, cand, self.group)
        out = out.view(self.world, 2, -1)
        b = out[:, 0].argmax(dim=0, keepdim=True)               # (1, w)
        return out[:, 1].gather(0, b)[0].long()

    def lookup_full(self, W: torch.Tensor) -> torch.Tensor:
        """Best uninserted vertex of each row in W: the local masked
        argmax, then the lowest-index maximum across ranks."""
        rows = self.S.index_select(0, W)
        rows.masked_fill_(self.local_mask[None, :], NEG)
        j = rows.argmax(dim=1, keepdim=True)
        cand = torch.cat([rows.gather(1, j).double().T,
                          (j + self.col0).double().T])           # (2, w)
        if self.batched:
            return self._best_of_ranks(cand)
        return torch.cat([self._best_of_ranks(cand[:, q:q + 1].contiguous())
                          for q in range(cand.shape[1])])

    def seed_lookup(self, W: torch.Tensor) -> torch.Tensor:
        return self.lookup_full(W)

    def lookup(self, W: torch.Tensor):
        return self.lookup_full(W), None

    def values(self, r: torch.Tensor, c: torch.Tensor):
        """S[r, c]: the owner's value, the others' 0.0, summed by one
        all-reduce (one per element with ``collectives="per-element"``)."""
        local = c - self.col0
        own = (local >= 0) & (local < self.ncol)
        v = torch.where(own, self.S[r, local.clamp(0, self.ncol - 1)], 0.0)
        if self.batched:
            dist.all_reduce(v, group=self.group)
            return v, None
        parts = [x.clone() for x in v.reshape(-1).split(1)]
        for x in parts:
            dist.all_reduce(x, group=self.group)
        return torch.cat(parts).view(v.shape), None


def sharded_program(n: int, mesh, axis: str = "data",
                    collectives: str = "batched",
                    dev=None) -> tmfg_mod.LoopProgram:
    """The cached lazy program of this rank's column block of an (n, n)
    S: a ``tmfg.LoopProgram`` over a :class:`_ColumnShard` of fresh
    buffers, keyed like the single-device programs and also by the
    block, the collectives and the process group (the program holds the
    group, so its ``id`` names no other while the entry lives).  Every
    rank makes the same calls, so every rank hits or misses together: a
    miss builds (on a card: one eager step and T captured, collectives
    included), counted once in ``obs.trace.compile_stats``, and a
    replayed call builds nothing."""
    if collectives not in COLLECTIVES:
        raise ValueError(f"collectives={collectives!r}; have {COLLECTIVES}")
    d = dist_sh.axis_size(mesh, axis)
    if dist_sh.block(n, d, d - 1)[1] < 1:
        raise ValueError(f"n={n} leaves a rank of {d} without columns")
    col0, ncol = dist_sh.my_block(n, mesh, axis)
    grp = dist_sh.group(mesh, axis)
    dev = tmfg_mod.program_device(dev)

    def make_source():
        Sl = torch.empty((n, ncol), dtype=torch.float32, device=dev)
        return _ColumnShard(Sl, n, col0, grp, d, collectives)
    return tmfg_mod.cached_program(
        ("sharded", n, col0, ncol, d, collectives, id(grp)), dev,
        make_source)


def build_sharded(S, mesh, axis: str = "data",
                  collectives: str = "batched"):
    """The lazy construction over this rank's column block of S (a
    tensor or a column-sharded DTensor), through its cached
    :func:`sharded_program`: (TMFGResult, host syncs).  The block is
    copied into the program's buffer with its diagonal entries at -inf.
    On a card the program replays its T captured steps until the
    inserted count, read once a replay, reaches n; on the CPU the steps
    run eagerly, the count read every T steps."""
    Sl = dist_sh.local_block(S, mesh, axis, dim=1)
    prog = sharded_program(S.shape[0], mesh, axis, collectives, Sl.device)
    with prog.lock:
        src = prog.d
        src.S.copy_(Sl)
        j = torch.arange(src.ncol, device=src.S.device)
        src.S[src.col0 + j, j] = NEG
        res, syncs, _, _ = prog.run()
    return res, syncs


def build_tmfg_sharded(S, mesh, *, axis: str = "data",
                       method: Optional[str] = None,
                       collectives: str = "batched",
                       config: Optional[PipelineConfig] = None
                       ) -> TMFGResult:
    """TMFG construction with S column-sharded over ``axis``.

    State is replicated; every row scan is distributed.  The result is
    the single-device lazy ``build_tmfg`` (bitwise at world size 1; at
    larger sizes the clique's row sums are added in another order).
    ``collectives="batched"`` (default) makes one collective per lookup
    and per value gather, ``"per-element"`` one per row and per element
    (the reference's baseline).  ``config`` supplies the method instead
    of the loose kwarg (combining the two raises ValueError); only
    ``"lazy"`` has a sharded form."""
    config_mod.check_no_conflict(config, method=method)
    method = config.method if config is not None else (method or "lazy")
    if method != "lazy":
        raise ValueError(f"sharded construction is lazy only, got "
                         f"method={method!r}")
    return build_sharded(S, mesh, axis, collectives)[0]


# ---------------------------------------------------------------------------
# sharded hub APSP
# ---------------------------------------------------------------------------

def apsp_hub_sharded(W, mesh, *, axis: str = "data",
                     n_hubs: Optional[int] = None,
                     rounds: Optional[int] = None,
                     config: Optional[PipelineConfig] = None,
                     backend: str = "auto", stats: Optional[dict] = None):
    """Hub APSP with W row-sharded; returns the row-sharded distance
    estimate (a DTensor).

    The hubs come from the ranks' row strengths (one all-gather), their
    rows of W from their owners (one all-reduce MIN).  Each Bellman-Ford
    round each rank takes ``D_h[:, local] (x) W_local`` with
    ``ops.minplus`` and one all-reduce MIN combines the (h, n) partials;
    the combined update is replicated, so the fixed-point test is the
    same on every rank (``rounds=0`` relaxes to the fixed point, as
    ``apsp_hub``).  The local rows' composition ``D_h[:, local].T (x)
    D_h``, floored by W, goes through ``ops.minplus`` too.  ``config``
    supplies ``apsp_hubs``/``apsp_rounds`` (and the backend) instead of
    the loose kwargs; ``stats``, if a dict, receives ``bf_rounds``."""
    config_mod.check_no_conflict(config, n_hubs=n_hubs, rounds=rounds)
    if config is not None:
        n_hubs, rounds, backend = (config.apsp_hubs, config.apsp_rounds,
                                   config.backend)
    n = W.shape[0]
    grp = dist_sh.group(mesh, axis)
    r0, nl = dist_sh.my_block(n, mesh, axis)
    Wl = dist_sh.local_block(W, mesh, axis).float()
    cap = rounds if rounds else n
    h = apsp_mod.hub_count(n, n_hubs or 0)

    finite = torch.isfinite(Wl) & (Wl > 0)
    part = torch.where(finite, torch.reciprocal(Wl + 1e-6), 0.0).sum(dim=1)
    strength = dist_sh.gather_rows(part, n, mesh, axis)
    hubs = torch.sort(strength, descending=True, stable=True)[1][:h]
    D_h = torch.full((h, n), float("inf"), device=Wl.device)
    if nl:
        # the hubs' rows of W from their owners, +inf from the others
        mine = (hubs >= r0) & (hubs < r0 + nl)
        D_h = torch.where(mine[:, None], Wl[(hubs - r0).clamp(0, nl - 1)],
                          D_h)
    dist.all_reduce(D_h, op=dist.ReduceOp.MIN, group=grp)

    i, changed = 0, True
    while i < cap and changed:
        part = ops.minplus(D_h[:, r0:r0 + nl].contiguous(), Wl,
                           backend=backend)
        dist.all_reduce(part, op=dist.ReduceOp.MIN, group=grp)
        D2 = torch.minimum(D_h, part)
        changed = _lowered(D2, D_h)
        D_h = D2
        i += 1
    if stats is not None:
        stats["bf_rounds"] = i
    est = ops.minplus(D_h[:, r0:r0 + nl].T.contiguous(), D_h,
                      backend=backend)                         # (n_local, n)
    torch.minimum(est, Wl, out=est)
    return dist_sh.as_dtensor(est, mesh, axis, dist_sh.timeseries_spec(axis),
                              (n, n))


def _lowered(new: torch.Tensor, old: torch.Tensor) -> bool:
    """Whether a round lowered any distance: the hub APSP's one read of
    data a round (one sync)."""
    return bool((new < old).any())


# ---------------------------------------------------------------------------
# the config-driven multi-device funnel (DESIGN.md §17.4)
# ---------------------------------------------------------------------------

def shards(cfg: PipelineConfig, have_S: bool) -> bool:
    """Whether the funnel shards ``cfg``'s stages: the top-K table from X,
    and the dense TMFG pipeline but for the sparse tail.  Every other
    config runs the single-device fused program on the whole input on
    every rank, replicated and unsharded: the top-K table cut from S and
    the sparse tail, as in the reference, and a non-TMFG filter or the
    RMT cleaning, which the reference's funnel does not read.  A
    non-lazy builder on a sharded route raises ValueError, as the
    reference's ``fused_from_table`` and ``build_tmfg_sharded`` do."""
    if cfg.filter != "tmfg" or cfg.clean != "none":
        return False
    route = (not have_S) if cfg.similarity == "topk" \
        else cfg.apsp_method != "sparse"
    if route and cfg.method != "lazy":
        raise ValueError(f"the sharded funnel's construction is lazy only, "
                         f"got method={cfg.method!r}")
    return route


def funnel(arr: torch.Tensor, have_S: bool, cfg: PipelineConfig, mesh,
           axis: str = "data") -> dict:
    """One matrix through the sharded stages of ``cfg`` (for configs
    :func:`shards` accepts): ``fused_approx.fused_one``'s dict, the same
    on every rank.

      * top-K from X: ``topk_pearson_sharded`` (each rank its row range
        of the table), one gather of the table, then
        ``fused_approx.fused_from_table``, the single-device approx body
        after its table;
      * dense: the Pearson block (or the given S), the column-sharded
        TMFG, the row-sharded hub APSP (exact squarings, replicated,
        below ``HUB_MIN_N`` or for ``apsp_method="exact"``), then the
        dense DBHT tail on the gathered S and D."""
    from . import dbht as dbht_mod
    from . import fused_approx as fa_mod

    n = arr.shape[0]
    if cfg.similarity == "topk":
        kk = min(cfg.sim_k, n - 1)
        v, i, z = dist_sh.topk_pearson_sharded(arr, kk, mesh, axis,
                                               backend=cfg.backend)
        tail = fa_mod.fused_from_table(cfg, n, from_x=True)
        return tail((v.full_tensor(), i.full_tensor()), z)

    S = arr if have_S else pearson_sharded(arr, mesh, axis)
    res, syncs = build_sharded(S, mesh, axis)
    S_full = arr if have_S else S.full_tensor()
    W = apsp_mod.edge_lengths(n, res.edges, S_full)
    stats = {"bf_rounds": 0}
    if cfg.apsp_method == "hub" and n >= apsp_mod.HUB_MIN_N:
        D = apsp_hub_sharded(W, mesh, axis=axis, config=cfg,
                             stats=stats).full_tensor()
    else:
        D = apsp_mod.apsp_exact(W, backend=cfg.backend)
    del W
    core, _ = dbht_mod.dense_tail(S_full, res, cfg, D=D)
    core.update(tmfg=res, hubs=None, overflow=False, counters=None,
                bf_rounds=stats["bf_rounds"], tmfg_host_syncs=syncs)
    return core


def run_pipeline_sharded(X_or_S, config: PipelineConfig, mesh, *,
                         is_similarity: Optional[bool] = None, caps=None,
                         device=None):
    """The whole pipeline on ``mesh``'s ``"data"`` axis, dispatched by
    ``config``: the one sharded entry point (``run_pipeline_device(...,
    mesh=)`` and the fused ``cluster(..., mesh=)`` land here).  Every
    rank passes the same (n, L) or (n, n) input and gets the same
    ``DeviceOutputs``.

    The stage entry points above stay the unit-tested building blocks;
    :func:`funnel` composes the ones the config selects (the top-K table
    from X, the scaling path, or the dense stages); every other config
    runs the single-device fused program on each rank, replicated and
    unsharded (:func:`shards`), and a non-lazy builder on a sharded
    route raises ValueError."""
    from . import pipeline as pipe    # lazy: no import cycle

    return pipe.run_pipeline_device(X_or_S, config,
                                    is_similarity=is_similarity,
                                    batched=False, caps=caps, mesh=mesh,
                                    device=device)


# ---------------------------------------------------------------------------
# a batch over the mesh: whole entries per rank, outputs all-gathered
# ---------------------------------------------------------------------------

def gather_entries(items: list, B: int, mesh, axis: str = "data") -> list:
    """The B entries' outputs on every rank, from each rank's own block of
    ``dist.sharding.block(B, d, r)`` entries (``items``, like structures
    of tensors, tuples, host ints and None): each tensor leaf stacked,
    padded to ceil(B / d) entries and all-gathered."""
    d = dist_sh.axis_size(mesh, axis)
    size = -(-B // d)
    if dist_sh.block(B, d, d - 1)[1] < 1:
        raise ValueError(f"a batch of {B} leaves a rank of {d} without an "
                         f"entry")
    dev = next(_leaves(items[0])).device

    def gather(leaves):
        first = leaves[0]
        if first is None:
            return [None] * B
        if isinstance(first, tuple):
            cols = [gather([x[f] for x in leaves])
                    for f in range(len(first))]
            return [type(first)(*(c[b] for c in cols)) for b in range(B)]
        if isinstance(first, torch.Tensor):
            t = torch.stack(leaves)
        else:
            t = torch.tensor(leaves, device=dev)
        kind = t.dtype
        if kind == torch.bool:
            t = t.to(torch.uint8)
        full = dist_sh.gather_rows(t, B, mesh, axis)
        full = full.to(kind)
        if isinstance(first, torch.Tensor):
            return list(full)
        return [type(first)(x) for x in full.tolist()]

    return gather(items)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for f in x:
            yield from _leaves(f)
