"""The port's MoE on a batch whose rows are split over data ranks, against
the JAX package's MoE and train step on the global batch.

  * ``moe.dispatch`` with ``before`` (each expert's pairs held by the
    ranks ahead): JAX's top-k of one dispatch group, cut into R
    contiguous slices of tokens, dispatched slice by slice with the
    exclusive prefix of the earlier slices' counts, fills the dispatch
    buffer bitwise JAX's and drops the same pairs.
  * ``moe.moe_apply`` under a ``moe_data`` binding, R ranks simulated by
    threads in this process (each its own autograd graph and hints; the
    sum over ranks a barrier): one group spanning 2 or 4 ranks, and 3
    ranks over two groups of 3072 tokens (a rank straddles them).  The
    ranks' outputs side by side within 1e-5 of JAX's ``moe_apply`` on
    the whole batch, the mean of their aux losses within 1e-6 of JAX's
    aux, the mean of their aux gradients and the sum of their output
    gradients (router and experts) within 1e-6 of JAX's.
  * ``make_train_step(model, run_cfg, mesh)`` at world sizes 2 and 4
    (one spawned gloo group each, ``tests/torch_dist_worker.py``, task
    ``moe_mesh``): a reduced deepseek-moe-16b (1 layer, 4 experts top-2
    and a shared one, capacity factor 0.5, aux weight 1, lr 1e-5), one
    step at 1 and 2 microbatches in two regimes: "small" (64 tokens a
    microbatch, one dispatch group spanning the ranks) and "large"
    (16384 tokens a microbatch, 8 groups of 2048: 4 whole groups a rank
    at world 2, 2 at world 4), and at world 4 three of the cases again
    on a ("data", "model") (2, 2) mesh (each expert's d_ff split over
    the model ranks, the routing replicated over them), against JAX's
    jitted single-device step
    on the global batch: the loss and the aux within 1e-5 (1e-6
    relative to the loss's scale), the gradient norm within 1e-6
    relative, the pairs dropped in the forward summed over the ranks
    equal to JAX's (counted inside its step by a ``jax.debug.callback``
    on its dispatch groups, without remat), every updated parameter
    within 1e-6, each leaf's gradient (mu = 0.1 g after one step)
    within 1e-5 of that leaf's largest |mu|, and nu = 0.001 g^2 within
    1e-6 times max(1, |nu|).

A mesh step whose ranks reckon the groups from their own tokens and
split their own rows into microbatches fails the small regime's 4
cases (its dropped pairs 69 and 38 against 64, 130 and 53 against 128).
The large regime's groups of 2048 tokens lie inside the ranks either
way: those cases hold the whole-group path and the row exchange at 2
microbatches.
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

import torch_zoo as zoo  # noqa: E402
from repro.configs import RunConfig as JRunConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import hints as jhints  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.registry import build_model as jax_build  # noqa: E402
from repro.train import optimizer as joptim  # noqa: E402
from repro.train.train_step import make_train_step as jmake  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import hints  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.train.tree import leaves  # noqa: E402

import torch_dist_worker as worker  # noqa: E402

_t, _np = zoo.t, zoo.npf
ARCH = "deepseek-moe-16b"
CF = 0.5


def _layer():
    """The reduced MoE layer (4 experts, top-2, one shared) at capacity
    factor 0.5: JAX's parameters, the port's copy and both configs."""
    pr = zoo.pair(ARCH, n_layers=1)
    jcfg = jax_get_config(ARCH).reduced(n_layers=1, capacity_factor=CF)
    cfg = dataclasses.replace(pr.cfg, capacity_factor=CF)
    jp = jax.tree.map(lambda a: a[0], pr.jp["layers"]["moe"])
    return jcfg, cfg, jp, dict(pr.tp["layers"][0]["moe"])


@pytest.fixture(scope="module")
def layer():
    return _layer()


# ---------------------------------------------------------------------------
# the dispatch, slice by slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R", [2, 4])
def test_dispatch_across_ranks_bitwise_given_jax_topk(layer, R):
    jcfg, cfg, jp, _ = layer
    x = np.random.default_rng(R).normal(size=(64, 64)).astype(np.float32)
    seen = []

    def group(p_, x_):
        out_, _ = jmoe._moe_dispatch_one(p_, x_, jcfg)
        probs = jax.nn.softmax(x_ @ p_["router"], axis=-1)
        return seen[0], lax.top_k(probs, jcfg.moe_top_k)[1]

    def record(a, name):
        if name == "moe_expert":
            seen.append(a)
        return a

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhints, "constrain", record)
        jbuf, ji = zoo.jit(group)(jp, jnp.asarray(x))
    N, E, d = x.shape[0], cfg.n_experts, x.shape[1]
    C = moe._capacity(cfg, N)
    topi = _t(np.asarray(ji)).long()
    buf = torch.zeros((E * C + 1, d))
    before = torch.zeros(E, dtype=torch.long)
    kept = 0
    for r in range(R):
        sl = topi[r * N // R:(r + 1) * N // R]
        _, ptok_s, keep, slot = moe.dispatch(sl, C, E, before)
        buf[slot] = _t(x)[r * N // R:][ptok_s]
        kept += int(keep.sum())
        before = before + moe._expert_counts(sl.reshape(-1), E)
    np.testing.assert_array_equal(buf[:-1].reshape(E, C, d).numpy(),
                                  np.asarray(jbuf))
    whole = moe.dispatch(topi, C, E)[2]
    assert kept == int(whole.sum()) < N * cfg.moe_top_k      # pairs dropped


# ---------------------------------------------------------------------------
# moe_apply over ranks simulated by threads
# ---------------------------------------------------------------------------

class _ThreadRanks:
    """R ranks as threads: ``ranks(q)`` is rank q's DataRanks, whose
    all_reduce sums the ranks' tensors in rank order behind a barrier."""

    def __init__(self, R: int):
        self.R = R
        self.slots = [None] * R
        self.barrier = threading.Barrier(R, timeout=60)

    def ranks(self, q: int) -> "hints.DataRanks":
        def all_reduce(t):
            self.slots[q] = t.clone()
            self.barrier.wait()
            total = sum(self.slots[1:], self.slots[0].clone())
            self.barrier.wait()
            return t.copy_(total)

        return hints.DataRanks(self.R, q, all_reduce)

    def run(self, fn):
        out, errors = [None] * self.R, []

        def body(q):
            try:
                out[q] = fn(q, self.ranks(q))
            except BaseException as e:              # re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(q,))
                   for q in range(self.R)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        return out


GRAD_LEAVES = ("router", "wg")


@pytest.mark.parametrize("R,N", [(2, 64), (4, 64), (3, 6144)])
def test_moe_apply_over_ranks_matches_jax(layer, R, N):
    jcfg, cfg, jp, tp = layer
    rng = np.random.default_rng(N + R)
    x = rng.normal(size=(1, N, 64)).astype(np.float32)
    w = rng.normal(size=(1, N, 64)).astype(np.float32)

    def jfn(p_, x_):
        out_, aux_ = jmoe.moe_apply(p_, x_, jcfg)
        return out_, aux_

    jout, jaux = zoo.jit(jfn)(jp, jnp.asarray(x))
    jg_aux = zoo.jit(jax.grad(lambda p_: jfn(p_, jnp.asarray(x))[1]))(jp)
    jg_out = zoo.jit(jax.grad(lambda p_: jnp.sum(
        jfn(p_, jnp.asarray(x))[0] * jnp.asarray(w))))(jp)

    def rank(q, ranks):
        rows = slice(q * N // R, (q + 1) * N // R)
        p = {k: v.detach().requires_grad_(k in GRAD_LEAVES)
             for k, v in tp.items() if k != "shared"}
        p["shared"] = tp["shared"]
        with hints.hints(moe_data=ranks):
            out, aux = moe.moe_apply(p, _t(x[:, rows]), cfg)
        leaf = [p[k] for k in GRAD_LEAVES]
        g_aux = torch.autograd.grad(aux, leaf, retain_graph=True,
                                    allow_unused=True)
        g_aux = [torch.zeros_like(a) if g is None else g
                 for g, a in zip(g_aux, leaf)]
        g_out = torch.autograd.grad((out * _t(w[:, rows])).sum(), leaf)
        return out.detach(), float(aux.detach()), g_aux, g_out

    res = _ThreadRanks(R).run(rank)
    out = torch.cat([r[0] for r in res], dim=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    assert abs(np.mean([r[1] for r in res]) - float(jaux)) <= 1e-6
    for i, k in enumerate(GRAD_LEAVES):
        g_aux = sum(r[2][i] for r in res) / R
        g_out = sum(r[3][i] for r in res)
        np.testing.assert_allclose(g_aux.numpy(), np.asarray(jg_aux[k]),
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(g_out.numpy(), np.asarray(jg_out[k]),
                                   atol=1e-6 * max(1.0, float(
                                       np.abs(jg_out[k]).max())),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the train step at world sizes 2 and 4
# ---------------------------------------------------------------------------

# case -> (microbatches, global batch rows, sequence length)
CASES = {"small1": (1, 4, 16), "small2": (2, 8, 16),
         "large1": (1, 64, 256), "large2": (2, 128, 256)}
LR = 1e-5


def _jax_drops(jcfg, record):
    """JAX's moe_apply with the pairs its dispatch groups drop handed to
    ``record`` (a debug callback: at run time, in its step)."""
    apply = jmoe.moe_apply

    def counted(p, x, cfg):
        B, T, d = x.shape
        N = B * T
        G = jmoe._n_groups(N)
        C = jmoe._capacity(cfg, N // G)
        probs = jax.nn.softmax(
            x.reshape(G, N // G, d).astype(jnp.float32) @ p["router"], -1)
        _, topi = lax.top_k(probs, cfg.moe_top_k)
        counts = jax.nn.one_hot(topi, cfg.n_experts).sum((1, 2))
        jax.debug.callback(record, jnp.maximum(counts - C, 0).sum())
        return apply(p, x, cfg)

    return counted


@pytest.fixture(scope="module")
def moe_mesh(tmp_path_factory):
    """The ranks' outputs at world sizes 2 and 4 (two spawned groups, run
    beside JAX's steps) and JAX's: {case: (metrics, drops, params, mu,
    nu)}."""
    rng = np.random.default_rng(7)
    cfg = get_config(ARCH).reduced(n_layers=1, capacity_factor=CF)
    batches = {c: {k: rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
                   for k in ("tokens", "targets")}
               for c, (m, B, T) in CASES.items()}
    arrays = {f"{c}_{k}": v for c, b in batches.items() for k, v in b.items()}
    arrays.update({f"{c}_m": np.array(m) for c, (m, _, _) in CASES.items()})
    ranks, threads = {}, []
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"moe_mesh{world}")
        np.savez(tmp / "moe_mesh.npz", **arrays)

        def run(world=world, tmp=tmp):
            try:
                ranks[world] = worker.spawn("moe_mesh", world, tmp)
            except BaseException as e:             # re-raised below
                ranks[f"error{world}"] = e

        threads.append(threading.Thread(target=run))
        threads[-1].start()

    tm = build_model(cfg, device="cpu")
    jcfg = jax_get_config(ARCH).reduced(n_layers=1, capacity_factor=CF)
    jm = jax_build(jcfg)
    jp0 = zoo.jax_params(tm, jm)
    want, drops = {}, []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmoe, "moe_apply",
                   _jax_drops(jcfg, lambda v: drops.append(int(v))))
        for c, (m, _, _) in CASES.items():
            jstep = zoo.jit(jmake(jm, JRunConfig(
                lr=LR, warmup_steps=1, total_steps=10, microbatches=m),
                loss_kwargs={"aux_weight": 1.0, "remat": False}))
            drops.clear()
            jp, jo, met = jstep(jp0, joptim.init(jp0),
                                {k: jnp.asarray(v)
                                 for k, v in batches[c].items()})
            jax.block_until_ready(jp)
            want[c] = ({k: float(v) for k, v in met.items()}, sum(drops),
                       *[[zoo.npf(x) for x in leaves(params_from_jax(t))]
                         for t in (jp, jo.mu, jo.nu)])
    for th in threads:
        th.join()
    for world in (2, 4):
        if f"error{world}" in ranks:
            raise ranks[f"error{world}"]
    return ranks, want


@pytest.mark.parametrize("world", [2, 4])
def test_moe_mesh_ranks_agree(moe_mesh, world):
    outs = moe_mesh[0][world]
    for o in outs[1:]:
        for key in o:
            if not key.endswith("_drops"):
                np.testing.assert_array_equal(o[key], outs[0][key],
                                              err_msg=key)


def _check_step(outs, want, case, key):
    """The step of ``case`` saved under ``key`` against JAX's."""
    met, drops, params, mu, nu = want
    o = outs[0]
    assert sum(int(r[f"{key}_drops"]) for r in outs) == drops > 0
    loss = float(o[f"{key}_met_loss"])
    assert abs(loss - met["loss"]) <= 1e-6 * max(1.0, abs(met["loss"]))
    gn = float(o[f"{key}_met_grad_norm"])
    assert abs(gn - met["grad_norm"]) <= 1e-6 * max(1.0, met["grad_norm"])
    if CASES[case][0] == 1:
        assert abs(float(o[f"{key}_met_aux"]) - met["aux"]) <= 1e-6
        assert abs(float(o[f"{key}_met_ce"]) - met["ce"]) <= 1e-6 * max(
            1.0, met["ce"])
    for i, w in enumerate(params):
        d = np.abs(o[f"{key}_p_{i}"] - w).max()
        assert d <= 1e-6, ("p", i, d)
    # after one step mu is (1 - b1) g: each leaf's gradient, held
    # relative to that leaf's largest entry
    for i, w in enumerate(mu):
        d = np.abs(o[f"{key}_mu_{i}"] - w).max()
        assert d <= 1e-5 * np.abs(w).max(), ("mu", i, d)
    for i, w in enumerate(nu):
        d = np.abs(o[f"{key}_nu_{i}"] - w).max()
        assert d <= 1e-6 * max(1.0, np.abs(w).max()), ("nu", i, d)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world", [2, 4])
def test_moe_mesh_step_matches_jax(moe_mesh, world, case):
    _check_step(moe_mesh[0][world], moe_mesh[1][case], case, case)


@pytest.mark.parametrize("case", worker.MOE_TP_CASES)
def test_moe_mesh_tp_step_matches_jax(moe_mesh, case):
    """The step on a ("data", "model") (2, 2) mesh: the experts' d_ff
    split over the 2 model ranks, the global dispatch groups over the 2
    data ranks."""
    _check_step(moe_mesh[0][4], moe_mesh[1][case], case, f"tp_{case}")
