"""The port's MoE layer and MoE decoders against the JAX package's.

``models/moe.py`` stage by stage: the fp32 router's top-k (ties to the
lowest expert), the sort-based dispatch and the combine bitwise JAX's
given JAX's own top-k (the reference's dispatch buffer and expert output
are read through its ``dist.hints.constrain`` calls, which pass them
through unchanged without a mesh), ``moe_apply`` with and without
capacity drops and at 4096 tokens (two dispatch groups, each with its
own capacity) within 1e-5, and ``moe_apply_dense_ref``; then
deepseek-moe-16b and mixtral-8x7b, reduced (fp32), through forward (the
aux loss too), prefill and greedy decode: logits within 1e-4, greedy
tokens equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

import torch_zoo as zoo  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import hints as jhints  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

_t, _np = zoo.t, zoo.npf


def _layer(capacity_factor=1.25):
    """deepseek's reduced MoE layer (4 experts, top-2, one shared): the
    first layer of the JAX model's parameters and the port's copy, and
    both configs at ``capacity_factor``."""
    pr = zoo.pair("deepseek-moe-16b", n_layers=2)
    jcfg = jax_get_config("deepseek-moe-16b").reduced(
        n_layers=2, capacity_factor=capacity_factor)
    cfg = dataclasses.replace(pr.cfg, capacity_factor=capacity_factor)
    jp = jax.tree.map(lambda a: a[0], pr.jp["layers"]["moe"])
    tp = dict(pr.tp["layers"][0]["moe"])
    return jcfg, cfg, jp, tp


_jmoe_apply = zoo.jit(jmoe.moe_apply, static_argnums=2)


def _x(T, seed, d=64):
    return np.random.default_rng(seed).normal(size=(1, T, d)) \
        .astype(np.float32)


def test_capacity_and_groups_as_the_reference():
    cfg = get_config("deepseek-moe-16b")
    jcfg = jax_get_config("deepseek-moe-16b")
    for N in (1, 4, 100, 2048, 4096, 8192, 4100, 65536):
        assert moe._capacity(cfg, N) == jmoe._capacity(jcfg, N)
        assert moe._n_groups(N) == jmoe._n_groups(N)
    assert moe._n_groups(4096) == 2 and moe._capacity(cfg, 4) == 8


def test_router_tie_goes_to_the_lowest_expert():
    """Experts 1 and 3 share a router column, the others are zero: each
    token's probabilities tie in pairs, {1, 3} on top where the shared
    logit is positive and {0, 2} where it is negative.  lax.top_k takes
    the lower expert first, and so does the port's stable sort."""
    jcfg, cfg, jp, tp = _layer()
    x = _x(16, 1)[0]
    r = np.zeros_like(np.asarray(jp["router"]))
    r[:, 1] = r[:, 3] = np.asarray(jp["router"])[:, 0]
    probs, topv, topi = moe.route(dict(tp, router=_t(r)), _t(x), cfg)
    jv, ji = zoo.jit(lambda x_, r_: lax.top_k(
        jax.nn.softmax(x_ @ r_, axis=-1), 2))(jnp.asarray(x), jnp.asarray(r))
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
    rows = {tuple(row) for row in topi.tolist()}
    assert rows == {(1, 3), (0, 2)}, rows
    np.testing.assert_array_equal(_np(topv), np.full((16, 2), 0.5,
                                                     np.float32))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
def test_dispatch_and_combine_bitwise_given_jax_topk(monkeypatch,
                                                     capacity_factor):
    """Given JAX's top-k experts and weights, the port's dispatch buffer
    (slots and keep mask: every kept pair at its slot, the dropped pairs
    nowhere) is bitwise JAX's, and its combine of JAX's expert output is
    bitwise JAX's group output.  capacity_factor 0.25 drops pairs."""
    jcfg, cfg, jp, tp = _layer(capacity_factor)
    x = _x(64, 2)[0]
    seen = []

    def record(a, name):
        if name == "moe_expert":
            seen.append(a)
        return a

    monkeypatch.setattr(jhints, "constrain", record)

    def group(p_, x_):
        seen.clear()
        out_, _ = jmoe._moe_dispatch_one(p_, x_, jcfg)
        probs = jax.nn.softmax(x_ @ p_["router"], axis=-1)
        v_, i_ = lax.top_k(probs, jcfg.moe_top_k)
        return out_, seen[0], seen[1], v_, i_

    jout, jbuf, jy, jv, ji = zoo.jit(group)(jp, jnp.asarray(x))
    jv = jv / jnp.maximum(jv.sum(-1, keepdims=True), 1e-9)

    N, E = x.shape[0], cfg.n_experts
    C = moe._capacity(cfg, N)
    order, ptok_s, keep, slot = moe.dispatch(_t(np.asarray(ji)).long(), C, E)
    dropped = int((~keep).sum())
    assert (dropped > 0) == (capacity_factor < 1)
    buf = torch.zeros((E * C + 1, x.shape[1]))
    buf[slot] = _t(x)[ptok_s]
    np.testing.assert_array_equal(buf[:-1].reshape(E, C, -1).numpy(),
                                  np.asarray(jbuf))
    pw_s = _t(np.asarray(jv)).reshape(-1)[order]
    out = moe.combine(_t(jy), keep, slot, pw_s, ptok_s, N)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize("capacity_factor,T", [(1.25, 48), (0.25, 48),
                                               (0.25, 4096)])
def test_moe_apply_against_jax(capacity_factor, T):
    """Out and aux within 1e-5; at 4096 tokens the dispatch runs in two
    groups of 2048, each with its own capacity (drops differ from one
    ungrouped dispatch)."""
    jcfg, cfg, jp, tp = _layer(capacity_factor)
    x = _x(T, 3)
    want, jaux = _jmoe_apply(jp, jnp.asarray(x), jcfg)
    got, aux = moe.moe_apply(tp, _t(x), cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    if T == 4096:
        one, _ = moe._moe_dispatch_one(tp, _t(x)[0], cfg)
        one = one + moe._shared(tp, _t(x)[0])
        assert float((one - got[0]).abs().max()) > 1e-3


def test_moe_apply_dense_ref_against_jax_and_the_dispatch():
    """The dense oracle against JAX's, and against the dispatch where no
    pair is dropped."""
    jcfg, cfg, jp, tp = _layer(8.0)
    x = _x(24, 4)
    want = zoo.jit(jmoe.moe_apply_dense_ref, static_argnums=2)(
        jp, jnp.asarray(x), jcfg)
    got = moe.moe_apply_dense_ref(tp, _t(x), cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(_np(moe.moe_apply(tp, _t(x), cfg)[0]),
                               _np(got), atol=1e-5)


# ---------------------------------------------------------------------------
# the MoE decoders
# ---------------------------------------------------------------------------

@pytest.fixture(params=["deepseek-moe-16b", "mixtral-8x7b"])
def pair(request):
    return zoo.pair(request.param, n_layers=2)


def test_forward_logits_and_aux(pair):
    """params_from_jax carries the MoE layers (router, stacked experts,
    shared experts) across: the logits within 1e-4, the summed aux loss
    within 1e-6 (at the engine test's prompt shape)."""
    toks = np.random.default_rng(5).integers(0, pair.cfg.vocab, (1, 40),
                                             dtype=np.int32)
    want, jaux = zoo.jax_forward(pair, toks, max_len=64)
    got, _, aux = pair.tm.forward(pair.tp, toks)
    np.testing.assert_allclose(_np(got), want, atol=zoo.ATOL)
    assert abs(float(aux) - jaux) <= 1e-6 and float(aux) > 0


def test_prefill_and_greedy_decode_through_the_engine(pair):
    """Two slots serve three 40-token prompts (4, 6 and 5 new tokens: the
    third joins beside the second mid-stream): every prefill's and decode
    step's logits within 1e-4 of the JAX engine's, the same greedy tokens
    and steps.  mixtral's window (32 reduced) is shorter than the
    prompts: a ring buffer; each decode step dispatches 2 tokens at
    C = 8."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, pair.cfg.vocab, 40, dtype=np.int32)
               for _ in range(3)]
    zoo.serve_both(pair, prompts, n_new=[4, 6, 5], n_slots=2, max_len=64)
