"""The port's Mamba2, mLSTM and sLSTM blocks and the zamba2 and xLSTM
models against the JAX package's.

The blocks at ``tests/test_ssm.py``'s config: the chunked SSD within
3e-4 (the reference's own tolerance) of JAX's and of the port's
sequential oracle at several chunks, its last state too; the recurrent
decode against the oracle; mLSTM and sLSTM forward (and last states)
against JAX's and their decode against their forward.  Then zamba2-2.7b
(two groups of two Mamba2 layers and the shared attention block) and
xlstm-125m (m, s, m, s) reduced (fp32) through forward and through both
engines: logits within 1e-4, greedy tokens equal.  zamba2's stacked
``mamba_S`` has its batch axis second: both engines keep it as the
first request left it until a decode step broadcasts it, and a later
admission does not overwrite it (ROADMAP Queue 3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_zoo as zoo  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

_t, _np = zoo.t, zoo.npf

_KW = dict(name="t", family="hybrid", n_layers=2, d_model=32, n_heads=4,
           n_kv_heads=4, d_ff=64, vocab=100, head_dim=8, ssm_state=16,
           ssm_head_dim=16, dtype="float32")
JCFG, CFG = JModelConfig(**_KW), ModelConfig(**_KW)


def _jax(tp):
    return {k: jnp.asarray(v.numpy()) for k, v in tp.items()}


@pytest.fixture(scope="module")
def mamba():
    """The block's parameters, drawn by the port's init (A_log, dt_bias,
    D and conv_b redrawn, so the decay, step, skip and bias are not their
    constant inits), the input and JAX's chunked forward on them."""
    tp = ssm.mamba2_init(torch.Generator().manual_seed(0), CFG,
                         torch.float32)
    r = np.random.default_rng(0)
    H = tp["A_log"].shape[0]
    for k, scale in (("A_log", 0.5), ("dt_bias", 0.5), ("D", 1.0),
                     ("conv_b", 0.1)):
        tp[k] = _t(r.normal(size=tuple(tp[k].shape)) * scale).float()
    x = r.normal(size=(2, 37, 32)).astype(np.float32)
    want, jS = zoo.jit(lambda p_, x_: jssm.mamba2_forward(p_, x_, JCFG,
                                                          chunk=16))(
        _jax(tp), jnp.asarray(x))
    return tp, x, np.asarray(want), np.asarray(jS)


def test_mamba2_chunked_against_jax(mamba):
    """chunk 16 over 37 positions (a padded last chunk): the output and
    the last state within 3e-4 of JAX's."""
    tp, x, want, jS = mamba
    got, S = ssm.mamba2_forward(tp, _t(x), CFG, chunk=16)
    np.testing.assert_allclose(_np(got), want, atol=3e-4)
    np.testing.assert_allclose(_np(S), jS, atol=3e-4)


@pytest.mark.parametrize("chunk", [4, 8, 64, 128])
def test_mamba2_chunked_against_the_sequential_oracle(mamba, chunk):
    tp, x, want, _ = mamba
    seq = ssm.mamba2_sequential_ref(tp, _t(x), CFG)
    np.testing.assert_allclose(_np(seq), want, atol=3e-4)
    got, _ = ssm.mamba2_forward(tp, _t(x), CFG, chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(seq), atol=3e-4)


def test_mamba2_decode_against_forward(mamba):
    """Token by token from a zero state: the oracle's outputs, and the
    chunked forward's last state."""
    tp, x, _, _ = mamba
    seq = ssm.mamba2_sequential_ref(tp, _t(x), CFG)
    _, S_fwd = ssm.mamba2_forward(tp, _t(x), CFG)
    st = ssm.mamba2_state_init(CFG, 2, torch.float32, "cpu")
    outs = []
    for t in range(x.shape[1]):
        o, st = ssm.mamba2_decode(tp, _t(x[:, t:t + 1]), st, CFG)
        outs.append(o)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(seq), atol=3e-4)
    np.testing.assert_allclose(_np(st.S), _np(S_fwd), atol=3e-4)
    assert st.conv.shape == (2, CFG.ssm_conv - 1, 64 + 2 * 16)


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_xlstm_cells_against_jax_and_decode(cell):
    """Forward and last state within 3e-4 of JAX's (on the port's init,
    whose parameters have JAX's names, shapes and dtypes); decode token by
    token against the port's forward."""
    tp = getattr(ssm, f"{cell}_init")(torch.Generator().manual_seed(1), CFG,
                                      torch.float32)
    x = np.random.default_rng(2).normal(size=(2, 25, 32)).astype(np.float32)
    jfwd = getattr(jssm, f"{cell}_forward")
    want, jst = zoo.jit(lambda p_, x_: jfwd(p_, x_, JCFG))(_jax(tp),
                                                           jnp.asarray(x))
    got, st = getattr(ssm, f"{cell}_forward")(tp, _t(x), CFG)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=3e-4)
    for a, b in zip(jst, st):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=3e-4)
    st = getattr(ssm, f"{cell}_state_init")(CFG, 2, "cpu")
    outs = []
    for t in range(x.shape[1]):
        o, st = getattr(ssm, f"{cell}_decode")(tp, _t(x[:, t:t + 1]), st,
                                               CFG)
        outs.append(o)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(got), atol=3e-4)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.fixture(params=["zamba2-2.7b", "xlstm-125m"])
def pr(request):
    return zoo.pair(request.param)


def test_forward(pr):
    """params_from_jax carries zamba2's stacked Mamba2 layers and shared
    block, and xLSTM's heterogeneous list: logits within 1e-4."""
    toks = np.random.default_rng(11).integers(0, pr.cfg.vocab, (1, 20),
                                              dtype=np.int32)
    want, _ = zoo.jax_forward(pr, toks, max_len=48)
    got, _, _ = pr.tm.forward(pr.tp, toks)
    np.testing.assert_allclose(_np(got), want, atol=zoo.ATOL)


def test_engine(pr):
    """Two slots serve three 20-token prompts (4, 6 and 5 new tokens: the
    third takes the first's slot mid-stream, beside the second): each
    prefill and decode step within 1e-4 of the JAX engine's, the same
    greedy tokens and steps.  zamba2's shared block has a 32-token window
    (reduced), and its state's quirk is held as the reference's: after
    the first decode step every slot's Mamba2 state is the first
    request's."""
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, pr.cfg.vocab, 20, dtype=np.int32)
               for _ in range(3)]
    zoo.serve_both(pr, prompts, n_new=[4, 6, 5], n_slots=2, max_len=48)
    if pr.cfg.family == "hybrid":
        engine = ServeEngine(pr.tm, pr.tp, n_slots=2, max_len=48)
        for i, p in enumerate(prompts[:2]):
            engine.submit(Request(uid=i, prompt=p, max_new_tokens=3))
        engine._admit()
        S = engine.caches["mamba_S"][0]
        assert S.shape[:2] == (pr.cfg.attn_every, 1)
        _, st, _ = pr.tm.prefill(pr.tp, prompts[0][None], max_len=48)
        assert torch.equal(S, st["mamba_S"][0])
