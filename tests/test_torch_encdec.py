"""The port's cross attention and encoder-decoder (seamless-m4t) against
the JAX package's.

``cross_attention`` and ``encoder_kv`` within 1e-5; ``attention_full``
with ``causal=False`` (the encoder's) within 1e-5; then
seamless-m4t-large-v2 reduced (fp32; two encoder and four decoder
layers over 8 stub frame embeddings) through the encoder, forward, and
both engines (the caches a dict of the self-attention caches and the
per-layer cross (k, v)): the encoder's output within 1e-5, logits within
1e-4, greedy tokens equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_zoo as zoo  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

_t, _np = zoo.t, zoo.npf


@pytest.fixture(scope="module")
def pr():
    return zoo.pair("seamless-m4t-large-v2")


def _xattn(pr):
    """The first decoder layer's cross-attention weights."""
    jp = jax.tree.map(lambda a: a[0], pr.jp["dec_layers"]["xattn"])
    return jp, pr.tp["dec_layers"][0]["xattn"]


def test_cross_attention_and_encoder_kv(pr):
    jp, tp = _xattn(pr)
    r = np.random.default_rng(13)
    enc = r.normal(size=(2, 8, pr.cfg.d_model)).astype(np.float32)
    x = r.normal(size=(2, 5, pr.cfg.d_model)).astype(np.float32)
    cfg = pr.jm.cfg
    jkv = zoo.jit(jattn.encoder_kv, static_argnums=2)(jp, jnp.asarray(enc),
                                                      cfg)
    want = zoo.jit(lambda p_, x_, kv_: jattn.cross_attention(
        p_, x_, kv_, cfg=cfg))(jp, jnp.asarray(x), jkv)
    kv = attn.encoder_kv(tp, _t(enc), pr.cfg)
    for a, b in zip(jkv, kv):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=1e-5)
    got = attn.cross_attention(tp, _t(x), kv, cfg=pr.cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_non_causal_attention_full(pr):
    """The encoder's attention: every position sees every other."""
    jp = jax.tree.map(lambda a: a[0], pr.jp["enc_layers"]["attn"])
    tp = pr.tp["enc_layers"][0]["attn"]
    x = np.random.default_rng(14).normal(size=(2, 12, pr.cfg.d_model)) \
        .astype(np.float32)
    pos = np.tile(np.arange(12, dtype=np.int32), (2, 1))
    cfg = pr.jm.cfg
    want, _ = zoo.jit(lambda p_, x_, q_: jattn.attention_full(
        p_, x_, q_, cfg=cfg, window=0, causal=False, q_chunk=8,
        kv_chunk=8))(jp, jnp.asarray(x), jnp.asarray(pos))
    got, _ = attn.attention_full(tp, _t(x), _t(pos), cfg=pr.cfg, window=0,
                                 causal=False)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    causal, _ = attn.attention_full(tp, _t(x), _t(pos), cfg=pr.cfg,
                                    window=0)
    assert float((causal - got)[:, :-1].abs().max()) > 1e-3
    np.testing.assert_allclose(_np(causal[:, -1]), _np(got[:, -1]),
                               atol=1e-5)


def test_encoder_and_forward(pr):
    rng = np.random.default_rng(15)
    toks = rng.integers(0, pr.cfg.vocab, (1, 16), dtype=np.int32)
    fe = zoo.frontend(pr.cfg, rng)[None]
    enc = zoo.jit(lambda p_, f_: pr.jm.encode(p_, f_, remat=False,
                                              for_grad=False))(
        pr.jp, jnp.asarray(fe))
    np.testing.assert_allclose(_np(pr.tm.encode(pr.tp, fe)), np.asarray(enc),
                               atol=1e-5)
    want, _ = zoo.jax_forward(pr, toks, fe, max_len=32)
    got = pr.tm.forward(pr.tp, toks, fe)
    assert got.shape == (1, 16, pr.cfg.vocab_padded)
    np.testing.assert_allclose(_np(got), want, atol=zoo.ATOL)


def test_engine(pr):
    """Two slots serve three requests of 8 frames and 16 tokens (4, 6 and
    5 new tokens): each prefill and decode step within 1e-4 of the JAX
    engine's, the same greedy tokens and steps; the batched caches hold
    the self-attention caches and the cross (k, v) per layer."""
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, pr.cfg.vocab, 16, dtype=np.int32)
               for _ in range(3)]
    fes = [zoo.frontend(pr.cfg, rng) for _ in range(3)]
    zoo.serve_both(pr, prompts, fes, n_new=[4, 6, 5], n_slots=2, max_len=32)
    _, caches, pos = pr.tm.prefill(pr.tp, prompts[0][None], fes[0][None],
                                   max_len=32)
    assert pos == 16 and set(caches) == {"self", "cross"}
    assert len(caches["self"]) == len(caches["cross"]) == pr.cfg.n_layers
    assert caches["cross"][0][0].shape == (1, 8, pr.cfg.n_kv_heads,
                                           pr.cfg.head_dim)
