"""The port's M-RoPE and frontend adapter (qwen2-vl) against the JAX
package's.

``layers.apply_mrope`` within 1e-5 of JAX's at three distinct position
streams, and equal to ``apply_rope`` where the streams are equal; the
stub (t, h, w) position streams of ``DecoderModel._positions`` equal to
JAX's; then qwen2-vl-72b reduced (fp32; 8 frontend patch embeddings,
projected and prepended) through forward and through both engines
(prefill with a frontend, decode with (B, 1) positions broadcast to
three streams): logits within 1e-4, greedy tokens equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_zoo as zoo  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.models import layers  # noqa: E402

_t, _np = zoo.t, zoo.npf


def test_apply_mrope_against_jax():
    """qwen2-vl's head (hd 128: 64 frequencies in sections of 16, 24 and
    24) at theta 1e6 and positions up to 5000, three distinct streams.
    The JAX function runs eagerly, as written: under ``jax.jit`` XLA's
    fused sin and cos move its output by up to 4e-5 at these angles."""
    r = np.random.default_rng(128)
    x = r.normal(size=(2, 9, 4, 128)).astype(np.float32)
    pos3 = r.integers(0, 5000, (3, 2, 9)).astype(np.int32)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6)
    got = layers.apply_mrope(_t(x), _t(pos3), 1e6)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("hd", [16, 80, 128])
def test_apply_mrope_with_equal_streams_is_rope(hd):
    """hd/2 = 8, 40 and 64: sections (2, 3, 3), (10, 15, 15) and
    (16, 24, 24); with three equal streams M-RoPE is RoPE bitwise, and a
    stream moved moves only its own section's frequencies."""
    r = np.random.default_rng(hd)
    x = r.normal(size=(2, 9, 4, hd)).astype(np.float32)
    pos = r.integers(0, 5000, (2, 9)).astype(np.int32)
    same = np.broadcast_to(pos, (3, 2, 9))
    np.testing.assert_array_equal(
        layers.apply_mrope(_t(x), _t(same)).numpy(),
        layers.apply_rope(_t(x), _t(pos)).numpy())
    half = hd // 2
    secs = [round(0.25 * half), round(0.375 * half)]
    moved = same.copy()
    moved[2] += 7
    d = (layers.apply_mrope(_t(x), _t(moved))
         - layers.apply_mrope(_t(x), _t(same))).abs().amax(dim=(0, 1, 2))
    w_cols = list(range(secs[0] + secs[1], half))
    w_cols += [c + half for c in w_cols]
    assert float(d[w_cols].min()) > 0
    assert float(d[[c for c in range(hd) if c not in w_cols]].max()) == 0


@pytest.fixture(scope="module")
def pr():
    return zoo.pair("qwen2-vl-72b", n_layers=2)


def test_mrope_position_streams(pr):
    """Positions below frontend_len (8) take grid ids (p // 16, p % 16),
    the rest equal streams, as the reference's stub."""
    got = pr.tm._positions(2, 20)
    want = zoo.jit(lambda: pr.jm._positions(2, 20))()
    assert got.shape == (3, 2, 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forward_with_frontend(pr):
    """The frontend embeddings (B, 8, d) are cast, projected by
    ``frontend_proj`` and prepended: logits (B, 8 + T, V) within 1e-4."""
    rng = np.random.default_rng(9)
    toks = rng.integers(0, pr.cfg.vocab, (1, 16), dtype=np.int32)
    fe = zoo.frontend(pr.cfg, rng)[None]
    want, _ = zoo.jax_forward(pr, toks, fe, max_len=48)
    got, _, _ = pr.tm.forward(pr.tp, toks, fe)
    assert got.shape == (1, 8 + 16, pr.cfg.vocab_padded)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=zoo.ATOL)


def test_engine_with_frontends(pr):
    """Two slots serve three requests of 8 patch embeddings and 16 tokens
    (4, 6 and 5 new tokens): each prefill and decode step within 1e-4 of
    the JAX engine's, the same greedy tokens and steps."""
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, pr.cfg.vocab, 16, dtype=np.int32)
               for _ in range(3)]
    fes = [zoo.frontend(pr.cfg, rng) for _ in range(3)]
    zoo.serve_both(pr, prompts, fes, n_new=[4, 6, 5], n_slots=2, max_len=48)
