"""The port's int8 KV cache against the JAX package's.

``_quant`` bitwise (``torch.round`` and ``jnp.round`` both round half to
even; the values clipped to +-127), the cache filled from a prefill
bitwise and one decode step against it within 1e-5 (a global cache and
a ring shorter than the prompt, window 0 and 6), a ``kv_quant=True``
decoder (window 6: every layer an int8 ring) served by the engine within
1e-4 of the JAX engine with the same greedy tokens, and the int8
caches' bytes against a bf16 cache's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_zoo as zoo  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

_t, _np = zoo.t, zoo.npf


def test_quant_bitwise_with_exact_halves():
    """Random rows, and a row whose max is 127 (scale 1.0 in fp32), so
    that +-0.5, 2.5 and 3.5 land on exact halves."""
    x = np.random.default_rng(0).normal(size=(3, 5, 2, 16)) \
        .astype(np.float32) * 3
    x[0, 0, 0] = [127.0, 2.5, 3.5, -0.5, 0.5, -2.5, 1.5, -127.0,
                  0.0, 4.5, -3.5, 126.5, 5.5, -1.5, 0.25, 7.5]
    jq, js = jattn._quant(jnp.asarray(x))
    q, s = attn._quant(_t(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[0, 0, 0, :4].tolist() == [127, 2, 4, 0]


def _pair():
    """granite-3-8b reduced, window 6 (every layer a 6-slot ring), with
    int8 caches."""
    return zoo.pair("granite-3-8b", kv_quant=True, n_layers=2, window=6)


_jdecode_quant = zoo.jit(jattn.attention_decode_quant,
                         static_argnames=("cfg", "window"))


@pytest.mark.parametrize("capacity,window", [(32, 0),    # global
                                             (10, 6)])   # a ring of 10 < T
def test_quant_cache_fill_and_decode(capacity, window):
    """Seeded prefill keys and values (B 2, T 24) quantized into both
    caches bitwise (the JAX fill runs eagerly, op by op as the reference
    writes it: under ``jax.jit`` XLA rounds the scale's division by 127
    otherwise, and 3 of 128 scales move by one ulp); then, with the
    first layer's attention weights, one decode step per sequence at its
    own position (24 and 19), the JAX step jitted: outputs within 1e-5,
    every slot the step did not write bitwise JAX's, and the two it
    wrote bitwise eager ``_quant`` of the step's own key and value (the
    jitted step's division by 127 rounds otherwise, as in the fill)."""
    pr = _pair()
    cfg = pr.jm.cfg
    jp = jax.tree.map(lambda a: a[0], pr.jp["layers"]["attn"])
    tp = pr.tp["layers"][0]["attn"]
    r = np.random.default_rng(3)
    k, v = (r.normal(size=(2, 24, cfg.n_kv_heads, cfg.head_dim))
            .astype(np.float32) for _ in range(2))
    positions = jnp.arange(24, dtype=jnp.int32)[None]
    jc = jattn.quant_cache_fill_from_prefill(
        jattn.quant_cache_init(cfg, 2, capacity), jnp.asarray(k),
        jnp.asarray(v), positions)
    tc = attn.quant_cache_fill_from_prefill(
        attn.quant_cache_init(cfg, 2, capacity, "cpu"), _t(k), _t(v),
        _t(positions))
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    xd = r.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    step_pos = np.array([24, 19], np.int32)
    want, jc2 = _jdecode_quant(jp, jnp.asarray(xd), jc,
                               jnp.asarray(step_pos), cfg=cfg, window=window)
    got, tc2 = attn.attention_decode_quant(tp, _t(xd), tc, _t(step_pos),
                                           cfg=pr.cfg, window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    new = np.zeros(tc2.slot_pos.shape, bool)
    new[[0, 1], step_pos % capacity] = True
    np.testing.assert_array_equal(np.asarray(jc2.slot_pos),
                                  tc2.slot_pos.numpy())
    for a, b in zip(jc2[:4], tc2[:4]):
        np.testing.assert_array_equal(np.asarray(a)[~new], b.numpy()[~new])
    _, pos_q = attn._decode_positions(_t(step_pos), 2, pr.cfg, "cpu")
    _, k_new, v_new = attn._project_qkv(tp, _t(xd), pr.cfg, pos_q)
    jqk, jsk = jattn._quant(jnp.asarray(_np(k_new[:, 0])))
    jqv, jsv = jattn._quant(jnp.asarray(_np(v_new[:, 0])))
    for a, b in zip((jqk, jqv, jsk, jsv), tc2[:4]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy()[new])


def test_kv_quant_model_through_the_engine():
    """granite-3-8b reduced with ``kv_quant=True`` and window 6: two
    slots serve three 12-token prompts (4, 6 and 5 new tokens), every
    layer's 6-slot int8 ring overwritten as they decode: every prefill's
    and decode step's logits within 1e-4 of the JAX engine's, the same
    greedy tokens and steps."""
    pr = _pair()
    assert pr.tm.kv_quant and pr.jm.kv_quant
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, pr.cfg.vocab, 12, dtype=np.int32)
               for _ in range(3)]
    zoo.serve_both(pr, prompts, n_new=[4, 6, 5], n_slots=2, max_len=32)


def test_kv_quant_prefill_caches_are_int8_rings():
    pr = _pair()
    toks = np.arange(12, dtype=np.int32)[None]
    _, caches, pos = pr.tm.prefill(pr.tp, toks, max_len=32)
    assert pos == 12 and len(caches) == pr.cfg.n_layers
    for c in caches:
        assert isinstance(c, attn.QuantKVCache) and c.k.dtype == torch.int8
        assert c.k.shape[1] == 6
        assert sorted(c.slot_pos[0].tolist()) == list(range(6, 12))
    assert pr.tm.decode_state(3, 32)[0].k_scale.shape == (
        3, 6, pr.cfg.n_kv_heads)


def test_int8_cache_bytes_against_bf16():
    """At a full-size head (hd 128, 16 KV heads: deepseek-moe-16b's) the
    int8 caches (values, fp32 scales per slot and head, slot positions)
    hold 0.516x the bytes of bf16 caches, as the JAX package's do."""
    cfg = get_config("deepseek-moe-16b").reduced(
        dtype="bfloat16", head_dim=128, n_heads=16, n_kv_heads=16)
    jcfg = jax_get_config("deepseek-moe-16b").reduced(
        dtype="bfloat16", head_dim=128, n_heads=16, n_kv_heads=16)

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for c in tree for t in c)

    full = build_model(cfg, device="cpu").decode_state(4, 256)
    quant = build_model(cfg, kv_quant=True, device="cpu").decode_state(4, 256)
    ratio = nbytes(quant) / nbytes(full)
    jfull = jattn.cache_init(jcfg, 4, 256, jnp.bfloat16)
    jquant = jattn.quant_cache_init(jcfg, 4, 256)
    jratio = sum(np.asarray(a).nbytes for a in jquant) / \
        sum(np.asarray(a).nbytes for a in jfull)
    assert abs(ratio - jratio) < 1e-12 and 0.51 < ratio <= 0.55, ratio
