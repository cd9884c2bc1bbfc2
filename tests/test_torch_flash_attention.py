"""The port's plain flash attention against the JAX package's.

``repro_torch.kernels.ref.flash_attention_ref`` (what ``ops.flash_attention``
runs for a tensor on the CPU, and the CUDA kernel's oracle on the card)
against ``flash_attention_pallas(..., interpret=True)``, its dense
oracle ``flash_attention_ref`` and the model's XLA ``_flash``, on the
shapes of ``tests/test_flash_attention.py``.  Inputs are seeded numpy
arrays handed to both.

Tolerances: 3e-5 absolute in fp32 (the JAX tests' own bound between the
Pallas kernel and its oracle: the online softmax sums in another order);
2e-2 in bf16 (the JAX tests' bf16 bound: one bf16 ulp of unit-sized
outputs, the output being rounded to bf16 once in each).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_pallas, flash_attention_ref as jax_ref)
from repro.models.attention import _flash  # noqa: E402
from repro_torch.interop import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    check_shapes, flash_attention_cuda)


def _qkv(seed, B, Tq, Tk, H, KV, hd, dtype=np.float32):
    r = np.random.default_rng(seed)
    return (r.normal(size=(B, Tq, H, hd)).astype(dtype),
            r.normal(size=(B, Tk, KV, hd)).astype(dtype),
            r.normal(size=(B, Tk, KV, hd)).astype(dtype))


def _port(arrs, **kw):
    q, k, v = (torch.from_numpy(a) for a in arrs)
    return ref.flash_attention_ref(q, k, v, **kw).numpy()


@pytest.mark.parametrize("B,T,H,KV,hd", [
    (1, 16, 2, 2, 8),      # MHA
    (2, 40, 4, 2, 16),     # GQA 2:1
    (1, 33, 8, 1, 16),     # MQA, ragged T
    (2, 64, 4, 4, 32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_and_oracle(B, T, H, KV, hd, causal):
    arrs = _qkv(B * 100 + T, B, T, T, H, KV, hd)
    got = _port(arrs, causal=causal)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    pal = flash_attention_pallas(jq, jk, jv, causal=causal, bq=16, bk=16,
                                 interpret=True)
    np.testing.assert_allclose(got, np.asarray(pal), atol=3e-5)
    np.testing.assert_allclose(got, np.asarray(jax_ref(jq, jk, jv,
                                                       causal=causal)),
                               atol=3e-5)


@pytest.mark.parametrize("window", [4, 16, 64])
def test_sliding_window(window):
    arrs = _qkv(window, 1, 48, 48, 4, 2, 16)
    got = _port(arrs, causal=True, window=window)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    pal = flash_attention_pallas(jq, jk, jv, causal=True, window=window,
                                 bq=16, bk=16, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pal), atol=3e-5)


def test_bf16_inputs():
    arrs = _qkv(7, 1, 32, 32, 2, 2, 16)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrs)
    q, k, v = (tensor_from_numpy(a, "cpu") for a in (jq, jk, jv))
    got = ref.flash_attention_ref(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    pal = flash_attention_pallas(jq, jk, jv, causal=True, bq=16, bk=16,
                                 interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pal, np.float32), atol=2e-2)


def test_matches_xla_formulation():
    """The model's XLA ``_flash`` at window 8: the function that
    ``attention_full`` replaces with ``ops.flash_attention``."""
    arrs = _qkv(8, 2, 40, 40, 4, 2, 16)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    xla = _flash(jq, jk, jv, causal=True, window=8, q_chunk=16, kv_chunk=16)
    got = _port(arrs, causal=True, window=8)
    B, T, H, hd = got.shape
    np.testing.assert_allclose(got.reshape(B, T, H * hd), np.asarray(xla),
                               atol=3e-5)


def test_ops_dispatch_on_the_cpu():
    """``auto`` and ``torch`` run the plain version for a CPU tensor;
    ``cuda`` raises instead of falling back."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, 1, 20, 20, 4, 2, 8))
    want = ref.flash_attention_ref(q, k, v, causal=True, window=5)
    for backend in ("auto", "torch"):
        got = ops.flash_attention(q, k, v, causal=True, window=5,
                                  backend=backend)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)


@pytest.mark.parametrize("shapes,match", [
    (((1, 8, 4, 12), (1, 8, 2, 12)), "multiple of 8"),
    (((1, 8, 4, 264), (1, 8, 2, 264)), "multiple of 8"),
    (((1, 8, 4, 16), (1, 8, 3, 16)), "not a multiple"),
    (((1, 8, 4, 16), (2, 8, 2, 16)), "do not fit"),
])
def test_kernel_refuses_shapes_it_does_not_take(shapes, match):
    q = torch.zeros(shapes[0])
    k = torch.zeros(shapes[1])
    with pytest.raises(ValueError, match=match):
        check_shapes(q, k, k, 0)


def test_kernel_route_is_chosen_by_dtype():
    """bfloat16 goes to the wgmma kernel and float32 to the CUDA-core one,
    each with its own entry point and launch count; other dtypes are
    refused before any device check."""
    assert flash_mod.kernel_for(torch.bfloat16) is flash_mod.KERNEL_WGMMA
    assert flash_mod.kernel_for(torch.float32) is flash_mod.KERNEL
    assert ops.KERNELS["flash_attention_wgmma"] is flash_mod.KERNEL_WGMMA
    assert ops.KERNELS["flash_attention"] is flash_mod.KERNEL
    assert flash_mod.KERNEL.symbol != flash_mod.KERNEL_WGMMA.symbol
    q = torch.zeros(1, 4, 2, 8, dtype=torch.float16)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            flash_mod.kernel_for(dt)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_cuda(q, q, q)


@pytest.mark.parametrize("shapes,window,match", [
    (((1, 8, 4, 16), (1, 8, 2, 16)), -1, "window"),
    (((8, 4, 16), (8, 2, 16)), 0, "4-d"),
    (((1, 8, 4, 16), (1, 8, 0, 16)), 0, "not a multiple"),
    (((1, 8, 4, 0), (1, 8, 2, 0)), 0, "multiple of 8"),
])
def test_kernel_refuses_windows_ranks_and_empty_heads(shapes, window, match):
    q = torch.zeros(shapes[0])
    k = torch.zeros(shapes[1])
    with pytest.raises(ValueError, match=match):
        check_shapes(q, k, k, window)


def test_scale_keyword():
    """``scale=None`` is the Pallas kernel's 1 / sqrt(hd) (the default
    path unchanged, bitwise); a given scale multiplies the fp32 scores,
    so q * c at scale 1 is q at scale c up to fp32 rounding."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(11, 1, 24, 24, 4, 2, 32))
    base = ref.flash_attention_ref(q, k, v, causal=True)
    assert torch.equal(ref.flash_attention_ref(q, k, v, causal=True,
                                               scale=None), base)
    assert torch.equal(ops.flash_attention(q, k, v, scale=None), base)
    np.testing.assert_allclose(
        ref.flash_attention_ref(q, k, v, scale=32 ** -0.5).numpy(),
        base.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        ops.flash_attention(q * 0.3, k, v, scale=1.0).numpy(),
        ops.flash_attention(q, k, v, scale=0.3).numpy(), atol=1e-6)


@pytest.mark.parametrize("B,Tq,H,KV,hd", [
    (1, 1000, 48, 1, 128), (1, 1024, 32, 8, 128), (1, 4096, 8, 4, 256),
    (2, 333, 6, 2, 72), (1, 16, 2, 2, 8), (3, 1, 4, 4, 24)])
def test_fp32_plan_fits_and_covers_every_row_once(B, Tq, H, KV, hd):
    """The fp32 kernel's plan fits one block's shared memory, takes two
    heads of a group where G is even (one where it is odd), and its
    blocks cover every (batch, position, head) exactly once, the last
    positions first."""
    pl = flash_mod.plan(B, Tq, H, KV, hd)
    assert pl.smem <= flash_mod.MAX_SMEM
    assert pl.rows == pl.heads * pl.positions == (128 if hd <= 128 else 64)
    assert pl.heads == (2 if pl.rows == 128 and (H // KV) % 2 == 0 else 1)
    assert pl.keys == 64
    blocks = flash_mod.blocks(B, Tq, H, KV, pl.positions, pl.heads)
    assert len(blocks) == pl.grid[0] * pl.grid[1]
    seen = np.zeros((B, Tq, H), np.int64)
    for b, h0, q_lo in blocks:
        assert h0 // (H // KV) == (h0 + pl.heads - 1) // (H // KV)
        seen[b, q_lo:q_lo + pl.positions, h0:h0 + pl.heads] += 1
    assert (seen == 1).all()
    firsts = [q_lo for _, _, q_lo in blocks]
    assert firsts == sorted(firsts, reverse=True)


@pytest.mark.parametrize("Tq,Tk,causal,window", [
    (200, 200, True, 0), (200, 200, True, 50), (300, 100, True, 30),
    (100, 300, False, 0), (130, 130, False, 64)])
def test_fp32_key_tiles_hold_every_live_pair(Tq, Tk, causal, window):
    """The relevance test skips only key tiles with no live (q, k) pair
    for any position of the block."""
    for positions, keys in ((64, 64), (128, 64), (16, 32)):
        for q_lo in range(0, Tq, positions):
            lo, hi = flash_mod.key_tiles(q_lo, positions, Tk, causal, window,
                                         keys)
            for t in range(q_lo, min(q_lo + positions, Tq)):
                for s in range(Tk):
                    live = (not causal or s <= t) and (
                        window == 0 or t - s < window)
                    if live:
                        assert lo <= s // keys < hi, (q_lo, t, s, lo, hi)


@pytest.mark.parametrize("B,T,H,KV,hd", [
    (1, 16, 2, 2, 8), (2, 40, 4, 2, 16), (1, 33, 8, 1, 16),
    (2, 64, 4, 4, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tiles", [None, (8, 16), (4, 8)])
def test_fp32_plan_ref_matches_pallas(B, T, H, KV, hd, causal, tiles):
    """The plain twin of the fp32 kernel's schedule (its plan, or tiles of
    (positions, keys) small enough to walk many) within 1e-5 of the
    Pallas kernel on the JAX tests' shapes, and of the plain version."""
    arrs = _qkv(B * 100 + T, B, T, T, H, KV, hd)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    kw = {} if tiles is None else dict(positions=tiles[0], keys=tiles[1])
    got = flash_mod.flash_plan_ref(q, k, v, causal=causal, **kw).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    pal = flash_attention_pallas(jq, jk, jv, causal=causal, bq=16, bk=16,
                                 interpret=True)
    np.testing.assert_allclose(got, np.asarray(pal), atol=1e-5)
    np.testing.assert_allclose(got, _port(arrs, causal=causal), atol=1e-5)


@pytest.mark.parametrize("window", [4, 16, 64])
def test_fp32_plan_ref_sliding_window(window):
    arrs = _qkv(window, 1, 48, 48, 4, 2, 16)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    pal = flash_attention_pallas(jq, jk, jv, causal=True, window=window,
                                 bq=16, bk=16, interpret=True)
    for kw in ({}, dict(positions=8, keys=16), dict(positions=4, heads=1,
                                                     keys=8)):
        got = flash_mod.flash_plan_ref(q, k, v, causal=True, window=window,
                                       **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(pal), atol=1e-5)
