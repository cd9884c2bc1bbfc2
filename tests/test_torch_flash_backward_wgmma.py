"""The bf16 flash-attention backward of the port (the "wgmma" route) on
the CPU: its schedule twin against the oracle and JAX, the saved lse,
and the route.

``flash_attention.flash_bwd_wgmma_plan_ref`` walks the items and tiles
of ``csrc/flash_attention_bwd_wgmma.cu`` in its order (tile sizes read
from the source) and rounds P and dS to bf16 where the kernel does; it
is held against ``ref.flash_attention_bwd_ref`` and against ``jax.vjp``
of the reference ``_flash`` on the same bf16-valued inputs, causal,
windowed and bidirectional, with the kernel's tiles and with smaller
ones that cross many tiles.  ``flash_attention.flash_wgmma_lse_ref``,
the twin of the lse the bf16 forward saves, is held against
``torch.logsumexp`` of the plain masked scores; rows with no live key
give +inf and zero gradients.  ``bwd_route`` and
``ops.FlashAttentionFn`` send bf16 up to hd 128 to the new launches
and bf16 above it to the wide ones (both with the forward's lse), and
fp32 to the CUDA-core backward's, checked
with the CUDA wrappers swapped for their plain twins.

Tolerances: the twin within 2^-7 of each gradient's largest magnitude,
cosine >= 0.9999 (the card's bf16 gate: P and dS enter their products
as bf16, 2^-9 relative each, and the gradients are rounded to bf16
once); the lse within 1e-5 * max(1, |lse|) (fp32 online sums in log2
units against a one-pass logsumexp).
"""

import functools
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_zoo as zoo  # noqa: E402
from repro.models.attention import _flash  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

MODES = {"causal": (True, 0), "window": (True, 40),
         "bidirectional": (False, 0)}
CSRC = Path(flash_mod.__file__).parent / "csrc"


def _inputs(seed, B, Tq, Tk, H, KV, hd):
    """q, k, v, do as bf16-valued float32 numpy arrays."""
    r = np.random.default_rng(seed)
    out = []
    for s in ((B, Tq, H, hd), (B, Tk, KV, hd), (B, Tk, KV, hd),
              (B, Tq, H, hd)):
        a = torch.from_numpy(r.normal(size=s).astype(np.float32))
        out.append(a.bfloat16().float().numpy())
    return out


def _gate(got, want):
    """The card's bf16 gate: within 2^-7 of the largest |want|, cosine
    >= 0.9999."""
    g = torch.tensor(np.asarray(got, np.float32)).double().flatten()
    w = torch.tensor(np.asarray(want, np.float32)).double().flatten()
    err = float((g - w).abs().max())
    assert err <= 2.0 ** -7 * float(w.abs().max()), err
    assert float(g @ w / (g.norm() * w.norm())) >= 0.9999


def _plain_lse(q, k, causal, window):
    """torch.logsumexp of the plain masked scaled scores, (B, H, Tq)."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    qh = q.reshape(B, Tq, KV, H // KV, hd).float() / math.sqrt(hd)
    s = torch.einsum("bqKgh,bsKh->bKgqs", qh, k.float())
    ti, tj = torch.arange(Tq)[:, None], torch.arange(Tk)[None, :]
    live = torch.ones((Tq, Tk), dtype=torch.bool)
    if causal:
        live &= tj <= ti
    if window > 0:
        live &= ti - tj < window
    return torch.logsumexp(torch.where(live, s, -math.inf), -1) \
        .reshape(B, H, Tq)


def test_twin_tiles_are_the_kernels():
    """The twins' tiles and route bound are the sources' own."""
    bwd = (CSRC / "flash_attention_bwd_wgmma.cu").read_text()
    const = {n: int(v) for n, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", bwd)}
    assert const["kRows"] == flash_mod.BWD_WGMMA_ROWS
    assert const["kBK"] == flash_mod.BWD_WGMMA_KEYS
    assert const["kBQ"] == flash_mod.BWD_WGMMA_QUERIES
    assert "d.hd <= %d" % flash_mod.BWD_WGMMA_MAX_HEAD_DIM in bwd
    cuh = (CSRC / "flash_wgmma.cuh").read_text()
    assert "(Tq + 63) / 64 * 64" in cuh and flash_mod.LSE_ALIGN == 64
    fwd = (CSRC / "flash_attention_wgmma.cu").read_text()
    assert "kBQ = 64 * kConsumers" in fwd and "kConsumers = 2;" in fwd
    assert flash_mod.WGMMA_QUERIES == 128
    for hdp, bk in re.findall(r"launch<(\d+), (\d+)>", fwd):
        assert flash_mod.wgmma_keys(int(hdp)) == int(bk)
    assert flash_mod.lse_rows(1) == 64 and flash_mod.lse_rows(128) == 128


@functools.lru_cache(maxsize=None)
def _jax_grads(mode, seed, B, T, H, KV, hd):
    """jax.vjp of the reference _flash (one compile per mode)."""
    causal, window = MODES[mode]
    q, k, v, do = _inputs(seed, B, T, T, H, KV, hd)

    def vjp(q_, k_, v_, do_):
        out, pull = jax.vjp(lambda a, b, c: _flash(
            a, b, c, causal=causal, window=window, q_chunk=75, kv_chunk=75,
            unroll_q=True), q_, k_, v_)
        return pull(do_.reshape(out.shape))

    return [np.asarray(g) for g in zoo.jit(vjp)(
        *(jnp.asarray(a) for a in (q, k, v, do)))]


@pytest.mark.parametrize("tiles", ["kernel", "small"])
@pytest.mark.parametrize("mode", list(MODES))
def test_schedule_twin_matches_oracle_and_jax(mode, tiles):
    """The twin against the oracle and JAX's gradient at 150 positions,
    GQA 2, over the kernel's tiles (two dq items of 128 queries, two
    dkdv items of 128 keys, each split between two warpgroups) and over
    16-key and 16-query tiles."""
    causal, window = MODES[mode]
    B, T, H, KV, hd = 1, 150, 4, 2, 16
    q, k, v, do = _inputs(11, B, T, T, H, KV, hd)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    o = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    small = dict(keys=16, queries=16) if tiles == "small" else {}
    got = flash_mod.flash_bwd_wgmma_plan_ref(tq, tk, tv, o, tdo,
                                             causal=causal, window=window,
                                             **small)
    want = ref.flash_attention_bwd_ref(tq, tk, tv, o, tdo, causal=causal,
                                       window=window)
    for g, w, j in zip(got, want, _jax_grads(mode, 11, B, T, H, KV, hd)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _gate(g.float().numpy(), w.float().numpy())
        _gate(g.float().numpy(), j)


@pytest.mark.parametrize("mode", list(MODES))
def test_lse_twin_matches_logsumexp(mode):
    """The forward's saved lse (natural units, rows rounded up to 64,
    +inf on the padding) against torch.logsumexp, at hd 16 (128-key
    tiles) and hd 256 (64-key tiles)."""
    causal, window = MODES[mode]
    for hd in (16, 256):
        q, k, _, _ = _inputs(hd, 2, 150, 150, 4, 2, hd)
        tq, tk = torch.from_numpy(q), torch.from_numpy(k)
        lse = flash_mod.flash_wgmma_lse_ref(tq, tk, causal=causal,
                                            window=window)
        assert lse.shape == (2, 4, 192) and lse.dtype == torch.float32
        want = _plain_lse(tq, tk, causal, window)
        err = ((lse[..., :150] - want).abs() / want.abs().clamp_min(1))
        assert float(err.max()) <= 1e-5
        assert bool((lse[..., 150:] == math.inf).all())


def test_no_live_key_rows_give_inf_lse_and_zero_gradients():
    """Tq > Tk with a window: queries past Tk + window - 1 see no key.
    Their lse is +inf and they add nothing to any gradient: their dq
    rows are zero, and dk and dv are those of the same dO with their
    rows zeroed, which the oracle gets right."""
    B, Tq, Tk, H, KV, hd, window = 1, 150, 60, 4, 2, 16, 20
    q, k, v, do = _inputs(3, B, Tq, Tk, H, KV, hd)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    dead = torch.arange(Tq) >= Tk + window - 1
    lse = flash_mod.flash_wgmma_lse_ref(tq, tk, causal=True, window=window)
    assert bool((lse[:, :, :Tq][..., dead] == math.inf).all())
    assert bool(torch.isfinite(lse[:, :, :Tq][..., ~dead]).all())
    o = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    kw = dict(causal=True, window=window)
    dq, dk, dv = flash_mod.flash_bwd_wgmma_plan_ref(tq, tk, tv, o, tdo,
                                                    lse=lse, **kw)
    assert not bool(dq[:, dead].any())
    tdo0 = torch.where(dead[None, :, None, None], 0.0, tdo.float()).bfloat16()
    zq, zk, zv = flash_mod.flash_bwd_wgmma_plan_ref(tq, tk, tv, o, tdo0,
                                                    lse=lse, **kw)
    assert torch.equal(dk, zk) and torch.equal(dv, zv)
    want = ref.flash_attention_bwd_ref(tq, tk, tv, o, tdo0, **kw)
    for g, w in zip((dq[:, ~dead], dk, dv), (want[0][:, ~dead], *want[1:])):
        _gate(g.float().numpy(), w.float().numpy())


def test_backward_route_by_dtype_and_head_dim():
    """bf16 up to hd 128 takes the wgmma launches, bf16 above hd 128 the
    wide ones, fp32 at any hd the split-TF32 one's; other dtypes are
    refused."""
    for hd in (8, 64, 80, 128):
        assert flash_mod.bwd_route(torch.bfloat16, hd) == "wgmma"
        assert flash_mod.bwd_route(torch.float32, hd) == "tf32x3"
    for hd in (136, 256):
        assert flash_mod.bwd_route(torch.bfloat16, hd) == "wgmma_wide"
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_mod.bwd_route(torch.float16, 64)
    assert ops.KERNELS["flash_attention_bwd_wgmma_dq"] \
        is flash_mod.KERNEL_BWD_WGMMA_DQ
    assert ops.KERNELS["flash_attention_bwd_wgmma_dkdv"] \
        is flash_mod.KERNEL_BWD_WGMMA_DKDV


@pytest.mark.parametrize("dtype,hd,wgmma", [
    (torch.bfloat16, 16, True), (torch.bfloat16, 136, True),
    (torch.float32, 16, False)])
def test_autograd_takes_the_forward_lse_on_the_wgmma_route(
        monkeypatch, dtype, hd, wgmma):
    """On the card's route (the CUDA wrappers swapped for their plain
    twins), FlashAttentionFn asks the forward for the lse on every route
    (the bf16 wgmma ones, and, since the fp32 backward moved to the
    tensor cores, fp32's split-TF32 one too) and hands it over; the
    gradients through the twin of that backward (``wgmma``: the bf16
    one, else the fp32 one) pass the bf16 gate against autograd of the
    plain attention."""
    calls = []

    def fwd(q, k, v, *, return_lse=False, **kw):
        calls.append(("fwd", return_lse))
        o = ref.flash_attention_ref(q, k, v, **kw)
        if return_lse:
            lse_ref = (flash_mod.flash_wgmma_lse_ref if wgmma
                       else flash_mod.flash_lse_ref)
            return o, lse_ref(q, k, **kw)
        return o

    def bwd(q, k, v, o, do, *, lse=None, **kw):
        calls.append(("bwd", lse is not None))
        if lse is None:
            return ref.flash_attention_bwd_ref(q, k, v, o, do, **kw)
        plan = (flash_mod.flash_bwd_wgmma_plan_ref if wgmma
                else flash_mod.flash_bwd_tf32x3_plan_ref)
        return plan(q, k, v, o, do, lse=lse, **kw)

    monkeypatch.setattr(flash_mod, "flash_attention_cuda", fwd)
    monkeypatch.setattr(flash_mod, "flash_attention_bwd_cuda", bwd)
    monkeypatch.setattr(ops, "use_kernel", lambda t, b: b != "torch")
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _inputs(5, 1, 70, 70, 4, 2, hd))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*leaves, window=30),
                              leaves, do)
    assert calls == [("fwd", True), ("bwd", True)]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        ops.flash_attention(*plain, window=30, backend="torch"), plain, do)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        _gate(g.float().numpy(), w.float().numpy())
