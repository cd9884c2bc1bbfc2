"""The fp32 flash-attention backward (the "tf32x3" route,
``csrc/flash_attention_bwd_tf32x3.cu``) and the lse of the fp32 forward
on the CPU: the schedule twin against the oracle and JAX, the TF32
split, rows with no live key, the lse twin, the route and the autograd
wiring.

``flash_attention.flash_bwd_tf32x3_plan_ref`` walks the kernel's items
and tiles in its order (dq items of R queries over R-key tiles, dkdv
items of R keys over the group's R-query tiles; R read from the source)
and forms every product as the kernel's tensor cores do, from the TF32
halves of its operands (``tf32_split``: lo hi' + hi lo' + hi hi'); it
is held against ``ref.flash_attention_bwd_ref`` and ``jax.vjp`` of the
reference ``_flash`` on the same fp32 inputs, made from a seed with
numpy: causal, windowed and bidirectional, GQA groups of 1, 2 and 4, hd
64, 80, 128 and 256, Tq != Tk, over the kernel's tiles and 16-row ones
that cross many tiles.

Tolerance (the fp32 gate of the card): within 1e-5 of each gradient's
largest magnitude.  The split keeps about 22 bits of each product (lo
lo' dropped, 2^-22 relative); the rest is summation order.
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
GATE = 1e-5


def _inputs(seed, B, Tq, Tk, H, KV, hd):
    """q, k, v, do as float32 numpy arrays."""
    r = np.random.default_rng(seed)
    return [r.normal(size=s).astype(np.float32)
            for s in ((B, Tq, H, hd), (B, Tk, KV, hd), (B, Tk, KV, hd),
                      (B, Tq, H, hd))]


def _gate(got, want):
    """Within GATE of the largest |want|."""
    g = np.asarray(got, np.float64).ravel()
    w = np.asarray(want, np.float64).ravel()
    err = float(np.abs(g - w).max())
    assert err <= GATE * float(np.abs(w).max()), err


@functools.lru_cache(maxsize=None)
def _jax_grads(modes, seed, B, Tq, Tk, H, KV, hd):
    """jax.vjp of the reference _flash in fp32 for each of ``modes``, one
    chunk of each side, in one compile per shape (about 0.6 s here for
    one mode, 1.1 s for three; two 75-row chunks took twice that)."""
    q, k, v, do = _inputs(seed, B, Tq, Tk, H, KV, hd)

    def vjp(q_, k_, v_, do_):
        grads = []
        for mode in modes:
            causal, window = MODES[mode]
            out, pull = jax.vjp(lambda a, b, c: _flash(
                a, b, c, causal=causal, window=window, q_chunk=Tq,
                kv_chunk=Tk, unroll_q=True), q_, k_, v_)
            grads.append(pull(do_.reshape(out.shape)))
        return grads

    got = zoo.jit(vjp)(*(jnp.asarray(a) for a in (q, k, v, do)))
    return {m: [np.asarray(g) for g in gs] for m, gs in zip(modes, got)}


def _check(mode, seed, B, Tq, Tk, H, KV, hd, modes=tuple(MODES), **tiles):
    """The twin against the oracle and JAX (whose gradients for every mode
    in ``modes`` come from one compile)."""
    causal, window = MODES[mode]
    tq, tk, tv, tdo = (torch.from_numpy(a)
                       for a in _inputs(seed, B, Tq, Tk, H, KV, hd))
    o = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    got = flash_mod.flash_bwd_tf32x3_plan_ref(tq, tk, tv, o, tdo,
                                              causal=causal, window=window,
                                              **tiles)
    want = ref.flash_attention_bwd_ref(tq, tk, tv, o, tdo, causal=causal,
                                       window=window)
    jg = _jax_grads(modes, seed, B, Tq, Tk, H, KV, hd)[mode]
    for g, w, j in zip(got, want, jg):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _gate(g.numpy(), w.numpy())
        _gate(g.numpy(), j)


def test_twin_tiles_are_the_kernels():
    """The twin's rows per item and tile are the source's dispatch: 64
    up to hd 128 (HDP 64 and 128), 32 above (HDP 256, hd in two parts
    across warps), each HDP with an instance for hd = HDP."""
    src = (CSRC / "flash_attention_bwd_tf32x3.cu").read_text()
    table = re.findall(r"if \(\(d\)\.hd (==|<) (\d+)\) return "
                       r"F<(\d+), (\d+), (\d), (\w+)>", src)
    assert table == [("==", "64", "64", "64", "1", "true"),
                     ("<", "64", "64", "64", "1", "false"),
                     ("==", "128", "128", "64", "1", "F128"),
                     ("<", "128", "128", "64", "1", "false"),
                     ("==", "256", "256", "32", "2", "true")]
    assert "return F<256, 32, 2, false>(__VA_ARGS__);" in src
    for hd in range(8, 257, 8):
        want = 64 if hd <= 128 else 32
        assert flash_mod.tf32x3_rows(hd) == want


@pytest.mark.parametrize("G,hd", [(1, 64), (2, 80), (4, 128), (2, 256)])
@pytest.mark.parametrize("mode", list(MODES))
def test_tf32x3_twin_matches_oracle_and_jax(mode, G, hd):
    """At 150 positions, two KV heads and G query heads a group, the
    kernel's tiles (three dq items and three dkdv items at R = 64, five
    at R = 32).  Against the oracle and JAX in every case."""
    _check(mode, G * 1000 + hd, 1, 150, 150, 2 * G, 2, hd)


@pytest.mark.parametrize("mode", list(MODES))
def test_tf32x3_twin_small_tiles(mode):
    """16-row items and tiles cross many tiles and tile edges (the
    inputs of the hd 64 case above, so JAX's gradients are its)."""
    _check(mode, 1064, 1, 150, 150, 2, 2, 64, rows=16)


@pytest.mark.parametrize("Tq,Tk,mode,hd", [(70, 150, "bidirectional", 80),
                                           (70, 150, "window", 256),
                                           (150, 100, "causal", 128)])
def test_tf32x3_twin_tq_ne_tk_and_mqa(Tq, Tk, mode, hd):
    """Tq != Tk and MQA (one KV head for four query heads).  (JAX's
    _flash stands for "no window" by Tk + q_chunk + 1, so it masks pairs
    farther apart than that: with q_chunk = Tq every pair stays within
    it here, as on every model path.)"""
    _check(mode, Tq + Tk + hd, 1, Tq, Tk, 4, 1, hd, modes=(mode,))


def test_tf32_split_halves():
    """hi has at most 10 mantissa bits, rounded to nearest with ties away
    from zero, and |x - hi - lo| <= 2^-22 |x|, over magnitudes from
    2^-60 to 2^60 and both signs."""
    r = np.random.default_rng(5)
    x = (r.normal(size=20000) * np.exp2(r.integers(-60, 60, 20000))) \
        .astype(np.float32)
    tx = torch.from_numpy(x)
    hi, lo = flash_mod.tf32_split(tx)
    bits = hi.view(torch.int32)
    assert not bool((bits & 0x1FFF).any())
    assert not bool((lo.view(torch.int32) & 0x1FFF).any())
    err = (tx.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * tx.double().abs()).all())
    # hi is the nearest 11-bit value: its error at most half its ulp
    assert bool(((tx - hi).abs() <= 2.0 ** -11 * tx.abs()).all())
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11,
                         1 + 2 ** -12], dtype=torch.float32)
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, 1.0])
    assert torch.equal(flash_mod.tf32_round(ties), want)


@pytest.mark.parametrize("hd", [16, 80, 256])
@pytest.mark.parametrize("mode", list(MODES))
def test_fp32_lse_twin_matches_logsumexp(mode, hd):
    """The lse the fp32 forward saves (natural units, rows rounded up to
    64, +inf on the padding) against torch.logsumexp of the scaled
    masked scores, at hd 16 and 80 (128-row tiles of two heads, G = 2)
    and hd 256 (flash_kernel_wide's 64-row tiles)."""
    causal, window = MODES[mode]
    q, k, v, _ = _inputs(hd, 2, 150, 150, 4, 2, hd)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    lse = flash_mod.flash_lse_ref(tq, tk, causal=causal, window=window)
    assert lse.shape == (2, 4, 192) and lse.dtype == torch.float32
    s = torch.einsum("bqkgh,bskh->bkgqs", tq.reshape(2, 150, 2, 2, hd),
                     tk) / math.sqrt(hd)
    live = flash_mod._live(0, 150, 0, 150, 150, 150, causal, window)
    want = torch.logsumexp(torch.where(live, s, -math.inf), -1) \
        .reshape(2, 4, 150)
    assert float((lse[..., :150] - want).abs().max()) <= 1e-5 * max(
        1.0, float(want.abs().max()))
    assert bool((lse[..., 150:] == math.inf).all())


def test_no_live_key_rows_give_inf_lse_and_zero_gradients():
    """Tq > Tk with a window: queries past Tk + window - 1 see no key.
    Their lse is +inf, their dq rows are zero, and dk and dv are those of
    the same dO with their rows zeroed, which the oracle gets right."""
    B, Tq, Tk, H, KV, hd, window = 1, 150, 60, 4, 2, 80, 20
    tq, tk, tv, tdo = (torch.from_numpy(a)
                       for a in _inputs(3, B, Tq, Tk, H, KV, hd))
    dead = torch.arange(Tq) >= Tk + window - 1
    lse = flash_mod.flash_lse_ref(tq, tk, causal=True, window=window)
    assert bool((lse[:, :, :Tq][..., dead] == math.inf).all())
    assert bool(torch.isfinite(lse[:, :, :Tq][..., ~dead]).all())
    o = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    kw = dict(causal=True, window=window)
    dq, dk, dv = flash_mod.flash_bwd_tf32x3_plan_ref(tq, tk, tv, o, tdo,
                                                     lse=lse, **kw)
    assert not bool(dq[:, dead].any())
    tdo0 = torch.where(dead[None, :, None, None], 0.0, tdo)
    zq, zk, zv = flash_mod.flash_bwd_tf32x3_plan_ref(tq, tk, tv, o, tdo0,
                                                     lse=lse, **kw)
    assert torch.equal(dk, zk) and torch.equal(dv, zv)
    want = ref.flash_attention_bwd_ref(tq, tk, tv, o, tdo0, **kw)
    for g, w in zip((dq[:, ~dead], dk, dv), (want[0][:, ~dead], *want[1:])):
        _gate(g.numpy(), w.numpy())


def test_route_and_launch_names():
    """fp32 at every head dim takes the tf32x3 launches, each with its own
    count in ops.launch_counts() and its C entry point; the fp32 forward
    takes an lse pointer; the CUDA-core kernels stay registered (the
    forced A/B route)."""
    for hd in range(8, 257, 8):
        assert flash_mod.bwd_route(torch.float32, hd) == "tf32x3"
    assert flash_mod.BWD_KERNELS["tf32x3"] == (
        flash_mod.KERNEL_BWD_TF32X3_DQ, flash_mod.KERNEL_BWD_TF32X3_DKDV)
    assert ops.KERNELS["flash_attention_bwd_tf32x3_dq"] \
        is flash_mod.KERNEL_BWD_TF32X3_DQ
    assert ops.KERNELS["flash_attention_bwd_tf32x3_dkdv"] \
        is flash_mod.KERNEL_BWD_TF32X3_DKDV
    assert ops.KERNELS["flash_attention_bwd_rows"] \
        is flash_mod.KERNEL_BWD_ROWS
    src = (CSRC / "flash_attention_bwd_tf32x3.cu").read_text()
    for k in flash_mod.BWD_KERNELS["tf32x3"]:
        assert f'extern "C" int {k.symbol}(' in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    # the kernel's rounding is the twin's (tf32_round)
    assert "(__float_as_uint(x) + 0x1000u) & 0xFFFFE000u" in src
    assert flash_mod.KERNEL.signature == flash_mod.KERNEL_WGMMA.signature


def test_autograd_hands_the_fp32_forward_lse_to_the_backward(monkeypatch):
    """On the card's route (the CUDA wrappers swapped for their plain
    twins), FlashAttentionFn asks the fp32 forward for the lse and hands
    it to the backward, whose route is tf32x3; the gradients through the
    twin of that backward pass the fp32 gate against autograd of the
    plain attention."""
    calls = []

    def fwd(q, k, v, *, return_lse=False, **kw):
        calls.append(("fwd", return_lse))
        o = ref.flash_attention_ref(q, k, v, **kw)
        if return_lse:
            return o, flash_mod.flash_lse_ref(q, k, **kw)
        return o

    def bwd(q, k, v, o, do, *, lse=None, **kw):
        calls.append(("bwd", flash_mod.bwd_route(q.dtype, q.shape[-1]),
                      lse is not None))
        return flash_mod.flash_bwd_tf32x3_plan_ref(q, k, v, o, do, lse=lse,
                                                   **kw)

    monkeypatch.setattr(flash_mod, "flash_attention_cuda", fwd)
    monkeypatch.setattr(flash_mod, "flash_attention_bwd_cuda", bwd)
    monkeypatch.setattr(ops, "use_kernel", lambda t, b: b != "torch")
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(5, 1, 70, 70, 4, 2, 64))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*leaves, window=30),
                              leaves, do)
    assert calls == [("fwd", True), ("bwd", "tf32x3", True)]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        ops.flash_attention(*plain, window=30, backend="torch"), plain, do)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _gate(g.numpy(), w.numpy())
