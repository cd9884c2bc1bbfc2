"""The bf16 flash-attention backward above hd 128 (the "wgmma_wide"
route, ``csrc/flash_attention_bwd_wgmma_wide.cu``) on the CPU: its
schedule twin against the oracle and JAX, rows with no live key, the
route and the autograd wiring.

``flash_attention.flash_bwd_wide_plan_ref`` walks the kernel's items and
tiles in its order (dq items of 128 queries over 64-key tiles; dkdv
items of 64 keys over the group's 64-query tiles, tile sizes read from
the source) and rounds P and dS to bf16 where the kernel does; it is
held against ``ref.flash_attention_bwd_ref`` and ``jax.vjp`` of the
reference ``_flash`` on the same bf16-valued inputs, made from a seed
with numpy, at hd 136, 192 and 256 (HDP 192 and 256), causal, windowed
and bidirectional, GQA and MQA, Tq != Tk, and over the kernel's tiles
and 16-row ones that cross many tiles.

Tolerance (the tensor-core backwards' bf16 gate): within 2^-7 of each
gradient's largest magnitude, cosine >= 0.9999: P and dS enter their
products as bf16 (2^-9 relative each) and the gradients are rounded to
bf16 once.
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


@functools.lru_cache(maxsize=None)
def _jax_grads(mode, seed, B, Tq, Tk, H, KV, hd):
    """jax.vjp of the reference _flash (one compile per shape and mode)."""
    causal, window = MODES[mode]
    q, k, v, do = _inputs(seed, B, Tq, Tk, H, KV, hd)

    def vjp(q_, k_, v_, do_):
        out, pull = jax.vjp(lambda a, b, c: _flash(
            a, b, c, causal=causal, window=window, q_chunk=75, kv_chunk=75,
            unroll_q=True), q_, k_, v_)
        return pull(do_.reshape(out.shape))

    return [np.asarray(g) for g in zoo.jit(vjp)(
        *(jnp.asarray(a) for a in (q, k, v, do)))]


def _check(mode, seed, B, Tq, Tk, H, KV, hd, with_jax=True, **tiles):
    causal, window = MODES[mode]
    arrs = _inputs(seed, B, Tq, Tk, H, KV, hd)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in arrs)
    o = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    got = flash_mod.flash_bwd_wide_plan_ref(tq, tk, tv, o, tdo,
                                            causal=causal, window=window,
                                            **tiles)
    want = ref.flash_attention_bwd_ref(tq, tk, tv, o, tdo, causal=causal,
                                       window=window)
    jg = _jax_grads(mode, seed, B, Tq, Tk, H, KV, hd) if with_jax \
        else [None] * 3
    for g, w, j in zip(got, want, jg):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _gate(g.float().numpy(), w.float().numpy())
        if j is not None:
            _gate(g.float().numpy(), j)


def test_twin_tiles_are_the_kernels():
    """The twin's tiles, route bounds and instantiations are the source's
    own: dq rows per warpgroup and keys per tile, dkdv keys per item and
    queries per tile, hd 136..256 as HDP 192 and 256."""
    src = (CSRC / "flash_attention_bwd_wgmma_wide.cu").read_text()
    const = {n: int(v) for n, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kRows"] == flash_mod.BWD_WGMMA_ROWS
    assert const["kBK"] == flash_mod.BWD_WIDE_KEYS
    assert const["kBQ"] == flash_mod.BWD_WIDE_QUERIES
    assert "d.hd > %d && d.hd <= %d" % (
        flash_mod.BWD_WGMMA_MAX_HEAD_DIM, flash_mod.MAX_HEAD_DIM) in src
    assert re.findall(r"launch_dq<(\d+)>\(", src) == ["192", "256"]
    assert re.findall(r"launch_dkdv<(\d+)>\(", src) == ["192", "256"]
    assert flash_mod.BWD_WGMMA_KEYS == flash_mod.BWD_WIDE_KEYS


@pytest.mark.parametrize("hd", [136, 192, 256])
@pytest.mark.parametrize("mode", list(MODES))
def test_wide_twin_matches_oracle_and_jax(mode, hd):
    """At 150 positions, GQA 2, the kernel's tiles: two dq items of 128
    queries (three 64-key tiles), three dkdv items of 64 keys (three
    64-query tiles per head).  Against the oracle in every case and
    against JAX at hd 256 in every mode and at every hd when causal (a
    JAX compile costs about 1 s a shape here)."""
    _check(mode, hd, 1, 150, 150, 4, 2, hd,
           with_jax=hd == 256 or mode == "causal")


@pytest.mark.parametrize("mode", list(MODES))
def test_wide_twin_small_tiles(mode):
    """16-key dq tiles and 16-query dkdv tiles cross many tiles and
    tile edges at hd 256 (the inputs of the hd 256 case above, so JAX's
    gradients are its)."""
    _check(mode, 256, 1, 150, 150, 4, 2, 256, keys=16, queries=16)


@pytest.mark.parametrize("Tq,Tk,mode", [(70, 150, "bidirectional"),
                                        (70, 150, "window"),
                                        (150, 100, "causal")])
def test_wide_twin_tq_ne_tk_and_mqa(Tq, Tk, mode):
    """Tq != Tk, MQA (one KV head for four query heads), hd 200 padded
    to HDP 256.  (JAX's _flash stands for "no window" by Tk + q_chunk +
    1, so it masks pairs farther apart than that: Tq > Tk stays within
    it here, as every model path does.)"""
    _check(mode, Tq + Tk, 1, Tq, Tk, 4, 1, 200)


def test_no_live_key_rows_give_zero_gradients():
    """Tq > Tk with a window: queries past Tk + window - 1 see no key.
    Their lse is +inf, their dq rows are zero, and dk and dv are those of
    the same dO with their rows zeroed, which the oracle gets right."""
    B, Tq, Tk, H, KV, hd, window = 1, 150, 60, 4, 2, 256, 20
    q, k, v, do = _inputs(3, B, Tq, Tk, H, KV, hd)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    dead = torch.arange(Tq) >= Tk + window - 1
    lse = flash_mod.flash_wgmma_lse_ref(tq, tk, causal=True, window=window)
    assert bool((lse[:, :, :Tq][..., dead] == math.inf).all())
    o = ref.flash_attention_ref(tq, tk, tv, causal=True, window=window)
    kw = dict(causal=True, window=window)
    dq, dk, dv = flash_mod.flash_bwd_wide_plan_ref(tq, tk, tv, o, tdo,
                                                   lse=lse, **kw)
    assert not bool(dq[:, dead].any())
    tdo0 = torch.where(dead[None, :, None, None], 0.0, tdo.float()).bfloat16()
    zq, zk, zv = flash_mod.flash_bwd_wide_plan_ref(tq, tk, tv, o, tdo0,
                                                   lse=lse, **kw)
    assert torch.equal(dk, zk) and torch.equal(dv, zv)
    want = ref.flash_attention_bwd_ref(tq, tk, tv, o, tdo0, **kw)
    for g, w in zip((dq[:, ~dead], dk, dv), (want[0][:, ~dead], *want[1:])):
        _gate(g.float().numpy(), w.float().numpy())


def test_route_and_launch_names():
    """bf16 from hd 136 to 256 takes the wide launches, each with its own
    count in ops.launch_counts(); fp32 takes the split-TF32 route."""
    for hd in range(136, 257, 8):
        assert flash_mod.bwd_route(torch.bfloat16, hd) == "wgmma_wide"
        assert flash_mod.bwd_route(torch.float32, hd) == "tf32x3"
    assert flash_mod.bwd_route(torch.bfloat16, 128) == "wgmma"
    assert ops.KERNELS["flash_attention_bwd_wide_dq"] \
        is flash_mod.KERNEL_BWD_WIDE_DQ
    assert ops.KERNELS["flash_attention_bwd_wide_dkdv"] \
        is flash_mod.KERNEL_BWD_WIDE_DKDV
    assert flash_mod.KERNEL_BWD_WIDE_DQ.symbol == \
        "repro_flash_attention_bwd_wide_dq"
    src = (CSRC / "flash_attention_bwd_wgmma_wide.cu").read_text()
    for k in (flash_mod.KERNEL_BWD_WIDE_DQ, flash_mod.KERNEL_BWD_WIDE_DKDV):
        assert f'extern "C" int {k.symbol}(' in src


@pytest.mark.parametrize("hd", [136, 256])
def test_autograd_hands_the_forward_lse_to_the_wide_backward(monkeypatch,
                                                             hd):
    """On the card's route (the CUDA wrappers swapped for their plain
    twins), FlashAttentionFn asks the bf16 forward for the lse at hd
    above 128 and hands it to the backward, whose route is the wide one;
    the gradients through the wide twin pass the bf16 gate against
    autograd of the plain attention."""
    calls = []

    def fwd(q, k, v, *, return_lse=False, **kw):
        calls.append(("fwd", return_lse))
        o = ref.flash_attention_ref(q, k, v, **kw)
        if return_lse:
            return o, flash_mod.flash_wgmma_lse_ref(q, k, **kw)
        return o

    def bwd(q, k, v, o, do, *, lse=None, **kw):
        route = flash_mod.bwd_route(q.dtype, q.shape[-1])
        calls.append(("bwd", route, lse is not None))
        return flash_mod.flash_bwd_wide_plan_ref(q, k, v, o, do, lse=lse,
                                                 **kw)

    monkeypatch.setattr(flash_mod, "flash_attention_cuda", fwd)
    monkeypatch.setattr(flash_mod, "flash_attention_bwd_cuda", bwd)
    monkeypatch.setattr(ops, "use_kernel", lambda t, b: b != "torch")
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _inputs(5, 1, 70, 70, 4, 2, hd))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*leaves, window=30),
                              leaves, do)
    assert calls == [("fwd", True), ("bwd", "wgmma_wide", True)]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        ops.flash_attention(*plain, window=30, backend="torch"), plain, do)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _gate(g.float().numpy(), w.float().numpy())
