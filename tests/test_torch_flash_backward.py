"""The flash-attention backward of the port against autograd and JAX.

``ref.flash_attention_bwd_ref`` (the backward kernel's oracle) against
``torch.autograd`` of ``ref.flash_attention_ref`` and against
``jax.vjp`` of the reference's ``_flash(..., unroll_q=True)`` with small
q and kv chunks (what the JAX package differentiates when it trains):
causal, sliding-window and bidirectional, each at GQA group sizes 1, 2
and 4 (head dim 20 at G = 2, 16 otherwise).  ``flash_bwd_plan_ref``, the
plain twin of the kernel's three-launch schedule (its tiles read from
the CUDA source), against the oracle at shapes that cross many tiles;
the autograd wiring of ``ops.flash_attention`` for card tensors
(``ops.FlashAttentionFn``), exercised on the CPU with the CUDA wrappers
swapped for their plain versions.  Inputs are seeded numpy
arrays handed to both packages.

Tolerance: each gradient within 1e-5 times its largest magnitude (fp32:
the einsum and online-softmax summation orders differ, and JAX scales q
by 1 / sqrt(hd) where the oracle divides).
"""

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

MODES = {"causal": (True, 0), "window": (True, 7), "bidirectional": (False, 0)}


def _inputs(seed, B, T, H, KV, hd):
    r = np.random.default_rng(seed)
    return [r.normal(size=s).astype(np.float32)
            for s in ((B, T, H, hd), (B, T, KV, hd), (B, T, KV, hd),
                      (B, T, H, hd))]


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = 1e-5 * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol


@pytest.mark.parametrize("G,hd", [(1, 16), (2, 20), (4, 16)])
@pytest.mark.parametrize("mode", list(MODES))
def test_bwd_ref_matches_autograd_and_jax(mode, G, hd):
    causal, window = MODES[mode]
    B, T, KV = 2, 24, 2
    H = KV * G
    q, k, v, do = _inputs(G * 100 + hd, B, T, H, KV, hd)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    auto = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    got = ref.flash_attention_bwd_ref(
        *(t.detach() for t in (tq, tk, tv, o)), torch.from_numpy(do),
        causal=causal, window=window)

    def fwd(q_, k_, v_):
        return _flash(q_, k_, v_, causal=causal, window=window, q_chunk=8,
                      kv_chunk=8, unroll_q=True)

    def vjp(q_, k_, v_, do_):
        out, pull = jax.vjp(fwd, q_, k_, v_)
        return out, pull(do_.reshape(out.shape))

    jo, jg = zoo.jit(vjp)(*(jnp.asarray(a) for a in (q, k, v, do)))
    _close(o.detach().numpy().reshape(B, T, -1), jo)
    for g, a, j in zip(got, auto, jg):
        assert g.dtype == torch.float32
        _close(g.numpy(), a.numpy())
        _close(g.numpy(), j)


# The tiles of csrc/flash_attention_bwd.cu, read from the source so that
# the schedule twin below walks the kernel's own: kBQ queries per tile,
# and BK keys per tile for each head-dim class of its dispatch.
_CU = (Path(flash_mod.__file__).parent / "csrc"
       / "flash_attention_bwd.cu").read_text()
BWD_QUERIES = int(re.search(r"constexpr int kBQ = (\d+);", _CU).group(1))
_BWD_KEYS = [(int(hd), int(bk)) for hd, bk in re.findall(
    r"F<float, (\d+), (\d+)>", _CU)]


def bwd_keys(hd: int) -> int:
    """Keys per tile of the backward at head dim ``hd``."""
    return next(bk for cls, bk in _BWD_KEYS if hd <= cls)


def bwd_query_rows(k_lo: int, keys: int, Tq: int, causal: bool,
                   window: int):
    """[t_lo, t_hi): the query rows that can see keys [k_lo, k_lo +
    keys), as the dK/dV launch bounds its loop (causal: t >= k_lo;
    window: t < k_lo + keys - 1 + window)."""
    t_lo = k_lo if causal else 0
    t_hi = min(Tq, k_lo + keys - 1 + window) if window > 0 else Tq
    return t_lo, t_hi


def flash_bwd_plan_ref(q, k, v, o, do, *, causal=True, window=0,
                       scale=None, keys=None):
    """The plain twin of the backward kernel's schedule, in fp32: (a)
    each query tile's lse over the key tiles ``key_tiles`` keeps, by the
    online max and sum, and D; (b) per key tile, dK and dV over the heads
    of its group and the query tiles from ``bwd_query_rows``; (c) per
    query tile, dQ over the key tiles ``key_tiles`` keeps.  Returns (dq,
    dk, dv) in fp32.  ``keys`` defaults to the kernel's tile and may be
    set smaller to walk many tiles at a small shape."""
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    G = H // KV
    keys = keys or bwd_keys(hd)
    P = BWD_QUERIES
    mul = 1.0 / math.sqrt(hd) if scale is None else scale
    qs = q.float() * torch.tensor(mul, dtype=torch.float32)
    kf, vf, dof = k.float(), v.float(), do.float()
    D = (dof * o.float()).sum(-1)                                # (B, Tq, H)

    def live(t0, n_t, j0, n_j):
        ti = torch.arange(t0, t0 + n_t)[:, None]
        ji = torch.arange(j0, j0 + n_j)[None, :]
        ok = (ti < Tq) & (ji < Tk)
        if causal:
            ok &= ji <= ti
        if window > 0:
            ok &= ti - ji < window
        return ok

    lse = torch.full((B, Tq, H), float("inf"))
    for b in range(B):
        for h in range(H):
            for q_lo in range(0, Tq, P):
                rows = qs[b, q_lo:q_lo + P, h]
                m = torch.full((rows.shape[0],), flash_mod.NEG)
                l = torch.zeros(rows.shape[0])
                lo, hi = flash_mod.key_tiles(q_lo, P, Tk, causal, window,
                                             keys)
                for kt in range(lo, hi):
                    s = rows @ kf[b, kt * keys:(kt + 1) * keys, h // G].T
                    ok = live(q_lo, s.shape[0], kt * keys, s.shape[1])
                    m_new = torch.maximum(
                        m, torch.where(ok, s, flash_mod.NEG).amax(1))
                    l = l * torch.exp(m - m_new) + torch.where(
                        ok, torch.exp(s - m_new[:, None]), 0.0).sum(1)
                    m = m_new
                lse[b, q_lo:q_lo + P, h] = torch.where(
                    l > 0, m + torch.log(l), float("inf"))

    def p_ds(b, h, q_lo, kt):
        rows = slice(q_lo, q_lo + P)
        cols = slice(kt * keys, (kt + 1) * keys)
        s = qs[b, rows, h] @ kf[b, cols, h // G].T
        ok = live(q_lo, s.shape[0], kt * keys, s.shape[1])
        p = torch.where(ok, torch.exp(s - lse[b, rows, h][:, None]), 0.0)
        dp = dof[b, rows, h] @ vf[b, cols, h // G].T
        return p, p * (dp - D[b, rows, h][:, None])

    dq = torch.zeros((B, Tq, H, hd))
    dk = torch.zeros((B, Tk, KV, hd))
    dv = torch.zeros((B, Tk, KV, hd))
    for b in range(B):
        for kvh in range(KV):
            for kt in range(-(-Tk // keys)):
                t_lo, t_hi = bwd_query_rows(kt * keys, keys, Tq, causal,
                                            window)
                cols = slice(kt * keys, (kt + 1) * keys)
                for h in range(kvh * G, (kvh + 1) * G):
                    for q_lo in range(t_lo // P * P, t_hi, P):
                        p, ds = p_ds(b, h, q_lo, kt)
                        dv[b, cols, kvh] += p.T @ dof[b, q_lo:q_lo + P, h]
                        dk[b, cols, kvh] += ds.T @ qs[b, q_lo:q_lo + P, h]
        for h in range(H):
            for q_lo in range(0, Tq, P):
                lo, hi = flash_mod.key_tiles(q_lo, P, Tk, causal, window,
                                             keys)
                for kt in range(lo, hi):
                    _, ds = p_ds(b, h, q_lo, kt)
                    dq[b, q_lo:q_lo + P, h] += \
                        ds @ kf[b, kt * keys:(kt + 1) * keys, h // G]
    return dq * mul, dk, dv


@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_schedule_twin_matches_oracle(mode):
    """The three launches' loop bounds (the forward's key tiles for the
    rows and dQ, ``bwd_query_rows`` for dK and dV) at 150 positions over
    16-key tiles, and over the kernel's own 64-key tiles."""
    causal, window = MODES[mode]
    window = window and 40
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(7, 1, 150, 4, 2, 16))
    o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, causal=causal,
                                       window=window)
    for keys in (16, None):
        got = flash_bwd_plan_ref(q, k, v, o, do, causal=causal,
                                           window=window, keys=keys)
        for g, w in zip(got, want):
            _close(g.numpy(), w.numpy())


def test_bwd_tiles_and_row_bounds():
    assert bwd_keys(128) == 64 and bwd_keys(256) == 32
    # causal: rows from the tile's first key; window: up to k + keys - 2 + w
    assert bwd_query_rows(128, 64, 4096, True, 0) == (128, 4096)
    assert bwd_query_rows(128, 64, 4096, True, 100) == (128, 291)
    assert bwd_query_rows(128, 64, 200, False, 0) == (0, 200)


def _plain_cuda(monkeypatch, calls):
    """The CUDA wrappers swapped for their plain versions (CPU tensors),
    each call recorded, and ``ops.use_kernel`` true for every backend but
    "torch": the card's route, run on the CPU."""
    def fwd(q, k, v, *, return_lse=False, **kw):
        calls.append("fwd")
        o = ref.flash_attention_ref(q, k, v, **kw)
        return (o, flash_mod.flash_lse_ref(q, k, **kw)) if return_lse else o

    def bwd(q, k, v, o, do, *, lse=None, **kw):
        calls.append("bwd")
        return ref.flash_attention_bwd_ref(q, k, v, o, do, **kw)

    monkeypatch.setattr(flash_mod, "flash_attention_cuda", fwd)
    monkeypatch.setattr(flash_mod, "flash_attention_bwd_cuda", bwd)
    monkeypatch.setattr(ops, "use_kernel", lambda t, b: b != "torch")


def test_card_route_differentiates_through_the_backward_kernel(monkeypatch):
    """With gradients asked for, the card's route goes through
    FlashAttentionFn (the output has its grad_fn and the backward calls
    the backward kernel's wrapper once); without, the forward kernel is
    called directly and the output has no grad_fn.  The gradients equal
    autograd's of the plain version."""
    calls = []
    _plain_cuda(monkeypatch, calls)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, 1, 20, 4, 2, 16))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, window=5)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, leaves, do)
    assert calls == ["fwd", "bwd"]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        ops.flash_attention(*plain, window=5, backend="torch"), plain, do)
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy())
    calls.clear()
    with torch.no_grad():
        out = ops.flash_attention(*leaves, window=5)
    assert out.grad_fn is None and calls == ["fwd"]
    calls.clear()
    assert ops.flash_attention(q, k, v).grad_fn is None and calls == ["fwd"]


def test_cuda_backend_on_cpu_tensors_raises():
    """No quiet fallback: the backward kernel's wrapper and the card's
    route refuse CPU tensors, and count no launch."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(4, 1, 8, 2, 1, 16))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        flash_mod.flash_attention_bwd_cuda(q, k, v, q, do)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.flash_attention(q.requires_grad_(), k, v, backend="cuda")
    assert not any(ops.launch_counts().values())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the backward kernel has no CPU "
                    "mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_matches_oracle(cuda, dtype):
    """The backward kernel through autograd against the oracle on the
    card: fp32 within 1e-5 of each gradient's largest magnitude, bf16
    within 2^-7 of it."""
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(cuda, dt)
                   for a in _inputs(5, 1, 200, 8, 2, 64))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, window=70)
    got = torch.autograd.grad(out, leaves, do)
    want = ref.flash_attention_bwd_ref(q, k, v, out.detach(), do, window=70)
    rel = 1e-5 if dtype == "float32" else 2.0 ** -7
    for g, w in zip(got, want):
        assert g.dtype == dt
        err = float((g.float() - w.float()).abs().max())
        assert err <= rel * float(w.float().abs().max()), err
