"""State-space blocks: Mamba2 (chunked SSD) and xLSTM (mLSTM / sLSTM).

The port of ``repro.models.ssm``.  Mamba2 runs the SSD (state-space
duality) chunked algorithm: within a chunk of 128 positions the
recurrence is a masked quadratic form (``einsum`` products, as the
reference computes it outside any Pallas kernel); across chunks a Python
loop carries the (B, H, N, P) state, the reference's ``lax.scan``.
``mamba2_sequential_ref`` is the O(T) recurrence, the plain twin the
tests hold the chunked form against.  Decode is the O(1) recurrent
update.

mLSTM and sLSTM are recurrences over time (the reference's scans) in a
Python loop: sLSTM's hidden state feeds its gates, so it admits no
chunked form.  States are NamedTuples of fp32 tensors, batch first.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import dense_init


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def _dims(cfg):
    """(din, N, H) of a Mamba2 layer."""
    din = cfg.ssm_expand * cfg.d_model
    return din, cfg.ssm_state, din // cfg.ssm_head_dim


def mamba2_init(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    din, N, H = _dims(cfg)
    conv_ch = din + 2 * N
    dev = gen.device
    return {
        # fused in-projection: [z (din), x (din), B (N), C (N), dt (H)]
        "w_in": dense_init(gen, d, 2 * din + 2 * N + H, dtype),
        "conv_w": (torch.randn((cfg.ssm_conv, conv_ch), generator=gen,
                               device=dev) * 0.1).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.full((H,), math.log(math.e - 1),
                              dtype=torch.float32, device=dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((din,), dtype=dtype, device=dev),
        "w_out": dense_init(gen, din, d, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, T, C); w: (K, C).  The taps are
    summed in the reference's order."""
    K, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = 0
    for i in range(K):
        out = out + xp[:, i:i + T] * w[i]
    return out + b


def _split_in(p, x: torch.Tensor, cfg):
    din, N, H = _dims(cfg)
    proj = x @ p["w_in"]
    z, rest = proj[..., :din], proj[..., din:]
    xbc, dt = rest[..., :din + 2 * N], rest[..., din + 2 * N:]
    return z, xbc, dt, din, N, H


def _gated_out(p, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = y * F.silu(z)
    # RMS norm over din
    y32 = y.float()
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + 1e-6)).to(y.dtype) * p["norm_scale"]
    return y @ p["w_out"]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j < m <= i} a[..., m] for i >= j, -inf
    otherwise."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(Q, device=a.device)
    return torch.where(ii[:, None] >= ii[None, :], diff, float("-inf"))


def _conv_inputs(p, x: torch.Tensor, cfg):
    """The projections and the conv of a Mamba2 layer over x (B, T, d):
    (z, xs (B, T, H, P), Bm, Cm (B, T, N), dt (B, T, H) fp32, A (H,),
    din)."""
    B, T, _ = x.shape
    z, xbc, dt, din, N, H = _split_in(p, x, cfg)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :din].reshape(B, T, H, cfg.ssm_head_dim)
    Bm, Cm = xbc[..., din:din + N], xbc[..., din + N:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return z, xs, Bm, Cm, dt, A, din


def mamba2_forward(p, x: torch.Tensor, cfg, *, chunk: int = 128):
    """Chunked SSD forward.  x: (B, T, d) -> ((B, T, d), the last state
    (B, H, N, P) fp32); T need not be a multiple of the chunk."""
    B, T, d = x.shape
    z, xs, Bm, Cm, dt, A, din = _conv_inputs(p, x, cfg)
    H, P = xs.shape[2], xs.shape[3]
    N = Bm.shape[-1]
    dA = dt * A                                                # (B, T, H)

    Q = min(chunk, T)
    pad = (-T) % Q
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (T + pad) // Q
    xs_c = xs.reshape(B, nc, Q, H, P)
    B_c = Bm.reshape(B, nc, Q, N)
    C_c = Cm.reshape(B, nc, Q, N)
    dA_c = dA.reshape(B, nc, Q, H)
    dt_c = dt.reshape(B, nc, Q, H)

    # intra-chunk (quadratic, attention-like)
    L = torch.exp(_segsum(dA_c.movedim(-1, -2)))               # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", C_c, B_c)         # (B,nc,Q,Q)
    M = scores[:, :, None] * L                                 # (B,nc,H,Q,Q)
    xdt = xs_c * dt_c[..., None]                               # (B,nc,Q,H,P)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", M, xdt.float())

    # chunk states: S_c = sum_i exp(cum_end - cum_i) dt_i B_i x_i^T
    cum = torch.cumsum(dA_c, dim=2)                            # (B,nc,Q,H)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    S_chunk = torch.einsum("bcqn,bcqh,bcqhp->bchnp", B_c.float(),
                           (dt_c * decay_to_end).float(), xs_c.float())
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (B,nc,H)

    # inter-chunk recurrence over the nc chunks
    S = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    y_inter = []
    for c in range(nc):
        decay_in = torch.exp(cum[:, c])                        # (B,Q,H)
        y_inter.append(torch.einsum("bqn,bhnp,bqh->bqhp", C_c[:, c].float(),
                                    S, decay_in))
        S = chunk_decay[:, c, :, None, None] * S + S_chunk[:, c]
    y_inter = torch.stack(y_inter, dim=1)                      # (B,nc,Q,H,P)

    y = (y_intra + y_inter).reshape(B, T + pad, H, P)[:, :T]
    y = y + xs[:, :T] * p["D"][None, None, :, None]
    y = y.reshape(B, T, din).to(x.dtype)
    return _gated_out(p, y, z), S


def mamba2_sequential_ref(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """The O(T) sequential recurrence the chunked form computes: the
    tests' plain twin of ``mamba2_forward``."""
    B, T, d = x.shape
    z, xs, Bm, Cm, dt, A, din = _conv_inputs(p, x, cfg)
    H, P, N = xs.shape[2], xs.shape[3], Bm.shape[-1]
    S = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        S = S * torch.exp(dt[:, t] * A)[..., None, None]
        S = S + torch.einsum("bn,bh,bhp->bhnp", Bm[:, t].float(), dt[:, t],
                             xs[:, t].float())
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t].float(), S))
    y = torch.stack(ys, dim=1)                                 # (B,T,H,P)
    y = y + xs * p["D"][None, None, :, None]
    y = y.reshape(B, T, din).to(x.dtype)
    return _gated_out(p, y, z)


class MambaState(NamedTuple):
    S: torch.Tensor      # (B, H, N, P) ssm state, fp32
    conv: torch.Tensor   # (B, K-1, C) conv history


def mamba2_state_init(cfg, batch: int, dtype: torch.dtype,
                      device) -> MambaState:
    din, N, H = _dims(cfg)
    return MambaState(
        S=torch.zeros((batch, H, N, cfg.ssm_head_dim), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, din + 2 * N),
                         dtype=dtype, device=device))


def mamba2_decode(p, x: torch.Tensor, state: MambaState, cfg):
    """One-token recurrent update.  x: (B, 1, d) -> ((B, 1, d), the new
    MambaState)."""
    B = x.shape[0]
    z, xbc, dt, din, N, H = _split_in(p, x, cfg)
    P = cfg.ssm_head_dim
    hist = torch.cat([state.conv, xbc], dim=1)                 # (B, K, C)
    conv_out = (hist * p["conv_w"][None]).sum(dim=1, keepdim=True)
    xbc1 = F.silu(conv_out + p["conv_b"])                      # (B, 1, C)
    xs = xbc1[..., :din].reshape(B, H, P)
    Bm = xbc1[:, 0, din:din + N]
    Cm = xbc1[:, 0, din + N:]
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])
    dA = torch.exp(dt1 * -torch.exp(p["A_log"]))               # (B, H)
    S = state.S * dA[..., None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", Bm.float(), dt1, xs.float())
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), S)
    y = y + xs * p["D"][None, :, None]
    y = y.reshape(B, 1, din).to(x.dtype)
    return _gated_out(p, y, z), MambaState(S=S, conv=hist[:, 1:])


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (a recurrence with stabilised exponential gating)
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    return {
        "wq": dense_init(gen, d, d, dtype),
        "wk": dense_init(gen, d, d, dtype),
        "wv": dense_init(gen, d, d, dtype),
        "wi": dense_init(gen, d, H, torch.float32),   # input gate (exp)
        "wf": dense_init(gen, d, H, torch.float32),   # forget gate
        "wo": dense_init(gen, d, d, dtype),
        "og": torch.zeros((d,), dtype=dtype, device=gen.device),
    }


class MLSTMState(NamedTuple):
    C: torch.Tensor   # (B, H, hd, hd) matrix memory
    n: torch.Tensor   # (B, H, hd) normalizer
    m: torch.Tensor   # (B, H) stabilizer


def mlstm_state_init(cfg, batch: int, device, d_model=None) -> MLSTMState:
    d = d_model or cfg.d_model
    H = cfg.n_heads
    hd = d // H
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(C=torch.zeros((batch, H, hd, hd), **f32),
                      n=torch.zeros((batch, H, hd), **f32),
                      m=torch.full((batch, H), -1e30, **f32))


def _mlstm_step(state: MLSTMState, q, k, v, i_t, f_t):
    """q, k, v: (B, H, hd); i_t, f_t: (B, H) -> (new state, h (B, H, hd))."""
    C, n, m = state
    m_new = torch.maximum(f_t + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_t + m - m_new)
    C = f_p[..., None, None] * C + i_p[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * k
    num = torch.einsum("bhij,bhj->bhi", C, q)
    den = torch.clamp(torch.einsum("bhj,bhj->bh", n, q).abs(), min=1.0)
    return MLSTMState(C, n, m_new), num / den[..., None]


def _mlstm_inputs(p, x: torch.Tensor, cfg):
    """q, k (scaled), v (..., H, hd) fp32 and the gates i, f (..., H) of
    x (..., d)."""
    d = x.shape[-1]
    H = cfg.n_heads
    hd = d // H
    lead = x.shape[:-1]
    q = (x @ p["wq"]).reshape(*lead, H, hd).float() / math.sqrt(hd)
    k = (x @ p["wk"]).reshape(*lead, H, hd).float() / math.sqrt(hd)
    v = (x @ p["wv"]).reshape(*lead, H, hd).float()
    i_t = x.float() @ p["wi"]
    f_t = F.logsigmoid(x.float() @ p["wf"])
    return q, k, v, i_t, f_t


def mlstm_forward(p, x: torch.Tensor, cfg):
    """x: (B, T, d) -> ((B, T, d), the last MLSTMState)."""
    B, T, d = x.shape
    q, k, v, i_t, f_t = _mlstm_inputs(p, x, cfg)
    st = mlstm_state_init(cfg, B, x.device, d)
    hs = []
    for t in range(T):
        st, h = _mlstm_step(st, q[:, t], k[:, t], v[:, t], i_t[:, t],
                            f_t[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, T, d).to(x.dtype)
    return h * torch.sigmoid(x @ p["wo"] + p["og"]), st


def mlstm_decode(p, x: torch.Tensor, state: MLSTMState, cfg):
    B, _, d = x.shape
    q, k, v, i_t, f_t = _mlstm_inputs(p, x[:, 0], cfg)
    st, h = _mlstm_step(state, q, k, v, i_t, f_t)
    h = h.reshape(B, 1, d).to(x.dtype)
    return h * torch.sigmoid(x @ p["wo"] + p["og"]), st


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, a nonlinear recurrence)
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, cfg, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    return {
        "wz": dense_init(gen, d, d, dtype),
        "wi": dense_init(gen, d, d, torch.float32),
        "wf": dense_init(gen, d, d, torch.float32),
        "wo": dense_init(gen, d, d, dtype),
        "r": torch.randn((d,), generator=gen, device=gen.device) * 0.1,
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, d)
    n: torch.Tensor   # (B, d)
    m: torch.Tensor   # (B, d)
    h: torch.Tensor   # (B, d)


def slstm_state_init(cfg, batch: int, device, d_model=None) -> SLSTMState:
    d = d_model or cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return SLSTMState(c=torch.zeros((batch, d), **f32),
                      n=torch.zeros((batch, d), **f32),
                      m=torch.full((batch, d), -1e30, **f32),
                      h=torch.zeros((batch, d), **f32))


def _slstm_step(p, state: SLSTMState, xt: torch.Tensor):
    c, n, m, h = state
    rec = h * p["r"]                                  # diagonal recurrence
    z = torch.tanh(xt @ p["wz"] + rec.to(xt.dtype))
    i_t = xt.float() @ p["wi"] + rec
    f_t = F.logsigmoid(xt.float() @ p["wf"] + rec)
    o = torch.sigmoid(xt @ p["wo"])
    m_new = torch.maximum(f_t + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_t + m - m_new)
    c = f_p * c + i_p * z.float()
    n = f_p * n + i_p
    h_new = (c / torch.clamp(n, min=1.0)) * o.float()
    return SLSTMState(c, n, m_new, h_new)


def slstm_forward(p, x: torch.Tensor, cfg):
    """x: (B, T, d) -> ((B, T, d), the last SLSTMState)."""
    B, T, d = x.shape
    st = slstm_state_init(cfg, B, x.device, d)
    hs = []
    for t in range(T):
        st = _slstm_step(p, st, x[:, t])
        hs.append(st.h)
    return torch.stack(hs, dim=1).to(x.dtype), st


def slstm_decode(p, x: torch.Tensor, state: SLSTMState, cfg):
    st = _slstm_step(p, state, x[:, 0])
    return st.h[:, None].to(x.dtype), st
