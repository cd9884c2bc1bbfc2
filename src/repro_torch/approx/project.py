"""Seeded random-projection sketches → per-row candidate pools
(DESIGN.md §13.1).

The port of ``repro.approx.project``.  Pearson correlation of
standardised rows is a cosine, and a Johnson–Lindenstrauss projection of
``X (n, L)`` to ``(n, dim)`` keeps cosines to about 1/sqrt(dim), so the
top-``pool`` partners of each row in the sketch (``ops.topk`` on the
sketch: ``csrc/topk.cu`` on the card) are candidates that
``knn.rescore_pools`` then rescores with exact Pearson dots.

The projection matrix R (L, dim) is the reference's for the same seed:
:func:`projection` computes ``jax.random.normal(PRNGKey(seed), (L, dim),
float32) / sqrt(dim)`` in numpy, on the host, and moves it to X's device,
so one seed gives one R, and the same pools, on the CPU, on the card and
in the reference.  The steps are JAX's default ``threefry2x32`` stream:

  * the key of ``PRNGKey(seed)`` with 32-bit integers: (0, seed mod 2^32);
  * one 32-bit word per element, the element's flat index i as the
    counter pair (i >> 32, i & 0xffffffff) through threefry2x32 (20
    rounds), the two output words xor-ed (the partitionable layout);
  * the word's top 23 bits as the mantissa of a float in [1, 2), minus 1,
    scaled to [nextafter(-1, 0), 1) and clamped below there;
  * ``sqrt(2) * erfinv(u)`` with XLA's float32 erfinv, Giles' polynomial
    (each step one fused multiply-add, rounded once).  An exact erfinv
    differs from that polynomial by up to 3e-6 relative in the tails.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import standardize_rows

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# Giles' single-precision erfinv ("Approximating the erfinv function",
# GPU Computing Gems), as XLA lowers erf_inv for float32: w < 5, w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """The threefry2x32 block cipher (20 rounds) on uint32 counter words
    (x0, x1) under ``key`` = (k0, k1); returns the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_KS_PARITY))
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _key(seed: int):
    """``PRNGKey(seed)``'s two words with 32-bit integers: the seed is
    taken mod 2^32 as an int32, whose 32-bit right shift is 0."""
    return 0, int(seed) & 0xFFFFFFFF


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv: Giles' polynomial in w = -log1p(-x²)."""
    x = x.astype(np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    coef = [np.where(lt, np.float32(a), np.float32(b))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    w64 = w.astype(np.float64)
    for c in coef[1:]:
        # c + p * w as one fused multiply-add: the product of two float32
        # is exact in float64, so the sum rounds once (then to float32)
        p = (c.astype(np.float64) + p.astype(np.float64) * w64) \
            .astype(np.float32)
    out = p * x
    return np.where(np.abs(x) == 1.0, x * np.finfo(np.float32).max, out)


def normal_f32(seed: int, shape) -> np.ndarray:
    """``jax.random.normal(PRNGKey(seed), shape, float32)`` in numpy."""
    size = int(np.prod(shape))
    i = np.arange(size, dtype=np.uint64)
    b0, b1 = threefry2x32(_key(seed), (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = b0 ^ b1
    one = np.float32(1.0)
    f = ((bits >> np.uint32(9)) | one.view(np.uint32)).view(np.float32) - one
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, f * (one - lo) + lo)
    z = np.float32(math.sqrt(2.0)) * _erfinv_f32(u)
    return z.astype(np.float32).reshape(shape)


def projection(L: int, dim: int, seed: int) -> torch.Tensor:
    """The (L, dim) N(0, 1/dim) projection matrix of ``seed`` (the
    reference's R), on the CPU."""
    R = normal_f32(seed, (L, dim)) / np.float32(math.sqrt(float(dim)))
    return torch.from_numpy(R.astype(np.float32))


def sketch(X: torch.Tensor, *, dim: int = 64, seed: int = 0) -> torch.Tensor:
    """(n, L) → (n, dim) seeded Gaussian random-projection sketch of the
    standardised rows (so it approximates Pearson, not raw cosine)."""
    X = torch.as_tensor(X).float()
    Z = standardize_rows(X)
    R = projection(X.shape[1], dim, seed).to(X.device)
    return Z @ R


def candidate_pools(X: torch.Tensor, pool: int, *, dim: int = 64,
                    seed: int = 0, backend: str = "auto") -> torch.Tensor:
    """Per-row candidate pools from the sketch: (n, pool) int32 indices,
    the sketch-similarity top-``pool`` of each row (``pool`` clamped to
    n - 1), ordered by value descending then index ascending, never the
    row itself."""
    s = sketch(X, dim=dim, seed=seed)
    pool = min(int(pool), s.shape[0] - 1)
    _, idx = ops.topk(s, pool, backend=backend)
    return idx
