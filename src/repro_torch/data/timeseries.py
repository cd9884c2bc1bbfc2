"""Synthetic labelled time-series generators (UCR-archive stand-ins).

A copy of ``repro.data.timeseries``: the port imports nothing from the
JAX package, and the same seed must give the same X bitwise in both, so
the parity tests and ``chip_smoke.py`` feed both packages one dataset.

The UCR archive is not shipped with the repository (DESIGN.md §9), so
these generators produce labelled datasets with the same statistical shape:
k latent classes, each a smooth prototype curve; samples are warped, scaled
and noised copies.  Pearson correlation of within-class pairs is high,
cross-class near zero — the regime TMFG-DBHT targets.

``UCR_SIZES`` mirrors the paper's Table 1 so benchmarks can sweep the same
(n, L, k) grid.
"""

from __future__ import annotations

import numpy as np

# (name, n, L, classes) — from the paper's Table 1
UCR_SIZES = [
    ("CBF", 930, 128, 3),
    ("ECG5000", 5000, 140, 5),
    ("Crop", 19412, 46, 24),
    ("ElectricDevices", 16160, 96, 7),
    ("FreezerSmallTrain", 2878, 301, 2),
    ("HandOutlines", 1370, 2709, 2),
    ("InsectWingbeatSound", 2200, 256, 11),
    ("Mallat", 2400, 1024, 8),
    ("MixedShapesRegularTrain", 2925, 1024, 5),
    ("MixedShapesSmallTrain", 2525, 1024, 5),
    ("NonInvasiveFetalECGThorax1", 3765, 750, 42),
    ("NonInvasiveFetalECGThorax2", 3765, 750, 42),
    ("ShapesAll", 1200, 512, 60),
    ("SonyAIBORobotSurface2", 980, 65, 2),
    ("StarLightCurves", 9236, 84, 2),
    ("UWaveGestureLibraryAll", 4478, 945, 8),
    ("UWaveGestureLibraryX", 4478, 315, 8),
    ("UWaveGestureLibraryY", 4478, 315, 8),
]


def _prototype(L: int, rng: np.random.Generator) -> np.ndarray:
    """Smooth random curve: a few random sinusoids + a random trend."""
    t = np.linspace(0.0, 1.0, L)
    y = np.zeros(L)
    for _ in range(rng.integers(2, 5)):
        f = rng.uniform(0.5, 6.0)
        ph = rng.uniform(0, 2 * np.pi)
        a = rng.uniform(0.5, 1.5)
        y += a * np.sin(2 * np.pi * f * t + ph)
    y += rng.uniform(-1, 1) * t
    return y


def make_dataset(n: int, L: int, k: int, *, noise: float = 0.8,
                 warp: float = 0.05, seed: int = 0):
    """Labelled synthetic dataset: returns (X (n, L) f32, labels (n,))."""
    rng = np.random.default_rng(seed)
    protos = np.stack([_prototype(L, rng) for _ in range(k)])
    labels = rng.integers(0, k, size=n)
    t = np.linspace(0.0, 1.0, L)
    X = np.empty((n, L), np.float32)
    for i in range(n):
        p = protos[labels[i]]
        shift = rng.uniform(-warp, warp)
        ti = np.clip(t + shift, 0, 1)
        base = np.interp(ti, t, p)
        X[i] = (rng.uniform(0.7, 1.3) * base
                + noise * rng.normal(size=L)).astype(np.float32)
    return X, labels


def make_ucr_like(name_or_id, *, scale: float = 1.0, seed: int = 0,
                  noise: float = 0.8):
    """Synthetic stand-in for a paper Table-1 dataset (optionally downscaled
    by ``scale`` for CPU-sized benchmarks)."""
    if isinstance(name_or_id, int):
        name, n, L, k = UCR_SIZES[name_or_id - 1]
    else:
        entry = [e for e in UCR_SIZES if e[0] == name_or_id]
        assert entry, f"unknown dataset {name_or_id}"
        name, n, L, k = entry[0]
    n = max(k * 8, int(n * scale))
    return (name,) + make_dataset(n, L, k, seed=seed, noise=noise) + (k,)
