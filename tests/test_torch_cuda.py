"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips, with the reason, where
there is no GPU (a CUDA kernel has no CPU mode).  The file imports no
JAX, so it runs on a machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: Pearson within 1e-5 absolute of the plain version (the
kernel multiplies by the inverse norm where the plain version divides by
the norm, and sums in another order); min-plus and masked argmax
bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import PipelineConfig, cluster  # noqa: E402
from repro_torch.data.timeseries import make_dataset  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rng(seed):
    return np.random.default_rng(seed)


def _dist(rng, shape, inf_frac):
    A = rng.uniform(0, 5, shape).astype(np.float32)
    if inf_frac:
        A[rng.random(shape) < inf_frac] = np.inf
    return A


# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n,L", [(1, 3), (65, 46), (130, 17), (300, 200)])
def test_cuda_pearson_matches_plain(cuda, n, L):
    X = torch.from_numpy(_rng(n).normal(size=(n, L)).astype(np.float32))
    X = X.to(cuda)
    before = ops.KERNELS["pearson"].launches
    got = ops.pearson(X, backend="cuda")
    torch.cuda.synchronize()
    assert ops.KERNELS["pearson"].launches == before + 1
    assert float((got - ref.pearson_ref(X)).abs().max()) <= 1e-5
    assert torch.equal(got, got.T)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (17, 33, 9), (130, 7, 127),
                                   (140, 300, 300), (300, 140, 300)])
def test_cuda_minplus_bitwise(cuda, m, k, n):
    rng = _rng(m + k + n)
    A = torch.from_numpy(_dist(rng, (m, k), 0.3)).to(cuda)
    B = torch.from_numpy(_dist(rng, (k, n), 0.3)).to(cuda)
    A0, B0 = A.clone(), B.clone()
    got = ops.minplus(A, B, backend="cuda")
    torch.cuda.synchronize()
    assert torch.equal(got, ref.minplus_ref(A, B))
    assert torch.equal(A, A0) and torch.equal(B, B0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(1, 1), (13, 40), (40, 600), (7, 5000)])
def test_cuda_masked_argmax_bitwise(cuda, m, n):
    rng = _rng(m * n)
    S = torch.from_numpy(rng.integers(0, 4, (m, n)).astype(np.float32))
    mask = torch.from_numpy(rng.random(n) < 0.5)
    for msk in (mask, torch.ones(n, dtype=torch.bool)):
        S_d, m_d = S.to(cuda), msk.to(cuda)
        vk, ik = ops.masked_argmax(S_d, m_d, backend="cuda")
        vp, ip = ref.masked_argmax_ref(S_d, m_d)
        torch.cuda.synchronize()
        assert torch.equal(vk, vp) and torch.equal(ik, ip)


@pytest.mark.cuda
def test_cuda_cluster_backends_agree_bitwise(cuda):
    """The whole pipeline through the kernels equals the plain path on
    the card, given one S, and launches every kernel."""
    X, _ = make_dataset(300, 46, 5, noise=0.5, seed=3)
    S = ops.pearson(torch.from_numpy(X).to(cuda), backend="torch")
    ops.reset_launch_counts()
    rc = cluster(S=S, k=5, config=PipelineConfig.opt(backend="cuda"))
    counts = ops.launch_counts()
    rt = cluster(S=S, k=5, config=PipelineConfig.opt(backend="torch"))
    np.testing.assert_array_equal(rc.linkage, rt.linkage)
    np.testing.assert_array_equal(rc.labels, rt.labels)
    assert counts["masked_argmax"] == 299 and counts["minplus"] >= 2
