"""``examples/cluster_timeseries_torch.py``, the twin of
``examples/cluster_timeseries.py``, run on the CPU in a subprocess at a
small scale (CBF at 0.05: 46 series of 128), against the JAX example's
functions on the same data run here meanwhile: each variant's TMFG edge
sum within 1e-4 relative and its ARI within 1e-6 (both printed to six
decimals), and the stream replay's line."""

import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.core.ari import ari  # noqa: E402
from repro.core.pipeline import VARIANTS, cluster  # noqa: E402
from repro.data.timeseries import make_ucr_like  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SCALE = "0.05"


def test_cluster_timeseries_torch_example_matches_jax():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "cluster_timeseries_torch.py"),
         "CBF", SCALE, "--device", "cpu"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
    _, X, labels, k = make_ucr_like("CBF", scale=float(SCALE))
    want = {}
    for variant in VARIANTS:
        res = cluster(X, k=k, variant=variant)
        want[variant] = (ari(labels, res.labels), float(res.edge_sum))
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    got = {}
    for line in out.splitlines():
        parts = line.split()
        if parts and parts[0] in want:
            got[parts[0]] = (float(parts[2]), float(parts[3]))
    assert set(got) == set(want)
    for variant, (a, s) in want.items():
        assert abs(got[variant][0] - a) <= 1e-6, variant
        assert abs(got[variant][1] - s) <= 1e-4 * abs(s), variant
    assert "stream: " in out and "final ARI" in out
