"""The port's pipeline (``repro_torch.core.cluster``) against JAX, and the
package rules.

  * Given the reference's own S, ``cluster`` gives bitwise the JAX
    linkage and labels for the OPT and HEAP variants.
  * From X, the two Pearson products round differently (within 1e-6,
    tests/test_torch_kernels.py), so the labels and the merge structure
    (ids and sizes) must be equal, and the merge heights close: a
    distance sqrt(2(1-rho)) turns a 1e-7 change of rho into up to about
    1e-5 near rho = 1, which the DBHT offsets carry into the heights.
  * ``fused=True`` and ``fused=False`` are bitwise the same run.
  * Without a GPU, ``cluster(X)`` raises unless ``device="cpu"``.
  * ``repro_torch`` and ``chip_smoke.py`` import neither jax nor repro.
"""

import ast
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import ari as jari  # noqa: E402
from repro.data import timeseries as jts  # noqa: E402
from repro.kernels.ref import pearson_ref as jpearson  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.data import timeseries as tts  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def data():
    X, y = tts.make_dataset(60, 46, 4, noise=0.7, seed=11)
    return X, y, np.asarray(jpearson(jnp.asarray(X)))


@pytest.mark.parametrize("variant", ["opt", "heap"])
def test_cluster_on_reference_S_is_bitwise(data, variant):
    X, y, S = data
    want = jcore.cluster(S=S, k=4, config=jcore.PipelineConfig.variant(
        variant))
    got = tcore.cluster(S=S, k=4, config=tcore.PipelineConfig.variant(
        variant), device="cpu")
    np.testing.assert_array_equal(got.linkage, np.asarray(want.linkage))
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.edge_sum == want.edge_sum
    assert got.linkage.dtype == np.float32


@pytest.mark.parametrize("variant", ["opt", "heap"])
def test_cluster_from_X_matches_reference(data, variant):
    X, y, _ = data
    want = jcore.cluster(X, k=4, config=jcore.PipelineConfig.variant(variant))
    got = tcore.cluster(X, k=4, config=tcore.PipelineConfig.variant(variant),
                        device="cpu")
    Zw = np.asarray(want.linkage)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.linkage[:, [0, 1, 3]], Zw[:, [0, 1, 3]])
    np.testing.assert_allclose(got.linkage[:, 2], Zw[:, 2], rtol=0,
                               atol=1e-4)


def test_fused_and_staged_are_the_same_run(data):
    X, _, _ = data
    a = tcore.cluster(X, k=4, device="cpu", collect_timings=True)
    b = tcore.cluster(X, k=4, device="cpu", fused=False,
                      collect_timings=True)
    np.testing.assert_array_equal(a.linkage, b.linkage)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert set(b.timings) >= {"similarity", "tmfg", "apsp", "dbht", "hac",
                              "total", "tmfg_pops", "tmfg_host_syncs",
                              "apsp_rounds"}
    T = tcore.tmfg.STEPS_PER_SYNC
    assert b.timings["tmfg_host_syncs"] <= math.ceil(
        b.timings["tmfg_pops"] / T) + 3
    assert "tmfg" not in a.timings and a.timings["total"] > 0


def test_default_device_is_cuda_and_raises_without_one(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    X, _, _ = data
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.cluster(X, k=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.pipeline.similarity_from_timeseries(X)


def test_similarity_from_timeseries_on_cpu(data):
    X, _, S = data
    got = tcore.pipeline.similarity_from_timeseries(X, device="cpu")
    np.testing.assert_allclose(got.numpy(), S, rtol=0, atol=1e-6)


@pytest.mark.parametrize("field,value", [
    ("filter", "pmfg"), ("filter", "ag"), ("filter", "mst"),
    ("clean", "rmt")])
def test_filter_knobs_match_reference(data, field, value):
    """Every knob value of the filter matrix runs on the CPU with the
    reference's labels and merge structure (heights within 1e-4 from X,
    the rule above)."""
    if value == "pmfg":
        pytest.importorskip("networkx")
    X, _, _ = data
    X = X[:32]
    cfg = tcore.PipelineConfig().replace(**{field: value})
    want = jcore.cluster(X, k=4, config=jcore.PipelineConfig().replace(
        **{field: value}))
    got = tcore.cluster(X, k=4, config=cfg, device="cpu")
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.linkage[:, [0, 1, 3]],
                                  np.asarray(want.linkage)[:, [0, 1, 3]])
    np.testing.assert_allclose(got.linkage[:, 2],
                               np.asarray(want.linkage)[:, 2], atol=1e-4)
    np.testing.assert_array_equal(got.tmfg.edges.numpy(),
                                  np.asarray(want.tmfg.edges))


def test_approx_config_runs_on_cpu_and_needs_a_card_by_default(data):
    X, _, _ = data
    cfg = tcore.PipelineConfig.approx(sim_k=8)
    res = tcore.cluster(X, k=4, config=cfg, device="cpu")
    assert res.labels.shape == (60,) and len(np.unique(res.labels)) == 4
    assert res.linkage.shape == (59, 4)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.cluster(X, k=4, config=cfg)


def test_config_copy_agrees_with_reference():
    assert tconfig.VARIANTS == jcore.config.VARIANTS
    for name in tconfig.VARIANTS:
        assert (tcore.PipelineConfig.variant(name).content_key()
                == jcore.PipelineConfig.variant(name).content_key())
    assert tcore.PipelineConfig().content_key() == \
        jcore.PipelineConfig().content_key()
    with pytest.raises(ValueError, match="unknown backend"):
        tcore.PipelineConfig(backend="pallas")
    assert tcore.PipelineConfig(backend="cuda").backend == "cuda"


def test_data_and_ari_copies_agree_with_reference():
    assert tts.UCR_SIZES == jts.UCR_SIZES
    for seed in (0, 3):
        Xt, yt = tts.make_dataset(30, 20, 3, seed=seed)
        Xj, yj = jts.make_dataset(30, 20, 3, seed=seed)
        np.testing.assert_array_equal(Xt, Xj)
        np.testing.assert_array_equal(yt, yj)
    a = tts.make_ucr_like("CBF", scale=0.03, seed=1)
    b = jts.make_ucr_like("CBF", scale=0.03, seed=1)
    assert a[0] == b[0] and a[3] == b[3]
    np.testing.assert_array_equal(a[1], b[1])
    r = np.random.default_rng(0)
    for _ in range(5):
        u, v = r.integers(0, 4, 50), r.integers(0, 5, 50)
        assert tcore.adjusted_rand_index(u, v) == jari.ari(u, v)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
