"""The port's LM integration wrappers (``repro_torch.core.integration``)
against ``repro.core.integration`` on the same inputs: equal labels and
an equal ``cluster_batch_order`` permutation.  The embeddings are
mean-pooled in float32 by both (the pooled values may differ in the last
bit, so the data is well separated), and every wrapper is
``cluster()`` on the array it pools or transposes, bitwise."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import integration as jint  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import integration as tint  # noqa: E402


@pytest.fixture(scope="module")
def embeddings():
    """(60, 24, 16) token embeddings of three domains."""
    rng = np.random.default_rng(0)
    domain = rng.integers(0, 3, 60)
    centers = rng.normal(size=(3, 1, 16))
    emb = centers[domain] + 0.6 * rng.normal(size=(60, 24, 16))
    return emb.astype(np.float32), domain


@pytest.fixture(scope="module")
def router():
    rng = np.random.default_rng(1)
    return rng.dirichlet(np.ones(8), size=512).astype(np.float32)


def test_cluster_sequences_matches_reference(embeddings):
    emb, _ = embeddings
    want, _ = jint.cluster_sequences(emb, k=3)
    got, res = tint.cluster_sequences(emb, k=3, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert res.labels is got


def test_cluster_sequences_is_cluster_on_the_pooled_embeddings(embeddings):
    emb, _ = embeddings
    got, res = tint.cluster_sequences(torch.from_numpy(emb), k=3,
                                      device="cpu")
    pooled = torch.from_numpy(emb).mean(dim=1)
    want = tcore.cluster(pooled, k=3, device="cpu")
    np.testing.assert_array_equal(res.linkage, want.linkage)
    # a (batch, d) input is taken as pooled already
    again, _ = tint.cluster_sequences(pooled.numpy(), k=3, device="cpu")
    np.testing.assert_array_equal(again, got)


def test_cluster_activations_matches_reference(embeddings):
    emb, _ = embeddings
    hidden = emb[:, -1, :]
    want, _ = jint.cluster_activations(hidden, k=3, variant="heap")
    got, _ = tint.cluster_activations(hidden, k=3, variant="heap",
                                      device="cpu")
    np.testing.assert_array_equal(got, want)


def test_expert_affinity_matches_reference(router):
    want, _ = jint.expert_affinity(router, k=3)
    got, res = tint.expert_affinity(router, k=3, device="cpu")
    np.testing.assert_array_equal(got, want)
    direct = tcore.cluster(router.T.copy(), k=3, device="cpu")
    np.testing.assert_array_equal(res.linkage, direct.linkage)


def test_cluster_batch_order_matches_reference(embeddings):
    emb, _ = embeddings
    want = jint.cluster_batch_order(emb)
    got = tint.cluster_batch_order(emb, device="cpu")
    np.testing.assert_array_equal(got, want)
    labels, _ = tint.cluster_sequences(emb, device="cpu")
    assert (np.diff(labels[got]) >= 0).all()


def test_wrappers_are_exported_from_core():
    for name in ("cluster_sequences", "cluster_activations",
                 "expert_affinity", "cluster_batch_order"):
        assert getattr(tcore, name) is getattr(tint, name)


def test_wrappers_need_a_card_by_default(embeddings):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tint.cluster_sequences(embeddings[0], k=3)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA device")
def test_cluster_sequences_on_the_card_is_cluster(embeddings):
    emb = torch.from_numpy(embeddings[0]).cuda()
    got, _ = tint.cluster_sequences(emb, k=3)
    want = tcore.cluster(emb.mean(dim=1), k=3)
    np.testing.assert_array_equal(got, want.labels)
