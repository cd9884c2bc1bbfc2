"""TMFG-DBHT as a feature of the LM framework: the port of
``repro.core.integration``.

The paper's technique consumes any similarity matrix, so it attaches to
every architecture of the zoo the same way:

  * :func:`cluster_sequences` -- cluster sequences by the Pearson
    correlation of their mean-pooled embeddings (cluster-coherent
    batching, per-cluster curriculum sampling);
  * :func:`cluster_activations` -- cluster a batch by a layer's hidden
    states (analysis, probing);
  * :func:`expert_affinity` -- cluster MoE experts by router
    co-activation: the Pearson correlation of two experts' routing
    probabilities across tokens;
  * :func:`cluster_batch_order` -- the permutation that puts
    same-cluster sequences next to each other.

Each is a thin wrapper over :func:`repro_torch.core.cluster`, on the card
unless ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .pipeline import cluster


def _pool(emb: torch.Tensor) -> torch.Tensor:
    """Mean-pool (batch, seq, d) token embeddings to (batch, d)."""
    if emb.ndim == 3:
        return emb.mean(dim=1)
    return emb


def _f32(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.float()
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def cluster_sequences(embeddings, *, k=None, variant: str = "opt",
                      device=None):
    """Cluster sequences by embedding correlation.  Returns (labels,
    result).

    ``embeddings``: (batch, d) pooled, or (batch, seq, d), mean-pooled in
    float32 on the tensor's own device."""
    res = cluster(_pool(_f32(embeddings)), k=k, variant=variant,
                  device=device)
    return res.labels, res


def cluster_activations(hidden, *, k=None, variant: str = "opt",
                        device=None):
    """Cluster a batch by a layer's hidden states (analysis tool)."""
    return cluster_sequences(hidden, k=k, variant=variant, device=device)


def expert_affinity(router_probs, *, k=None, variant: str = "opt",
                    device=None):
    """Cluster experts by co-activation.

    ``router_probs``: (tokens, n_experts) routing probabilities.  The
    similarity of two experts is the Pearson correlation of their routing
    probability across tokens."""
    res = cluster(_f32(router_probs).T, k=k, variant=variant, device=device)
    return res.labels, res


def cluster_batch_order(embeddings, *, variant: str = "opt",
                        device=None) -> np.ndarray:
    """Permutation putting same-cluster sequences adjacent (for
    batching)."""
    labels, _ = cluster_sequences(embeddings, variant=variant, device=device)
    return np.argsort(labels, kind="stable")
