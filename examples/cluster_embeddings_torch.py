"""The paper's technique as an LM feature on the PyTorch/CUDA port, the
twin of ``cluster_embeddings.py``: cluster sequence embeddings for
cluster-coherent batching, cluster MoE experts by router co-activation,
and take the corpus-scale case through the approx path (DESIGN.md §13).

    PYTHONPATH=src python examples/cluster_embeddings_torch.py \\
        [--device cpu] [--n 2000] [--mesh]

The embeddings are those of a reduced granite-3-8b of the port
(``repro_torch.models``, 2 layers) with weights drawn from a seeded
``torch.Generator``.  It runs on the card by default; ``--device cpu``
runs the plain PyTorch path (the large-n part takes about a minute
there; ``--n 500`` is quicker).  ``--mesh`` sends the large-n approx
run through the multi-device funnel on a world-1 group
(``dist.sharding.data_mesh``).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.approx.quality import edge_recall
from repro_torch.configs import get_config
from repro_torch.core import PipelineConfig, adjusted_rand_index, cluster
from repro_torch.core import integration as I
from repro_torch.data.timeseries import make_dataset
from repro_torch.models.registry import build_model

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="torch device (default: cuda)")
ap.add_argument("--n", type=int, default=2000,
                help="series in the corpus-scale part (default 2000)")
ap.add_argument("--mesh", action="store_true",
                help="run the large-n approx call through the funnel")
args = ap.parse_args()
dev = torch.device("cuda" if args.device is None else args.device)

# 1. embed a batch of sequences with a (reduced) zoo model
cfg = get_config("granite-3-8b").reduced(n_layers=2)
model = build_model(cfg, device=dev)
params = model.init(torch.Generator(device=dev).manual_seed(0))

rng = np.random.default_rng(0)
# three synthetic "domains" of token sequences
domain = rng.integers(0, 3, 60)
base = rng.integers(0, cfg.vocab // 3, (3, 24))
tokens = torch.as_tensor(
    (base[domain] + rng.integers(0, cfg.vocab // 8, (60, 24))) % cfg.vocab,
    device=dev)

emb = params["embed"][tokens]           # (60, 24, d) token embeddings
labels, res = I.cluster_sequences(emb, k=3, device=dev)
print(f"sequence clustering ARI vs true domains: "
      f"{adjusted_rand_index(domain, labels):.3f}")

order = I.cluster_batch_order(emb, device=dev)
print("cluster-coherent batch order (first 20):", order[:20].tolist())

# 2. expert affinity from router statistics (MoE analysis)
router_probs = rng.dirichlet(np.ones(8), size=512)
elabels, _ = I.expert_affinity(router_probs, k=3, device=dev)
print("expert affinity clusters:", elabels.tolist())

# 3. corpus scale: n embedding series through the approx pipeline
# (DESIGN.md §13): the (n, n) Pearson matrix is never materialized; the
# TMFG runs off an (n, 64) candidate table, and the approximation is
# scored against the dense path (edge recall, ARI agreement)
n, sim_k = args.n, 64
Xbig, _ = make_dataset(n, 96, 6, noise=0.6, seed=0)
mesh = None
if args.mesh:
    from repro_torch.dist.sharding import data_mesh
    mesh = data_mesh(device=dev)

t0 = time.time()
approx = cluster(Xbig, k=6, config=PipelineConfig.approx(sim_k=sim_k),
                 collect_timings=True, device=dev, mesh=mesh)
t_approx = time.time() - t0
t0 = time.time()
dense = cluster(Xbig, k=6, config=PipelineConfig.opt(), fused=False,
                device=dev)
t_dense = time.time() - t0

print(f"\nlarge-n approx demo (n={n}, sim_k={sim_k}"
      f"{', through the funnel' if mesh is not None else ''}):")
print(f"  approx {t_approx:.1f}s vs dense {t_dense:.1f}s "
      f"(similarity memory {n * n * 4 // 1024}KB dense -> "
      f"{n * sim_k * 8 // 1024}KB table)")
print(f"  TMFG edge recall vs dense: "
      f"{edge_recall(approx.tmfg.edges, dense.tmfg.edges):.3f}")
print(f"  ARI agreement with the dense labels: "
      f"{adjusted_rand_index(dense.labels, approx.labels):.3f}")
print(f"  dense-row fallback rate: "
      f"{approx.timings['sim_fallback_rate']:.3f}")
if mesh is not None:
    import torch.distributed as dist
    dist.destroy_process_group()
