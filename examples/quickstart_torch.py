"""Quickstart on the PyTorch/CUDA port: cluster synthetic time series with
TMFG-DBHT (OPT-TDBHT), the twin of ``quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

It runs on the card by default; ``--device cpu`` runs the plain PyTorch
path (a few seconds).
"""

import argparse

import numpy as np

from repro_torch.core import PipelineConfig, adjusted_rand_index, cluster
from repro_torch.data.timeseries import make_dataset

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default=None,
                help="torch device (default: cuda)")
args = ap.parse_args()

# 300 series, 5 latent classes
X, labels = make_dataset(n=300, L=96, k=5, noise=0.7, seed=0)

# one frozen config object carries every stage knob (DESIGN.md §12.1);
# opt() is the paper's OPT-TDBHT: Pearson similarity -> lazy
# (heap-equivalent) TMFG with an up-front top-K candidate table ->
# hub-approximate APSP -> DBHT dendrogram
cfg = PipelineConfig.opt()

# fused by default: every stage back to back on the device and one
# device->host copy of the linkage (DESIGN.md §12.2); timings report the
# total and the loop counts
result = cluster(X, k=5, config=cfg, collect_timings=True,
                 device=args.device)

print(f"clusters found: {len(np.unique(result.labels))}")
print(f"ARI vs ground truth: {adjusted_rand_index(labels, result.labels):.3f}")
print(f"TMFG edge sum: {result.edge_sum:.1f}")
print(f"fused end-to-end: {result.timings['total']:.3f}s")

# the staged path (fused=False) is the timing/debug mode: identical
# labels and linkage, per-stage timings (DESIGN.md §12.4)
staged = cluster(X, k=5, config=cfg, fused=False, collect_timings=True,
                 device=args.device)
assert (staged.labels == result.labels).all()
assert (staged.linkage == result.linkage).all()
print("stage timings:", {k: f"{v:.3f}s" for k, v in staged.timings.items()
                         if k in ("similarity", "tmfg", "apsp", "dbht",
                                  "hac", "total")})

# the dendrogram is a scipy-style linkage matrix: cut it anywhere
for k in (2, 5, 10):
    print(f"k={k:2d}: sizes =",
          np.bincount(result.labels_at(k)).tolist())
