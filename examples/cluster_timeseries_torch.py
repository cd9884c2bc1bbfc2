"""Compare every TMFG-DBHT variant on a UCR-like dataset (paper fig. 2/6),
then replay the same data as a *stream* through the rolling-window
service, on the PyTorch/CUDA port: the twin of ``cluster_timeseries.py``.

    PYTHONPATH=src python examples/cluster_timeseries_torch.py [dataset] [scale] [--device cpu]

It runs on the card by default; ``--device cpu`` runs the plain PyTorch
path.  The edge sums and ARIs are printed to more digits than the JAX
example's, so that the two can be held against each other.
"""

import argparse
import time

from repro_torch.core import VARIANTS, adjusted_rand_index, cluster
from repro_torch.data.timeseries import make_ucr_like
from repro_torch.stream import ClusterService

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("dataset", nargs="?", default="CBF")
ap.add_argument("scale", nargs="?", type=float, default=1.0)
ap.add_argument("--device", default=None,
                help="torch device (default: cuda)")
args = ap.parse_args()

ds_name, X, labels, k = make_ucr_like(args.dataset, scale=args.scale)
print(f"dataset {ds_name}: n={X.shape[0]} L={X.shape[1]} classes={k}\n")

print(f"{'variant':10s} {'time':>8s} {'ARI':>9s} {'edge sum':>14s}")
for variant in VARIANTS:
    t0 = time.time()
    res = cluster(X, k=k, variant=variant, device=args.device)
    print(f"{variant:10s} {time.time() - t0:7.2f}s "
          f"{adjusted_rand_index(labels, res.labels):9.6f} "
          f"{res.edge_sum:14.6f}")

# --- streaming replay: ticks arrive one (n,) observation at a time --------
n, L = X.shape
window = max(16, (2 * L) // 3)
svc = ClusterService(n=n, window=window, k=k, variant="opt",
                     recluster_every=max(1, L // 8), device=args.device)
t0 = time.time()
for t in range(L):                       # each column of X is one tick
    if svc.tick(X[:, t]) is not None:
        svc.drain()                      # micro-batched recluster
dt = time.time() - t0
res = svc.latest if svc.latest is not None else svc.recluster()
print(f"\nstream: {L} ticks in {dt:.2f}s "
      f"({L / max(dt, 1e-9):.0f} ticks/s, window={window}, "
      f"{svc.batcher.batches_run} batched reclusters, "
      f"{svc.cache.hits} cache hits) final ARI "
      f"{adjusted_rand_index(labels, res.labels):.3f}")
