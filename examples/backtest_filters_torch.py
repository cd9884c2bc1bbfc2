"""Rolling backtest across the filter matrix (DESIGN.md §18.5), on the
PyTorch/CUDA port: the twin of ``backtest_filters.py`` driving
``repro_torch.stream.ClusterService``.

Daily-returns-style data with a REGIME SWITCH halfway through: the
first half of the ticks follows one cluster assignment, the second
half another.  Each filter front-end (TMFG / MST / AG — plus a
TMFG+RMT track on the raw window, since ``clean="rmt"`` needs the
(n, T) series) replays the same ticks through the rolling-window
service and is scored per recluster on

  * accuracy — ARI against the regime truth active at that tick;
  * stability — ARI against the SAME filter's previous labels.

    PYTHONPATH=src python examples/backtest_filters_torch.py [n] [ticks] \\
        [--device cpu]

It runs on the card by default; ``--device cpu`` runs the plain PyTorch
path (a few seconds at the default size).
"""

import argparse

import numpy as np

from repro_torch.core import PipelineConfig, adjusted_rand_index, cluster
from repro_torch.data.timeseries import make_dataset
from repro_torch.stream import ClusterService

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("n", type=int, nargs="?", default=48)
ap.add_argument("ticks", type=int, nargs="?", default=160)
ap.add_argument("--device", default=None,
                help="torch device (default: cuda)")
args = ap.parse_args()
n, ticks = args.n, args.ticks
k, window, cadence = 3, 48, 16

# regime A for the first half of the ticks, regime B for the second
XA, lab_A = make_dataset(n, ticks // 2, k, noise=0.7, seed=7)
XB, lab_B = make_dataset(n, ticks - ticks // 2, k, noise=0.7, seed=8)
X = np.concatenate([XA, XB], axis=1)


def truth(t):
    return lab_A if t < ticks // 2 else lab_B


CONFIGS = {
    "tmfg": PipelineConfig.opt(),
    "mst": PipelineConfig.mst(),
    "ag": PipelineConfig(filter="ag"),
}

print(f"regime backtest: n={n} ticks={ticks} window={window} "
      f"cadence={cadence} (switch at t={ticks // 2})\n")
print(f"{'filter':10s} {'reclusters':>10s} {'ARI(truth)':>11s} "
      f"{'stability':>10s}")

for name, cfg in CONFIGS.items():
    svc = ClusterService(n=n, window=window, k=k, config=cfg,
                         recluster_every=cadence, device=args.device)
    prev, acc, stab = None, [], []
    for t in range(ticks):
        if svc.tick(X[:, t]) is not None:
            svc.drain()
            res = svc.latest
            acc.append(adjusted_rand_index(truth(t), res.labels))
            if prev is not None:
                stab.append(adjusted_rand_index(prev, res.labels))
            prev = res.labels
    print(f"{name:10s} {len(acc):10d} {np.mean(acc):11.3f} "
          f"{np.mean(stab):10.3f}")

# the clean= axis: RMT clipping needs the raw (n, T) window, so this
# track reclusters straight from the series at the same cadence
cfg = PipelineConfig.opt(clean="rmt")
prev, acc, stab = None, [], []
for t in range(window, ticks, cadence):
    res = cluster(X[:, t - window:t], k=k, config=cfg, device=args.device)
    acc.append(adjusted_rand_index(truth(t), res.labels))
    if prev is not None:
        stab.append(adjusted_rand_index(prev, res.labels))
    prev = res.labels
print(f"{'tmfg+rmt':10s} {len(acc):10d} {np.mean(acc):11.3f} "
      f"{np.mean(stab):10.3f}")
