"""Distribution layer of the port (DESIGN.md §4.4): the clustering half
of ``repro.dist`` over ``torch.distributed``.

* :mod:`repro_torch.dist.sharding` -- the layouts of the paper's arrays
  as ``DTensor`` placements on a ``DeviceMesh``, ``data_mesh`` (a group
  of world size 1 when the caller has none), and the sharded Pearson,
  top-K, masked-argmax and min-plus entry points.

The LM half (parameter and batch placement, gradient compression,
layout hints) is not ported yet: ROADMAP Queue 1 item 15.
"""

from . import sharding  # noqa: F401

__all__ = ["sharding"]
