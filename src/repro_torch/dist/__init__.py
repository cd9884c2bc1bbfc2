"""Distribution layer of the port (DESIGN.md §4.4): the clustering half
of ``repro.dist`` over ``torch.distributed``.

* :mod:`repro_torch.dist.sharding` -- the layouts of the paper's arrays
  as ``DTensor`` placements on a ``DeviceMesh``, ``data_mesh`` (a group
  of world size 1 when the caller has none), and the sharded Pearson,
  top-K, masked-argmax and min-plus entry points.

* :mod:`repro_torch.dist.compression` -- int8 error-feedback gradient
  compression, the value half (the train step's ``compress_grads``).

The LM half of the sharding rules (parameter and batch placement over
DTensor), ``psum_compressed`` and the layout hints are not ported yet:
ROADMAP Queue 1 item 15.6b.
"""

from . import compression, sharding  # noqa: F401

__all__ = ["compression", "sharding"]
