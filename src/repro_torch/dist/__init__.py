"""Distribution layer of the port (DESIGN.md §4.4, §7): ``repro.dist``
over ``torch.distributed``.

* :mod:`repro_torch.dist.sharding` -- mesh-aware placement as ``DTensor``
  placements on a ``DeviceMesh``: the layouts of the paper's arrays,
  ``data_mesh`` (a group of world size 1 when the caller has none), the
  sharded Pearson, top-K, masked-argmax and min-plus entry points, and
  the LM zoo's parameter and batch placement (``param_specs``,
  ``param_shardings``, ``batch_specs``, ``batch_shardings``).

* :mod:`repro_torch.dist.compression` -- int8 error-feedback gradient
  compression (the train step's ``compress_grads``) and
  ``psum_compressed``.

* :mod:`repro_torch.dist.hints` -- dynamically scoped logical-axis
  annotations: the launcher pins layouts (``kv_cache``, ``logits``,
  ``activations``, ``moe_expert``) and algorithm variants
  (``onehot_embed``) without threading them through every model
  signature.
"""

from . import compression, hints, sharding  # noqa: F401

__all__ = ["compression", "hints", "sharding"]
