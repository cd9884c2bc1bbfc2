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

* :mod:`repro_torch.dist.tensor_parallel` -- the dense, MoE and VLM
  models' work split over a mesh's ``model`` ranks: each stored leaf's
  compute block (gathered over the data ranks a layer at a time), the
  products' collectives and the vocabulary-parallel lookup and cross
  entropy.
"""

from . import compression, hints, sharding, tensor_parallel  # noqa: F401

__all__ = ["compression", "hints", "sharding", "tensor_parallel"]
