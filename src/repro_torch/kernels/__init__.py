"""Hand-written CUDA kernels of the port, with plain PyTorch twins.

  * pearson.py   -- fused Pearson correlation (csrc/pearson.cu)
  * minplus.py   -- tropical matmul for APSP (csrc/minplus.cu)
  * gainscan.py  -- masked row argmax, the HAC merge scan
                    (csrc/masked_argmax.cu)
  * topk.py      -- streaming top-K Pearson (csrc/topk.cu)
  * sparse_apsp.py -- CSR graph and one multi-source relaxation round
                    (csrc/sparse_relax.cu)
  * flash_attention.py -- causal / sliding-window GQA prefill attention:
                    bf16 on the tensor cores (csrc/flash_attention_wgmma.cu),
                    fp32 on the CUDA cores (csrc/flash_attention.cu), and
                    its backward: bf16 by wgmma
                    (csrc/flash_attention_bwd_wgmma*.cu), fp32 by split
                    TF32 mma.sync (csrc/flash_attention_bwd_tf32x3.cu)

Each kernel is built from ``csrc/`` with nvcc at first use
(``_build.py``) and has a plain version in ``ref.py``; ``ops.py``
dispatches between them.
"""

from . import ops, ref  # noqa: F401
