"""repro_torch — the PyTorch/CUDA port of ``repro`` (TMFG-DBHT clustering).

Mirrors the layout of the JAX package (``core/``, ``approx/``, ``kernels/``,
``data/``); the JAX package is the reference each part is tested
against.  The port imports torch and numpy only, never jax or repro.

Entry points run on CUDA unless the caller passes ``device="cpu"``.  The
hot loops are hand-written CUDA kernels for Hopper (``kernels/csrc/``),
built with nvcc at first use.

Importing the package turns TF32 off for fp32 matrix products and
convolutions: the parity path is full fp32, and TF32 keeps about three
decimal digits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
