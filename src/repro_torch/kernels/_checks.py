"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def require_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
                 ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and rank."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device for the kernel, "
                         f"got {t.device} (use backend='torch' or 'auto' "
                         f"for the plain version)")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_int32_range(**sizes: int) -> None:
    """The C entry points take their sizes and flat offsets as int."""
    for name, v in sizes.items():
        if not 0 < v < 2 ** 31:
            raise ValueError(f"{name}={v} is outside the kernel's int range")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
