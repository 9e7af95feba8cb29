"""Input checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def require(t: torch.Tensor, name: str, dtype: torch.dtype, dim: int,
            device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of rank ``dim`` on
    ``device`` — the C entry points take raw pointers and dense strides."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected rank {dim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def on_cpu(t: torch.Tensor) -> bool:
    """True for CPU tensors (plain twin); False for CUDA (kernel); raises else."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")
