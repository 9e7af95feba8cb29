"""Input checks shared by the kernel wrappers."""

from __future__ import annotations

import torch

# the element types of the model's features: the serving configuration
# computes in bfloat16, the default one in float32
MODEL_DTYPES = (torch.float32, torch.bfloat16)


def require(t: torch.Tensor, name: str, dtype, dim: int,
            device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor of rank ``dim`` on
    ``device`` whose dtype is ``dtype`` (one dtype or a tuple of the dtypes
    the kernel takes) — the C entry points take raw pointers and dense
    strides, and a tensor of another dtype is never converted."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
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
