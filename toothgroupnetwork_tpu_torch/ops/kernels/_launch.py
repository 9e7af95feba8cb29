"""Input checks, launch counts and stream hand-off shared by the kernel
wrappers."""

from __future__ import annotations

import threading

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


# one lock for every wrapper's counts: scans served from several threads
# (``TgnInferencePipeline.run_many``) launch the same kernels at once, and an
# unguarded ``+= 1`` may lose a count
_COUNT_LOCK = threading.Lock()


def count_launch(fn, shape=None) -> None:
    """Add one to ``fn.launches`` and, with ``shape``, to
    ``fn.launches_by_shape[shape]``, under one lock."""
    with _COUNT_LOCK:
        fn.launches += 1
        if shape is not None:
            fn.launches_by_shape[shape] = fn.launches_by_shape.get(shape, 0) + 1


def settle(made) -> None:
    """Wait until the current stream has finished making ``made`` (a tensor,
    or a dict of them; anything else is ignored) where it lies on a CUDA
    device, so that a kernel on any other stream may read it: state shared
    by the scans of several streams (folded parameters, kernel layouts) is
    published only once it is complete on the card."""
    tensors = made.values() if isinstance(made, dict) else (made,)
    devices = {t.device for t in tensors
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


def on_cpu(t: torch.Tensor) -> bool:
    """True for CPU tensors (plain twin); False for CUDA (kernel); raises else."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")
