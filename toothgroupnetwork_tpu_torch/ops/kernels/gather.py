"""K8 — row gather into the lane-packed layout (csrc/gather.cu) and its
plain twin.

Replaces toothgroupnetwork_tpu/ops/pallas/gather_kernel.py:
``onehot_gather_packed`` (``_gather_kernel``) and ``onehot_gather``, its
``[B, M, K, C]`` view. The TPU kernel selects rows with one-hot MXU
products; on Hopper K8 is an indexed copy with the same output contract,
bit-equal to ``index_points`` in float32 and in bfloat16 (the JAX kernel's
pinned contract). As in the JAX package only
``ops/gather.py:gather_neighbors`` with ``TGN_TPU_GATHER=mxu`` reaches it.
"""

from __future__ import annotations

import torch

from . import build
from ._launch import MODEL_DTYPES, count_launch, on_cpu, require, stream_of


def onehot_gather_packed(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K8: ``x [B, N, C]`` (float32 or bfloat16), ``idx [B, M, K]`` int32
    with values in ``[0, N)`` (not checked, as in the JAX contract) ->
    ``[B, M, K*C]`` in x's dtype, ``out[b, m, k*C:(k+1)*C] = x[b, idx[b, m,
    k]]``. CPU tensors take :func:`onehot_gather_packed_reference`."""
    if on_cpu(x):
        return onehot_gather_packed_reference(x, idx)
    dev = x.device
    require(x, "x", MODEL_DTYPES, 3, dev)
    require(idx, "idx", torch.int32, 3, dev)
    b, n, c = x.shape
    _, m, kk = idx.shape
    if idx.shape[0] != b:
        raise ValueError(f"gather: x {tuple(x.shape)} idx {tuple(idx.shape)}")
    with torch.cuda.device(dev):
        lib = build.library()
        out = torch.empty((b, m, kk * c), dtype=x.dtype, device=dev)
        status = lib.tgn_gather_rows(x.data_ptr(), idx.data_ptr(), b, n, m * kk,
                                     c * x.element_size(), out.data_ptr(),
                                     stream_of(dev))
        build.check(status, "tgn_gather_rows")
    count_launch(onehot_gather_packed)
    return out


onehot_gather_packed.launches = 0


def onehot_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``index_points``-shaped entry: ``[B, N, C]``, ``[B, M, K]`` ->
    ``[B, M, K, C]``, the same buffer as :func:`onehot_gather_packed`."""
    b, _, c = x.shape
    _, m, kk = idx.shape
    return onehot_gather_packed(x, idx).reshape(b, m, kk, c)


def onehot_gather_packed_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain twin of K8: ``index_points`` reshaped to the packed layout."""
    from ..gather import index_points

    b, _, c = x.shape
    _, m, kk = idx.shape
    return index_points(x, idx).reshape(b, m, kk * c)
