"""Row gathers (counterpart of toothgroupnetwork_tpu/ops/gather.py)."""

from __future__ import annotations

import os

import torch

from ..parallel import points as point_shards
from .kernels.gather import onehot_gather


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points[..., idx, :]``: points ``[B, N, C]`` (or ``[N, C]``), integer
    idx ``[B, ...]`` (or ``[...]``) into the N axis -> ``idx.shape + (C,)``.
    Inside the point-sharded context ``points`` is this rank's rows of a
    cloud, ``idx`` global indices, and the rows come over the ring
    (``parallel/sharded_ops.py:ring_gather``, with its gradient)."""
    mesh = point_shards.active()
    if mesh is not None:
        from ..parallel.sharded_ops import ring_gather

        if points.dim() != 3:
            point_shards.unsupported("index_points on an unbatched cloud")
        return ring_gather(points, idx, mesh, point_shards.global_size(points.shape[1]))
    c = points.shape[-1]
    if points.dim() == 2:
        return points[idx.reshape(-1).long()].reshape(idx.shape + (c,))
    b, n = points.shape[0], points.shape[1]
    offs = (torch.arange(b, device=idx.device) * n).reshape(
        (b,) + (1,) * (idx.dim() - 1))
    flat = (idx.long() + offs).reshape(-1)
    return points.reshape(b * n, c)[flat].reshape(idx.shape + (c,))


def gather_neighbors(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbourhood gather ``[B, N, C]`` + ``[B, M, K]`` -> ``[B, M, K, C]``.

    The JAX package's switch, under the same name: ``TGN_TPU_GATHER=mxu``
    takes the row-gather kernel K8 (``kernels/gather.py:onehot_gather``;
    on CPU tensors its plain twin), and ``auto``, the default, takes
    :func:`index_points`. Both give the same values; no model layer calls
    this function, in either package."""
    if os.environ.get("TGN_TPU_GATHER", "auto") == "mxu":
        return onehot_gather(points, idx)
    return index_points(points, idx)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Neighbourhood gather ``[B, N, C]`` + ``[B, S, K]`` -> ``[B, S, K, C]``
    (the pointops grouping contract)."""
    return index_points(points, idx)
