"""Farthest point sampling (counterpart of toothgroupnetwork_tpu/ops/fps.py).

Every call goes through K1 (``kernels/fps.py``): the kernel on a CUDA
tensor, its plain twin on a CPU tensor. Inside the point-sharded context
(``parallel/points.py``) it samples the whole cloud, all-gathered once
(``parallel/sharded_ops.py:gather_axis``), as GSPMD runs the dense step's
kernel on the gathered cloud.
"""

from __future__ import annotations

import torch

from ..parallel import points
from .kernels.fps import fps as fps_kernel


def farthest_point_sample(xyz: torch.Tensor, n_samples: int,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """xyz ``[N, 3]`` or ``[B, N, 3]``, optional bool mask ``[N]`` / ``[B, N]``
    -> int32 ``[n_samples]`` / ``[B, n_samples]``. Seeds at the first valid
    point; invalid points are never picked; once the valid points are
    exhausted the indices repeat valid points. Inside the point-sharded
    context ``xyz`` is this rank's rows of the cloud and the result this
    rank's rows of the global sample (global indices)."""
    mesh = points.active()
    if mesh is not None:
        from ..parallel.sharded_ops import gather_axis

        if xyz.dim() != 3:
            points.unsupported("farthest_point_sample of one unbatched cloud")
        n = points.global_size(xyz.shape[1])
        points.register(n_samples)
        xyz = gather_axis(xyz, mesh, n)
        mask = None if mask is None else gather_axis(mask, mesh, n)
        lo, hi = points.rows(n_samples, mesh)
        return _fps(xyz, n_samples, mask)[:, lo:hi].contiguous()
    if xyz.dim() == 2:
        return farthest_point_sample(
            xyz[None], n_samples, None if mask is None else mask[None])[0]
    return _fps(xyz, n_samples, mask)


def _fps(xyz: torch.Tensor, n_samples: int, mask: torch.Tensor | None) -> torch.Tensor:
    valid = None if mask is None else mask.to(torch.bool).contiguous()
    return fps_kernel(xyz.to(torch.float32).contiguous(), n_samples, valid)


def fps(xyz: torch.Tensor, n_samples: int,
        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Alias of :func:`farthest_point_sample` (the JAX package's name)."""
    return farthest_point_sample(xyz, n_samples, mask)
