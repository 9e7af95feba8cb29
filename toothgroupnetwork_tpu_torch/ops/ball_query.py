"""Radius ball query (counterpart of toothgroupnetwork_tpu/ops/ball_query.py).

The JAX package runs it in XLA, outside any Pallas kernel, so it is plain
torch here. For each query it takes the ``k`` *lowest-index* points whose
squared distance is within ``radius^2`` (not the nearest), fills the
missing slots with the first in-ball point, and falls back to the nearest
point when the ball is empty. Masked points carry a 1e10 bias, so they are
never in a ball; a fully masked cloud falls back to index 0.

Inside the point-sharded context (``parallel/points.py``) the queries are
this rank's rows of the centres and the candidates the whole cloud: its
coordinates and mask are all-gathered once (13 bytes a point,
``parallel/sharded_ops.py:gather_axis``), and the dense body runs this
rank's queries against them, so the indices are global and the three
rules above hold over the whole cloud.

The lowest indices come from a prefix count: ``cnt = cumsum(in_ball)`` is
non-decreasing along a row, so the j-th in-ball point is the first position
where ``cnt`` reaches j (``searchsorted``). No row of ``[S, N]`` is sorted.
"""

from __future__ import annotations

import torch

from ..parallel import points as point_shards
from .distance import square_distance

_BIG = 1e10


def ball_query(radius: float, k: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
               p_mask: torch.Tensor | None = None, *, chunk: int = 1024
               ) -> torch.Tensor:
    """xyz ``[N, 3]``/``[B, N, 3]`` points, new_xyz ``[S, 3]``/``[B, S, 3]``
    centres, optional bool ``p_mask`` over xyz -> int32 ``[..., S, k]``
    indices into the N axis. Inside the point-sharded context ``xyz`` and
    ``p_mask`` are this rank's rows of the cloud, ``new_xyz`` its rows of
    the centres, and the indices global."""
    mesh = point_shards.active()
    if mesh is not None:
        from ..parallel.sharded_ops import gather_axis

        if xyz.dim() != 3:
            point_shards.unsupported("ball_query on an unbatched cloud")
        n = point_shards.global_size(xyz.shape[1])
        xyz = gather_axis(xyz, mesh, n)
        p_mask = None if p_mask is None else gather_axis(p_mask, mesh, n)
    elif xyz.dim() == 2:
        return ball_query(radius, k, xyz[None], new_xyz[None],
                          None if p_mask is None else p_mask[None], chunk=chunk)[0]
    b, n, _ = xyz.shape
    s = new_xyz.shape[1]
    xyz = xyz.to(torch.float32)
    new_xyz = new_xyz.to(torch.float32)
    bias = torch.zeros((b, n), dtype=torch.float32, device=xyz.device)
    if p_mask is not None:
        bias = torch.where(p_mask.to(torch.bool), 0.0, _BIG).to(torch.float32)
    r2 = torch.tensor(radius, dtype=torch.float32, device=xyz.device) ** 2
    keff = min(k, n)
    want = torch.arange(1, keff + 1, dtype=torch.int32, device=xyz.device)
    out = []
    for c0 in range(0, s, chunk):
        qc = new_xyz[:, c0:c0 + chunk]
        d2 = square_distance(qc, xyz) + bias[:, None, :]           # [B, c, N]
        in_ball = d2 <= r2
        cnt = torch.cumsum(in_ball, dim=-1, dtype=torch.int32)
        # position of the j-th in-ball point (n where there are fewer)
        idx = torch.searchsorted(cnt, want.expand(cnt.shape[:-1] + (keff,))
                                 .contiguous())
        found = idx < n
        idx = torch.where(found, idx, idx[..., :1])
        if keff < k:
            idx = torch.cat([idx, idx[..., :1].expand(idx.shape[:-1] + (k - keff,))],
                            dim=-1)
        nearest = torch.argmin(d2, dim=-1, keepdim=True)
        out.append(torch.where(found[..., :1], idx, nearest).to(torch.int32))
    return torch.cat(out, dim=1)
