"""K4 / K5 — per-query selection from candidate blocks (csrc/cell_select.cu)
and their plain twins.

Replaces toothgroupnetwork_tpu/ops/pallas/cell_select_kernel.py:
``cell_select_x`` (``_x_kernel``, K4) and ``cell_select_p`` (``_p_kernel``,
K5). The TPU kernels select with a one-hot MXU contraction; on Hopper both
are indexed copies (csrc/cell_select.cu states the bound and the design),
bit-equal to the twins below. The candidate blocks come from
``ops/cells.py:gather_candidate_blocks``.
"""

from __future__ import annotations

import torch

from . import build
from ._launch import MODEL_DTYPES, count_launch, on_cpu, require, stream_of

CELL = 8


def _check(blk: torch.Tensor, pos: torch.Tensor, dtypes, width: int | None) -> None:
    dev = blk.device
    require(blk, "blk", dtypes, 3, dev)
    require(pos, "pos", torch.int32, 2, dev)
    if pos.shape[0] != blk.shape[0] * CELL or (width and blk.shape[2] != width):
        raise ValueError(f"cell_select: blk {tuple(blk.shape)} pos "
                         f"{tuple(pos.shape)}")


def cell_select_x(blk_x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """K4: ``blk_x [G, L8, C]`` (float32 or bfloat16) + ``pos [N, K]`` int32
    (N = 8 G) -> ``x_g [N, K, C]`` in blk_x's dtype,
    ``x_g[q, k] = blk_x[q // 8, pos[q, k]]``. CPU tensors take
    :func:`cell_select_x_reference`."""
    if on_cpu(blk_x):
        return cell_select_x_reference(blk_x, pos)
    _check(blk_x, pos, MODEL_DTYPES, None)
    dev = blk_x.device
    _, l8, c = blk_x.shape
    n, kk = pos.shape
    with torch.cuda.device(dev):
        lib = build.library()
        out = torch.empty((n, kk, c), dtype=blk_x.dtype, device=dev)
        status = lib.tgn_cell_select_x(blk_x.data_ptr(), pos.data_ptr(), n, kk,
                                       l8, c * blk_x.element_size(), out.data_ptr(),
                                       stream_of(dev))
        build.check(status, "tgn_cell_select_x")
    count_launch(cell_select_x)
    return out


cell_select_x.launches = 0


def cell_select_p(blk_p: torch.Tensor, pos: torch.Tensor,
                  p_q: torch.Tensor) -> torch.Tensor:
    """K5: ``blk_p [G, L8, 3]`` f32 + ``pos [N, K]`` int32 + ``p_q [N, 3]``
    f32 -> ``p_r [N, K, 3]`` f32, ``blk_p[q // 8, pos[q, k]] - p_q[q]``.
    CPU tensors take :func:`cell_select_p_reference`."""
    if on_cpu(blk_p):
        return cell_select_p_reference(blk_p, pos, p_q)
    _check(blk_p, pos, torch.float32, 3)
    dev = blk_p.device
    require(p_q, "p_q", torch.float32, 2, dev)
    n, kk = pos.shape
    if tuple(p_q.shape) != (n, 3):
        raise ValueError(f"cell_select_p: p_q {tuple(p_q.shape)}, pos {(n, kk)}")
    with torch.cuda.device(dev):
        lib = build.library()
        out = torch.empty((n, kk, 3), dtype=torch.float32, device=dev)
        status = lib.tgn_cell_select_p(blk_p.data_ptr(), pos.data_ptr(),
                                       p_q.data_ptr(), n, kk, blk_p.shape[1],
                                       out.data_ptr(), stream_of(dev))
        build.check(status, "tgn_cell_select_p")
    count_launch(cell_select_p)
    return out


cell_select_p.launches = 0


def _select(blk: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``blk[q // 8, pos[q, k]]``, zeros where pos is outside ``[0, L8)``
    (the one-hot row of the TPU kernel has no hit there)."""
    g, l8, c = blk.shape
    n, kk = pos.shape
    hit = (pos >= 0) & (pos < l8)
    rows = (torch.arange(n, device=pos.device) // CELL)[:, None] * l8 \
        + torch.where(hit, pos, 0).long()
    sel = blk.reshape(g * l8, c)[rows.reshape(-1)].reshape(n, kk, c)
    return torch.where(hit[..., None], sel, torch.zeros((), dtype=blk.dtype,
                                                        device=blk.device))


def cell_select_x_reference(blk_x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Plain twin of K4."""
    return _select(blk_x, pos)


def cell_select_p_reference(blk_p: torch.Tensor, pos: torch.Tensor,
                            p_q: torch.Tensor) -> torch.Tensor:
    """Plain twin of K5 (f32)."""
    return _select(blk_p.to(torch.float32), pos) - p_q.to(torch.float32)[:, None, :]
