"""Cell-candidate machinery for super-row neighbourhood gathers (counterpart
of toothgroupnetwork_tpu/ops/cells.py).

A spatially sorted cloud is grouped into cells of 8 consecutive points. Each
query cell's deduplicated neighbour cells are gathered once as contiguous
8-row "super-rows" (``gather_candidate_blocks``), and every query then picks
its neighbours out of that dense candidate block by position (K4/K5,
``kernels/cell_select.py``). This module is the prep around those kernels,
built once per backbone stage like the kNN itself:

  * :func:`spatial_sort_perm` — host 2-level spatial sort (numpy),
  * :func:`build_cell_candidates` — each query cell's candidate cells in
    ``L`` slots and each neighbour's position in the candidate block, with
    the dump value ``L*8`` for neighbours whose cell overflowed the slots,
  * :func:`pos_with_self_fallback` — dump positions re-pointed at the self
    slot,
  * :func:`gather_candidate_blocks` — the super-row take.

Integer results are identical to the JAX package's: the scatter-max is an
integer ``scatter_reduce("amax")``, which is order-independent.
"""

from __future__ import annotations

import numpy as np
import torch

CELL = 8  # points per cell


def spatial_sort_perm(xyz: np.ndarray, slab: int = 1500) -> np.ndarray:
    """Equal-count slabs along the widest axis, then a sort by the
    second-widest axis within each slab (both stable). Returns the
    permutation (int64 ``[N]``)."""
    xyz = np.asarray(xyz)
    n = xyz.shape[0]
    var = xyz.var(axis=0)
    ax1 = int(np.argmax(var))
    var2 = var.copy()
    var2[ax1] = -1
    ax2 = int(np.argmax(var2))
    o1 = np.argsort(xyz[:, ax1], kind="stable")
    out = []
    for i in range(0, n, slab):
        seg = o1[i:i + slab]
        out.append(seg[np.argsort(xyz[seg, ax2], kind="stable")])
    return np.concatenate(out)


def build_cell_candidates(knn_idx: torch.Tensor, n_slots: int):
    """Per-query-cell candidate cells + per-neighbour positions.

    knn_idx ``[N, K]`` int32 neighbour indices into the same sorted cloud,
    ``N`` divisible by 8; ``n_slots`` is L. Returns ``cand [G, L]`` int32
    (G = N/8, ascending, empty slots padded with the row maximum),
    ``pos [N, K]`` int32 (``l*8 + idx%8``, or ``L*8`` when the neighbour's
    cell overflowed the L slots) and ``n_cells [G]`` int32 (distinct
    candidate cells per query cell)."""
    n, k = knn_idx.shape
    g = n // CELL
    l_slots = n_slots
    dev = knn_idx.device
    idx = knn_idx.to(torch.int32)

    cid = (idx // CELL).reshape(g, CELL * k)
    s = torch.sort(cid, dim=-1).values
    first = torch.cat([torch.ones((g, 1), dtype=torch.bool, device=dev),
                       s[:, 1:] != s[:, :-1]], dim=-1)
    rank = (torch.cumsum(first.to(torch.int32), dim=-1) - 1).to(torch.int32)
    n_cells = rank[:, -1] + 1

    # first occurrences go to their rank slot, overflow to the dump slot L
    target = torch.where(first & (rank < l_slots), rank, l_slots)
    flat_t = (torch.arange(g, dtype=torch.int64, device=dev)[:, None]
              * (l_slots + 1) + target).reshape(-1)
    cand_flat = torch.zeros(g * (l_slots + 1), dtype=torch.int32, device=dev)
    cand_flat = cand_flat.scatter_reduce(0, flat_t, s.reshape(-1), "amax")
    cand = cand_flat.reshape(g, l_slots + 1)[:, :l_slots]
    slot_ids = torch.arange(l_slots, dtype=torch.int32, device=dev)[None, :]
    row_max = cand.amax(dim=-1, keepdim=True)
    cand = torch.where(slot_ids < torch.clamp(n_cells, max=l_slots)[:, None],
                       cand, row_max).contiguous()

    # l = number of candidates below the neighbour's cell (rows ascending:
    # a left searchsorted counts exactly those)
    cid_q = cid.contiguous()
    l_pos = torch.searchsorted(cand, cid_q).to(torch.int32)      # [G, 8K]
    found = torch.gather(cand, 1, torch.clamp(l_pos, max=l_slots - 1).long()
                         ) == cid_q
    found &= l_pos < l_slots
    pos = torch.where(found, l_pos * CELL + idx.reshape(g, CELL * k) % CELL,
                      l_slots * CELL)
    return cand, pos.reshape(n, k).to(torch.int32), n_cells.to(torch.int32)


def pos_with_self_fallback(pos: torch.Tensor, l8: int) -> torch.Tensor:
    """Dump positions (overflowed candidate cells) take the self slot of
    column 0 instead: the affected neighbours re-weight the query point."""
    return torch.where(pos < l8, pos, pos[:, :1]).contiguous()


def gather_candidate_blocks(x: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Candidate super-rows: ``x [N, C]`` viewed as ``[N/8, 8C]``, rows
    ``cand [G, L]`` taken -> ``[G, L*8, C]`` (contiguous)."""
    n, c = x.shape
    g, l_slots = cand.shape
    cells = x.reshape(n // CELL, CELL * c)
    return cells[cand.reshape(-1).long()].reshape(g, l_slots * CELL, c)
