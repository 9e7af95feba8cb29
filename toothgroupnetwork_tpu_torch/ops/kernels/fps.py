"""K1 — farthest point sampling (csrc/fps.cu) and its plain PyTorch twin.

Replaces toothgroupnetwork_tpu/ops/pallas/fps_kernel.py: ``fps_pallas``
(``_fps_folded_kernel``), ``fps_pallas_multicloud`` and ``fps_pallas_batched``
with one kernel. What bounds it on the H100 is the chain of dependent
argmax steps, not the arithmetic; so each cloud runs on a thread-block
cluster of :func:`cluster_size` CTAs that hold its slices in shared memory
and agree on each step's winner through distributed shared memory, one
cluster barrier a step. The source note in csrc/fps.cu gives the contract
and the design.
"""

from __future__ import annotations

import torch

from . import build
from ._launch import count_launch, on_cpu, require, stream_of

MAX_CLUSTER = 16
# points per CTA the cluster size aims at: a step's update of a slice this
# size takes about as long as the step's barrier and exchange
POINTS_PER_CTA = 2048


def cluster_size(n: int) -> int:
    """CTAs per cloud for an ``n``-point cloud: 1 up to 16 as ``n`` grows."""
    return max(1, min(MAX_CLUSTER, -(-n // POINTS_PER_CTA)))


def fps(xyz: torch.Tensor, n_samples: int,
        valid: torch.Tensor | None = None) -> torch.Tensor:
    """xyz ``[B, N, 3]`` f32 contiguous, valid ``[B, N]`` bool or None ->
    int32 ``[B, n_samples]``. CPU tensors take :func:`fps_reference`."""
    if on_cpu(xyz):
        return fps_reference(xyz, n_samples, valid)
    dev = xyz.device
    require(xyz, "xyz", torch.float32, 3, dev)
    b, n, _ = xyz.shape
    if xyz.shape[2] != 3 or n < 1 or n_samples < 1:
        raise ValueError(f"fps: xyz {tuple(xyz.shape)}, n_samples {n_samples}")
    if valid is not None:
        require(valid, "valid", torch.bool, 2, dev)
        if tuple(valid.shape) != (b, n):
            raise ValueError(f"valid {tuple(valid.shape)} != {(b, n)}")
    with torch.cuda.device(dev):
        lib = build.library()
        dist = torch.empty((b, n), dtype=torch.float32, device=dev)
        out = torch.empty((b, n_samples), dtype=torch.int32, device=dev)
        status = lib.tgn_fps(xyz.data_ptr(),
                             None if valid is None else valid.data_ptr(),
                             b, n, n_samples, cluster_size(n), dist.data_ptr(),
                             out.data_ptr(), stream_of(dev))
        build.check(status, "tgn_fps")
    count_launch(fps)
    return out


fps.launches = 0


def chain_floor(steps: int, cluster: int, device: torch.device,
                pull: bool = False) -> torch.Tensor:
    """Run K1's chain alone on one cluster of ``cluster`` CTAs: ``steps``
    steps of K1's candidate exchange with no points, or with ``pull`` of the
    barrier design (one cluster barrier a step, then DSMEM reads). A
    measurement of K1's floor; no model path calls it. Returns the int32
    ``[1, steps]`` winners."""
    with torch.cuda.device(device):
        lib = build.library()
        out = torch.empty((1, steps), dtype=torch.int32, device=device)
        build.check(lib.tgn_fps_chain(1, steps, cluster, int(pull), out.data_ptr(),
                                      stream_of(device)), "tgn_fps_chain")
    return out


def fps_reference(xyz: torch.Tensor, n_samples: int,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin: the contract of toothgroupnetwork_tpu/ops/fps.py, all B
    clouds advanced per step; distances in the kernel's order."""
    b, n, _ = xyz.shape
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=xyz.device)
    inf = torch.tensor(float("inf"), device=xyz.device)
    dist = torch.where(valid, inf, -inf)
    rows = torch.arange(b, device=xyz.device)
    last = valid.to(torch.uint8).argmax(dim=1)   # first valid, 0 if none
    out = torch.empty((b, n_samples), dtype=torch.int64, device=xyz.device)
    out[:, 0] = last
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    for i in range(1, n_samples):
        lc = xyz[rows, last]
        dx, dy, dz = x - lc[:, 0:1], y - lc[:, 1:2], z - lc[:, 2:3]
        d = (dx * dx + dy * dy) + dz * dz
        dist = torch.minimum(dist, torch.where(valid, d, -inf))
        last = dist.argmax(dim=1)                # first max: lowest index
        out[:, i] = last
    return out.to(torch.int32)
