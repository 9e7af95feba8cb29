"""Fit the last Dense of each tgnet head to the synthetic scans' labels, so
that random weights serve like trained ones: stage 1 names the half-arch
class of each point and moves each tooth's points onto its centroid, stage
2 tells tooth from gingiva in a crop. Without it, random logits and offsets
hand the host clustering a scatter no trained model gives (DBSCAN merges it
into one band and MeanShift re-splits that for seconds a scan), and the
benchmark would measure that instead of the product.

The fit is ridge least squares on the features the reference's plain
forward gives the heads (``reference/pointtransformer.py``), over random
``n_sample``-point subsets of labelled meshes: stage 1 to logits +-4 around
the class and to the offset from each point to its tooth's centroid (0 on
gingiva), stage 2 to +-4 on crops around the true centroids.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.mesh import compute_vertex_normals, normalize_scan_vertices
from reference.ops import Precision, index_points, smallest_k, square_distance
from reference.pointtransformer import Backbone

MARGIN = 4.0
RIDGE = 1e-3


def labelled_cloud(verts, faces, cls, n: int, rng, device):
    """``(feat [1, n, 6], cls [n])``: the scan prep's normalised xyz and
    normals of ``n`` vertices drawn without repeats."""
    v = normalize_scan_vertices(verts.astype(np.float64))
    feats = np.concatenate([v, compute_vertex_normals(v, faces)], axis=1)
    rows = np.sort(rng.choice(len(v), n, replace=False))
    return (torch.from_numpy(feats[rows].astype(np.float32))[None].to(device),
            torch.from_numpy(cls[rows]).to(device))


def half_arch_class(cls: torch.Tensor) -> torch.Tensor:
    """Class 0..16 (0 gingiva) -> the fps model's 10 half-arch classes."""
    return torch.where(cls >= 9, cls - 8, cls)


def solve(x: torch.Tensor, t: torch.Tensor):
    """Ridge least squares ``t ~ x w + b``: (weight ``[out, in]``, bias)."""
    a = torch.cat([x, torch.ones_like(x[:, :1])], dim=1).double()
    gram = a.T @ a + RIDGE * len(a) * torch.eye(a.shape[1], device=a.device,
                                                 dtype=a.dtype)
    sol = torch.linalg.solve(gram, a.T @ t.double())
    return sol[:-1].T.float().contiguous(), sol[-1].float().contiguous()


def targets(n_classes: int, cls: torch.Tensor) -> torch.Tensor:
    return MARGIN * (2 * torch.nn.functional.one_hot(cls.long(), n_classes).float() - 1)


def fit(w: dict, arch: dict, clouds: list, crop: int) -> None:
    """Replace the heads' last Dense in ``w`` (the fps or bdl model's
    weights) by the fit to ``clouds`` (``labelled_cloud`` pairs)."""
    first = Backbone(w, "first", arch, Precision())
    second = Backbone(w, "second", arch, Precision())
    xs = {"cls": [], "off": [], "crop": []}
    ts = {"cls": [], "off": [], "crop": []}
    for feat, cls in clouds:
        h = first.head_inputs(feat)
        xyz = feat[0, :, :3]
        xs["cls"].append(h["cls_head"][0])
        ts["cls"].append(targets(10, half_arch_class(cls)))
        teeth = [c for c in torch.unique(cls).tolist() if c > 0]
        cents = torch.stack([xyz[cls == c].mean(dim=0) for c in teeth])
        off = torch.zeros_like(xyz)
        for c, cen in zip(teeth, cents):
            off[cls == c] = cen - xyz[cls == c]
        xs["off"].append(h["offset_head"][0])
        ts["off"].append(off)
        idx = smallest_k(square_distance(cents[None], xyz[None]), crop)[0][0]
        crops = index_points(feat, idx[None])[0]
        crops = torch.cat([crops[..., :3] - crops[..., :3].mean(dim=1, keepdim=True),
                           crops[..., 3:]], dim=-1)
        mask = torch.ones(crops.shape[:2], dtype=torch.bool, device=crops.device)
        hc = second.head_inputs(crops, mask)["cls_head"]
        xs["crop"].append(hc.reshape(-1, hc.shape[-1]))
        ts["crop"].append(targets(2, (cls[idx] > 0).reshape(-1)))
    for key, name in (("cls", "first.cls_head.cls"), ("off", "first.offset_head.cls"),
                      ("crop", "second.cls_head.cls")):
        w[name + ".weight"], w[name + ".bias"] = solve(torch.cat(xs[key]),
                                                       torch.cat(ts[key]))
