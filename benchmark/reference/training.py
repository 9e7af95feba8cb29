"""What the plain training references share: the masked batch statistics
of train mode, the 17-way segmentation cross-entropy, and the batches and
dropout seeds of the port's ``Trainer`` over its ``BatchLoader`` of one
case a batch, worked out again from the case files and the seeds.

Batch statistics: the masked mean and biased variance normalise, the
running mean and unbiased variance move with momentum 0.9.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BN_MOMENTUM = 0.9


def batchnorm_train(x, w, name, mask, buffers):
    """Masked batch statistics over every leading axis; the running
    statistics of ``name`` in ``buffers`` are replaced by their update."""
    red = tuple(range(x.dim() - 1))
    if mask is None:
        s1, cnt = x.sum(dim=red), torch.tensor(float(x.numel() // x.shape[-1]),
                                               device=x.device)
        wm = None
    else:
        wm = mask[..., None].float()
        s1, cnt = (x * wm).sum(dim=red), wm.sum()
    n = torch.clamp_min(cnt, 1.0)
    mean = s1 / n
    dev = (x - mean) ** 2
    var = (dev if wm is None else dev * wm).sum(dim=red) / n
    empty = cnt < 0.5
    var = torch.where(empty, 1.0, var)
    with torch.no_grad():
        unbiased = var * n / torch.clamp_min(n - 1.0, 1.0)
        rm, rv = buffers[name + ".mean"], buffers[name + ".var"]
        buffers[name + ".mean"] = torch.where(
            empty, rm, BN_MOMENTUM * rm + (1 - BN_MOMENTUM) * mean)
        buffers[name + ".var"] = torch.where(
            empty, rv, BN_MOMENTUM * rv + (1 - BN_MOMENTUM) * unbiased)
    inv = torch.reciprocal(torch.sqrt(var + 1e-5))
    return (x - mean) * inv * w[name + ".scale"] + w[name + ".bias"]


def seg_loss(logits, labels, mask):
    """The cross-entropy of the labels shifted by one (gingiva -1 to class
    0), averaged over the valid points."""
    lab = torch.clamp(labels.long() + 1, 0, logits.shape[-1] - 1)
    logp = F.log_softmax(logits, dim=-1)
    ce = -(F.one_hot(lab, logits.shape[-1]).to(logp.dtype) * logp).sum(dim=-1)
    wm = torch.ones_like(ce) if mask is None else mask.to(ce.dtype)
    return (ce * wm).sum() / torch.clamp_min(wm.sum(), 1e-8)


def dropout_seed(seed: int, step: int) -> int:
    """The dropout generator's seed before step ``step`` (0-based), as the
    program states it: a function of ``(seed + 1, step)``."""
    state = np.random.SeedSequence([seed + 1, step]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def draw_augment(rng: np.random.Generator, specs) -> list:
    """The parameters of scaling, rotation about z and translation in the
    order of ``specs``, each uniform in its range, drawn from ``rng``."""
    drawn = []
    for name, lo_hi, *rest in specs:
        lo, hi = lo_hi
        if name == "rotation" and rest != ["fixed"]:
            raise NotImplementedError(f"rotation axis {rest}")
        drawn.append((name, rng.random((1, 3)) * (hi - lo) + lo if name == "translation"
                      else rng.random() * (hi - lo) + lo))
    return drawn


def augment(feat: np.ndarray, drawn: list) -> np.ndarray:
    """The ``drawn`` augmentation applied, xyz and normals rotated alike."""
    for name, v in drawn:
        if name == "scaling":
            feat[:, :3] = feat[:, :3] * v
        elif name == "rotation":
            a = np.radians(v)
            c, s = np.cos(a), np.sin(a)
            rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, c + (1 - c)]])
            feat[:, :3] = feat[:, :3] @ rot.T
            feat[:, 3:6] = feat[:, 3:6] @ rot.T
        else:
            feat[:, :3] = feat[:, :3] + v
    return feat


def batches(paths, config: dict, loader_seed: int, data_seed: int, start: int,
            steps: int, device):
    """Batches ``start`` to ``start + steps`` (counted over all epochs) of
    one case each: each epoch the cases in a new order that
    ``default_rng(loader_seed)`` shuffles them into, each augmented with
    parameters drawn from ``default_rng(data_seed)`` in that order; labels
    one below the file's class (-1 gingiva)."""
    order_rng = np.random.default_rng(loader_seed)
    rng = np.random.default_rng(data_seed)
    picked = []
    while len(picked) < start + steps:
        order = np.arange(len(paths))
        order_rng.shuffle(order)
        picked.extend((int(i), draw_augment(rng, config["aug_specs"])) for i in order)
    out = []
    for i, drawn in picked[start:start + steps]:
        arr = np.load(paths[i])
        feat = augment(arr[:, :6].astype(np.float32).copy(), drawn)
        out.append({"feat": torch.from_numpy(feat[None]).to(device),
                    "gt_seg_label": torch.from_numpy(
                        arr[None, :, 6].astype(np.int32) - 1).to(device),
                    "mask": torch.ones((1, arr.shape[0]), dtype=torch.bool, device=device)})
    return out
