"""Plain reference of DGCNN segmentation training (Wang et al., Dynamic
Graph CNN, arXiv:1801.07829, at the ToothGroupNetwork reference's widths:
k 20, EdgeConv 64-64 / 64-64 / 64, a 1024-d embedding, heads 512-256, 17
classes) with the Adam preset, from a flat dict of weights named as the
program's ``state_dict``.

The train-mode forward: each EdgeConv takes each point's k nearest in
feature space (itself first; exact selection by the expansion, ties to the
lower index), ``[x_j - x_i, x_i]`` through Dense (no bias) + masked batch
statistics + LeakyReLU(0.2), max over the neighbours; the masked global max
of the embedding joins the skip features; dropout 0.5 draws its keep mask
``rand < 0.5`` from the generator it is given; the loss is the 17-way
cross-entropy of the labels shifted by one, averaged over the valid points.
Batch statistics: the masked mean and biased variance normalise, the
running mean and unbiased variance move with momentum 0.9. Adam: the decay
added to the gradient (L2), betas (0.9, 0.999), eps 1e-8, bias-corrected.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .ops import Precision, index_points, knn_points, linear

EDGE = (("ec1", 2), ("ec2", 2), ("ec3", 1))
BN_MOMENTUM = 0.9
BETAS = (0.9, 0.999)
EPS = 1e-8


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


class DgcnnReference:
    """``params``/``buffers``: name -> tensor (copied here); ``k``: the
    neighbours of each EdgeConv."""

    def __init__(self, params: dict, buffers: dict, k: int, lr: float,
                 weight_decay: float, prec: Precision = Precision(), moments=None):
        """``moments``: Adam's ``(first, second, steps taken)`` to go on
        from; none, fresh."""
        self.p = {n: t.detach().clone().float() for n, t in params.items()}
        self.b = {n: t.detach().clone().float() for n, t in buffers.items()}
        self.k, self.lr, self.wd, self.prec = k, lr, weight_decay, prec
        if moments is None:
            zeros = {n: torch.zeros_like(t) for n, t in self.p.items()}
            moments = (zeros, zeros, 0)
        m, v, self.t = moments
        self.m = {n: m[n].detach().clone().float() for n in self.p}
        self.v = {n: v[n].detach().clone().float() for n in self.p}

    def dense(self, w, x, name):
        return linear(x, w[name + ".weight"], w.get(name + ".bias"), self.prec)

    def forward(self, w, feat, mask, generator):
        act = lambda y: F.leaky_relu(y, 0.2)  # noqa: E731
        x, xs = feat.float(), []
        for name, layers in EDGE:
            idx = knn_points(x.detach(), x.detach(), self.k, mask, include_self=True,
                             need_dist=False)[0]
            neigh = index_points(x, idx)
            center = x[:, :, None, :].expand(neigh.shape)
            h = torch.cat([neigh - center, center], dim=-1)
            b, n, kk, c = h.shape
            h = h.reshape(b * n * kk, c)
            flat = None if mask is None else mask[..., None].expand(b, n, kk).reshape(-1)
            for i in range(layers):
                h = act(batchnorm_train(self.dense(w, h, f"{name}.dense_{i}"), w,
                                        f"{name}.bn_{i}", flat, self.b))
            x = h.reshape(b, n, kk, -1).amax(dim=2)
            xs.append(x)
        x = torch.cat(xs, dim=-1)
        x = act(batchnorm_train(self.dense(w, x, "emb"), w, "emb_bn", mask, self.b))
        if mask is not None:
            x = torch.where(mask[..., None], x, torch.tensor(-1e30, device=x.device))
        g = x.amax(dim=1)
        x = torch.cat([g[:, None, :].expand(-1, xs[0].shape[1], -1), *xs], dim=-1)
        x = act(batchnorm_train(self.dense(w, x, "head1"), w, "head1_bn", mask, self.b))
        x = act(batchnorm_train(self.dense(w, x, "head2"), w, "head2_bn", mask, self.b))
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 0.5
        x = torch.where(keep, x / 0.5, torch.zeros_like(x))
        return self.dense(w, x, "cls")

    def loss(self, logits, labels, mask):
        lab = torch.clamp(labels.long() + 1, 0, logits.shape[-1] - 1)
        logp = F.log_softmax(logits, dim=-1)
        ce = -(F.one_hot(lab, logits.shape[-1]).to(logp.dtype) * logp).sum(dim=-1)
        wm = torch.ones_like(ce) if mask is None else mask.to(ce.dtype)
        return (ce * wm).sum() / torch.clamp_min(wm.sum(), 1e-8)

    def step(self, batch: dict, generator) -> tuple[float, dict]:
        """One Adam step on ``batch`` (``feat``, ``gt_seg_label``, ``mask``
        tensors). Returns the loss and each parameter's gradient as Adam
        takes it (with the decay added)."""
        w = {n: t.clone().requires_grad_(True) for n, t in self.p.items()}
        logits = self.forward(w, batch["feat"], batch.get("mask"), generator)
        loss = self.loss(logits, batch["gt_seg_label"], batch.get("mask"))
        grads = torch.autograd.grad(loss, list(w.values()), allow_unused=True)
        self.t += 1
        b1, b2 = BETAS
        got = {}
        with torch.no_grad():
            for (n, p), g in zip(self.p.items(), grads):
                g = (torch.zeros_like(p) if g is None else g) + self.wd * p
                got[n] = g
                self.m[n] = b1 * self.m[n] + (1 - b1) * g
                self.v[n] = b2 * self.v[n] + (1 - b2) * g * g
                bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
                denom = self.v[n].sqrt() / np.sqrt(bc2) + EPS
                self.p[n] = p - (self.lr / bc1) * self.m[n] / denom
        return float(loss.detach()), got



class TrainReference(DgcnnReference):
    """The reference of the ``dgcnn`` configuration."""

    def __init__(self, params, buffers, config: dict, lr: float, weight_decay: float,
                 prec: Precision = Precision(), moments=None):
        super().__init__(params, buffers, config["model_parameter"]["k"], lr,
                         weight_decay, prec, moments)


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
