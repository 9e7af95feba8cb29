"""Plain reference of DGCNN segmentation training (Wang et al., Dynamic
Graph CNN, arXiv:1801.07829, at the ToothGroupNetwork reference's widths:
k 20, EdgeConv 64-64 / 64-64 / 64, a 1024-d embedding, heads 512-256, 17
classes), from a flat dict of weights named as the program's
``state_dict``, and the yardstick of its training step.

The train-mode forward: each EdgeConv takes each point's k nearest in
feature space (itself first; exact selection by the expansion, ties to the
lower index), ``[x_j - x_i, x_i]`` through Dense (no bias) + masked batch
statistics + LeakyReLU(0.2), max over the neighbours; the masked global max
of the embedding joins the skip features; dropout 0.5 draws its keep mask
``rand < 0.5`` from the generator it is given; the loss is the 17-way
cross-entropy of the labels shifted by one, averaged over the valid points
(``training.py``). The optimizer's step is ``optim.py``'s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from counts import dense_flops, knn_bound_s

from .ops import Precision, index_points, knn_points, linear
from .training import batches, batchnorm_train, dropout_seed, seg_loss  # noqa: F401

EDGE = (("ec1", 2), ("ec2", 2), ("ec3", 1))


class TrainReference:
    """The reference of the ``dgcnn`` configuration. ``params``/``buffers``:
    name -> tensor (copied here); the configuration's ``model_parameter``
    gives ``k``, the neighbours of each EdgeConv."""

    def __init__(self, params: dict, buffers: dict, config: dict,
                 prec: Precision = Precision()):
        self.p = {n: t.detach().clone().float() for n, t in params.items()}
        self.b = {n: t.detach().clone().float() for n, t in buffers.items()}
        self.k, self.prec = config["model_parameter"]["k"], prec

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

    def gradients(self, batch: dict, generator) -> tuple[float, dict]:
        """The loss on ``batch`` (``feat``, ``gt_seg_label``, ``mask``
        tensors) and each parameter's gradient (None for one the loss does
        not reach); the running statistics move."""
        w = {n: t.clone().requires_grad_(True) for n, t in self.p.items()}
        logits = self.forward(w, batch["feat"], batch.get("mask"), generator)
        loss = seg_loss(logits, batch["gt_seg_label"], batch.get("mask"))
        grads = torch.autograd.grad(loss, list(w.values()), allow_unused=True)
        return float(loss.detach()), dict(zip(w, grads))


def forward_flops(b: int, n: int, k: int, c: int = 6, emb: int = 1024,
                  classes: int = 17) -> float:
    """DGCNN's forward as the loss needs it: the EdgeConv Dense layers once
    a neighbour row, the embedding, the two head layers and the classifier
    once a point (not the offset and distance heads, which no loss of the
    preset reads)."""
    pair = b * n * k
    edge = (dense_flops(pair, 2 * c, 64) + dense_flops(pair, 64, 64)
            + dense_flops(pair, 128, 64) + dense_flops(pair, 64, 64)
            + dense_flops(pair, 128, 64))
    rows = b * n
    return (edge + dense_flops(rows, 192, emb) + dense_flops(rows, emb + 192, 512)
            + dense_flops(rows, 512, 256)
            + dense_flops(rows, 256, classes))


def train_flops(config: dict) -> float:
    """A training step of the configuration: the forward and a backward of
    twice its products."""
    return 3.0 * forward_flops(config["batch_size"], config["n_points"],
                               config["model_parameter"]["k"])


def kernel_bounds_s(config: dict) -> dict:
    """The bound of a training step's calls of each kernel: K2, each
    EdgeConv's self-kNN in feature space, at C = 6 (the input) and twice at
    C = 64."""
    b, n, k = config["batch_size"], config["n_points"], config["model_parameter"]["k"]
    return {"k2": knn_bound_s(6, b, n, n, k, True) + 2 * knn_bound_s(64, b, n, n, k, True)}
