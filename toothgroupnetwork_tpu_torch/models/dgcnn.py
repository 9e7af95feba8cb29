"""DGCNN semantic segmentation (counterpart of
toothgroupnetwork_tpu/models/dgcnn.py): three EdgeConv stages over a
dynamic feature-space kNN (k = 20; K2's general-C route at C = 6 and 64), a
1024-d global max embedding, the skip concat, dropout (train mode only,
from the generator ``train_step`` sets) and the cls (17), offset (3) and
dist (1) heads, offset and dist zero-initialised."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..nn.layers import Dense, Dropout, MaskedBatchNorm, masked_max
from ..ops import index_points, knn_points


def edge_conv_feature(x: torch.Tensor, k: int, mask=None) -> torch.Tensor:
    """``[B, N, C] -> [B, N, k, 2C]`` EdgeConv tensor ``[x_j - x_i, x_i]``
    over each point's k feature-space neighbours (itself first)."""
    idx, _ = knn_points(x, x, k, mask, mask, include_self=True, need_dist=False)
    neigh = index_points(x, idx)
    center = x[:, :, None, :].expand(neigh.shape)
    return torch.cat([neigh - center, center], dim=-1)


class EdgeConvBlock(nn.Module):
    """Dense (no bias) + BN + LeakyReLU(0.2) stacks on the flattened graph
    rows, then the max over the k neighbours."""

    def __init__(self, din: int, features, *, device):
        super().__init__()
        self.n = len(features)
        for i, f in enumerate(features):
            self.add_module(f"dense_{i}", Dense(din, f, bias=False, device=device))
            self.add_module(f"bn_{i}", MaskedBatchNorm(f, device=device))
            din = f

    def forward(self, x, mask=None):
        b, n, kk, c = x.shape
        x = x.reshape(b * n * kk, c)
        flat_mask = None
        if mask is not None:
            flat_mask = mask[..., None].expand(b, n, kk).reshape(-1)
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            x = F.leaky_relu(getattr(self, f"bn_{i}")(x, flat_mask), 0.2)
        return x.reshape(b, n, kk, -1).amax(dim=2)


class DGCNNSeg(nn.Module):
    def __init__(self, num_classes: int = 17, k: int = 20, emb_dims: int = 1024,
                 c: int = 6, dropout: float = 0.5, *, device):
        super().__init__()
        self.k = k
        kw = dict(device=device)
        self.ec1 = EdgeConvBlock(2 * c, (64, 64), **kw)
        self.ec2 = EdgeConvBlock(128, (64, 64), **kw)
        self.ec3 = EdgeConvBlock(128, (64,), **kw)
        self.emb = Dense(192, emb_dims, bias=False, **kw)
        self.emb_bn = MaskedBatchNorm(emb_dims, **kw)
        self.head1 = Dense(emb_dims + 192, 512, bias=False, **kw)
        self.head1_bn = MaskedBatchNorm(512, **kw)
        self.head2 = Dense(512, 256, bias=False, **kw)
        self.head2_bn = MaskedBatchNorm(256, **kw)
        self.drop = Dropout(dropout)
        self.cls = Dense(256, num_classes, bias=False, **kw)
        self.offset = Dense(256, 3, bias=False, zero_init=True, **kw)
        self.dist = Dense(256, 1, bias=False, zero_init=True, **kw)
        self.eval()

    def forward(self, feat, mask=None):
        x1 = self.ec1(edge_conv_feature(feat, self.k, mask), mask)
        x2 = self.ec2(edge_conv_feature(x1, self.k, mask), mask)
        x3 = self.ec3(edge_conv_feature(x2, self.k, mask), mask)
        x = torch.cat([x1, x2, x3], dim=-1)
        x = F.leaky_relu(self.emb_bn(self.emb(x), mask), 0.2)
        g = masked_max(x, mask, dim=1)
        g = g[:, None, :].expand(x.shape[0], x.shape[1], g.shape[-1])
        x = torch.cat([g, x1, x2, x3], dim=-1)
        x = F.leaky_relu(self.head1_bn(self.head1(x), mask), 0.2)
        x = self.drop(F.leaky_relu(self.head2_bn(self.head2(x), mask), 0.2))
        return {"cls_pred": self.cls(x), "offset": self.offset(x),
                "dist": self.dist(x)}
