"""K3 / K6 — fused eval-mode vector attention (csrc/attention.cu) and twins.

K3 :func:`fused_vector_attention_packed_x` replaces
toothgroupnetwork_tpu/ops/pallas/attention_kernel.py:
``fused_vector_attention_packed_x`` (``_packed_x_kernel`` + ``_packed_body``).
On Hopper the neighbour gather and the relative positions are fused into the
kernel as well: it takes ``x``, ``p`` and ``knn_idx`` instead of the gathered
``x_g`` and ``p_r``.

K6 :func:`fused_vector_attention` replaces ``attention_kernel.py``:
``fused_vector_attention`` (``_attn_kernel``) with the same contract: the
gathered ``x_g`` and ``p_r``, as the cell-attention path builds them
(K4/K5, ``cell_select.py``). Both share the kernel body and the BatchNorm
folding of ``fold_bn`` / ``fold_attention_params`` (csrc/attention.cu states
the bound and the design).
"""

from __future__ import annotations

import torch

from . import build
from ._launch import on_cpu, require, stream_of

SMEM_LIMIT = 232448  # bytes a Hopper block may opt into (227 KB)

# order and shapes of the packed parameter buffer read by csrc/attention.cu
_PACK_ORDER = ("wk", "bk", "wv", "bv", "a0", "b0", "a1", "b1", "bn0_scale",
               "bn0_shift", "w0", "c0", "bn1_scale", "bn1_shift", "w1", "c1")


def fold_bn(bn, eps: float = 1e-5):
    """Eval-mode BatchNorm as an affine pair (a, b): y = a * x + b."""
    a = bn.scale / torch.sqrt(bn.var + eps)
    return a, bn.bias - bn.mean * a


def fold_attention_params(layer, eps: float = 1e-5) -> dict:
    """Fold a PointTransformerLayer's eval-mode sub-layers for the kernel.
    Matrices come back in the ``[in, out]`` orientation of the JAX package."""
    a_p, b_p = fold_bn(layer.linear_p_bn, eps)
    a_w0, b_w0 = fold_bn(layer.linear_w_bn0, eps)
    a_w1, b_w1 = fold_bn(layer.linear_w_bn1, eps)
    w_p0 = layer.linear_p0.weight.t()
    return {
        # the pe BN folded into Dense(3,3): relu(a*(xW+b)+t) = relu(x(W*a) + (b*a+t))
        "a0": w_p0 * a_p[None, :], "b0": layer.linear_p0.bias * a_p + b_p,
        "a1": layer.linear_p1.weight.t(), "b1": layer.linear_p1.bias,
        "bn0_scale": a_w0, "bn0_shift": b_w0,
        "w0": layer.linear_w0.weight.t(), "c0": layer.linear_w0.bias,
        "bn1_scale": a_w1, "bn1_shift": b_w1,
        "w1": layer.linear_w1.weight.t(), "c1": layer.linear_w1.bias,
        "wk": layer.linear_k.weight.t(), "bk": layer.linear_k.bias,
        "wv": layer.linear_v.weight.t(), "bv": layer.linear_v.bias,
    }


def pack_params(params: dict) -> torch.Tensor:
    """One contiguous f32 buffer in the order csrc/attention.cu unpacks."""
    return torch.cat([params[k].reshape(-1).float() for k in _PACK_ORDER])


def _launch_setup(kk: int, cin: int, c: int, params: dict):
    lib = build.library()
    smem = lib.tgn_attention_smem_bytes(kk, cin, c)
    if smem > SMEM_LIMIT:
        raise ValueError(f"attention: K={kk} Cin={cin} C={c} needs {smem} B "
                         f"of shared memory (> {SMEM_LIMIT})")
    packed = pack_params(params).contiguous()
    return lib, packed


def fused_vector_attention_packed_x(x: torch.Tensor, p: torch.Tensor,
                                    knn_idx: torch.Tensor, q: torch.Tensor,
                                    params: dict) -> torch.Tensor:
    """K3, neighbour gather fused: x ``[B, N, Cin]``, p ``[B, N, 3]`` f32,
    knn_idx ``[B, N, K]`` int32 (indices within each cloud), q ``[B*N, C]``
    f32, params from :func:`fold_attention_params` -> ``[B*N, C]`` f32.
    CPU tensors take :func:`fused_vector_attention_packed_x_reference`."""
    if on_cpu(x):
        return fused_vector_attention_packed_x_reference(x, p, knn_idx, q, params)
    dev = x.device
    require(x, "x", torch.float32, 3, dev)
    require(p, "p", torch.float32, 3, dev)
    require(knn_idx, "knn_idx", torch.int32, 3, dev)
    require(q, "q", torch.float32, 2, dev)
    b, n, cin = x.shape
    kk = knn_idx.shape[2]
    c = q.shape[1]
    cs = params["w1"].shape[-1]
    if (tuple(p.shape) != (b, n, 3) or tuple(knn_idx.shape[:2]) != (b, n)
            or q.shape[0] != b * n or c % cs or 2 * cs > cin):
        raise ValueError(f"attention: x {tuple(x.shape)} p {tuple(p.shape)} "
                         f"idx {tuple(knn_idx.shape)} q {tuple(q.shape)} cs {cs}")
    with torch.cuda.device(dev):
        lib, packed = _launch_setup(kk, cin, c, params)
        out = torch.empty((b * n, c), dtype=torch.float32, device=dev)
        status = lib.tgn_attention(x.data_ptr(), p.data_ptr(), knn_idx.data_ptr(),
                                   q.data_ptr(), packed.data_ptr(), b, n, kk, cin,
                                   c, cs, out.data_ptr(), stream_of(dev))
        build.check(status, "tgn_attention")
    fused_vector_attention_packed_x.launches += 1
    return out


fused_vector_attention_packed_x.launches = 0


def fused_vector_attention(q: torch.Tensor, x_g: torch.Tensor, p_r: torch.Tensor,
                           params: dict, *, k: int) -> torch.Tensor:
    """K6, gathered input: q ``[BN, C]`` f32, x_g ``[BN*K, Cin]`` f32, p_r
    ``[BN*K, 3]`` f32, params from :func:`fold_attention_params` ->
    ``[BN, C]`` f32. CPU tensors take
    :func:`fused_vector_attention_reference`."""
    if on_cpu(q):
        return fused_vector_attention_reference(q, x_g, p_r, params, k=k)
    dev = q.device
    require(q, "q", torch.float32, 2, dev)
    require(x_g, "x_g", torch.float32, 2, dev)
    require(p_r, "p_r", torch.float32, 2, dev)
    bn, c = q.shape
    cin = x_g.shape[1]
    cs = params["w1"].shape[-1]
    if (x_g.shape[0] != bn * k or tuple(p_r.shape) != (bn * k, 3) or c % cs
            or 2 * cs > cin):
        raise ValueError(f"attention: q {tuple(q.shape)} x_g {tuple(x_g.shape)} "
                         f"p_r {tuple(p_r.shape)} k {k} cs {cs}")
    with torch.cuda.device(dev):
        lib, packed = _launch_setup(k, cin, c, params)
        out = torch.empty((bn, c), dtype=torch.float32, device=dev)
        status = lib.tgn_attention_gathered(q.data_ptr(), x_g.data_ptr(),
                                            p_r.data_ptr(), packed.data_ptr(), bn,
                                            k, cin, c, cs, out.data_ptr(),
                                            stream_of(dev))
        build.check(status, "tgn_attention_gathered")
    fused_vector_attention.launches += 1
    return out


fused_vector_attention.launches = 0


def fused_vector_attention_reference(q, x_g, p_r, params, *, k: int) -> torch.Tensor:
    """Plain twin of K6: the eval-mode PointTransformerLayer after the q
    projection and the gathers, on the folded parameters (same steps as the
    kernel, as torch ops)."""
    bn, c = q.shape
    cs = params["w1"].shape[-1]
    k_g = x_g @ params["wk"] + params["bk"]
    v_g = x_g @ params["wv"] + params["bv"]
    pe = torch.relu(p_r @ params["a0"] + params["b0"]) @ params["a1"] + params["b1"]
    w = k_g - q.repeat_interleave(k, dim=0) + pe
    w = torch.relu(w * params["bn0_scale"] + params["bn0_shift"])
    w = w @ params["w0"] + params["c0"]
    w = torch.relu(w * params["bn1_scale"] + params["bn1_shift"])
    w = w @ params["w1"] + params["c1"]
    w = torch.softmax(w.reshape(bn, k, cs), dim=1)
    vpe = (v_g + pe).reshape(bn, k, c // cs, cs)
    return (vpe * w[:, :, None, :]).sum(dim=1).reshape(bn, c)


def fused_vector_attention_packed_x_reference(x, p, knn_idx, q,
                                              params) -> torch.Tensor:
    """Plain twin of K3: the neighbour gathers, then the K6 twin."""
    from ..gather import index_points

    b, n, kk = knn_idx.shape
    x_g = index_points(x, knn_idx).reshape(b * n * kk, -1)
    p_r = (index_points(p, knn_idx) - p[:, :, None, :]).reshape(b * n * kk, 3)
    return fused_vector_attention_reference(q, x_g, p_r, params, k=kk)
