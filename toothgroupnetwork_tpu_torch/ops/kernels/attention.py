"""K3 / K6 / K7 — fused eval-mode vector attention (csrc/attention.cu) and
twins.

K3 :func:`fused_vector_attention_packed_x` replaces
toothgroupnetwork_tpu/ops/pallas/attention_kernel.py:
``fused_vector_attention_packed_x`` (``_packed_x_kernel`` + ``_packed_body``).
On Hopper the neighbour gather and the relative positions are fused into the
kernel as well: it takes ``x``, ``p`` and ``knn_idx`` instead of the gathered
``x_g`` and ``p_r``.

K6 :func:`fused_vector_attention` replaces ``attention_kernel.py``:
``fused_vector_attention`` (``_attn_kernel``) with the same contract: the
gathered ``x_g`` and ``p_r``, as the cell-attention path builds them
(K4/K5, ``cell_select.py``).

K7 :func:`fused_vector_attention_packed` replaces ``attention_kernel.py``:
``fused_vector_attention_packed`` (``_packed_kernel``): k and v projected
ahead of the kernel. As in the JAX package, no model layer calls it.

The three share the kernel body and the BatchNorm folding of ``fold_bn`` /
``fold_attention_params`` (csrc/attention.cu states the bound, the design
and the element type of each input).
"""

from __future__ import annotations

import torch

from . import build
from ._launch import MODEL_DTYPES, on_cpu, require, stream_of

SMEM_LIMIT = 232448  # bytes a Hopper block may opt into (227 KB)

# order of the packed parameter buffer read by csrc/attention.cu; the k/v
# projection comes last, and K7 takes the buffer without it
_PACK_ORDER = ("a0", "b0", "a1", "b1", "bn0_scale", "bn0_shift", "w0", "c0",
               "bn1_scale", "bn1_shift", "w1", "c1")
_KV_ORDER = ("wk", "bk", "wv", "bv")


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and widened back to float32."""
    return t.to(dtype).float()


def fold_bn(bn, eps: float = 1e-5):
    """Eval-mode BatchNorm as an affine pair (a, b): y = a * x + b."""
    a = bn.scale / torch.sqrt(bn.var + eps)
    return a, bn.bias - bn.mean * a


def _probe_dense(lin, dtype):
    """(kernel ``[in, out]``, bias) of a Dense that computes in ``dtype``,
    read back as the JAX backbone reads it: ``bias = d(0)``, ``kernel =
    d(I) - bias``, each output rounded to ``dtype`` (backbone.py
    ``dense_wb``)."""
    bias = _round(lin.bias, dtype)
    return _round(_round(lin.weight.t(), dtype) + bias, dtype) - bias, bias


def _probe_bn(bn, dtype, eps: float):
    """(scale, shift) of an eval BatchNorm with output ``dtype``, read back
    as the JAX backbone reads it: ``shift = bn(0)``, ``scale = bn(1) -
    shift`` (backbone.py ``bn_ab``)."""
    inv = torch.reciprocal(torch.sqrt(bn.var + eps))
    shift = _round((0.0 - bn.mean) * inv * bn.scale + bn.bias, dtype)
    return _round((1.0 - bn.mean) * inv * bn.scale + bn.bias, dtype) - shift, shift


def fold_attention_params(layer, dtype: torch.dtype = torch.float32,
                          eps: float = 1e-5) -> dict:
    """Fold a PointTransformerLayer's eval-mode sub-layers for the kernel.
    Matrices come back in the ``[in, out]`` orientation of the JAX package.

    ``dtype`` is the layer's compute dtype. In float32 the folding is exact.
    In bfloat16 each sub-layer is read back the way the JAX backbone's
    kernel path reads it, by probing the bf16 sub-layer with zeros and the
    identity, so the folded weights carry the same bf16 roundings."""
    if dtype == torch.float32:
        a_p, b_p = fold_bn(layer.linear_p_bn, eps)
        a_w0, b_w0 = fold_bn(layer.linear_w_bn0, eps)
        a_w1, b_w1 = fold_bn(layer.linear_w_bn1, eps)
        lin = {name: (getattr(layer, name).weight.t(), getattr(layer, name).bias)
               for name in ("linear_p0", "linear_p1", "linear_w0", "linear_w1",
                            "linear_k", "linear_v")}
    else:
        a_p, b_p = _probe_bn(layer.linear_p_bn, dtype, eps)
        a_w0, b_w0 = _probe_bn(layer.linear_w_bn0, dtype, eps)
        a_w1, b_w1 = _probe_bn(layer.linear_w_bn1, dtype, eps)
        lin = {name: _probe_dense(getattr(layer, name), dtype)
               for name in ("linear_p0", "linear_p1", "linear_w0", "linear_w1",
                            "linear_k", "linear_v")}
    w_p0, bias_p0 = lin["linear_p0"]
    return {
        # the pe BN folded into Dense(3,3): relu(a*(xW+b)+t) = relu(x(W*a) + (b*a+t))
        "a0": w_p0 * a_p[None, :], "b0": bias_p0 * a_p + b_p,
        "a1": lin["linear_p1"][0], "b1": lin["linear_p1"][1],
        "bn0_scale": a_w0, "bn0_shift": b_w0,
        "w0": lin["linear_w0"][0], "c0": lin["linear_w0"][1],
        "bn1_scale": a_w1, "bn1_shift": b_w1,
        "w1": lin["linear_w1"][0], "c1": lin["linear_w1"][1],
        "wk": lin["linear_k"][0], "bk": lin["linear_k"][1],
        "wv": lin["linear_v"][0], "bv": lin["linear_v"][1],
    }


def _kv_in(params: dict, dtype: torch.dtype) -> dict:
    """K3's contract: with bf16 rows the k/v weights are rounded to bf16
    first (the bf16 kron weights of ``fused_vector_attention_packed_x``)."""
    if dtype == torch.float32:
        return params
    return {**params, "wk": _round(params["wk"], dtype),
            "wv": _round(params["wv"], dtype)}


def pack_params(params: dict, kv: bool = True) -> torch.Tensor:
    """One contiguous f32 buffer in the order csrc/attention.cu unpacks
    (without the k/v projection for K7)."""
    keys = _PACK_ORDER + (_KV_ORDER if kv else ())
    return torch.cat([params[k].reshape(-1).float() for k in keys]).contiguous()


def _check_smem(smem: int, what: str) -> None:
    if smem > SMEM_LIMIT:
        raise ValueError(f"attention: {what} needs {smem} B of shared memory "
                         f"(> {SMEM_LIMIT})")


def fused_vector_attention_packed_x(x: torch.Tensor, p: torch.Tensor,
                                    knn_idx: torch.Tensor, q: torch.Tensor,
                                    params: dict) -> torch.Tensor:
    """K3, neighbour gather fused: x ``[B, N, Cin]`` (float32 or bfloat16),
    p ``[B, N, 3]`` f32, knn_idx ``[B, N, K]`` int32 (indices within each
    cloud), q ``[B*N, C]`` in x's dtype, params from
    :func:`fold_attention_params` -> ``[B*N, C]`` in x's dtype (the JAX
    backbone's ``out_dtype``, its model dtype). Compute is float32; with
    bf16 rows the relative positions and Wk/Wv are rounded to bf16 first.
    CPU tensors take :func:`fused_vector_attention_packed_x_reference`."""
    if on_cpu(x):
        return fused_vector_attention_packed_x_reference(x, p, knn_idx, q, params)
    dev = x.device
    require(x, "x", MODEL_DTYPES, 3, dev)
    require(p, "p", torch.float32, 3, dev)
    require(knn_idx, "knn_idx", torch.int32, 3, dev)
    require(q, "q", x.dtype, 2, dev)
    b, n, cin = x.shape
    kk = knn_idx.shape[2]
    c = q.shape[1]
    cs = params["w1"].shape[-1]
    if (tuple(p.shape) != (b, n, 3) or tuple(knn_idx.shape[:2]) != (b, n)
            or q.shape[0] != b * n or c % cs or 2 * cs > cin):
        raise ValueError(f"attention: x {tuple(x.shape)} p {tuple(p.shape)} "
                         f"idx {tuple(knn_idx.shape)} q {tuple(q.shape)} cs {cs}")
    with torch.cuda.device(dev):
        lib = build.library()
        _check_smem(lib.tgn_attention_smem_bytes(kk, cin, c),
                    f"K={kk} Cin={cin} C={c}")
        packed = pack_params(_kv_in(params, x.dtype))
        out = torch.empty((b * n, c), dtype=x.dtype, device=dev)
        status = lib.tgn_attention(x.data_ptr(), p.data_ptr(), knn_idx.data_ptr(),
                                   q.data_ptr(), packed.data_ptr(), b, n, kk, cin,
                                   c, cs, out.data_ptr(), x.dtype == torch.bfloat16,
                                   stream_of(dev))
        build.check(status, "tgn_attention")
    fused_vector_attention_packed_x.launches += 1
    return out


fused_vector_attention_packed_x.launches = 0


def fused_vector_attention(q: torch.Tensor, x_g: torch.Tensor, p_r: torch.Tensor,
                           params: dict, *, k: int) -> torch.Tensor:
    """K6, gathered input: q ``[BN, C]`` f32, x_g ``[BN*K, Cin]`` and p_r
    ``[BN*K, 3]`` of one dtype (float32 or bfloat16, widened in the
    kernel), params from :func:`fold_attention_params` (f32, used as they
    are) -> ``[BN, C]`` f32; the caller casts. CPU tensors take
    :func:`fused_vector_attention_reference`."""
    if on_cpu(q):
        return fused_vector_attention_reference(q, x_g, p_r, params, k=k)
    dev = q.device
    require(q, "q", torch.float32, 2, dev)
    require(x_g, "x_g", MODEL_DTYPES, 2, dev)
    require(p_r, "p_r", x_g.dtype, 2, dev)
    bn, c = q.shape
    cin = x_g.shape[1]
    cs = params["w1"].shape[-1]
    if (x_g.shape[0] != bn * k or tuple(p_r.shape) != (bn * k, 3) or c % cs
            or 2 * cs > cin):
        raise ValueError(f"attention: q {tuple(q.shape)} x_g {tuple(x_g.shape)} "
                         f"p_r {tuple(p_r.shape)} k {k} cs {cs}")
    with torch.cuda.device(dev):
        lib = build.library()
        _check_smem(lib.tgn_attention_smem_bytes(k, cin, c), f"K={k} Cin={cin} C={c}")
        packed = pack_params(params)
        out = torch.empty((bn, c), dtype=torch.float32, device=dev)
        status = lib.tgn_attention_gathered(q.data_ptr(), x_g.data_ptr(),
                                            p_r.data_ptr(), packed.data_ptr(), bn,
                                            k, cin, c, cs, out.data_ptr(),
                                            x_g.dtype == torch.bfloat16,
                                            stream_of(dev))
        build.check(status, "tgn_attention_gathered")
    fused_vector_attention.launches += 1
    return out


fused_vector_attention.launches = 0


def fused_vector_attention_packed(q: torch.Tensor, k_g: torch.Tensor,
                                  v_g: torch.Tensor, p_r: torch.Tensor,
                                  params: dict, *, k: int) -> torch.Tensor:
    """K7, k and v pre-projected: q ``[BN, C]``, k_g and v_g ``[BN*K, C]``,
    p_r ``[BN*K, 3]``, all of one dtype (float32 or bfloat16, widened in
    the kernel), params from :func:`fold_attention_params` (the k/v part is
    not used) -> ``[BN, C]`` f32. CPU tensors take
    :func:`fused_vector_attention_packed_reference`."""
    if on_cpu(q):
        return fused_vector_attention_packed_reference(q, k_g, v_g, p_r, params, k=k)
    dev = q.device
    require(q, "q", MODEL_DTYPES, 2, dev)
    for t, name in ((k_g, "k_g"), (v_g, "v_g"), (p_r, "p_r")):
        require(t, name, q.dtype, 2, dev)
    bn, c = q.shape
    cs = params["w1"].shape[-1]
    if (tuple(k_g.shape) != (bn * k, c) or tuple(v_g.shape) != (bn * k, c)
            or tuple(p_r.shape) != (bn * k, 3) or c % cs):
        raise ValueError(f"attention: q {tuple(q.shape)} k_g {tuple(k_g.shape)} "
                         f"v_g {tuple(v_g.shape)} p_r {tuple(p_r.shape)} k {k}")
    with torch.cuda.device(dev):
        lib = build.library()
        _check_smem(lib.tgn_attention_projected_smem_bytes(k, c, cs),
                      f"K={k} C={c} (pre-projected)")
        packed = pack_params(params, kv=False)
        out = torch.empty((bn, c), dtype=torch.float32, device=dev)
        status = lib.tgn_attention_projected(q.data_ptr(), k_g.data_ptr(),
                                             v_g.data_ptr(), p_r.data_ptr(),
                                             packed.data_ptr(), bn, k, c, cs,
                                             out.data_ptr(), q.dtype == torch.bfloat16,
                                             stream_of(dev))
        build.check(status, "tgn_attention_projected")
    fused_vector_attention_packed.launches += 1
    return out


fused_vector_attention_packed.launches = 0


def _attention_core(q, k_g, v_g, p_r, params, k: int) -> torch.Tensor:
    """The layer after the k/v projection, in float32 on the folded
    parameters (the kernel's steps (2)-(5), as torch ops)."""
    bn, c = q.shape
    cs = params["w1"].shape[-1]
    pe = torch.relu(p_r @ params["a0"] + params["b0"]) @ params["a1"] + params["b1"]
    w = k_g - q.repeat_interleave(k, dim=0) + pe
    w = torch.relu(w * params["bn0_scale"] + params["bn0_shift"])
    w = w @ params["w0"] + params["c0"]
    w = torch.relu(w * params["bn1_scale"] + params["bn1_shift"])
    w = w @ params["w1"] + params["c1"]
    w = torch.softmax(w.reshape(bn, k, cs), dim=1)
    vpe = (v_g + pe).reshape(bn, k, c // cs, cs)
    return (vpe * w[:, :, None, :]).sum(dim=1).reshape(bn, c)


def fused_vector_attention_reference(q, x_g, p_r, params, *, k: int) -> torch.Tensor:
    """Plain twin of K6: the eval-mode PointTransformerLayer after the q
    projection and the gathers, on the folded parameters, in float32."""
    x_g = x_g.float()
    k_g = x_g @ params["wk"] + params["bk"]
    v_g = x_g @ params["wv"] + params["bv"]
    return _attention_core(q.float(), k_g, v_g, p_r.float(), params, k)


def fused_vector_attention_packed_reference(q, k_g, v_g, p_r, params, *,
                                            k: int) -> torch.Tensor:
    """Plain twin of K7: K6's twin from the projection on."""
    return _attention_core(q.float(), k_g.float(), v_g.float(), p_r.float(),
                           params, k)


def fused_vector_attention_packed_x_reference(x, p, knn_idx, q,
                                              params) -> torch.Tensor:
    """Plain twin of K3: the neighbour gathers and the relative positions
    (rounded to x's dtype), then the K6 twin with Wk/Wv rounded to x's
    dtype, out in x's dtype."""
    from ..gather import index_points

    b, n, kk = knn_idx.shape
    x_g = index_points(x, knn_idx).reshape(b * n * kk, -1)
    p_r = (index_points(p, knn_idx) - p[:, :, None, :]).reshape(b * n * kk, 3)
    out = fused_vector_attention_reference(q, x_g, p_r.to(x.dtype),
                                           _kv_in(params, x.dtype), k=kk)
    return out.to(x.dtype)
