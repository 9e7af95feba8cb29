"""K3 / K6 / K7 — fused eval-mode vector attention (csrc/attention.cu) and
twins.

K3 :func:`fused_vector_attention_packed_x` replaces
toothgroupnetwork_tpu/ops/pallas/attention_kernel.py:
``fused_vector_attention_packed_x`` (``_packed_x_kernel`` + ``_packed_body``).
On Hopper it is two kernels, launched in turn by the one wrapper (one count):
:func:`project_kv` (``tgn_project_kv``) projects k and v once per point, a
tile product on the tensor cores for bf16 rows, where the TPU kernel's
``kron(I_K, W)`` dot projected every gathered row; then ``tgn_attention``
gathers the projected rows and the relative positions by ``knn_idx`` and
runs the rest of the layer. It takes ``x``, ``p`` and ``knn_idx`` instead of
the gathered ``x_g`` and ``p_r``.

K6 :func:`fused_vector_attention` replaces ``attention_kernel.py``:
``fused_vector_attention`` (``_attn_kernel``) with the same contract: the
gathered ``x_g`` and ``p_r``, as the cell-attention path builds them
(K4/K5, ``cell_select.py``); each CTA projects its R*K rows as tiles.

K7 :func:`fused_vector_attention_packed` replaces ``attention_kernel.py``:
``fused_vector_attention_packed`` (``_packed_kernel``): k and v projected
ahead of the kernel. As in the JAX package, no model layer calls it.

The three share the kernel body (many rows a CTA, the folded parameters
staged once a CTA, the channels of a wide layer split over a cluster) and
the BatchNorm folding of ``fold_bn`` / ``fold_attention_params``
(csrc/attention.cu states the bound, the design and the element type of
each input). Each wrapper keeps the kernel layout of the parameters it is
given in the dict itself (:func:`kernel_layout`), built anew when a tensor
of the dict is replaced or changed in place, so a layer that keeps its
folded dict (``PointTransformerLayer.kernel_params``) packs once per load.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import build
from ._launch import (MODEL_DTYPES, count_launch, on_cpu, require, settle,
                      stream_of)

SMEM_LIMIT = 232448  # bytes a Hopper block may opt into (227 KB)

# order of the packed parameter buffer read by csrc/attention.cu; the k/v
# projection has layouts of its own (kernel_layout)
_PACK_ORDER = ("a0", "b0", "a1", "b1", "bn0_scale", "bn0_shift", "w0", "c0",
               "bn1_scale", "bn1_shift", "w1", "c1")
# the key under which a parameter dict keeps its kernel layouts
LAYOUT_KEY = "_kernel_layout"
# the loaders of csrc/attention.cu
_K3, _K6, _K7 = 0, 1, 2
# guards every parameter dict's layouts (cached_layout)
_LAYOUT_LOCK = threading.Lock()


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


def pack_params(params: dict) -> torch.Tensor:
    """One contiguous f32 buffer of the parameters after the k/v projection,
    in the order csrc/attention.cu unpacks."""
    return torch.cat([params[k].reshape(-1).float() for k in _PACK_ORDER]).contiguous()


def _split_bf16(w: torch.Tensor) -> torch.Tensor:
    """float32 ``w`` as three bf16 pieces hi + mid + lo (stacked), whose sum
    is ``w`` to float32's 24 bits: K6's tensor-core product of bf16 rows
    with float32 weights rounds no weight."""
    hi = w.to(torch.bfloat16)
    rest = w - hi.float()
    mid = rest.to(torch.bfloat16)
    return torch.stack([hi, mid, (rest - mid.float()).to(torch.bfloat16)])


def kernel_layout(params: dict, loader: int, dtype: torch.dtype,
                  device: torch.device) -> dict:
    """The tensors a kernel reads for ``params`` (from
    :func:`fold_attention_params`), rows of ``dtype``, on ``device``: the
    parameters after the projection, laid out per CTA as its shared memory
    holds them (``tgn_attention_param_map``), and for K3 and K6 bk|bv
    ``[2C]`` and Wk|Wv transposed, ``[2C, Cin]`` float32 for float32 rows,
    ``[P, 2C, Cin]`` bf16 for bf16 rows: K3 the weights rounded to bf16
    (P = 1, its contract), K6 the float32 weights in three pieces. Kept in
    ``params[LAYOUT_KEY]`` (:func:`cached_layout`) and built anew once a
    tensor of ``params`` is replaced or changed in place."""

    def make() -> dict:
        lib = build.library()
        c, cs = params["b1"].numel(), params["w1"].shape[-1]
        n = lib.tgn_attention_param_map(c, cs, None)
        src = (ctypes.c_int * n)()
        lib.tgn_attention_param_map(c, cs, src)
        with torch.no_grad():
            packed = pack_params(params).to(device)
            src = torch.tensor(list(src), dtype=torch.long, device=device)
            src[src < 0] = packed.numel()   # padding reads the appended zero
            lay = {"params": torch.cat([packed, packed.new_zeros(1)])[src].contiguous()}
            if loader != _K7:
                lay["bias"] = torch.cat([params["bk"], params["bv"]]).float().to(device)
                wt = torch.cat([params["wk"], params["wv"]], dim=1).float().to(device).t()
                if dtype == torch.float32:
                    lay["w"] = wt.contiguous()
                elif loader == _K3:
                    lay["w"] = wt.to(dtype).contiguous()[None]
                else:
                    lay["w"] = _split_bf16(wt.contiguous()).contiguous()
        return lay

    return cached_layout(params, (loader, dtype, device), make)


def cached_layout(params: dict, key, make):
    """``make()``, kept in ``params[LAYOUT_KEY]`` under ``key`` with the
    identity, storage and version counter of every tensor of ``params``,
    and made anew when one of them differs: a tensor replaced, or changed
    in place (``copy_``, ``mul_``, ``load_state_dict``). Nothing is kept
    when a tensor has no version counter (made under
    ``torch.inference_mode``).

    A layout kept in the dict is read by every scan in flight, each on its
    own stream (``TgnInferencePipeline.run_many``), so the look-up and the
    rebuild hold one lock and a new layout is stored only once the stream
    that made it has finished it (``settle``)."""
    with _LAYOUT_LOCK:
        tensors = [v for k, v in params.items() if k != LAYOUT_KEY]
        if any(t.is_inference() for t in tensors):
            return make()
        cache = params.setdefault(LAYOUT_KEY, {})
        stamp = tuple((id(t), t.data_ptr(), t._version) for t in tensors)
        hit = cache.get(key)
        if hit is None or hit[0] != stamp:
            lay = make()
            settle(lay)
            hit = cache[key] = (stamp, lay)
        return hit[1]


def prepare_layouts(params: dict, dtype: torch.dtype, device: torch.device,
                    gathered: bool = False) -> None:
    """Make (or find) the kernel layouts K3, and with ``gathered`` K6, read
    for ``params`` with rows of ``dtype`` on ``device``, on the calling
    thread's stream."""
    kernel_layout(params, _K3, dtype, device)
    if gathered:
        kernel_layout(params, _K6, dtype, device)


def _check_smem(lib, loader: int, n_rows: int, kk: int, c: int, cs: int,
                what: str) -> None:
    smem = lib.tgn_attention_smem_bytes(loader, n_rows, kk, c, cs)
    if smem > SMEM_LIMIT:
        raise ValueError(f"attention: {what} needs {smem} B of shared memory "
                         f"(> {SMEM_LIMIT})")


def project_kv(x: torch.Tensor, params: dict) -> torch.Tensor:
    """K3's step (1), the k/v projection once per point: x ``[M, Cin]``
    (float32 or bfloat16), params from :func:`fold_attention_params` ->
    kv ``[M, 2C]`` float32, ``x [Wk | Wv] + [bk | bv]`` with Wk/Wv rounded
    to x's dtype (K3's contract). A tile product: bf16 rows on the tensor
    cores (exact products, float32 sums), float32 rows on the FMA units
    (float32 sums in order; no TF32). CPU tensors take
    :func:`project_kv_reference`."""
    if on_cpu(x):
        return project_kv_reference(x, params)
    dev = x.device
    require(x, "x", MODEL_DTYPES, 2, dev)
    m, cin = x.shape
    c = params["wk"].shape[-1]
    if params["wk"].shape[0] != cin:
        raise ValueError(f"project_kv: x {tuple(x.shape)} wk {tuple(params['wk'].shape)}")
    with torch.cuda.device(dev):
        return _project_kv(x, kernel_layout(params, _K3, x.dtype, dev), c)


def _project_kv(x: torch.Tensor, lay: dict, c: int) -> torch.Tensor:
    """Launch ``tgn_project_kv`` on x ``[M, Cin]`` (a CUDA tensor, checked)
    with K3's kernel layout -> kv ``[M, 2C]`` float32."""
    m, cin = x.shape
    kv = torch.empty((m, 2 * c), dtype=torch.float32, device=x.device)
    status = build.library().tgn_project_kv(
        x.data_ptr(), lay["w"].data_ptr(), lay["bias"].data_ptr(), m, cin, c,
        kv.data_ptr(), x.dtype == torch.bfloat16, stream_of(x.device))
    build.check(status, "tgn_project_kv")
    count_launch(project_kv)
    return kv


project_kv.launches = 0


def fused_vector_attention_packed_x(x: torch.Tensor, p: torch.Tensor,
                                    knn_idx: torch.Tensor, q: torch.Tensor,
                                    params: dict) -> torch.Tensor:
    """K3, neighbour gather fused: x ``[B, N, Cin]`` (float32 or bfloat16),
    p ``[B, N, 3]`` f32, knn_idx ``[B, N, K]`` int32 (indices within each
    cloud), q ``[B*N, C]`` in x's dtype, params from
    :func:`fold_attention_params` -> ``[B*N, C]`` in x's dtype (the JAX
    backbone's ``out_dtype``, its model dtype). Compute is float32; with
    bf16 rows the relative positions and Wk/Wv are rounded to bf16 first.
    Launches :func:`project_kv` into a float32 scratch, then the attention
    over the gathered projections. CPU tensors take
    :func:`fused_vector_attention_packed_x_reference`."""
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
            or q.shape[0] != b * n or c % cs or params["wk"].shape != (cin, c)):
        raise ValueError(f"attention: x {tuple(x.shape)} p {tuple(p.shape)} "
                         f"idx {tuple(knn_idx.shape)} q {tuple(q.shape)} cs {cs}")
    with torch.cuda.device(dev):
        lib = build.library()
        _check_smem(lib, _K3, b * n, kk, c, cs, f"K={kk} C={c}")
        lay = kernel_layout(params, _K3, x.dtype, dev)
        kv = _project_kv(x.reshape(b * n, cin), lay, c)
        out = torch.empty((b * n, c), dtype=x.dtype, device=dev)
        status = lib.tgn_attention(kv.data_ptr(), p.data_ptr(), knn_idx.data_ptr(),
                                   q.data_ptr(), lay["params"].data_ptr(), b, n, kk, c,
                                   cs, out.data_ptr(), x.dtype == torch.bfloat16,
                                   stream_of(dev))
        build.check(status, "tgn_attention")
    count_launch(fused_vector_attention_packed_x, (b, n, kk, c, x.dtype))
    return out


fused_vector_attention_packed_x.launches = 0
# the same launches by (B, N, K, C, dtype); cleared with the count
fused_vector_attention_packed_x.launches_by_shape = {}


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
            or params["wk"].shape[0] != cin):
        raise ValueError(f"attention: q {tuple(q.shape)} x_g {tuple(x_g.shape)} "
                         f"p_r {tuple(p_r.shape)} k {k} cs {cs}")
    with torch.cuda.device(dev):
        lib = build.library()
        _check_smem(lib, _K6, bn, k, c, cs, f"K={k} C={c} (gathered)")
        lay = kernel_layout(params, _K6, x_g.dtype, dev)
        out = torch.empty((bn, c), dtype=torch.float32, device=dev)
        status = lib.tgn_attention_gathered(q.data_ptr(), x_g.data_ptr(),
                                            p_r.data_ptr(), lay["params"].data_ptr(),
                                            lay["w"].data_ptr(), lay["bias"].data_ptr(),
                                            bn, k, cin, c, cs, out.data_ptr(),
                                            x_g.dtype == torch.bfloat16,
                                            stream_of(dev))
        build.check(status, "tgn_attention_gathered")
    count_launch(fused_vector_attention)
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
        _check_smem(lib, _K7, bn, k, c, cs, f"K={k} C={c} (pre-projected)")
        lay = kernel_layout(params, _K7, q.dtype, dev)
        out = torch.empty((bn, c), dtype=torch.float32, device=dev)
        status = lib.tgn_attention_projected(q.data_ptr(), k_g.data_ptr(),
                                             v_g.data_ptr(), p_r.data_ptr(),
                                             lay["params"].data_ptr(), bn, k, c, cs,
                                             out.data_ptr(), q.dtype == torch.bfloat16,
                                             stream_of(dev))
        build.check(status, "tgn_attention_projected")
    count_launch(fused_vector_attention_packed)
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


def _kv_in(params: dict, dtype: torch.dtype) -> dict:
    """K3's contract: with bf16 rows the k/v weights are rounded to bf16
    first (the bf16 kron weights of ``fused_vector_attention_packed_x``)."""
    if dtype == torch.float32:
        return params
    return {**params, "wk": _round(params["wk"], dtype),
            "wv": _round(params["wv"], dtype)}


def project_kv_reference(x, params) -> torch.Tensor:
    """Plain twin of :func:`project_kv`: ``x [Wk | Wv] + [bk | bv]`` in
    float32, Wk/Wv rounded to x's dtype first (:func:`_kv_in`)."""
    kv = _kv_in(params, x.dtype)
    return (x.float() @ torch.cat([kv["wk"], kv["wv"]], dim=1)
            + torch.cat([kv["bk"], kv["bv"]]))


def gathered_kv_attention_reference(kv, p, knn_idx, q, params,
                                    dtype=None) -> torch.Tensor:
    """Plain twin of K3 after its projection (``tgn_attention``): the rows
    of kv ``[B*N, 2C]`` that knn_idx names, the relative positions rounded
    to ``dtype`` (default q's), then K7's twin; out in ``dtype``."""
    dtype = dtype or q.dtype
    from ..gather import index_points

    b, n, kk = knn_idx.shape
    c = kv.shape[1] // 2
    kv_g = index_points(kv.reshape(b, n, 2 * c), knn_idx).reshape(b * n * kk, 2 * c)
    p_r = (index_points(p, knn_idx) - p[:, :, None, :]).reshape(b * n * kk, 3)
    out = fused_vector_attention_packed_reference(q, kv_g[:, :c], kv_g[:, c:],
                                                  p_r.to(dtype), params, k=kk)
    return out.to(dtype)


def fused_vector_attention_packed_x_reference(x, p, knn_idx, q,
                                              params) -> torch.Tensor:
    """Plain twin of K3: the neighbour gathers and the relative positions
    (rounded to x's dtype), then the K6 twin with Wk/Wv rounded to x's
    dtype, out in x's dtype. It projects every gathered row, as the JAX
    kernel's ``kron`` dot does; the twins of K3's two kernels are
    :func:`project_kv_reference` and :func:`gathered_kv_attention_reference`."""
    from ..gather import index_points

    b, n, kk = knn_idx.shape
    x_g = index_points(x, knn_idx).reshape(b * n * kk, -1)
    p_r = (index_points(p, knn_idx) - p[:, :, None, :]).reshape(b * n * kk, 3)
    out = fused_vector_attention_reference(q, x_g, p_r.to(x.dtype),
                                           _kv_in(params, x.dtype), k=kk)
    return out.to(x.dtype)
