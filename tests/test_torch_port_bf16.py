"""The bfloat16 serving configuration of the port against the JAX package, on
the CPU.

The JAX package serves tgnet with ``model_parameter["dtype"] = "bfloat16"``
(bench.py): the backbone computes in bf16 while parameters, geometry, logits
and offsets stay float32. The JAX side runs its attention kernels (as
tests/test_fused_attention.py does with ``TGN_TPU_ATTENTION``), so both
sides compute attention in float32 from bf16 inputs, each layer through the
JAX entry whose contract the port's layer runs: ``packed`` (K3's: bf16 k/v
weights, bf16 out) and, on the stages the cell path serves, ``fused`` (K6's:
float32 weights and q, float32 out cast by the caller).

* The kernels' bf16 contracts, twin against the JAX entry (interpret mode):
  K3 within 1 bf16 ulp of ``fused_vector_attention_packed_x(...,
  out_dtype=bf16)``, K6 within 1e-5 of ``fused_vector_attention`` on bf16
  rows, K4 bit-equal to ``cell_select_x`` on bf16 rows.
* The bf16 folding of the attention parameters against the probes of the
  JAX backbone's kernel path (flax sub-layers in bf16 fed zeros and the
  identity).
* Tiny bf16 TGNet stage 1 / stage 2, with and without ``cell_attention``:
  argmax agreement >= 0.99 and logits/offsets within atol 1e-2. The two
  sides round to bf16 at the same places and mostly agree to ~1e-7; where
  a float32 sum is taken in another order before a bf16 rounding (the
  3-NN interpolation and the bottleneck mean of the stride-4 stages), a
  one-ulp flip (2^-9 at 0.5) moved logits of magnitude <= 0.7 by up to
  2.2e-3 over four seeds. 1e-2 is about four bf16 ulps at 0.5.
* The tiny pipeline through ``cli.infer --config_path`` with ``"dtype":
  "bfloat16"``: challenge JSON, a repeated scan identical, the bdl model in
  float32, the float32 run of the same scan unchanged, and agreement with
  the JAX bf16 pipeline.
"""

import functools
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import write_synthetic_obj
from test_torch_port_ops import _attention_setup
from test_torch_port_pipeline import (BDL_ARCH, BOUNDARY, CROP, FPS_PARAMS,
                                      N_SAMPLE, _checkpoint, _ins_agreement)
from toothgroupnetwork_tpu.models import get_task
from toothgroupnetwork_tpu.models.point_transformer import backbone as jax_backbone
from toothgroupnetwork_tpu.models.tgnet import TGNet as JaxTGNet
from toothgroupnetwork_tpu.models.tgnet import make_crops as jax_make_crops
from toothgroupnetwork_tpu.nn.layers import MaskedBatchNorm as JaxBN
from toothgroupnetwork_tpu.ops import cells as jax_cells
from toothgroupnetwork_tpu.ops import knn_points as jax_knn
from toothgroupnetwork_tpu.ops.gather import index_points as jax_gather
from toothgroupnetwork_tpu.ops.pallas import attention_kernel as jax_attention
from toothgroupnetwork_tpu.ops.pallas import cell_select_kernel as jax_select
from toothgroupnetwork_tpu.pipelines.tgn import TgnInferencePipeline as JaxPipeline
from toothgroupnetwork_tpu_torch.cli import infer
from toothgroupnetwork_tpu_torch.models import tasks
from toothgroupnetwork_tpu_torch.models.tgnet import TGNet
from toothgroupnetwork_tpu_torch.ops.kernels import attention, cell_select
from toothgroupnetwork_tpu_torch.pipelines import maker
from toothgroupnetwork_tpu_torch.pipelines.tgn import TgnInferencePipeline
from toothgroupnetwork_tpu_torch.utils.weights import from_jax_variables

BF16 = torch.bfloat16
TOL = dict(atol=1e-2, rtol=0)


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _bf16_np(a) -> np.ndarray:
    """A bf16 array (JAX or torch) as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, dtype=np.float32)


def _ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |a| (8 significant bits)."""
    mag = np.maximum(np.abs(a), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _flat(variables) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(variables)[0]}


def _params(jax_params: dict) -> dict:
    return {k: _t(np.asarray(v)) for k, v in jax_params.items()}


class TestKernelContracts:
    @pytest.mark.parametrize("c", [16, 32])
    def test_k3_twin_within_one_ulp_of_packed_x(self, rng, c):
        """bf16 x and q, p_r rounded to bf16, bf16 k/v weights, f32
        compute, bf16 out: the same contract as the JAX entry."""
        _, vs, _, pp, xx, kidx = _attention_setup(rng, 2, 120, 12, c)
        b, n, kk = kidx.shape
        params = jax_attention.fold_attention_params(vs)
        p = vs["params"]
        q = ((xx.reshape(b * n, -1) @ p["linear_q"]["kernel"] + p["linear_q"]["bias"])
             .astype(jnp.bfloat16))
        xb = xx.astype(jnp.bfloat16)
        x_g = jax_gather(xb, kidx).reshape(b * n * kk, -1)
        p_r = ((jax_gather(pp, kidx) - pp[:, :, None, :]).reshape(-1, 3)
               .astype(jnp.bfloat16))
        ref = jax_attention.fused_vector_attention_packed_x(
            q, x_g, p_r, params, k=kk, out_dtype=jnp.bfloat16)
        got = attention.fused_vector_attention_packed_x(
            _t(_bf16_np(xb)).to(BF16), _t(np.asarray(pp)), _t(np.asarray(kidx)),
            _t(_bf16_np(q)).to(BF16), _params(params))
        assert got.dtype == BF16
        ref, got = _bf16_np(ref), _bf16_np(got)
        diff = np.abs(got - ref)
        assert (diff <= _ulp(np.maximum(np.abs(got), np.abs(ref)))).all(), diff.max()
        assert np.mean(diff == 0) > 0.9

    @pytest.mark.parametrize("b,n,kk,c", [(1, 60, 24, 128), (1, 60, 24, 256),
                                          (2, 12, 24, 64)])
    def test_k3_projection_then_gathered_twin(self, rng, b, n, kk, c):
        """K3's two twins in turn on bf16 rows (project_kv_reference with
        the bf16 k/v weights, then gathered_kv_attention_reference) against
        the JAX entry with out_dtype=bf16, at the wide layers and on a
        k > n tail: within one bf16 ulp + 1e-4 (two float32 results within
        the float32 tolerance round at most one ulp apart)."""
        _, vs, _, pp, xx, kidx = _attention_setup(rng, b, n, kk, c)
        params = jax_attention.fold_attention_params(vs)
        p = vs["params"]
        q = ((xx.reshape(b * n, -1) @ p["linear_q"]["kernel"] + p["linear_q"]["bias"])
             .astype(jnp.bfloat16))
        xb = xx.astype(jnp.bfloat16)
        x_g = jax_gather(xb, kidx).reshape(b * n * kk, -1)
        p_r = ((jax_gather(pp, kidx) - pp[:, :, None, :]).reshape(-1, 3)
               .astype(jnp.bfloat16))
        ref = jax_attention.fused_vector_attention_packed_x(
            q, x_g, p_r, params, k=kk, out_dtype=jnp.bfloat16)
        tp = _params(params)
        kv = attention.project_kv_reference(_t(_bf16_np(xb)).to(BF16).reshape(b * n, c),
                                            tp)
        got = attention.gathered_kv_attention_reference(
            kv, _t(np.asarray(pp)), _t(np.asarray(kidx)), _t(_bf16_np(q)).to(BF16), tp)
        assert got.dtype == BF16
        ref, got = _bf16_np(ref), _bf16_np(got)
        diff = np.abs(got - ref)
        assert (diff <= _ulp(np.maximum(np.abs(got), np.abs(ref))) + 1e-4).all(), diff.max()

    @pytest.mark.parametrize("c", [16, 32])
    def test_k6_twin_on_bf16_rows(self, rng, c):
        """bf16 x_g and p_r widened to f32, f32 weights, f32 out."""
        _, vs, _, pp, xx, kidx = _attention_setup(rng, 2, 120, 12, c)
        b, n, kk = kidx.shape
        params = jax_attention.fold_attention_params(vs)
        p = vs["params"]
        q = xx.reshape(b * n, -1) @ p["linear_q"]["kernel"] + p["linear_q"]["bias"]
        x_g = jax_gather(xx, kidx).reshape(b * n * kk, -1).astype(jnp.bfloat16)
        p_r = ((jax_gather(pp, kidx) - pp[:, :, None, :]).reshape(-1, 3)
               .astype(jnp.bfloat16))
        ref = jax_attention.fused_vector_attention(q, x_g, p_r, params, k=kk)
        got = attention.fused_vector_attention(
            _t(np.asarray(q)), _t(_bf16_np(x_g)).to(BF16),
            _t(_bf16_np(p_r)).to(BF16), _params(params), k=kk)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    @pytest.mark.parametrize("fallback", [True, False])
    def test_k4_twin_bit_equal_on_bf16_rows(self, rng, fallback):
        n, k, n_slots, c = 512, 12, 24, 32
        u = rng.uniform(-1, 1, (n, 2))
        xyz = np.stack([u[:, 0], 0.3 * u[:, 0] ** 2, u[:, 1]], 1).astype(np.float32)
        xyz = xyz[jax_cells.spatial_sort_perm(xyz, slab=128)]
        idx, _ = jax_knn(jnp.asarray(xyz), jnp.asarray(xyz), k, include_self=True,
                         need_dist=False)
        cand, pos, _ = jax_cells.build_cell_candidates(idx, n_slots)
        pos = np.array(pos)
        if fallback:
            pos = np.asarray(jax_cells.pos_with_self_fallback(jnp.asarray(pos),
                                                              n_slots * 8))
        else:
            pos[::7, 3] = n_slots * 8          # dump positions select zeros
        x = jnp.asarray(rng.standard_normal((n, c)), jnp.bfloat16)
        blk = jax_cells.gather_candidate_blocks(x, cand)
        ref = jax_select.cell_select_x(blk, jnp.asarray(pos, jnp.int32))
        got = cell_select.cell_select_x(_t(_bf16_np(blk)).to(BF16),
                                        _t(pos.astype(np.int32)))
        assert got.dtype == BF16
        np.testing.assert_array_equal(_bf16_np(got), _bf16_np(ref))

    def test_fold_matches_the_jax_probes(self, rng):
        """The bf16 folding reads each sub-layer back as the JAX backbone's
        kernel path does (backbone.py dense_wb / bn_ab): flax sub-layers in
        bf16 fed zeros and the identity."""
        _, vs, port, *_ = _attention_setup(rng, 1, 40, 8, 16)
        p, s = vs["params"], vs["batch_stats"]
        bf = jnp.bfloat16

        def dense(name, din):
            d = fnn.Dense(p[name]["kernel"].shape[1], dtype=bf)
            v = {"params": p[name]}
            bias = d.apply(v, jnp.zeros((1, din), bf)).astype(jnp.float32)
            ker = d.apply(v, jnp.eye(din, dtype=bf)).astype(jnp.float32) - bias
            return ker, bias[0]

        def bn(name, din):
            v = {"params": p[name], "batch_stats": s[name]}
            f = functools.partial(JaxBN(dtype=bf).apply, v, mask=None, train=False)
            shift = f(jnp.zeros((1, din), bf)).astype(jnp.float32)
            return (f(jnp.ones((1, din), bf)).astype(jnp.float32) - shift)[0], shift[0]

        w_p0, b_p0 = dense("linear_p0", 3)
        a_p, sh_p = bn("linear_p_bn", 3)
        want = {"a0": w_p0 * a_p[None, :], "b0": b_p0 * a_p + sh_p}
        for key, (name, din) in {"a1": ("linear_p1", 3), "w0": ("linear_w0", 16),
                                 "w1": ("linear_w1", 2), "wk": ("linear_k", 16),
                                 "wv": ("linear_v", 16)}.items():
            bias_key = {"a1": "b1", "w0": "c0", "w1": "c1", "wk": "bk",
                        "wv": "bv"}[key]
            want[key], want[bias_key] = dense(name, din)
        for pre, name, din in (("bn0", "linear_w_bn0", 16), ("bn1", "linear_w_bn1", 2)):
            want[pre + "_scale"], want[pre + "_shift"] = bn(name, din)
        with torch.no_grad():
            got = attention.fold_attention_params(port, BF16)
        assert set(got) == set(want)
        for key, val in want.items():
            np.testing.assert_allclose(got[key].numpy(), np.asarray(val), rtol=1e-6,
                                       atol=1e-7, err_msg=key)


ARCHS = {
    # tests/test_torch_port_model.py's tiny configurations
    "fps": dict(planes=(8, 16), stride=(1, 4), nsample=(8, 8), blocks=(2, 2),
                block_num=2),
    "bdl": dict(planes=(8, 16), stride=(1, 1), nsample=(12, 8), blocks=(2, 3),
                block_num=2),
    "deep": dict(planes=(8, 16, 32), stride=(1, 4, 4), nsample=(8, 8, 8),
                 blocks=(2, 2, 2), block_num=3),
}
N_POINTS, N_CROP = 256, 64


def _sorted_cloud(rng, n):
    """A curved sheet in spatially sorted order, unit normals beside it."""
    u = rng.uniform(-1, 1, (n, 2))
    xyz = np.stack([u[:, 0], 0.3 * u[:, 0] ** 2 + 0.2 * u[:, 1] ** 2, u[:, 1]], 1)
    xyz = xyz.astype(np.float32)[jax_cells.spatial_sort_perm(xyz.astype(np.float32),
                                                              slab=64)]
    nrm = rng.standard_normal((n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return np.concatenate([xyz, nrm], 1)[None].astype(np.float32)


def _bf16_models(rng, arch, cell):
    jax_model = JaxTGNet(crop_size=N_CROP, c=6, dtype=jnp.bfloat16,
                         cell_attention=cell, **arch)
    vs = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, N_POINTS, 6)), None,
                        train=False, labels=jnp.zeros((1, N_POINTS), jnp.int32))

    def jitter(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return a + jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
        if name in ("mean", "bias", "scale"):
            return a + jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype)
        return a

    vs = jax.tree_util.tree_map_with_path(jitter, dict(vs))
    port = TGNet(crop_size=N_CROP, c=6, **arch, cell_attention=cell, device="cpu",
                 dtype=BF16)
    port.load_state_dict(from_jax_variables(_flat(vs)))
    return jax_model, vs, port.eval()


def _jax_entries(monkeypatch, cell_n):
    """Per layer, the JAX attention entry whose contract the port's layer
    runs: ``fused`` (K6) on the full-resolution stage of ``cell_n`` points
    that the cell path serves, ``packed`` (K3) elsewhere."""
    monkeypatch.setattr(jax_backbone, "_attention_mode",
                        lambda train, b, n, k, c: "fused" if n == cell_n else "packed")


def _compare(got, ref, live=slice(None)):
    for key in ("sem_1", "offset_1"):
        g, r = got[key].numpy()[live], np.asarray(ref[key])[live]
        assert got[key].dtype == torch.float32, key
        np.testing.assert_allclose(g, r, err_msg=key, **TOL)
    agree = np.mean(got["sem_1"].numpy()[live].argmax(-1)
                    == np.asarray(ref["sem_1"])[live].argmax(-1))
    assert agree >= 0.99, agree


@pytest.mark.parametrize("cell", [False, True])
@pytest.mark.parametrize("name", list(ARCHS))
def test_stage1_bf16_matches_jax(rng, monkeypatch, name, cell):
    _jax_entries(monkeypatch, N_POINTS if cell else None)
    jax_model, vs, port = _bf16_models(rng, ARCHS[name], cell)
    feat = _sorted_cloud(rng, N_POINTS)
    ref = jax_model.apply(vs, jnp.asarray(feat), None, method=JaxTGNet.stage1)
    with torch.no_grad():
        got = port.stage1(_t(feat))
    _compare(got, ref)


@pytest.mark.parametrize("name", ["fps", "bdl"])
def test_stage2_bf16_matches_jax(rng, monkeypatch, name):
    _jax_entries(monkeypatch, None)
    jax_model, vs, port = _bf16_models(rng, ARCHS[name], False)
    feat = _sorted_cloud(rng, N_POINTS)
    cents = np.full((1, 16, 3), 1e3, np.float32)
    valid = np.zeros((1, 16), bool)
    cents[0, :5] = feat[0, rng.choice(N_POINTS, 5, replace=False), :3]
    valid[0, :5] = True
    crops, mask, _, _ = jax_make_crops(jnp.asarray(feat), jnp.asarray(cents),
                                       jnp.asarray(valid), N_CROP)
    ref = jax_model.apply(vs, crops, mask, method=JaxTGNet.stage2)
    with torch.no_grad():
        got = port.stage2(_t(np.asarray(crops)), _t(np.asarray(mask)))
    _compare(got, ref, valid.reshape(-1))


@pytest.mark.parametrize("name,ok", [("float32", True), ("bfloat16", True),
                                     ("float16", False)])
def test_dtype_of_the_config(name, ok):
    """``model_parameter["dtype"]``: float32 and bfloat16 are served, any
    other dtype is refused; the bdl model has no dtype and stays float32."""
    cfg = tasks.tgnet_fps_config()
    cfg["model_parameter"].update(planes=[8, 16], stride=[1, 4], nsample=[8, 8],
                                  blocks=[2, 2], block_num=2, dtype=name)
    if not ok:
        with pytest.raises(NotImplementedError, match="float16"):
            tasks.build_tgnet_fps(cfg, device="cpu")
        return
    model = tasks.build_tgnet_fps(cfg, device="cpu")
    assert model.first.dtype == model.second.dtype == tasks.DTYPES[name]
    assert model.first.cls_head.cls.compute_dtype == torch.float32
    assert tasks.build_tgnet_bdl(N_CROP, device="cpu").first.dtype == torch.float32


def test_bf16_slice_through_the_cli(tmp_path, rng, monkeypatch):
    """The tiny pipeline with ``"dtype": "bfloat16"`` through ``cli.infer
    --config_path``: valid challenge JSON, a repeated scan identical, the
    float32 run of the same scan unchanged by the bf16 run, and per-vertex
    agreement >= 0.99 with the JAX bf16 pipeline."""
    monkeypatch.setenv("TGN_TPU_ATTENTION", "packed")
    params = dict(FPS_PARAMS, dtype="bfloat16")
    task = get_task("tgnet_fps")
    cfg = task.default_config()
    cfg.model_parameter.update(params)
    fps_ckpt, bdl_ckpt = str(tmp_path / "fps.npz"), str(tmp_path / "bdl.npz")
    _checkpoint(task.build_module(cfg), fps_ckpt, rng)
    _checkpoint(JaxTGNet(crop_size=CROP, c=6, **BDL_ARCH), bdl_ckpt, rng)
    scan_dir = tmp_path / "scans"
    scan_dir.mkdir()
    obj = str(scan_dir / "case_lower.obj")
    write_synthetic_obj(obj, n_side=40, seed=1)
    ref = JaxPipeline(fps_ckpt, bdl_ckpt, cfg, bdl_arch=BDL_ARCH,
                      n_sample=N_SAMPLE, boundary_info=BOUNDARY)(obj)
    assert len(np.unique(ref["ins"])) > 1, "degenerate reference output"

    monkeypatch.setattr(maker, "TgnInferencePipeline", functools.partial(
        TgnInferencePipeline, bdl_arch=BDL_ARCH, n_sample=N_SAMPLE,
        boundary_info=BOUNDARY))
    argv = ["--input_dir_path", str(scan_dir), "--model_name", "tgnet",
            "--checkpoint_path", fps_ckpt, "--checkpoint_path_bdl", bdl_ckpt,
            "--device", "cpu"]

    def run(name, model_parameter):
        config = tmp_path / f"{name}.json"
        config.write_text(json.dumps({"model_parameter": model_parameter}))
        pipe = infer.main(argv + ["--save_path", str(tmp_path / name),
                                  "--config_path", str(config)])
        return pipe, json.loads((tmp_path / name / "case_lower.json").read_text())

    _, f32_before = run("f32_before", FPS_PARAMS)
    pipe, res = run("bf16", params)
    _, f32_after = run("f32_after", FPS_PARAMS)
    assert pipe.fps_module.first.dtype == pipe.fps_module.second.dtype == BF16
    assert pipe.bdl_module.first.dtype == torch.float32
    assert f32_after == f32_before

    sem, ins = np.asarray(res["labels"]), np.asarray(res["instances"])
    assert res["jaw"] == "lower" and sem.shape == ins.shape == (40 * 40,)
    fdi = {0} | {10 * q + t for q in (1, 2, 3, 4) for t in range(1, 9)}
    assert set(sem.tolist()) <= fdi and ins.min() >= 0
    again = pipe(obj)
    want = again["sem"].copy()
    want[want > 0] += 20
    assert want.tolist() == res["labels"] and again["ins"].tolist() == res["instances"]

    want = ref["sem"].copy()
    want[want > 0] += 20
    sem_agree = np.mean(sem == want)
    ins_agree = _ins_agreement(ins, ref["ins"])
    f32_agree = np.mean(sem == np.asarray(f32_before["labels"]))
    print(f"bf16 slice agreement with JAX bf16: sem {sem_agree:.4f} ins "
          f"{ins_agree:.4f}; with the port in f32: sem {f32_agree:.4f}")
    assert sem_agree >= 0.99 and ins_agree >= 0.99, (sem_agree, ins_agree)
