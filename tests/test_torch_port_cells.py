"""The port's cell-attention path against the JAX package, on the CPU.

* ``ops/cells.py``: the spatial sort, the candidate cells and positions (with
  slot overflow), the self fallback and the super-row take, integer- or
  bit-equal to the JAX functions.
* The plain twins of K4/K5 (``ops/kernels/cell_select.py``) bit-equal to
  ``cell_select_x``/``cell_select_p``, which run in interpret mode here; the
  twin of K6 within 1e-5 of ``fused_vector_attention``.
* ``PointTransformerSeg(cell_attention=True)`` against the JAX backbone on a
  sorted cloud (atol 2e-4: float32 over two stages, other summation orders),
  with slots that cover every candidate cell and with forced overflow.
* The tiny tgnet pipeline with ``"cell_attention": true`` driven through
  ``cli.infer --config_path``, against the JAX pipeline.
"""

import functools
import json

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
from toothgroupnetwork_tpu.models.point_transformer.backbone import (
    PointTransformerSeg as JaxSeg)
from toothgroupnetwork_tpu.models.tgnet import TGNet as JaxTGNet
from toothgroupnetwork_tpu.ops import knn_points as jax_knn
from toothgroupnetwork_tpu.ops import cells as jax_cells
from toothgroupnetwork_tpu.ops.pallas import attention_kernel as jax_attention
from toothgroupnetwork_tpu.ops.pallas import cell_select_kernel as jax_select
from toothgroupnetwork_tpu.pipelines.tgn import TgnInferencePipeline as JaxPipeline
from toothgroupnetwork_tpu_torch.cli import infer
from toothgroupnetwork_tpu_torch.models.point_transformer import backbone
from toothgroupnetwork_tpu_torch.models.point_transformer.backbone import (
    PointTransformerSeg)
from toothgroupnetwork_tpu_torch.models.tgnet import TGNet, make_crops
from toothgroupnetwork_tpu_torch.ops import cells, knn_self
from toothgroupnetwork_tpu_torch.ops.kernels import attention, cell_select
from toothgroupnetwork_tpu_torch.pipelines import maker
from toothgroupnetwork_tpu_torch.pipelines.tgn import TgnInferencePipeline
from toothgroupnetwork_tpu_torch.utils.weights import from_jax_variables


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _surface(rng, n, slab):
    """A curved sheet, spatially sorted (the pattern of tests/test_ops.py)."""
    u1 = rng.uniform(-1, 1, n)
    u2 = rng.uniform(-1, 1, n)
    xyz = np.stack([u1, 0.3 * u1 ** 2 + 0.2 * u2 ** 2, u2], 1)
    xyz = (xyz + rng.normal(0, 0.01, xyz.shape)).astype(np.float32)
    return xyz[jax_cells.spatial_sort_perm(xyz, slab=slab)]


def _self_knn(xyz, k):
    """The JAX self-kNN (own index first) on a sorted cloud."""
    idx, _ = jax_knn(jnp.asarray(xyz), jnp.asarray(xyz), k, include_self=True,
                     need_dist=False)
    return np.asarray(idx)


def _flat(variables) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(variables)[0]}


def _jitter(rng, variables):
    def one(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return a + jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)
        if name in ("mean", "bias", "scale"):
            return a + jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(one, dict(variables))


class TestCells:
    @pytest.mark.parametrize("n,slab", [(700, 128), (3000, 1500)])
    def test_spatial_sort_perm_matches_jax(self, rng, n, slab):
        xyz = rng.standard_normal((n, 3)).astype(np.float32) * [1.0, 0.3, 2.0]
        got = cells.spatial_sort_perm(xyz, slab=slab)
        np.testing.assert_array_equal(got, jax_cells.spatial_sort_perm(xyz, slab=slab))

    @pytest.mark.parametrize("case", ["sorted", "overflow"])
    def test_build_cell_candidates_matches_jax(self, rng, case):
        """Sorted cloud with L=24 (no overflow), and random indices with L=4:
        cand, pos (dump value L*8 included), n_cells and the self fallback
        all identical."""
        if case == "sorted":
            idx = _self_knn(_surface(rng, 1024, 256), 16)
            n_slots = 24
        else:
            idx = rng.integers(0, 1024, (1024, 16)).astype(np.int32)
            idx[:, 0] = np.arange(1024)
            n_slots = 4
        ref = [np.asarray(a) for a in
               jax_cells.build_cell_candidates(jnp.asarray(idx), n_slots)]
        got = [a.numpy() for a in cells.build_cell_candidates(_t(idx), n_slots)]
        for g, r, name in zip(got, ref, ("cand", "pos", "n_cells")):
            assert g.dtype == np.int32, name
            np.testing.assert_array_equal(g, r, err_msg=name)
        dump = got[1] == n_slots * 8
        assert dump.any() == (case == "overflow")
        l8 = n_slots * 8
        np.testing.assert_array_equal(
            cells.pos_with_self_fallback(_t(got[1]), l8).numpy(),
            np.asarray(jax_cells.pos_with_self_fallback(jnp.asarray(ref[1]), l8)))

    def test_gather_candidate_blocks_matches_jax(self, rng):
        idx = _self_knn(_surface(rng, 512, 128), 12)
        cand, _, _ = jax_cells.build_cell_candidates(jnp.asarray(idx), 24)
        x = rng.standard_normal((512, 16)).astype(np.float32)
        ref = np.asarray(jax_cells.gather_candidate_blocks(jnp.asarray(x), cand))
        got = cells.gather_candidate_blocks(_t(x), _t(np.asarray(cand))).numpy()
        assert got.shape == (64, 24 * 8, 16)
        np.testing.assert_array_equal(got, ref)


def _select_inputs(rng, c, fallback):
    n, k, n_slots = 512, 12, 24
    xyz = _surface(rng, n, 128)
    x = rng.standard_normal((n, c)).astype(np.float32)
    idx = _self_knn(xyz, k)
    cand, pos, _ = jax_cells.build_cell_candidates(jnp.asarray(idx), n_slots)
    pos = np.array(pos)
    if fallback:
        pos = np.asarray(jax_cells.pos_with_self_fallback(jnp.asarray(pos),
                                                          n_slots * 8))
    else:
        pos[::7, 3] = n_slots * 8          # dump positions select zeros
    blk_x = np.asarray(jax_cells.gather_candidate_blocks(jnp.asarray(x), cand))
    blk_p = np.asarray(jax_cells.gather_candidate_blocks(jnp.asarray(xyz), cand))
    return xyz, x, idx, pos.astype(np.int32), blk_x, blk_p


class TestCellSelect:
    @pytest.mark.parametrize("c", [16, 32])
    @pytest.mark.parametrize("fallback", [True, False])
    def test_select_x_matches_jax(self, rng, c, fallback):
        xyz, x, idx, pos, blk_x, _ = _select_inputs(rng, c, fallback)
        ref = np.asarray(jax_select.cell_select_x(jnp.asarray(blk_x),
                                                  jnp.asarray(pos)))
        got = cell_select.cell_select_x(_t(blk_x), _t(pos)).numpy()
        np.testing.assert_array_equal(got, ref)
        if fallback:          # no overflow on a sorted cloud: the exact gather
            np.testing.assert_array_equal(got, x[idx])

    @pytest.mark.parametrize("fallback", [True, False])
    def test_select_p_matches_jax(self, rng, fallback):
        xyz, _, idx, pos, _, blk_p = _select_inputs(rng, 16, fallback)
        ref = np.asarray(jax_select.cell_select_p(
            jnp.asarray(blk_p), jnp.asarray(pos), jnp.asarray(xyz)))
        got = cell_select.cell_select_p(_t(blk_p), _t(pos), _t(xyz)).numpy()
        np.testing.assert_array_equal(got, ref)
        if fallback:
            np.testing.assert_array_equal(got, xyz[idx] - xyz[:, None, :])

    def test_counters_untouched_by_twins(self, rng):
        xyz, _, _, pos, blk_x, blk_p = _select_inputs(rng, 16, True)
        before = (cell_select.cell_select_x.launches,
                  cell_select.cell_select_p.launches,
                  attention.fused_vector_attention.launches)
        cell_select.cell_select_x(_t(blk_x), _t(pos))
        cell_select.cell_select_p(_t(blk_p), _t(pos), _t(xyz))
        assert (cell_select.cell_select_x.launches,
                cell_select.cell_select_p.launches,
                attention.fused_vector_attention.launches) == before


class TestGatheredAttention:
    @pytest.mark.parametrize("c", [16, 32])          # cs = 2 and 4
    def test_matches_jax_kernel(self, rng, c):
        """K6's twin against ``fused_vector_attention`` (interpret mode) on
        the same gathered rows and folded weights."""
        lay, vs, port, pp, xx, kidx = _attention_setup(rng, 2, 120, 12, c)
        b, n, kk = kidx.shape
        p = vs["params"]
        q = (xx.reshape(b * n, -1) @ p["linear_q"]["kernel"]
             + p["linear_q"]["bias"])
        from toothgroupnetwork_tpu.ops.gather import index_points as jax_gather

        x_g = jax_gather(xx, kidx).reshape(b * n * kk, -1)
        p_r = (jax_gather(pp, kidx) - pp[:, :, None, :]).reshape(-1, 3)
        ref = jax_attention.fused_vector_attention(
            q, x_g, p_r, jax_attention.fold_attention_params(vs), k=kk)
        with torch.no_grad():
            got = attention.fused_vector_attention(
                _t(np.asarray(q)), _t(np.asarray(x_g)), _t(np.asarray(p_r)),
                attention.fold_attention_params(port), k=kk)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    def test_packed_x_twin_is_gather_then_k6(self, rng):
        _, _, port, pp, xx, kidx = _attention_setup(rng, 1, 64, 8, 16)
        x, p, idx = (_t(np.asarray(a)) for a in (xx, pp, kidx))
        with torch.no_grad():
            params = attention.fold_attention_params(port)
            q = port.linear_q(x).reshape(64, 16).contiguous()
            a = attention.fused_vector_attention_packed_x(x, p, idx, q, params)
            x_g = x[0][idx[0].long()].reshape(-1, 16)
            p_r = (p[0][idx[0].long()] - p[0][:, None]).reshape(-1, 3)
            b = attention.fused_vector_attention(q, x_g, p_r, params, k=8)
        assert torch.equal(a, b)


KW = dict(k=10, planes=(8, 16), stride=(1, 4), nsample=(12, 8), blocks=(2, 2),
          block_num=2)


class TestCellBackbone:
    @pytest.mark.parametrize("n_slots,overflow", [(24, False), (3, True)])
    def test_matches_jax(self, rng, n_slots, overflow):
        """tests/test_point_transformer.py:138-168 with the port on the
        other side: the same sorted cloud and weights through the JAX
        backbone and the port, both with ``cell_attention``."""
        n = 512
        xyz = _surface(rng, n, 128)
        feat = np.concatenate(
            [xyz, rng.standard_normal((n, 3)).astype(np.float32) * 0.1], 1)[None]
        jax_model = JaxSeg(**KW, cell_attention=True, cell_slots=n_slots)
        vs = _jitter(rng, jax_model.init(jax.random.PRNGKey(0), jnp.asarray(feat),
                                         None, train=False))
        port = PointTransformerSeg(c=6, **KW, cell_attention=True,
                                   cell_slots=n_slots, device="cpu")
        port.load_state_dict(from_jax_variables(_flat(vs)))
        port.eval()
        with torch.no_grad():
            _, pos, _ = cells.build_cell_candidates(
                knn_self(_t(xyz)[None], 12)[0][0], n_slots)
            assert bool((pos == n_slots * 8).any()) == overflow
            got = port(_t(feat))
        ref = jax_model.apply(vs, jnp.asarray(feat), None, False)
        for key in ("sem_1", "offset_1"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                       atol=2e-4, rtol=1e-4, err_msg=key)

    def test_bdl_stages_take_the_cell_path(self, rng, monkeypatch):
        """Stride (1, 1): K5 runs once (stage 2 slices stage 1's relative
        positions), K4/K6 once per attention layer (2 + 3 blocks in the
        encoder and decoder), K3 never; without the flag K3 runs instead."""
        calls = {"x": 0, "p": 0, "k6": 0, "k3": 0}

        def spy(key, fn):
            @functools.wraps(fn)
            def wrapped(*a, **k):
                calls[key] += 1
                return fn(*a, **k)
            return wrapped

        for name, key in (("cell_select_x", "x"), ("cell_select_p", "p"),
                          ("fused_vector_attention", "k6"),
                          ("fused_vector_attention_packed_x", "k3")):
            monkeypatch.setattr(backbone, name, spy(key, getattr(backbone, name)))
        arch = dict(planes=(8, 16), stride=(1, 1), nsample=(12, 8), blocks=(2, 3),
                    block_num=2)
        feat = _t(np.concatenate([_surface(rng, 256, 64),
                                  np.zeros((256, 3), np.float32)], 1)[None])
        with torch.no_grad():
            PointTransformerSeg(k=10, **arch, cell_attention=True,
                                device="cpu").eval()(feat)
        assert calls == {"x": 5, "p": 1, "k6": 5, "k3": 0}
        calls.update(x=0, p=0, k6=0, k3=0)
        with torch.no_grad():
            PointTransformerSeg(k=10, **arch, device="cpu").eval()(feat)
        assert calls == {"x": 0, "p": 0, "k6": 0, "k3": 5}


    def test_cells_off_switch_takes_k3(self, rng, monkeypatch):
        """``TGN_TPU_CELLS=off`` (the JAX package's switch, backbone.py:421):
        the cell configuration runs K3 on every layer, none of K4/K5/K6, and
        gives the default path's outputs."""
        calls = {"x": 0, "p": 0, "k6": 0, "k3": 0}
        for name, key in (("cell_select_x", "x"), ("cell_select_p", "p"),
                          ("fused_vector_attention", "k6"),
                          ("fused_vector_attention_packed_x", "k3")):
            fn = getattr(backbone, name)

            def wrapped(*a, _fn=fn, _key=key, **k):
                calls[_key] += 1
                return _fn(*a, **k)

            monkeypatch.setattr(backbone, name, wrapped)
        arch = dict(planes=(8, 16), stride=(1, 1), nsample=(12, 8), blocks=(2, 3),
                    block_num=2)
        feat = _t(np.concatenate([_surface(rng, 256, 64),
                                  np.zeros((256, 3), np.float32)], 1)[None])
        plain = PointTransformerSeg(k=10, **arch, device="cpu").eval()
        cell = PointTransformerSeg(k=10, **arch, cell_attention=True,
                                   device="cpu").eval()
        cell.load_state_dict(plain.state_dict())
        monkeypatch.setenv("TGN_TPU_CELLS", "off")
        with torch.no_grad():
            got = cell(feat)
            assert calls == {"x": 0, "p": 0, "k6": 0, "k3": 5}
            want = plain(feat)
        for key in ("sem_1", "offset_1"):
            assert torch.equal(got[key], want[key]), key


def test_stage2_ignores_the_flag(rng):
    """The crop half runs 16 crops at once (B != 1): the flag changes
    nothing there."""
    arch = dict(planes=(8, 16), stride=(1, 4), nsample=(8, 8), blocks=(2, 2),
                block_num=2)
    plain = TGNet(crop_size=CROP, c=6, **arch, device="cpu").eval()
    cell = TGNet(crop_size=CROP, c=6, **arch, cell_attention=True,
                 device="cpu").eval()
    cell.load_state_dict(plain.state_dict())
    feat = _t(np.concatenate([_surface(rng, 256, 64),
                              rng.standard_normal((256, 3)).astype(np.float32)],
                             1)[None])
    cents = torch.full((1, 16, 3), 1e3)
    cents[0, :4] = feat[0, :4, :3]
    valid = torch.zeros((1, 16), dtype=torch.bool)
    valid[0, :4] = True
    crops, mask, _ = make_crops(feat, cents, valid, CROP)
    with torch.no_grad():
        a, b = plain.stage2(crops, mask), cell.stage2(crops, mask)
    for key in ("sem_1", "offset_1"):
        assert torch.equal(a[key], b[key]), key


def test_cell_slice_matches_jax(tmp_path, rng, monkeypatch):
    """The tiny pipeline of test_torch_port_pipeline.py with
    ``"cell_attention": true``, the port driven through ``cli.infer
    --config_path``: sem and ins agreement >= 0.99 with the JAX pipeline."""
    params = dict(FPS_PARAMS, cell_attention=True)
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

    # the tiny sizes the CLI has no flags for; the config file sets the flag
    monkeypatch.setattr(maker, "TgnInferencePipeline", functools.partial(
        TgnInferencePipeline, bdl_arch=BDL_ARCH, n_sample=N_SAMPLE,
        boundary_info=BOUNDARY))
    calls = {"x": 0, "p": 0}
    for name, key in (("cell_select_x", "x"), ("cell_select_p", "p")):
        fn = getattr(backbone, name)

        def wrapped(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(backbone, name, wrapped)
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"model_parameter": params}))
    out_dir = tmp_path / "out"
    pipe = infer.main(["--input_dir_path", str(scan_dir), "--save_path",
                       str(out_dir), "--model_name", "tgnet", "--checkpoint_path",
                       fps_ckpt, "--checkpoint_path_bdl", bdl_ckpt,
                       "--config_path", str(config), "--device", "cpu"])
    assert pipe._spatial_sort and pipe.fps_module.first.cell_attention
    assert pipe.bdl_module.first.cell_attention
    # fps stage 1 (one stride-1 stage) and bdl stage 1 (stride 1, 1)
    assert calls["p"] == 2 and calls["x"] > 0

    res = json.loads((out_dir / "case_lower.json").read_text())
    assert res["jaw"] == "lower"
    sem = np.asarray(res["labels"])
    ins = np.asarray(res["instances"])
    want = ref["sem"].copy()
    want[want > 0] += 20
    assert sem.shape == ins.shape == (40 * 40,)
    sem_agree = np.mean(sem == want)
    ins_agree = _ins_agreement(ins, ref["ins"])
    print(f"cell slice agreement: sem {sem_agree:.4f} ins {ins_agree:.4f}")
    assert sem_agree >= 0.99 and ins_agree >= 0.99, (sem_agree, ins_agree)
