"""The rest of the port's public surface against the JAX package, on the
CPU: ``utils/viz.py`` (files byte-equal), ``utils/profiling.py``,
``utils/torch_import.py`` (each family), ``pipelines/tgn.py:prep_mesh_tgn``
and ``TgnInferencePipeline.variants()``, the ``ops.fps``/``ops.knn``
aliases, ``data.default_augmenter`` and the ``data``/``postprocess``
re-exports.

``torch_import``: no original checkpoint is on this machine, so each
family's torch ``state_dict`` is made of the key names the JAX converter
reads (found by running it: each missing key it asks for is added, and the
optional keys it tests for, a Dense layer's bias and a TransitionUp's
second BatchNorm, are added where the JAX model has those leaves), filled
with the JAX model's randomised variables in the torch layout (``[out,
in]`` weights, ``[out, in, 1]`` for the convolutions). Both packages
convert it; the JAX result must equal those variables, the port's loads
strictly into the port's module, and the eval forwards agree within the
1e-4 of tests/test_torch_port_families.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import write_synthetic_obj
from test_torch_port_families import (_jax_family, _t, assert_close,
                                      jax_init, randomize_variables,
                                      same_selection_as_port)
from test_torch_port_serving import TorchStandIn
import toothgroupnetwork_tpu.data as jax_data
import toothgroupnetwork_tpu.postprocess as jax_post
from toothgroupnetwork_tpu.models.tgnet import TGNet as JaxTGNet
from toothgroupnetwork_tpu.models.tsegnet import TsgCentroidModule as JaxCentroid
from toothgroupnetwork_tpu.ops import fps as jax_fps_alias
from toothgroupnetwork_tpu.ops import knn as jax_knn_alias
from toothgroupnetwork_tpu.pipelines.tgn import prep_mesh_tgn as jax_prep_mesh_tgn
from toothgroupnetwork_tpu.utils import torch_import as jax_torch_import
from toothgroupnetwork_tpu.utils import viz as jax_viz
import toothgroupnetwork_tpu_torch.data as data
import toothgroupnetwork_tpu_torch.postprocess as post
from toothgroupnetwork_tpu_torch import ops
from toothgroupnetwork_tpu_torch.models.tasks import (build_sem_model,
                                                      build_tgnet_bdl,
                                                      build_tgnet_fps)
from toothgroupnetwork_tpu_torch.models.tgnet import TGNet
from toothgroupnetwork_tpu_torch.models.tsegnet import TsgCentroidModule
from toothgroupnetwork_tpu_torch.pipelines.tgn import (TgnInferencePipeline,
                                                       prep_mesh_tgn)
from toothgroupnetwork_tpu_torch.utils import profiling, torch_import, viz


# ---------------------------------------------------------------------------
# viz: the cases of tests/test_misc_parallel.py::TestViz, files byte-equal
# ---------------------------------------------------------------------------

class TestViz:
    def test_palette_and_colors(self, rng):
        for n in (1, 17, 33):
            np.testing.assert_array_equal(viz.label_palette(n),
                                          jax_viz.label_palette(n))
        labels = rng.integers(0, 17, 50)
        np.testing.assert_array_equal(viz.labels_to_colors(labels),
                                      jax_viz.labels_to_colors(labels))
        assert len({tuple(c) for c in viz.label_palette(17).tolist()}) == 17

    @pytest.mark.parametrize("what", ["points", "mesh", "plain"])
    def test_files_byte_equal(self, tmp_path, rng, what):
        pts = rng.standard_normal((20, 3)).astype(np.float32)
        labels = rng.integers(0, 17, 20)
        faces = np.array([[0, 1, 2], [2, 3, 4]])
        out = []
        for mod in (viz, jax_viz):
            p = str(tmp_path / f"{mod.__name__}.ply")
            if what == "points":
                mod.export_labeled_points(p, pts, labels)
            elif what == "mesh":
                mod.export_colored_mesh(p, pts, faces, labels)
            else:
                mod.write_ply(p, pts)
            out.append(open(p, "rb").read())
        assert out[0] == out[1]
        assert b"element vertex 20" in out[0]


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

class TestProfiling:
    def test_chained_time_on_the_cpu(self):
        calls = []
        x = torch.ones(8)
        sec = profiling.chained_time(lambda a: calls.append(a.sum()), x, iters=5)
        assert len(calls) == 6 and sec >= 0.0
        assert not hasattr(profiling, "cost_bytes")

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with profiling.trace(str(tmp_path / "t")) as prof:
            torch.ones(64, 64) @ torch.ones(64, 64)
        text = (tmp_path / "t" / "trace.json").read_text()
        assert json.loads(text)["traceEvents"]
        assert any("mm" in e.key for e in prof.key_averages())


# ---------------------------------------------------------------------------
# torch_import
# ---------------------------------------------------------------------------

TGN_PARAMS = dict(planes=(8, 16), stride=(1, 4), nsample=(8, 8), blocks=(2, 2),
                  block_num=2)
TGN_PREFIXES = ("first_ins_cent_model.", "second_ins_cent_model.")


def _leaves(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _read_keys(convert, want: set, **kw) -> dict:
    """The torch keys ``convert`` reads, each mapped to the flax leaf path it
    fills: run it on placeholders of unique value, adding each key it asks
    for, and a Dense layer's ``.bias`` and a TransitionUp's
    ``linear2.1.*`` (optional keys it tests with ``in``) where ``want``,
    the JAX model's leaf paths, has them."""
    sd = {}
    while True:
        try:
            leaves = _leaves(convert(sd, **kw))
        except KeyError as e:
            sd[e.args[0]] = np.full((1, 1), float(len(sd)))
            continue
        key_of = {path: list(sd)[int(v.flat[0])] for path, v in leaves.items()}
        added = False
        for path in sorted(want - set(key_of)):
            head, leaf = path.rsplit("/", 1)
            kernel = key_of.get(f"{head}/kernel")
            if leaf == "bias" and kernel is not None:
                sd[kernel[:-len("weight")] + "bias"] = np.zeros((1,))
                added = True
            elif "_up/bn2" in head:
                i = head.split("/")[-2][len("dec"):-len("_up")]
                for name in ("weight", "bias", "running_mean", "running_var"):
                    sd.setdefault(f"dec{i}.0.linear2.1.{name}", np.zeros((1,)))
                added = True
        if not added:
            return key_of
        for k in sd:
            sd[k] = np.full((1, 1), float(list(sd).index(k)))


def _torch_state_dict(key_of: dict, leaves: dict) -> dict:
    """The torch state_dict those keys make from the flax leaves."""
    sd = {}
    for path, key in key_of.items():
        a = leaves[path]
        if path.endswith("/kernel"):
            a = a.T[..., None] if "conv" in key else a.T
        sd[key] = torch.from_numpy(np.array(a))
    return sd


def _family(name, rng):
    """(jax module, randomised variables, port module, input, forward pair,
    the converter's name and keyword arguments) of a small ``name``."""
    feat = (rng.standard_normal((1, 512, 6)) * 0.3).astype(np.float32)
    if name == "tgnet":
        module = JaxTGNet(crop_size=64, c=6, **TGN_PARAMS)
        vs = jax_init(module, jnp.asarray(feat), None, train=False,
                      labels=jnp.zeros((1, 512), jnp.int32))
        port = TGNet(crop_size=64, c=6, **TGN_PARAMS, device="cpu")

        def jax_fwd(v, f):
            return module.apply(v, f, method=module.stage1)["sem_1"]

        def port_fwd(m, f):
            return m.stage1(f)["sem_1"]

        kw = dict(block_num=2, blocks=(2, 2))
        return module, vs, port, feat, jax_fwd, port_fwd, "convert_tgnet", kw
    if name == "tsg_centroid":
        module = JaxCentroid(tiny=True)
        vs = jax_init(module, jnp.asarray(feat), None, train=False)
        port = TsgCentroidModule(tiny=True, device="cpu")

        def jax_fwd(v, f):
            return module.apply(v, f, None, False)["offset_result"]

        def port_fwd(m, f):
            return m(f)["offset_result"]

        return module, vs, port, feat, jax_fwd, port_fwd, "convert_tsg_centroid", {}
    module, cfg = _jax_family(name)
    vs = jax_init(module, jnp.asarray(feat), None, train=False)
    port = build_sem_model(name, cfg.model_parameter, device="cpu")

    def jax_fwd(v, f):
        return module.apply(v, f, None, False)["cls_pred"]

    def port_fwd(m, f):
        return m(f)["cls_pred"]

    convert, kw = f"convert_{name}", {}
    if name == "pointtransformer":
        convert = "convert_point_transformer"
        kw = dict(block_num=3, blocks=tuple(cfg.model_parameter["blocks"]))
    return module, vs, port, feat, jax_fwd, port_fwd, convert, kw


@pytest.mark.parametrize("name", ["pointnet", "pointtransformer", "tgnet",
                                  "dgcnn", "pointnetpp", "tsg_centroid"])
def test_torch_import_matches_jax(rng, monkeypatch, name):
    if name == "dgcnn":
        same_selection_as_port(monkeypatch)
    module, vs, port, feat, jax_fwd, port_fwd, convert, kw = _family(name, rng)
    vs = randomize_variables(vs, rng)
    leaves = _leaves(dict(vs))
    if name == "tgnet":
        # the two halves read the same keys under their prefixes
        first = [p.split("/", 2) for p in leaves]
        inner = _read_keys(jax_torch_import.convert_point_transformer,
                           {f"{c}/{rest}" for c, half, rest in first
                            if half == "first"}, **kw)
        key_of = {}
        for half, prefix in zip(("first", "second"), TGN_PREFIXES):
            for path, key in inner.items():
                coll, rest = path.split("/", 1)
                key_of[f"{coll}/{half}/{rest}"] = prefix + key
    else:
        key_of = _read_keys(getattr(jax_torch_import, convert), set(leaves), **kw)
    assert set(key_of) == set(leaves), sorted(set(key_of) ^ set(leaves))[:6]
    sd = _torch_state_dict(key_of, leaves)

    want = _leaves(getattr(jax_torch_import, convert)(
        {k: v.numpy() for k, v in sd.items()}, **kw))
    assert set(want) == set(leaves)
    for path, a in leaves.items():
        np.testing.assert_array_equal(want[path], a)

    state = getattr(torch_import, convert)(sd, **kw)
    port.load_state_dict(state, strict=True)
    port.eval()
    ref = jax.jit(jax_fwd)(vs, jnp.asarray(feat))
    with torch.no_grad():
        got = port_fwd(port, _t(feat))
    assert_close(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# prep_mesh_tgn, variants(), aliases and re-exports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_side", [40, 12])
def test_prep_mesh_tgn_equals_jax(tmp_path, n_side):
    """A 1600-vertex scan sampled to 512 points, and a 144-vertex one that
    is subdivided and repeated."""
    obj = str(tmp_path / "scan_lower.obj")
    write_synthetic_obj(obj, n_side=n_side, seed=3)
    got = prep_mesh_tgn(obj, 512, device="cpu")
    for g, w in zip(got, jax_prep_mesh_tgn(obj, 512)):
        np.testing.assert_array_equal(g, w)
    assert got[2].shape == (512, 6)


def test_variants_reports_the_routes():
    mp = {"planes": [8, 16], "stride": [1, 4], "nsample": [8, 8],
          "blocks": [2, 2], "block_num": 2, "crop_sample_size": 64}
    info = {"bdl_ratio": 0.7, "num_of_bdl_points": 300, "num_of_all_points": 512}
    bdl_arch = dict(planes=(8, 16), stride=(1, 1), nsample=(8, 8),
                    blocks=(2, 2), block_num=2)

    def pipe(params, on_device=False):
        cfg = {"model_parameter": dict(mp, **params)}
        mods = (build_tgnet_fps(cfg, device="cpu"),
                build_tgnet_bdl(64, dict(bdl_arch, cell_attention=bool(
                    params.get("cell_attention"))), device="cpu"))
        made = TgnInferencePipeline(None, None, cfg, n_sample=512,
                                    boundary_info=info, inject_modules=mods,
                                    device="cpu")
        # the device route of a CUDA pipeline, on its plain versions here
        made._boundary_on_device = on_device
        return made.variants()

    v = pipe({})
    assert v == {"device": "cpu", "attn_fps_stage0": "K3", "attn_fps_crops": "K3",
                 "attn_bdl_stage0": "K3", "attn_bdl_crops": "K3",
                 "boundary_route": "host", "purity_knn": "host KD-tree",
                 "bdl_nn1_knn": "host KD-tree", "fps_dtype": "torch.float32",
                 "bdl_dtype": "torch.float32"}
    v = pipe({"cell_attention": True, "dtype": "bfloat16"}, on_device=True)
    assert (v["attn_fps_stage0"], v["attn_fps_crops"], v["attn_bdl_stage0"],
            v["attn_bdl_crops"]) == ("K6", "K3", "K6", "K3")
    assert (v["purity_knn"], v["bdl_nn1_knn"]) == ("plain", "plain")
    assert (v["fps_dtype"], v["bdl_dtype"]) == ("torch.bfloat16", "torch.float32")
    stand_in = TorchStandIn(np.zeros((9, 3), np.float32))
    v = TgnInferencePipeline(None, None, None, n_sample=512, boundary_info=info,
                             inject_modules=(stand_in, stand_in),
                             device="cpu").variants()
    assert v["attn_fps_stage0"] == v["fps_dtype"] == "injected"


def test_ops_aliases_equal_jax(rng):
    pts = rng.standard_normal((1, 300, 3)).astype(np.float32)
    mask = rng.random((1, 300)) > 0.2
    np.testing.assert_array_equal(
        ops.fps(_t(pts), 40, _t(mask)).numpy(),
        np.asarray(jax_fps_alias(jnp.asarray(pts), 40, jnp.asarray(mask))))
    q = rng.standard_normal((1, 50, 3)).astype(np.float32)
    got_i, got_d = ops.knn(_t(q), _t(pts), 8, None, _t(mask))
    ref_i, ref_d = jax_knn_alias(jnp.asarray(q), jnp.asarray(pts), 8, None,
                                 jnp.asarray(mask))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=1e-5)


def test_data_reexports_equal_jax(tmp_path, rng):
    for name in ("Y_AXIS_MIN", "Y_AXIS_MAX"):
        assert getattr(data, name) == getattr(jax_data, name)
    labels = np.array([-1, 0, 11, 18, 21, 28, 31, 38, 41, 48])
    for jaw in ("lower", "upper"):
        np.testing.assert_array_equal(data.fdi_to_class(labels, jaw),
                                      jax_data.fdi_to_class(labels, jaw))
        cls = np.arange(17)
        np.testing.assert_array_equal(data.class_to_fdi(cls, jaw),
                                      jax_data.class_to_fdi(cls, jaw))
    xyz = rng.standard_normal((200, 3))
    np.testing.assert_array_equal(data.normalize_vertices(xyz),
                                  jax_data.normalize_vertices(xyz))
    obj = str(tmp_path / "scan_lower.obj")
    write_synthetic_obj(obj, n_side=20, seed=1)
    for faces in (False, True):
        got, want = (m.load_mesh_arr(obj, return_faces=faces)
                     for m in (data, jax_data))
        for g, w in zip(got if faces else [got], want if faces else [want]):
            np.testing.assert_array_equal(g, w)
    for g, w in zip(data.preprocess_scan(obj, device="cpu"),
                    jax_data.preprocess_scan(obj)):
        np.testing.assert_array_equal(g, w)
    arr = rng.standard_normal((100, 6))
    got, want = data.default_augmenter(), jax_data.default_augmenter()
    got.reload_vals(np.random.default_rng(5))
    want.reload_vals(np.random.default_rng(5))
    np.testing.assert_array_equal(got.run(arr.copy()), want.run(arr.copy()))
    for name in ("Scaling", "Rotation", "Translation"):
        assert getattr(data, name).__name__ == getattr(jax_data, name).__name__
    aug = data.Augmentator([data.Scaling([0.9, 1.1]), data.Rotation([-5, 5], "fixed"),
                            data.Translation([-0.1, 0.1])])
    jaug = jax_data.Augmentator([jax_data.Scaling([0.9, 1.1]),
                                 jax_data.Rotation([-5, 5], "fixed"),
                                 jax_data.Translation([-0.1, 0.1])])
    aug.reload_vals(np.random.default_rng(2))
    jaug.reload_vals(np.random.default_rng(2))
    np.testing.assert_array_equal(aug.run(arr.copy()), jaug.run(arr.copy()))


def test_postprocess_reexports_equal_jax(rng):
    arr = rng.integers(0, 4, (50, 10))
    np.testing.assert_array_equal(post.first_label_ratio(arr),
                                  jax_post.first_label_ratio(arr))
    blobs = np.concatenate([rng.normal(c, 0.005, (200, 3))
                            for c in ([0, 0, 0], [0.5, 0, 0], [0, 0.5, 0])])
    got = post.get_clustering_labels(blobs, np.ones(len(blobs)))
    want = jax_post.get_clustering_labels(blobs, np.ones(len(blobs)))
    np.testing.assert_array_equal(got, want)
    pts = np.concatenate([rng.normal(0, 0.01, (50, 3)), rng.normal(1, 0.01, (50, 3))])
    _, _, got = post.clustering_points([pts], "kmeans", [2])
    _, _, want = jax_post.clustering_points([pts], "kmeans", [2])
    a, b = np.asarray(got[0]), np.asarray(want[0])
    assert len(set(zip(a.tolist(), b.tolist()))) == len(set(a)) == len(set(b)) == 2


def test_knn_route_by_shape():
    """K2's kernel follows from C and k alone: the warp kernels up to k = 64
    (C = 3, and any other C up to 256), the any-size kernel beyond."""
    from toothgroupnetwork_tpu_torch.ops.kernels.knn import knn_route
    assert [knn_route(c, k) for c, k in ((3, 40), (3, 64), (6, 20), (256, 64),
                                         (3, 65), (300, 20), (257, 1))] == [
        "tgn_knn", "tgn_knn", "tgn_knn_c", "tgn_knn_c", "tgn_knn_any",
        "tgn_knn_any", "tgn_knn_any"]
