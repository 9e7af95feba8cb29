"""The port's offline workflow entry points against the JAX package's, on the
CPU: the preprocessing (``data/preprocess.py``, ``cli.preprocess``), the
case split (``make_split_files``, ``cli.split``) and the evaluation
(``eval/metrics.cal_metric``, ``cli.evaluate``). Each output is bit-equal
(arrays, files) or line-equal (printed lines) to the JAX package's on the
same inputs.

The preprocessing samples ``N_POINTS`` points; the tests set that module
constant to 512 in both packages (``monkeypatch``), so that a 900-vertex
synthetic mesh runs the FPS and a 400-vertex one the padding branch. The
port's FPS runs on the CPU here, through K1's plain version.
"""

import json
import os

import numpy as np
import pytest
import torch

from synthetic import write_synthetic_case
import toothgroupnetwork_tpu.data.preprocess as jax_preprocess
from toothgroupnetwork_tpu.cli import evaluate as jax_evaluate
from toothgroupnetwork_tpu.cli import preprocess as jax_cli_preprocess
from toothgroupnetwork_tpu.cli import split as jax_split
from toothgroupnetwork_tpu.data.dataset import make_split_files as jax_make_split_files
from toothgroupnetwork_tpu.data.mesh_io import load_mesh_arr as jax_load_mesh_arr
from toothgroupnetwork_tpu.eval.metrics import cal_metric as jax_cal_metric
import toothgroupnetwork_tpu_torch.data.preprocess as preprocess
from toothgroupnetwork_tpu_torch.cli import evaluate
from toothgroupnetwork_tpu_torch.cli import preprocess as cli_preprocess
from toothgroupnetwork_tpu_torch.cli import split
from toothgroupnetwork_tpu_torch.data.dataset import make_split_files
from toothgroupnetwork_tpu_torch.data.mesh_io import load_mesh_arr
from toothgroupnetwork_tpu_torch.eval.metrics import cal_metric

N_POINTS = 512
# (case, jaw, vertices per side): 900 vertices (FPS) and 400 (padded)
CASES = (("CASE01", "lower", 30), ("CASE02", "upper", 30), ("CASE03", "upper", 20))


@pytest.fixture
def small_sample(monkeypatch):
    monkeypatch.setattr(preprocess, "N_POINTS", N_POINTS)
    monkeypatch.setattr(jax_preprocess, "N_POINTS", N_POINTS)


@pytest.fixture
def cases(tmp_path):
    for i, (case, jaw, side) in enumerate(CASES):
        write_synthetic_case(str(tmp_path / "src"), case, jaw, n_side=side, seed=i)
    return tmp_path / "src"


def _equal_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        if name.endswith(".npy"):
            got, want = np.load(os.path.join(a, name)), np.load(os.path.join(b, name))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            with open(os.path.join(a, name)) as f, open(os.path.join(b, name)) as g:
                assert f.read() == g.read(), name
    return names


def test_load_mesh_arr_and_label_maps_match_jax(cases, rng):
    obj = str(cases / "objs" / "CASE01" / "CASE01_lower.obj")
    got, want = load_mesh_arr(obj), jax_load_mesh_arr(obj)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    fdi = rng.choice([0, 11, 18, 21, 28, 31, 38, 41, 48, -1], 500)
    for jaw in ("lower", "upper"):
        np.testing.assert_array_equal(preprocess.fdi_to_class(fdi, jaw),
                                      jax_preprocess.fdi_to_class(fdi, jaw))
        cls = rng.integers(0, 17, 500)
        np.testing.assert_array_equal(preprocess.class_to_fdi(cls, jaw),
                                      jax_preprocess.class_to_fdi(cls, jaw))
    xyz = rng.standard_normal((300, 3)) * 20
    np.testing.assert_array_equal(preprocess.normalize_vertices(xyz),
                                  jax_preprocess.normalize_vertices(xyz))


@pytest.mark.parametrize("case,labelled", [("CASE01", True), ("CASE03", True),
                                           ("CASE01", False)],
                         ids=["fps", "padded", "unlabelled"])
def test_preprocess_scan_matches_jax(cases, small_sample, case, labelled):
    jaw = next(j for c, j, _ in CASES if c == case)
    obj = str(cases / "objs" / case / f"{case}_{jaw}.obj")
    js = str(cases / "jsons" / case / f"{case}_{jaw}.json") if labelled else None
    got = preprocess.preprocess_scan(obj, js, device="cpu")
    want = jax_preprocess.preprocess_scan(obj, js)
    assert got[1:] == want[1:]
    assert got[0].dtype == want[0].dtype and got[0].shape == (N_POINTS, 7)
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[1] < N_POINTS) == (case == "CASE03")


def test_cli_preprocess_matches_jax(cases, small_sample, tmp_path, capsys):
    """``cli.preprocess --device cpu``: the same files (npy and the padded
    scan's .meta.json) under the same names, and the same printed lines
    with the save paths swapped."""
    common = ["--source_obj_data_path", str(cases / "objs"),
              "--source_json_data_path", str(cases / "jsons")]
    assert cli_preprocess.main(common + ["--save_data_path", str(tmp_path / "port"),
                                         "--device", "cpu"]) == len(CASES)
    port_out = capsys.readouterr().out
    jax_cli_preprocess.main(common + ["--save_data_path", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    names = _equal_dirs(tmp_path / "port", tmp_path / "jax")
    assert "CASE01_lower_lower_sampled_points.npy" in names
    assert "CASE03_upper_upper_sampled_points.meta.json" in names
    assert port_out == jax_out.replace(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_cli_preprocess_needs_a_card_by_default(cases, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_preprocess.main(["--source_obj_data_path", str(cases / "objs"),
                             "--source_json_data_path", str(cases / "jsons"),
                             "--save_data_path", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("n_cases,seed", [(0, 42), (1, 42), (7, 42), (23, 3)])
def test_split_matches_jax(tmp_path, capsys, n_cases, seed):
    """``make_split_files`` and ``cli.split``: the same folds, files and
    printed lines (both jaws of a case in one fold)."""
    data = tmp_path / "processed"
    data.mkdir()
    for i in range(n_cases):
        for jaw in ("lower", "upper"):
            np.save(data / f"C{i:03d}_{jaw}_{jaw}_sampled_points.npy", np.zeros((2, 7)))
    got = make_split_files(str(data), str(tmp_path / "port"), seed)
    assert got == jax_make_split_files(str(data), str(tmp_path / "jax"), seed)
    _equal_dirs(tmp_path / "port", tmp_path / "jax")
    argv = ["--processed_data_path", str(data), "--seed", str(seed), "--out_dir"]
    assert split.main(argv + [str(tmp_path / "port_cli")]) == got
    port_out = capsys.readouterr().out
    jax_split.main(argv + [str(tmp_path / "jax_cli")])
    assert port_out == capsys.readouterr().out
    _equal_dirs(tmp_path / "port_cli", tmp_path / "jax")


def _predictions(rng, gt: np.ndarray, flips: float) -> np.ndarray:
    """A prediction of FDI labels: the ground truth with a share of the
    vertices given another FDI label or gingiva."""
    pred = gt.copy()
    flip = rng.random(gt.shape) < flips
    pred[flip] = rng.choice(np.unique(np.concatenate([gt, [0]])), flip.sum())
    return pred


@pytest.mark.parametrize("flips", [0.0, 0.1, 0.6])
@pytest.mark.parametrize("is_half", [False, True])
def test_cal_metric_matches_jax(rng, flips, is_half):
    gt = rng.choice([0, 31, 32, 33, 41, 42, 43, 44], 4000)
    pred = _predictions(rng, gt, flips)
    ins = rng.integers(0, 6, gt.shape)
    for sem, instances in ((pred, pred), (pred, ins), (pred, np.zeros_like(pred))):
        got = cal_metric(gt, sem, instances, is_half=is_half)
        want = jax_cal_metric(gt, sem, instances, is_half=is_half)
        assert got[:4] == want[:4]
        assert list(got[4]) == list(want[4])


@pytest.mark.parametrize("half", [False, True])
def test_cli_evaluate_matches_jax(tmp_path, rng, capsys, half):
    """``cli.evaluate`` on one file pair and on a directory of predictions
    against a tree of ground truth: the same printed lines."""
    gt_root, pred_dir = tmp_path / "gt", tmp_path / "pred"
    pred_dir.mkdir()
    for i, (case, jaw) in enumerate((("A", "lower"), ("B", "upper"), ("C", "lower"))):
        gt = rng.choice([0, 31, 32, 33, 41, 42], 3000) if jaw == "lower" \
            else rng.choice([0, 11, 12, 21, 22], 3000)
        (gt_root / case).mkdir(parents=True)
        name = f"{case}_{jaw}.json"
        (gt_root / case / name).write_text(json.dumps({"jaw": jaw,
                                                       "labels": gt.tolist()}))
        pred = _predictions(rng, gt, 0.05 * (i + 1))
        (pred_dir / name).write_text(json.dumps({"labels": pred.tolist()}))
    extra = ["--half_arch_tolerance"] if half else []
    for gt_path, pred_path in ((gt_root / "A" / "A_lower.json", pred_dir / "A_lower.json"),
                               (gt_root, pred_dir)):
        argv = ["--gt_json_path", str(gt_path), "--pred_json_path", str(pred_path)] + extra
        evaluate.main(argv)
        got = capsys.readouterr().out
        jax_evaluate.main(argv)
        assert got == capsys.readouterr().out
        assert got.count("IoU") == (1 if pred_path.is_file() else 4)

