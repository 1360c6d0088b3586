"""The port's metric suite (eval/metrics.py) and label reader
(data/labels.py) against the JAX package's, to 1e-12, on ``gen_map``
boxes as ground truth and detections made from them: jittered, dropped,
relabelled and extra boxes with seeded confs."""

import os
import sys

import numpy as np
import pytest

from oriented_object_detection_tpu.data import labels as JL
from oriented_object_detection_tpu.eval import metrics as JM
from oriented_object_detection_tpu.utils.xlsx import read_xlsx
from oriented_object_detection_tpu_torch.data import labels as L
from oriented_object_detection_tpu_torch.eval import metrics as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.train_synthetic import gen_map  # noqa: E402

cv2 = pytest.importorskip("cv2")

SIZE = 384


@pytest.fixture(scope="module")
def dataset():
    """{image name: GT [M, 9] in pixels} and {image name: dets [N, 11]} for
    four maps; the last map has no detections at all."""
    rng = np.random.RandomState(0)
    gts, dets = {}, {}
    for k in range(4):
        _, lab = gen_map(rng, H=SIZE, W=SIZE, n_obj=18)
        gt = lab.copy()
        gt[:, 1:] *= SIZE
        name = f"map{k}.png"
        gts[name] = gt
        keep = rng.rand(len(gt)) < 0.8                       # dropped GTs
        d = np.zeros((keep.sum(), 11))
        d[:, :8] = gt[keep, 1:] + rng.normal(0, 2.0, (keep.sum(), 8))
        d[:, 8] = gt[keep, 0]
        relabel = rng.rand(len(d)) < 0.1
        d[relabel, 8] = (d[relabel, 8] + 1) % 6
        extra = np.zeros((6, 11))                           # false positives
        c = rng.uniform(40, SIZE - 40, (6, 2))
        extra[:, :8] = np.tile(c, 4) + np.tile([-8, -5, 8, -5, 8, 5, -8, 5],
                                               (6, 1))
        extra[:, 8] = rng.randint(0, 6, 6)
        d = np.concatenate([d, extra])
        d[:, 9] = np.round(rng.uniform(0.0, 1.0, len(d)), 2)   # ties
        dets[name] = d[np.argsort(-d[:, 9], kind="stable")] if k < 3 \
            else np.zeros((0, 11))
    return gts, dets


@pytest.fixture
def caches(dataset):
    gts = dataset[0]
    loader = lambda path: gts[os.path.basename(path)]
    return M.GTCache(loader=loader), JM.GTCache(loader=loader)


def test_gt_cache_and_iou(dataset, caches):
    got, ref = caches
    for name, d in dataset[1].items():
        np.testing.assert_array_equal(got.gt(name), ref.gt(name))
        a = got.iou(d, name)
        assert a.shape == (len(d), len(dataset[0][name]))
        np.testing.assert_array_equal(a, ref.iou(d, name))
        assert got.iou(d.copy(), name) is a                  # memoized


@pytest.mark.parametrize("counts", [(5, 2, 3), (0, 0, 0), (0, 4, 0),
                                    (7, 0, 0)])
def test_prec_rec_f1(counts):
    np.testing.assert_allclose(M.prec_rec_f1(*counts),
                               JM.prec_rec_f1(*counts), rtol=0, atol=1e-12)


@pytest.mark.parametrize("thr", [0.1, 0.25, 0.5, 0.75])
def test_match_dets_to_gts(dataset, caches, thr):
    for name, d in dataset[1].items():
        gt = dataset[0][name]
        iou = caches[0].iou(d, name)
        assert M.match_dets_to_gts(d, gt, iou, thr) == \
            JM.match_dets_to_gts(d, gt, iou, thr)


def test_compute_ap_from_pr():
    rng = np.random.RandomState(1)
    for n in (1, 5, 40):
        r = np.sort(rng.rand(n))
        p = rng.rand(n)
        assert abs(M.compute_ap_from_pr(r, p)
                   - JM.compute_ap_from_pr(r, p)) <= 1e-12


def _class_lists(dataset, cid):
    gts, dets = dataset
    per_dets = [(img, i, float(d[i, 9])) for img, d in dets.items()
                for i in np.flatnonzero(d[:, 8] == cid)]
    per_gts = {img: [int(j) for j in np.flatnonzero(g[:, 0] == cid)]
               for img, g in gts.items()}
    return per_dets, per_gts


def _assert_pr_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x[0], y[0], rtol=0, atol=1e-12)
        np.testing.assert_allclose(x[1], y[1], rtol=0, atol=1e-12)
        assert abs(x[2] - y[2]) <= 1e-12 and x[3:] == y[3:]


@pytest.mark.parametrize("cid", [0, 1, 2, 5])
def test_pr_for_class(dataset, caches, cid):
    per_dets, per_gts = _class_lists(dataset, cid)
    look = lambda img: caches[0].iou(dataset[1][img], img)
    ious = list(np.arange(0.3, 0.96, 0.05))
    _assert_pr_equal(M.compute_pr_for_class_multi(per_dets, per_gts, look,
                                                  ious),
                     JM.compute_pr_for_class_multi(per_dets, per_gts, look,
                                                   ious))
    _assert_pr_equal([M.compute_pr_for_class(per_dets, per_gts, look, 0.5)],
                     [JM.compute_pr_for_class(per_dets, per_gts, look, 0.5)])
    _assert_pr_equal(M.compute_pr_for_class_multi([], per_gts, look, ious),
                     JM.compute_pr_for_class_multi([], per_gts, look, ious))
    _assert_pr_equal(M.compute_pr_for_class_multi(per_dets, {}, look, ious),
                     JM.compute_pr_for_class_multi(per_dets, {}, look, ious))


@pytest.mark.parametrize("ious, min_score", [
    (list(np.arange(0.5, 0.96, 0.05)), 0.001),
    ([0.30, 0.40, 0.50, 0.60, 0.70], 0.001),
    ([0.5], 0.3),
])
def test_evaluate_map(dataset, caches, ious, min_score):
    names = sorted(dataset[0])
    a = M.evaluate_map(dataset[1], names, ious, caches[0], min_score)
    b = JM.evaluate_map(dataset[1], names, ious, caches[1], min_score)
    assert a["per_iou"].keys() == b["per_iou"].keys()
    for k in a["per_iou"]:
        assert abs(a["per_iou"][k] - b["per_iou"][k]) <= 1e-12
    assert abs(a["mAP@0.5"] - b["mAP@0.5"]) <= 1e-12
    assert abs(a["mAP@mean"] - b["mAP@mean"]) <= 1e-12
    assert 0.2 < a["mAP@mean"] < 1.0


@pytest.mark.parametrize("conf", [0.0, 0.25, 0.5])
def test_center_hit_and_dataset_prf(dataset, caches, conf, capsys):
    names = sorted(dataset[0])
    np.testing.assert_allclose(
        M.evaluate_center_hit(dataset[1], names, caches[0], conf),
        JM.evaluate_center_hit(dataset[1], names, caches[1], conf),
        rtol=0, atol=1e-12)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and out[0].startswith("[Center-Hit")
    np.testing.assert_allclose(
        M.evaluate_dataset(dataset[1], names, caches[0], conf, 0.25),
        JM.evaluate_dataset(dataset[1], names, caches[1], conf, 0.25),
        rtol=0, atol=1e-12)


def test_center_hit_skips_self_intersecting_gt():
    gt = np.array([[0, 0, 0, 10, 10, 10, 0, 0, 10.0],      # bow-tie
                   [0, 0, 0, 10, 0, 10, 10, 0, 10.0]])     # square
    det = np.zeros((1, 11))
    det[0, :8] = [2, 2, 8, 2, 8, 8, 2, 8]
    det[0, 9] = 0.9
    cache = M.GTCache(loader=lambda _: gt)
    assert M.evaluate_center_hit({"a": det}, ["a"], cache, 0.5)[:2] == \
        pytest.approx((1.0, 0.5), abs=1e-6)


def test_classwise_report_and_its_xlsx(dataset, caches, tmp_path):
    names = sorted(dataset[0])
    a = M.classwise_report(dataset[1], names, caches[0], 0.25, 0.25,
                           out_path=str(tmp_path / "port.xlsx"))
    b = JM.classwise_report(dataset[1], names, caches[1], 0.25, 0.25,
                            out_path=str(tmp_path / "jax.xlsx"))
    assert len(a) == len(b) >= 5
    for x, y in zip(a, b):
        assert x[:5] == y[:5]
        np.testing.assert_allclose(x[5:], y[5:], rtol=0, atol=1e-12)
    assert read_xlsx(str(tmp_path / "port.xlsx")) == \
        read_xlsx(str(tmp_path / "jax.xlsx"))


def test_run_fusion_eval_block(dataset, caches, tmp_path, capsys):
    """The whole block over an input folder: same numbers, same printed
    lines, same class-wise xlsx; a wide set feeds mAP when given."""
    inp = tmp_path / "in"
    inp.mkdir()
    for name in dataset[0]:
        (inp / name).write_bytes(b"")        # the loader reads no pixels
    key = lambda d: {str(inp / k): v for k, v in d.items()}
    gts = key(dataset[0])
    shift = np.array([3.0] * 8 + [0.0] * 3)
    wide = {k: np.concatenate([v, v + shift])
            for k, v in key(dataset[1]).items()}
    for single in (False, True):
        outs = []
        for mod, sub in ((M, "port"), (JM, "jax")):
            (tmp_path / sub).mkdir(exist_ok=True)
            res = mod.run_fusion_eval(
                key(dataset[1]), str(inp), str(tmp_path / sub),
                dets_map=wide, cache=mod.GTCache(loader=gts.__getitem__),
                single_scale=single)
            outs.append((res, capsys.readouterr().out.replace(
                str(tmp_path / sub), "")))
        (a, out_a), (b, out_b) = outs
        assert out_a == out_b and ("[Fusion]" in out_a) != single
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12)
        assert read_xlsx(str(tmp_path / "port" /
                             "fusion_classwise_metrics.xlsx")) == \
            read_xlsx(str(tmp_path / "jax" / "fusion_classwise_metrics.xlsx"))


def test_run_fusion_eval_without_images(tmp_path, capsys):
    assert M.run_fusion_eval({}, str(tmp_path), str(tmp_path)) == {}
    assert "No images" in capsys.readouterr().out


def test_labels_equal_jax(tmp_path):
    img, lab = gen_map(np.random.RandomState(2), H=200, W=300, n_obj=6)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    JL.write_labels(str(tmp_path / "a.txt"), lab)
    (tmp_path / "Labels").mkdir()
    cv2.imwrite(str(tmp_path / "b.png"), img)
    with open(tmp_path / "Labels" / "b.txt", "w") as f:
        f.write("# a comment\n0 0.1 0.1 0.2 0.1 0.2 0.2 0.1 0.2 extra\n"
                "1 0.5 0.5 0.6 0.5 0.6 0.6 0.5 0.6\nbad line\n"
                "2 0.1 0.1 0.2 0.1 0.2 0.2 0.1 0.2 # tail\n\n")
    (tmp_path / "c.txt").write_text("")
    for name in ("a", "b", "c", "missing"):
        p = str(tmp_path / f"{name}.png")
        assert L.label_path_for_image(p) == JL.label_path_for_image(p)
        np.testing.assert_array_equal(L.load_gt_as_pixels(p),
                                      JL.load_gt_as_pixels(p))
        lp = L.label_path_for_image(p) or p
        for strict in (False, True):
            np.testing.assert_array_equal(
                L.read_labels(lp, strict=strict),
                JL.read_labels(lp, strict=strict))
            np.testing.assert_array_equal(
                L.read_labels(lp, 300, 200, strict=strict),
                JL.read_labels(lp, 300, 200, strict=strict))
    assert L.load_gt_as_pixels(str(tmp_path / "a.png")).shape == (len(lab), 9)
