"""The port's dataset build against the JAX package's on the same seeded
`tools/train_synthetic.py::gen_map` maps: two-pass train tiling, class
balancing, the empty-tile budget and val tiling write the same tile images,
label files and list files byte for byte; the 4-channel TIFFs carry the
same RGB pages and a DT-Edge page equal up to the last-ulp `exp`
divergence between XLA and PyTorch (at most one level, on few pixels)."""

import os
import sys

import numpy as np
import pytest
import torch

from oriented_object_detection_tpu.data import config_yaml as JY
from oriented_object_detection_tpu.data import dataset as JDS
from oriented_object_detection_tpu_torch.data import config_yaml as TY
from oriented_object_detection_tpu_torch.data import dataset as TDS
from oriented_object_detection_tpu_torch.data import labels as TL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.train_synthetic import gen_map  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

cv2 = pytest.importorskip("cv2")
TS, OV = 64, 16


def _write_maps(root):
    rng = np.random.RandomState(3)
    for split, n in (("train", 2), ("val", 1)):
        os.makedirs(f"{root}/images/{split}")
        os.makedirs(f"{root}/labels/{split}")
        for k in range(n):
            img, lab = gen_map(rng, H=160, W=192, n_obj=9)
            cv2.imwrite(f"{root}/images/{split}/m{k}.png", img)
            TL.write_labels(f"{root}/labels/{split}/m{k}.txt", lab)


def _build(DS, root):
    """The `train` CLI's dataset build (both packages' `cli.py`)."""
    crop = f"{root}/cropped{TS}"
    stats = DS.build_train_tiles(
        f"{root}/images/train", f"{root}/labels/train",
        f"{crop}/images/train", f"{crop}/labels/train",
        f"{root}/train_cropped{TS}.txt", TS, OV, 0.1)
    DS.balance_classes(f"{crop}/images/train", f"{crop}/labels/train",
                       f"{root}/train_cropped{TS}.txt", 800, 2, seed=42)
    frac = min(1.0, 4 * DS.count_positives(f"{crop}/labels/train")
               / stats["E_total"]) if stats["E_total"] else 0.0
    DS.save_selected_empty_tiles(stats["empty_meta_path"], 0.5 * frac,
                                 f"{root}/train_cropped{TS}.txt", 42)
    DS.build_val_tiles(f"{root}/images/val", f"{root}/labels/val",
                       f"{crop}/images/val", f"{crop}/labels/val",
                       f"{root}/val_cropped{TS}.txt", TS, OV,
                       keep_empty_fraction=0.5)
    return stats


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    roots = {}
    for name, DS in (("jax", JDS), ("port", TDS)):
        root = str(tmp_path_factory.mktemp(name))
        _write_maps(root)
        stats = _build(DS, root)
        roots[name] = (root, stats)
    return roots


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = p
    return out


def test_build_writes_the_same_files(built):
    (jroot, jstats), (troot, tstats) = built["jax"], built["port"]
    assert (jstats["P_total"], jstats["E_total"]) == \
        (tstats["P_total"], tstats["E_total"])
    jf, tf = _files(jroot), _files(troot)
    assert sorted(jf) == sorted(tf)
    kinds = {".jpg": 0, ".txt": 0, ".json": 0}
    for rel in jf:
        with open(jf[rel], "rb") as a, open(tf[rel], "rb") as b:
            ja, tb = a.read(), b.read()
        if rel.endswith(".txt") and "/" not in rel or rel.endswith(".json"):
            # list files and the empty-tile metadata hold absolute paths
            ja = ja.replace(jroot.encode(), b"ROOT")
            tb = tb.replace(troot.encode(), b"ROOT")
        assert ja == tb, rel
        kinds[os.path.splitext(rel)[1]] = kinds.get(
            os.path.splitext(rel)[1], 0) + 1
    # tiles, their augmentations and the empty tiles were all written
    assert kinds[".jpg"] > 50 and kinds[".txt"] > 50
    assert any("_aug_hsv_" in r for r in jf)


def test_label_stats_match(built):
    jroot, troot = built["jax"][0], built["port"][0]
    lbl = f"cropped{TS}/labels/train"
    assert TDS.class_distribution(f"{troot}/{lbl}") == \
        JDS.class_distribution(f"{jroot}/{lbl}")
    assert TDS.count_positives(f"{troot}/{lbl}") == \
        JDS.count_positives(f"{jroot}/{lbl}")
    lab = np.array([[1, .1, .2, .3, .4, .5, .6, .7, .8],
                    [1, .10001, .2, .3, .4, .5, .6, .7, .8],
                    [2, .1, .2, .3, .4, .5, .6, .7, .8]])
    np.testing.assert_array_equal(TDS._dedup4(lab), JDS._dedup4(lab))


def test_4ch_tiffs_match_jax_up_to_the_exp_ulp(built, tmp_path):
    """Both packages convert the same eight val tiles; the port on the CPU
    (plain EDT versions). RGB pages equal; the DT-Edge page within one level
    on at most 1 in 1000 pixels (PERF.md: 53 of 692,224 at 416)."""
    jroot = built["jax"][0]
    src = tmp_path / "src"
    src.mkdir()
    tiles = sorted(os.listdir(f"{jroot}/cropped{TS}/images/val"))[:8]
    for f in tiles:
        os.link(f"{jroot}/cropped{TS}/images/val/{f}", src / f)
    jout = JDS.convert_folder_to_4ch_tiff(str(src), str(tmp_path / "j"))
    tout = TDS.convert_folder_to_4ch_tiff(str(src), str(tmp_path / "t"),
                                          device="cpu")
    assert [os.path.basename(p) for p in jout] == \
        [os.path.basename(p) for p in tout]
    differ = total = 0
    for jp, tp in zip(jout, tout):
        ja = np.stack(cv2.imreadmulti(jp, flags=cv2.IMREAD_GRAYSCALE)[1])
        tb = np.stack(cv2.imreadmulti(tp, flags=cv2.IMREAD_GRAYSCALE)[1])
        assert ja.shape == tb.shape == (4, TS, TS)
        np.testing.assert_array_equal(tb[:3], ja[:3])
        d = np.abs(tb[3].astype(int) - ja[3].astype(int))
        assert d.max() <= 1
        differ += int((d > 0).sum())
        total += d.size
    assert differ <= total // 1000, (differ, total)

    bgr = np.stack([cv2.imread(str(src / f)) for f in tiles])
    core = TDS.tiles_to_4ch(torch.from_numpy(bgr)).numpy()
    for c, tp in zip(core, tout):
        np.testing.assert_array_equal(
            c, np.stack(cv2.imreadmulti(tp, flags=cv2.IMREAD_GRAYSCALE)[1]))

    TDS.mirror_labels_by_stem(f"{jroot}/cropped{TS}/labels/val",
                              str(tmp_path / "tl"),
                              [os.path.splitext(f)[0] for f in tiles])
    assert sorted(os.listdir(tmp_path / "tl")) == \
        sorted(os.path.splitext(f)[0] + ".txt" for f in tiles)


def test_label_writer_text_equal(tmp_path):
    from oriented_object_detection_tpu.data import labels as JL

    rows = np.array([[3, 0.125, 1 / 3, 1.0, 0.0, 0.5, 0.25, 2 / 7, 0.9],
                     [11, 1e-9, 0.999999999, 0, 1, 0.1, 0.2, 0.3, 0.4]])
    for name, rs in (("a", rows), ("empty", np.zeros((0, 9)))):
        JL.write_labels(str(tmp_path / f"j{name}.txt"), rs)
        TL.write_labels(str(tmp_path / f"t{name}.txt"), rs)
        assert (tmp_path / f"j{name}.txt").read_bytes() == \
            (tmp_path / f"t{name}.txt").read_bytes()
    np.testing.assert_array_equal(TL.read_labels(str(tmp_path / "ta.txt")),
                                  rows)


def test_data_yaml_matches_jax(tmp_path):
    pytest.importorskip("yaml")
    p = tmp_path / "data.yaml"
    p.write_text("path: /data/GeoMap\ntrain: train.txt\nval: /abs/val.txt\n"
                 "channels: 4\nnames:\n  0: Landslide 1\n  1: Strike\n")
    got, ref = TY.load_data_yaml(str(p)), JY.load_data_yaml(str(p))
    assert vars(got) == vars(ref)
    assert (got.nc, got.train_list(), got.val_list()) == \
        (ref.nc, ref.train_list(), ref.val_list())
