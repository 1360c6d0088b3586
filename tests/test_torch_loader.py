"""The port's training loader against the JAX package's: from the same list
file and the same seed, the batches (images, labels, boxes, masks) are equal
bit for bit, with mosaic on, off and mixed, over two batches, without
augmentation, and for 4-channel tiles; the port's mosaic on the tensor
device equals its numpy mirror."""

import os

import jax
import numpy as np
import pytest
import torch

from oriented_object_detection_tpu.data import loader as JLD
from oriented_object_detection_tpu_torch.data import dataset as TDS
from oriented_object_detection_tpu_torch.data import labels as TL
from oriented_object_detection_tpu_torch.data import loader as TLD
from torch_parity import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")
TS = 64


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    """A 3-channel tile list from the dataset build of one seeded map, and a
    4-channel list of seeded random multipage tiffs."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tools.train_synthetic import gen_map

    root = tmp_path_factory.mktemp("tiles")
    rng = np.random.RandomState(5)
    img, lab = gen_map(rng, H=224, W=224, n_obj=14)
    os.makedirs(root / "images/train")
    os.makedirs(root / "labels/train")
    cv2.imwrite(str(root / "images/train/m.png"), img)
    TL.write_labels(str(root / "labels/train/m.txt"), lab)
    TDS.build_train_tiles(str(root / "images/train"),
                          str(root / "labels/train"),
                          str(root / "crop/images/train"),
                          str(root / "crop/labels/train"),
                          str(root / "train3.txt"), TS, 32)
    paths4 = []
    os.makedirs(root / "c4/images/train")
    os.makedirs(root / "c4/labels/train")
    for k in range(8):
        pages = rng.randint(0, 256, (4, TS, TS)).astype(np.uint8)
        p = str(root / f"c4/images/train/t{k}.tiff")
        assert cv2.imwritemulti(p, list(pages))
        cx, cy = rng.uniform(0.3, 0.7, 2)
        TL.write_labels(str(root / f"c4/labels/train/t{k}.txt"), np.array(
            [[k % 12, cx + .2, cy - .1, cx + .2, cy + .1, cx - .2, cy + .1,
              cx - .2, cy - .1]]))
        paths4.append(p)
    with open(root / "train4.txt", "w") as f:
        f.write("\n".join(paths4) + "\n")
    return {3: str(root / "train3.txt"), 4: str(root / "train4.txt")}


def _jax_batches(path, channels, n, **kw):
    ds = JLD.TileDataset(path, TS, channels)
    with jax.enable_x64(False):
        it = ds.batches(4, np.random.RandomState(11), device_mosaic=False,
                        **kw)
        return [{k: np.asarray(v) for k, v in b.items()}
                for _, b in zip(range(n), it)]


def _port_batches(path, channels, n, **kw):
    ds = TLD.TileDataset(path, TS, channels, device="cpu")
    it = ds.batches(4, np.random.RandomState(11), **kw)
    return [{k: v.numpy() for k, v in b.items()} for _, b in zip(range(n), it)]


@pytest.mark.parametrize("channels,kw", [
    (3, {"mosaic_p": 1.0}),
    (3, {"mosaic_p": 0.0}),
    (3, {"mosaic_p": 0.5}),
    (3, {"augment": False}),
    (4, {"mosaic_p": 1.0}),
], ids=["mosaic", "no_mosaic", "mixed", "no_augment", "4ch_mosaic"])
def test_batches_bit_equal_to_jax(lists, channels, kw):
    ref = _jax_batches(lists[channels], channels, 2, **kw)
    got = _port_batches(lists[channels], channels, 2, **kw)
    assert len(ref) == len(got) == 2
    for r, g in zip(ref, got):
        assert g["images"].shape == (4, channels, TS, TS)
        np.testing.assert_array_equal(g["images"].transpose(0, 2, 3, 1),
                                      r["images"])
        np.testing.assert_array_equal(g["gt_labels"], r["gt_labels"])
        np.testing.assert_array_equal(g["gt_xywhr"], r["gt_xywhr"])
        np.testing.assert_array_equal(g["gt_mask"], r["gt_mask"])
    assert any(r["gt_mask"].any() for r in ref)


def test_device_mosaic_equals_numpy_mirror(lists):
    ds = TLD.TileDataset(lists[3], TS, 3, device="cpu")
    rng = np.random.RandomState(2)
    params = [ds.mosaic_params(i, rng) for i in range(5)]
    tidx = torch.tensor([p[0] for p in params])
    tabs = np.stack([np.stack(TLD.W.affine_deltas(TLD.W.invert_affine(
        np.array([[p[3], 0, p[4]], [0, p[3], p[5]]])), TS, TS))
        for p in params])
    got = ds._mosaic_device(ds.tile_cache()[tidx],
                            torch.tensor([p[1] for p in params]),
                            torch.tensor([p[2] for p in params]),
                            torch.from_numpy(tabs)).numpy()
    for g, p in zip(got, params):
        np.testing.assert_array_equal(g, ds.mosaic_pixels_host(p))


def test_mosaic_schedule_and_label_paths_match_jax(tmp_path):
    for total in (1, 5, 10, 15):
        for close in (0, 3, 10):
            for e in range(total):
                assert TLD.mosaic_p_for_epoch(e, total, close) == \
                    JLD.mosaic_p_for_epoch(e, total, close)
    os.makedirs(tmp_path / "images/x")
    os.makedirs(tmp_path / "labels/x")
    (tmp_path / "labels/x/a.txt").write_text("")
    for p in (str(tmp_path / "images/x/a.jpg"),
              str(tmp_path / "images/x/b.jpg")):
        assert TLD.label_path_for_tile(p) == JLD.label_path_for_tile(p)
