"""The JAX package's fault-tolerance behaviours (``tests/
test_fault_tolerance.py``) held on the port: each JAX function and its
port run on the same input and warn, skip and return alike.

* The dataset build skips an image it cannot read and tiles the rest.
* ``process_image`` returns ``{}`` for a path it cannot read.
* ``run_fusion_eval`` reports "No images found" for an empty folder.
"""

import os

import numpy as np
import pytest

from oriented_object_detection_tpu.data import dataset as JDS
from oriented_object_detection_tpu.data import labels as JL
from oriented_object_detection_tpu.eval import metrics as JME
from oriented_object_detection_tpu.infer import pipeline as JP
from oriented_object_detection_tpu_torch.data import dataset as TDS
from oriented_object_detection_tpu_torch.eval import metrics as TME
from oriented_object_detection_tpu_torch.infer import pipeline as TP

cv2 = pytest.importorskip("cv2")

PACKAGES = {"jax": (JDS, JP, JME), "port": (TDS, TP, TME)}


def _listing(root) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_dataset_build_skips_a_corrupt_image(tmp_path, capsys):
    """One readable image with a label and one file that is no image: both
    builds warn "cannot read: bad.png", keep going, return the same
    statistics and write the same tiles, labels and list."""
    src = tmp_path / "src"
    (src / "images").mkdir(parents=True)
    (src / "labels").mkdir()
    img = np.random.RandomState(0).randint(0, 255, (120, 120, 3), np.uint8)
    cv2.imwrite(str(src / "images" / "good.png"), img)
    (src / "images" / "bad.png").write_bytes(b"not a png")
    JL.write_labels(str(src / "labels" / "good.txt"),
                    np.array([[0, .3, .3, .5, .3, .5, .5, .3, .5]]))
    stats, outs = {}, {}
    for name, (ds, _, _) in PACKAGES.items():
        out = tmp_path / name
        stats[name] = ds.build_train_tiles(
            str(src / "images"), str(src / "labels"), str(out / "ci"),
            str(out / "cl"), str(out / "list.txt"), 100, 20)
        outs[name] = capsys.readouterr().out
        assert "[WARN] cannot read: bad.png" in outs[name], name
    for name, st in stats.items():   # the one path in them, made relative
        st["empty_meta_path"] = os.path.relpath(st["empty_meta_path"],
                                                tmp_path / name)
    assert stats["port"] == stats["jax"]
    assert stats["port"]["P_total"] >= 1
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
    for f in ("cl", "ci"):
        for rel in _listing(tmp_path / "jax" / f):
            a, b = (tmp_path / n / f / rel for n in ("jax", "port"))
            assert a.read_bytes() == b.read_bytes(), rel


@pytest.mark.parametrize("kind", ["missing", "corrupt"])
def test_process_image_returns_empty_on_an_unreadable_path(tmp_path, capsys,
                                                           kind):
    """A missing file, or one that is no image: both ``process_image``s
    warn "Could not read image", return ``{}`` and write nothing (the
    detector is never reached)."""
    path = tmp_path / "in" / "map.png"
    path.parent.mkdir()
    if kind == "corrupt":
        path.write_bytes(b"not a png")
    lines = {}
    for name, (_, pipeline, _) in PACKAGES.items():
        out = tmp_path / f"out_{name}"
        out.mkdir()
        assert pipeline.process_image(None, str(path), str(out)) == {}
        lines[name] = capsys.readouterr().out
        assert f"[Warn] Could not read image: {path}" in lines[name]
        assert not os.listdir(out)
    assert lines["port"] == lines["jax"]


def test_fusion_eval_reports_an_empty_folder(tmp_path, capsys):
    """An input folder with no image (a label file only): both
    ``run_fusion_eval``s print "No images found" and return ``{}``."""
    (tmp_path / "map.txt").write_text("0 .1 .1 .2 .1 .2 .2 .1 .2\n")
    lines = {}
    for name, (_, _, metrics) in PACKAGES.items():
        assert metrics.run_fusion_eval({}, str(tmp_path), str(tmp_path)) == {}
        lines[name] = capsys.readouterr().out
        assert "[Eval] No images found for evaluation." in lines[name]
    assert lines["port"] == lines["jax"]
