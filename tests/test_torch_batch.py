"""The port's multi-map detection (infer/pipeline.py: ``detect_images``,
``detect_stream``) with the committed 4-channel ``train416_4ch.ckpt``
(YOLO11n-OBB) on three synthetic maps of different shapes: against the
JAX package's ``detect_images`` and against the port's per-map
``detect_image``; the stage names of ``utils/profiling.py``; and the CLI's
``--batch``, ``--stream`` and ``--chunk`` against its per-map path."""

import dataclasses
import os
import sys

import numpy as np
import pytest

from oriented_object_detection_tpu.config import PRESETS as JAX_PRESETS
from oriented_object_detection_tpu.config import ScaleConfig as JaxScale
from oriented_object_detection_tpu.infer.pipeline import (
    TiledDetector as JaxDetector)
from oriented_object_detection_tpu.train.trainer import (
    variables_from_checkpoint as jax_variables)
from oriented_object_detection_tpu.utils.xlsx import read_xlsx
from oriented_object_detection_tpu_torch import cli
from oriented_object_detection_tpu_torch.infer import pipeline as P
from oriented_object_detection_tpu_torch.utils import profiling as prof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "bench_ckpts", "train416_4ch.ckpt")
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
from tools.train_synthetic import gen_map  # noqa: E402
from torch_parity import (  # noqa: E402,F401
    match_one_to_one, one_torch_thread, port_float32)

cv2 = pytest.importorskip("cv2")
SHAPES = ((300, 500), (420, 300), (316, 316))   # 2, 2 and 1 tiles


@pytest.fixture(scope="module")
def maps():
    return [gen_map(np.random.RandomState(10 + i), H=h, W=w, n_obj=12)[0]
            for i, (h, w) in enumerate(SHAPES)]


@pytest.fixture(scope="module")
def detector():
    return P.build_detector([(416, 100, CKPT)], channels=4, device="cpu",
                            compute_dtype="float32")


@pytest.fixture(scope="module")
def batched(detector, maps):
    prof.reset()
    return detector.detect_images(maps)


def _close(got: np.ndarray, ref: np.ndarray, conf: float = 1e-5,
           px: float = 1e-3) -> None:
    """Rows in the same order: same class, conf within ``conf``, corners
    within ``px``."""
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[:, 8], ref[:, 8])
    np.testing.assert_allclose(got[:, 9], ref[:, 9], rtol=0, atol=conf)
    np.testing.assert_allclose(got[:, :8], ref[:, :8], rtol=0, atol=px)


def test_detect_images_matches_jax(maps, batched):
    cfg = dataclasses.replace(
        JAX_PRESETS["detect_416_4ch"], compute_dtype="float32",
        max_det_per_map=1 << 20,
        scales=(JaxScale(416, 100, model_scale="n"),))
    ref = JaxDetector(cfg, {416: jax_variables(CKPT)}).detect_images(maps)
    assert len(batched) == len(ref) == len(maps)
    for got, want in zip(batched, ref):
        assert len(got["merged_for_pr"]) >= 5
        match_one_to_one(got["merged_for_pr"], want["merged_for_pr"])
        match_one_to_one(got["by_scale"][416], want["by_scale"][416])


def test_detect_images_equals_detect_image_per_map(detector, maps, batched):
    """One batch over every map's tiles gives each map's rows: the same
    rows in the same order, conf within 1e-5 (the CPU's convolutions sum
    a batch of another size in another order)."""
    for img, got in zip(maps, batched):
        one = detector.detect_image(img)
        assert set(one) == set(got) == {"by_scale", "merged_for_pr"}
        _close(got["merged_for_pr"], one["merged_for_pr"])
        _close(got["by_scale"][416], one["by_scale"][416])


def test_detect_images_in_tile_chunks(detector, maps, batched, monkeypatch):
    """Forward chunks of three tiles, the second one spanning two maps,
    give the rows of one forward over all five tiles: the same rows in the
    same order, conf within 1e-5 (another batch size on the CPU)."""
    monkeypatch.setattr(P, "TILE_PIXELS_PER_FORWARD", 3 * 416 * 416)
    for got, want in zip(detector.detect_images(maps), batched):
        _close(got["merged_for_pr"], want["merged_for_pr"])
        _close(got["by_scale"][416], want["by_scale"][416])


def test_detect_stream_equals_detect_images_per_group(detector, maps):
    """Groups of two maps in input order, each group's rows those of
    ``detect_images`` over that group, bit for bit."""
    stream = list(detector.detect_stream(maps, chunk=2))
    ref = detector.detect_images(maps[:2]) + detector.detect_images(maps[2:])
    assert len(stream) == len(maps)
    for got, want in zip(stream, ref):
        np.testing.assert_array_equal(got["merged_for_pr"],
                                      want["merged_for_pr"])
        np.testing.assert_array_equal(got["by_scale"][416],
                                      want["by_scale"][416])
    assert list(detector.detect_stream([], chunk=2)) == []
    assert detector.detect_images([]) == []


def test_profiling_records_the_stage_names(batched):
    rep = prof.report()
    assert set(rep) == {"detect/h2d", "detect/dispatch", "detect/fetch",
                        "detect/merge_416", "detect/fusion"}
    assert all(v["calls"] >= 1 and v["total_s"] >= 0 for v in rep.values())
    prof.enable(False)
    try:
        prof.reset()
        with prof.timed("x"):
            pass
        assert prof.report() == {}
    finally:
        prof.enable(True)


@pytest.fixture(scope="module")
def mapdir(tmp_path_factory, maps):
    """The maps as files, and the per-map CLI path's outputs."""
    root = tmp_path_factory.mktemp("cli")
    (root / "in").mkdir()
    for i, img in enumerate(maps):
        cv2.imwrite(str(root / "in" / f"map{i}.png"), img)
    with port_float32():
        cli.main(_detect_argv(root) + ["--output", str(root / "one")])
    return root


def _detect_argv(root) -> list:
    return ["detect", "--input", str(root / "in"), "--ckpt416", CKPT,
            "--channels", "4", "--device", "cpu"]


@pytest.mark.parametrize("flags", [["--batch"], ["--stream"],
                                   ["--chunk", "2"]],
                         ids=["batch", "stream", "chunk2"])
def test_cli_modes_write_the_per_map_outputs(mapdir, maps, flags, capsys):
    """The same files as the per-map path: every map's xlsx holds rows
    within 1e-5 conf of the per-map path's, and its jpg is written."""
    out = mapdir / flags[-1].strip("-")
    with port_float32():
        cli.main(_detect_argv(mapdir) + ["--output", str(out)] + flags)
    assert capsys.readouterr().out.count("Results saved for") == len(maps)
    for i in range(len(maps)):
        a, b = (np.asarray([r[1:] for r in read_xlsx(
            str(d / f"map{i}.xlsx"))[1:]], np.float64)
            for d in (mapdir / "one", out))
        assert a.shape == b.shape and len(a) > 0
        np.testing.assert_allclose(b[:, 8], a[:, 8], rtol=0, atol=1e-5)
        np.testing.assert_allclose(b[:, :8], a[:, :8], rtol=0, atol=1e-3)
        assert (out / f"map{i}_detected.jpg").exists()
