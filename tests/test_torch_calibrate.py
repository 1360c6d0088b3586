"""Random initialization of a detect scale and its density calibration
(models/calibrate.py) against the JAX package's, and the CLI's
``--allow-random`` rules."""

import math
import os
import sys

import jax
import numpy as np
import pytest

from oriented_object_detection_tpu.models import YOLO11OBB as JaxYOLO
from oriented_object_detection_tpu.models import calibrate as JC
from oriented_object_detection_tpu.models.yolo11_obb import (
    STRIDES as JAX_STRIDES)
from oriented_object_detection_tpu_torch import cli
from oriented_object_detection_tpu_torch.config import (DetectConfig,
                                                        ScaleConfig)
from oriented_object_detection_tpu_torch.infer import pipeline as P
from oriented_object_detection_tpu_torch.models import calibrate as TC
from oriented_object_detection_tpu_torch.models.yolo11_obb import YOLO11OBB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, REPO)
from tools.train_synthetic import gen_map  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def variables():
    return P.random_variables(12, "n", 3, seed=0)


def _head_biases(variables, branch: str) -> list:
    head = variables["params"]["l23"]
    return [head[f"{branch}_{i}_2"]["bias"] for i in range(len(JAX_STRIDES))]


def test_random_init_follows_the_engine_bias_rule(variables):
    """Box biases 1.0, class biases log(5 / nc / (640 / stride)^2), the
    rule of the JAX package's ``OBBHead``; and the init is seeded."""
    for b in _head_biases(variables, "cv2"):
        np.testing.assert_array_equal(b, np.ones(64, np.float32))
    for b, s in zip(_head_biases(variables, "cv3"), JAX_STRIDES):
        np.testing.assert_allclose(b, math.log(5.0 / 12 / (640.0 / s) ** 2),
                                   rtol=1e-6)
    again = P.random_variables(12, "n", 3, seed=0)
    other = P.random_variables(12, "n", 3, seed=1)
    k = variables["params"]["l0"]["conv"]["kernel"]
    np.testing.assert_array_equal(k, again["params"]["l0"]["conv"]["kernel"])
    assert not np.array_equal(k, other["params"]["l0"]["conv"]["kernel"])


def test_random_init_follows_the_flax_kernel_rule(variables):
    """Every conv kernel lecun normal (flax's default: a normal truncated
    at two standard deviations, variance 1 / fan_in), as the JAX
    package's init draws it; every other conv bias 0."""
    kernels = [(k, v) for k, v in _leaves(variables["params"])
               if k[-1] == "kernel"]
    assert len(kernels) > 80
    fan = lambda v: int(np.prod(v.shape[:3]))
    big = [v * np.sqrt(fan(v)) for _, v in kernels if v.size >= 4096]
    std = np.concatenate([b.ravel() for b in big]).std()
    assert abs(std - 1.0) < 0.02
    for k, v in kernels:
        assert np.abs(v).max() * np.sqrt(fan(v)) <= 2.0 / 0.8796256 + 1e-4, k
    assert not variables["params"]["l23"]["cv4_0_2"]["bias"].any()


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_calibrate_density_offset_matches_jax(variables):
    """The same variables through both packages' calibration at tile 64:
    every class bias moves by one offset, within 1e-4 of the JAX one."""
    got = TC.calibrate_density(YOLO11OBB(nc=12, scale="n"), variables, 64,
                               3, device="cpu")
    with jax.enable_x64(False):
        ref = JC.calibrate_density(JaxYOLO(nc=12, scale="n", in_channels=3),
                                   variables, 64, 3)
    old = _head_biases(variables, "cv3")
    off = [g - o for g, o in zip(_head_biases(got, "cv3"), old)]
    joff = [np.asarray(r) - o for r, o in zip(_head_biases(ref, "cv3"), old)]
    assert float(off[0][0]) > 1.0          # the sparse init moves up
    for a, b in zip(off, joff):
        np.testing.assert_allclose(a, float(off[0][0]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(_head_biases(got, "cv2"),
                                  _head_biases(variables, "cv2"))


def test_calibrated_random_detector_detects(variables):
    """A calibrated random model gives rows at the predict threshold,
    where the uncalibrated one gives none."""
    img = gen_map(np.random.RandomState(4), H=200, W=220, n_obj=8)[0]
    cfg = DetectConfig(scales=(ScaleConfig(128, 30, model_scale="n"),))
    cal = TC.calibrate_density(YOLO11OBB(nc=12, scale="n"), variables, 128,
                               3, device="cpu")
    rows = [P.TiledDetector(cfg, {128: v}, device="cpu").detect_images(
        [img])[0]["by_scale"][128] for v in (variables, cal)]
    assert len(rows[0]) == 0 and len(rows[1]) > 0


@pytest.fixture()
def mapdir(tmp_path):
    (tmp_path / "in").mkdir()
    cv2.imwrite(str(tmp_path / "in" / "m.png"),
                gen_map(np.random.RandomState(5), H=120, W=140, n_obj=4)[0])
    return tmp_path


def _detect(mapdir, *flags):
    cli.main(["detect", "--input", str(mapdir / "in"), "--output",
              str(mapdir / "out"), "--scale", "n", "--device", "cpu",
              *flags])


def test_cli_refuses_a_missing_checkpoint(mapdir):
    missing = str(mapdir / "nope.ckpt")
    with pytest.raises(SystemExit, match="does not exist .pass "
                                         "--allow-random"):
        _detect(mapdir, "--ckpt128", missing)
    assert not (mapdir / "out").exists()


@pytest.mark.parametrize("flags, warning", [
    (["--ckpt128", "nope.ckpt", "--allow-random"],
     "[WARN] checkpoint nope.ckpt missing; random init (--allow-random)"),
    (["--scales", "128:30"],
     "[WARN] no checkpoint given for scale 128; random init"),
], ids=["allow_random", "no_checkpoint"])
def test_cli_random_init_warns_and_runs(mapdir, capsys, flags, warning):
    _detect(mapdir, *flags)
    assert warning in capsys.readouterr().out
    assert (mapdir / "out" / "m.xlsx").exists()
    assert (mapdir / "out" / "m_detected.jpg").exists()
