"""The port's box geometry and tiling (ops/geometry.py, ops/tiling.py)
against the JAX package's on the same float32 inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oriented_object_detection_tpu.ops import geometry as JG
from oriented_object_detection_tpu.ops import tiling as JT
from oriented_object_detection_tpu_torch.ops import geometry as TG
from oriented_object_detection_tpu_torch.ops import tiling as TT


def _boxes(n=64, seed=0):
    rng = np.random.RandomState(seed)
    b = np.stack([rng.uniform(0, 400, n), rng.uniform(0, 400, n),
                  rng.uniform(4, 60, n), rng.uniform(4, 40, n),
                  rng.uniform(-np.pi / 4, 3 * np.pi / 4, n)], -1)
    return b.astype(np.float32)


def _jax32(fn, *args):
    with jax.enable_x64(False):
        return np.array(fn(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("name", ["xywhr_to_corners8", "corners8_to_xywhr",
                                  "box_center", "strike_angle"])
def test_converters_match_jax(name):
    b = _boxes()
    x = b if name == "xywhr_to_corners8" else _jax32(
        JG.xywhr_to_corners8, b)
    ref = _jax32(getattr(JG, name), x)
    got = getattr(TG, name)(torch.from_numpy(x)).numpy()
    assert got.dtype == ref.dtype == np.float32
    atol = 1e-3 if name == "strike_angle" else 1e-4   # degrees / px
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=atol)


def test_probiou_matrix_matches_jax():
    b = _boxes(48, 1)
    b[:8] = b[8:16] + np.float32(0.5)     # close pairs, high ProbIoU
    b[16, 2:4] = 0.0                      # degenerate box
    ref = _jax32(JG.probiou_matrix, b, b)
    got = TG.probiou_matrix(torch.from_numpy(b), torch.from_numpy(b)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_probiou_degenerate_box_has_finite_gradient():
    b = torch.tensor([[10.0, 10.0, 0.0, 0.0, 0.0]], requires_grad=True)
    c = torch.tensor([[12.0, 11.0, 5.0, 3.0, 0.3]])
    TG.probiou(b, c).sum().backward()
    assert torch.isfinite(b.grad).all()


@pytest.mark.parametrize("hw", [(740, 740), (1024, 1024), (300, 500),
                                (416, 417)])
def test_inference_grid_equal(hw):
    np.testing.assert_array_equal(TT.inference_tile_grid(*hw, 416, 100),
                                  JT.inference_tile_grid(*hw, 416, 100))


def test_extract_tiles_equal_with_pad():
    rng = np.random.RandomState(3)
    img = rng.randint(0, 255, (300, 500, 3)).astype(np.uint8)
    grid = JT.inference_tile_grid(300, 500, 128, 30)
    ref = np.asarray(JT.extract_tiles(jnp.asarray(img),
                                      jnp.asarray(grid[:, :2]), 128))
    got = TT.extract_tiles(torch.from_numpy(img), grid, 128).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[-1, -1, -1] == TT.PAD_VALUE).all()


def test_stitch_and_border_mask_equal():
    rng = np.random.RandomState(4)
    grid = JT.inference_tile_grid(740, 740, 416, 100)
    c8 = rng.uniform(-5, 420, (len(grid), 10, 8)).astype(np.float32)
    ref = np.asarray(JT.stitch_to_global(jnp.asarray(c8),
                                         jnp.asarray(grid[:, :2])))
    got = TT.stitch_to_global(torch.from_numpy(c8),
                              torch.from_numpy(grid[:, :2]))
    np.testing.assert_array_equal(got.numpy(), ref)
    cen = TG.box_center(got)
    mj = np.asarray(JT.border_keep_mask(jnp.asarray(cen.numpy()),
                                        jnp.asarray(grid), 20.0))
    mt = TT.border_keep_mask(cen, torch.from_numpy(grid), 20.0).numpy()
    np.testing.assert_array_equal(mt, mj)
    assert mt.any() and not mt.all()
    assert TT.margin_for(416) == JT.margin_for(416) == 20
    assert TT.margin_for(128) == JT.margin_for(128) == 10
