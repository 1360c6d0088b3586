"""The port's DT-Edge channel (ops/dtedge.py) against the JAX package's
``dt_edge_channel`` on 416 tiles of synthetic maps, and its steps one by
one."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oriented_object_detection_tpu.ops import dtedge as JDT
from oriented_object_detection_tpu.ops import edt as JE
from oriented_object_detection_tpu_torch.config import DTEdgeConfig
from oriented_object_detection_tpu_torch.ops import dtedge as TDT
from oriented_object_detection_tpu_torch.ops import edt as TE

pytest.importorskip("cv2")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from tools.train_synthetic import gen_map  # noqa: E402


@pytest.fixture(scope="module")
def tiles():
    rng = np.random.RandomState(1)
    return np.stack([gen_map(rng, H=416, W=416, n_obj=20)[0]
                     for _ in range(4)])


@pytest.fixture(scope="module")
def gray(tiles):
    return np.array(JDT.bgr_to_gray_u8(jnp.asarray(tiles)))


def test_dt_edge_channel_matches_jax(tiles):
    """Identical, or one level apart on at most 0.1% of pixels. Everything
    up to the exp is bit-equal (the tests below); the exp is not: XLA's CPU
    exp and PyTorch's round differently in the last ulp, which can move
    floor(255 * blend) by one level."""
    ref = np.asarray(JDT.dt_edge_channel(jnp.asarray(tiles)))
    got = TDT.dt_edge_channel(torch.from_numpy(tiles))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (4, 416, 416)
    diff = np.abs(got.numpy().astype(np.int32) - ref.astype(np.int32))
    n = int((diff > 0).sum())
    print(f"DT-Edge pixels one level apart: {n} of {diff.size}")
    assert diff.max() <= 1
    assert n <= 0.001 * diff.size


def test_gray_bit_equal(tiles, gray):
    got = TDT.bgr_to_gray_u8(torch.from_numpy(tiles)).numpy()
    np.testing.assert_array_equal(got, gray)


@pytest.mark.parametrize("sigma", [0.6, 1.2, 2.4])
def test_gaussian_blur_bit_equal(gray, sigma):
    ref = np.asarray(JDT.gaussian_blur_u8(jnp.asarray(gray), sigma))
    got = TDT.gaussian_blur_u8(torch.from_numpy(gray), sigma).numpy()
    np.testing.assert_array_equal(got, ref)


def test_multi_scale_scharr_bit_equal(gray):
    sig = DTEdgeConfig().sigmas
    ref = np.asarray(JDT.multi_scale_scharr(jnp.asarray(gray), sig))
    got = TDT.multi_scale_scharr(torch.from_numpy(gray), sig).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("qs", [(90,), (1.0, 99.0), (0.0, 65.0, 100.0)])
def test_percentile_bit_equal(qs):
    rng = np.random.RandomState(3)
    x = (np.abs(rng.randn(3, 40, 56)) * 100).astype(np.float32)
    x.flat[::7] = 0.0
    ref = np.asarray(JDT._percentile_hw(jnp.asarray(x), qs))
    got = TDT.percentile_hw(torch.from_numpy(x), qs).numpy()
    np.testing.assert_array_equal(got, ref)


def test_percentile_beyond_2_24_elements():
    """torch.quantile refuses inputs over 2^24 elements; the port's
    percentile does not."""
    x = torch.arange(1 << 24 | 5, dtype=torch.float32).reshape(1, 1, -1)
    got = TDT.percentile_hw(x, (50.0,))
    assert float(got[0, 0]) == float(np.percentile(x.numpy(), 50.0))


def test_morph_open_bit_equal():
    rng = np.random.RandomState(5)
    m = rng.rand(2, 40, 48) < 0.3
    ref = np.asarray(JDT.morph_open_cross(jnp.asarray(m)))
    got = TDT.morph_open_cross(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_edge_mask_then_edt_equals_the_channel_steps(tiles):
    """``edge_mask`` + ``edt_l2`` give what ``dt_edge_channel`` computed
    inline before the split, and the JAX package's steps."""
    t = torch.from_numpy(tiles[:2])
    cfg = DTEdgeConfig()
    gray = TDT.bgr_to_gray_u8(t)
    acc = TDT.multi_scale_scharr(gray, cfg.sigmas)
    inline = TDT.morph_open_cross(
        acc >= TDT.percentile_hw(acc, (cfg.p_hi,))[:, :, None],
        cfg.morph_open)
    edges, mag = TDT.edge_mask(t, cfg)
    np.testing.assert_array_equal(edges.numpy(), inline.numpy())
    np.testing.assert_array_equal(mag.numpy(), acc.numpy())

    jacc = JDT.multi_scale_scharr(JDT.bgr_to_gray_u8(jnp.asarray(tiles[:2])),
                                  cfg.sigmas)
    jedges = JDT.morph_open_cross(JDT.binarize_percentile(jacc, cfg.p_hi),
                                  cfg.morph_open)
    np.testing.assert_array_equal(edges.numpy(), np.asarray(jedges))
    np.testing.assert_array_equal(
        TE.edt_l2(edges).numpy(), np.asarray(JE.edt_l2(jedges)))


def test_plain_edt_gives_the_same_map(tiles):
    t = torch.from_numpy(tiles[:2])
    np.testing.assert_array_equal(
        TDT.dt_edge_channel(t).numpy(),
        TDT.dt_edge_channel(t, edt=TE.edt_l2_plain).numpy())


def test_build_multich_layout(tiles):
    t = torch.from_numpy(tiles[:2])
    x = TDT.build_multich(t, 4)
    assert tuple(x.shape) == (2, 4, 416, 416) and x.dtype == torch.float32
    np.testing.assert_array_equal(
        x[:, :3].permute(0, 2, 3, 1).numpy(), tiles[:2, ..., ::-1])
    np.testing.assert_array_equal(x[:, 3].numpy(),
                                  TDT.dt_edge_channel(t).float().numpy())
    assert tuple(TDT.build_multich(t, 3).shape) == (2, 3, 416, 416)
