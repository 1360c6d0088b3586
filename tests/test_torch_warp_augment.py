"""The port's fixed-point affine warp and its augmentation ops against the
JAX package's on the same seeded inputs: uint8 results bit-equal (the warp's
numpy mirror, the general and the axis-aligned tensor warps; the HSV round
trip and jitter as the JAX loader compiles them), the flips exact and the
label scalers within float64 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oriented_object_detection_tpu.ops import augment as JA
from oriented_object_detection_tpu.ops import warp as JW
from oriented_object_detection_tpu_torch.ops import augment as TA
from oriented_object_detection_tpu_torch.ops import warp as TW

AFFINES = {
    "shrink": np.array([[0.6, 0.0, -20.3], [0.0, 0.6, 13.1]]),
    "grow": np.array([[1.45, 0.0, -51.5], [0.0, 1.45, -30.25]]),
    "identity": np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]),
    "rotate_shear": np.array([[0.9, 0.2, 3.0], [-0.3, 1.1, -4.0]]),
}


def _img(seed, shape=(37, 41, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("name", sorted(AFFINES))
def test_warp_bit_equal_to_jax(name):
    M = AFFINES[name]
    img = _img(0)
    border = (114, 114, 114)
    Minv = TW.invert_affine(M)
    np.testing.assert_array_equal(Minv, JW.invert_affine(M))
    tabs = TW.affine_deltas(Minv, 29, 33)
    for a, b in zip(tabs, JW.affine_deltas(Minv, 29, 33)):
        np.testing.assert_array_equal(a, b)
    ref = JW.warp_affine_u8_np(img, Minv, 29, 33, border)
    np.testing.assert_array_equal(
        TW.warp_affine_u8_np(img, Minv, 29, 33, border), ref)
    got = TW.warp_affine_u8(torch.from_numpy(img),
                            *[torch.from_numpy(t) for t in tabs], border)
    np.testing.assert_array_equal(got.numpy(), ref)
    jdev = JW.warp_affine_u8_dev(jnp.asarray(img),
                                 *[jnp.asarray(t) for t in tabs], border)
    np.testing.assert_array_equal(np.asarray(jdev), ref)
    if M[0, 1] == 0 and M[1, 0] == 0:
        ad, _, X0, Y0 = (torch.from_numpy(t)[None] for t in tabs)
        fast = TW.warp_axis_aligned_u8(torch.from_numpy(img)[None], ad, X0,
                                       Y0, border)[0]
        np.testing.assert_array_equal(fast.numpy(), ref)


def test_axis_aligned_warp_batched_per_sample():
    """Each sample of a batch warps with its own tables, as one at a time."""
    imgs = np.stack([_img(s, (24, 24, 4)) for s in range(3)])
    tabs = [TW.affine_deltas(TW.invert_affine(AFFINES[k]), 24, 24)
            for k in ("shrink", "grow", "identity")]
    ad, X0, Y0 = (torch.from_numpy(np.stack([t[i] for t in tabs]))
                  for i in (0, 2, 3))
    got = TW.warp_axis_aligned_u8(torch.from_numpy(imgs), ad, X0, Y0,
                                  (114,) * 4).numpy()
    for k, name in enumerate(("shrink", "grow", "identity")):
        np.testing.assert_array_equal(got[k], JW.warp_affine_u8_np(
            imgs[k], TW.invert_affine(AFFINES[name]), 24, 24, (114,) * 4))


def test_hsv_round_trip_bit_equal_to_jax():
    img = _img(1, (4, 16, 16, 3)).astype(np.float32)
    img[0, :4] = 10.0                    # grays: diff == 0
    img[1, :3] = [255.0, 0.0, 0.0]       # pure hues
    img[2, :2] = 0.0                     # black: v == 0
    with jax.enable_x64(False):
        jh = jax.jit(JA.bgr_to_hsv_u8)(img)
        jb = np.asarray(jax.jit(JA.hsv_to_bgr_u8)(jh))
    th = TA.bgr_to_hsv_u8(torch.from_numpy(img))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(
        TA.hsv_to_bgr_u8(torch.from_numpy(np.asarray(jh))).numpy(), jb)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hsv_jitter_bit_equal_to_the_jax_loader(seed):
    """Per-sample gains, then /255, compiled as the JAX loader compiles
    them: XLA multiplies by the float32 reciprocals."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (6, 24, 24, 3)).astype(np.float32)
    sg = np.maximum(1 + rng.uniform(-1, 1, 6) * 0.7, 0).astype(np.float32)
    vg = np.maximum(1 + rng.uniform(-1, 1, 6) * 0.4, 0).astype(np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(jax.jit(
            lambda x, s, v: JA.hsv_jitter(x, s[:, None, None],
                                          v[:, None, None]) / 255.0)(
            img, sg, vg))
    got = TA.hsv_jitter(torch.from_numpy(img),
                        torch.from_numpy(sg)[:, None, None],
                        torch.from_numpy(vg)[:, None, None]) * TA.INV_255
    np.testing.assert_array_equal(got.numpy(), ref)


def test_flips_match_jax():
    img = _img(2, (2, 8, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TA.fliplr_image(torch.from_numpy(img)).numpy(),
        np.asarray(JA.fliplr_image(jnp.asarray(img))))
    c8 = np.random.RandomState(3).uniform(0, 50, (5, 8))
    np.testing.assert_array_equal(
        TA.fliplr_corners8(torch.from_numpy(c8), 64.0).numpy(),
        np.asarray(JA.fliplr_corners8(jnp.asarray(c8), 64.0)))


def test_label_scalers_match_jax():
    rng = np.random.RandomState(4)
    lab = np.concatenate([rng.randint(0, 12, (7, 1)), rng.rand(7, 8)], 1)
    got, size = TA.scale_labels_norm(torch.from_numpy(lab), 101, 67)
    ref, ref_size = JA.scale_labels_norm(jnp.asarray(lab), 101, 67)
    assert size == ref_size
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-15)
    got = TA.shift_labels_norm(torch.from_numpy(lab), 101, 67, -13, 9)
    ref = JA.shift_labels_norm(jnp.asarray(lab), 101, 67, -13, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-15)
