"""The port's Otsu binarization of DT-Edge (ops/dtedge.py) and its image
ops (ops/image.py: ``letterbox``, ``elastic_remap``) against the JAX
package's on seeded inputs, the JAX side in float32."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oriented_object_detection_tpu.config import DTEdgeConfig as JaxDTCfg
from oriented_object_detection_tpu.ops import dtedge as JDT
from oriented_object_detection_tpu.ops import image as JIM
from oriented_object_detection_tpu_torch.config import DTEdgeConfig
from oriented_object_detection_tpu_torch.ops import dtedge as TDT
from oriented_object_detection_tpu_torch.ops import image as TIM

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_parity import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.train_synthetic import gen_map  # noqa: E402

pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def tiles():
    rng = np.random.RandomState(2)
    return np.stack([gen_map(rng, H=416, W=416, n_obj=20)[0]
                     for _ in range(3)])


@pytest.fixture(scope="module")
def scharr(tiles):
    """Seeded Scharr magnitude maps [4, 416, 416] float32: three tiles of
    synthetic maps and one of noise."""
    noise = np.random.RandomState(3).randint(0, 256, (1, 416, 416, 3),
                                             ).astype(np.uint8)
    bgr = jnp.asarray(np.concatenate([tiles, noise]))
    with jax.enable_x64(False):
        return np.array(JDT.multi_scale_scharr(JDT.bgr_to_gray_u8(bgr),
                                               JaxDTCfg().sigmas))


def test_config_fields_follow_the_jax_order():
    import dataclasses

    names = [f.name for f in dataclasses.fields(DTEdgeConfig)]
    assert names == [f.name for f in dataclasses.fields(JaxDTCfg)]
    assert DTEdgeConfig().bin_method == "percentile"
    assert DTEdgeConfig().p_lo == 65


def test_otsu_masks_equal_jax(scharr):
    """The same threshold on each map, so the same mask; these maps'
    level sums stay below 2**24 (``test_otsu_above_2_24_matches_jax``
    covers the range above)."""
    mn = scharr.min(axis=(1, 2), keepdims=True)
    a8 = np.round((scharr - mn) / (scharr.max(axis=(1, 2), keepdims=True)
                                   - mn) * 255.0)
    assert a8.sum(axis=(1, 2)).max() < 2 ** 24
    with jax.enable_x64(False):
        ref = np.asarray(JDT.binarize_otsu(jnp.asarray(scharr)))
    got = TDT.binarize_otsu(torch.from_numpy(scharr)).numpy()
    assert 0 < got.sum() < got.size
    np.testing.assert_array_equal(got, ref)


def _otsu_levels(w0: np.ndarray, m0: np.ndarray) -> np.ndarray:
    """Otsu's level of each row of cumulative counts and level sums."""
    w0, m0 = w0.astype(np.float32), m0.astype(np.float32)
    w1 = w0[:, -1:] - w0
    mu0 = m0 / np.maximum(w0, np.float32(1))
    mu1 = (m0[:, -1:] - m0) / np.maximum(w1, np.float32(1))
    return np.argmax(w0 * w1 * (mu0 - mu1) ** 2, axis=1)


def test_otsu_above_2_24_matches_jax():
    """Level maps whose level sums pass 2**24, where JAX's float32
    cumulative sums round: bright two-mode histograms drawn from a seed,
    kept where the float32 sums move the threshold off the exactly summed
    one. On each, the exact threshold's mask differs from JAX's, and the
    port's (float32, in XLA's order) equals it."""
    rng = np.random.RandomState(1000)
    bins = np.arange(256)
    n_px = 416 * 416
    hists = []
    for _ in range(2000):
        p = (np.exp(-0.5 * ((bins - rng.uniform(60, 200))
                            / rng.uniform(5, 60)) ** 2)
             + rng.uniform(0.2, 1) * np.exp(
                 -0.5 * ((bins - rng.uniform(150, 250))
                         / rng.uniform(5, 40)) ** 2))
        hists.append(rng.multinomial(n_px - 2, p / p.sum()))
    hists = np.array(hists)
    hists[:, 0] += 1      # levels 0 and 255 present: the min-max
    hists[:, 255] += 1    # normalization keeps every level
    exact = _otsu_levels(np.cumsum(hists, 1), np.cumsum(hists * bins, 1))
    h32 = torch.from_numpy(hists.astype(np.float32))
    f32 = _otsu_levels(TDT._cumsum_256_f32(h32).numpy(),
                       TDT._cumsum_256_f32(h32 * torch.arange(256.0)).numpy())
    moved = np.nonzero(exact != f32)[0][:2]
    assert len(moved) == 2
    acc = np.stack([rng.permutation(np.repeat(bins, hists[i]))
                    .reshape(416, 416) for i in moved]).astype(np.float32)
    assert (acc.sum(axis=(1, 2)) > 2 ** 24).all()
    with jax.enable_x64(False):
        ref = np.asarray(JDT.binarize_otsu(jnp.asarray(acc)))
    for k, i in enumerate(moved):
        assert not np.array_equal(ref[k], acc[k] > exact[i])
    got = TDT.binarize_otsu(torch.from_numpy(acc)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_otsu_ties_take_the_first_level():
    """Two levels only: every threshold between them gives the same
    between-class variance, and the first one (0) wins."""
    acc = np.zeros((2, 20, 30), np.float32)
    acc[:, ::3] = 7.0
    acc[1, 0, 0] = 3.5
    with jax.enable_x64(False):
        ref = np.asarray(JDT.binarize_otsu(jnp.asarray(acc)))
    got = TDT.binarize_otsu(torch.from_numpy(acc)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0], acc[0] > 0)


def test_dt_edge_channel_otsu_matches_jax(tiles):
    """Within one level, on at most the share of pixels that the last-ulp
    ``exp`` difference moves on the percentile path (0.1%)."""
    with jax.enable_x64(False):
        ref = np.asarray(JDT.dt_edge_channel(
            jnp.asarray(tiles), JaxDTCfg(bin_method="otsu")))
    got = TDT.dt_edge_channel(torch.from_numpy(tiles),
                              DTEdgeConfig(bin_method="otsu")).numpy()
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    print(f"Otsu DT-Edge pixels one level apart: {int((diff > 0).sum())} "
          f"of {diff.size}")
    assert diff.max() <= 1
    assert (diff > 0).sum() <= 0.001 * diff.size
    # and Otsu is not the percentile map
    assert not np.array_equal(got, TDT.dt_edge_channel(
        torch.from_numpy(tiles)).numpy())


@pytest.mark.parametrize("shape, size", [((700, 500), 416),
                                         ((300, 260), 416)],
                         ids=["downscale", "upscale"])
def test_letterbox_matches_jax(shape, size):
    """Equal ratio and pad; pixels within 1e-3 of 255. The JAX side runs
    as the tests run it, in 64-bit mode, so its resize weights are
    computed in float64 and rounded once to float32, as the port's are
    (in 32-bit mode XLA's compiled weight arithmetic moves them by up to
    3e-5: ``ROADMAP.md`` section 3)."""
    img = np.random.RandomState(4).randint(0, 256, (*shape, 4)).astype(
        np.float32)
    ref, r_ref, pad_ref = JIM.letterbox(jnp.asarray(img), size)
    got, r, pad = TIM.letterbox(torch.from_numpy(img), size)
    assert r == r_ref and pad == pad_ref
    assert tuple(got.shape) == (size, size, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-3)
    with jax.enable_x64(False):
        ref32 = np.asarray(JIM.letterbox(jnp.asarray(img), size)[0])
    d32 = float(np.abs(got.numpy() - ref32).max())
    print(f"letterbox {shape}: {d32} of 255 from JAX in 32-bit mode")
    assert d32 < 1e-2


def test_elastic_remap_with_jax_draws():
    img = np.random.RandomState(5).randint(0, 256, (96, 80, 3)).astype(
        np.uint8)
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(False):
        ref = np.asarray(JIM.elastic_transform(jnp.asarray(img), key,
                                               alpha=8.0, sigma=2.0))
        k1, k2 = jax.random.split(key)
        dx, dy = (np.array(jax.random.uniform(k, (96, 80), minval=-1.0,
                                              maxval=1.0))
                  for k in (k1, k2))
    got = TIM.elastic_remap(torch.from_numpy(img), torch.from_numpy(dx),
                            torch.from_numpy(dy), 8.0, 2.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


def test_elastic_transform_is_seeded_by_its_generator():
    img = torch.from_numpy(np.random.RandomState(6).randint(
        0, 256, (40, 50, 3)).astype(np.uint8))
    a, b, c = (TIM.elastic_transform(img, torch.Generator().manual_seed(s))
               for s in (1, 1, 2))
    assert tuple(a.shape) == (40, 50, 3) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
