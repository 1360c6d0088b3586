"""The port's exact EDT (ops/edt.py) against the JAX package's: the plain
versions of both CUDA kernels and ``edt_l2`` are bit-equal to JAX
``edt_l2`` in its XLA form and in its Pallas form (interpret mode), and to
scipy in squared space. The CUDA kernels themselves are held to these plain
versions on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oriented_object_detection_tpu.ops import edt as JE
from oriented_object_detection_tpu_torch.ops import edt as TE

scipy_nd = pytest.importorskip("scipy.ndimage")


def _masks_416():
    """[6, 416, 416] edge masks: empty, all-edge, one pixel, one column,
    sparse and dense."""
    rng = np.random.RandomState(0)
    m = np.zeros((6, 416, 416), bool)
    m[1] = True
    m[2, 300, 17] = True
    m[3, :, 200] = True
    m[4] = rng.rand(416, 416) < 0.002
    m[5] = rng.rand(416, 416) < 0.1
    return m


@pytest.fixture(scope="module")
def masks_416():
    return _masks_416()


def test_edt_l2_bit_equal_to_jax_xla(masks_416):
    ref = np.asarray(JE.edt_l2(jnp.asarray(masks_416), use_pallas=False))
    got = TE.edt_l2(torch.from_numpy(masks_416)).numpy()
    assert got.dtype == np.float32 and ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_pass1_plain_bit_equal_to_capped_jax(masks_416):
    ref = np.minimum(np.asarray(JE._edt_pass1_columns(
        jnp.asarray(masks_416))), np.float32(JE._INF))
    got = TE.edt_pass1_columns_plain(torch.from_numpy(masks_416)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_pass2_plain_bit_equal_to_jax(masks_416):
    d0 = np.asarray(JE._edt_pass1_columns(jnp.asarray(masks_416)))
    flat = d0.reshape(-1, 416)
    ref = np.asarray(JE._edt_pass2_rows_xla(jnp.asarray(flat)))
    got = TE.edt_pass2_rows_plain(torch.from_numpy(
        np.minimum(flat, np.float32(JE._INF)))).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["random", "single", "column", "halves"])
def test_edt_l2_bit_equal_to_jax_pallas_interpret(case):
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.RandomState(1)
    if case == "random":
        mask = rng.rand(2, 16, 128) < 0.05
        mask[0, 3, 40] = True
    elif case == "single":
        mask = np.zeros((1, 24, 200), bool)
        mask[0, 20, 150] = True
    elif case == "column":
        mask = np.zeros((1, 16, 130), bool)
        mask[0, :, 5] = True
    else:
        mask = np.zeros((1, 16, 256), bool)
        mask[0, :, 150:] = rng.rand(16, 106) < 0.2
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(JE.edt_l2(jnp.asarray(mask), use_pallas=True))
    got = TE.edt_l2(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_squared_distances_equal_scipy(masks_416):
    m = masks_416[1:]        # scipy has no answer for an edge-free image
    d0 = TE.edt_pass1_columns(torch.from_numpy(m))
    sq = TE.edt_pass2_rows(d0.reshape(-1, 416)).reshape(m.shape).numpy()
    for b in range(len(m)):
        ref = scipy_nd.distance_transform_edt(~m[b])
        np.testing.assert_array_equal(sq[b], np.round(ref ** 2))


def test_edge_free_image_is_capped():
    got = TE.edt_l2(torch.zeros((1, 8, 12), dtype=torch.bool)).numpy()
    np.testing.assert_array_equal(got, np.float32(1e9))


def test_uint8_mask_equals_bool_mask(masks_416):
    b = torch.from_numpy(masks_416[4:])
    np.testing.assert_array_equal(
        TE.edt_pass1_columns(b.to(torch.uint8)).numpy(),
        TE.edt_pass1_columns(b).numpy())


def test_wrappers_take_plain_versions_on_cpu(masks_416):
    m = torch.from_numpy(masks_416[3:5])
    before = dict(TE.LAUNCHES)
    np.testing.assert_array_equal(TE.edt_l2(m).numpy(),
                                  TE.edt_l2_plain(m).numpy())
    assert TE.LAUNCHES == before      # no kernel launched on the CPU


def test_sqrt_rn_is_correctly_rounded():
    """PyTorch's CPU float32 sqrt can miss by one ulp; sqrt_rn matches
    numpy's (IEEE) float32 sqrt, which XLA also gives."""
    x = np.arange(0, 2 ** 20, 7, dtype=np.float32)
    np.testing.assert_array_equal(TE.sqrt_rn(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))


def test_kernel_build_without_nvcc_raises(monkeypatch):
    """No silent fallback when the CUDA build cannot run."""
    import shutil

    if shutil.which("nvcc"):
        pytest.skip("this checks a machine without nvcc")
    TE.kernel_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        TE.kernel_library()
