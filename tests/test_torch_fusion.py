"""The port's host fusion (infer/fusion.py) and its native bindings against
the JAX package's, bit-equal on identical seeded detections: the global
merge, the cross-scale consensus filter (ties, empty scales, one scale, and
confs on the consensus thresholds), the exact quad-IoU matrix and the
multi-threshold PR matching."""

import numpy as np
import pytest

from oriented_object_detection_tpu.infer import fusion as JF
from oriented_object_detection_tpu.utils import native as jax_native
from oriented_object_detection_tpu_torch.infer import fusion as F
from oriented_object_detection_tpu_torch.utils import native


def _boxes(rng, n, cx=None, cy=None):
    """[n, 11] rectangles (x1..y4, cls, conf, 0) around the given or
    random centers, confs on a 0.05 grid (ties) that includes the
    consensus thresholds 0.25 and 0.70 themselves."""
    cx = rng.uniform(0, 300, n) if cx is None else cx
    cy = rng.uniform(0, 300, n) if cy is None else cy
    w, h = rng.uniform(8, 40, n), rng.uniform(6, 25, n)
    t = rng.uniform(0, np.pi, n)
    pts = []
    for sx, sy in ((1, 1), (1, -1), (-1, -1), (-1, 1)):
        pts += [cx + sx * w / 2 * np.cos(t) - sy * h / 2 * np.sin(t),
                cy + sx * w / 2 * np.sin(t) + sy * h / 2 * np.cos(t)]
    d = np.zeros((n, 11))
    d[:, :8] = np.stack(pts, -1)
    d[:, 8] = rng.randint(0, 3, n)
    d[:, 9] = np.round(rng.uniform(0.1, 1.0, n) * 20) / 20
    return d


def _two_scales(seed, n=120):
    """Two scales that see many of the same objects: the second holds
    jittered copies of half the first's boxes, plus boxes of its own."""
    rng = np.random.RandomState(seed)
    a = _boxes(rng, n)
    twins = a[rng.rand(n) < 0.5].copy()
    twins[:, :8] += rng.normal(0, 2.0, (len(twins), 8))
    twins[:, 9] = np.round(rng.uniform(0.1, 1.0, len(twins)) * 20) / 20
    b = np.concatenate([twins, _boxes(rng, n // 3)])
    return {128: a, 416: b[rng.permutation(len(b))]}


CASES = {
    "two_scales": lambda: _two_scales(0),
    "two_scales_dense": lambda: _two_scales(1, n=300),
    "empty_128": lambda: {128: np.zeros((0, 11)), 416: _two_scales(2)[416]},
    "empty_416": lambda: {128: _two_scales(3)[128], 416: np.zeros((0, 11))},
    "both_empty": lambda: {128: np.zeros((0, 11)), 416: np.zeros((0, 11))},
    "one_scale": lambda: {416: _two_scales(4)[416]},
    "three_scales": lambda: {**_two_scales(5),
                             640: _two_scales(6)[416]},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_consensus_filter_bit_equal_to_jax(case):
    by_scale = CASES[case]()
    got = F.cross_scale_consensus_filter(by_scale)
    ref = JF.cross_scale_consensus_filter(by_scale)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    if case == "two_scales":
        # pairs were formed: some kept rows are below CONS_HIGH
        assert ((got[:, 9] < F.CONS_HIGH) & (got[:, 9] >= F.CONS_LOW)).any()


def test_consensus_keeps_the_reference_rules():
    """A pair keeps the stronger row; a solo row needs conf >= CONS_HIGH;
    rows below CONS_LOW go."""
    rng = np.random.RandomState(7)
    box = _boxes(rng, 1, cx=np.array([50.0]), cy=np.array([50.0]))
    far = _boxes(rng, 1, cx=np.array([250.0]), cy=np.array([250.0]))
    pair_a, pair_b = box.copy(), box.copy()
    pair_a[0, 9], pair_b[0, 9] = 0.40, 0.55
    solo_hi, solo_lo, low = far.copy(), far.copy(), far.copy()
    solo_hi[0, 9], solo_lo[0, 9], low[0, 9] = 0.70, 0.65, 0.2
    solo_lo[0, :8] += 100.0
    low[0, :8] -= 100.0
    got = F.cross_scale_consensus_filter(
        {128: np.concatenate([pair_a, solo_hi, low]),
         416: np.concatenate([pair_b, solo_lo])})
    np.testing.assert_array_equal(got, np.concatenate([pair_b, solo_hi]))


@pytest.mark.parametrize("case", ["two_scales", "two_scales_dense",
                                  "empty_128"])
@pytest.mark.parametrize("iou", [0.0, 0.4, 0.9])
def test_merge_bit_equal_to_jax(case, iou):
    union = np.concatenate(list(CASES[case]().values()))
    got = F.merge_detections(union, iou)
    ref = JF.merge_detections(union, iou)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_merge_of_nothing_is_empty():
    assert F.merge_detections(np.zeros((0, 11)), 0.4).shape == (0, 11)


def test_quad_iou_matrix_bit_equal_to_jax():
    by_scale = _two_scales(8)
    a, b = by_scale[128][:, :8], by_scale[416][:, :8]
    got = F.exact_iou_matrix_host(a, b)
    np.testing.assert_array_equal(got, jax_native.quad_iou_matrix(a, b))
    np.testing.assert_array_equal(got, JF.exact_iou_matrix_host(a, b))
    assert (got > 0.5).any() and got.shape == (len(a), len(b))
    np.testing.assert_allclose(np.diag(native.quad_iou_matrix(a, a)), 1.0,
                               atol=1e-12)
    assert native.quad_iou_matrix(a, np.zeros((0, 8))).shape == (len(a), 0)


def test_pr_match_multi_bit_equal_to_jax():
    rng = np.random.RandomState(9)
    iou = rng.rand(40, 25) * (rng.rand(40, 25) < 0.2)
    iou[3, :] = iou[2, :]                          # ties between dets
    thrs = np.arange(0.3, 0.96, 0.05)
    got = native.pr_match_multi(iou, thrs)
    assert got.dtype == np.uint8 and got.shape == (len(thrs), 40)
    np.testing.assert_array_equal(got, jax_native.pr_match_multi(iou, thrs))
    assert native.pr_match_multi(np.zeros((0, 5)), thrs).shape == (
        len(thrs), 0)


def test_native_bindings_check_their_arguments():
    d = _two_scales(10)[128]
    with pytest.raises(ValueError, match="does not match"):
        native.consensus_filter(d, np.zeros(len(d) - 1, np.int32), 0.4,
                                0.25, 0.7)
    with pytest.raises(ValueError, match=r"\[nd, ng\]"):
        native.pr_match_multi(np.zeros(5), np.array([0.5]))
