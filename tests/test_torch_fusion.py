"""The port's host fusion (infer/fusion.py) and its native bindings against
the JAX package's, bit-equal on identical seeded detections: the global
merge, the cross-scale consensus filter (ties, empty scales, one scale, and
confs on the consensus thresholds), the exact quad-IoU matrix and the
multi-threshold PR matching. The port's merge and consensus filter index
their rows by a uniform grid and the JAX package's scan all pairs, so the
sheet-scale cases (thousands of rows over 4096x4096, dense clusters, boxes
straddling cell edges or many cells wide, equal conf and IoU ties, rows
beyond the sheet) hold the grid to the all-pairs scan."""

import numpy as np
import pytest

from oriented_object_detection_tpu.infer import fusion as JF
from oriented_object_detection_tpu.utils import native as jax_native
from oriented_object_detection_tpu_torch.infer import fusion as F
from oriented_object_detection_tpu_torch.utils import native


def _boxes(rng, n, cx=None, cy=None, lo=0.0, hi=300.0, w=None, h=None,
           t=None):
    """[n, 11] rectangles (x1..y4, cls, conf, 0) around the given centers
    or random ones in [lo, hi), of the given or random sides and angles,
    confs on a 0.05 grid (ties) that includes the consensus thresholds
    0.25 and 0.70 themselves."""
    cx = rng.uniform(lo, hi, n) if cx is None else cx
    cy = rng.uniform(lo, hi, n) if cy is None else cy
    w = rng.uniform(8, 40, n) if w is None else w
    h = rng.uniform(6, 25, n) if h is None else h
    t = rng.uniform(0, np.pi, n) if t is None else t
    pts = []
    for sx, sy in ((1, 1), (1, -1), (-1, -1), (-1, 1)):
        pts += [cx + sx * w / 2 * np.cos(t) - sy * h / 2 * np.sin(t),
                cy + sx * w / 2 * np.sin(t) + sy * h / 2 * np.cos(t)]
    d = np.zeros((n, 11))
    d[:, :8] = np.stack(pts, -1)
    d[:, 8] = rng.randint(0, 3, n)
    d[:, 9] = np.round(rng.uniform(0.1, 1.0, n) * 20) / 20
    return d


def _two_scales(seed, n=120, lo=0.0, hi=300.0, first=None):
    """Two scales that see many of the same objects: the second holds
    jittered copies of half the first's boxes (``first``, or random ones
    in [lo, hi)), plus boxes of its own."""
    rng = np.random.RandomState(seed)
    a = _boxes(rng, n, lo=lo, hi=hi) if first is None else first
    twins = a[rng.rand(len(a)) < 0.5].copy()
    twins[:, :8] += rng.normal(0, 2.0, (len(twins), 8))
    twins[:, 9] = np.round(rng.uniform(0.1, 1.0, len(twins)) * 20) / 20
    b = np.concatenate([twins, _boxes(rng, len(a) // 3, lo=lo, hi=hi)])
    return {128: a, 416: b[rng.permutation(len(b))]}


def _clusters(seed):
    """Dense clusters: 400 boxes around 5 centers, a few pixels apart."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(200, 3900, (5, 2))
    at = centers[rng.randint(0, 5, 400)] + rng.normal(0, 6.0, (400, 2))
    return _two_scales(seed, first=_boxes(rng, 400, at[:, 0], at[:, 1]))


def _cell_edges(seed):
    """Axis-aligned 16-pixel squares on a 16-pixel lattice, so neighbours
    touch edge to edge, with copies shifted by half a square and by a
    pixel: boxes on and across every cell edge."""
    rng = np.random.RandomState(seed)
    gx, gy = np.meshgrid(np.arange(24) * 16.0 + 1000, np.arange(24) * 16.0)
    cx = np.concatenate([gx.ravel(), gx.ravel()[::3] + 8, gx.ravel()[::5]])
    cy = np.concatenate([gy.ravel(), gy.ravel()[::3], gy.ravel()[::5] + 1])
    n = len(cx)
    sq = _boxes(rng, n, cx, cy, w=np.full(n, 16.0), h=np.full(n, 16.0),
                t=np.zeros(n))
    return _two_scales(seed, first=sq[rng.permutation(n)])


def _wide(seed):
    """Small boxes over a sheet and 30 boxes of 600 to 2,500 pixels
    across many grid cells, some of them lying over the small ones."""
    rng = np.random.RandomState(seed)
    small = _boxes(rng, 1500, lo=0.0, hi=4096.0)
    big = _boxes(rng, 30, lo=0.0, hi=4096.0, w=rng.uniform(600, 2500, 30),
                 h=rng.uniform(20, 800, 30))
    big[:, 8] = small[:30, 8]
    both = np.concatenate([small, big, big[:10] + np.r_[np.full(8, 3.0),
                                                         np.zeros(3)]])
    return _two_scales(seed, first=both[rng.permutation(len(both))])


def _ties(seed):
    """Rows with two partners of equal conf at equal IoU in the other
    scale, the later partner reaching a grid cell left of the earlier
    one's; and rows of equal conf suppressing each other. 3,000 squares of
    4 pixels set the grid's cells to 4 pixels; squares with integer
    corners make the IoUs exactly equal."""
    rng = np.random.RandomState(seed)
    small = _boxes(rng, 3000, lo=0.0, hi=360.0, w=np.full(3000, 4.0),
                   h=np.full(3000, 4.0), t=np.zeros(3000))
    small[:, 8] = 2
    n = 8
    cx = np.arange(n) * 45.0 + 30
    cy = np.full(n, 200.0)
    sq = dict(w=np.full(n, 20.0), h=np.full(n, 20.0), t=np.zeros(n))
    mid = _boxes(rng, n, cx, cy, **sq)
    right = _boxes(rng, n, cx + 6, cy, **sq)
    left = _boxes(rng, n, cx - 6, cy, **sq)
    for rows in (mid, right, left):
        rows[:, 8] = 1
    mid[:, 9] = 0.5
    right[:, 9] = left[:, 9] = 0.6
    return {128: np.concatenate([small[:1500], mid]),
            416: np.concatenate([small[1500:], right, left])}


def _beyond(seed):
    """Rows below 0 and beyond a 4096x4096 sheet."""
    return _two_scales(seed, n=800, lo=-600.0, hi=4700.0)


CASES = {
    "two_scales": lambda: _two_scales(0),
    "two_scales_dense": lambda: _two_scales(1, n=300),
    "empty_128": lambda: {128: np.zeros((0, 11)), 416: _two_scales(2)[416]},
    "empty_416": lambda: {128: _two_scales(3)[128], 416: np.zeros((0, 11))},
    "both_empty": lambda: {128: np.zeros((0, 11)), 416: np.zeros((0, 11))},
    "one_scale": lambda: {416: _two_scales(4)[416]},
    "three_scales": lambda: {**_two_scales(5),
                             640: _two_scales(6)[416]},
    "sheet_4096": lambda: _two_scales(11, n=3000, hi=4096.0),
    "dense_clusters": lambda: _clusters(12),
    "cell_edges": lambda: _cell_edges(13),
    "wide_boxes": lambda: _wide(14),
    "ties": lambda: _ties(15),
    "beyond_sheet": lambda: _beyond(16),
    "one_row": lambda: {128: _boxes(np.random.RandomState(17), 1),
                        416: np.zeros((0, 11))},
}
GRID_CASES = ["two_scales", "both_empty", "sheet_4096", "dense_clusters",
              "cell_edges", "wide_boxes", "ties", "beyond_sheet", "one_row"]


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


@pytest.mark.parametrize("case", sorted({"two_scales_dense", "empty_128",
                                         *GRID_CASES}))
@pytest.mark.parametrize("iou", [0.0, 0.4, 0.9])
def test_merge_bit_equal_to_jax(case, iou):
    union = np.concatenate(list(CASES[case]().values()))
    got = F.merge_detections(union, iou)
    ref = JF.merge_detections(union, iou)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _consensus_rows(by_scale):
    """The consensus filter's input: the CONS_LOW-prefiltered rows in
    ascending-scale blocks and each row's scale index."""
    arrs = [by_scale[s][by_scale[s][:, 9] >= F.CONS_LOW]
            for s in sorted(by_scale)]
    return (np.concatenate(arrs),
            np.concatenate([np.full(len(a), i, np.int32)
                            for i, a in enumerate(arrs)]))


@pytest.mark.parametrize("case", GRID_CASES)
@pytest.mark.parametrize("iou", [0.0, 0.4, 0.9])
def test_grid_scans_equal_the_all_pairs_scans(case, iou):
    """The grid's merge and consensus filter keep the indices of the JAX
    package's all-pairs scans, in order, at every threshold; they test at
    most the all-pairs scan's pairs, exactly those where the threshold is
    0 (one cell), and under a tenth of them on a sheet."""
    by_scale = CASES[case]()
    union = np.concatenate(list(by_scale.values()))
    keep, tested, scanned = native.greedy_nms_grid(union, iou)
    np.testing.assert_array_equal(keep, jax_native.greedy_nms(union, iou))
    assert 0 <= tested <= scanned
    rows, scale_of = _consensus_rows(by_scale)
    ckeep, ctested, cscanned = native.consensus_filter_grid(
        rows, scale_of, iou, F.CONS_LOW, F.CONS_HIGH)
    np.testing.assert_array_equal(ckeep, jax_native.consensus_filter(
        rows, scale_of, iou, F.CONS_LOW, F.CONS_HIGH))
    assert 0 <= ctested <= cscanned
    if iou <= 0:
        assert (tested, ctested) == (scanned, cscanned)
    if case == "sheet_4096" and iou > 0:
        assert tested < 0.1 * scanned and ctested < 0.1 * cscanned
    if case == "ties":
        # the tied partners exist: equal conf, equal IoU with the row
        mid, right, left = by_scale[128][-1], *by_scale[416][[-9, -1]]
        pair = native.quad_iou_matrix(mid[None, :8],
                                      np.stack([right, left])[:, :8])[0]
        assert pair[0] == pair[1] >= F.CONS_IOU_PARTNER
        assert right[9] == left[9]


def test_grid_counts_the_fusions_calls_rows_and_pairs():
    by_scale = CASES["sheet_4096"]()
    union = np.concatenate(list(by_scale.values()))
    before = dict(F.GRID)
    F.merge_detections(union, 0.4)
    F.cross_scale_consensus_filter(by_scale)
    F.merge_detections(np.zeros((0, 11)), 0.4)
    F.cross_scale_consensus_filter({416: union})
    got = {k: F.GRID[k] - before[k] for k in F.GRID}
    rows, scale_of = _consensus_rows(by_scale)
    _, t1, a1 = native.greedy_nms_grid(union, 0.4)
    _, t2, a2 = native.consensus_filter_grid(rows, scale_of,
                                             F.CONS_IOU_PARTNER,
                                             F.CONS_LOW, F.CONS_HIGH)
    assert got == {"calls": 2, "rows": len(union) + len(rows),
                   "pairs_tested": t1 + t2, "pairs_all": a1 + a2}
    assert got["pairs_tested"] < 0.1 * got["pairs_all"]


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
        native.consensus_filter_grid(d, np.zeros(len(d) - 1, np.int32),
                                     0.4, 0.25, 0.7)
    with pytest.raises(ValueError, match=r"\[nd, ng\]"):
        native.pr_match_multi(np.zeros(5), np.array([0.5]))
