"""ctypes loader for the host geometry library (``native/geom.cpp`` and
``csrc/fusion_grid.cpp``).

Compiles the port's ``csrc/fusion_grid.cpp``, which includes the
repository's ``native/geom.cpp``, with ``g++`` into the port's own build
directory at first use (nothing is written into ``native/``) and binds
what the detector, the fusion and the metrics run on the host: the exact
quad-IoU matrix, the per-tile greedy class-aware merge, the fusion's
global merge and cross-scale consensus filter over a uniform grid
(``greedy_nms_grid``, ``consensus_filter_grid``: the rows of the
all-pairs scans, each row testing only the rows that share a grid cell
with it) and the multi-threshold PR matching.
Raises when the library cannot be built.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from .build import build_shared_library

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOM_SOURCE = os.path.join(os.path.dirname(_PACKAGE), "native", "geom.cpp")
GRID_SOURCE = os.path.join(_PACKAGE, "csrc", "fusion_grid.cpp")

_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int)
_UP = ctypes.POINTER(ctypes.c_ubyte)
_LP = ctypes.POINTER(ctypes.c_longlong)


@functools.cache
def load() -> ctypes.CDLL:
    lib = build_shared_library(
        "geomobb", [GRID_SOURCE],
        ["g++", "-O3", "-std=c++17", "-fPIC", "-shared"], timeout=120,
        includes=(GEOM_SOURCE,))
    lib.greedy_nms_grouped.restype = ctypes.c_int
    lib.greedy_nms_grouped.argtypes = [
        _DP, _IP, ctypes.c_int, ctypes.c_double, _IP]
    lib.quad_iou_matrix.restype = None
    lib.quad_iou_matrix.argtypes = [_DP, ctypes.c_int, _DP, ctypes.c_int,
                                    _DP]
    lib.greedy_nms_grid.restype = ctypes.c_int
    lib.greedy_nms_grid.argtypes = [_DP, ctypes.c_int, ctypes.c_double, _IP,
                                    _LP]
    lib.consensus_filter_grid.restype = ctypes.c_int
    lib.consensus_filter_grid.argtypes = [
        _DP, _IP, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, _IP, _LP]
    lib.pr_match_multi.restype = None
    lib.pr_match_multi.argtypes = [_DP, ctypes.c_int, ctypes.c_int, _DP,
                                   ctypes.c_int, _UP]
    return lib


def quad_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact pairwise IoU [n, m] of quads a [n, 8] and b [m, 8], in
    double precision."""
    a = np.ascontiguousarray(a, dtype=np.float64).reshape(-1, 8)
    b = np.ascontiguousarray(b, dtype=np.float64).reshape(-1, 8)
    out = np.empty((len(a), len(b)), dtype=np.float64)
    if out.size:
        load().quad_iou_matrix(a.ctypes.data_as(_DP), len(a),
                               b.ctypes.data_as(_DP), len(b),
                               out.ctypes.data_as(_DP))
    return out


def greedy_nms_grid(dets: np.ndarray, iou_thr: float) -> tuple:
    """Greedy class-aware exact-IoU NMS over [n, 11] rows (x1..y4, cls,
    conf, angle), each row tested only against the kept rows that share a
    grid cell with it. Returns (the kept indices in conf-descending order,
    ties in input order, as the all-pairs scan keeps them; the pairs
    tested; the pairs the all-pairs scan tests)."""
    d = np.ascontiguousarray(dets, dtype=np.float64).reshape(-1, 11)
    keep = np.empty(len(d), dtype=np.int32)
    pairs = np.zeros(2, dtype=np.int64)
    cnt = load().greedy_nms_grid(d.ctypes.data_as(_DP), len(d),
                                 float(iou_thr), keep.ctypes.data_as(_IP),
                                 pairs.ctypes.data_as(_LP))
    return keep[:cnt], int(pairs[0]), int(pairs[1])


def greedy_nms_grouped(dets: np.ndarray, group_ids: np.ndarray,
                       iou_thr: float) -> np.ndarray:
    """Greedy class-aware exact-IoU NMS (the all-pairs scan) run per group
    in one call. Rows must come sorted by group (contiguous runs),
    conf-descending within each group; returns kept indices in that
    order."""
    d = np.ascontiguousarray(dets, dtype=np.float64).reshape(-1, 11)
    g = np.ascontiguousarray(group_ids, dtype=np.int32)
    if g.shape != (len(d),):
        raise ValueError(f"group_ids {g.shape} do not match {len(d)} rows")
    keep = np.empty(len(d), dtype=np.int32)
    cnt = load().greedy_nms_grouped(
        d.ctypes.data_as(_DP), g.ctypes.data_as(_IP), len(d),
        float(iou_thr), keep.ctypes.data_as(_IP))
    return keep[:cnt]


def consensus_filter_grid(dets: np.ndarray, scale_of: np.ndarray,
                          iou_partner: float, cons_low: float,
                          cons_high: float) -> tuple:
    """Cross-scale consensus fusion (`Detect_OBB.py:347-423`) over the
    CONS_LOW-prefiltered [n, 11] rows in ascending-scale blocks;
    ``scale_of[i]`` is row i's scale index. Each row tests only the rows
    that share a grid cell with it. Returns (the kept row indices in
    discovery order, as the all-pairs scan keeps them; the pairs tested;
    the pairs the all-pairs scan tests)."""
    d = np.ascontiguousarray(dets, dtype=np.float64).reshape(-1, 11)
    s = np.ascontiguousarray(scale_of, dtype=np.int32)
    if s.shape != (len(d),):
        raise ValueError(f"scale_of {s.shape} does not match {len(d)} rows")
    keep = np.empty(len(d), dtype=np.int32)
    pairs = np.zeros(2, dtype=np.int64)
    cnt = load().consensus_filter_grid(
        d.ctypes.data_as(_DP), s.ctypes.data_as(_IP), len(d),
        float(iou_partner), float(cons_low), float(cons_high),
        keep.ctypes.data_as(_IP), pairs.ctypes.data_as(_LP))
    return keep[:cnt], int(pairs[0]), int(pairs[1])


def pr_match_multi(iou: np.ndarray, iou_thrs: np.ndarray) -> np.ndarray:
    """Greedy det->GT matching at every IoU threshold at once over one
    image's [nd, ng] IoU block (det rows conf-descending). Returns TP flags
    [T, nd] (uint8)."""
    m = np.ascontiguousarray(iou, dtype=np.float64)
    if m.ndim != 2:
        raise ValueError(f"iou must be [nd, ng], got {m.shape}")
    nd, ng = m.shape
    t = np.ascontiguousarray(iou_thrs, dtype=np.float64).reshape(-1)
    out = np.zeros((len(t), nd), dtype=np.uint8)
    if nd and ng:
        load().pr_match_multi(m.ctypes.data_as(_DP), nd, ng,
                              t.ctypes.data_as(_DP), len(t),
                              out.ctypes.data_as(_UP))
    return out
