"""ctypes loader for the host geometry library (``native/geom.cpp``).

Compiles the repository's ``native/geom.cpp`` with ``g++`` into the port's
own build directory at first use (nothing is written into ``native/``) and
binds the greedy class-aware merges that the detector runs on the host.
Raises when the library cannot be built.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from .build import build_shared_library

GEOM_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "geom.cpp")

_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int)


@functools.cache
def load() -> ctypes.CDLL:
    lib = build_shared_library(
        "geomobb", [GEOM_SOURCE],
        ["g++", "-O3", "-std=c++17", "-fPIC", "-shared"], timeout=120)
    lib.greedy_nms.restype = ctypes.c_int
    lib.greedy_nms.argtypes = [_DP, ctypes.c_int, ctypes.c_double, _IP]
    lib.greedy_nms_grouped.restype = ctypes.c_int
    lib.greedy_nms_grouped.argtypes = [
        _DP, _IP, ctypes.c_int, ctypes.c_double, _IP]
    return lib


def greedy_nms(dets: np.ndarray, iou_thr: float) -> np.ndarray:
    """Greedy class-aware exact-IoU NMS over [n, 11] rows (x1..y4, cls,
    conf, angle); kept indices in conf-descending order (ties keep input
    order)."""
    d = np.ascontiguousarray(dets, dtype=np.float64).reshape(-1, 11)
    keep = np.empty(len(d), dtype=np.int32)
    cnt = load().greedy_nms(d.ctypes.data_as(_DP), len(d), float(iou_thr),
                            keep.ctypes.data_as(_IP))
    return keep[:cnt]


def greedy_nms_grouped(dets: np.ndarray, group_ids: np.ndarray,
                       iou_thr: float) -> np.ndarray:
    """The same merge run per group in one call. Rows must come sorted by
    group (contiguous runs), conf-descending within each group; returns
    kept indices in that order."""
    d = np.ascontiguousarray(dets, dtype=np.float64).reshape(-1, 11)
    g = np.ascontiguousarray(group_ids, dtype=np.int32)
    if g.shape != (len(d),):
        raise ValueError(f"group_ids {g.shape} do not match {len(d)} rows")
    keep = np.empty(len(d), dtype=np.int32)
    cnt = load().greedy_nms_grouped(
        d.ctypes.data_as(_DP), g.ctypes.data_as(_IP), len(d),
        float(iou_thr), keep.ctypes.data_as(_IP))
    return keep[:cnt]
