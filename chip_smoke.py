#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile MAPS]

Phases, each printing one JSON line (warnings go to stderr):

1. device  - the card's name and power limit (nvidia-smi) and the float32
             matmul/convolution precision it runs with (TF32 off).
2. build   - builds, all at once, the EDT kernels (``csrc/edt.cu``, nvcc
             for sm_90a), the host geometry library (``native/geom.cpp``,
             g++), and edt.cu once more with ``-Xptxas -v`` for each
             kernel's registers, shared memory and spills.
3. sqrt    - float32 ``torch.sqrt`` on the card against a float64 sqrt
             rounded once to float32, over every non-negative finite
             float32: ``ops.edt.sqrt_rn`` relies on their being equal.
4. kernels - holds each EDT kernel bit-equal to its plain PyTorch version
             on the card and times kernel and plain version (device time
             only: the launches are queued behind a device sleep, so the
             host's launch time is not counted) at three
             shapes: the detector's [16, 416, 416] on seeded masks of swept
             density, a map [1, 2048, 2048], and the slice's own DT-Edge
             masks of the synthetic map below (with K2's time per tile);
             then bit-equality alone on shapes that cut the kernels' tiles
             raggedly, and that one ``edt_l2`` call is two device kernels.
5. slice   - runs the 4-channel 416/100 detector on the committed
             ``train416_4ch.ckpt`` (YOLO11n-OBB) over a seeded synthetic
             1024x1024 map (16 tiles): both kernels must launch, the
             DT-Edge tile batch must equal the plain-version one, the rows
             must be sane and agree with the same detector on the CPU, and
             the xlsx is written.
6. profile - only with ``--profile MAPS``: the slice over MAPS warm maps
             under ``torch.profiler``; per map, the wall time, the device's
             busy time and idle share, the device ops, and the device time
             by kind of kernel and of the costliest kernels.
7. dual    - the reference's default path ``detect_dual``: YOLO11x-OBB at
             128/30 and 416/100 from the committed int8 checkpoints, 3
             channels, consensus fusion, on the same map (121 + 16 tiles).
             Both scales must give sane rows (launching no EDT kernel), the
             rows must agree with the same detector on the CPU on the map's
             640x640 corner, the xlsx is written, one metrics-mode map is
             scored against the map's own rectangles (the metric block,
             finite and in [0, 1]), and the seconds per map are timed; with
             ``--profile MAPS`` it is profiled as the slice is
             (``dual_profile``).

Then the kernel summary line (the slice-mask times), the card's name and
power limit again, and last ``{"ok": true, "device": ...}``. Any failure
raises and the script exits non-zero; without a CUDA device it exits 1
and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "assets", "bench_ckpts", "train416_4ch.ckpt")
# the detect_dual scales: (tile size, overlap, checkpoint)
DUAL = tuple((ts, ov, os.path.join(REPO, "assets", "bench_ckpts",
                                   f"train{ts}_x.ckpt"))
             for ts, ov in ((128, 30), (416, 100)))
CSRC = os.path.join(REPO, "oriented_object_detection_tpu_torch", "csrc")
KERNELS = ("edt_pass1_columns", "edt_pass2_rows")
# shapes that cut K1's 32-column strips and 32-row segments (4097 rows
# also pass one block's 1024 rows) and K2's row slots raggedly; 20000 is a
# row wide enough for the shared-memory opt-in
RAGGED_SHAPES = ((3, 37, 53), (2, 4097, 33), (1, 1, 700), (5, 416, 1),
                 (1, 4, 20000))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
# per-SM limits of sm_90, as the CUDA occupancy calculator has them
SM_THREADS, SM_BLOCKS, SM_REGS, SM_SMEM = 2048, 32, 65536, 233472
SM_REG_UNIT = 256             # registers allocated per warp in these units
SM_SMEM_UNIT = 128            # shared memory allocated in these units
SM_SMEM_RESERVED = 1024       # shared memory the system takes per block
FP32_FLOPS = 67e12            # same, float32 outside the tensor cores
# the TPU kernels each CUDA kernel replaces
REPLACES = {
    "edt_pass1_columns": "oriented_object_detection_tpu/ops/edt.py:110",
    "edt_pass2_rows": "oriented_object_detection_tpu/ops/edt.py:286",
}
# training palette of the synthetic maps the checkpoint was fit on
PALETTE = [(200, 40, 40), (40, 200, 40), (40, 40, 200), (200, 200, 40),
           (200, 40, 200), (40, 200, 200)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@functools.cache
def sleep_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def device_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call of ``fn``, after two warm-up calls:
    ``reps`` calls queued behind a device sleep longer than the host takes
    to queue them, between two CUDA events, so the time is the device's
    alone (a kernel far shorter than its launch would otherwise be timed
    at the host's launch rate)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2.0 * host_ms + 1.0) * sleep_cycles_per_ms()))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def edge_masks(rng, shape) -> np.ndarray:
    """Seeded edge masks. A batch of three or more gets per-image densities
    from 5e-4 to 0.3, with an empty first image and an all-edge second one;
    a single map gets density 0.02."""
    B = shape[0]
    if B < 3:
        return rng.rand(*shape) < 0.02
    m = rng.rand(*shape) < np.geomspace(5e-4, 0.3, B)[:, None, None]
    m[0] = False
    m[1] = True
    return m


def synthetic_map(seed: int, H: int = 1024, W: int = 1024,
                  n_obj: int = 40, n_lines: int = 12) -> tuple:
    """Seeded BGR uint8 map from numpy alone: a noisy light background,
    thin dark lines and filled rotated rectangles in the palette. Returns
    the map and its rectangles as ground truth [n_obj, 9] (palette class,
    then the four corners in pixels, in ``tools/train_synthetic.py``'s
    order)."""
    rng = np.random.RandomState(seed)
    img = (230 - rng.randint(0, 40, (H, W, 3))).astype(np.int16)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for _ in range(n_lines):
        x0, x1 = rng.uniform(0, W, 2)
        y0, y1 = rng.uniform(0, H, 2)
        dx, dy = x1 - x0, y1 - y0
        t = np.clip(((xx - x0) * dx + (yy - y0) * dy) / (dx * dx + dy * dy),
                    0.0, 1.0)
        d2 = (xx - x0 - t * dx) ** 2 + (yy - y0 - t * dy) ** 2
        img[d2 <= 1.0] = 60
    boxes = []
    for _ in range(n_obj):
        cls = rng.randint(0, len(PALETTE))
        cx, cy = rng.uniform(30, W - 30), rng.uniform(30, H - 30)
        w, h = rng.uniform(18, 40), rng.uniform(10, 22)
        th = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(th), np.sin(th)
        u = (xx - cx) * c + (yy - cy) * s
        v = -(xx - cx) * s + (yy - cy) * c
        img[(np.abs(u) <= w / 2) & (np.abs(v) <= h / 2)] = PALETTE[cls]
        corners = [(cx + su * w / 2 * c - sv * h / 2 * s,
                    cy + su * w / 2 * s + sv * h / 2 * c)
                   for su, sv in ((1, 1), (1, -1), (-1, -1), (-1, 1))]
        boxes.append([cls] + [z for p in corners for z in p])
    return (np.clip(img, 0, 255).astype(np.uint8),
            np.asarray(boxes, np.float64).reshape(-1, 9))


def pass2_operations(d0, dist) -> float:
    """Float operations K2's exact scan needs for d0 [N, W] whose result is
    ``dist``: a pixel whose squared distance is b scans the offsets
    delta >= 1 with rowmin + delta^2 < b (rowmin: the row's least fsq),
    over the columns between the row's first and last column below the
    cap (the others are skipped); one add and one min per candidate."""
    import torch

    f = torch.clamp_max(d0, 1e9).double() ** 2
    W = f.shape[-1]
    j = torch.arange(W, device=f.device)
    real = f < 1e18
    any_real = real.any(dim=1)
    lo = torch.where(any_real, real.int().argmax(dim=1), W)[:, None]
    hi = torch.where(any_real, W - 1 - real.flip(1).int().argmax(dim=1),
                     -1)[:, None]
    b = torch.round(dist.double() ** 2)
    gap = torch.clamp_min(b - f.amin(dim=1, keepdim=True), 0.0)
    D = torch.clamp_min(torch.ceil(torch.sqrt(gap)) - 1, 0).long()
    one = torch.ones_like(j)
    left = torch.minimum(D, j - lo) - torch.maximum(one, j - hi) + 1
    right = torch.minimum(D, hi - j) - torch.maximum(one, lo - j) + 1
    return 2.0 * float(left.clamp_min(0).sum() + right.clamp_min(0).sum())


def bound(nbytes: float, ops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ptxas_report(E) -> dict:
    """Registers, shared memory and spills of each kernel of edt.cu, from
    ``nvcc -Xptxas -v`` (a cubin in a temporary directory)."""
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run(
            [E._nvcc()] + [f for f in E.NVCC_FLAGS
                           if f not in ("-shared", "-Xcompiler", "-fPIC")]
            + ["-cubin", "-Xptxas", "-v", "-o",
               os.path.join(tmp, "edt.cubin"), E.KERNEL_SOURCE],
            capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{res.stderr}")
    out, name = {}, None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            raw = m.group(1)
            name = next(k for k in KERNELS if k in raw)
            vec = re.search(r"ILi(\d)E", raw)
            name += f"<{vec.group(1)}>" if vec else ""
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem_bytes"] = int(s.group(1)) if s else 0
    return out


def slice_masks(torch, cfg, img):
    """The DT-Edge edge masks [T, ts, ts] of the slice's tiles of ``img``,
    on the card."""
    from oriented_object_detection_tpu_torch.ops import dtedge as DT
    from oriented_object_detection_tpu_torch.ops import tiling as T

    sc = cfg.scales[0]
    H, W = img.shape[:2]
    grid = T.inference_tile_grid(H, W, sc.tile_size, sc.overlap)
    tiles = T.extract_tiles(torch.from_numpy(img).cuda(), grid,
                            sc.tile_size)
    return DT.edge_mask(tiles, cfg.dt_edge)[0].contiguous()


def blocks_per_sm(ptx: dict, threads: int, dynamic_smem: int) -> int:
    """Blocks of a kernel that one SM holds, by the CUDA occupancy
    calculator's rules for sm_90: from the kernel's ``-Xptxas -v``
    registers and static shared memory, and its launch's threads and
    dynamic shared memory."""
    warps = -(-threads // 32)
    regs_per_warp = -(-ptx["registers"] * 32 // SM_REG_UNIT) * SM_REG_UNIT
    smem = ptx["static_smem_bytes"] + dynamic_smem + SM_SMEM_RESERVED
    smem = -(-smem // SM_SMEM_UNIT) * SM_SMEM_UNIT
    return min(SM_BLOCKS, SM_THREADS // (warps * 32),
               SM_REGS // regs_per_warp // warps, SM_SMEM // smem)


def launch_shapes(E, H: int, W: int) -> dict:
    """Each kernel's ``-Xptxas -v`` entry, threads per block and dynamic
    shared memory at a shape [B, H, W], as ``csrc/edt.cu``'s launchers
    set them (K1: 32 columns x one warp per 32-row segment, at most 32
    segments; K2: 128 threads, the 16-byte-load variant for contiguous
    rows of a multiple of 4 floats)."""
    return {
        "edt_pass1_columns": ("edt_pass1_columns",
                              32 * min(-(-H // 32), 32), 0),
        "edt_pass2_rows": (f"edt_pass2_rows<{4 if W % 4 == 0 else 1}>",
                           128,
                           E.kernel_library().edt_pass2_rows_smem_bytes(W)),
    }


def phase_kernels(E, torch, ptxas, masks_by_label) -> dict:
    results = {}
    for label, mask in masks_by_label.items():
        B, H, W = mask.shape
        d0 = E.edt_pass1_columns(mask)
        d0_plain = E.edt_pass1_columns_plain(mask)
        dist = E.edt_pass2_rows(d0.reshape(-1, W))
        dist_plain = E.edt_pass2_rows_plain(d0.reshape(-1, W))
        row = {}
        launch = launch_shapes(E, H, W)
        for name, got, ref, fn, plain, nbytes, ops in (
                ("edt_pass1_columns", d0, d0_plain,
                 lambda: E.edt_pass1_columns(mask),
                 lambda: E.edt_pass1_columns_plain(mask),
                 B * H * W * (1 + 4), 0.0),
                ("edt_pass2_rows", dist, dist_plain,
                 lambda: E.edt_pass2_rows(d0.reshape(-1, W)),
                 lambda: E.edt_pass2_rows_plain(d0.reshape(-1, W)),
                 B * H * W * (4 + 4), pass2_operations(
                     d0.reshape(-1, W), dist))):
            err = float((got - ref).abs().max())
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"{name} at {label} {list(mask.shape)}: kernel differs "
                    f"from its plain version (max abs err {err})")
            row[name] = {
                "max_abs_err": err,
                "ms": statistics.mean([device_ms(fn), device_ms(fn)]),
                "plain_ms": device_ms(plain, reps=3),
                **bound(nbytes, ops),
                "library_ms": None,
                "blocks_per_sm": blocks_per_sm(ptxas[launch[name][0]],
                                               *launch[name][1:]),
            }
        if label == "slice":
            row["edt_pass2_rows"]["ms_by_tile"] = [
                device_ms(lambda b=b: E.edt_pass2_rows(d0[b]))
                for b in range(B)]
            row["edt_pass2_rows"]["operations_by_tile"] = [
                pass2_operations(d0[b], dist.reshape(B, H, W)[b])
                for b in range(B)]
        results[label] = row
        emit({"phase": "kernels", "shape": [label, B, H, W],
              "bit_equal": True, **row})
    return results


def phase_ragged(E, torch) -> None:
    """Bit-equality alone on shapes that cut the tiles raggedly, each on an
    empty, an all-edge and a sparse mask; then ``edt_l2`` on a CUDA mask
    must run exactly the two kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.RandomState(1)
    checked = []
    for shape in RAGGED_SHAPES:
        W = shape[2]
        for kind, m in (("empty", np.zeros(shape, bool)),
                        ("all_edge", np.ones(shape, bool)),
                        ("sparse", rng.rand(*shape) < 0.01)):
            mask = torch.from_numpy(m).cuda()
            d0 = E.edt_pass1_columns(mask)
            dist = E.edt_pass2_rows(d0.reshape(-1, W))
            if not torch.equal(d0, E.edt_pass1_columns_plain(mask)):
                raise AssertionError(f"edt_pass1_columns differs from its "
                                     f"plain version at {shape} {kind}")
            if not torch.equal(dist, E.edt_pass2_rows_plain(
                    d0.reshape(-1, W))):
                raise AssertionError(f"edt_pass2_rows differs from its "
                                     f"plain version at {shape} {kind}")
            checked.append(f"{list(shape)} {kind}")

    mask = torch.from_numpy(edge_masks(rng, (16, 416, 416))).cuda()
    E.edt_l2(mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        E.edt_l2(mask)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if not names:
        raise AssertionError("the profiler recorded no device work")
    if len(names) != 2 or not all("edt_pass" in n for n in names):
        raise AssertionError(f"edt_l2 ran {len(names)} device ops, not the "
                             f"two kernels: {names}")
    emit({"phase": "ragged", "bit_equal": checked,
          "edt_l2_device_ops": names})


def phase_sqrt(torch) -> None:
    """float32 torch.sqrt against float64 sqrt rounded to float32 over every
    non-negative finite float32 (bit patterns 0 to 0x7f7fffff)."""
    t0 = time.perf_counter()
    top, step, differ, first = 0x7F800000, 1 << 27, 0, []
    for lo in range(0, top, step):
        x = torch.arange(lo, min(lo + step, top), dtype=torch.int32,
                         device="cuda").view(torch.float32)
        ne = (torch.sqrt(x).view(torch.int32)
              != torch.sqrt(x.double()).float().view(torch.int32))
        n = int(ne.sum())
        differ += n
        if n and len(first) < 8:
            first += x[ne][:8].tolist()
    out = {"phase": "sqrt", "values": top, "differing": differ,
           "first_differing": first, "seconds": time.perf_counter() - t0}
    emit(out)
    if differ:
        raise AssertionError("float32 torch.sqrt is not correctly rounded "
                             "on this card; ops.edt.sqrt_rn relies on it")


def check_rows(rows: np.ndarray, H: int, W: int, thr: float) -> None:
    if rows.ndim != 2 or rows.shape[1] != 11 or not len(rows):
        raise AssertionError(f"expected [N>0, 11] rows, got {rows.shape}")
    if not np.isfinite(rows).all():
        raise AssertionError("non-finite detection rows")
    cx, cy = rows[:, 0:8:2].mean(1), rows[:, 1:8:2].mean(1)
    if (cx < 0).any() or (cx > W).any() or (cy < 0).any() or (cy > H).any():
        raise AssertionError("detection centers outside the map")
    if (rows[:, 9] < thr).any() or (rows[:, 9] > 1).any():
        raise AssertionError("confidence outside [threshold, 1]")


def match_rows(a: np.ndarray, b: np.ndarray, conf_min: float = 0.35,
               px: float = 1.0, dconf: float = 0.02,
               skip_near: tuple = ()) -> None:
    """Every row of ``a`` with conf >= conf_min, and not within ``dconf``
    of a threshold in ``skip_near``, has a row of ``b`` with the same
    class, corners within ``px`` and conf within ``dconf``."""
    sel = a[:, 9] >= conf_min
    for t in skip_near:
        sel &= np.abs(a[:, 9] - t) > dconf
    for r in a[sel]:
        same = b[b[:, 8] == r[8]]
        close = (np.abs(same[:, :8] - r[:8]).max(1) <= px) & (
            np.abs(same[:, 9] - r[9]) <= dconf)
        if not close.any():
            raise AssertionError(f"no partner for detection {r.tolist()}")


def check_xlsx(rows: np.ndarray) -> None:
    """The 11-column sheet of ``rows`` holds a header and every row."""
    from oriented_object_detection_tpu_torch.utils.xlsx import export_xlsx

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.xlsx")
        export_xlsx(path, rows)
        with zipfile.ZipFile(path) as z:
            sheet = z.read("xl/worksheets/sheet1.xml").decode()
    if sheet.count("<row ") != len(rows) + 1:
        raise AssertionError("xlsx does not hold every row")


def seconds_per_map(torch, det, img, maps: int = 5) -> list:
    """Wall seconds of ``maps`` warm ``detect_image`` calls, each ended by a
    device synchronize, after one call to warm up."""
    det.detect_image(img)
    times = []
    for _ in range(maps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.detect_image(img)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def phase_slice(torch, E, img) -> tuple:
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        build_detector)
    from oriented_object_detection_tpu_torch.ops import dtedge as DT
    from oriented_object_detection_tpu_torch.ops import tiling as T

    H, W = img.shape[:2]
    det = build_detector([(416, 100, CKPT)], channels=4)
    sc = det.cfg.scales[0]
    grid = T.inference_tile_grid(H, W, sc.tile_size, sc.overlap)

    for k in E.LAUNCHES:
        E.LAUNCHES[k] = 0
    res = det.detect_image(img)
    torch.cuda.synchronize()
    launches = dict(E.LAUNCHES)
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    rows = res["merged_for_pr"]
    check_rows(rows, H, W, det.cfg.conf_thr_predict)

    tiles = T.extract_tiles(torch.from_numpy(img).cuda(), grid,
                            sc.tile_size)
    dt = DT.dt_edge_channel(tiles, det.cfg.dt_edge)
    dt_plain = DT.dt_edge_channel(tiles, det.cfg.dt_edge, edt=E.edt_l2_plain)
    if not torch.equal(dt, dt_plain):
        raise AssertionError("DT-Edge tiles from the kernels differ from "
                             "the plain-version ones")

    cpu_rows = build_detector([(416, 100, CKPT)], channels=4,
                              device="cpu").detect_image(img)["merged_for_pr"]
    match_rows(rows, cpu_rows)
    match_rows(cpu_rows, rows)
    check_xlsx(rows)

    times = seconds_per_map(torch, det, img)
    out = {"phase": "slice", "map": [H, W], "tiles": len(grid),
           "rows": len(rows), "cpu_rows": len(cpu_rows),
           "launches": launches, "dt_edge_bit_equal": True,
           "seconds_per_map": statistics.median(times),
           "seconds_per_map_all": times}
    emit(out)
    return det, out


def phase_dual(torch, E, img, gt) -> object:
    """The reference's default path on the card: rows, agreement with the
    CPU, the xlsx, one metrics-mode map and the seconds per map."""
    from oriented_object_detection_tpu_torch.eval import metrics as M
    from oriented_object_detection_tpu_torch.infer import fusion as F
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        build_detector)
    from oriented_object_detection_tpu_torch.ops import tiling as T

    H, W = img.shape[:2]
    det = build_detector(DUAL)
    if [sc.model_scale for sc in det.cfg.scales] != ["x", "x"]:
        raise AssertionError(f"not the x scale: {det.cfg.scales}")
    tiles = {sc.tile_size: len(T.inference_tile_grid(H, W, sc.tile_size,
                                                     sc.overlap))
             for sc in det.cfg.scales}
    for k in E.LAUNCHES:
        E.LAUNCHES[k] = 0
    res = det.detect_image(img)
    torch.cuda.synchronize()
    launches = dict(E.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"the 3-channel path ran an EDT kernel: "
                             f"{launches}")
    if sorted(res["by_scale"]) != [128, 416]:
        raise AssertionError(f"scales {sorted(res['by_scale'])}")
    thr = det.cfg.conf_thr_predict
    for rows in (*res["by_scale"].values(), res["merged_for_pr"]):
        check_rows(rows, H, W, thr)
    check_xlsx(res["merged_for_pr"])

    # the same detector on the CPU, on a corner small enough for it; a
    # fused row whose conf lies near a consensus threshold may be kept on
    # one device and dropped on the other by a last-bit difference
    corner = np.ascontiguousarray(img[:640, :640])
    gpu = det.detect_image(corner)
    cpu = build_detector(DUAL, device="cpu").detect_image(corner)
    for a, b in ((gpu, cpu), (cpu, gpu)):
        for ts in (128, 416):
            match_rows(a["by_scale"][ts], b["by_scale"][ts])
        match_rows(a["merged_for_pr"], b["merged_for_pr"],
                   skip_near=(F.CONS_LOW, F.CONS_HIGH))

    # one metrics-mode map against the map's own rectangles; the input
    # folder holds an empty file of the map's name (the GT loader reads no
    # pixels, and the card's machine has no cv2)
    mdet = build_detector(DUAL, calculate_metrics=True)
    mres = mdet.detect_image(img)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.png")
        open(path, "wb").close()
        block = M.run_fusion_eval(
            {path: mres["merged_for_pr"]}, tmp, tmp,
            iou_thr=mdet.cfg.metrics_iou,
            dets_map={path: mres["merged_for_map"]},
            cache=M.GTCache(loader=lambda _: gt),
            map_min_score=mdet.cfg.map_min_score)
    numbers = [v for v in block.values() for v in np.ravel(v)]
    if len(block) != 8 or not all(np.isfinite(v) and 0.0 <= v <= 1.0
                                  for v in numbers):
        raise AssertionError(f"metric block out of range: {block}")

    times = seconds_per_map(torch, det, img)
    emit({"phase": "dual", "map": [H, W], "tiles": tiles,
          "model_scale": "x", "edt_launches": launches,
          "rows": {str(ts): len(r) for ts, r in res["by_scale"].items()},
          "fused_rows": len(res["merged_for_pr"]),
          "cpu_check": {"map": list(corner.shape[:2]),
                        "rows": {str(ts): [len(gpu["by_scale"][ts]),
                                           len(cpu["by_scale"][ts])]
                                 for ts in (128, 416)},
                        "fused_rows": [len(gpu["merged_for_pr"]),
                                       len(cpu["merged_for_pr"])]},
          "metrics": {"rows_for_map": len(mres["merged_for_map"]),
                      "gt": len(gt), **{k: np.ravel(v).tolist()
                                        for k, v in block.items()}},
          "seconds_per_map": statistics.median(times),
          "seconds_per_map_all": times})
    return det


# kinds of device work, by a substring of the kernel's name (first match)
KERNEL_KINDS = (
    ("edt", ("edt_pass",)),
    ("conv_matmul", ("conv", "gemm", "xmma", "cudnn", "cutlass", "sm90_",
                     "implicit", "winograd")),
    ("sort", ("sort", "radix")),
    ("copy", ("memcpy", "memset")),
)


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k in low for k in keys):
            return kind
    return "elementwise_other"


def busy_ms(intervals) -> float:
    """Length of the union of [start, end] microsecond intervals, in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def phase_profile(torch, det, img, maps: int, phase: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        walls = []
        for _ in range(maps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            det.detect_image(img)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return walls

    walls = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        walls_profiled = run()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        raise AssertionError("the profiler recorded no device work")
    busy = busy_ms((e.time_range.start, e.time_range.end) for e in ops)
    by_kind, by_name = {}, {}
    for e in ops:
        ms = (e.time_range.end - e.time_range.start) / 1e3 / maps
        kind = kernel_kind(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    wall_ms = statistics.median(walls) * 1e3
    emit({"phase": phase, "maps": maps,
          "seconds_per_map": wall_ms / 1e3, "seconds_per_map_all": walls,
          "seconds_per_map_profiled": statistics.median(walls_profiled),
          "device_busy_ms": busy / maps,
          "idle_share": 1.0 - busy / maps / wall_ms,
          "device_ops_per_map": len(ops) / maps,
          "device_ms_by_kind": by_kind,
          "top_kernels": [{"name": k[:90], "device_ms": v} for k, v in
                          sorted(by_name.items(), key=lambda kv: -kv[1])[:12]]})


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--profile", type=int, default=0, metavar="MAPS",
                   help="also profile the slice and the dual path over "
                        "MAPS warm maps each")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from oriented_object_detection_tpu_torch.config import PRESETS
    from oriented_object_detection_tpu_torch.ops import edt as E
    from oriented_object_detection_tpu_torch.utils import native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    def timed(fn):
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        builds = {name: pool.submit(timed, fn) for name, fn in (
            ("edt_cu", E.kernel_library), ("geom_cpp", native.load),
            ("ptxas", lambda: ptxas_report(E)))}
        built = {name: f.result() for name, f in builds.items()}
    ptxas = built["ptxas"][0]
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          **{f"{name}_s": sec for name, (_, sec) in built.items()},
          "ptxas": ptxas})

    phase_sqrt(torch)
    img, gt = synthetic_map(seed=0)
    rng = np.random.RandomState(0)
    smask = slice_masks(torch, PRESETS["detect_416_4ch"], img)
    kern = phase_kernels(E, torch, ptxas, {
        "path": torch.from_numpy(edge_masks(rng, (16, 416, 416))).cuda(),
        "map": torch.from_numpy(edge_masks(rng, (1, 2048, 2048))).cuda(),
        "slice": smask})
    phase_ragged(E, torch)
    det, sl = phase_slice(torch, E, img)
    if args.profile:
        phase_profile(torch, det, img, args.profile, "profile")
    del det
    dual = phase_dual(torch, E, img, gt)
    if args.profile:
        phase_profile(torch, dual, img, args.profile, "dual_profile")

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # the times are the slice-mask shape's, device only; the launches are
    # the slice's (the dual path runs neither kernel)
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": "oriented_object_detection_tpu_torch/csrc/edt.cu",
         "replaces": REPLACES[name], "launches": sl["launches"][name],
         **{k: kern["slice"][name][k] for k in keys},
         "shape": ["slice", *smask.shape], "timing": "device_only"}
        for name in KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
