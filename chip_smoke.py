#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile MAPS]

Phases, each printing one JSON line (warnings go to stderr). The port
computes in bf16 by default, as the JAX package does; every phase but
``bf16`` pins ``compute_dtype="float32"`` (``F32``), so its float32
equalities and bounds hold as before:

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
8. batch   - multi-map detection: the 4ch slice over four seeded maps of
             the reference's Test1/Test2 sizes and 1024x1024 twice, and
             ``detect_dual`` over eight 1024x1024 maps, each per map
             (``detect_image``), batched (``detect_images``) and streamed
             (``detect_stream``, groups of two); every map's batched and
             streamed rows pair with its per-map rows; K1 and K2 launch
             once for the 4ch batch and once a group for the stream; per
             mode the seconds per map, the device's idle share, peak
             device memory and the stage totals of ``utils/profiling.py``,
             and the host synchronizations inside the dispatch.
9. crop    - ``predict_crop`` of the 4ch slice's detector on a 500x700 crop
             with the percentile and the Otsu binarization: K1 and K2
             launch once each, at the crop's shape; the rows pair with the
             CPU's; Otsu's edge mask on the card equals the CPU's.
10. convert - ``train416_4ch.ckpt`` written as a fake ultralytics ``.pt``
             and brought back by ``cli.py convert``: nothing missing or
             mismatched, and the rows of a detector on it equal the
             committed checkpoint's bit for bit; a crafted ``.pt`` (a view
             past its storage) is refused.
11. random  - ``--allow-random``'s path at full width: a seeded
             YOLO11x-OBB 4ch init, ``calibrate_density`` at 416 and
             ``detect_images`` of two maps, which give rows at the predict
             threshold and launch K1 and K2.
12. bf16    - the default compute dtype on every path that runs it, with
             nothing falling back to float32: ``detect_dual`` at the
             defaults over the batch phase's eight maps (every conv output
             bf16; seconds a map one at a time and batched, peak memory,
             device busy time; with ``--profile`` the kinds and names of
             the kernels; rows paired with the batch phase's float32 rows
             of the same maps, ``BF16_ROWS``; one map's metric block), the
             4ch slice over the batch phase's four maps one at a time and
             batched (K1/K2 launched and bit-equal to their plain versions,
             rows paired with float32; profiled with ``--profile``),
             ``cli.py detect`` with no dtype setting (bf16 weights and conv
             outputs, jpg and xlsx written),
             ``train_416`` (the first step against the float32 step from
             the same warm start and batch, ``BF16_STEP``; 4 steps of
             ``fit``: finite losses, float32 parameters, gradients,
             momentum, EMA and statistics, seconds a step, peak memory, two
             profiled steps) and an n-scale bf16 step on the card against
             the CPU's.
13. train   - the training path (``Train_OBB.py``'s configuration) on four
             seeded 1024x1024 train maps (64 tiles at 416/100, labels from
             the maps' own rectangles written with ``write_labels``) and
             one val map (16 tiles), fed through ``TileDataset(reader=...)``
             (the card's machine has no cv2): YOLO11x-OBB, 3 channels, tile
             416, batch 16, warm-started from ``train416_x.ckpt``, ``fit``
             for one epoch of 4 steps with mosaic; every loss finite and fg
             > 0 each step, parameters, EMA and BN statistics moved; seconds
             per step, peak device memory, the device's idle share over two
             profiled steps; ``validate_tiles`` fitness in [0, 1]; the
             written ``last.ckpt`` detects through ``build_detector``. Then
             the 4-channel build of the 64 tiles (``tiles_to_4ch``: both EDT
             kernels launched, the DT channel equal to the plain versions'),
             2 steps of YOLO11n-OBB 4ch from ``train416_4ch.ckpt``; last one
             n-scale step at tile 64, batch 2 from the same weights and
             batch on the card and on the CPU, held together.
14. dist    - data parallelism across processes (``--dist``), each run of
             it held to the one-process run of the same work on the same
             card: the 4ch build of the train tiles (process 0 alone
             launches K1/K2), the sharded validation of the
             ``train416_x.ckpt`` warm start (the same fitness on every
             process, within 1e-6), ``fit`` of YOLO11x-OBB 416 for 3 steps
             of a global batch of 16 with mosaic (losses within 1e-4
             relative, parameters, EMA and BN statistics within 1e-4 of
             each leaf's largest value, the processes bit-equal, process 0
             alone writing), and ``detect_images`` of the 4ch slice and of
             ``detect_dual`` over two maps (rows paired, K1/K2 launched on
             every process and bit-equal to their plain versions). One
             card: NCCL at world 1 and gloo at world 2 (NCCL puts no two
             processes on one card); more cards: NCCL across up to 4. Then
             the run's ``last.ckpt`` detects, and ``cli.py detect --dist``
             runs in processes of its own (``--coordinator/
             --num-processes/--process-id``; a numpy stand-in for cv2,
             which the card's machine lacks): process 0 alone writes.
             Seconds per step, collectives per step and peak memory per
             process, and the phase's seconds.

Then the kernel summary line (the slice-mask times, and each kernel's
launches by phase), the card's name and power limit again, and last
``{"ok": true, "device": ...}``. Any failure raises and the script exits
non-zero; without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import itertools
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
TRAIN_CKPT = os.path.join(REPO, "assets", "bench_ckpts", "train416_x.ckpt")
STEP_CKPT = os.path.join(REPO, "assets", "bench_ckpts", "train128.ckpt")
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
                 (1, 4, 20000), (1, 500, 700))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
# per-SM limits of sm_90, as the CUDA occupancy calculator has them
SM_THREADS, SM_BLOCKS, SM_REGS, SM_SMEM = 2048, 32, 65536, 233472
SM_REG_UNIT = 256             # registers allocated per warp in these units
SM_SMEM_UNIT = 128            # shared memory allocated in these units
SM_SMEM_RESERVED = 1024       # shared memory the system takes per block
FP32_FLOPS = 67e12            # same, float32 outside the tensor cores
# the TPU kernels each CUDA kernel replaces
# every phase but the bf16 one pins float32: they hold the float32
# equalities and bounds of the work before bf16 became the default
F32 = {"compute_dtype": "float32"}
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
    det = build_detector([(416, 100, CKPT)], channels=4, **F32)
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

    cpu_rows = build_detector([(416, 100, CKPT)], channels=4, device="cpu",
                              **F32).detect_image(img)["merged_for_pr"]
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
    det = build_detector(DUAL, **F32)
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
    cpu = build_detector(DUAL, device="cpu", **F32).detect_image(corner)
    for a, b in ((gpu, cpu), (cpu, gpu)):
        for ts in (128, 416):
            match_rows(a["by_scale"][ts], b["by_scale"][ts])
        match_rows(a["merged_for_pr"], b["merged_for_pr"],
                   skip_near=(F.CONS_LOW, F.CONS_HIGH))

    # one metrics-mode map against the map's own rectangles; the input
    # folder holds an empty file of the map's name (the GT loader reads no
    # pixels, and the card's machine has no cv2)
    mdet = build_detector(DUAL, calculate_metrics=True, **F32)
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


# ---------------------------------------------------------------------------
# Multi-map detection, the single-crop predictor, convert, random init
# ---------------------------------------------------------------------------

# the reference's Input/Test1.png (895x807) and Test2.png (1056x1028) and
# two 1024x1024 maps, as (H, W)
BATCH_SHAPES = ((807, 895), (1028, 1056), (1024, 1024), (1024, 1024))
BATCH_SEEDS = (1, 2, 3, 4)
DUAL_BATCH_SEEDS = tuple(range(21, 29))      # eight 1024x1024 maps
RANDOM_SEEDS = (31, 32)
STREAM_CHUNK = 2


def reset_launches(E) -> None:
    for k in E.LAUNCHES:
        E.LAUNCHES[k] = 0


class PathKernels:
    """Wraps both EDT wrappers for one run of a path: each call's input and
    the output the path went on with are kept, and ``check`` holds every
    output bit-equal to the kernel's plain version on the same input on
    the card. The plain versions launch nothing, so the counts stay the
    path's."""

    def __init__(self, E):
        self.E, self.calls, self.saved = E, [], {}

    def __enter__(self):
        for name in KERNELS:
            self.saved[name] = fn = getattr(self.E, name)

            def spy(x, _name=name, _fn=fn):
                out = _fn(x)
                self.calls.append((_name, x, out))
                return out

            setattr(self.E, name, spy)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.E, name, fn)

    def shapes(self, name: str) -> list:
        return [list(x.shape) for n, x, _ in self.calls if n == name]

    def check(self, torch, label: str) -> list:
        """[[kernel, *input shape]] of every call, each checked."""
        plain = {"edt_pass1_columns": self.E.edt_pass1_columns_plain,
                 "edt_pass2_rows": self.E.edt_pass2_rows_plain}
        for name, x, out in self.calls:
            if not torch.equal(out, plain[name](x)):
                raise AssertionError(f"{label}: {name} at {list(x.shape)} "
                                     f"differs from its plain version")
        checked = [[name, *x.shape] for name, x, _ in self.calls]
        self.calls = []
        return checked


def device_busy(torch, fn) -> tuple:
    """(device busy ms, device ops) of one synchronized call of ``fn`` under
    ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        raise AssertionError("the profiler recorded no device work")
    return busy_ms((e.time_range.start, e.time_range.end) for e in ops), \
        len(ops)


def dispatch_syncs(torch, det, maps) -> dict:
    """Host synchronizations inside a side-stream upload and the multi-map
    dispatch (the part of ``detect_stream`` that must queue without
    waiting), as ``torch.cuda.set_sync_debug_mode`` reports them; the rows
    are fetched afterwards."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pending = det._dispatch(det._upload(maps, side=True))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    det._fetch(pending)
    msgs = [str(w.message) for w in caught
            if "called a synchronizing" in str(w.message)]
    return {"count": len(msgs), "first": msgs[:2]}


def tile_gather_seconds(torch, det, maps) -> dict:
    """Seconds of ``ops/tiling.extract_tiles`` over every map at each of the
    detector's scales, as the dispatch runs it: the host's time to queue
    it, and with the device's work waited for."""
    from oriented_object_detection_tpu_torch.ops import tiling as T

    dev = [torch.from_numpy(m).cuda() for m in maps]
    grids = [(sc.tile_size, [T.inference_tile_grid(*m.shape[:2],
                                                   sc.tile_size, sc.overlap)
                             for m in maps]) for sc in det.cfg.scales]

    def gather():
        return [torch.cat([T.extract_tiles(m, g, ts)
                           for m, g in zip(dev, gs)]) for ts, gs in grids]

    gather()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiles = gather()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {"tiles": sum(len(t) for t in tiles), "host_s": host,
            "synchronized_s": wall_seconds(torch, gather)[1]}


def run_modes(torch, E, det, maps, reps: int = 2) -> tuple:
    """Per-map ``detect_image``, ``detect_images`` and ``detect_stream``
    (groups of ``STREAM_CHUNK``) over ``maps``, each warmed once, then
    driven with the launch counts set to 0 just before and read just
    after, then timed ``reps`` more times and profiled once. Returns
    ({mode: per-map results}, {mode: numbers})."""
    from oriented_object_detection_tpu_torch.utils import profiling as prof

    runs = {"per_image": lambda: [det.detect_image(m) for m in maps],
            "batch": lambda: det.detect_images(maps),
            "stream": lambda: list(det.detect_stream(maps,
                                                     chunk=STREAM_CHUNK))}
    results, numbers = {}, {}
    for mode, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prof.reset()
        with PathKernels(E) as rec:
            reset_launches(E)
            res, sec = wall_seconds(torch, fn)
            launches = dict(E.LAUNCHES)
        stages = {k: v["total_s"] for k, v in prof.report().items()}
        peak = torch.cuda.max_memory_allocated()
        bit_equal = rec.check(torch, mode)
        times = [sec] + [wall_seconds(torch, fn)[1] for _ in range(reps)]
        busy, ops = device_busy(torch, fn)
        wall = statistics.median(times)
        results[mode] = res
        numbers[mode] = {
            "launches": launches,
            "seconds_per_map": wall / len(maps),
            "seconds_per_map_all": [t / len(maps) for t in times],
            "device_busy_ms_per_map": busy / len(maps),
            "idle_share": 1.0 - busy / (wall * 1e3),
            "device_ops_per_map": ops / len(maps),
            "peak_memory_gib": peak / 2 ** 30,
            "stage_seconds": stages,
            "kernels_bit_equal_to_plain": bit_equal}
    return results, numbers


def pair_modes(results: dict, scales, skip_near=(),
               modes=("batch", "stream")) -> None:
    """Each map's rows of each of ``modes`` (``detect_images``,
    ``detect_stream``) pair with its ``detect_image`` rows both ways
    (``match_rows``), per scale and fused."""
    for mode in modes:
        for got, one in zip(results[mode], results["per_image"]):
            for a, b in ((got, one), (one, got)):
                for ts in scales:
                    match_rows(a["by_scale"][ts], b["by_scale"][ts])
                match_rows(a["merged_for_pr"], b["merged_for_pr"],
                           skip_near=skip_near)


def phase_batch(torch, E) -> dict:
    """Multi-map detection: the 4ch n-scale slice over the four
    ``BATCH_SHAPES`` maps (one K1 and one K2 launch for the batch, one a
    group for the stream), and ``detect_dual`` at full width over eight
    1024x1024 maps; the rows of both multi-map modes pair with the per-map
    rows on every map, and every K1 and K2 output of each mode's counted
    run is bit-equal to its plain version on the same input."""
    from oriented_object_detection_tpu_torch.infer import fusion as F
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        build_detector)
    from oriented_object_detection_tpu_torch.ops import tiling as T

    maps = [synthetic_map(s, H=h, W=w)[0]
            for s, (h, w) in zip(BATCH_SEEDS, BATCH_SHAPES)]
    det = build_detector([(416, 100, CKPT)], channels=4, **F32)
    res, num = run_modes(torch, E, det, maps)
    groups = -(-len(maps) // STREAM_CHUNK)
    want = {"per_image": len(maps), "batch": 1, "stream": groups}
    for mode, n in want.items():
        if num[mode]["launches"] != {k: n for k in KERNELS}:
            raise AssertionError(f"4ch {mode}: launches "
                                 f"{num[mode]['launches']}, not {n} each")
    pair_modes(res, (416,))
    for r, m in zip(res["batch"], maps):
        check_rows(r["merged_for_pr"], *m.shape[:2],
                   det.cfg.conf_thr_predict)
    four = {"maps": [list(m.shape[:2]) for m in maps],
            "tiles": sum(len(T.inference_tile_grid(h, w, 416, 100))
                         for h, w in BATCH_SHAPES),
            "rows": [len(r["merged_for_pr"]) for r in res["batch"]],
            "dispatch_syncs": dispatch_syncs(torch, det, maps),
            "tile_gather": tile_gather_seconds(torch, det, maps), **num}
    emit({"phase": "batch", "part": "4ch", "model_scale": "n", **four})
    rows_4ch = [r["merged_for_pr"] for r in res["per_image"]]
    del det

    maps = [synthetic_map(s)[0] for s in DUAL_BATCH_SEEDS]
    det = build_detector(DUAL, **F32)
    res, num = run_modes(torch, E, det, maps)
    if any(n for mode in num.values() for n in mode["launches"].values()):
        raise AssertionError("the 3-channel path ran an EDT kernel")
    pair_modes(res, (128, 416), skip_near=(F.CONS_LOW, F.CONS_HIGH))
    for r in res["batch"]:
        check_rows(r["merged_for_pr"], 1024, 1024, det.cfg.conf_thr_predict)
    emit({"phase": "batch", "part": "dual", "model_scale": "x",
          "maps": len(maps), "map": [1024, 1024],
          "tiles_per_map": {str(ts): len(T.inference_tile_grid(
              1024, 1024, ts, ov)) for ts, ov, _ in DUAL},
          "rows": [len(r["merged_for_pr"]) for r in res["batch"]],
          "dispatch_syncs": dispatch_syncs(torch, det, maps[:STREAM_CHUNK]),
          "tile_gather": tile_gather_seconds(torch, det, maps), **num})
    phase_sheets(torch, det, maps)
    return {"batch": four["batch"]["launches"],
            "stream": four["stream"]["launches"],
            "float32_results": {"4ch": rows_4ch, "dual": res["per_image"]}}


def phase_sheets(torch, det, maps) -> None:
    """``detect_dual`` over sheets of the size users run: two 4096x4096
    sheets, each a 4x4 mosaic of the 1024x1024 maps, in one
    ``detect_images`` call, against ``detect_image`` of each. The tiles
    pass the network in several forwards a scale
    (``TILE_PIXELS_PER_FORWARD``); the rows pair both ways; seconds a
    sheet and the peak device memory of both modes."""
    from oriented_object_detection_tpu_torch.infer import fusion as F
    from oriented_object_detection_tpu_torch.infer import pipeline as P
    from oriented_object_detection_tpu_torch.ops import tiling as T

    sheets = [np.concatenate([np.concatenate(
        [maps[(5 * k + 4 * r + c) % len(maps)] for c in range(4)], axis=1)
        for r in range(4)]) for k in range(2)]
    H, W = sheets[0].shape[:2]
    tiles = {ts: len(T.inference_tile_grid(H, W, ts, ov))
             for ts, ov, _ in DUAL}
    forwards = {ts: -(-len(sheets) * n // max(
        1, P.TILE_PIXELS_PER_FORWARD // (ts * ts))) for ts, n in tiles.items()}
    if max(forwards.values()) < 2:
        raise AssertionError(f"the sheets ran in one forward a scale: "
                             f"{forwards}")
    out = {}
    for mode, fn in (("batch", lambda: det.detect_images(sheets)),
                     ("per_image", lambda: [det.detect_image(s)
                                            for s in sheets])):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, sec = wall_seconds(torch, fn)
        out[mode] = {"seconds_per_sheet": sec / len(sheets),
                     "peak_memory_gib":
                         torch.cuda.max_memory_allocated() / 2 ** 30,
                     "rows": [len(r["merged_for_pr"]) for r in res],
                     "results": res}
    results = {m: v.pop("results") for m, v in out.items()}
    pair_modes(results, tiles, skip_near=(F.CONS_LOW, F.CONS_HIGH),
               modes=("batch",))
    for r in results["batch"]:
        check_rows(r["merged_for_pr"], H, W, det.cfg.conf_thr_predict)
    emit({"phase": "batch", "part": "sheets", "model_scale": "x",
          "sheets": len(sheets), "sheet": [H, W],
          "tiles_per_sheet": {str(k): v for k, v in tiles.items()},
          "forwards_batch": {str(k): v for k, v in forwards.items()},
          **out})


def phase_crop(torch, E, img) -> dict:
    """``predict_crop`` of the 4ch n-scale detector on a 500x700 crop, with
    the percentile and the Otsu binarization: K1 and K2 launch once, at the
    crop's own shape, each output bit-equal to its plain version on the
    same input; the rows pair with the CPU's; Otsu's edge mask on the card
    equals the CPU's."""
    from oriented_object_detection_tpu_torch.config import DTEdgeConfig
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        build_detector)
    from oriented_object_detection_tpu_torch.ops import dtedge as DT

    crop = np.ascontiguousarray(img[100:600, 150:850])
    H, W = crop.shape[:2]
    out = {}
    for method in ("percentile", "otsu"):
        kw = {"channels": 4, "dt_edge": DTEdgeConfig(bin_method=method),
              **F32}
        det = build_detector([(416, 100, CKPT)], **kw)
        det.predict_crop(crop)
        with PathKernels(E) as rec:
            reset_launches(E)
            rows = det.predict_crop(crop).rows
            torch.cuda.synchronize()
            launches = dict(E.LAUNCHES)
        shapes = rec.shapes("edt_pass1_columns")
        bit_equal = rec.check(torch, f"crop {method}")
        if launches != {k: 1 for k in KERNELS} or shapes != [[1, H, W]]:
            raise AssertionError(f"crop {method}: launches {launches} at "
                                 f"{shapes}, not one each at [1, {H}, {W}]")
        check_rows(rows, H, W, det.cfg.conf_thr_predict)
        cpu = build_detector([(416, 100, CKPT)], device="cpu",
                             **kw).predict_crop(crop).rows
        match_rows(rows, cpu)
        match_rows(cpu, rows)
        times = [wall_seconds(torch, lambda: det.predict_crop(crop))[1]
                 for _ in range(3)]
        out[method] = {"launches": launches, "edt_shapes": shapes,
                       "kernels_bit_equal_to_plain": bit_equal,
                       "rows": len(rows), "cpu_rows": len(cpu),
                       "seconds": statistics.median(times)}
    cfg = DTEdgeConfig(bin_method="otsu")
    mask = DT.edge_mask(torch.from_numpy(crop).cuda()[None], cfg)[0].cpu()
    if not torch.equal(mask, DT.edge_mask(torch.from_numpy(crop)[None],
                                          cfg)[0]):
        raise AssertionError("Otsu's edge mask differs between the card and "
                             "the CPU")
    emit({"phase": "crop", "crop": [H, W], "otsu_mask_card_equals_cpu": True,
          "otsu_edge_share": float(mask.float().mean()), **out})
    return out["percentile"]["launches"]


def save_fake_ultralytics(torch, sd: dict, path: str) -> None:
    """``torch.save`` of {'model': <a module tree holding ``sd`` under a
    stub ``ultralytics.nn.tasks.OBBModel``>, 'ema': None}, the layout of an
    ultralytics checkpoint; the stub module is in ``sys.modules`` only
    while saving."""
    import types

    from torch import nn

    root = nn.Module()
    for key, val in sd.items():
        *mods, leaf = key.split(".")
        node = root
        for name in mods:
            if name not in node._modules:
                node.add_module(name, nn.Module())
            node = node._modules[name]
        node.register_buffer(leaf, torch.from_numpy(
            np.ascontiguousarray(val)))
    tasks = types.ModuleType("ultralytics.nn.tasks")

    class OBBModel(nn.Module):
        pass

    OBBModel.__module__ = "ultralytics.nn.tasks"
    OBBModel.__qualname__ = "OBBModel"
    tasks.OBBModel = OBBModel
    wrapper = OBBModel()
    wrapper.add_module("model", root._modules["model"])
    names = ("ultralytics", "ultralytics.nn", "ultralytics.nn.tasks")
    saved = {k: sys.modules.get(k) for k in names}
    sys.modules.update({"ultralytics": types.ModuleType("ultralytics"),
                        "ultralytics.nn": types.ModuleType("ultralytics.nn"),
                        "ultralytics.nn.tasks": tasks})
    try:
        torch.save({"epoch": 0, "model": wrapper, "ema": None}, path)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def write_crafted_pt(torch, path: str) -> None:
    """A torch zip checkpoint whose one tensor, of size (4096,), views a
    storage of 4 float32 elements."""
    import io
    import pickle
    from collections import OrderedDict

    class Storage:
        pass

    class View:
        def __reduce__(self):
            return (torch._utils._rebuild_tensor_v2,
                    (Storage(), 0, (4096,), (1,), False, OrderedDict()))

    class Pickler(pickle.Pickler):
        def persistent_id(self, obj):
            if isinstance(obj, Storage):
                return ("storage", torch.FloatStorage, "0", "cpu", 4)
            return None

    buf = io.BytesIO()
    Pickler(buf, protocol=2).dump(OrderedDict(w=View()))
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("archive/data.pkl", buf.getvalue())
        zf.writestr("archive/version", "3\n")
        zf.writestr("archive/byteorder", "little")
        zf.writestr("archive/data/0", bytes(16))


def phase_convert(torch, img) -> None:
    """``train416_4ch.ckpt`` exported (``export_state_dict``, the stem's
    channels reversed) as a fake ultralytics ``.pt``, then ``convert``ed
    back: nothing missing or mismatched, and a detector on it gives the
    committed checkpoint's rows bit for bit; a crafted ``.pt`` is
    refused."""
    import contextlib
    import io
    import pickle

    from oriented_object_detection_tpu_torch.cli import main as cli_main
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        build_detector)
    from oriented_object_detection_tpu_torch.models.pt_reader import (
        read_pt_state_dict)
    from oriented_object_detection_tpu_torch.models.weights import (
        export_state_dict, load_checkpoint, variables_from_checkpoint)

    with tempfile.TemporaryDirectory() as tmp:
        sd = export_state_dict(variables_from_checkpoint(
            load_checkpoint(CKPT)), reverse_stem_channels=True)
        pt, out = os.path.join(tmp, "best.pt"), os.path.join(tmp, "b.ckpt")
        save_fake_ultralytics(torch, sd, pt)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            cli_main(["convert", pt, "--out", out, "--scale", "n",
                      "--channels", "4", "--imgsz", "416"])
        m = re.search(r"matched (\d+) arrays; missing=(\d+) extra=(\d+) "
                      r"mismatched=(\d+)", text.getvalue())
        if m is None or m.group(2) != "0" or m.group(4) != "0":
            raise AssertionError(f"convert report: {text.getvalue()}")
        rows = [build_detector([(416, 100, ck)], channels=4,
                               **F32).detect_image(img)["merged_for_pr"]
                for ck in (CKPT, out)]
        if not np.array_equal(*rows):
            raise AssertionError("the converted checkpoint's rows differ "
                                 "from the committed checkpoint's")
        crafted = os.path.join(tmp, "crafted.pt")
        write_crafted_pt(torch, crafted)
        try:
            read_pt_state_dict(crafted)
        except pickle.UnpicklingError as e:
            refused = str(e)
        else:
            raise AssertionError("the crafted .pt was read")
    emit({"phase": "convert", "tensors": len(sd),
          "report": {"matched": int(m.group(1)), "missing": 0,
                     "extra": int(m.group(3)), "mismatched": 0},
          "rows": len(rows[0]), "rows_bit_equal": True,
          "crafted_refused": refused})


def phase_random(torch, E) -> dict:
    """``--allow-random``'s path at full width: a seeded YOLO11x-OBB 4ch
    init, ``calibrate_density`` at 416, and ``detect_images`` of two maps,
    which must give rows at the predict threshold and launch K1 and K2,
    each output bit-equal to its plain version on the same input."""
    import dataclasses

    from oriented_object_detection_tpu_torch.config import (PRESETS,
                                                            ScaleConfig)
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        TiledDetector, random_variables)
    from oriented_object_detection_tpu_torch.models.calibrate import (
        calibrate_density)
    from oriented_object_detection_tpu_torch.models.yolo11_obb import (
        YOLO11OBB)

    t0 = time.perf_counter()
    variables = random_variables(12, "x", 4, seed=0)
    init_s = time.perf_counter() - t0
    cal, cal_s = wall_seconds(torch, lambda: calibrate_density(
        YOLO11OBB(nc=12, scale="x", in_channels=4), variables, 416, 4))
    offset = float(cal["params"]["l23"]["cv3_0_2"]["bias"][0]
                   - variables["params"]["l23"]["cv3_0_2"]["bias"][0])
    cfg = dataclasses.replace(PRESETS["detect_416_4ch"], scales=(
        ScaleConfig(416, 100, model_scale="x"),), **F32)
    det = TiledDetector(cfg, {416: cal})
    maps = [synthetic_map(s)[0] for s in RANDOM_SEEDS]
    det.detect_images(maps)
    with PathKernels(E) as rec:
        reset_launches(E)
        res, sec = wall_seconds(torch, lambda: det.detect_images(maps))
        launches = dict(E.LAUNCHES)
    bit_equal = rec.check(torch, "random")
    if launches != {k: 1 for k in KERNELS}:
        raise AssertionError(f"random: launches {launches}, not one each")
    rows = [r["merged_for_pr"] for r in res]
    if not sum(len(r) for r in rows):
        raise AssertionError("the calibrated random model gave no rows")
    for r in rows:
        if len(r):
            check_rows(r, 1024, 1024, cfg.conf_thr_predict)
    times = [sec] + [wall_seconds(torch, lambda: det.detect_images(maps))[1]
                     for _ in range(2)]
    emit({"phase": "random", "model_scale": "x", "channels": 4,
          "maps": len(maps), "init_seconds": init_s,
          "calibrate_seconds": cal_s, "bias_offset": offset,
          "rows": [len(r) for r in rows], "launches": launches,
          "kernels_bit_equal_to_plain": bit_equal,
          "seconds_per_map": statistics.median(times) / len(maps),
          "seconds_per_map_all": [t / len(maps) for t in times]})
    return launches


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

TRAIN_SEEDS, VAL_SEED, STEP_SEED = (11, 12, 13, 14), 15, 16
# the reference's training configuration (`Train_OBB.py:19-42`) on
# 1024x1024 maps: YOLO11x-OBB, tile 416, overlap 100, batch 16
TRAIN = {"tile_size": 416, "overlap": 100, "batch": 16, "scale": "x",
         "map_size": 1024, "ckpt": TRAIN_CKPT}
# the card's n-scale step against the CPU's (tile 64, batch 2, float32, TF32
# off): the loss components and the BN statistics within 1e-4 relative, the
# parameters after the step within 1e-3 of each leaf's largest value
STEP_RTOL = {"loss": 1e-4, "batch_stats": 1e-4, "params": 1e-3}


def map_tiles(seed: int, ts: int, ov: int, H: int = 1024, W: int = 1024):
    """BGR tiles [T, ts, ts, 3] of one synthetic map on the detector's grid
    (edge tiles padded with 114) and their normalized labels from the map's
    rectangles (`Train_OBB.py:93-108` assignment)."""
    import torch

    from oriented_object_detection_tpu_torch.ops import tiling as T

    img, gt = synthetic_map(seed, H=H, W=W)
    grid = T.inference_tile_grid(H, W, ts, ov)
    tiles = T.extract_tiles(torch.from_numpy(img), grid, ts).numpy()
    return tiles, T.assign_labels_to_tiles(gt, grid[:, :2], ts)


def write_split(tmp: str, split: str, seeds, ts: int, ov: int,
                size: int = 1024) -> tuple:
    """The label files (``write_labels``) and the list file of the maps'
    tiles in the layout of `data/dataset.py`. Returns (list file, {image path:
    RGB tile} for ``TileDataset(reader=...)``, the BGR tiles)."""
    from oriented_object_detection_tpu_torch.data import labels as L

    for d in ("images", "labels"):
        os.makedirs(f"{tmp}/{d}/{split}", exist_ok=True)
    pixels, bgr = {}, []
    for seed in seeds:
        tiles, labels = map_tiles(seed, ts, ov, size, size)
        for i, (tile, lab) in enumerate(zip(tiles, labels)):
            stem = f"m{seed}_tile_{i}"
            L.write_labels(f"{tmp}/labels/{split}/{stem}.txt", lab)
            pixels[f"{tmp}/images/{split}/{stem}.jpg"] = \
                np.ascontiguousarray(tile[..., ::-1])
        bgr.append(tiles)
    lst = f"{tmp}/{split}.txt"
    with open(lst, "w") as f:
        f.write("\n".join(pixels) + "\n")
    return lst, pixels, np.concatenate(bgr)


@contextlib.contextmanager
def step_recorder(torch, TR):
    """Wraps ``trainer.train_step``, which ``fit`` calls, to keep each
    step's wall seconds (device synchronized at both ends), metrics and
    collective calls (``parallel/distributed.py``)."""
    from oriented_object_detection_tpu_torch.parallel import distributed as PD

    steps, inner = [], TR.train_step

    def recorded(state, batch, cfg):
        torch.cuda.synchronize()
        calls = sum(PD.COLLECTIVES.values())
        t0 = time.perf_counter()
        m = inner(state, batch, cfg)
        torch.cuda.synchronize()
        steps.append({"seconds": time.perf_counter() - t0,
                      "metrics": dict(zip(TR.METRIC_KEYS, m.tolist())),
                      "collectives": sum(PD.COLLECTIVES.values()) - calls})
        return m

    TR.train_step = recorded
    try:
        yield steps
    finally:
        TR.train_step = inner


def check_steps(steps, n: int, label: str) -> None:
    if len(steps) != n:
        raise AssertionError(f"{label}: {len(steps)} steps, not {n}")
    for m in (s["metrics"] for s in steps):
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{label}: non-finite loss {m}")
        if m["fg_count"] <= 0:
            raise AssertionError(f"{label}: a step with no fg anchor {m}")


def moved(before: dict, after: dict) -> tuple:
    """(entries that changed, entries) between two {name: tensor} dicts."""
    n = sum(not bool((before[k] == after[k]).all()) for k in before)
    return n, len(before)


def profile_steps(torch, TR, state, batches, cfg) -> dict:
    """Two train steps under the profiler: wall seconds, the device's busy
    time and idle share, and its time by kind of kernel, per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            TR.train_step(state, b, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        raise AssertionError("the profiler recorded no device work")
    busy = busy_ms((e.time_range.start, e.time_range.end) for e in ops)
    by_kind: dict = {}
    by_name: dict = {}
    for e in ops:
        ms = (e.time_range.end - e.time_range.start) / 1e3 / len(batches)
        kind = kernel_kind(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    return {"steps": len(batches), "seconds_per_step_profiled":
            wall_ms / 1e3, "device_busy_ms": busy / len(batches),
            "idle_share": 1.0 - busy / len(batches) / wall_ms,
            "device_ops_per_step": len(ops) / len(batches),
            "device_ms_by_kind": by_kind,
            "top_kernels": [{"name": k[:90], "device_ms": v} for k, v in
                            sorted(by_name.items(),
                                   key=lambda kv: -kv[1])[:10]]}


def step_flops(torch, TR, state, batch, cfg) -> float:
    """Float operations of one train step (forward and backward) as
    ``torch.utils.flop_counter`` counts them: convolutions and matmuls."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        TR.train_step(state, batch, cfg)
    torch.cuda.synchronize()
    return float(counter.get_total_flops())


def wall_seconds(torch, fn) -> tuple:
    """(result, wall seconds) of ``fn()``, the device synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def train_3ch(torch, tmp: str, smi: str) -> tuple:
    """YOLO11x-OBB, 3 channels, 416/100, batch 16 (``TRAIN``): warm start,
    one epoch of ``fit`` with mosaic and per-epoch validation, the moved
    state, the checkpoint through ``build_detector``, two profiled steps.
    Returns the phase's numbers and the train tiles (BGR)."""
    from oriented_object_detection_tpu_torch.config import TrainConfig
    from oriented_object_detection_tpu_torch.data.loader import TileDataset
    from oriented_object_detection_tpu_torch.eval.val import validate_tiles
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        build_detector)
    from oriented_object_detection_tpu_torch.train import trainer as TR

    ts, ov, bs, size = (TRAIN[k] for k in ("tile_size", "overlap", "batch",
                                           "map_size"))
    cfg = TrainConfig(tile_size=ts, overlap=ov, batch_size=bs,
                      model_scale=TRAIN["scale"], channels=3, epochs=1,
                      plots=False, **F32)
    lst, pixels, bgr = write_split(tmp, "train", TRAIN_SEEDS, ts, ov, size)
    vlst, vpixels, _ = write_split(tmp, "val", (VAL_SEED,), ts, ov, size)
    train_ds = TileDataset(lst, ts, 3, reader=pixels.__getitem__)
    val_ds = TileDataset(vlst, ts, 3, reader=vpixels.__getitem__)
    steps_per_epoch = len(train_ds) // bs
    state = TR.create_train_state(cfg, steps_per_epoch)
    TR.warm_start_state(TRAIN["ckpt"], state, expect={
        "model_scale": TRAIN["scale"], "channels": 3})
    clone = lambda m: {k: v.detach().clone() for k, v in
                       m.state_dict().items()}
    before, ema_before = clone(state.model), clone(state.ema)
    fit_warm_start = validate_tiles(state.eval_model(), val_ds, cfg)
    fits = []

    def val_fn(s):
        fits.append(validate_tiles(s.eval_model(), val_ds, cfg))
        return fits[-1]

    rng = np.random.RandomState(cfg.seed)
    run_dir = os.path.join(tmp, "run_x")
    torch.cuda.reset_peak_memory_stats()
    with step_recorder(torch, TR) as steps:
        TR.fit(state, cfg, lambda e: train_ds.batches(bs, rng),
               val_fn=val_fn, ckpt_dir=run_dir)
    peak = torch.cuda.max_memory_allocated()
    check_steps(steps, steps_per_epoch, "3ch x-scale")
    after = clone(state.model)
    params = {k for k, _ in state.model.named_parameters()}
    stats = {k for k in before if k.endswith(("running_mean",
                                              "running_var"))}
    moved_params = moved({k: before[k] for k in params},
                         {k: after[k] for k in params})
    moved_stats = moved({k: before[k] for k in stats},
                        {k: after[k] for k in stats})
    ema_keys = {k for k in params}
    moved_ema = moved({k: ema_before[k] for k in ema_keys},
                      {k: v for k, v in clone(state.ema).items()
                       if k in ema_keys})
    if moved_params[0] < 0.9 * moved_params[1] or moved_stats[0] != \
            moved_stats[1] or moved_ema[0] < 0.9 * moved_ema[1]:
        raise AssertionError(f"state did not move: params {moved_params}, "
                             f"BN statistics {moved_stats}, EMA {moved_ema}")
    if len(fits) != 1 or not 0.0 <= fits[0] <= 1.0:
        raise AssertionError(f"validation fitness {fits}")

    # the written checkpoint, read back by the detector
    vimg, _ = synthetic_map(VAL_SEED, H=size, W=size)
    det = build_detector([(ts, ov, os.path.join(run_dir, "last.ckpt"))],
                         **F32)
    rows = det.detect_image(vimg)["merged_for_pr"]
    check_rows(rows, *vimg.shape[:2], det.cfg.conf_thr_predict)
    del det

    # the layers apart: a loader batch, validation, a checkpoint write, the
    # step's operations, then two profiled steps
    it = train_ds.batches(bs, np.random.RandomState(1))
    loader_s = [wall_seconds(torch, lambda: next(it))[1] for _ in range(3)]
    extra = {"loader_seconds_per_batch": statistics.median(loader_s),
             "validate_seconds": wall_seconds(torch, lambda: validate_tiles(
                 state.eval_model(), val_ds, cfg))[1],
             "checkpoint_write_seconds": wall_seconds(
                 torch, lambda: TR.save_checkpoint(
                     os.path.join(tmp, "ck.ckpt"), state))[1]}
    batches = list(itertools.islice(train_ds.batches(
        bs, np.random.RandomState(2)), 3))
    flops = step_flops(torch, TR, state, batches[0], cfg)
    prof = profile_steps(torch, TR, state, batches[1:], cfg)
    warm = [s["seconds"] for s in steps[1:]]
    return {"model_scale": cfg.model_scale, "channels": 3, "tile_size": ts,
            "overlap": ov, "batch": bs, "train_tiles": len(train_ds),
            "val_tiles": len(val_ds), "steps": len(steps),
            "seconds_per_step": statistics.median(warm),
            "seconds_per_step_all": [s["seconds"] for s in steps],
            "losses": [s["metrics"] for s in steps],
            "peak_memory_gib": peak / 2 ** 30, "nvidia_smi": smi,
            "moved": {"params": moved_params, "bn_statistics": moved_stats,
                      "ema": moved_ema},
            "fitness_warm_start": fit_warm_start, "fitness": fits[0],
            "detect_rows": len(rows), **extra, "step_tflop": flops / 1e12,
            "conv_tflops_per_s": flops / 1e9 / prof["device_ms_by_kind"].get(
                "conv_matmul", float("nan")),
            "profile": prof,
            # the profiler's own cost slows each launch; the busy time over
            # the unprofiled step is the idle share the step really has
            "idle_share_unprofiled": 1.0 - prof["device_busy_ms"] / (
                statistics.median(warm) * 1e3)}, bgr


def train_4ch(torch, E, tmp: str, bgr: np.ndarray) -> dict:
    """The 4-channel build of the train tiles on the card (both EDT kernels,
    the DT channel against the plain versions'), then 2 steps of
    YOLO11n-OBB 4ch from ``train416_4ch.ckpt``."""
    from oriented_object_detection_tpu_torch.config import (DTEdgeConfig,
                                                            TrainConfig)
    from oriented_object_detection_tpu_torch.data import dataset as DS
    from oriented_object_detection_tpu_torch.data.loader import TileDataset
    from oriented_object_detection_tpu_torch.ops import dtedge as DT
    from oriented_object_detection_tpu_torch.train import trainer as TR

    ts, bs = TRAIN["tile_size"], TRAIN["batch"]
    tiles = torch.from_numpy(bgr).cuda()
    for k in E.LAUNCHES:
        E.LAUNCHES[k] = 0
    four = torch.cat([DS.tiles_to_4ch(tiles[i:i + bs])
                      for i in range(0, len(tiles), bs)])
    torch.cuda.synchronize()
    launches = dict(E.LAUNCHES)
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the 4ch build never ran: "
                             f"{launches}")
    plain = torch.cat([DT.dt_edge_channel(tiles[i:i + bs], DTEdgeConfig(),
                                          edt=E.edt_l2_plain)
                       for i in range(0, len(tiles), bs)])
    if not torch.equal(four[:, 3], plain):
        raise AssertionError("the 4ch build's DT channel differs from the "
                             "plain versions'")
    if not torch.equal(four[:, :3], tiles.flip(-1).permute(0, 3, 1, 2)):
        raise AssertionError("the 4ch build's RGB pages are not the tiles'")

    hwc = four.permute(0, 2, 3, 1).cpu().numpy()
    with open(f"{tmp}/train.txt") as f:
        paths = f.read().split()
    pixels = dict(zip(paths, hwc))
    ds = TileDataset(f"{tmp}/train.txt", ts, 4, reader=pixels.__getitem__)
    cfg = TrainConfig(tile_size=ts, batch_size=bs, model_scale="n",
                      channels=4, epochs=1, plots=False, **F32)
    state = TR.create_train_state(cfg, len(ds) // bs)
    TR.warm_start_state(CKPT, state, expect={"model_scale": "n",
                                             "channels": 4})
    rng = np.random.RandomState(cfg.seed)
    with step_recorder(torch, TR) as steps:
        TR.fit(state, cfg, lambda e: itertools.islice(ds.batches(bs, rng),
                                                      2),
               ckpt_dir=os.path.join(tmp, "run_4ch"))
    check_steps(steps, 2, "4ch n-scale")
    return {"tiles": len(four), "launches": launches, "dt_bit_equal": True,
            "model_scale": "n", "channels": 4, "tile_size": ts, "batch": bs,
            "steps": len(steps),
            "seconds_per_step_all": [s["seconds"] for s in steps],
            "losses": [s["metrics"] for s in steps]}


def max_rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-6))


def tree_leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def train_card_vs_cpu(torch, tmp: str, card: str = "cuda",
                      dtype: str = "float32") -> dict:
    """The loader's batches and one n-scale step at tile 64, batch 2 from
    ``train128.ckpt`` on the same batch, on the card and on the CPU, in
    ``dtype``: float32 held to ``STEP_RTOL``, bf16 to ``BF16_STEP``."""
    from oriented_object_detection_tpu_torch.config import TrainConfig
    from oriented_object_detection_tpu_torch.data.loader import TileDataset
    from oriented_object_detection_tpu_torch.models.weights import (
        load_state, torch_state_from_jax, variables_from_checkpoint)
    from oriented_object_detection_tpu_torch.train import trainer as TR

    lst, pixels, _ = write_split(f"{tmp}/step", "train", (STEP_SEED,), 64,
                                 0, size=256)
    # the loader's batches for one seed, composed on each device, are equal
    # bit for bit (mosaic, warp, flip and HSV)
    on_card, on_cpu = (list(itertools.islice(TileDataset(
        lst, 64, 3, device=dev, reader=pixels.__getitem__).batches(
        2, np.random.RandomState(0)), 3)) for dev in (card, "cpu"))
    for a, b in zip(on_card, on_cpu):
        for k in a:
            if not torch.equal(a[k].cpu(), b[k]):
                raise AssertionError(f"loader batch {k} differs between "
                                     f"the card and the CPU")
    batch = on_cpu[0]
    if not batch["gt_mask"].any():
        raise AssertionError("the step batch has no box")
    cfg = TrainConfig(tile_size=64, batch_size=2, model_scale="n", epochs=3,
                      compute_dtype=dtype)
    start = variables_from_checkpoint(STEP_CKPT)
    weights = torch_state_from_jax(start)
    out = {}
    for dev in (card, "cpu"):
        st = TR.create_train_state(cfg, 4, device=dev)
        load_state(st.model, weights)
        st.reset_ema()
        m = TR.train_step(st, {k: v.to(dev) for k, v in batch.items()}, cfg)
        out[dev] = (m.cpu().numpy(), TR.checkpoint_payload(st))
    (mc, pc), (mh, ph) = out[card], out["cpu"]
    if mc[4] != mh[4] or mc[4] <= 0:
        raise AssertionError(f"fg count card {mc[4]} cpu {mh[4]}")
    if dtype == "bfloat16":
        gap = check_bf16_step("card against CPU", start, [out[card]],
                              [out["cpu"]])
        return {"model_scale": "n", "tile_size": 64, "batch": 2,
                "compute_dtype": dtype,
                "metrics_card": dict(zip(TR.METRIC_KEYS, mc.tolist())),
                "metrics_cpu": dict(zip(TR.METRIC_KEYS, mh.tolist())),
                "gap": gap, "bound": BF16_STEP}
    worst = {"loss": max_rel(mh[:4], mc[:4])}
    for key in ("params", "batch_stats"):
        cpu = dict(tree_leaves(ph[key]))
        worst[key] = max(max_rel(cpu[k], v) for k, v in
                         tree_leaves(pc[key]))
    for key, tol in STEP_RTOL.items():
        if not worst[key] <= tol:
            raise AssertionError(f"card and CPU steps differ: {key} "
                                 f"{worst[key]} > {tol}")
    return {"model_scale": "n", "tile_size": 64, "batch": 2,
            "loader_batches_bit_equal": len(on_cpu),
            "metrics_card": dict(zip(TR.METRIC_KEYS, mc.tolist())),
            "metrics_cpu": dict(zip(TR.METRIC_KEYS, mh.tolist())),
            "max_rel": worst, "tolerance": STEP_RTOL}


def phase_train(torch, E, smi: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        x3, bgr = train_3ch(torch, tmp, smi)
        emit({"phase": "train", "part": "3ch", **x3})
        c4 = train_4ch(torch, E, tmp, bgr)
        emit({"phase": "train", "part": "4ch", **c4})
        step = train_card_vs_cpu(torch, tmp)
        emit({"phase": "train", "part": "card_vs_cpu", **step})
    return {"launches": c4["launches"],
            "seconds_per_step": x3["seconds_per_step"]}


# ---------------------------------------------------------------------------
# bf16, the default compute dtype
# ---------------------------------------------------------------------------

# bf16 rows against the float32 rows of the same maps, by the rule of the
# CPU rows test (``tests/test_torch_bf16_rows.py``): rows with conf >= 0.35
# paired one to one by class and IoU >= 0.5, a row within 0.05 of the 0.35
# cut may lack a partner, and of the rows above it at most 1% (rounded
# down: none below 100 rows) may, where bf16 flips a class or an NMS or
# merge decision; the pairs' conf within 0.05 (the margin, so that no pair
# can cross the cut unseen). The pairs' corner distance is reported: after
# the merge across overlapping tiles, a pair may be two tiles' views of one
# object, a few pixels apart (on a one-tile map on the CPU the JAX
# package's own bf16 rows came within 0.365 px and 0.0286 of its float32
# rows). The rule holds the rows of each scale; the fused rows of two
# scales are reported: the cross-scale consensus keeps the stronger row of
# a pair, or drops a row whose partner crosses its thresholds
# (``infer/fusion.py``), so a last-bit difference there moves a row of any
# confidence.
BF16_ROWS = {"conf": 0.35, "margin": 0.05, "iou": 0.5, "dconf": 0.05}
# bf16 train steps against float32 steps from the same state and batches
# (and the card's bf16 step against the CPU's), both at step 0 as ``fit``
# starts: each loss part's relative difference, root mean square over the
# batches, within 1e-2 (the CPU step test's floor, 2.56 bf16 epsilons); over
# the leaves that moved (at step 0 the bias group alone), the median
# relative L2 distance of the updates within 1.25 times the JAX package's
# own bf16-versus-float32 median at step 0 on the CPU
# (``tests/test_torch_bf16_train.py`` prints it, YOLO11n-OBB: 0.0936 for the
# parameters, 0.0239 for the BatchNorm statistics)
BF16_STEP = {"loss": 1e-2, "params": 1.25 * 0.0936,
             "batch_stats": 1.25 * 0.0239}


def pair_bf16_rows(a: np.ndarray, b: np.ndarray) -> dict:
    """Pairs ``a``'s rows (bf16) with ``b``'s (float32) by ``BF16_ROWS``:
    the pair count, the largest corner distance and |dconf| over the pairs,
    the rows with conf >= 0.40 of each side, and each such row left without
    a partner, with the row of the other side it overlaps most (any
    class)."""
    from oriented_object_detection_tpu_torch.utils import native

    lo = BF16_ROWS["conf"] - BF16_ROWS["margin"]
    hi = BF16_ROWS["conf"] + BF16_ROWS["margin"]
    a, b = a[a[:, 9] >= lo], b[b[:, 9] >= lo]
    overlap = native.quad_iou_matrix(np.ascontiguousarray(a[:, :8]),
                                     np.ascontiguousarray(b[:, :8])) \
        if len(a) and len(b) else np.zeros((len(a), len(b)))
    iou = np.where(a[:, 8:9] == b[None, :, 8], overlap, 0.0)
    used_a, used_b = np.zeros(len(a), bool), np.zeros(len(b), bool)
    dist, dconf, pairs = 0.0, 0.0, 0
    for i in np.argsort(-a[:, 9], kind="stable"):
        cand = np.where(~used_b & (iou[i] >= BF16_ROWS["iou"]), iou[i], -1.0)
        if not len(b) or cand.max() < BF16_ROWS["iou"]:
            continue
        j = int(cand.argmax())
        used_a[i] = used_b[j] = True
        if max(a[i, 9], b[j, 9]) < BF16_ROWS["conf"]:
            continue
        p, q = a[i, :8].reshape(4, 2), b[j, :8].reshape(4, 2)
        dist = max(dist, min(float(np.linalg.norm(
            p - np.roll(q, k, axis=0), axis=1).max()) for k in range(4)))
        dconf = max(dconf, abs(float(a[i, 9] - b[j, 9])))
        pairs += 1
    lone = []
    for side, rows, used, other, ov in (("bf16", a, used_a, b, overlap),
                                        ("float32", b, used_b, a,
                                         overlap.T)):
        for i in np.flatnonzero(~used & (rows[:, 9] >= hi)):
            k = int(ov[i].argmax()) if len(other) else None
            lone.append({"side": side, "cls": int(rows[i, 8]),
                         "conf": float(rows[i, 9]),
                         "nearest": None if k is None else {
                             "iou": float(ov[i, k]),
                             "cls": int(other[k, 8]),
                             "conf": float(other[k, 9])}})
    return {"pairs": pairs, "max_corner_px": dist, "max_dconf": dconf,
            "rows": max(int((a[:, 9] >= hi).sum()),
                        int((b[:, 9] >= hi).sum())), "unpaired": lone}


def pair_maps(got: list, ref: list, label: str, strict: bool = True) -> dict:
    """``pair_bf16_rows`` map by map (bf16 ``got`` against float32 ``ref``):
    the pairs and rows summed, the largest gaps, the unpaired rows. With
    ``strict``, raises unless the pairs' |dconf| is within
    ``BF16_ROWS["dconf"]`` and at most 1% of the rows (rounded down) lack a
    partner."""
    out = [pair_bf16_rows(a, b) for a, b in zip(got, ref)]
    res = {"pairs": sum(o["pairs"] for o in out),
           "rows": sum(o["rows"] for o in out),
           "max_corner_px": max(o["max_corner_px"] for o in out),
           "max_dconf": max(o["max_dconf"] for o in out),
           "unpaired": [{"map": i, **u} for i, o in enumerate(out)
                        for u in o["unpaired"]]}
    if strict and (len(res["unpaired"]) > res["rows"] // 100
                   or res["max_dconf"] > BF16_ROWS["dconf"]):
        raise AssertionError(f"{label}: {res}")
    return res


def conv_output_dtypes(torch, models) -> tuple:
    """Forward hooks on every ConvBN and head conv of ``models``: (the set of
    their output dtypes, filled as they run; the hooks, to remove)."""
    from oriented_object_detection_tpu_torch.models import layers as TL

    seen = set()
    hooks = [m.register_forward_hook(lambda m, i, o: seen.add(str(o.dtype)))
             for model in models for m in model.modules()
             if isinstance(m, (TL.ConvBN, TL.Conv2d))]
    return seen, hooks


def bf16_dual(torch, f32: list, profile: int) -> dict:
    """``detect_dual`` at the defaults (bf16, the int8 x-scale checkpoints)
    over the batch phase's eight maps: every conv output bf16, seconds a
    map one at a time (median of 5) and through ``detect_images``, peak
    memory, device busy time; each scale's rows paired with the float32
    results ``f32`` of the same maps, the fused rows reported; the metric
    block of one map."""
    import dataclasses

    from oriented_object_detection_tpu_torch.eval import metrics as M
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        build_detector)

    made = [synthetic_map(s) for s in DUAL_BATCH_SEEDS]
    maps = [m for m, _ in made]
    det = build_detector(DUAL)
    if det.cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"detect_dual defaults to "
                             f"{det.cfg.compute_dtype}")
    seen, hooks = conv_output_dtypes(torch, det.models.values())
    det.detect_image(maps[0])
    for h in hooks:
        h.remove()
    if seen != {"torch.bfloat16"}:
        raise AssertionError(f"conv outputs {seen}, not bf16 alone")
    times = seconds_per_map(torch, det, maps[0])
    torch.cuda.reset_peak_memory_stats()
    per_map = [det.detect_image(m) for m in maps]
    peak_one = torch.cuda.max_memory_allocated() / 2 ** 30
    rows = [r["merged_for_pr"] for r in per_map]
    for r in rows:
        check_rows(r, 1024, 1024, det.cfg.conf_thr_predict)
    paired = {str(ts): pair_maps([r["by_scale"][ts] for r in per_map],
                                 [r["by_scale"][ts] for r in f32],
                                 f"bf16 dual {ts}")
              for ts in (128, 416)}
    paired["fused"] = pair_maps(rows, [r["merged_for_pr"] for r in f32],
                                "bf16 dual fused", strict=False)
    det.detect_images(maps)
    torch.cuda.reset_peak_memory_stats()
    batch = [wall_seconds(torch, lambda: det.detect_images(maps))[1]
             for _ in range(3)]
    peak_batch = torch.cuda.max_memory_allocated() / 2 ** 30
    busy, ops = device_busy(torch, lambda: det.detect_images(maps))
    if profile:
        phase_profile(torch, det, maps[0], profile, "bf16_dual_profile")

    det.cfg = dataclasses.replace(det.cfg, calculate_metrics=True)
    mres = det.detect_image(maps[0])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.png")
        open(path, "wb").close()
        block = M.run_fusion_eval(
            {path: mres["merged_for_pr"]}, tmp, tmp,
            iou_thr=det.cfg.metrics_iou,
            dets_map={path: mres["merged_for_map"]},
            cache=M.GTCache(loader=lambda _: made[0][1]),
            map_min_score=det.cfg.map_min_score)
    numbers = [v for v in block.values() for v in np.ravel(v)]
    if len(block) != 8 or not all(np.isfinite(v) and 0.0 <= v <= 1.0
                                  for v in numbers):
        raise AssertionError(f"bf16 metric block out of range: {block}")
    wall = statistics.median(batch)
    return {"maps": len(maps), "map": [1024, 1024], "model_scale": "x",
            "conv_output_dtypes": sorted(seen),
            "seconds_per_map": statistics.median(times),
            "seconds_per_map_all": times, "peak_memory_gib": peak_one,
            "batch_seconds_per_map": wall / len(maps),
            "batch_seconds_per_map_all": [t / len(maps) for t in batch],
            "batch_peak_memory_gib": peak_batch,
            "batch_device_busy_ms_per_map": busy / len(maps),
            "batch_idle_share": 1.0 - busy / (wall * 1e3),
            "batch_device_ops_per_map": ops / len(maps),
            "rows": [len(r) for r in rows],
            "float32_rows": [len(r["merged_for_pr"]) for r in f32],
            "paired_with_float32": paired,
            "metrics": {k: np.ravel(v).tolist() for k, v in block.items()}}


def bf16_4ch(torch, E, f32_rows: list, profile: int) -> dict:
    """``detect_416_4ch`` in bf16 over the batch phase's four maps, one at a
    time and in one batch: K1 and K2 launched (once a map, once for the
    batch), every output bit-equal to its plain version on the same input;
    rows paired with the float32 rows; with ``profile``, the first map
    profiled as the slice is (``bf16_4ch_profile``)."""
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        build_detector)

    maps = [synthetic_map(s, H=h, W=w)[0]
            for s, (h, w) in zip(BATCH_SEEDS, BATCH_SHAPES)]
    det = build_detector([(416, 100, CKPT)], channels=4)
    if det.dtype != torch.bfloat16:
        raise AssertionError(f"the 4ch slice runs {det.dtype}")
    out = {}
    for mode, fn, n in (
            ("per_image", lambda: [det.detect_image(m) for m in maps],
             len(maps)),
            ("batch", lambda: det.detect_images(maps), 1)):
        fn()
        with PathKernels(E) as rec:
            reset_launches(E)
            res, sec = wall_seconds(torch, fn)
            launches = dict(E.LAUNCHES)
        if launches != {k: n for k in KERNELS}:
            raise AssertionError(f"bf16 4ch {mode}: launches {launches}, "
                                 f"not {n} each")
        out[mode] = {"launches": launches,
                     "kernels_bit_equal_to_plain": rec.check(
                         torch, f"bf16 4ch {mode}"),
                     "seconds_per_map": sec / len(maps),
                     "rows": [len(r["merged_for_pr"]) for r in res],
                     "paired_with_float32": pair_maps(
                         [r["merged_for_pr"] for r in res], f32_rows,
                         f"bf16 4ch {mode}")}
    if profile:
        phase_profile(torch, det, maps[0], profile, "bf16_4ch_profile")
    return out


@contextlib.contextmanager
def cv2_stand_in():
    """``CV2_STAND_IN`` as the ``cv2`` module inside the block."""
    import types

    mod = types.ModuleType("cv2")
    exec(CV2_STAND_IN, mod.__dict__)
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = mod
    try:
        yield
    finally:
        if saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved


def bf16_cli(torch, img: np.ndarray) -> dict:
    """``cli.py detect`` at the reference's two scales with no dtype
    setting, on one map: its models hold bf16 weights and give bf16 conv
    outputs, and it writes the jpg and the xlsx (through ``cv2_stand_in``:
    the card's machine has no cv2)."""
    from oriented_object_detection_tpu_torch import cli
    from oriented_object_detection_tpu_torch.infer import pipeline as P

    built, build = [], P.build_detector

    def spy(*a, **k):
        det = build(*a, **k)
        built.append((det, *conv_output_dtypes(torch, det.models.values())))
        return det

    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(src)
        with open(os.path.join(src, "map0.png"), "wb") as f:
            np.save(f, img)
        P.build_detector = spy
        try:
            with cv2_stand_in():
                _, sec = wall_seconds(torch, lambda: cli.main([
                    "detect", "--input", src, "--output", dst, "--scales",
                    ",".join(f"{ts}:{ov}={ck}" for ts, ov, ck in DUAL)]))
        finally:
            P.build_detector = build
        files = sorted(os.listdir(dst))
        with zipfile.ZipFile(os.path.join(dst, "map0.xlsx")) as z:
            sheet = z.read("xl/worksheets/sheet1.xml").decode()
    (det, seen, hooks), = built
    for h in hooks:
        h.remove()
    weights = {str(p.dtype) for m in det.models.values()
               for p in m.parameters()}
    if det.cfg.compute_dtype != "bfloat16" or weights != {"torch.bfloat16"} \
            or seen != {"torch.bfloat16"}:
        raise AssertionError(f"cli detect: {det.cfg.compute_dtype}, weights "
                             f"{weights}, conv outputs {seen}")
    if files != ["map0.xlsx", "map0_detected.jpg"] or \
            sheet.count("<row ") < 2:
        raise AssertionError(f"cli detect wrote {files}")
    return {"compute_dtype": det.cfg.compute_dtype, "weights": sorted(weights),
            "conv_output_dtypes": sorted(seen), "files": files,
            "xlsx_rows": sheet.count("<row ") - 1, "seconds": sec}


def step_gap(start: dict, a: list, b: list) -> dict:
    """Steps ``a`` against steps ``b``, each from ``start`` ({'params',
    'batch_stats'} trees), one pair a batch, each step (metrics, trees
    after it): per loss part the root mean square over the batches of the
    relative difference, and per tree the median over the leaves that moved
    in ``b`` of |update_a - update_b| / |update_b| (L2 over the batches)."""
    ma, mb = (np.stack([m for m, _ in x])[:, :4] for x in (a, b))
    out = {"loss_parts": np.sqrt(np.mean(((ma - mb) / mb) ** 2,
                                         axis=0)).tolist()}
    out["loss"] = max(out["loss_parts"])
    for key in ("params", "batch_stats"):
        s = dict(tree_leaves(start[key]))
        ua = [dict(tree_leaves(t[key])) for _, t in a]
        num, den = {}, {}
        for ta, (_, tb) in zip(ua, b):
            for k, vb in tree_leaves(tb[key]):
                db = vb - s[k]
                num[k] = num.get(k, 0.0) + np.sum((ta[k] - s[k] - db) ** 2)
                den[k] = den.get(k, 0.0) + np.sum(db ** 2)
        rel = [np.sqrt(num[k] / den[k]) for k in den if den[k] > 0]
        out[key] = float(np.median(rel))
        out[f"{key}_moved"] = len(rel)
    return out


def check_bf16_step(label: str, start: dict, a: list, b: list) -> dict:
    """``step_gap`` within ``BF16_STEP``; the numbers are emitted first."""
    gap = step_gap(start, a, b)
    emit({"phase": "bf16", "part": "step_gap", "label": label, **gap,
          "bound": BF16_STEP})
    bad = [f"{k} {gap[k]} > {v}" for k, v in BF16_STEP.items()
           if not gap[k] <= v]
    if bad:
        raise AssertionError(f"{label}: " + "; ".join(bad))
    return gap


def float32_state(torch, state) -> dict:
    """Raises unless every parameter, gradient, momentum buffer, EMA leaf
    and BatchNorm statistic of ``state`` is float32; returns their
    counts."""
    model = state.model
    found = {
        "params": [p.dtype for p in model.parameters()],
        "grads": [p.grad.dtype for p in model.parameters()
                  if p.grad is not None],
        "momentum": [state.opt.state[p]["momentum_buffer"].dtype
                     for p in model.parameters() if p in state.opt.state],
        "ema": [p.dtype for p in state.ema.parameters()],
        "statistics": [b.dtype for n, b in model.named_buffers()
                       if n.endswith(("running_mean", "running_var"))]}
    n = len(found["params"])
    for key, dtypes in found.items():
        if set(dtypes) != {torch.float32} or (
                key != "statistics" and len(dtypes) != n):
            raise AssertionError(f"{key} after a bf16 step: "
                                 f"{sorted(set(map(str, dtypes)))}")
    return {k: len(v) for k, v in found.items()}


def bf16_train(torch, tmp: str, smi: str) -> dict:
    """``train_416`` at the default bf16: the first step against the float32
    step from the same warm start and batch (``BF16_STEP``), then ``fit``
    for one epoch of 4 steps (finite losses, float32 optimizer state,
    seconds a step, peak memory) and two profiled steps."""
    import dataclasses

    from oriented_object_detection_tpu_torch.config import TrainConfig
    from oriented_object_detection_tpu_torch.data.loader import TileDataset
    from oriented_object_detection_tpu_torch.models.weights import (
        jax_trees_from_torch_state)
    from oriented_object_detection_tpu_torch.train import trainer as TR

    ts, ov, bs, size = (TRAIN[k] for k in ("tile_size", "overlap", "batch",
                                           "map_size"))
    cfg = TrainConfig(tile_size=ts, overlap=ov, batch_size=bs,
                      model_scale=TRAIN["scale"], channels=3, epochs=1,
                      plots=False)
    if cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"train_416 defaults to {cfg.compute_dtype}")
    lst, pixels, _ = write_split(tmp, "train", TRAIN_SEEDS, ts, ov, size)
    train_ds = TileDataset(lst, ts, 3, reader=pixels.__getitem__)
    steps_per_epoch = len(train_ds) // bs
    expect = {"model_scale": TRAIN["scale"], "channels": 3}

    def warm(c):
        st = TR.create_train_state(c, steps_per_epoch)
        return TR.warm_start_state(TRAIN["ckpt"], st, expect=expect)

    # the first step of fit (step 0) from the warm start, on each of the
    # epoch's first four batches, in bf16 and in float32
    first = list(itertools.islice(train_ds.batches(
        bs, np.random.RandomState(cfg.seed)), 4))
    trees = lambda st: jax_trees_from_torch_state(st.model.state_dict())
    one = {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        st = warm(c)
        start, saved = trees(st), {k: v.clone() for k, v in
                                   st.model.state_dict().items()}
        one[dtype] = []
        for b in first:
            st.model.load_state_dict(saved)
            st.opt.state.clear()
            st.step = 0
            m = TR.train_step(st, b, c)
            one[dtype].append((m.cpu().numpy(), trees(st)))
        del st, saved
        torch.cuda.empty_cache()
    gap = check_bf16_step("bf16 against float32", start, one["bfloat16"],
                          one["float32"])

    state = warm(cfg)
    rng = np.random.RandomState(cfg.seed)
    torch.cuda.reset_peak_memory_stats()
    with step_recorder(torch, TR) as steps:
        TR.fit(state, cfg, lambda e: train_ds.batches(bs, rng),
               ckpt_dir=os.path.join(tmp, "run_bf16"))
    peak = torch.cuda.max_memory_allocated()
    check_steps(steps, steps_per_epoch, "bf16 x-scale")
    counts = float32_state(torch, state)
    batches = list(itertools.islice(train_ds.batches(
        bs, np.random.RandomState(2)), 2))
    prof = profile_steps(torch, TR, state, batches, cfg)
    warm_s = [s["seconds"] for s in steps[1:]]
    return {"model_scale": cfg.model_scale, "channels": 3, "tile_size": ts,
            "batch": bs, "compute_dtype": cfg.compute_dtype,
            "steps": len(steps),
            "seconds_per_step": statistics.median(warm_s),
            "seconds_per_step_all": [s["seconds"] for s in steps],
            "losses": [s["metrics"] for s in steps],
            "peak_memory_gib": peak / 2 ** 30, "nvidia_smi": smi,
            "float32_state": counts,
            "first_step": {"metrics": {dtype: [dict(zip(
                TR.METRIC_KEYS, m.tolist())) for m, _ in runs]
                for dtype, runs in one.items()}, "gap": gap,
                "bound": BF16_STEP},
            "profile": prof,
            "idle_share_unprofiled": 1.0 - prof["device_busy_ms"] / (
                statistics.median(warm_s) * 1e3)}


def phase_bf16(torch, E, smi: str, f32: dict, img: np.ndarray,
               profile: int) -> dict:
    """bf16, the default compute dtype, on every path that runs it:
    ``detect_dual`` (``bf16_dual``), the 4ch slice (``bf16_4ch``),
    ``cli.py detect`` (``bf16_cli``), ``train_416`` (``bf16_train``) and an
    n-scale bf16 step on the card against the CPU's. Any failure raises: a
    bf16 path that does not run is not replaced by float32."""
    if not torch.cuda.is_bf16_supported():
        raise AssertionError("the card does not support bf16")
    t0 = time.perf_counter()
    dual = bf16_dual(torch, f32["dual"], profile)
    emit({"phase": "bf16", "part": "dual", **dual})
    four = bf16_4ch(torch, E, f32["4ch"], profile)
    emit({"phase": "bf16", "part": "4ch", "model_scale": "n", **four})
    emit({"phase": "bf16", "part": "cli", **bf16_cli(torch, img)})
    with tempfile.TemporaryDirectory() as tmp:
        train = bf16_train(torch, tmp, smi)
        emit({"phase": "bf16", "part": "train", **train})
        step = train_card_vs_cpu(torch, tmp, dtype="bfloat16")
    emit({"phase": "bf16", "part": "card_vs_cpu", **step,
          "phase_seconds": time.perf_counter() - t0})
    return {mode: four[mode]["launches"] for mode in four}


DIST_SEEDS = (41, 42)        # the two 1024x1024 maps detected under --dist
DIST_STEPS = 3
# each data-parallel run against the one-process run on the same card. In
# float64 (a control of the training semantics) the per-step losses within
# 1e-4 relative, the parameters, EMA and BN statistics after the steps
# within 1e-4 of each leaf's largest value. In float32 the losses and BN
# statistics the same, the parameters and EMA within 1e-3: the bias group's
# warmup lr (0.1) moves the head biases by up to 3 in 3 steps, and splitting
# the batch (other sums, other cuDNN algorithms at 8 rows) moves them by
# up to 2.5e-4 of their size (PERF.md, section 6), as the card's step against
# the CPU's is held to 1e-3 (``STEP_RTOL``). The sharded validation's
# fitness within 1e-6.
DIST_TOL = {"float64": {"loss": 1e-4, "params": 1e-4, "ema_params": 1e-4,
                        "batch_stats": 1e-4},
            "float32": {"loss": 1e-4, "params": 1e-3, "ema_params": 1e-3,
                        "batch_stats": 1e-4},
            "fitness": 1e-6}
DIST_TIMEOUT_S = 600
# the card's machine has no cv2: the CLI run of the dist phase imports this
# module in its place, which reads and writes arrays in numpy's format
# whatever the file's suffix and draws nothing
CV2_STAND_IN = """import numpy as np
FONT_HERSHEY_SIMPLEX, LINE_AA = 0, 16
def imread(path, flags=None):
    try:
        return np.load(path)
    except (OSError, ValueError):
        return None
def imwrite(path, img, params=None):
    with open(path, "wb") as f:
        np.save(f, np.asarray(img))
    return True
def polylines(img, *args, **kwargs):
    return img
def putText(img, *args, **kwargs):
    return img
"""


def dist_inputs(tmp: str) -> str:
    """The train and val tiles of the train phase (``TRAIN``), their BGR
    tiles for the 4ch build, the ``DIST_SEEDS`` maps and the configuration
    (``TRAIN``, the 4ch checkpoint, ``DUAL``), pickled once for every
    process of the phase. Returns the pickle's path."""
    import pickle

    ts, ov, size = (TRAIN[k] for k in ("tile_size", "overlap", "map_size"))
    lst, pixels, bgr = write_split(tmp, "train", TRAIN_SEEDS, ts, ov, size)
    vlst, vpixels, _ = write_split(tmp, "val", (VAL_SEED,), ts, ov, size)
    path = os.path.join(tmp, "dist_inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump({"list": lst, "pixels": pixels, "vlist": vlst,
                     "vpixels": vpixels, "bgr": bgr,
                     "maps": [synthetic_map(s)[0] for s in DIST_SEEDS],
                     "train": TRAIN, "ckpt4": CKPT, "dual": DUAL}, f)
    return path


def dist_train(torch, inputs: dict, run_dir: str, dtype: str) -> dict:
    """``fit`` for ``DIST_STEPS`` steps of the ``TRAIN`` model on this
    process's rows of each global batch with mosaic, warm-started (the run
    directory ``run_dir/rank{r}``), in ``dtype``; in float32 with the
    sharded validation of the warm start and of the epoch."""
    from oriented_object_detection_tpu_torch.config import TrainConfig
    from oriented_object_detection_tpu_torch.data.loader import TileDataset
    from oriented_object_detection_tpu_torch.eval.val import validate_tiles
    from oriented_object_detection_tpu_torch.parallel import distributed as PD
    from oriented_object_detection_tpu_torch.parallel import mesh as PM
    from oriented_object_detection_tpu_torch.train import trainer as TR

    train = inputs["train"]
    ts, bs = train["tile_size"], train["batch"]
    cfg = TrainConfig(tile_size=ts, overlap=train["overlap"], batch_size=bs,
                      model_scale=train["scale"], channels=3, epochs=1,
                      plots=False, **F32)
    train_ds = TileDataset(inputs["list"], ts, 3,
                           reader=inputs["pixels"].__getitem__)
    val_ds = TileDataset(inputs["vlist"], ts, 3,
                         reader=inputs["vpixels"].__getitem__)
    state = TR.create_train_state(cfg, len(train_ds) // bs)
    TR.warm_start_state(train["ckpt"], state, expect={
        "model_scale": train["scale"], "channels": 3})
    out, fits, val_fn = {}, [], None
    if dtype == "float64":
        state.model.double()
        state.ema.double()
        # ``train_step`` casts the images to the config's float32; the
        # control's model takes them back to float64
        forward = state.model.forward
        state.model.forward = lambda x: forward(x.double())
    else:
        out["fitness_warm_start"] = validate_tiles(
            state.eval_model(), val_ds, cfg, shard_across_processes=True)

        def val_fn(s):
            fits.append(validate_tiles(s.eval_model(), val_ds, cfg,
                                       shard_across_processes=True))
            return fits[-1]

    rows = PM.batch_rows(bs, PD.rank(), PD.world())
    rng = np.random.RandomState(cfg.seed)

    def batches(epoch):
        for b in itertools.islice(train_ds.batches(bs, rng, rows=rows),
                                  DIST_STEPS):
            yield {**b, "images": b["images"].to(getattr(torch, dtype))}

    torch.cuda.reset_peak_memory_stats()
    with step_recorder(torch, TR) as steps:
        TR.fit(state, cfg, batches, val_fn=val_fn,
               ckpt_dir=os.path.join(run_dir, f"rank{PD.rank()}"))
    out.update(steps=steps, fitness=fits, rows=list(rows),
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               checksums=PD.tensor_checksums(list(TR.state_tensors(
                   state).values())).cpu().numpy())
    return out


def dist_run(torch, E, inputs: dict, run_dir: str,
             dtype: str = "float32") -> dict:
    """The dist phase's work in this process, on its share, in a
    data-parallel group or (the reference) alone. In float32: the 4ch build
    of the train tiles (process 0 alone, K1/K2 held to their plain
    versions), ``dist_train`` and ``detect_images`` of the 4ch slice (K1/K2
    on this process's tiles, held to their plain versions) and of
    ``detect_dual`` over the ``DIST_SEEDS`` maps. In float64:
    ``dist_train`` alone."""
    from oriented_object_detection_tpu_torch.data import dataset as DS
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        build_detector)
    from oriented_object_detection_tpu_torch.parallel import distributed as PD

    out = {"rank": PD.rank(), "world": PD.world(), "dtype": dtype,
           "backend": torch.distributed.get_backend() if PD.active()
           else None, "device": torch.cuda.current_device()}
    if dtype == "float64":
        return {**out, **dist_train(torch, inputs, run_dir, dtype)}
    bs = inputs["train"]["batch"]
    with PathKernels(E) as rec:
        reset_launches(E)
        if PD.is_main():
            tiles = torch.from_numpy(inputs["bgr"]).cuda()
            for i in range(0, len(tiles), bs):
                DS.tiles_to_4ch(tiles[i:i + bs])
        torch.cuda.synchronize()
        out["build_launches"] = dict(E.LAUNCHES)
    out["build_checked"] = len(rec.check(torch, "dist 4ch build"))
    PD.barrier()
    out.update(dist_train(torch, inputs, run_dir, dtype))

    det = build_detector([(416, 100, inputs["ckpt4"])], channels=4, **F32)
    with PathKernels(E) as rec:
        reset_launches(E)
        out["detect_4ch"] = det.detect_images(inputs["maps"])
        torch.cuda.synchronize()
        out["detect_4ch_launches"] = dict(E.LAUNCHES)
    out["detect_4ch_checked"] = rec.check(torch, "dist 4ch detect")
    del det
    det = build_detector(inputs["dual"], **F32)
    out["detect_dual"] = det.detect_images(inputs["maps"])
    return out


def dist_worker(spec: dict) -> int:
    """One process of a data-parallel run of the dist phase (``main`` with
    ``--dist-worker``): joins the group, runs ``dist_run`` and pickles its
    results."""
    import pickle

    import torch

    sys.path.insert(0, REPO)
    from oriented_object_detection_tpu_torch.ops import edt as E
    from oriented_object_detection_tpu_torch.parallel import distributed as PD

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True    # as the parent's runs
    PD.initialize(spec["coordinator"], spec["world"], spec["rank"],
                  backend=spec["backend"])
    with open(spec["inputs"], "rb") as f:
        inputs = pickle.load(f)
    out = dist_run(torch, E, inputs, spec["run_dir"], spec["dtype"])
    PD.shutdown()
    with open(spec["out"], "wb") as f:
        pickle.dump(out, f)
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_processes(cmds: list, logs: list, env=None) -> float:
    """Run the commands together to their end; any process that fails, or
    the time limit, stops them all and raises with the logs' tails.
    Returns the wall seconds."""
    t0 = time.perf_counter()
    files = [open(p, "w") for p in logs]
    procs = [subprocess.Popen(c, stdout=f, stderr=subprocess.STDOUT,
                              cwd=REPO, env=env) for c, f in zip(cmds, files)]
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.returncode not in (None, 0)]
            if failed or time.perf_counter() - t0 > DIST_TIMEOUT_S:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    if any(p.returncode != 0 for p in procs):
        tails = []
        for p, path in zip(procs, logs):
            with open(path) as f:
                tails.append(f"--- rc {p.returncode}, {path}\n"
                             + f.read()[-3000:])
        raise AssertionError("a process of the dist phase failed:\n"
                             + "\n".join(tails))
    return time.perf_counter() - t0


def dist_group_run(tmp: str, inputs: str, backend: str, world: int,
                   dtype: str) -> tuple:
    """``world`` processes of ``dist_run`` joined by ``backend``: (results
    per rank, wall seconds, run directory)."""
    import pickle

    label = f"{backend}{world}_{dtype}"
    run_dir = os.path.join(tmp, f"run_{label}")
    coord = f"localhost:{free_port()}"
    specs = [{"coordinator": coord, "world": world, "rank": r,
              "backend": backend, "inputs": inputs, "run_dir": run_dir,
              "dtype": dtype, "out": os.path.join(tmp, f"{label}_{r}.pkl")}
             for r in range(world)]
    wall = run_processes(
        [[sys.executable, os.path.abspath(__file__), "--dist-worker",
          json.dumps(s)] for s in specs],
        [os.path.join(tmp, f"{label}_{r}.log") for r in range(world)])
    res = []
    for s in specs:
        with open(s["out"], "rb") as f:
            res.append(pickle.load(f))
    return res, wall, run_dir


def compare_train(label: str, res: list, ref: dict, run_dir: str,
                  ref_dir: str) -> tuple:
    """The training of one data-parallel run against the one-process run
    in the same dtype: (numbers, failures)."""
    from oriented_object_detection_tpu_torch.models.weights import (
        load_checkpoint)

    tol, fails = DIST_TOL[ref["dtype"]], []
    world = len(res)
    losses = [max(abs(a["metrics"][k] - b["metrics"][k])
                  / max(abs(b["metrics"][k]), 1e-6)
                  for k in ("loss", "box", "cls", "dfl"))
              for a, b in zip(res[0]["steps"], ref["steps"])]
    if len(res[0]["steps"]) != DIST_STEPS or max(losses) > tol["loss"]:
        fails.append(f"{label}: step losses off by {losses}")
    got = load_checkpoint(os.path.join(run_dir, "rank0", "last.ckpt"))
    one = load_checkpoint(os.path.join(ref_dir, "rank0", "last.ckpt"))
    state = {}
    for key in ("params", "ema_params", "batch_stats"):
        ref_leaves = dict(tree_leaves(one[key]))
        worst = sorted(((max_rel(ref_leaves[k], v), k, float(np.abs(
            ref_leaves[k]).max())) for k, v in tree_leaves(got[key])))[-3:]
        state[key] = [{"max_rel": e, "leaf": k, "leaf_max": m}
                      for e, k, m in reversed(worst)]
        if worst[-1][0] > tol[key]:
            fails.append(f"{label}: {key} off by {worst[-1]}")
    same = all(np.array_equal(r["checksums"], res[0]["checksums"])
               for r in res)
    if not same:
        fails.append(f"{label}: the processes' states differ")
    others = [r for r in range(1, world)
              if os.path.exists(os.path.join(run_dir, f"rank{r}"))]
    if others:
        fails.append(f"{label}: processes {others} wrote a run directory")
    seconds = [[s["seconds"] for s in r["steps"]] for r in res]
    numbers = {
        "world": world, "backend": res[0]["backend"], "dtype": ref["dtype"],
        "devices": [r["device"] for r in res],
        "rows_per_process": [r["rows"] for r in res],
        "seconds_per_step": statistics.median(seconds[0][1:]),
        "seconds_per_step_by_rank": seconds,
        "collectives_per_step": [s["collectives"] for s in res[0]["steps"]],
        "peak_memory_gib_by_rank": [r["peak_memory_gib"] for r in res],
        "losses": [s["metrics"] for s in res[0]["steps"]],
        "loss_max_rel": max(losses), "state": state, "tolerance": tol,
        "bit_equal_to_one_process": max(losses) == 0.0 and all(
            v[0]["max_rel"] == 0.0 for v in state.values()),
        "state_bit_equal_across_ranks": same}
    if numbers["backend"] == "gloo":
        numbers["seconds_per_step_note"] = (
            "gloo: every all-reduce crosses the host; no speed reading")
    return numbers, fails


def compare_rest(label: str, res: list, ref: dict) -> tuple:
    """The float32 run's validation, 4ch build and detection against the
    one-process run: (numbers, failures)."""
    from oriented_object_detection_tpu_torch.infer import fusion as F

    fails = []
    fit = [r["fitness_warm_start"] for r in res]
    if len(set(fit)) != 1 or abs(fit[0] - ref["fitness_warm_start"]) > \
            DIST_TOL["fitness"]:
        fails.append(f"{label}: fitness {fit} against "
                     f"{ref['fitness_warm_start']}")
    if len({tuple(r["fitness"]) for r in res}) != 1:
        fails.append(f"{label}: the epoch's fitness differs between "
                     f"processes")
    build = [r["build_launches"] for r in res]
    if not all(n > 0 for n in build[0].values()) or any(
            n for b in build[1:] for n in b.values()):
        fails.append(f"{label}: 4ch build launches {build}")
    launches = [r["detect_4ch_launches"] for r in res]
    if not all(n > 0 for b in launches for n in b.values()):
        fails.append(f"{label}: a process of the 4ch detection launched "
                     f"no EDT kernel: {launches}")
    bit_equal = {"4ch": [], "dual": []}
    try:
        for r in res:
            for a, b in zip(r["detect_4ch"], ref["detect_4ch"]):
                match_rows(a["merged_for_pr"], b["merged_for_pr"])
                match_rows(b["merged_for_pr"], a["merged_for_pr"])
                bit_equal["4ch"].append(bool(np.array_equal(
                    a["merged_for_pr"], b["merged_for_pr"])))
            for a, b in zip(r["detect_dual"], ref["detect_dual"]):
                for x, y in ((a, b), (b, a)):
                    for ts in a["by_scale"]:
                        match_rows(x["by_scale"][ts], y["by_scale"][ts])
                    match_rows(x["merged_for_pr"], y["merged_for_pr"],
                               skip_near=(F.CONS_LOW, F.CONS_HIGH))
                bit_equal["dual"].append(bool(np.array_equal(
                    a["merged_for_pr"], b["merged_for_pr"])))
    except AssertionError as e:
        fails.append(f"{label}: detection rows: {e}")
    return {"fitness_warm_start": fit, "fitness": res[0]["fitness"],
            "build_launches_by_rank": build,
            "detect_4ch_launches_by_rank": launches,
            "detect_4ch_kernels_checked": [len(r["detect_4ch_checked"])
                                           for r in res],
            "rows_bit_equal_to_one_process": {k: sum(v) for k, v in
                                              bit_equal.items()},
            "rows_compared": {k: len(v) for k, v in bit_equal.items()}}, fails


# ``cli.py`` with its detectors in float32 (the CLI, like the JAX
# package's, has no dtype flag): the dist phase holds float32 rows
CLI_FLOAT32 = """import functools, sys
from oriented_object_detection_tpu_torch import cli
from oriented_object_detection_tpu_torch.infer import pipeline as P
P.build_detector = functools.partial(P.build_detector,
                                     compute_dtype="float32")
cli.main(sys.argv[1:])
"""


def dist_cli(tmp: str, maps: list, backend: str, world: int,
             want_rows: list) -> dict:
    """``cli.py detect --dist`` of the 4ch slice over the maps in float32
    (``CLI_FLOAT32``), in ``world`` processes of its own joined through
    ``--coordinator/--num-processes/--process-id``, each given its own
    ``--output``: process 0 alone writes, one jpg and one xlsx a map
    holding ``want_rows`` rows."""
    stand_in = os.path.join(tmp, "cv2_stand_in")
    os.makedirs(stand_in, exist_ok=True)
    with open(os.path.join(stand_in, "cv2.py"), "w") as f:
        f.write(CV2_STAND_IN)
    src = os.path.join(tmp, "cli_in")
    os.makedirs(src, exist_ok=True)
    for i, m in enumerate(maps):
        with open(os.path.join(src, f"map{i}.png"), "wb") as f:
            np.save(f, m)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [stand_in, REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    coord = f"localhost:{free_port()}"
    outs = [os.path.join(tmp, f"cli_out{r}") for r in range(world)]
    wall = run_processes(
        [[sys.executable, "-c", CLI_FLOAT32,
          "detect", "--input", src, "--output", outs[r], "--scales",
          f"416:100={CKPT}", "--channels", "4", "--dist", "--coordinator",
          coord, "--num-processes", str(world), "--process-id", str(r),
          "--dist-backend", backend] for r in range(world)],
        [os.path.join(tmp, f"cli_rank{r}.log") for r in range(world)],
        env=env)
    files = sorted(os.listdir(outs[0]))
    want = sorted([f"map{i}{s}" for i in range(len(maps))
                   for s in ("_detected.jpg", ".xlsx")])
    if files != want:
        raise AssertionError(f"cli detect --dist wrote {files}")
    if any(os.path.exists(o) for o in outs[1:]):
        raise AssertionError("a process other than 0 wrote an output dir")
    for i, n in enumerate(want_rows):
        with zipfile.ZipFile(os.path.join(outs[0], f"map{i}.xlsx")) as z:
            sheet = z.read("xl/worksheets/sheet1.xml").decode()
        if sheet.count("<row ") != n + 1:
            raise AssertionError(f"map{i}.xlsx does not hold its {n} rows")
    return {"world": world, "backend": backend, "wall_s": wall,
            "files": files, "xlsx_rows": want_rows}


def phase_dist(torch, E) -> dict:
    """Data parallelism across processes (``--dist``) at full width, each
    run held to the one-process run of the same work on the same card
    (``dist_run``), with cuDNN's deterministic algorithms, so the runs
    differ only by how the batch is split. NCCL does not put two
    processes on one card, so one card runs NCCL at world 1 (its
    initialization and every collective call of the path) and gloo at
    world 2, both processes on the card (the split, the gathers, the
    global statistics, process 0's files); two cards or more run NCCL
    across them (at most 4). The multi-process training is run again in
    float64 against a float64 process, which takes float32's rounding out
    of the comparison. Then the run's ``last.ckpt`` detects and ``cli.py
    detect --dist`` runs in processes of its own. Any failing process or
    check fails the phase."""
    import pickle

    from oriented_object_detection_tpu_torch.infer.pipeline import (
        build_detector)

    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    cards = torch.cuda.device_count()
    worlds = [("nccl", min(cards, 4))] if cards > 1 else [("nccl", 1),
                                                          ("gloo", 2)]
    fails = []
    with tempfile.TemporaryDirectory() as tmp:
        inputs = dist_inputs(tmp)
        with open(inputs, "rb") as f:
            data = pickle.load(f)
        refs = {}
        for dtype in ("float32", "float64"):
            ref_dir = os.path.join(tmp, f"run_one_{dtype}")
            refs[dtype] = (dist_run(torch, E, data, ref_dir, dtype), ref_dir)
            torch.cuda.empty_cache()
            ref = refs[dtype][0]
            emit({"phase": "dist", "part": f"one_process_{dtype}",
                  "seconds_per_step": statistics.median(
                      [s["seconds"] for s in ref["steps"]][1:]),
                  "peak_memory_gib": ref["peak_memory_gib"],
                  "losses": [s["metrics"] for s in ref["steps"]],
                  **({"fitness_warm_start": ref["fitness_warm_start"],
                      "build_launches": ref["build_launches"]}
                     if dtype == "float32" else {})})
        runs = [(b, w, "float32") for b, w in worlds] + [
            (worlds[-1][0], worlds[-1][1], "float64")]
        for backend, world, dtype in runs:
            res, wall, run_dir = dist_group_run(tmp, inputs, backend, world,
                                                dtype)
            label = f"{backend}{world}_{dtype}"
            ref, ref_dir = refs[dtype]
            numbers, bad = compare_train(label, res, ref, run_dir, ref_dir)
            fails += bad
            if dtype == "float32":
                more, bad = compare_rest(label, res, ref)
                numbers.update(more)
                fails += bad
                if world > 1:
                    multi = (res, run_dir, backend, world)
            emit({"phase": "dist", "part": label, "wall_s": wall, **numbers})
        res, run_dir, backend, world = multi
        det = build_detector([(TRAIN["tile_size"], TRAIN["overlap"],
                               os.path.join(run_dir, "rank0",
                                            "last.ckpt"))], **F32)
        rows = det.detect_image(data["maps"][0])["merged_for_pr"]
        check_rows(rows, *data["maps"][0].shape[:2],
                   det.cfg.conf_thr_predict)
        del det
        cli = dist_cli(tmp, data["maps"], backend, world,
                       [len(r["merged_for_pr"]) for r in res[0][
                           "detect_4ch"]])
        emit({"phase": "dist", "part": "cli", **cli,
              "last_ckpt_detect_rows": len(rows),
              "phase_seconds": time.perf_counter() - t0})
    torch.backends.cudnn.deterministic = False
    if fails:
        raise AssertionError("dist phase: " + "; ".join(fails))
    return {"dist_detect_4ch": [r["detect_4ch_launches"] for r in res],
            "dist_train_4ch_build": [r["build_launches"] for r in res]}


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--profile", type=int, default=0, metavar="MAPS",
                   help="also profile the slice, the dual path and the "
                        "bf16 dual path over MAPS warm maps each")
    p.add_argument("--dist-worker", metavar="SPEC",
                   help="(used by the dist phase) run one process of a "
                        "data-parallel run from its JSON spec")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.dist_worker:
        return dist_worker(json.loads(args.dist_worker))
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
    del dual
    multi = phase_batch(torch, E)
    crop = phase_crop(torch, E, img)
    phase_convert(torch, img)
    rand = phase_random(torch, E)
    bf16 = phase_bf16(torch, E, smi, multi["float32_results"], img,
                      args.profile)
    train = phase_train(torch, E, smi)
    dist = phase_dist(torch, E)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # the times are the slice-mask shape's, device only; the launches are
    # the slice's, and by path: the dual path runs neither kernel, the 4ch
    # batch and stream, the crop, the random x-scale path, the bf16 4ch
    # slice (per map and batched) and the training path's 4-channel build
    # run both; under --dist, by process, the 4ch detection on every
    # process and the 4ch build on process 0 alone
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": "oriented_object_detection_tpu_torch/csrc/edt.cu",
         "replaces": REPLACES[name], "launches": sl["launches"][name],
         "launches_by_path": {"slice": sl["launches"][name], "dual": 0,
                              "batch": multi["batch"][name],
                              "stream": multi["stream"][name],
                              "crop": crop[name], "random": rand[name],
                              "bf16_4ch_per_map": bf16["per_image"][name],
                              "bf16_4ch_batch": bf16["batch"][name],
                              "train_4ch_build": train["launches"][name],
                              **{path: [r[name] for r in by_rank]
                                 for path, by_rank in dist.items()}},
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
