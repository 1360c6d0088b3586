#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile MAPS]

Phases, each printing one JSON line (warnings go to stderr):

1. device  - the card's name and power limit (nvidia-smi) and the float32
             matmul/convolution precision it runs with (TF32 off).
2. build   - builds the EDT kernels (``csrc/edt.cu``, nvcc for sm_90a) and
             the host geometry library (``native/geom.cpp``, g++).
3. kernels - holds each EDT kernel bit-equal to its plain PyTorch version
             on the card, at the detector's shape [16, 416, 416] and at a
             map shape [1, 2048, 2048], and times kernel and plain version.
4. slice   - runs the 4-channel 416/100 detector on the committed
             ``train416_4ch.ckpt`` (YOLO11n-OBB) over a seeded synthetic
             1024x1024 map (16 tiles): both kernels must launch, the
             DT-Edge tile batch must equal the plain-version one, the rows
             must be sane and agree with the same detector on the CPU, and
             the xlsx is written.
5. profile - only with ``--profile MAPS``: the slice over MAPS warm maps
             under ``torch.profiler``; per map, the wall time, the device's
             busy time and idle share, the device ops, and the device time
             by kind of kernel and of the costliest kernels.

Then the kernel summary line, and last ``{"ok": true, "device": ...}``.
Any failure raises and the script exits non-zero; without a CUDA device
it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import zipfile

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "assets", "bench_ckpts", "train416_4ch.ckpt")
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
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


def time_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events), after two
    warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
                  n_obj: int = 40, n_lines: int = 12) -> np.ndarray:
    """Seeded BGR uint8 map from numpy alone: a noisy light background,
    thin dark lines and filled rotated rectangles in the palette."""
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
    for _ in range(n_obj):
        color = PALETTE[rng.randint(0, len(PALETTE))]
        cx, cy = rng.uniform(30, W - 30), rng.uniform(30, H - 30)
        w, h = rng.uniform(18, 40), rng.uniform(10, 22)
        th = rng.uniform(-np.pi, np.pi)
        u = (xx - cx) * np.cos(th) + (yy - cy) * np.sin(th)
        v = -(xx - cx) * np.sin(th) + (yy - cy) * np.cos(th)
        img[(np.abs(u) <= w / 2) & (np.abs(v) <= h / 2)] = color
    return np.clip(img, 0, 255).astype(np.uint8)


def pass2_operations(sq, W: int) -> float:
    """Float operations K2 does for its result ``sq`` [N, W]: a pixel whose
    squared distance is b scans offsets 1..min(floor(sqrt(b)), its longest
    side), one add and one min per in-row candidate."""
    import torch

    j = torch.arange(W, device=sq.device)
    D = torch.floor(torch.sqrt(sq.double())).long()
    D = torch.minimum(D, torch.maximum(j, W - 1 - j))
    cand = torch.minimum(D, W - 1 - j) + torch.minimum(D, j)
    return 2.0 * float(cand.sum())


def phase_kernels(E, torch) -> dict:
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    results = {}
    for label, shape in (("path", (16, 416, 416)), ("map", (1, 2048, 2048))):
        mask = torch.from_numpy(edge_masks(rng, shape)).to(dev)
        B, H, W = shape
        d0 = E.edt_pass1_columns(mask)
        d0_plain = E.edt_pass1_columns_plain(mask)
        sq = E.edt_pass2_rows(d0.reshape(-1, W))
        sq_plain = E.edt_pass2_rows_plain(d0.reshape(-1, W))
        torch.cuda.synchronize()
        row = {}
        for name, got, ref, fn, plain, nbytes, ops in (
                ("edt_pass1_columns", d0, d0_plain,
                 lambda: E.edt_pass1_columns(mask),
                 lambda: E.edt_pass1_columns_plain(mask),
                 B * H * W * (1 + 4), 0.0),
                ("edt_pass2_rows", sq, sq_plain,
                 lambda: E.edt_pass2_rows(d0.reshape(-1, W)),
                 lambda: E.edt_pass2_rows_plain(d0.reshape(-1, W)),
                 B * H * W * (4 + 4), pass2_operations(sq, W))):
            err = float((got - ref).abs().max())
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"{name} at {shape}: kernel differs from its plain "
                    f"version (max abs err {err})")
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / FP32_FLOPS * 1e3
            row[name] = {
                "max_abs_err": err,
                "ms": time_ms(fn),
                "plain_ms": time_ms(plain, reps=3),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
            }
        results[label] = row
        emit({"phase": "kernels", "shape": list(shape), "bit_equal": True,
              **row})
    return results


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
               px: float = 1.0, dconf: float = 0.02) -> None:
    """Every row of ``a`` with conf >= conf_min has a row of ``b`` with the
    same class, corners within ``px`` and conf within ``dconf``."""
    for r in a[a[:, 9] >= conf_min]:
        same = b[b[:, 8] == r[8]]
        close = (np.abs(same[:, :8] - r[:8]).max(1) <= px) & (
            np.abs(same[:, 9] - r[9]) <= dconf)
        if not close.any():
            raise AssertionError(f"no partner for detection {r.tolist()}")


def phase_slice(torch, E) -> dict:
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        detector_from_checkpoint)
    from oriented_object_detection_tpu_torch.ops import dtedge as DT
    from oriented_object_detection_tpu_torch.ops import tiling as T
    from oriented_object_detection_tpu_torch.utils.xlsx import export_xlsx

    img = synthetic_map(seed=0)
    H, W = img.shape[:2]
    det = detector_from_checkpoint(CKPT)
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

    cpu_rows = detector_from_checkpoint(
        CKPT, device="cpu").detect_image(img)["merged_for_pr"]
    match_rows(rows, cpu_rows)
    match_rows(cpu_rows, rows)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.xlsx")
        export_xlsx(path, rows)
        with zipfile.ZipFile(path) as z:
            sheet = z.read("xl/worksheets/sheet1.xml").decode()
        if sheet.count("<row ") != len(rows) + 1:
            raise AssertionError("xlsx does not hold every row")

    det.detect_image(img)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.detect_image(img)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out = {"phase": "slice", "map": [H, W], "tiles": len(grid),
           "rows": len(rows), "cpu_rows": len(cpu_rows),
           "launches": launches, "dt_edge_bit_equal": True,
           "seconds_per_map": statistics.median(times),
           "seconds_per_map_all": times}
    emit(out)
    return det, img, out


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


def phase_profile(torch, det, img, maps: int) -> None:
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
    emit({"phase": "profile", "maps": maps,
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
                   help="also profile the slice over MAPS warm maps")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
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

    t0 = time.perf_counter()
    E.kernel_library()
    t1 = time.perf_counter()
    native.load()
    t2 = time.perf_counter()
    emit({"phase": "build", "edt_cu_s": t1 - t0, "geom_cpp_s": t2 - t1})

    kern = phase_kernels(E, torch)
    det, img, sl = phase_slice(torch, E)
    if args.profile:
        phase_profile(torch, det, img, args.profile)

    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": "oriented_object_detection_tpu_torch/csrc/edt.cu",
         "replaces": REPLACES[name], "launches": sl["launches"][name],
         **kern["path"][name]}
        for name in ("edt_pass1_columns", "edt_pass2_rows")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
