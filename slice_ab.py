"""Per-map detection time and train-step time of the port in this checkout
against another checkout of it (for example a ``git archive`` of the parent
commit), on one CUDA card. Processes alternate other, this, this, other,
and so on for each round; each process times warm ``detect_image`` calls,
each ended by a device synchronize, of the 4-channel slice
(``train416_4ch.ckpt`` at 416/100) and of ``detect_dual`` (YOLO11x-OBB,
int8 checkpoints) on ``chip_smoke.synthetic_map(0)`` (the maps,
checkpoints and tiles come from that checkout's ``chip_smoke.py``, the
timing from this file, so both sides are timed alike), and warm
one-process train steps of YOLO11x-OBB at 416, batch 16, from
``train416_x.ckpt`` on the sixteen 416 tiles of
``chip_smoke.map_tiles(11, ...)`` (``--steps``, 0 for none).
Prints the card's name and power limit, one JSON line a process, then a
summary line of the medians.

    python3 slice_ab.py OTHER_CHECKOUT [--rounds 2] [--maps 30] [--steps 10]
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def seconds_per_map(torch, det, img, maps: int) -> list:
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


def train_batch(C, torch, max_labels: int = 64) -> dict:
    """A batch of the sixteen 416 tiles of one synthetic map with the boxes
    of its rectangles, in the train step's layout, on the card."""
    from oriented_object_detection_tpu_torch.ops import geometry as G

    tiles, labels = C.map_tiles(11, 416, 100)
    B = len(tiles)
    gl = np.zeros((B, max_labels), np.int64)
    gb = np.zeros((B, max_labels, 5), np.float32)
    gm = np.zeros((B, max_labels), bool)
    for i, lab in enumerate(labels):
        lab = lab[:max_labels]
        gl[i, :len(lab)] = lab[:, 0]
        gb[i, :len(lab)] = G.corners8_to_xywhr_np(lab[:, 1:] * 416)
        gm[i, :len(lab)] = True
    x = np.ascontiguousarray(tiles[..., ::-1].transpose(0, 3, 1, 2))
    return {k: torch.from_numpy(v).cuda() for k, v in (
        ("images", x.astype(np.float32) / 255.0), ("gt_labels", gl),
        ("gt_xywhr", gb), ("gt_mask", gm))}


def train_seconds(C, torch, steps: int) -> list:
    """Wall seconds of ``steps`` warm train steps, each synchronized."""
    from oriented_object_detection_tpu_torch.config import TrainConfig
    from oriented_object_detection_tpu_torch.train import trainer as TR

    cfg = TrainConfig(tile_size=416, batch_size=16, model_scale="x",
                      epochs=1, plots=False)
    state = TR.create_train_state(cfg, 4)
    TR.warm_start_state(C.TRAIN_CKPT, state)
    batch = train_batch(C, torch)
    for _ in range(2):
        TR.train_step(state, batch, cfg)
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        TR.train_step(state, batch, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def child(checkout: str, maps: int, steps: int) -> None:
    sys.path.insert(0, checkout)
    import torch

    import chip_smoke as C
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        build_detector)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img = C.synthetic_map(seed=0)[0]
    out = {"checkout": checkout}
    for label, det, n in (
            ("slice", build_detector([(416, 100, C.CKPT)], channels=4), maps),
            ("dual", build_detector(C.DUAL), max(1, maps // 3))):
        times = seconds_per_map(torch, det, img, maps=n)
        out[label] = statistics.median(times)
        out[f"{label}_all"] = times
        del det
    if steps:
        times = train_seconds(C, torch, steps)
        out["train"] = statistics.median(times)
        out["train_all"] = times
    print(json.dumps(out), flush=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("other", help="the other checkout of the repository")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--maps", type=int, default=30)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        child(os.path.abspath(args.other), args.maps, args.steps)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    other = os.path.abspath(args.other)
    order = [other, HERE, HERE, other] * args.rounds
    runs = {other: [], HERE: []}
    for checkout in order:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), checkout, "--child",
             "--maps", str(args.maps), "--steps", str(args.steps)],
            capture_output=True, text=True,
            timeout=900, cwd=checkout)
        if res.returncode:
            sys.stderr.write(res.stderr[-4000:])
            raise SystemExit(f"the process for {checkout} failed")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        runs[checkout].append(line)
    labels = ("slice", "dual") + (("train",) if args.steps else ())
    print(json.dumps({
        "nvidia_smi": smi, "order": ["other" if c == other else "this"
                                     for c in order],
        **{f"{side}_{label}": [r[label] for r in runs[c]]
           for side, c in (("other", other), ("this", HERE))
           for label in labels},
        **{f"{side}_{label}_median": statistics.median(
            r[label] for r in runs[c])
           for side, c in (("other", other), ("this", HERE))
           for label in labels}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
