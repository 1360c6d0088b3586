"""Per-map detection time of the port in this checkout against another
checkout of it (for example a ``git archive`` of the parent commit), on one
CUDA card. Processes alternate other, this, this, other, and so on for each
round; each process times warm ``detect_image`` calls, each ended by a
device synchronize, of the 4-channel slice (``train416_4ch.ckpt`` at
416/100) and of ``detect_dual`` (YOLO11x-OBB, int8 checkpoints) on
``chip_smoke.synthetic_map(0)``, with the functions of its own checkout's
``chip_smoke.py``. Prints the card's name and power limit, one JSON line a
process, then a summary line of the medians.

    python3 slice_ab.py OTHER_CHECKOUT [--rounds 2] [--maps 30]
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def child(checkout: str, maps: int) -> None:
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
        times = C.seconds_per_map(torch, det, img, maps=n)
        out[label] = statistics.median(times)
        out[f"{label}_all"] = times
        del det
    print(json.dumps(out), flush=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("other", help="the other checkout of the repository")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--maps", type=int, default=30)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        child(os.path.abspath(args.other), args.maps)
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
             "--maps", str(args.maps)], capture_output=True, text=True,
            timeout=900, cwd=checkout)
        if res.returncode:
            sys.stderr.write(res.stderr[-4000:])
            raise SystemExit(f"the process for {checkout} failed")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        runs[checkout].append(line)
    print(json.dumps({
        "nvidia_smi": smi, "order": ["other" if c == other else "this"
                                     for c in order],
        **{f"{side}_{label}": [r[label] for r in runs[c]]
           for side, c in (("other", other), ("this", HERE))
           for label in ("slice", "dual")},
        **{f"{side}_{label}_median": statistics.median(
            r[label] for r in runs[c])
           for side, c in (("other", other), ("this", HERE))
           for label in ("slice", "dual")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
