"""The readings that the limits of ``correct`` are set from, for one cell,
in one process: the program's readings on many seeds (the lower end),
and on the first few seeds the control's, the reference computed in fp8
in the program's place (the upper end), and for a training cell the
readings of a planted fault (half of each batch left out); beside them
the reference computed with the program's bf16 rounding, for the look at
what bf16 alone moves.

    python3 obbbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--controls 3] [--seconds 3] [--out calib.jsonl]

Each seed runs the cell's set-up and a short window at the cell's own
sizes, then the checks. One JSON line a seed on standard output and in
``--out``; the last line sums them up.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from obbbench.harness import spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(args.workload, ROOT)
    drv = cell.driver
    dev = torch.device("cuda")
    if cell.workload["driver"].startswith("detect"):
        # one detector for every seed: the weights do not depend on it
        from obbbench.harness import detection as DT

        built = {}
        inner = DT.build_detector

        def cached(c, d):
            if "det" not in built:
                built["det"] = inner(c, d)
            return built["det"]

        DT.build_detector = cached
    seeds = [int(s) for s in args.seeds.split(",")]
    lines = []
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        sess = drv.setup(cell, seed, dev)
        rec = drv.window(sess, args.seconds, None)
        drv.release(sess)
        torch.cuda.empty_cache()
        line = {"seed": seed, "units": rec["units"],
                "program": drv.readings(sess, None)}
        if k < args.controls:
            line["control_fp8"] = drv.readings(sess, drv.reference(
                sess, "fp8"))
            line["reference_bf16"] = drv.readings(sess, drv.reference(
                sess, "bf16"))
            if cell.workload["driver"] == "train_steps":
                line["fault_half_batch"] = drv.readings(sess, drv.reference(
                    sess, "float32", fault="half_batch"))
        line["seconds"] = time.perf_counter() - t0
        lines.append(line)
        print(json.dumps(line), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del sess
    summary = {}
    for part in ("program", "control_fp8", "reference_bf16",
                 "fault_half_batch"):
        vals = [ln[part] for ln in lines if part in ln]
        if vals:
            summary[part] = {key: {"min": min(v[key] for v in vals),
                                   "max": max(v[key] for v in vals)}
                             for key in vals[0]}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
