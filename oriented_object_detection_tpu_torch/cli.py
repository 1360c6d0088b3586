"""Command-line entry point of the port.

  python -m oriented_object_detection_tpu_torch.cli detect \
      --input Input --output Output \
      --ckpt assets/bench_ckpts/train416_4ch.ckpt --channels 4

runs the ``detect_416_4ch`` preset (one 416/100 scale, RGB + DT-Edge) on
every image of ``--input`` and writes ``{stem}.xlsx`` (the 11-column sheet)
per image to ``--output``. The checkpoint must be a 4-channel YOLO11n-OBB
trained at 416; any other is refused. It runs on the CUDA card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import time


def _detect(args) -> None:
    import cv2  # reads the input images; nothing else of the port needs it

    from .infer.pipeline import detector_from_checkpoint
    from .utils.xlsx import export_xlsx

    if not os.path.exists(args.ckpt):
        raise SystemExit(f"checkpoint {args.ckpt} does not exist")
    try:
        det = detector_from_checkpoint(args.ckpt, device=args.device)
    except ValueError as e:
        raise SystemExit(str(e))
    os.makedirs(args.output, exist_ok=True)
    names = [f for f in sorted(os.listdir(args.input))
             if f.lower().endswith((".jpg", ".png", ".jpeg", ".tif",
                                    ".tiff"))]
    t0 = time.time()
    for fname in names:
        image = cv2.imread(os.path.join(args.input, fname))
        if image is None:
            print(f"[Warn] Could not read image: {fname}")
            continue
        rows = det.detect_image(image)["merged_for_pr"]
        stem = os.path.splitext(fname)[0]
        export_xlsx(os.path.join(args.output, f"{stem}.xlsx"), rows)
        print(f"Results saved for {fname}: {len(rows)} detections")
    print(f"--- {time.time() - t0:.2f} seconds ---")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="oriented_object_detection_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("detect", help="4-channel tiled OBB detection at 416/100")
    d.add_argument("--input", default="Input")
    d.add_argument("--output", default="Output")
    d.add_argument("--ckpt", required=True, help="checkpoint (.ckpt)")
    d.add_argument("--channels", type=int, default=4, choices=(4,),
                   help="input channels; only 4 (RGB + DT-Edge) is ported")
    d.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card")
    args = p.parse_args(argv)
    if args.cmd == "detect":
        _detect(args)


if __name__ == "__main__":
    main()
