"""Command-line entry point of the port.

  python -m oriented_object_detection_tpu_torch.cli detect \
      --input Input --output Output \
      --ckpt128 assets/bench_ckpts/train128_x.ckpt \
      --ckpt416 assets/bench_ckpts/train416_x.ckpt [--metrics]

runs tiled detection at each given scale (128/30 and 416/100, or the
``--scales ts:ov=ckpt,...`` list), fuses the scales with the cross-scale
consensus filter and writes ``{stem}_detected.jpg`` and ``{stem}.xlsx`` per
image of ``--input`` to ``--output``; with ``--metrics``, it then prints the
reference's metric block against each image's label file and writes
``fusion_classwise_metrics.xlsx``. Each checkpoint's recorded channels and
model scale are read from it. It runs on the CUDA card unless ``--device
cpu`` is given; reading and drawing the images needs cv2.
"""

from __future__ import annotations

import argparse
import os
import time


def _triples(args) -> list:
    """(tile_size, overlap, checkpoint) per scale: ``--scales`` (the
    reference's editable tile_sizes/overlaps lists, `Detect_OBB.py:24-25`)
    or the ``--ckpt128``/``--ckpt416`` shorthands with the reference's
    overlaps."""
    if not args.scales:
        return [(ts, ov, ck) for ts, ov, ck in
                ((128, 30, args.ckpt128), (416, 100, args.ckpt416)) if ck]
    triples = []
    for item in args.scales.split(","):
        geom, _, ck = item.partition("=")
        ts_s, _, ov_s = geom.partition(":")
        if not ov_s:
            raise SystemExit(f"bad --scales item {item!r}; want ts:ov[=ckpt]")
        triples.append((int(ts_s), int(ov_s), ck or None))
    return triples


def _detect(args) -> None:
    import cv2  # noqa: F401  (fail early: the images are read with it)

    from .eval.metrics import run_fusion_eval
    from .infer.pipeline import build_detector, process_image

    triples = _triples(args)
    if not triples:
        raise SystemExit("provide --ckpt128 and/or --ckpt416")
    try:
        det = build_detector(
            triples, channels=args.channels, model_scale=args.scale,
            device=args.device, calculate_metrics=args.metrics,
            merge_iou=args.merge_iou, metrics_iou=args.metrics_iou,
            map_min_score=args.map_min_score,
            apply_border_filter=not args.no_border_filter,
            margin_128=args.margin_128, margin_416=args.margin_416)
    except ValueError as e:
        raise SystemExit(str(e))

    os.makedirs(args.output, exist_ok=True)
    names = [f for f in sorted(os.listdir(args.input))
             if f.lower().endswith((".jpg", ".png", ".jpeg", ".tif",
                                    ".tiff"))]
    t0 = time.time()
    store: dict = {}
    for fname in names:
        print(f"Processing {fname}...")
        process_image(det, os.path.join(args.input, fname), args.output,
                      store=store)
        print(f"Results saved for {fname}")
    print(f"--- {time.time() - t0:.2f} seconds ---")

    if args.metrics:
        cfg = det.cfg
        try:
            run_fusion_eval(store.get("pr", {}), args.input, args.output,
                            iou_thr=cfg.metrics_iou,
                            dets_map=store.get("map"),
                            single_scale=len(cfg.scales) == 1,
                            map_min_score=cfg.map_min_score)
        except Exception as e:  # same guard as the reference's main
            print(f"[Eval] Skipped due to error: {e}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="oriented_object_detection_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("detect", help="tiled multi-scale OBB detection")
    d.add_argument("--input", default="Input")
    d.add_argument("--output", default="Output")
    d.add_argument("--ckpt128", help="checkpoint of the 128/30 scale")
    d.add_argument("--ckpt416", help="checkpoint of the 416/100 scale")
    d.add_argument("--scales",
                   help="custom scale geometry: comma list ts:ov=ckpt, "
                        "e.g. 128:30=ck128.ckpt,416:100=ck416.ckpt "
                        "(replaces --ckpt128/--ckpt416)")
    d.add_argument("--channels", type=int, default=3, choices=(3, 4),
                   help="input channels: 3 (RGB) or 4 (RGB + DT-Edge)")
    d.add_argument("--scale", default="x",
                   help="model scale where a checkpoint records none")
    d.add_argument("--metrics", action="store_true",
                   help="evaluate against the images' label files")
    # the remaining Detect_OBB.py constants (`:33-40`)
    d.add_argument("--merge-iou", type=float, default=0.4,
                   help="merge NMS IoU (reference iou_threshold)")
    d.add_argument("--metrics-iou", type=float, default=0.25,
                   help="metrics IoU/conf threshold (reference iou_thr)")
    d.add_argument("--map-min-score", type=float, default=0.001)
    d.add_argument("--no-border-filter", action="store_true")
    d.add_argument("--margin-128", type=int, default=10)
    d.add_argument("--margin-416", type=int, default=20)
    d.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card")
    args = p.parse_args(argv)
    if args.cmd == "detect":
        _detect(args)


if __name__ == "__main__":
    main()
