"""Command-line entry points of the port.

  python -m oriented_object_detection_tpu_torch.cli detect \
      --input Input --output Output \
      --ckpt128 assets/bench_ckpts/train128_x.ckpt \
      --ckpt416 assets/bench_ckpts/train416_x.ckpt [--metrics]

  python -m oriented_object_detection_tpu_torch.cli train \
      --data-root datasets/GeoMap --tile-size 416 --overlap 100 \
      --epochs 150 --batch-size 16 [--channels 4] [--scale x]

  python -m oriented_object_detection_tpu_torch.cli val \
      --ckpt runs/obb/train416/best.ckpt --data-root datasets/GeoMap

  python -m oriented_object_detection_tpu_torch.cli convert best416.pt \
      --out best416.ckpt [--scale x] [--channels 4]

``train`` builds the tile dataset from ``{root}/images/{train,val}`` and
``{root}/labels/{train,val}`` (tiling, class balancing, empty-tile budget,
the 4-channel TIFFs for ``--channels 4``) and trains, writing ``best.ckpt``,
``last.ckpt`` (the JAX package's checkpoint format), ``results.csv`` and
the plots to ``--ckpt-dir``; ``val`` prints a checkpoint's per-tile mAPs and
fitness. ``detect`` runs tiled detection at each given scale (128/30 and 416/100, or the
``--scales ts:ov=ckpt,...`` list), fuses the scales with the cross-scale
consensus filter and writes ``{stem}_detected.jpg`` and ``{stem}.xlsx`` per
image of ``--input`` to ``--output``; with ``--metrics``, it then prints the
reference's metric block against each image's label file and writes
``fusion_classwise_metrics.xlsx``. Each checkpoint's recorded channels and
model scale are read from it. ``--batch`` detects every map in one device
batch per scale, ``--stream`` and ``--chunk N`` pipeline the maps one or N
at a time; the outputs are those of the per-map path. ``convert`` turns an
ultralytics checkpoint into one that ``detect`` reads, with no torch code
of the file run. Every command but ``convert`` runs on the CUDA card unless
``--device cpu`` is given; reading and drawing the images needs cv2.

``--dist`` runs ``train``, ``val`` or ``detect`` data-parallel, one process
per card (``parallel/distributed.py``), joined through ``--coordinator
host:port --num-processes N --process-id I`` or torchrun's environment:

  torchrun --nproc-per-node 4 -m oriented_object_detection_tpu_torch.cli \
      train --dist --data-root datasets/GeoMap --batch-size 16

NCCL joins the cards (``--dist-backend`` names another, gloo with
``--device cpu``). Process 0 alone builds the dataset and writes the files
and reports; every process computes the same global results.
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


def _device(args):
    """The device of this command: with ``--dist``, this process's after
    joining the group (``parallel/distributed.py``); else ``--device``,
    the card by default."""
    from .parallel import distributed as PD
    from .utils.runtime import resolve_device

    if not args.dist:
        return resolve_device(args.device)
    return PD.initialize(args.coordinator, args.num_processes,
                         args.process_id, backend=args.dist_backend,
                         device=args.device)


def _run(fn, args):
    """``fn(args)``, leaving the data-parallel group, if one was joined, on
    the way out."""
    from .parallel import distributed as PD

    try:
        return fn(args)
    finally:
        PD.shutdown()


def _detect(args) -> None:
    import cv2  # the images are read and drawn with it

    from .eval.metrics import run_fusion_eval
    from .infer.pipeline import build_detector, process_image, write_outputs
    from .parallel import distributed as PD

    triples = _triples(args)
    if not triples:
        raise SystemExit("provide --ckpt128 and/or --ckpt416")
    device = _device(args) if args.dist else args.device
    main = PD.is_main()
    if args.dist and not (args.batch or args.stream or args.chunk):
        # the per-map path writes inside process_image; the multi-map path
        # gates the files to process 0
        args.batch = True
        if main:
            print("[detect] --dist implies --batch")
    try:
        det = build_detector(
            triples, channels=args.channels, model_scale=args.scale,
            device=device, allow_random=args.allow_random,
            calculate_metrics=args.metrics, merge_iou=args.merge_iou,
            metrics_iou=args.metrics_iou, map_min_score=args.map_min_score,
            apply_border_filter=not args.no_border_filter,
            margin_128=args.margin_128, margin_416=args.margin_416)
    except ValueError as e:
        raise SystemExit(str(e))

    if main:
        os.makedirs(args.output, exist_ok=True)
    names = [f for f in sorted(os.listdir(args.input))
             if f.lower().endswith((".jpg", ".png", ".jpeg", ".tif",
                                    ".tiff"))]
    t0 = time.time()
    store: dict = {}
    if args.batch or args.stream or args.chunk:
        paths = [os.path.join(args.input, f) for f in names]
        ok = [(p, im) for p, im in ((p, cv2.imread(p)) for p in paths)
              if im is not None]
        maps = [im for _, im in ok]
        if args.chunk:
            # groups of --chunk maps in input order, nothing padded
            results = det.detect_stream(maps, chunk=args.chunk)
        elif args.stream:
            results = det.detect_stream(maps)
        else:
            results = det.detect_images(maps)
        for (p, im), res in zip(ok, results):
            if main:
                write_outputs(im, p, res, args.output, store)
                print(f"Results saved for {os.path.basename(p)}")
    else:
        for fname in names:
            print(f"Processing {fname}...")
            process_image(det, os.path.join(args.input, fname), args.output,
                          store=store)
            print(f"Results saved for {fname}")
    if not main:
        return
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


def _train(args):
    import dataclasses

    import numpy as np

    from .config import TrainConfig
    from .data import dataset as DS
    from .data.loader import TileDataset, mosaic_p_for_epoch
    from .eval.val import validate_tiles
    from .parallel import distributed as PD
    from .parallel import mesh as PM
    from .train import trainer as TR

    device = _device(args)
    # each process's rows of every global batch, from the same stream
    rows = PM.batch_rows(args.batch_size, PD.rank(), PD.world())
    main = PD.is_main()
    cfg = TrainConfig(
        tile_size=args.tile_size, overlap=args.overlap, epochs=args.epochs,
        batch_size=args.batch_size, channels=args.channels,
        model_scale=args.scale, need_cropping=not args.skip_cropping,
        need_augmentation=not args.skip_augmentation,
        # the 4ch stem needs the DT-Edge TIFFs (`Train_OBB.py:763-787`)
        apply_filtered_rgb=args.channels == 4 or args.filtered_rgb,
        steps_per_dispatch=args.steps_per_dispatch)
    if args.close_mosaic is not None:
        cfg = dataclasses.replace(cfg, close_mosaic=args.close_mosaic)

    root, ts = args.data_root, cfg.tile_size
    dirs = {
        "img": f"{root}/images/train", "lbl": f"{root}/labels/train",
        "oimg": f"{root}/cropped{ts}/images/train",
        "olbl": f"{root}/cropped{ts}/labels/train",
        "vimg": f"{root}/images/val", "vlbl": f"{root}/labels/val",
        "voimg": f"{root}/cropped{ts}/images/val",
        "volbl": f"{root}/cropped{ts}/labels/val",
    }
    train_list = f"{root}/train_cropped{ts}.txt"
    val_list = f"{root}/val_cropped{ts}.txt"
    # the dataset build writes shared files: process 0 builds, the others
    # wait at the barrier below
    if cfg.need_cropping and main:
        stats = DS.build_train_tiles(
            dirs["img"], dirs["lbl"], dirs["oimg"], dirs["olbl"],
            train_list, ts, cfg.overlap, cfg.object_boundary_threshold)
        if cfg.need_augmentation:
            DS.balance_classes(
                dirs["oimg"], dirs["olbl"], train_list,
                cfg.class_balance_threshold, cfg.augmentation_repeats,
                seed=cfg.seed)
        P_post = DS.count_positives(dirs["olbl"])
        E_total = stats["E_total"]
        frac = min(1.0, cfg.r_target * P_post / E_total) \
            if E_total > 0 else 0.0
        print(f"[TRAIN] AUTO keep_fraction computed: {frac:.4f} "
              f"(R_TARGET={cfg.r_target}, P_post={P_post:,}, "
              f"E_total={E_total:,})")
        DS.save_selected_empty_tiles(stats["empty_meta_path"], frac,
                                     train_list, rng_seed=cfg.seed)
        DS.build_val_tiles(
            dirs["vimg"], dirs["vlbl"], dirs["voimg"], dirs["volbl"],
            val_list, ts, cfg.overlap,
            boundary_threshold=cfg.object_boundary_threshold,
            r_target=cfg.r_target)

    if cfg.channels == 4 and cfg.apply_filtered_rgb:
        train_list = f"{root}/train_cropped_4ch.txt"
        val_list = f"{root}/val_cropped_4ch.txt"
    if cfg.channels == 4 and cfg.apply_filtered_rgb and main:
        tr = DS.convert_folder_to_4ch_tiff(
            dirs["oimg"], f"{root}/cropped4/images/train", device=device)
        va = DS.convert_folder_to_4ch_tiff(
            dirs["voimg"], f"{root}/cropped4/images/val", device=device)
        stems = lambda ps: [os.path.splitext(os.path.basename(p))[0]
                            for p in ps]
        DS.mirror_labels_by_stem(dirs["olbl"],
                                 f"{root}/cropped4/labels/train", stems(tr))
        DS.mirror_labels_by_stem(dirs["volbl"],
                                 f"{root}/cropped4/labels/val", stems(va))
        DS.update_list_file(train_list, tr)
        DS.update_list_file(val_list, va)
    PD.barrier()

    train_ds = TileDataset(train_list, ts, cfg.channels, device=device)
    val_ds = TileDataset(val_list, ts, cfg.channels, device=device)
    steps_per_epoch = max(1, len(train_ds) // cfg.batch_size)
    if main:
        print(f"[TRAIN] {len(train_ds)} train tiles, {len(val_ds)} val "
              f"tiles, {steps_per_epoch} steps/epoch")

    state = TR.create_train_state(cfg, steps_per_epoch, device=device)
    rng = np.random.RandomState(cfg.seed)
    closed = []

    def train_batches(epoch):
        mp = mosaic_p_for_epoch(epoch, cfg.epochs, cfg.close_mosaic)
        if mp == 0.0 and not closed:
            closed.append(epoch)
            if main:
                print(f"[close_mosaic] mosaic disabled for the final "
                      f"{cfg.close_mosaic} epochs (engine default)")
        return train_ds.batches(cfg.batch_size, rng, augment=True,
                                mosaic_p=mp, rows=rows)

    return TR.fit(state, cfg, train_batches,
                  val_fn=lambda s: validate_tiles(
                      s.eval_model(), val_ds, cfg,
                      shard_across_processes=True),
                  ckpt_dir=args.ckpt_dir or f"runs/obb/train{ts}",
                  resume=args.resume, init_ckpt=args.init_ckpt)


def _val(args) -> dict:
    """The engine's ``model.val()``: per-tile mAP@0.5, mAP@[0.5:0.95] and
    the fitness of a checkpoint over the val tile list of ``train`` (no
    map stitching: that is ``detect --metrics``)."""
    from .config import TrainConfig
    from .data.loader import TileDataset
    from .eval.val import validate_tiles
    from .models.weights import (load_checkpoint, load_state,
                                 torch_state_from_jax,
                                 variables_from_checkpoint)
    from .models.yolo11_obb import YOLO11OBB
    from .parallel import distributed as PD

    device = _device(args)
    ck = load_checkpoint(args.ckpt)
    extra = ck.get("extra", {})
    scale = extra.get("model_scale", args.scale)
    channels = int(extra.get("channels", args.channels))
    ts = int(extra.get("tile_size", args.tile_size))
    cfg = TrainConfig(tile_size=ts, channels=channels, model_scale=scale)
    val_list = args.val_list or (
        f"{args.data_root}/val_cropped_4ch.txt" if channels == 4
        else f"{args.data_root}/val_cropped{ts}.txt")
    if not os.path.exists(val_list):
        raise SystemExit(
            f"val list {val_list} not found: run `train` (the dataset "
            "build) for this tile size first, or pass --val-list")
    ds = TileDataset(val_list, ts, channels, device=device)
    model = YOLO11OBB(nc=cfg.nc, scale=scale, in_channels=channels)
    load_state(model, torch_state_from_jax(variables_from_checkpoint(ck)))
    fitness, comps = validate_tiles(
        model.to(device).eval(), ds, cfg, max_tiles=args.max_tiles,
        batch_size=args.batch_size, return_components=True,
        shard_across_processes=args.dist)
    if PD.is_main():   # every process holds the same global metric
        print(f"[VAL] ckpt={args.ckpt} scale={scale} ts={ts} "
              f"tiles={comps['n_tiles']}")
        print(f"[VAL] mAP@0.5={comps['mAP@0.5']:.4f} "
              f"mAP@[0.5:0.95]={comps['mAP@[0.5:0.95]']:.4f} "
              f"fitness={fitness:.4f}")
    return {"fitness": fitness, **comps}


def _convert(args) -> None:
    """An ultralytics ``.pt`` (or an ``.npz`` dump of its state dict) -> a
    checkpoint in the JAX package's format, which both packages' ``detect``
    read. The ``.pt`` is read by ``models/pt_reader.py``, which runs no code
    from the file; the ``ema`` entry wins over ``model``."""
    import pickle

    import numpy as np

    from .models.weights import (convert_state_dict,
                                 jax_trees_from_torch_state,
                                 validate_against)
    from .models.yolo11_obb import YOLO11OBB

    if args.pt.endswith(".npz"):
        with np.load(args.pt) as z:
            sd = {k: np.asarray(v) for k, v in z.items()}
    else:
        from .models.pt_reader import read_pt_state_dict

        try:
            sd = read_pt_state_dict(args.pt)
        except (ValueError, pickle.UnpicklingError) as e:
            raise SystemExit(f"cannot read {args.pt}: {e}")
        print(f"[Convert] read {len(sd)} tensors (torch-free)")

    variables = convert_state_dict(
        sd, reverse_stem_channels=args.channels == 4)
    ref = jax_trees_from_torch_state(YOLO11OBB(
        nc=args.nc, scale=args.scale, in_channels=args.channels).state_dict())
    rep = validate_against(variables, ref)
    print(f"[Convert] matched {rep['matched']} arrays; "
          f"missing={len(rep['missing'])} extra={len(rep['extra'])} "
          f"mismatched={len(rep['mismatched'])}")
    if (rep["missing"] or rep["mismatched"]) and not args.force:
        for k in (rep["missing"] + rep["mismatched"])[:8]:
            print(f"  problem: {k}")
        raise SystemExit("conversion incomplete (use --force to write "
                         "anyway)")

    payload = {
        "step": 0,
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "ema_params": variables["params"],
        "extra": {"model_scale": args.scale, "channels": args.channels,
                  "tile_size": args.imgsz, "source": args.pt},
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(payload, f)
    print(f"[Convert] wrote {args.out}")


def _dist_flags(p, what: str) -> None:
    p.add_argument("--dist", action="store_true",
                   help="data parallelism across processes "
                        "(torch.distributed, one process per card): "
                        + what)
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (else torchrun's "
                        "MASTER_ADDR/MASTER_PORT)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--dist-backend", default=None,
                   help="torch.distributed backend; default: nccl on the "
                        "card, gloo with --device cpu")


def main(argv=None):
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
    d.add_argument("--batch", action="store_true",
                   help="one device batch per scale over every input map")
    d.add_argument("--stream", action="store_true",
                   help="pipelined per-map detection: the next map's "
                        "upload and device work overlap this map's host "
                        "merges")
    d.add_argument("--chunk", type=int, default=0,
                   help="pipelined detection over groups of N maps, in "
                        "input order")
    d.add_argument("--allow-random", action="store_true",
                   help="run with random init when a named checkpoint "
                        "does not exist (default: error)")
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
    _dist_flags(d, "split the tile batch over the processes, gather the "
                   "rows to each and write the files from process 0 only "
                   "(implies --batch)")
    d.set_defaults(fn=_detect)

    t = sub.add_parser("train", help="dataset build + training")
    t.add_argument("--data-root", default="datasets/GeoMap")
    t.add_argument("--tile-size", type=int, default=416)
    t.add_argument("--overlap", type=int, default=100)
    t.add_argument("--epochs", type=int, default=150)
    t.add_argument("--batch-size", type=int, default=16)
    t.add_argument("--channels", type=int, default=3, choices=(3, 4))
    t.add_argument("--scale", default="x")
    t.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="optimizer steps per group; they run one after "
                        "another, so the result is that of single steps")
    t.add_argument("--skip-cropping", action="store_true")
    t.add_argument("--skip-augmentation", action="store_true")
    t.add_argument("--filtered-rgb", action="store_true",
                   help="build the 4ch DT-Edge TIFF dataset "
                        "(implied by --channels 4)")
    t.add_argument("--resume", action="store_true",
                   help="resume from <ckpt-dir>/last.ckpt")
    t.add_argument("--init-ckpt",
                   help="warm-start params/EMA from a checkpoint (the "
                        "engine's pretrained start, Train_OBB.py:792); "
                        "step/schedule/optimizer start fresh")
    t.add_argument("--close-mosaic", type=int, default=None,
                   help="disable mosaic for the final N epochs "
                        "(engine default 10)")
    t.add_argument("--ckpt-dir")
    t.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card")
    _dist_flags(t, "the reference's data-parallel training "
                   "(Train_OBB.py:39-42): process 0 builds the dataset and "
                   "writes the files, every process trains on its rows of "
                   "each global batch")
    t.set_defaults(fn=_train)

    v = sub.add_parser("val", help="per-tile val mAP/fitness of a "
                                   "checkpoint (engine model.val())")
    v.add_argument("--ckpt", required=True)
    v.add_argument("--data-root",
                   help="dataset root holding val_cropped{ts}.txt")
    v.add_argument("--val-list", help="explicit val tile list file "
                                      "(overrides --data-root)")
    v.add_argument("--tile-size", type=int, default=416,
                   help="fallback when the ckpt lacks tile_size metadata")
    v.add_argument("--channels", type=int, default=3, choices=(3, 4))
    v.add_argument("--scale", default="x",
                   help="fallback when the ckpt lacks model_scale")
    v.add_argument("--batch-size", type=int, default=16)
    v.add_argument("--max-tiles", type=int)
    v.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card")
    _dist_flags(v, "each process validates a stride slice of the tiles, "
                   "the rows are gathered, process 0 reports the global "
                   "metric")
    v.set_defaults(fn=_val)

    c = sub.add_parser("convert",
                       help="ultralytics .pt/.npz -> checkpoint")
    c.add_argument("pt", help=".pt checkpoint or .npz state-dict dump")
    c.add_argument("--out", required=True, help="output .ckpt path")
    c.add_argument("--scale", default="x")
    c.add_argument("--channels", type=int, default=3, choices=(3, 4))
    c.add_argument("--nc", type=int, default=12)
    c.add_argument("--imgsz", type=int, default=416,
                   help="tile size recorded in the checkpoint")
    c.add_argument("--force", action="store_true",
                   help="write even if some model arrays are missing")
    c.set_defaults(fn=_convert)

    args = p.parse_args(argv)
    return _run(args.fn, args)


if __name__ == "__main__":
    main()
