"""What both detection drivers share: the program's detector built from a
configuration, spans around its layers for the traced run, the pool of
seeded maps, and the check of a sample of the window's answers against
the plain reference."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch

from . import compare, synth
from . import trace as TR
from ..reference import detect as RD

# rows below this confidence are left out of the check on both sides; the
# merges are exact above it (reference/merge.py)
FLOOR = compare.WEAK


@dataclass
class Session:
    cell: object
    seed: int
    device: torch.device
    det: object = None
    pool: list = field(default_factory=list)     # BGR maps
    results: list = field(default_factory=list)  # (pool index, result)
    sample: list = field(default_factory=list)
    flops_per_map: list = field(default_factory=list)
    ref_f32: list | None = None


def conf_thr(cfg: dict) -> float:
    return cfg["conf_thr_metrics"] if cfg["calculate_metrics"] \
        else cfg["conf_thr_predict"]


def reference_config(cfg: dict) -> dict:
    return {**cfg, "conf_thr": conf_thr(cfg)}


def build_detector(cell, device):
    """The program's ``TiledDetector`` for the configuration, every knob
    the configuration states passed through."""
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        build_detector as build)

    cfg = cell.config
    triples = [(s["tile_size"], s["overlap"],
                os.path.join(cell.root, s["checkpoint"]))
               for s in cfg["scales"]]
    fields = {k: cfg[k] for k in (
        "calculate_metrics", "conf_thr_metrics", "conf_thr_predict",
        "engine_nms_iou", "merge_iou", "apply_border_filter", "margin_128",
        "margin_416", "max_det_per_tile", "pre_topk", "compute_dtype")}
    return build(triples, channels=cfg["channels"],
                 model_scale=cfg["model_scale"], device=device, **fields)


def add_spans(det) -> None:
    """Spans around each scale's forward (hooks on its model) and around
    the decode and the NMS, for the traced run."""
    from oriented_object_detection_tpu_torch.models import decode as D

    for ts, model in det.models.items():
        def pre(mod, inp, _ts=ts):
            mod._obb_span = torch.profiler.record_function(
                f"{TR.SPAN_PREFIX}forward_{_ts}")
            mod._obb_span.__enter__()

        def post(mod, inp, out):
            mod._obb_span.__exit__(None, None, None)

        model.register_forward_pre_hook(pre)
        model.register_forward_hook(post)
    if not getattr(D, "_obb_wrapped", False):
        for name in ("decode_raw", "postprocess_batch"):
            inner = getattr(D, name)

            def wrapped(*a, _inner=inner, _name=name, **k):
                with TR.span(_name):
                    return _inner(*a, **k)

            setattr(D, name, wrapped)
        D._obb_wrapped = True


def map_flops(cfg: dict, h: int, w: int) -> float:
    """Forward FLOPs of one map: its tiles at each scale, each a full tile
    of the reference model."""
    from . import flops as FL

    return sum(len(synth.tile_grid(h, w, s["tile_size"], s["overlap"]))
               * FL.forward_flops(cfg["model_scale"], s["tile_size"],
                                  cfg["nc"], cfg["channels"])
               for s in cfg["scales"])


def make_pool(sess: Session, shapes: list) -> None:
    sess.pool = [synth.synthetic_map(sess.seed, i, h, w, sess.device)[0]
                 for i, (h, w) in enumerate(shapes)]
    sess.flops_per_map = [map_flops(sess.cell.config, *m.shape[:2])
                          for m in sess.pool]


def release(sess: Session) -> None:
    """Draws the sample of answers to check and drops the detector."""
    n = len(sess.results)
    k = min(sess.cell.workload["check_maps"], n)
    rng = synth.rng_for(sess.seed, 7)
    sess.sample = sorted(rng.choice(n, size=k, replace=False).tolist())
    sess.det = None


def reference(sess: Session, precision: str = "float32") -> list:
    """The reference's results over the sampled answers' maps."""
    cfg = reference_config(sess.cell.config)
    models = RD.load_models(cfg, sess.cell.root, sess.device, precision)
    done = {}
    for i in sess.sample:
        p = sess.results[i][0]
        if p not in done:
            done[p] = RD.detect_map(models, sess.pool[p], cfg, sess.device,
                                    FLOOR)
    del models
    return [done[sess.results[i][0]] for i in sess.sample]


def readings(sess: Session, outputs=None) -> dict:
    if not sess.results:
        return {k: float("inf") for k in sess.cell.workload["limits"]}
    if sess.ref_f32 is None:
        sess.ref_f32 = reference(sess, "float32")
    ref = sess.ref_f32
    got = outputs if outputs is not None else [sess.results[i][1]
                                               for i in sess.sample]
    return compare.detection_readings(got, ref)
