"""What both detection drivers share: the program's detector, the pool of
seeded maps with their FLOPs, and the check of a sample of the window's
answers against the plain reference; the configuration's architecture
module (``archs/<model>.py``) builds the detector and the reference
models and counts the FLOPs."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from . import compare, synth
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
    """The program's detector, as the configuration's architecture builds
    it."""
    return cell.arch.program_detector(cell, device)


def map_flops(cell, h: int, w: int) -> float:
    """Forward FLOPs of one map: its tiles at each scale, each a full tile
    of the reference model."""
    cfg = cell.config
    return sum(len(synth.tile_grid(h, w, s["tile_size"], s["overlap"]))
               * cell.arch.forward_flops(cfg, s["tile_size"])
               for s in cfg["scales"])


def make_pool(sess: Session, shapes: list) -> None:
    sess.pool = [synth.synthetic_map(sess.seed, i, h, w, sess.device)[0]
                 for i, (h, w) in enumerate(shapes)]
    sess.flops_per_map = [map_flops(sess.cell, *m.shape[:2])
                          for m in sess.pool]


def release(sess: Session) -> None:
    """Draws the sample of answers to check and drops the detector."""
    n = len(sess.results)
    k = min(sess.cell.workload["check_maps"], n)
    rng = synth.rng_for(sess.seed, 7)
    sess.sample = sorted(rng.choice(n, size=k, replace=False).tolist())
    sess.det = None


def reference(sess: Session, precision: str = "float32") -> list:
    """The reference's results over the sampled answers' maps, through the
    architecture's tile input and decode where its module defines them
    (``reference/detect.py``; YOLO's otherwise)."""
    cfg = reference_config(sess.cell.config)
    arch = sess.cell.arch
    models = arch.reference_models(cfg, sess.cell.root, sess.device,
                                   precision)
    hooks = {k: getattr(arch, k) for k in RD.ARCH_HOOKS if hasattr(arch, k)}
    done = {}
    for i in sess.sample:
        p = sess.results[i][0]
        if p not in done:
            done[p] = RD.detect_map(models, sess.pool[p], cfg, sess.device,
                                    FLOOR, **hooks)
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
