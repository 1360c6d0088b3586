"""Traffic driver: `Train_OBB.py`'s loop, ``trainer.train_step`` fed by
``TileDataset.batches`` (the loop ``fit`` runs, without validation or
checkpoints), one optimizer step after another.

Parameters: ``maps`` seeded maps of ``map_size`` pixels a side, cut into
tiles on the detector's grid with labels from their rectangles. Set-up
builds the one training state, warm-starts it from the configuration's
checkpoint and drives it through its first three steps from the seed,
keeping what the check compares (the losses, the first gradient from
the optimizer's state, the change of the parameters and of the EMA);
the window continues the same state and the same batch stream. The
record: steps, window seconds, the loader's host seconds a batch and the
step's FLOPs."""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from obbbench.harness import compare, synth
from obbbench.harness import flops as FL
from obbbench.harness import trace as TR
from obbbench.reference import ckpt as RC
from obbbench.reference import model as RM
from obbbench.reference import train as RT

CHECK_STEPS = 3


@dataclass
class Session:
    cell: object
    seed: int
    device: torch.device
    tiles: np.ndarray = None
    labels: list = None
    loader_seed: int = 0
    state: object = None
    cfg: object = None
    batches: object = None
    got: dict = field(default_factory=dict)
    ref_f32: dict | None = None
    workdir: str = ""


def _train_config(c: dict):
    from oriented_object_detection_tpu_torch.config import TrainConfig

    return TrainConfig(
        channels=c["channels"], tile_size=c["tile_size"],
        overlap=c["overlap"], epochs=c["epochs"], batch_size=c["batch_size"],
        model_scale=c["model_scale"], nc=c["nc"], lr0=c["lr0"], lrf=c["lrf"],
        weight_decay=c["weight_decay"], momentum=c["momentum"],
        warmup_epochs=c["warmup_epochs"],
        warmup_momentum=c["warmup_momentum"],
        warmup_bias_lr=c["warmup_bias_lr"], ema_decay=c["ema_decay"],
        ema_tau=c["ema_tau"], box_gain=c["box_gain"],
        cls_gain=c["cls_gain"], dfl_gain=c["dfl_gain"], plots=False,
        compute_dtype=c["compute_dtype"])


def _dataset(sess: Session):
    """The program's ``TileDataset`` over the tiles: label files written
    in a temporary directory, the pixels handed over by ``reader``."""
    from oriented_object_detection_tpu_torch.data import labels as L
    from oriented_object_detection_tpu_torch.data.loader import TileDataset

    sess.workdir = tempfile.mkdtemp(prefix="obbbench_")
    for d in ("images", "labels"):
        os.makedirs(f"{sess.workdir}/{d}/train")
    pixels = {}
    for i, (tile, lab) in enumerate(zip(sess.tiles, sess.labels)):
        L.write_labels(f"{sess.workdir}/labels/train/t{i}.txt", lab)
        pixels[f"{sess.workdir}/images/train/t{i}.jpg"] = tile
    lst = f"{sess.workdir}/train.txt"
    with open(lst, "w") as f:
        f.write("\n".join(pixels) + "\n")
    return TileDataset(lst, sess.cfg.tile_size, sess.cfg.channels,
                       device=sess.device, reader=pixels.__getitem__)


def _endless(ds, bs: int, rng):
    while True:
        yield from ds.batches(bs, rng)


def _norms(ts) -> np.ndarray:
    return np.asarray([float(torch.linalg.vector_norm(t.detach().double()))
                       for t in ts])


def setup(cell, seed: int, device):
    from oriented_object_detection_tpu_torch.train import trainer as TRN

    c, p = cell.config, cell.workload["params"]
    sess = Session(cell, seed, device)
    sess.cfg = cfg = _train_config(c)
    sess.tiles, sess.labels = synth.training_tiles(
        seed, p["maps"], p["map_size"], c["tile_size"], c["overlap"], device)
    sess.loader_seed = int(synth.rng_for(seed, 3).integers(0, 2 ** 32))
    ds = _dataset(sess)
    spe = len(ds) // cfg.batch_size
    state = TRN.create_train_state(cfg, spe, device=device)
    TRN.warm_start_state(os.path.join(cell.root, c["init_checkpoint"]),
                         state, expect={"model_scale": cfg.model_scale,
                                        "channels": cfg.channels})
    sess.state = state
    sess.batches = _endless(ds, cfg.batch_size,
                            np.random.RandomState(sess.loader_seed))
    names = [n for n, _ in state.model.named_parameters()]
    wd = [cfg.weight_decay if RT.group_of(n, p_) == "decay" else 0.0
          for n, p_ in state.model.named_parameters()]
    p0 = [t.detach().clone() for t in state.model.parameters()]
    e0 = [t.detach().clone() for t in state.ema_tensors()]
    losses = []
    for k in range(CHECK_STEPS):
        m = TRN.train_step(state, next(sess.batches), cfg)
        losses.append(float(m[0]))
        if k == 0:
            sess.got["grad"] = _norms(
                [mom - w * p_ for mom, w, p_ in
                 zip(state.momentum_tensors(), wd, p0)])
    state.sync()
    sess.got.update(
        losses=losses, names=names,
        change=_norms([a - b for a, b in zip(state.model.parameters(), p0)]),
        ema_change=_norms([a - b for a, b in zip(state.ema_tensors(), e0)]))
    del p0, e0
    for _ in range(p["warm_steps"]):
        TRN.train_step(state, next(sess.batches), cfg)
    return sess


def window(sess, seconds: float, max_units: int | None) -> dict:
    from oriented_object_detection_tpu_torch.train import trainer as TRN

    n_max = max_units or 1_000_000
    loader_s, steps = [], 0
    t0 = time.perf_counter()
    while steps < n_max:
        t = time.perf_counter()
        with TR.span("loader"):
            batch = next(sess.batches)
        loader_s.append(time.perf_counter() - t)
        with TR.span("train_step"):
            TRN.train_step(sess.state, batch, sess.cfg)
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if sess.device.type == "cuda":
        torch.cuda.synchronize()
    c = sess.cell.config
    return {"window_s": time.perf_counter() - t0, "units": steps,
            "steps": steps, "loader_s": loader_s,
            "flops": steps * FL.train_step_flops(
                c["model_scale"], c["tile_size"], c["batch_size"], c["nc"],
                c["channels"])}


def release(sess) -> None:
    sess.state = sess.batches = None
    shutil.rmtree(sess.workdir, ignore_errors=True)


def reference(sess, precision: str = "float32", fault: str | None = None
              ) -> dict:
    """The reference's first three steps from the same checkpoint on the
    same tiles and loader seed. ``fault="half_batch"`` leaves out half of
    each batch (the loss's mean over the rest)."""
    c = sess.cell.config
    dev = sess.device
    model = RM.build(RC.state_dict(RC.load(os.path.join(
        sess.cell.root, c["init_checkpoint"]))), c["model_scale"], c["nc"],
        c["channels"], dev).set_precision(precision)
    loader = RT.Loader(sess.tiles, sess.labels)
    spe = len(sess.tiles) // c["batch_size"]
    tr = RT.Trainer(model, c, spe)
    it = loader.batches(c["batch_size"], np.random.RandomState(
        sess.loader_seed), dev, half=fault == "half_batch")
    p0 = [p.detach().clone() for _, p in tr.named]
    wd = [c["weight_decay"] if RT.group_of(n, p) == "decay" else 0.0
          for n, p in tr.named]
    losses, out = [], {}
    for k in range(CHECK_STEPS):
        losses.append(tr.train_step(next(it)))
        if k == 0:
            out["grad"] = _norms([m - w * p for m, w, p in
                                  zip(tr.mom, wd, p0)])
    out.update(losses=losses, names=[n for n, _ in tr.named],
               change=_norms([p - q for (_, p), q in zip(tr.named, p0)]),
               ema_change=_norms([e - q for e, q in zip(tr.ema, p0)]))
    del tr, model
    return out


def readings(sess, outputs=None) -> dict:
    if sess.ref_f32 is None:
        sess.ref_f32 = reference(sess, "float32")
    got = outputs if outputs is not None else sess.got
    if got["names"] != sess.ref_f32["names"]:
        raise RuntimeError("the program's parameters are not the "
                           "reference's, in name or order")
    return compare.training_readings(got, sess.ref_f32)
