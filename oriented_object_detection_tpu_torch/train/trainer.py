"""Training loop, the port of the JAX package's ``train/trainer.py``: the
engine's SGD (nesterov, momentum 0.937, weight decay coupled and on conv
kernels only) with the warmup and linear-decay schedule, the EMA of the
parameters (decay 0.9999 ramped by 1 - exp(-step/tau)), early-stop
patience and best/last checkpoints in the JAX package's format
(`Train_OBB.py:796-841`).

The optimizer is ``torch.optim.SGD`` with three parameter groups (conv
kernels with decay, BatchNorm scales without, every bias with the bias
warmup), whose lr and momentum are set before each step from the schedule,
computed in float32 as the JAX train step computes it. Its update is the
JAX package's ``sgd_apply``: g += wd * p; m = g + mu * m; p -= lr * (g +
mu * m).
"""

from __future__ import annotations

import copy
import math
import os
import pickle

import numpy as np
import torch

from ..config import TrainConfig, torch_dtype
from ..models.weights import (jax_trees_from_torch_state, load_checkpoint,
                              load_state, torch_state_from_jax)
from ..models.yolo11_obb import STRIDES, YOLO11OBB
from ..parallel import distributed as PD
from ..utils.runtime import resolve_device
from .loss import LossConfig, obb_loss

METRIC_KEYS = ("loss", "box", "cls", "dfl", "fg_count")
GROUPS = ("decay", "no_decay", "bias")


def make_sched_vector(cfg: TrainConfig, steps_per_epoch: int) -> np.ndarray:
    """[total_steps, warm_steps, lr0, lrf, warmup_momentum, momentum,
    warmup_bias_lr] as float32."""
    total = float(cfg.epochs * steps_per_epoch)
    warm = float(max(1, int(cfg.warmup_epochs * steps_per_epoch)))
    return np.asarray([total, warm, cfg.lr0, cfg.lrf, cfg.warmup_momentum,
                       cfg.momentum, cfg.warmup_bias_lr], np.float32)


def schedule_hypers(sched: np.ndarray, step: int) -> dict:
    """The engine's hyperparameters at ``step``, in float32: lr decays
    linearly lr0 -> lr0 * lrf over total_steps; over the warmup window the
    momentum ramps warmup_momentum -> momentum, the bias group's lr
    warmup_bias_lr -> scheduled and the other groups' lr 0 -> scheduled."""
    total, warm, lr0, lrf, wmom, mom, wbias = (np.float32(v) for v in sched)
    s = np.float32(step)
    frac = np.minimum(s, total - np.float32(1)) / total
    base = lr0 * (np.float32(1) - frac) + (lr0 * lrf) * frac
    w = np.clip(s / warm, np.float32(0), np.float32(1))
    return {"lr": base * w,
            "lr_bias": wbias * (np.float32(1) - w) + base * w,
            "momentum": wmom * (np.float32(1) - w) + mom * w}


def param_group(name: str, p: torch.Tensor) -> str:
    """The engine's split: every ``bias`` (conv biases, BatchNorm offsets)
    warms up from warmup_bias_lr; conv kernels (ndim >= 2) take weight
    decay; BatchNorm scales neither."""
    if name.endswith(".bias"):
        return "bias"
    return "decay" if p.ndim >= 2 else "no_decay"


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig
                   ) -> torch.optim.SGD:
    groups = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        groups[param_group(name, p)].append(p)
    return torch.optim.SGD(
        [{"params": groups[g], "name": g,
          "weight_decay": cfg.weight_decay if g == "decay" else 0.0}
         for g in GROUPS],
        lr=cfg.lr0, momentum=cfg.momentum, nesterov=True)


def set_hypers(opt: torch.optim.SGD, hypers: dict) -> None:
    for g in opt.param_groups:
        g["lr"] = float(hypers["lr_bias" if g["name"] == "bias" else "lr"])
        g["momentum"] = float(hypers["momentum"])


def ema_decay_at(step: int, decay: float, tau: float) -> np.float32:
    """d = decay * (1 - exp(-step / tau)) in float32 (XLA turns the
    division by the constant tau into a multiply by its reciprocal)."""
    s = np.float32(step) * np.float32(1.0 / tau)
    return np.float32(decay) * (np.float32(1) - np.exp(-s))


@torch.no_grad()
def ema_update(ema: list, params: list, step: int, decay: float,
               tau: float) -> None:
    """ema = ema * d + p * (1 - d) over the parameters (not the BatchNorm
    statistics), with d at ``step``."""
    d = ema_decay_at(step, decay, tau)
    torch._foreach_mul_(ema, float(d))
    torch._foreach_add_(ema, torch._foreach_mul(params,
                                                float(np.float32(1) - d)))


class TrainState:
    """The model in training mode, its EMA copy (parameters only; the
    BatchNorm statistics are the model's), the optimizer, the step and the
    schedule vector."""

    def __init__(self, model: YOLO11OBB, opt: torch.optim.SGD,
                 sched: np.ndarray, step: int = 0):
        self.model = model
        self.ema = copy.deepcopy(model).requires_grad_(False).eval()
        self.opt = opt
        self.sched = sched
        self.step = step

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def reset_ema(self) -> None:
        with torch.no_grad():
            for e, p in zip(self.ema.parameters(), self.model.parameters()):
                e.copy_(p)

    def eval_model(self) -> YOLO11OBB:
        """The model for inference (validation, like the engine's best.pt):
        the EMA parameters with the model's BatchNorm statistics, in eval
        mode."""
        with torch.no_grad():
            for e, b in zip(self.ema.buffers(), self.model.buffers()):
                e.copy_(b)
        return self.ema.eval()


def init_head_biases(model: YOLO11OBB, nc: int) -> None:
    """The engine's bias_init: box DFL conv biases 1.0, class conv biases
    log(5 / nc / (640 / stride)^2), so a fresh detector is sparse."""
    head = model.model["23"]
    with torch.no_grad():
        for lvl, s in enumerate(STRIDES):
            head.cv2[lvl][-1].bias.fill_(1.0)
            head.cv3[lvl][-1].bias.fill_(
                math.log(5.0 / nc / (640.0 / s) ** 2))


# flax's truncated normal in [-2, 2] has this standard deviation; lecun
# normal divides it out
_TRUNC_STD = 0.87962566103423978


def fresh_model(nc: int, scale: str, channels: int, seed: int
                ) -> YOLO11OBB:
    """A freshly initialized model on the CPU, by the JAX package's rule
    (flax's defaults, the values drawn from a generator seeded by
    ``seed``): every conv kernel lecun normal (a normal truncated at two
    standard deviations, variance 1 / fan_in), every conv bias 0, the
    BatchNorm scales 1, biases 0 and statistics 0 and 1, then the engine's
    head biases. torch's default conv init has a third of that variance,
    which fades the signal over the network's depth until a random model's
    scores hardly depend on its input."""
    torch.manual_seed(seed)
    model = YOLO11OBB(nc=nc, scale=scale, in_channels=channels)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                std = 1.0 / math.sqrt(m.weight[0].numel()) / _TRUNC_STD
                torch.nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                            b=2 * std, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
    init_head_biases(model, nc)
    return model


def create_train_state(cfg: TrainConfig, steps_per_epoch: int = 100,
                       device=None) -> TrainState:
    """A freshly initialized model (seeded by ``cfg.seed``) on ``device``
    (the CUDA card unless ``device="cpu"``), its EMA, the optimizer."""
    dev = resolve_device(device)
    model = fresh_model(cfg.nc, cfg.model_scale, cfg.channels,
                        cfg.seed).to(dev).train()
    return TrainState(model, make_optimizer(model, cfg),
                      make_sched_vector(cfg, steps_per_epoch))


def loss_config(cfg: TrainConfig) -> LossConfig:
    return LossConfig(nc=cfg.nc, img_size=cfg.tile_size,
                      box_gain=cfg.box_gain, cls_gain=cfg.cls_gain,
                      dfl_gain=cfg.dfl_gain)


def train_step(state: TrainState, batch: dict, cfg: TrainConfig
               ) -> torch.Tensor:
    """One optimizer step; returns the float32 [5] metrics (METRIC_KEYS) on
    the device. The BatchNorm statistics move in the forward, the
    schedule is read at the step before it is incremented, and the EMA
    follows the new parameters at step + 1.

    In a data-parallel group ``batch`` is this process's rows of the global
    batch: the BatchNorm statistics and the loss normaliser are the global
    batch's, the gradients are summed over the processes (the gradient of
    the one global loss, as the JAX package's step on the global batch
    takes it), so every process makes the same update; the metrics are
    summed too, the global batch's.

    The forward and backward run in ``cfg.compute_dtype`` (the images are
    cast to it); the loss upcasts the head outputs, and the parameters,
    gradients, momentum, EMA and BatchNorm statistics are float32."""
    set_hypers(state.opt, schedule_hypers(state.sched, state.step))
    state.model.train()
    out = state.model(batch["images"].to(torch_dtype(cfg.compute_dtype)))
    total, parts = obb_loss(out, batch["gt_labels"], batch["gt_xywhr"],
                            batch["gt_mask"], loss_config(cfg))
    state.opt.zero_grad(set_to_none=True)
    total.backward()
    if PD.active():
        PD.all_reduce_grads(state.model.parameters())
    state.opt.step()
    ema_update(list(state.ema.parameters()), list(state.model.parameters()),
               state.step + 1, cfg.ema_decay, cfg.ema_tau)
    state.step += 1
    metrics = torch.stack([total.detach()] + [parts[k].detach().float()
                                              for k in METRIC_KEYS[1:]])
    return PD.all_reduce_sum_(metrics)


# ---------------------------------------------------------------------------
# Checkpoints, in the JAX package's format
# ---------------------------------------------------------------------------

def checkpoint_payload(state: TrainState) -> dict:
    """{'step', 'params', 'batch_stats', 'ema_params', 'opt_state', 'sched'}
    as flax-keyed numpy trees, the JAX package's checkpoint payload (with
    the schedule vector besides)."""
    trees = jax_trees_from_torch_state(state.model.state_dict())
    named = dict(state.model.named_parameters())
    ema = dict(zip(named, state.ema.parameters()))
    mom = {n: state.opt.state.get(p, {}).get("momentum_buffer",
                                              torch.zeros_like(p))
           for n, p in named.items()}
    return {"step": int(state.step), "params": trees["params"],
            "batch_stats": trees["batch_stats"],
            "ema_params": jax_trees_from_torch_state(ema)["params"],
            "opt_state": jax_trees_from_torch_state(mom)["params"],
            "sched": np.asarray(state.sched, np.float32)}


def write_checkpoint(path: str, payload: dict, extra: dict | None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({**payload, "extra": extra or {}}, f)


def save_checkpoint(path: str, state: TrainState,
                    extra: dict | None = None) -> None:
    write_checkpoint(path, checkpoint_payload(state), extra)


def _load_params(module: torch.nn.Module, params: dict,
                 batch_stats: dict) -> None:
    load_state(module, torch_state_from_jax(
        {"params": params, "batch_stats": batch_stats}))


def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Resume: parameters, BatchNorm statistics, EMA, SGD momentum and step
    from a checkpoint. A checkpoint without optimizer state restarts the
    momentum from zero, with a message."""
    ck = load_checkpoint(path)
    _load_params(state.model, ck["params"], ck["batch_stats"])
    _load_params(state.ema, ck["ema_params"], ck["batch_stats"])
    state.opt.state.clear()
    opt = ck.get("opt_state")
    if opt is None:
        print("[Resume] checkpoint has no optimizer state; momentum "
              "restarts from zero")
    else:
        mom = torch_state_from_jax({"params": opt})
        for name, p in state.model.named_parameters():
            state.opt.state[p]["momentum_buffer"] = torch.as_tensor(
                mom[name], device=p.device).clone()
    state.step = int(ck["step"])
    return state


def warm_start_state(path: str, state: TrainState,
                     expect: dict | None = None) -> TrainState:
    """Warm start (``train --init-ckpt``): parameters (the EMA ones when the
    checkpoint has them) and BatchNorm statistics, without touching step,
    schedule or optimizer; the EMA restarts from the loaded parameters. A
    recorded ``extra`` value that differs from ``expect`` (model_scale,
    channels) raises before any step."""
    ck = load_checkpoint(path)
    extra = ck.get("extra") or {}
    for k, want in (expect or {}).items():
        have = extra.get(k)
        if have is not None and have != want:
            raise SystemExit(
                f"--init-ckpt {path}: checkpoint was saved with {k}={have!r} "
                f"but this run uses {k}={want!r}; convert/choose a matching "
                f"checkpoint")
    src = ck["ema_params"] if ck.get("ema_params") is not None \
        else ck["params"]
    _load_params(state.model, src, ck["batch_stats"])
    state.reset_ema()
    return state


# ---------------------------------------------------------------------------
# Epoch loop with patience and best tracking
# ---------------------------------------------------------------------------

def _log(epoch: int, i: int, m) -> None:
    m = dict(zip(METRIC_KEYS, m.tolist()))
    print(f"epoch {epoch} step {i}: loss={m['loss']:.4f} box={m['box']:.4f} "
          f"cls={m['cls']:.4f} dfl={m['dfl']:.4f}")


def state_tensors(state: TrainState) -> dict:
    """Every tensor the processes of a data-parallel group must hold alike:
    the parameters, the BatchNorm statistics and the EMA."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"ema.{k}": p for k, p in state.ema.named_parameters()})
    return out


def fit(state: TrainState, cfg: TrainConfig, train_batches, val_fn=None,
        ckpt_dir: str = "runs/obb/train", log_every: int = 10,
        resume: bool = False, init_ckpt: str | None = None) -> TrainState:
    """Epoch loop: ``train_batches(epoch)`` yields the epoch's batch dicts;
    ``val_fn(state) -> float`` is the fitness (higher is better). Stops
    after ``cfg.patience`` epochs without a better fitness; writes
    ``best.ckpt`` and ``last.ckpt`` (the JAX package's format), and
    ``results.csv`` with the plots. ``resume`` restores ``last.ckpt`` of
    ckpt_dir if present; else ``init_ckpt`` warm-starts.

    In a data-parallel group every process runs this loop on its rows of
    each global batch, and process 0 alone writes the files and the log.
    Every process must start from the same state (the same seed, or the
    same file to resume or warm-start from): the start compares the
    processes' parameters, statistics and EMA bit for bit and raises if
    they differ. The steps keep them equal, and ``val_fn`` must give
    every process the same fitness, so the best epoch and the early stop
    agree."""
    from ..utils.plots import (ResultsWriter, plot_train_batch,
                               write_args_yaml)

    main = PD.is_main()
    start_epoch = 0
    best, best_epoch = -float("inf"), -1
    last_path = os.path.join(ckpt_dir, "last.ckpt")
    if resume and os.path.exists(last_path):
        ck = load_checkpoint(last_path)
        state = restore_train_state(last_path, state)
        start_epoch = int(ck["extra"].get("epoch", -1)) + 1
        best = float(ck["extra"].get("best_fitness", best))
        best_epoch = int(ck["extra"].get("best_epoch", best_epoch))
        if main:
            print(f"[Resume] from {last_path} @ epoch {start_epoch}")
    elif init_ckpt:
        if not os.path.exists(init_ckpt):
            raise FileNotFoundError(f"--init-ckpt {init_ckpt} not found")
        state = warm_start_state(init_ckpt, state, expect={
            "model_scale": cfg.model_scale, "channels": cfg.channels})
        if main:
            print(f"[WarmStart] params/EMA initialized from {init_ckpt}")
    PD.check_same_across_ranks(state_tensors(state))

    results = None
    if main:
        results = ResultsWriter(ckpt_dir, plots=cfg.plots)
        write_args_yaml(ckpt_dir, cfg)
    meta = {"model_scale": cfg.model_scale, "channels": cfg.channels,
            "tile_size": cfg.tile_size}
    for epoch in range(start_epoch, cfg.epochs):
        acc = torch.zeros(len(METRIC_KEYS), device=state.device)
        count = 0
        for i, batch in enumerate(train_batches(epoch)):
            if epoch == start_epoch and i == 0 and cfg.plots and main:
                plot_train_batch(batch, os.path.join(ckpt_dir,
                                                     "train_batch0.jpg"))
            m = train_step(state, batch, cfg)
            acc += m
            count += 1
            if i % log_every == 0 and main:
                _log(epoch, i, m)
        fitness = float(val_fn(state)) if val_fn is not None else 0.0
        improved = fitness > best
        if improved:
            best, best_epoch = fitness, epoch
        if main:
            sums = dict(zip(METRIC_KEYS, acc.tolist()))
            results.append(
                epoch=epoch, fitness=fitness,
                lr=float(schedule_hypers(state.sched, state.step)["lr"]),
                **{k: v / max(count, 1) for k, v in sums.items()})
            payload = checkpoint_payload(state)
            if improved:
                write_checkpoint(os.path.join(ckpt_dir, "best.ckpt"),
                                 payload,
                                 {"epoch": epoch, "fitness": fitness, **meta})
            write_checkpoint(last_path, payload,
                             {"epoch": epoch, "fitness": fitness,
                              "best_fitness": best, "best_epoch": best_epoch,
                              **meta})
        if epoch - best_epoch >= cfg.patience:
            if main:
                print(f"[EarlyStop] no improvement for {cfg.patience} "
                      f"epochs (best fitness {best:.4f} @ epoch "
                      f"{best_epoch})")
            break
    return state
