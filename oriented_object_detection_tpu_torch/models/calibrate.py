"""Detection-density calibration of randomly initialized models.

A fresh model scores almost every anchor at a tiny constant confidence (the
engine's sparse class-bias init and near-zero logit variance), so it gives
no detection at the 0.25 predict threshold and a check on its rows compares
empty sets. ``calibrate_density`` shifts the class-branch biases so that a
fraction ``target`` of the anchors score about 0.45, clear of the threshold.
The port of the JAX package's ``models/calibrate.py``; its input is the same
seeded numpy batch, so the two offsets are comparable.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.runtime import resolve_device
from . import decode as D
from .weights import load_state, torch_state_from_jax

DENSITY_TARGET = 0.01


def calibrate_density(model, variables: dict, tile_size: int,
                      channels: int, target: float = DENSITY_TARGET,
                      device=None) -> dict:
    """Flax variables {'params', 'batch_stats'} (numpy trees) with every
    ``cv3_*_2`` bias shifted so that ``target`` of the anchors of eight
    ``RandomState(7)`` images land at conf 0.45: the head's last class
    convs, at layer 23 in YOLO11 and 21 in YOLO12. ``model`` is a
    ``YOLO11OBB`` or ``YOLO12OBB`` of the variables' shape; they are loaded
    into it, and it runs on ``device`` (the CUDA card unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(7)
    x = rng.randint(0, 255, (8, tile_size, tile_size, channels)) / 255.0
    x = torch.from_numpy(x.astype(np.float32)).permute(0, 3, 1, 2)
    load_state(model, torch_state_from_jax(variables))
    model = model.to(dev).eval()
    with torch.inference_mode():
        scores = D.decode_raw(model(x.to(dev)), tile_size)[1]
    s = np.clip(scores.cpu().numpy().astype(np.float64).reshape(-1), 1e-9,
                1 - 1e-9)
    logits = np.log(s / (1 - s))
    offset = float(np.log(0.45 / 0.55)) - float(
        np.quantile(logits, 1.0 - target))

    def shift(tree: dict, path: tuple) -> dict:
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = shift(v, path + (k,))
            elif k == "bias" and any(str(p).startswith("cv3_")
                                     and str(p).endswith("_2")
                                     for p in path):
                out[k] = v + np.float32(offset)
            else:
                out[k] = v
        return out

    return shift(variables, ())
