"""How close the PyTorch port's training is to the JAX package's, on the CPU
in float32, printed as one JSON line:

  * the training-mode forward (head outputs) and the BatchNorm statistics
    it moves, n scale from ``assets/bench_ckpts/train128.ckpt``, at tile
    32 and tile 64, batch 2 (at tile 32 the stride-32 level normalizes two
    values a channel, which multiplies rounding differences layer by layer);
  * one whole train step at tile 64, batch 2 (step 2 of the warmup, random
    momentum buffers) against ``make_train_step``: the loss and, per
    parameter tree, the largest difference relative to each leaf's largest
    value.

    JAX_PLATFORMS=cpu python tools/torch_train_parity.py

``tests/test_torch_train.py`` holds the port to bounds on the same
comparisons; this script prints the measured values.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from oriented_object_detection_tpu.config import TrainConfig as JaxCfg  # noqa: E402
from oriented_object_detection_tpu.models import YOLO11OBB as JaxModel  # noqa: E402
from oriented_object_detection_tpu.train import trainer as JT  # noqa: E402
from oriented_object_detection_tpu.train.loss import LossConfig  # noqa: E402
from oriented_object_detection_tpu_torch.config import TrainConfig  # noqa: E402
from oriented_object_detection_tpu_torch.models import weights as TW  # noqa: E402
from oriented_object_detection_tpu_torch.ops import geometry as G  # noqa: E402
from oriented_object_detection_tpu_torch.train import trainer as TT  # noqa: E402
from tools.train_synthetic import gen_map  # noqa: E402

CKPT = os.path.join(REPO, "assets", "bench_ckpts", "train128.ckpt")
B, M = 2, 16


def batch(ts: int):
    """Two ts tiles of one seeded map, with their boxes in pixels."""
    img, lab = gen_map(np.random.RandomState(1), H=ts, W=ts * B, n_obj=8)
    imgs = np.stack([img[:, i * ts:(i + 1) * ts]
                     for i in range(B)]).astype(np.float32) / 255.0
    lab[:, 1::2] *= ts * B
    lab[:, 2::2] *= ts
    gl, gm = np.zeros((B, M), np.int32), np.zeros((B, M), bool)
    gb = np.zeros((B, M, 5), np.float32)
    for i in range(B):
        sel = lab[(lab[:, 1::2].mean(1) >= i * ts)
                  & (lab[:, 1::2].mean(1) < (i + 1) * ts)]
        c8 = sel[:, 1:].copy()
        c8[:, 0::2] -= i * ts
        gl[i, :len(sel)], gm[i, :len(sel)] = sel[:, 0], True
        gb[i, :len(sel)] = G.corners8_to_xywhr_np(c8)
    return imgs, gl, gb, gm


def max_rel(ref, got) -> float:
    ref, got = np.asarray(ref), np.asarray(got)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-6))


def tree_rel(ref: dict, got: dict) -> float:
    if isinstance(ref, dict):
        return max(tree_rel(ref[k], got[k]) for k in ref)
    return max_rel(ref, got)


def forward(weights, ts: int) -> dict:
    imgs = batch(ts)[0]
    with jax.enable_x64(False):
        jm = JaxModel(nc=12, scale="n")
        out, upd = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(weights, imgs)
    model = TT.create_train_state(TrainConfig(model_scale="n", tile_size=ts),
                                  device="cpu").model
    TW.load_state(model, TW.torch_state_from_jax(weights))
    got = model.train()(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    head = max(max_rel(np.asarray(a).transpose(0, 3, 1, 2),
                       b.detach().numpy())
               for k in ("box", "cls", "ang") for a, b in zip(out[k], got[k]))
    stats = tree_rel(jax.tree.map(np.asarray, dict(upd["batch_stats"])),
                     TW.jax_trees_from_torch_state(
                         model.state_dict())["batch_stats"])
    return {"head": head, "batch_stats": stats}


def step(weights, ts: int = 64) -> dict:
    imgs, gl, gb, gm = batch(ts)
    cfg = TrainConfig(tile_size=ts, batch_size=B, model_scale="n", epochs=3)
    jcfg = dataclasses.replace(JaxCfg(), tile_size=ts, batch_size=B,
                               model_scale="n", compute_dtype="float32",
                               epochs=3)
    rng = np.random.RandomState(5)
    mom = jax.tree.map(lambda a: (rng.randn(*a.shape) * 1e-3).astype(
        np.float32), weights["params"])
    sched = TT.make_sched_vector(cfg, 4)
    with jax.enable_x64(False):
        state = JT.TrainState(
            step=jnp.asarray(2, jnp.int32),
            params=jax.tree.map(jnp.asarray, weights["params"]),
            batch_stats=jax.tree.map(jnp.asarray, weights["batch_stats"]),
            opt_state=jax.tree.map(jnp.asarray, mom),
            ema_params=jax.tree.map(jnp.array, weights["params"]),
            sched=jnp.asarray(sched))
        fn = JT.make_train_step(JaxModel(nc=12, scale="n"), None, jcfg,
                                LossConfig(nc=12, img_size=ts))
        new, m = fn(state, {"images": jnp.asarray(imgs),
                            "gt_labels": jnp.asarray(gl),
                            "gt_xywhr": jnp.asarray(gb),
                            "gt_mask": jnp.asarray(gm)})
        new, m = jax.tree.map(np.asarray, (new, m))
    st = TT.create_train_state(cfg, 4, device="cpu")
    TW.load_state(st.model, TW.torch_state_from_jax(weights))
    st.reset_ema()
    st.step = 2
    mt = TW.torch_state_from_jax({"params": mom})
    for n, p in st.model.named_parameters():
        st.opt.state[p]["momentum_buffer"] = torch.from_numpy(mt[n].copy())
    got = TT.train_step(st, {
        "images": torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous(),
        "gt_labels": torch.from_numpy(gl).long(),
        "gt_xywhr": torch.from_numpy(gb),
        "gt_mask": torch.from_numpy(gm)}, cfg).numpy()
    out = TT.checkpoint_payload(st)
    return {"loss": max_rel(m[:4], got[:4]), "fg": [float(m[4]),
                                                    float(got[4])],
            **{k: tree_rel(jax.tree.map(np.asarray, dict(getattr(new, k))),
                           out[k])
               for k in ("params", "ema_params", "batch_stats",
                         "opt_state")}}


def main() -> None:
    weights = TW.variables_from_checkpoint(CKPT)
    print(json.dumps({"forward_tile32_batch2": forward(weights, 32),
                      "forward_tile64_batch2": forward(weights, 64),
                      "step_tile64_batch2": step(weights)}))


if __name__ == "__main__":
    main()
