"""A bf16 YOLO11n-OBB train step against the JAX package's
``make_train_step`` in bf16, held to the JAX package's own gap between its
bf16 and float32 steps, and the float32 optimizer state after it.

Every step starts from one state on four batches of two 64-pixel tiles,
and the gaps are taken over the four; the state is step 2 of the warmup
with random momentum buffers, or step 0 as ``fit`` starts. One step's gap
is one draw of bf16 rounding noise: two equally valid bf16 roundings of a
step differ leaf by leaf by up to several times the JAX package's own gap
on one batch, and still 2x on four, so the updates are held in aggregate
(the median over the leaves) to the JAX package's own gap, and leaf by
leaf only loosely."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oriented_object_detection_tpu.config import TrainConfig as JaxCfg
from oriented_object_detection_tpu.models import YOLO11OBB as JaxModel
from oriented_object_detection_tpu.train import trainer as JT
from oriented_object_detection_tpu.train.loss import LossConfig as JaxLoss
from oriented_object_detection_tpu_torch.config import TrainConfig
from oriented_object_detection_tpu_torch.models import weights as TW
from oriented_object_detection_tpu_torch.ops import geometry as G
from oriented_object_detection_tpu_torch.train import trainer as TT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "bench_ckpts", "train128.ckpt")
sys.path.insert(0, REPO)
from tools.train_synthetic import gen_map  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

TS, B, M = 64, 2, 16
SEEDS = (1, 11, 21, 31)          # the four batches
RUNS = ("port_bfloat16", "jax_bfloat16", "jax_float32")


def _batch(seed: int):
    """Two 64 tiles of one seeded map with their boxes in pixels."""
    img, lab = gen_map(np.random.RandomState(seed), H=TS, W=TS * B,
                       n_obj=8)
    imgs = np.stack([img[:, i * TS:(i + 1) * TS]
                     for i in range(B)]).astype(np.float32) / 255.0
    lab[:, 1::2] *= TS * B
    lab[:, 2::2] *= TS
    gl = np.zeros((B, M), np.int32)
    gm = np.zeros((B, M), bool)
    gb = np.zeros((B, M, 5), np.float32)
    for i in range(B):
        cx = lab[:, 1::2].mean(1)
        sel = lab[(cx >= i * TS) & (cx < (i + 1) * TS)]
        c8 = sel[:, 1:].copy()
        c8[:, 0::2] -= i * TS
        gl[i, :len(sel)] = sel[:, 0]
        gm[i, :len(sel)] = True
        gb[i, :len(sel)] = G.corners8_to_xywhr_np(c8)
    assert gm.sum(1).min() > 0
    return imgs, gl, gb, gm


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's jitted ``make_train_step`` in bf16 and in float32,
    compiled once for the module."""
    out = {}
    for dtype in ("bfloat16", "float32"):
        jcfg = dataclasses.replace(JaxCfg(), tile_size=TS, batch_size=B,
                                   model_scale="n", epochs=3,
                                   compute_dtype=dtype)
        out[dtype] = JT.make_train_step(JaxModel(nc=12, scale="n"), None,
                                        jcfg, JaxLoss(nc=12, img_size=TS))
    return out


# the step's start: step 2 of the warmup with random momentum buffers
# (every leaf moves), or step 0 with none, as ``fit`` starts (only the bias
# group moves: the other groups' warmup lr is 0)
STARTS = {"step2": 2, "step0": 0}


@pytest.fixture(scope="module", params=sorted(STARTS))
def steps(request, jax_steps):
    """(start weights, {run: [(metrics, params, batch_stats) per batch]},
    the port's state after its step on the last batch, the start's name)."""
    step = STARTS[request.param]
    weights = TW.variables_from_checkpoint(CKPT)
    batches = [_batch(s) for s in SEEDS]
    rng = np.random.RandomState(5)
    mom = jax.tree.map(lambda a: (rng.randn(*a.shape) * 1e-3 * (step > 0)
                                  ).astype(np.float32), weights["params"])
    cfg = TrainConfig(tile_size=TS, batch_size=B, model_scale="n", epochs=3)
    assert cfg.compute_dtype == "bfloat16"
    sched = TT.make_sched_vector(cfg, 4)
    out = {run: [] for run in RUNS}
    with jax.enable_x64(False):
        for dtype, step_fn in jax_steps.items():
            for imgs, gl, gb, gm in batches:
                state = JT.TrainState(
                    step=jnp.asarray(step, jnp.int32),
                    params=jax.tree.map(jnp.asarray, weights["params"]),
                    batch_stats=jax.tree.map(jnp.asarray,
                                             weights["batch_stats"]),
                    opt_state=jax.tree.map(jnp.asarray, mom),
                    ema_params=jax.tree.map(jnp.array, weights["params"]),
                    sched=jnp.asarray(sched))
                new, metrics = step_fn(state, {
                    "images": jnp.asarray(imgs),
                    "gt_labels": jnp.asarray(gl),
                    "gt_xywhr": jnp.asarray(gb),
                    "gt_mask": jnp.asarray(gm)})
                new, metrics = jax.tree.map(np.asarray, (new, metrics))
                out[f"jax_{dtype}"].append(
                    (metrics, new.params, new.batch_stats))

    mt = TW.torch_state_from_jax({"params": mom})
    for imgs, gl, gb, gm in batches:
        st = TT.create_train_state(cfg, steps_per_epoch=4, device="cpu")
        TW.load_state(st.model, TW.torch_state_from_jax(weights))
        st.reset_ema()
        st.step = step
        if step:
            for n, p in st.model.named_parameters():
                st.opt.state[p]["momentum_buffer"] = torch.from_numpy(
                    mt[n].copy())
        metrics = TT.train_step(st, {
            "images": torch.from_numpy(imgs).permute(0, 3, 1, 2)
            .contiguous(), "gt_labels": torch.from_numpy(gl).long(),
            "gt_xywhr": torch.from_numpy(gb),
            "gt_mask": torch.from_numpy(gm)}, cfg).numpy()
        payload = TT.checkpoint_payload(st)
        out["port_bfloat16"].append((metrics, payload["params"],
                                     payload["batch_stats"]))
    return weights, out, st, request.param


def test_train_step_bf16_loss_within_jax_own_gap(steps):
    """The loss and its parts, root mean square over the four batches: the
    port's bf16 from the JAX float32 step within 1.25 times the JAX bf16
    step's distance from it (no worse an approximation), and from the JAX
    bf16 step within 1.5 times, or within 1e-2 relative (2.56 bf16
    epsilons) where that is larger."""
    _, out, _, start = steps
    m = {run: np.stack([r[0] for r in out[run]]) for run in RUNS}
    np.testing.assert_array_equal(m["port_bfloat16"][:, 4],
                                  m["jax_bfloat16"][:, 4])   # fg counts
    rms = lambda a: float(np.sqrt(np.mean(a ** 2)))
    for i, name in enumerate(TT.METRIC_KEYS[:4]):
        p, j16, j32 = (m[run][:, i] for run in RUNS)
        gap = rms(j16 - j32)
        floor = 1e-2 * float(np.abs(j32).mean())
        e32, e16 = rms(p - j32), rms(p - j16)
        print(f"{start} {name}: port-jax_f32 {e32:.3e}, port-jax_bf16 "
              f"{e16:.3e}, jax bf16-f32 {gap:.3e}, 1e-2 rel {floor:.3e}")
        assert e32 <= max(1.25 * gap, floor), name
        assert e16 <= max(1.5 * gap, floor), name


@pytest.mark.parametrize("tree", ["params", "batch_stats"])
def test_train_step_bf16_update_within_jax_own_gap(steps, tree):
    """Each leaf's update (after minus before), relative L2 error over the
    four batches. In aggregate: the median over the leaves of the port's
    error against the JAX float32 update, in units of the JAX bf16
    update's error, at most 1.25 (leaves whose JAX gap is below 1e-2
    leave it out). Each leaf: the port's error against the JAX bf16 update
    within 3 times the JAX gap, or 1e-2. Leaves that the float32 step does
    not move (step 0's decay groups) are left out. Printed besides: the
    median over the leaves of the JAX package's own gap, which
    ``chip_smoke.py`` holds the card's step to."""
    weights, out, _, name = steps
    idx = 1 if tree == "params" else 2
    start = dict(_leaves(weights[tree]))
    upd = {run: [{k: v - start[k] for k, v in _leaves(r[idx])}
                 for r in out[run]] for run in RUNS}

    def rel(a: str, b: str, leaf: str) -> float:
        num = sum(np.sum((x[leaf] - y[leaf]) ** 2)
                  for x, y in zip(upd[a], upd[b]))
        den = sum(np.sum(y[leaf] ** 2) for y in upd[b])
        return float(np.sqrt(num / max(den, 1e-60)))

    ratios, gaps, worst = [], [], (0.0, None)
    for leaf in start:
        if not any(u[leaf].any() for u in upd["jax_float32"]):
            continue
        gap = rel("jax_bfloat16", "jax_float32", leaf)
        gaps.append(gap)
        e32 = rel("port_bfloat16", "jax_float32", leaf)
        e16 = rel("port_bfloat16", "jax_bfloat16", leaf)
        if gap >= 1e-2:
            ratios.append(e32 / gap)
        bound = max(3 * gap, 1e-2)
        worst = max(worst, (e16 / bound, leaf))
        assert e16 <= bound, (leaf, e16, gap)
    median = float(np.median(ratios))
    print(f"{name} {tree}: {len(gaps)} leaves moved; JAX's own median gap "
          f"{np.median(gaps):.4f}; median port-vs-f32 / jax gap "
          f"{median:.3f} over {len(ratios)}; largest port-vs-bf16 / bound "
          f"{worst[0]:.3f} ({worst[1]})")
    assert len(ratios) > 50 and median <= 1.25


def test_train_step_bf16_keeps_float32_state(steps):
    """After a bf16 step: every parameter, gradient, momentum buffer, EMA
    leaf and BatchNorm statistic is float32."""
    st = steps[2]
    for n, p in st.model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, n
        assert st.opt.state[p]["momentum_buffer"].dtype == torch.float32, n
    assert {e.dtype for e in st.ema_tensors()} == {torch.float32}
    floats = [b for b in st.model.buffers() if b.is_floating_point()]
    assert floats and {b.dtype for b in floats} == {torch.float32}
