"""Helpers shared by the port's parity tests: the row comparison, a
fixture that runs a module's PyTorch work on one intra-op thread, the
float32 pin of the port's configs for the entry points that name no
dtype, and the seeded train batch of the step tests."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from oriented_object_detection_tpu_torch import config as C
from oriented_object_detection_tpu_torch.infer import pipeline as P


@dataclasses.dataclass(frozen=True)
class DetectConfig32(C.DetectConfig):
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainConfig32(C.TrainConfig):
    compute_dtype: str = "float32"


# every name through which an entry point builds a config with the default
# dtype: ``cli.py``'s commands import ``TrainConfig`` from ``config`` when
# they run, ``build_detector`` reads ``pipeline.DetectConfig``
_FLOAT32_NAMES = ((C, "DetectConfig", DetectConfig32),
                  (P, "DetectConfig", DetectConfig32),
                  (C, "TrainConfig", TrainConfig32))


@contextlib.contextmanager
def port_float32():
    """The port's configs default to ``compute_dtype="float32"`` inside the
    block: for a test that holds float32 equalities through ``cli.py``,
    which has no dtype flag (the JAX CLI has none either)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, cls in _FLOAT32_NAMES:
            mp.setattr(mod, name, cls)
        yield


def float32_cli_main() -> None:
    """``cli.main`` under ``port_float32``, for a test's CLI subprocess:
    ``python -c 'import torch_parity; torch_parity.float32_cli_main()'
    ARGS`` with ``tests/`` on ``PYTHONPATH``."""
    import sys

    from oriented_object_detection_tpu_torch import cli

    with port_float32():
        cli.main(sys.argv[1:])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: parallel test workers (six in
    the full run) share the cores, and their spinning thread pools slow
    each other down many times over (a 1 s CPU train step took 60 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def match_one_to_one(got, ref, skip_near=()):
    """Pair every [N, 11] row of ``got`` with one of ``ref``: same class,
    conf within 1e-3, corners within 0.05 px, Strike angle within 0.01
    degree. Rows whose conf lies within 1e-3 of a threshold in
    ``skip_near`` are left out on both sides: the consensus filter may
    keep or drop them on a last-bit difference."""
    def keep(rows):
        near = np.zeros(len(rows), bool)
        for t in skip_near:
            near |= np.abs(rows[:, 9] - t) < 1e-3
        return rows[~near]

    got, ref = keep(got), keep(ref)
    assert got.shape == ref.shape
    used = np.zeros(len(ref), bool)
    for r in got:
        ok = (~used & (ref[:, 8] == r[8]) & (np.abs(ref[:, 9] - r[9]) <= 1e-3)
              & (np.abs(ref[:, :8] - r[:8]).max(1) <= 0.05))
        assert ok.any(), f"no JAX partner for {r.tolist()}"
        used[np.flatnonzero(ok)[0]] = True
    np.testing.assert_allclose(got[:, 10], ref[:, 10], atol=1e-2)


def step_batch(seed: int = 1, ts: int = 64, b: int = 2, m: int = 16):
    """``b`` tiles of ``ts`` pixels of one seeded map (``gen_map``) with
    their boxes in pixels: (images [b, ts, ts, 3] float32 in [0, 1], labels
    [b, m], xywhr [b, m, 5], mask [b, m]), every tile with a box."""
    from oriented_object_detection_tpu_torch.ops import geometry as G
    from tools.train_synthetic import gen_map

    img, lab = gen_map(np.random.RandomState(seed), H=ts, W=ts * b, n_obj=8)
    imgs = np.stack([img[:, i * ts:(i + 1) * ts]
                     for i in range(b)]).astype(np.float32) / 255.0
    lab[:, 1::2] *= ts * b
    lab[:, 2::2] *= ts
    gl = np.zeros((b, m), np.int32)
    gm = np.zeros((b, m), bool)
    gb = np.zeros((b, m, 5), np.float32)
    for i in range(b):
        cx = lab[:, 1::2].mean(1)
        sel = lab[(cx >= i * ts) & (cx < (i + 1) * ts)]
        c8 = sel[:, 1:].copy()
        c8[:, 0::2] -= i * ts
        gl[i, :len(sel)] = sel[:, 0]
        gm[i, :len(sel)] = True
        gb[i, :len(sel)] = G.corners8_to_xywhr_np(c8)
    assert gm.sum(1).min() > 0
    return imgs, gl, gb, gm


def max_rel(a, b) -> float:
    """The largest |a - b| over the largest |a| (at least 1e-6)."""
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(a)).max(), 1e-6))


def tree_leaves(tree, prefix=()):
    """(path, numpy leaf) of a nested dict, depth first."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def assert_trees_close(got, ref, rtol):
    """Every leaf of ``ref`` (a numpy or JAX tree of more than 100 leaves)
    in ``got`` with its shape, within ``rtol`` of the leaf's largest
    value."""
    import jax

    n = 0
    for path, r in tree_leaves(jax.tree.map(np.asarray, ref)):
        g = tree_get(got, path)
        assert g.shape == r.shape, path
        assert max_rel(r, g) <= rtol, (path, max_rel(r, g))
        n += 1
    assert n > 100


def assert_trees_equal(a, b):
    for path, x in tree_leaves(a):
        np.testing.assert_array_equal(x, tree_get(b, path),
                                      err_msg=str(path))


def jax_global_step(weights: dict, mom: dict, batch: dict, step_cfg: dict,
                    step: int = 2):
    """The JAX package's one-process float32 train step (YOLO11n-OBB) on
    the whole ``batch`` (NCHW images, as the port's), from ``weights``,
    the momentum ``mom`` and ``step``, with the schedule of
    ``TrainConfig(**step_cfg)`` over 4 steps an epoch: (new state,
    metrics) as numpy."""
    import jax
    import jax.numpy as jnp

    from oriented_object_detection_tpu.config import TrainConfig as JaxCfg
    from oriented_object_detection_tpu.models import YOLO11OBB as JaxModel
    from oriented_object_detection_tpu.train import trainer as JT
    from oriented_object_detection_tpu.train.loss import (
        LossConfig as JaxLoss)
    from oriented_object_detection_tpu_torch.train import trainer as TT

    ts = step_cfg["tile_size"]
    jcfg = dataclasses.replace(JaxCfg(), tile_size=ts,
                               batch_size=step_cfg["batch_size"],
                               model_scale="n", compute_dtype="float32",
                               epochs=step_cfg["epochs"])
    sched = TT.make_sched_vector(C.TrainConfig(**step_cfg), 4)
    with jax.enable_x64(False):
        state = JT.TrainState(
            step=jnp.asarray(step, jnp.int32),
            params=jax.tree.map(jnp.asarray, weights["params"]),
            batch_stats=jax.tree.map(jnp.asarray, weights["batch_stats"]),
            opt_state=jax.tree.map(jnp.asarray, mom),
            ema_params=jax.tree.map(jnp.array, weights["params"]),
            sched=jnp.asarray(sched))
        step_fn = JT.make_train_step(JaxModel(nc=12, scale="n"), None, jcfg,
                                     JaxLoss(nc=12, img_size=ts))
        new, metrics = step_fn(state, {
            "images": jnp.asarray(batch["images"].transpose(0, 2, 3, 1)),
            "gt_labels": jnp.asarray(batch["gt_labels"].astype(np.int32)),
            "gt_xywhr": jnp.asarray(batch["gt_xywhr"]),
            "gt_mask": jnp.asarray(batch["gt_mask"])})
        return jax.tree.map(np.asarray, (new, metrics))
