"""The port's OBB loss and task-aligned assigner against the JAX package's
on seeded random head outputs at tile 32 (n-scale head shapes): the total,
its components and the fg count, and the gradients with respect to every
raw output against ``jax.value_and_grad(obb_loss)``, within float32
reduction-order rounding (loss rtol 1e-5; gradients atol 1e-5 of the
largest gradient of the level); the same with no valid GT at all, where
both must stay finite; the assigner's targets exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from oriented_object_detection_tpu.train import assigner as JAS
from oriented_object_detection_tpu.train import loss as JL
from oriented_object_detection_tpu_torch.train import assigner as TAS
from oriented_object_detection_tpu_torch.train import loss as TL
from torch_parity import one_torch_thread  # noqa: F401

TS, B, M, NC = 32, 2, 8, 12
CH = {"box": 64, "cls": NC, "ang": 1}


def _inputs(seed, n_valid=(3, 5)):
    rng = np.random.RandomState(seed)
    sizes = [TS // 8, TS // 16, TS // 32]
    raw = {k: [(rng.randn(B, c, s, s) * 1.5).astype(np.float32)
               for s in sizes] for k, c in CH.items()}
    gl = rng.randint(0, NC, (B, M)).astype(np.int32)
    gm = np.zeros((B, M), bool)
    for b, n in enumerate(n_valid):
        gm[b, :n] = True
    gb = np.zeros((B, M, 5), np.float32)
    gb[..., :2] = rng.uniform(4, TS - 4, (B, M, 2))
    gb[..., 2] = rng.uniform(6, 20, (B, M))
    gb[..., 3] = rng.uniform(4, 12, (B, M))
    gb[..., 4] = rng.uniform(-1.5, 1.5, (B, M))
    return raw, gl, gb, gm


def _jax(raw, gl, gb, gm):
    cfg = JL.LossConfig(img_size=TS)
    jr = {k: [jnp.asarray(a.transpose(0, 2, 3, 1)) for a in v]
          for k, v in raw.items()}
    with jax.enable_x64(False):
        (total, parts), grads = jax.value_and_grad(
            lambda r: JL.obb_loss(r, jnp.asarray(gl), jnp.asarray(gb),
                                  jnp.asarray(gm), cfg), has_aux=True)(jr)
    return (float(total), {k: float(v) for k, v in parts.items()},
            {k: [np.asarray(g).transpose(0, 3, 1, 2) for g in v]
             for k, v in grads.items()})


def _port(raw, gl, gb, gm):
    tr = {k: [torch.tensor(a, requires_grad=True) for a in v]
          for k, v in raw.items()}
    total, parts = TL.obb_loss(tr, torch.from_numpy(gl).long(),
                               torch.from_numpy(gb), torch.from_numpy(gm),
                               TL.LossConfig(img_size=TS))
    total.backward()
    return (float(total), {k: float(v) for k, v in parts.items()},
            {k: [t.grad.numpy() for t in v] for k, v in tr.items()})


@pytest.mark.parametrize("seed,n_valid", [(0, (3, 5)), (1, (8, 1)),
                                          (2, (0, 0))],
                         ids=["fg", "full_and_single", "zero_fg"])
def test_loss_and_grads_match_jax(seed, n_valid):
    args = _inputs(seed, n_valid)
    jt, jp, jg = _jax(*args)
    tt, tp, tg = _port(*args)
    assert np.isfinite(tt) and np.isfinite(jt)
    np.testing.assert_allclose(tt, jt, rtol=1e-5)
    assert tp["fg_count"] == jp["fg_count"]
    if n_valid == (0, 0):
        assert tp["fg_count"] == 0 and tp["box"] == tp["dfl"] == 0.0
    else:
        assert tp["fg_count"] > 0
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5, atol=1e-7)
    for k in CH:
        for a, b in zip(tg[k], jg[k]):
            assert np.isfinite(a).all()
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-5 * max(np.abs(b).max(), 1e-3))


def test_assigner_targets_match_jax():
    rng = np.random.RandomState(3)
    A = 21
    anchors = rng.uniform(0, TS, (A, 2)).astype(np.float32)
    scores = rng.rand(B, A, NC).astype(np.float32)
    _, gl, gb, gm = _inputs(4, (4, 2))
    pd = np.concatenate([anchors[None].repeat(B, 0)
                         + rng.randn(B, A, 2).astype(np.float32),
                         rng.uniform(5, 15, (B, A, 2)).astype(np.float32),
                         rng.uniform(-1, 1, (B, A, 1)).astype(np.float32)],
                        -1)
    with jax.enable_x64(False):
        ref = JAS.assign(jnp.asarray(scores), jnp.asarray(pd),
                         jnp.asarray(anchors), jnp.asarray(gl),
                         jnp.asarray(gb), jnp.asarray(gm), topk=3, nc=NC)
        cand = JAS.candidates_in_rotated_gts(jnp.asarray(anchors),
                                             jnp.asarray(gb[0]))
    got = TAS.assign(*(torch.from_numpy(a) for a in
                       (scores, pd, anchors, gl, gb, gm)), topk=3, nc=NC)
    np.testing.assert_array_equal(
        TAS.candidates_in_rotated_gts(torch.from_numpy(anchors),
                                      torch.from_numpy(gb[0])).numpy(),
        np.asarray(cand))
    np.testing.assert_array_equal(got["fg"].numpy(), np.asarray(ref["fg"]))
    assert got["fg"].any()
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(ref["labels"]))
    np.testing.assert_array_equal(got["bboxes"].numpy(),
                                  np.asarray(ref["bboxes"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(ref["scores"]), rtol=1e-5,
                               atol=1e-7)


def test_bce_and_dfl_match_jax():
    rng = np.random.RandomState(5)
    x = (rng.randn(64) * 20).astype(np.float32)
    z = rng.rand(64).astype(np.float32)
    with jax.enable_x64(False):
        ref = np.asarray(optax.sigmoid_binary_cross_entropy(x, z))
        logits = (rng.randn(5, 4, 16) * 3).astype(np.float32)
        tgt = rng.uniform(0, 14.99, (5, 4)).astype(np.float32)
        dref = np.asarray(JL._dfl_loss(jnp.asarray(logits),
                                       jnp.asarray(tgt), 16))
    np.testing.assert_allclose(
        TL.sigmoid_bce(torch.from_numpy(x), torch.from_numpy(z)).numpy(),
        ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        TL._dfl_loss(torch.from_numpy(logits), torch.from_numpy(tgt),
                     16).numpy(), dref, rtol=1e-6)
