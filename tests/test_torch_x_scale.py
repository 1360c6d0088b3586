"""The committed int8 YOLO11x-OBB checkpoints (``train128_x.ckpt``,
``train416_x.ckpt``) in the port against the JAX package: the dequant of
each int8 leaf by its ``q_scales`` vector, its refusals, and the folded
x-scale forward of one 128 tile."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oriented_object_detection_tpu.models import YOLO11OBB as JaxYOLO
from oriented_object_detection_tpu.models.fold import fold_bn_variables
from oriented_object_detection_tpu.train.trainer import (
    load_checkpoint as jax_load_checkpoint)
from oriented_object_detection_tpu.train.trainer import (
    variables_from_checkpoint as jax_variables)
from oriented_object_detection_tpu_torch.models import weights as W
from oriented_object_detection_tpu_torch.models.fold import fold_bn_state
from oriented_object_detection_tpu_torch.models.yolo11_obb import YOLO11OBB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {ts: os.path.join(REPO, "assets", "bench_ckpts", f"train{ts}_x.ckpt")
         for ts in (128, 416)}


@pytest.mark.parametrize("ts", [128, 416])
def test_int8_dequant_equals_jax(ts):
    got = W.load_checkpoint(CKPTS[ts])
    ref = jax_load_checkpoint(CKPTS[ts])
    assert "q_scales" not in got and "q_scales" not in ref
    for tree in ("params", "batch_stats"):
        a = jax.tree_util.tree_flatten_with_path(got[tree])[0]
        b = jax.tree_util.tree_flatten_with_path(ref[tree])[0]
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            assert x.dtype == y.dtype == np.float32, path
            np.testing.assert_array_equal(x, y)
    assert got["extra"]["model_scale"] == "x"
    assert got["extra"]["channels"] == 3


def _with_q_scales(tmp_path, edit):
    with open(CKPTS[128], "rb") as f:
        ck = pickle.load(f)
    edit(ck["q_scales"])
    path = tmp_path / "edited.ckpt"
    with open(path, "wb") as f:
        pickle.dump(ck, f)
    return str(path)


@pytest.mark.parametrize("edit, match", [
    (lambda q: q.update({"['l1']['conv']['kernal']": q["['l1']['conv']"
                                                       "['kernel']"]}),
     "match no parameter"),
    (lambda q: q.pop("['l1']['conv']['kernel']"), "has no q_scales entry"),
], ids=["stray_key", "missing_key"])
def test_int8_dequant_refuses_unmatched_scales(tmp_path, edit, match):
    with pytest.raises(ValueError, match=match):
        W.load_checkpoint(_with_q_scales(tmp_path, edit))


def test_x_scale_folded_forward_matches_jax():
    """One 128 tile through the folded YOLO11x-OBB of ``train128_x.ckpt``."""
    x = np.random.RandomState(0).rand(1, 128, 128, 3).astype(np.float32)
    jv = fold_bn_variables(jax_variables(CKPTS[128]))
    ref = jax.jit(JaxYOLO(nc=12, scale="x", in_channels=3,
                          fused_bn=True).apply)(jv, jnp.asarray(x))
    model = YOLO11OBB(nc=12, scale="x", in_channels=3, fused_bn=True)
    W.load_state(model, fold_bn_state(W.torch_state_from_jax(
        W.variables_from_checkpoint(CKPTS[128]))))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for key in ("box", "cls", "ang"):
        for a, b in zip(ref[key], out[key]):
            np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(a), rtol=1e-3, atol=1e-3)
