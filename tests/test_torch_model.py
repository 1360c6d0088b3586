"""The port's YOLO11n-OBB (models/) against the JAX package's on the
committed 4-channel checkpoint: weight conversion, BN folding and the raw
per-level head outputs, unfolded and folded."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oriented_object_detection_tpu.models import YOLO11OBB as JaxYOLO
from oriented_object_detection_tpu.models.fold import fold_bn_variables
from oriented_object_detection_tpu.models.weights import export_state_dict
from oriented_object_detection_tpu.train.trainer import (
    variables_from_checkpoint as jax_variables)
from oriented_object_detection_tpu_torch.models import weights as W
from oriented_object_detection_tpu_torch.models.fold import fold_bn_state
from oriented_object_detection_tpu_torch.models.yolo11_obb import YOLO11OBB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "bench_ckpts", "train416_4ch.ckpt")


@pytest.fixture(scope="module")
def variables():
    return W.variables_from_checkpoint(CKPT)


def test_checkpoint_loads_as_fp32_like_jax(variables):
    ref = jax_variables(CKPT)
    a = W.torch_state_from_jax(variables)
    b = W.torch_state_from_jax(ref)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])


def test_state_keys_match_engine_manifest_and_jax_export(variables):
    state = W.torch_state_from_jax(variables)
    manifest = json.load(open(os.path.join(
        REPO, "oriented_object_detection_tpu", "models",
        "engine_manifest.json")))["yolo11n-obb-4ch"]
    model_sd = YOLO11OBB(nc=12, scale="n", in_channels=4).state_dict()
    # ultralytics' DFL holds a fixed arange conv; the port takes the
    # expectation in decode.py instead
    expect = {k: tuple(v) for k, v in manifest.items()
              if not k.endswith("num_batches_tracked")
              and k != "model.23.dfl.conv.weight"}
    assert {k: tuple(v.shape) for k, v in state.items()} == expect
    assert {k: tuple(v.shape) for k, v in model_sd.items()
            if not k.endswith("num_batches_tracked")} == expect
    exported = export_state_dict(variables)
    assert exported.keys() == state.keys()
    for k in state:
        np.testing.assert_array_equal(state[k], exported[k])


def test_parameter_count(variables):
    m = YOLO11OBB(nc=12, scale="n", in_channels=4)
    W.load_state(m, W.torch_state_from_jax(variables))
    assert sum(p.numel() for p in m.parameters()) == 2_663_975


def test_fold_bit_equal_to_jax_fold(variables):
    a = fold_bn_state(W.torch_state_from_jax(variables))
    b = W.torch_state_from_jax(fold_bn_variables(jax_variables(CKPT)))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_load_state_refuses_missing_keys(variables):
    state = W.torch_state_from_jax(variables)
    state.pop("model.0.conv.weight")
    with pytest.raises(KeyError, match="model.0.conv.weight"):
        W.load_state(YOLO11OBB(nc=12, scale="n", in_channels=4), state)


@pytest.mark.parametrize("fused", [False, True], ids=["unfolded", "folded"])
def test_raw_head_outputs_match_jax(variables, fused):
    rng = np.random.RandomState(0)
    x = rng.rand(2, 128, 160, 4).astype(np.float32)
    jv = jax_variables(CKPT)
    if fused:
        jv = fold_bn_variables(jv)
    ref = JaxYOLO(nc=12, scale="n", in_channels=4, fused_bn=fused).apply(
        jv, jnp.asarray(x))
    state = W.torch_state_from_jax(variables)
    if fused:
        state = fold_bn_state(state)
    model = YOLO11OBB(nc=12, scale="n", in_channels=4, fused_bn=fused)
    W.load_state(model, state)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for key in ("box", "cls", "ang"):
        assert len(out[key]) == 3
        for a, b in zip(ref[key], out[key]):
            np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(a), rtol=1e-3, atol=1e-3)
