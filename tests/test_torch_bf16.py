"""bf16, the default compute dtype of the port as of the JAX package: the
configs, the dtype of every module's output at flax's cast points (exact),
the entry points (``cli.py detect`` in bf16, ``val`` and the density
calibration in float32), and the whole YOLO11n-OBB forward against the JAX
package's bf16 and float32, held to the JAX package's own
bf16-versus-float32 gap on the same input."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from oriented_object_detection_tpu.models import YOLO11OBB as JaxYOLO
from oriented_object_detection_tpu.models.fold import fold_bn_variables
from oriented_object_detection_tpu.train.trainer import (
    variables_from_checkpoint as jax_variables)
from oriented_object_detection_tpu_torch import cli
from oriented_object_detection_tpu_torch.config import (
    PRESETS, DetectConfig, TrainConfig, torch_dtype)
from oriented_object_detection_tpu_torch.data import labels as TLB
from oriented_object_detection_tpu_torch.eval import val as TV
from oriented_object_detection_tpu_torch.infer import pipeline as P
from oriented_object_detection_tpu_torch.models import calibrate as TC
from oriented_object_detection_tpu_torch.models import decode as D
from oriented_object_detection_tpu_torch.models import layers as TL
from oriented_object_detection_tpu_torch.models import weights as W
from oriented_object_detection_tpu_torch.models.fold import fold_bn_state
from oriented_object_detection_tpu_torch.models.yolo11_obb import YOLO11OBB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT4 = os.path.join(REPO, "assets", "bench_ckpts", "train416_4ch.ckpt")
CKPT3 = os.path.join(REPO, "assets", "bench_ckpts", "train128.ckpt")
sys.path.insert(0, REPO)
from tools.train_synthetic import gen_map  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

KINDS = (TL.ConvBN, TL.Conv2d, TL.Attention, TL.C3k2, TL.SPPF, TL.C2PSA)


def test_configs_default_to_bf16_and_refuse_other_dtypes():
    assert DetectConfig().compute_dtype == TrainConfig().compute_dtype \
        == "bfloat16"
    assert {c.compute_dtype for c in PRESETS.values()} == {"bfloat16"}
    assert torch_dtype("bfloat16") is torch.bfloat16
    assert torch_dtype("float32") is torch.float32
    for make in (lambda: DetectConfig(compute_dtype="float16"),
                 lambda: TrainConfig(compute_dtype="float16"),
                 lambda: dataclasses.replace(PRESETS["detect_dual"],
                                             compute_dtype="bf16")):
        with pytest.raises(ValueError, match="compute_dtype"):
            make()


class _Calls(TorchFunctionMode):
    """Records the output dtype of every ``torch.matmul`` and softmax."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.matmul, torch.Tensor.softmax):
            self.seen.append((func.__name__, out.dtype))
        return out


def _model(fused: bool) -> YOLO11OBB:
    state = W.torch_state_from_jax(W.variables_from_checkpoint(CKPT4))
    model = YOLO11OBB(nc=12, scale="n", in_channels=4, fused_bn=fused)
    W.load_state(model, fold_bn_state(state) if fused else state)
    return model


@pytest.mark.parametrize("mode", ["folded", "eval", "train"])
def test_module_outputs_are_bf16_at_flax_cast_points(mode):
    """Every ConvBN, head conv, Attention, C3k2, SPPF and C2PSA output is
    bf16; the attention logits and softmax are float32 and its product
    with v bf16; ``decode_raw`` returns float32; the parameters and
    statistics stay float32."""
    model = _model(mode == "folded").train(mode == "train")
    seen = {}
    hooks = [m.register_forward_hook(
        lambda m, i, o: seen.setdefault(type(m).__name__, set()).add(
            o.dtype)) for m in model.modules() if isinstance(m, KINDS)]
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 4, 64, 64)
                         .astype(np.float32)).bfloat16()
    calls = _Calls()
    with torch.set_grad_enabled(mode == "train"), calls:
        out = model(x)
    for h in hooks:
        h.remove()
    assert seen == {k.__name__: {torch.bfloat16} for k in KINDS}
    assert calls.seen == [("matmul", torch.float32),
                          ("softmax", torch.float32),
                          ("matmul", torch.bfloat16)]
    assert {o.dtype for v in out.values() for o in v} == {torch.bfloat16}
    rbox, scores = D.decode_raw(out, 64)
    assert rbox.dtype == scores.dtype == torch.float32
    assert {t.dtype for t in model.state_dict().values()
            if t.is_floating_point()} == {torch.float32}


def test_detector_keeps_bf16_folded_weights():
    """The detector at the default dtype holds its folded weights in bf16
    (flax casts the float32 ones at every apply, to the same values) and
    detects."""
    det = P.build_detector([(416, 100, CKPT4)], channels=4, device="cpu")
    ref = fold_bn_state(W.torch_state_from_jax(
        W.variables_from_checkpoint(CKPT4)))
    model = det.models[416]
    for k, t in model.state_dict().items():
        if t.is_floating_point():
            assert t.dtype == torch.bfloat16, k
            assert torch.equal(t, torch.from_numpy(ref[k]).bfloat16()), k
    img = gen_map(np.random.RandomState(2), H=300, W=260, n_obj=10)[0]
    rows = det.detect_image(img)["merged_for_pr"]
    assert len(rows) and np.isfinite(rows).all()


def test_calibration_and_validation_run_float32(tmp_path, monkeypatch):
    """``calibrate_density`` and ``validate_tiles`` (through ``cli.py
    val``, whose config is the bf16 default) compute in float32, as the
    JAX package's do."""
    seen = []
    model = YOLO11OBB(nc=12, scale="n")
    model.register_forward_hook(
        lambda m, i, o: seen.append(o["cls"][0].dtype))
    TC.calibrate_density(model, W.variables_from_checkpoint(CKPT3), 128, 3,
                         device="cpu")
    assert seen == [torch.float32]

    cv2 = pytest.importorskip("cv2")
    img, lab = gen_map(np.random.RandomState(4), H=128, W=128, n_obj=5)
    os.makedirs(tmp_path / "images" / "val")
    os.makedirs(tmp_path / "labels" / "val")
    cv2.imwrite(str(tmp_path / "images" / "val" / "t0.png"), img)
    TLB.write_labels(str(tmp_path / "labels" / "val" / "t0.txt"), lab)
    (tmp_path / "val.txt").write_text(
        str(tmp_path / "images" / "val" / "t0.png") + "\n")
    val = TV.validate_tiles

    def spy(model, val_ds, cfg, *a, **k):
        assert cfg.compute_dtype == "bfloat16"
        h = model.register_forward_hook(
            lambda m, i, o: seen.append(o["cls"][0].dtype))
        try:
            return val(model, val_ds, cfg, *a, **k)
        finally:
            h.remove()

    monkeypatch.setattr(TV, "validate_tiles", spy)
    seen.clear()
    cli.main(["val", "--ckpt", CKPT3, "--val-list",
              str(tmp_path / "val.txt"), "--device", "cpu"])
    assert seen == [torch.float32]


def test_cli_detect_computes_bf16(tmp_path, monkeypatch):
    """``cli.py detect`` with no dtype setting builds bf16 models, whose
    head outputs are bf16, and writes its outputs."""
    cv2 = pytest.importorskip("cv2")
    (tmp_path / "in").mkdir()
    cv2.imwrite(str(tmp_path / "in" / "m.png"),
                gen_map(np.random.RandomState(5), H=200, W=180, n_obj=6)[0])
    built, seen = [], set()
    build = P.build_detector

    def spy(*a, **k):
        det = build(*a, **k)
        for m in det.models.values():
            m.register_forward_hook(lambda m, i, o: seen.add(
                o["cls"][0].dtype))
        built.append(det)
        return det

    monkeypatch.setattr(P, "build_detector", spy)
    cli.main(["detect", "--input", str(tmp_path / "in"), "--output",
              str(tmp_path / "out"), "--ckpt128", CKPT3, "--scale", "n",
              "--device", "cpu"])
    (det,) = built
    assert det.cfg.compute_dtype == "bfloat16" and det.dtype is \
        torch.bfloat16
    assert {p.dtype for m in det.models.values()
            for p in m.parameters()} == {torch.bfloat16}
    assert seen == {torch.bfloat16}
    assert (tmp_path / "out" / "m.xlsx").exists()


# -- the whole forward against the JAX package ------------------------------

CASES = {"4ch_folded": (CKPT4, 4, True), "3ch": (CKPT3, 3, False)}


@pytest.fixture(scope="module", params=sorted(CASES))
def forward(request):
    """Head outputs (NCHW float32 numpy) of one seeded input [2, 128, 160]
    through the JAX package in bf16 and float32 and the port in bf16 and
    float32."""
    ckpt, ch, fused = CASES[request.param]
    x = np.random.RandomState(0).rand(2, 128, 160, ch).astype(np.float32)
    jv = jax_variables(ckpt)
    state = W.torch_state_from_jax(W.variables_from_checkpoint(ckpt))
    if fused:
        jv, state = fold_bn_variables(jv), fold_bn_state(state)
    jm = JaxYOLO(nc=12, scale="n", in_channels=ch, fused_bn=fused)
    out = {}
    with jax.enable_x64(False):
        for dtype in (jnp.bfloat16, jnp.float32):
            o = jax.jit(jm.apply)(jv, jnp.asarray(x, dtype))
            out[f"jax_{dtype.__name__}"] = {k: [np.asarray(
                jnp.asarray(a, jnp.float32)).transpose(0, 3, 1, 2)
                for a in v] for k, v in o.items()}
    model = YOLO11OBB(nc=12, scale="n", in_channels=ch, fused_bn=fused)
    W.load_state(model, state)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            o = model.eval()(xt.to(dtype))
            out[f"port_{str(dtype)[6:]}"] = {
                k: [a.float().numpy() for a in v] for k, v in o.items()}
    return request.param, out


def test_forward_bf16_within_jax_own_gap(forward):
    """For every head output, with g = mean|jax_bf16 - jax_f32|:
    mean|port_bf16 - jax_f32| <= 1.25 g (no worse an approximation of the
    network than the JAX package's own bf16), mean|port_bf16 - jax_bf16|
    <= 1.5 g, and port_bf16 differs from port_f32 (it computed in bf16)."""
    name, out = forward
    for key in ("box", "cls", "ang"):
        for lvl in range(3):
            j16, j32, p16, p32 = (out[r][key][lvl] for r in (
                "jax_bfloat16", "jax_float32", "port_bfloat16",
                "port_float32"))
            g = np.abs(j16 - j32).mean()
            e32, e16 = np.abs(p16 - j32).mean(), np.abs(p16 - j16).mean()
            print(f"{name} {key}{lvl}: g {g:.3e}, port_bf16-jax_f32 "
                  f"{e32:.3e} ({e32 / g:.3f} g), port_bf16-jax_bf16 "
                  f"{e16:.3e} ({e16 / g:.3f} g)")
            assert e32 <= 1.25 * g and e16 <= 1.5 * g, (key, lvl)
            assert not np.array_equal(p16, p32)
