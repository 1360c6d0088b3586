"""Rotated RTMDet in the port (``models/rtmdet_r.py``, the CSPNeXt blocks
of ``models/layers.py``, ``decode.decode_distance_angle``, its entry in
``models/archs.py``) against the benchmark's plain float32 reference
(``obbbench/reference/rtmdet_r.py``, mmdet's and mmrotate's modules), on
the CPU at scale "tiny" with 128-px tiles on the reference's seeded
weights: the parameter count, the float32 and bf16 forwards, the folded
forward at mmcv's eps, the in-place concatenations, the decode and the
input, the checkpoint keys and the architecture a checkpoint names, a
detector's rows against the reference's, the ``forward_depthwise`` span
and the ``CSPNEXT`` and ``STORES`` counters."""

import math
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from oriented_object_detection_tpu_torch.infer import pipeline as P
from oriented_object_detection_tpu_torch.models import archs as A
from oriented_object_detection_tpu_torch.models import decode as D
from oriented_object_detection_tpu_torch.models import layers as TL
from oriented_object_detection_tpu_torch.models.fold import fold_bn_state
from oriented_object_detection_tpu_torch.models.rtmdet_r import RTMDetR
from oriented_object_detection_tpu_torch.models.weights import (
    jax_trees_from_torch_state, load_state, torch_state_from_jax)
from oriented_object_detection_tpu_torch.ops import epilogue as EP
from oriented_object_detection_tpu_torch.utils import profiling as prof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
from obbbench.harness import compare  # noqa: E402
from obbbench.harness import synth  # noqa: E402
from obbbench.reference import detect as RD  # noqa: E402
from obbbench.reference import rtmdet_r as RR  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

TILE = 128
# the benchmark configuration's weight rule, calibrated at the test's tile
WEIGHTS = {"seed": 24, "bn_gain": 0.2, "bn_scale": 0.1, "bn_shift": 0.1,
           "bn_var": [0.8, 1.25], "reg_bias": 0.7, "cls_std": 1.0,
           "reg_std": 0.3, "ang_std": 0.5, "density": 0.01, "calib_seed": 7,
           "calib_images": 2, "calib_size": TILE}
# float32, the port against the reference: the same convolutions, summed
# in another order where the port's layout or threads differ, the channel
# attention's mean against AdaptiveAvgPool2d, and SPP's cascade of 5x5
# pools against pools of 5, 9 and 13 (exact); measured 1.1e-6 of the head
# outputs' largest value on two inputs (the fold 1.9e-6); about five times
F32_TOL = 1e-5
# bf16: the port's gap to the float32 reference against the reference's
# own bf16 rounding (conv inputs, weights and outputs rounded); the port
# also rounds every activation between the convolutions (the folded bias
# and SiLU, the residual sums, the attention's product), measured at 1.5
# and 1.8 times the reference's gap on two inputs; three times
BF16_FACTOR = 3.0


@pytest.fixture(scope="module")
def seeded():
    """(reference state, input of two calibration-like maps)."""
    state = RR.make_state("tiny", 12, WEIGHTS)
    x = RR.calib_input({**WEIGHTS, "calib_seed": 8})
    return state, x


def port_model(state, fused=False, eps=RR.BN_EPS):
    model = RTMDetR(nc=12, scale="tiny", fused_bn=fused)
    load_state(model, fold_bn_state(state, eps) if fused else state)
    return model.eval()


def head_outputs(out: dict) -> torch.Tensor:
    return torch.cat([D.flatten_levels(out[k]) for k in ("cls", "reg",
                                                         "ang")], -1)


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("nc, count", [(12, 52_264_147), (15, 52_266_460)])
def test_parameter_count_is_mmrotates_at_l(nc, count):
    """52,266,460 at DOTA's 15 classes (mmrotate's 52.27M), the head's
    shared convs counted once; the state dict lists the reference's keys,
    mmrotate's, in its order."""
    with torch.device("meta"):
        model = RTMDetR(nc=nc, scale="l")
        ref = RR.RTMDetR(nc=nc, scale="l")
    assert sum(p.numel() for p in model.parameters()) == count
    assert list(model.state_dict()) == list(ref.state_dict())
    assert "bbox_head.cls_convs.2.1.bn.weight" in model.state_dict()


def test_four_channels_raise():
    with pytest.raises(ValueError, match="3-channel"):
        RTMDetR(nc=12, scale="tiny", in_channels=4)


def test_float32_forward_matches_the_reference(seeded):
    state, x = seeded
    with torch.no_grad():
        got = head_outputs(port_model(state)(x))
        want = head_outputs(RR.build(state, "tiny").eval()(x))
    assert rel_gap(got, want) < F32_TOL


def test_bf16_forward_within_the_references_bf16_gap(seeded):
    state, x = seeded
    ref = RR.build(state, "tiny").eval()
    with torch.no_grad():
        want = head_outputs(ref(x))
        ref_gap = rel_gap(head_outputs(ref.set_precision("bf16")(x)), want)
        got = head_outputs(port_model(state, fused=True).to(
            torch.bfloat16)(x.to(torch.bfloat16))).float()
    assert torch.isfinite(got).all()
    assert rel_gap(got, want) < BF16_FACTOR * ref_gap


@pytest.mark.parametrize("eps, same", [(1e-5, True), (1e-3, False)],
                         ids=["mmcv_eps", "ultralytics_eps"])
def test_folded_forward_at_mmcvs_eps_equals_the_unfolded(seeded, eps, same):
    """Folded at 1e-5 the forward is the unfolded one's; folded at
    YOLO's 1e-3 it is not. Each level's head kernel differs after the
    fold, by its own BatchNorm."""
    state, x = seeded
    with torch.no_grad():
        got = head_outputs(port_model(state, fused=True, eps=eps)(x))
        want = head_outputs(port_model(state)(x))
    assert (rel_gap(got, want) < F32_TOL) is same
    folded = fold_bn_state(state, eps)
    k = "bbox_head.reg_convs.{}.0.conv.weight"
    assert np.array_equal(state[k.format(0)], state[k.format(2)])
    assert not np.array_equal(folded[k.format(0)], folded[k.format(2)])


@pytest.mark.parametrize("layout", [torch.contiguous_format,
                                    torch.channels_last],
                         ids=["nchw", "channels_last"])
def test_in_place_forward_is_the_cat_form(seeded, layout):
    """The fused bf16 forward, whose CSPLayers store the last block's and
    ``short_conv``'s outputs into their concatenation with the blocks'
    identity folded in, bit-equal to every block's ``forward_plain``; and
    the layout kept to the head's outputs."""
    state, x = seeded
    model = port_model(state, fused=True).to(torch.bfloat16,
                                             memory_format=layout)
    x = x.to(torch.bfloat16, memory_format=layout)
    blocks = (TL.CSPNeXtBlock, TL.CSPLayer)
    with torch.no_grad():
        got = model(x)
        saved = {cls: cls.forward for cls in blocks}
        for cls in blocks:
            cls.forward = cls.forward_plain
        try:
            want = model(x)
        finally:
            for cls, fn in saved.items():
                cls.forward = fn
    for k in want:
        for a, b in zip(got[k], want[k]):
            assert torch.equal(a, b), k
    assert got["cls"][0].is_contiguous(memory_format=layout)


def raw_outputs(gen, n=2):
    """Raw head outputs of a 128 tile: distances of a few strides, angles
    over [-4, 4] rad, so le90 wraps some of them."""
    sizes = [TILE // s for s in RR.STRIDES]
    mk = lambda c, lo, hi: [lo + (hi - lo) * torch.rand(
        n, c, s, s, generator=gen) for s in sizes]
    return {"cls": mk(12, -6.0, 2.0), "reg": mk(4, -0.5, 1.5),
            "ang": mk(1, -4.0, 4.0)}


@pytest.mark.parametrize("fault", [None, "anchors_at_half", "no_le90"])
def test_decode_against_the_references(fault, monkeypatch):
    """Boxes within 1e-3 px and the le90 angle in [-pi/2, pi/2) as
    mmrotate's ``distance2obb`` gives them, and scores equal; anchors at
    0.5 of a cell, or the angle left raw, do not match."""
    out = raw_outputs(torch.Generator().manual_seed(3))
    if fault == "anchors_at_half":
        inner = D.make_anchors
        monkeypatch.setattr(D, "make_anchors", lambda s, d, offset: inner(
            s, d, 0.5))
    rbox, scores = D.decode_distance_angle(out, TILE)
    if fault == "no_le90":
        rbox = torch.cat([rbox[..., :4], D.flatten_levels(out["ang"])], -1)
    want_rbox, want_scores = RR.decode(out, TILE)
    assert torch.equal(scores, want_scores)
    same = torch.allclose(rbox, want_rbox, rtol=0, atol=1e-3)
    assert same is (fault is None)
    if fault is None:
        assert float(rbox[..., 4].min()) >= -math.pi / 2
        assert float(rbox[..., 4].max()) < math.pi / 2


@pytest.mark.parametrize("flip", [False, True], ids=["bgr", "rgb_flipped"])
def test_input_is_bgr_less_the_mean_over_the_std(flip):
    """The architecture's tile input equals the reference's, mmdet's
    preprocessor with ``bgr_to_rgb=False``, to the float32 rounding; an
    RGB-flipped input does not."""
    tiles = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(5))
    arch = A.arch("rtmdet_r")
    got = arch.normalise(arch.pixels(tiles.flip(-1) if flip else tiles, 3))
    want = RR.reference_input(tiles)
    assert torch.allclose(got, want, rtol=0, atol=1e-6) is not flip
    assert arch.bn_eps == 1e-5 and A.arch("yolo12").bn_eps == 1e-3
    with pytest.raises(ValueError):
        arch.pixels(tiles, 4)


def test_checkpoint_keys_round_trip_and_arch_picks_the_class(seeded,
                                                              tmp_path):
    """Every mmrotate key to the flax trees and back, with the
    reference's writer naming every leaf alike; a written checkpoint's
    ``extra["arch"]`` builds ``RTMDetR`` at the recorded scale."""
    state, _ = seeded
    trees = jax_trees_from_torch_state(state)
    assert "depthwise_conv" in trees["params"]["backbone"]["stage1"]["1"][
        "blocks"]["0"]["conv2"]
    back = torch_state_from_jax(trees)
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert np.array_equal(back[k], v), k
    ref_trees = RR.to_trees(state)
    for coll in ("params", "batch_stats"):
        assert leaf_paths(trees[coll]) == leaf_paths(ref_trees[coll])
    cfg = {"model_scale": "tiny", "nc": 12, "weights": WEIGHTS}
    path = RR.checkpoint(cfg, str(tmp_path))
    det = P.build_detector([(TILE, 30, path)], channels=3, model_scale="x",
                           device="cpu", compute_dtype="float32")
    assert det.cfg.scales[0].arch == "rtmdet_r"
    assert det.cfg.scales[0].model_scale == "tiny"
    assert isinstance(det.models[TILE], RTMDetR)


def leaf_paths(tree: dict, prefix: tuple = ()) -> set:
    out = set()
    for k, v in tree.items():
        out |= (leaf_paths(v, prefix + (k,)) if isinstance(v, dict)
                else {prefix + (k,)})
    return out


def test_detector_rows_pair_with_the_reference(tmp_path):
    """``build_detector`` -> ``detect_images`` in float32 over a 320 x 300
    map against ``reference/detect.py::detect_map`` through the
    architecture's input and decode: every strong row paired both ways,
    the confidences within 1e-4."""
    cfg = {"model_scale": "tiny", "nc": 12, "weights": WEIGHTS,
           "scales": [{"tile_size": TILE, "overlap": 30}],
           "conf_thr": 0.001, "engine_nms_iou": 0.7, "merge_iou": 0.4,
           "max_det_per_tile": 64, "pre_topk": 256,
           "apply_border_filter": True, "margin_128": 10, "margin_416": 20}
    path = RR.checkpoint(cfg, str(tmp_path))
    det = P.build_detector([(TILE, 30, path)], channels=3, device="cpu",
                           compute_dtype="float32", calculate_metrics=True,
                           max_det_per_tile=64, pre_topk=256)
    image = synth.synthetic_map(2 ** 31 + 5, 0, 320, 300,
                                torch.device("cpu"))[0]
    got = det.detect_images([image])[0]
    ref = RD.detect_map(RR.load_models(cfg, str(tmp_path), "cpu"), image,
                        cfg, "cpu", compare.WEAK,
                        reference_input=RR.reference_input,
                        reference_decode=RR.decode)
    readings = compare.detection_readings([got], [ref])
    assert readings["strong_rows"] > 20
    assert readings["unpaired_share"] == 0.0
    assert readings["conf_gap_mean"] < 1e-4


def test_cspnext_counts_and_stores_a_1024_tile_at_l():
    """30 CSPNeXt blocks, 30 depthwise ConvBNs and 4 channel attentions a
    1024 tile at l, on the meta device; fused (on the CPU, at 64 px), the
    8 CSPLayers store 2 parts each into their concatenations and the 15
    blocks with an identity (stages 1 to 3) fold it into their
    epilogue."""
    with torch.device("meta"):
        model = RTMDetR(nc=12, scale="l")
        x = torch.zeros(1, 3, 1024, 1024)
    before = dict(TL.CSPNEXT)
    with torch.no_grad():
        model(x)
    assert {k: TL.CSPNEXT[k] - before[k] for k in before} == {
        "blocks": 30, "depthwise": 30, "channel_attn": 4, "tiles": 1}
    fused = RTMDetR(nc=12, scale="l", fused_bn=True).eval()
    EP.STORES.update(concat_parts=0, residual_folds=0)
    with torch.no_grad():
        fused(torch.zeros(1, 3, 64, 64))
    assert EP.STORES == {"concat_parts": 16, "residual_folds": 15}


def test_forward_depthwise_span_under_the_profiler(seeded):
    """One ``forward_depthwise`` span a CSPNeXt block, each holding its
    depthwise convolution and nothing else of the forward's convs."""
    state, x = seeded
    model = port_model(state, fused=True)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as p:
        model(x[:1])
    name = prof.SPAN_PREFIX + "forward_depthwise"
    spans = [e for e in p.events() if e.name == name]
    n_blocks = sum(isinstance(m, TL.CSPNeXtBlock) for m in model.modules())
    assert len(spans) == n_blocks == 8
    convs = [e for e in p.events() if e.name == "aten::conv2d"]
    inside = [e for e in convs if any(
        s.time_range.start <= e.time_range.start <= s.time_range.end
        for s in spans)]
    assert len(inside) == n_blocks
    assert len(convs) == sum(isinstance(m, torch.nn.Conv2d)
                             for m in model.modules())
