"""YOLO12-OBB in the port (``models/yolo12_obb.py``, the area-attention
blocks of ``models/layers.py``) against the benchmark's plain float32
reference (``obbbench/reference/yolo12.py``, an explicit softmax a head and
area), on the CPU at a 128-px input on the reference's seeded weights: the
float32 and bf16 forwards, the parameter count, the folded forward, the
checkpoint keys both ways, the architecture a checkpoint names, the
``AREA_ATTN`` counter and the ``forward_area_attn`` span."""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from oriented_object_detection_tpu_torch.infer import pipeline as P
from oriented_object_detection_tpu_torch.models import layers as TL
from oriented_object_detection_tpu_torch.models.calibrate import (
    calibrate_density)
from oriented_object_detection_tpu_torch.models.fold import fold_bn_state
from oriented_object_detection_tpu_torch.models.weights import (
    jax_trees_from_torch_state, load_state, torch_state_from_jax)
from oriented_object_detection_tpu_torch.models.yolo11_obb import YOLO11OBB
from oriented_object_detection_tpu_torch.models.yolo12_obb import YOLO12OBB
from oriented_object_detection_tpu_torch.utils import profiling as prof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
from obbbench.reference import model as RM  # noqa: E402
from obbbench.reference import yolo12 as RY  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

CKPT128 = os.path.join(REPO, "assets", "bench_ckpts", "train128.ckpt")
TILE = 128
# the benchmark configuration's weight rule, calibrated at the test's size
WEIGHTS = {"seed": 18, "bn_gain": 0.2, "bn_scale": 0.1, "bn_shift": 0.1,
           "bn_var": [0.8, 1.25], "qk_scale": 20.0, "gamma": 0.9,
           "density": 0.01, "calib_seed": 7, "calib_images": 2,
           "calib_size": TILE}
# float32, the port against the reference: the same products summed in
# another order (the reference's explicit softmax and matmuls against
# scaled_dot_product_attention, strided views against reshaped copies),
# measured 1e-6 of the head outputs' largest value; ten times that
F32_TOL = 1e-5
# bf16: the port's gap to the float32 reference against the reference's
# own bf16 rounding (conv inputs, outputs and attention products rounded)
# on the same input; the port also rounds every activation between the
# convolutions (the folded bias and SiLU, the residual sums, gamma, the
# head's outputs), measured at 1.6-2.7 times the reference's gap on two
# inputs at n and x; four times
BF16_FACTOR = 4.0


def head_outputs(out: dict) -> torch.Tensor:
    return torch.cat([RM.flatten_levels(out[k]) for k in ("box", "cls",
                                                          "ang")], -1)


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module", params=["n", "x"])
def seeded(request):
    """(scale, reference state, input) for a seeded YOLO12 at ``scale``."""
    scale = request.param
    state = RY.make_state(scale, 12, 3, WEIGHTS)
    return scale, state, RY.calib_images(3, {**WEIGHTS, "calib_seed": 8,
                                             "calib_images": 1})


def port_model(scale, state, fused=False):
    model = YOLO12OBB(nc=12, scale=scale, fused_bn=fused)
    load_state(model, fold_bn_state(state) if fused else state)
    return model.eval()


def test_parameter_count_is_ultralytics_at_x():
    model = YOLO12OBB(nc=12, scale="x")
    count = lambda m: sum(p.numel() for p in m.parameters())
    assert count(model) == 61_041_383
    assert {k: count(model.model[k]) for k in ("6", "8", "11", "14", "17",
                                               "20", "21")} == {
        "6": 9_512_128, "8": 9_512_128, "11": 4_727_040, "14": 1_331_328,
        "17": 4_579_584, "20": 5_612_544, "21": 5_068_551}
    ref = RY.YOLO12OBB(nc=12, scale="x")
    assert list(model.state_dict()) == list(ref.state_dict())


def test_float32_forward_matches_the_reference(seeded):
    scale, state, x = seeded
    with torch.no_grad():
        got = head_outputs(port_model(scale, state)(x))
        want = head_outputs(RY.build(state, scale).eval()(x))
    assert rel_gap(got, want) < F32_TOL


def test_bf16_forward_within_the_references_bf16_gap(seeded):
    scale, state, x = seeded
    ref = RY.build(state, scale).eval()
    with torch.no_grad():
        want = head_outputs(ref(x))
        ref_gap = rel_gap(head_outputs(ref.set_precision("bf16")(x)), want)
        got = head_outputs(port_model(scale, state, fused=True).to(
            torch.bfloat16)(x.to(torch.bfloat16))).float()
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert rel_gap(got, want) < BF16_FACTOR * ref_gap


def test_folded_forward_equals_the_unfolded(seeded):
    scale, state, x = seeded
    with torch.no_grad():
        got = head_outputs(port_model(scale, state, fused=True)(x))
        want = head_outputs(port_model(scale, state)(x))
    assert rel_gap(got, want) < F32_TOL
    folded = fold_bn_state(state)
    gammas = [k for k in state if k.endswith("gamma")]
    assert len(gammas) == (2 if scale == "x" else 0)
    assert all(np.array_equal(folded[k], state[k]) for k in gammas)


def test_channels_last_attention_takes_views_and_keeps_the_layout(seeded):
    """On the card's layout the attention core gets q, k and v as views of
    qkv's output (one storage, unit stride in the head dim), and every
    block returns channels-last."""
    scale, state, x = seeded
    model = port_model(scale, state, fused=True).to(
        memory_format=torch.channels_last)
    seen, inner = [], F.scaled_dot_product_attention

    def spy(q, k, v, *a, **kw):
        seen.append((q, k, v))
        return inner(q, k, v, *a, **kw)

    outs = []
    hooks = [m.register_forward_hook(lambda mod, i, o: outs.append(o))
             for m in model.modules() if isinstance(m, TL.AAttn)]
    TL.F.scaled_dot_product_attention = spy
    try:
        with torch.no_grad():
            model(x.to(memory_format=torch.channels_last))
    finally:
        TL.F.scaled_dot_product_attention = inner
        for h in hooks:
            h.remove()
    assert len(seen) == len(outs) == sum(
        isinstance(m, TL.AAttn) for m in model.modules())
    for q, k, v in seen:
        assert q.untyped_storage().data_ptr() == k.untyped_storage(
        ).data_ptr() == v.untyped_storage().data_ptr()
        assert q.stride(-1) == k.stride(-1) == v.stride(-1) == 1
    assert all(o.is_contiguous(memory_format=torch.channels_last)
               for o in outs)


def test_checkpoint_keys_round_trip_with_gamma_and_the_head_at_21(seeded):
    scale, state, _ = seeded
    trees = jax_trees_from_torch_state(state)
    assert "gamma" in trees["params"]["l6"] or scale == "n"
    assert "cv3_0_2" in trees["params"]["l21"]
    back = torch_state_from_jax(trees)
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert np.array_equal(back[k], v), k
    # the benchmark's writer names every leaf as the port does
    ref_trees = RY.to_trees(state)
    for coll in ("params", "batch_stats"):
        assert leaf_paths(trees[coll]) == leaf_paths(ref_trees[coll])


def leaf_paths(tree: dict, prefix: tuple = ()) -> set:
    out = set()
    for k, v in tree.items():
        out |= (leaf_paths(v, prefix + (k,)) if isinstance(v, dict)
                else {prefix + (k,)})
    return out


def test_checkpoint_arch_picks_the_class(tmp_path):
    cfg = {"model_scale": "n", "nc": 12, "channels": 3,
           "scales": [{"tile_size": 64, "overlap": 16}],
           "weights": {**WEIGHTS, "calib_size": 64}}
    path = RY.checkpoint(cfg, str(tmp_path))
    det = P.build_detector([(64, 16, path)], channels=3, model_scale="x",
                           device="cpu", compute_dtype="float32")
    assert det.cfg.scales[0].arch == "yolo12"
    assert det.cfg.scales[0].model_scale == "n"
    assert isinstance(det.models[64], YOLO12OBB)
    old = P.build_detector([(128, 30, CKPT128)], channels=3,
                           model_scale="n", device="cpu")
    assert old.cfg.scales[0].arch == "yolo11"
    assert isinstance(old.models[128], YOLO11OBB)
    rng = np.random.RandomState(3)
    res = det.detect_image(rng.randint(0, 256, (150, 170, 3), np.uint8))
    assert res["merged_for_pr"].shape[1] == 11


def test_area_attn_counts_a_1024_tile_at_x():
    """16 calls, 40 areas and 40,960 tokens a 1024 tile (8 blocks of 4
    areas of 1,024 tokens at P4, 8 of one at P5), on the meta device."""
    with torch.device("meta"):
        model = YOLO12OBB(nc=12, scale="x")
        x = torch.zeros(2, 3, 1024, 1024)
    before = dict(TL.AREA_ATTN)
    with torch.no_grad():
        model(x)
    assert {k: TL.AREA_ATTN[k] - before[k] for k in before} == {
        "calls": 16, "areas": 80, "tokens": 81920}


def test_forward_area_attn_span_under_the_profiler():
    model = YOLO12OBB(nc=12, scale="n").eval()
    x = torch.rand(1, 3, 64, 64)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as p:
        model(x)
    names = [e.name for e in p.events()]
    n_attn = sum(isinstance(m, TL.AAttn) for m in model.modules())
    assert names.count(prof.SPAN_PREFIX + "forward_area_attn") == n_attn == 8
    sdpa = [e for e in p.events()
            if e.name == "aten::scaled_dot_product_attention"]
    assert len(sdpa) == n_attn


def test_random_variables_and_calibrate_density_for_yolo12():
    variables = P.random_variables(12, "n", 3, seed=0, arch="yolo12")
    assert "gamma" not in variables["params"]["l6"]    # n: no residual
    assert "cv3_2_2" in variables["params"]["l21"]
    cal = calibrate_density(YOLO12OBB(nc=12, scale="n"), variables, 64, 3,
                            device="cpu")
    shift = [cal["params"]["l21"][f"cv3_{i}_2"]["bias"]
             - variables["params"]["l21"][f"cv3_{i}_2"]["bias"]
             for i in range(3)]
    assert np.all(shift[0] != 0) and np.allclose(shift[0], shift[2])
    assert np.array_equal(cal["params"]["l21"]["cv2_0_2"]["bias"],
                          variables["params"]["l21"]["cv2_0_2"]["bias"])
