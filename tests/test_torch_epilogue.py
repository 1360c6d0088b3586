"""The folded ConvBN's epilogue (``ops/epilogue.py``) and the detector's
channels-last forward, on the CPU: the plain epilogue is the arithmetic the
fused ConvBN always had, the forward in channels-last order gives the NCHW
forward's outputs, every fused ConvBN of the detector's forward sees and
gives channels-last tensors once its models are channels-last (the card's
layout), and the training path (``fused=False``) is as it was and never
reaches the kernel's wrapper."""

import copy
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from oriented_object_detection_tpu_torch.infer import pipeline as P
from oriented_object_detection_tpu_torch.models import layers as TL
from oriented_object_detection_tpu_torch.models.fold import fold_bn_state
from oriented_object_detection_tpu_torch.models.weights import (
    load_state, torch_state_from_jax, variables_from_checkpoint)
from oriented_object_detection_tpu_torch.models.yolo11_obb import (
    SCALES, YOLO11OBB)
from oriented_object_detection_tpu_torch.ops import epilogue as EP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT128 = os.path.join(REPO, "assets", "bench_ckpts", "train128.ckpt")
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_parity import one_torch_thread  # noqa: E402,F401

CL = torch.channels_last
DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["float32", "bf16"]
# float32: the two layouts sum each convolution in another order
F32_TOL = 1e-5


def bf16_ulps(ref: torch.Tensor, got: torch.Tensor) -> np.ndarray:
    """|ref - got| in bf16 ulps, by the rule of
    ``tests/test_torch_bf16_layers.py``: the spacing of bf16 numbers at the
    larger magnitude of the two, or at the reference's mean magnitude where
    both are smaller."""
    ref, got = ref.float().numpy(), got.float().numpy()
    mag = np.maximum(np.maximum(np.abs(ref), np.abs(got)),
                     np.abs(ref).mean())
    return np.abs(ref - got) / np.exp2(np.floor(np.log2(mag)) - 7)


def channels_innermost(t: torch.Tensor) -> bool:
    """The channel axis is the innermost in memory (NHWC order); a channel
    split of a channels-last tensor is so, though not dense."""
    return t.stride(1) == 1 and t.stride(3) >= t.shape[1]


@pytest.fixture(scope="module")
def folded_n():
    """The committed YOLO11n-OBB 128 checkpoint, BN folded, as a fused
    float32 model on the CPU."""
    model = YOLO11OBB(nc=12, scale="n", in_channels=3, fused_bn=True)
    load_state(model, fold_bn_state(torch_state_from_jax(
        variables_from_checkpoint(CKPT128))))
    return model.eval()


@pytest.mark.parametrize("act", [True, False], ids=["silu", "bias_only"])
@pytest.mark.parametrize("layout", [torch.contiguous_format, CL],
                         ids=["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_plain_epilogue_is_the_fused_convbn_arithmetic(dtype, layout, act):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 9, 7, generator=g).to(dtype, memory_format=layout)
    conv = TL.Conv2d(16, 24, 3, 1, 1, bias=False).to(
        dtype, memory_format=layout)
    bias = torch.randn(24, generator=g) * 0.5
    with torch.no_grad():
        want = conv(x).add_(bias.to(dtype)[:, None, None])
        want = F.silu(want) if act else want
        got = EP.bias_silu_nhwc(conv(x), bias, act)
        unit = TL.ConvBN(16, 24, 3, act=act)
        unit.conv = conv
        unit.bn.bias.copy_(bias)
        unit.fused = True
        by_module = unit(x)
    assert got.dtype == dtype and by_module.dtype == dtype
    assert torch.equal(got, want) and torch.equal(by_module, want)
    assert EP.LAUNCHES["bias_silu_nhwc"] == 0


def test_wrapper_refuses_a_device_it_has_no_kernel_for():
    y = torch.empty(1, 8, 2, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        EP.bias_silu_nhwc(y, torch.empty(8, device="meta"), True)


@pytest.mark.parametrize("scale", sorted(SCALES))
def test_every_fused_convbn_has_channels_in_eights(scale):
    """Every YOLO11 ConvBN of every scale has C a multiple of 8, so the
    kernel runs its 16-byte vectors on YOLO11's forward (YOLO12's MLP at
    460 channels takes 8-byte ones)."""
    model = YOLO11OBB(nc=12, scale=scale, fused_bn=True)
    widths = [m.conv.out_channels for m in model.modules()
              if isinstance(m, TL.ConvBN)]
    assert widths and all(c % 8 == 0 for c in widths)


def test_upsample_keeps_values_and_layout():
    x = torch.randn(2, 8, 5, 3)
    ref = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    assert torch.equal(TL.upsample2x(x), ref)
    got = TL.upsample2x(x.to(memory_format=CL))
    assert got.is_contiguous(memory_format=CL) and torch.equal(got, ref)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_upsample_gradient_has_the_reference_bits(dtype):
    """Training's upsample (an NCHW input) sums its gradient in the order
    of the JAX package's ``jnp.repeat``s, bit for bit; ``F.interpolate``'s
    backward sums in another order."""
    import jax
    import jax.numpy as jnp

    from oriented_object_detection_tpu.models import layers as JL

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 7, 16).astype(np.float32)        # NHWC
    g = rng.randn(2, 10, 14, 16).astype(np.float32)
    _, vjp = jax.vjp(JL.upsample2x, jnp.asarray(x, jdt))
    (want,) = vjp(jnp.asarray(g, jdt))
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(
        dtype, memory_format=torch.contiguous_format).requires_grad_()
    gt = torch.from_numpy(g).permute(0, 3, 1, 2).to(dtype)
    (got,) = torch.autograd.grad(TL.upsample2x(xt), xt, gt)
    assert np.array_equal(got.float().numpy(), want)


def test_launch_is_an_operator_under_the_profiler():
    """A ctypes launch made while a profiler collects is an operator named
    after its kernel, so the profiler links the kernel to a host op inside
    the caller's span; without a profiler it is a plain call. A CUDA error
    code raises."""
    from torch.profiler import ProfilerActivity, profile

    from oriented_object_detection_tpu_torch.utils import build as B

    calls = []
    B.launch("k_plain", lambda *a: calls.append(a) or 0, 1, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("obb/forward"):
            B.launch("k_traced", lambda *a: calls.append(a) or 0, 3)
    assert calls == [(1, 2), (3,)]
    names = {e.name for e in prof.events()}
    assert "k_traced" in names and "k_plain" not in names
    span = next(e for e in prof.events() if e.name == "obb/forward")
    op = next(e for e in prof.events() if e.name == "k_traced")
    assert (span.time_range.start <= op.time_range.start
            <= op.time_range.end <= span.time_range.end)
    with pytest.raises(RuntimeError, match="k_bad kernel launch failed"):
        B.launch("k_bad", lambda: 700)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_channels_last_forward_matches_nchw(folded_n, dtype):
    x = torch.rand(2, 3, 128, 96, generator=torch.Generator().manual_seed(5))
    nchw = copy.deepcopy(folded_n).to(dtype)
    nhwc = copy.deepcopy(folded_n).to(dtype, memory_format=CL)
    with torch.inference_mode():
        ref = nchw(x.to(dtype))
        got = nhwc(x.to(dtype, memory_format=CL))
    for key in ("box", "cls", "ang"):
        for a, b in zip(ref[key], got[key]):
            assert a.shape == b.shape and b.dtype == dtype
            assert b.is_contiguous(memory_format=CL)
            if dtype == torch.float32:
                np.testing.assert_allclose(b.numpy(), a.numpy(),
                                           rtol=F32_TOL, atol=F32_TOL)
            else:
                assert bf16_ulps(a, b).max() <= 2.0


def test_detector_forward_is_channels_last_end_to_end():
    """A CPU detector is NCHW, today's layout; with its models and input
    layout set as on the card, every fused ConvBN of both scales takes a
    channels-last input and gives a channels-last output (dense, or a
    channel slice of a block's channels-last concatenation), and the rows
    are the NCHW detector's."""
    gen_map = pytest.importorskip("tools.train_synthetic").gen_map
    image = gen_map(np.random.RandomState(4), H=300, W=340, n_obj=12)[0]
    scales = [(128, 30, CKPT128),
              (416, 100, os.path.join(REPO, "assets", "bench_ckpts",
                                      "train416.ckpt"))]
    det = P.build_detector(scales, model_scale="n", device="cpu",
                           compute_dtype="float32")
    assert det.layout == torch.contiguous_format
    ref = det.detect_image(image)
    det.layout = CL
    for model in det.models.values():
        model.to(memory_format=CL)
    seen = []

    def hook(mod, inp, out):
        seen.append((channels_innermost(inp[0]),
                     out.is_contiguous(memory_format=CL)
                     or channels_innermost(out) and out.stride(0)
                     > out[0].numel()))

    units = [m for model in det.models.values() for m in model.modules()
             if isinstance(m, TL.ConvBN)]
    hooks = [m.register_forward_hook(hook) for m in units]
    try:
        got = det.detect_image(image)
    finally:
        for h in hooks:
            h.remove()
    assert all(m.fused for m in units)
    assert len(seen) == len(units) and all(a and b for a, b in seen)
    assert EP.LAUNCHES["bias_silu_nhwc"] == 0
    for ts in ref["by_scale"]:
        a, b = ref["by_scale"][ts], got["by_scale"][ts]
        assert a.shape == b.shape and len(a) > 0
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("act", [True, False], ids=["silu", "no_act"])
def test_training_convbn_is_unchanged(act, monkeypatch):
    """``fused=False`` (training): conv, flax-style BatchNorm, SiLU, with
    gradients, and the epilogue's wrapper never called."""
    g = torch.Generator().manual_seed(8)
    unit = TL.ConvBN(8, 16, 3, act=act).train()
    x = torch.randn(4, 8, 10, 10, generator=g, requires_grad=True)
    calls = []
    monkeypatch.setattr(TL, "bias_silu_nhwc", lambda *a: calls.append(a))
    out = unit(x)
    y = unit.conv(x)
    mean = y.mean(dim=(0, 2, 3))
    var = torch.clamp_min((y * y).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    want = ((y - mean[:, None, None])
            * (torch.rsqrt(var + unit.bn.eps) * unit.bn.weight)[:, None, None]
            + unit.bn.bias[:, None, None])
    want = F.silu(want) if act else want
    assert torch.equal(out, want) and not calls
    out.sum().backward()
    assert x.grad is not None and unit.conv.weight.grad is not None
    assert EP.LAUNCHES["bias_silu_nhwc"] == 0


def test_kernel_build_without_nvcc_raises():
    """No silent fallback when the CUDA build cannot run."""
    import shutil

    if shutil.which("nvcc"):
        pytest.skip("this checks a machine without nvcc")
    EP.kernel_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        EP.kernel_library()
