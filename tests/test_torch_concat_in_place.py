"""The fused blocks build their concatenations in place (``models/layers.py``
over ``ops/epilogue.py``), on the CPU: the plain epilogue's stores, scale
and residual are the composition of PyTorch ops the blocks had, each fused
block (C3k2, C3k, A2C2f) is bit-equal to its ``forward_plain`` (the
``torch.cat`` form) in NCHW and channels-last order, a training block
keeps its outputs and gradients and never reaches the epilogue, and
``STORES`` counts the concatenation parts and residual folds of a YOLO11x
and a YOLO12x forward, which launch only the concatenations outside the
blocks."""

import contextlib
import os
import sys

import pytest
import torch
import torch.nn.functional as F

from oriented_object_detection_tpu_torch.models import layers as TL
from oriented_object_detection_tpu_torch.models.yolo11_obb import YOLO11OBB
from oriented_object_detection_tpu_torch.models.yolo12_obb import YOLO12OBB
from oriented_object_detection_tpu_torch.ops import epilogue as EP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_parity import one_torch_thread  # noqa: E402,F401

CL = torch.channels_last
DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["float32", "bf16"]
LAYOUTS = [torch.contiguous_format, CL]
LAYOUT_IDS = ["nchw", "channels_last"]
BLOCKS = (TL.Bottleneck, TL.C3k, TL.C3k2, TL.ABlock, TL.A2C2f)


@contextlib.contextmanager
def plain_blocks():
    """Every block class through its ``forward_plain``: the ``torch.cat``
    form with separate residual adds."""
    saved = {cls: cls.forward for cls in BLOCKS}
    for cls in BLOCKS:
        cls.forward = cls.forward_plain
    try:
        yield
    finally:
        for cls, fn in saved.items():
            cls.forward = fn


def reset_stores():
    for k in EP.STORES:
        EP.STORES[k] = 0


def seeded_fused(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """``module`` with every ConvBN fused and seeded weights: conv weights
    scaled to keep the activations near unit size, biases and ``gamma``
    of a few tenths, so every epilogue step moves the bits."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, TL.ConvBN):
                w = m.conv.weight
                w.copy_(torch.randn(w.shape, generator=g)
                        / (w[0].numel() ** 0.5))
                m.bn.bias.copy_(torch.randn(m.bn.bias.shape, generator=g)
                                * 0.3)
                m.fused = True
            elif isinstance(m, TL.A2C2f) and m.gamma is not None:
                m.gamma.copy_(1 + 0.5 * torch.randn(m.gamma.shape,
                                                    generator=g))
    return module.eval()


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("act", [True, False], ids=["silu", "bias_only"])
def test_plain_epilogue_stores_are_the_composition(act, dtype, layout):
    """Two destinations (a slice of a wider buffer and a packed tensor of
    the last channels), a residual that is itself a channel slice, and a
    scale: bit-equal to ``add_``, ``silu``, ``gamma *``, ``+`` and
    ``torch.cat``, and counted in ``STORES``."""
    g = torch.Generator().manual_seed(11)
    N, C, H, W = 2, 24, 5, 7
    mk = lambda c: torch.randn(N, c, H, W, generator=g).to(
        dtype, memory_format=layout)
    y, other, wide = mk(C), mk(8), mk(C + 16)
    bias, gamma = torch.randn(C, generator=g), torch.randn(C, generator=g)
    residual = wide[:, 8:8 + C]
    want = y.clone().add_(bias.to(dtype)[:, None, None])
    want = F.silu(want) if act else want
    want = residual + gamma.to(dtype)[:, None, None] * want
    want_cat = torch.cat([other, want], 1)

    buf = torch.empty(N, 8 + C, H, W, dtype=dtype).to(memory_format=layout)
    buf[:, :8] = other
    packed = torch.empty(N, C - 10, H, W, dtype=dtype).to(
        memory_format=layout)
    reset_stores()
    got = EP.bias_silu_nhwc(y.clone(), bias, act,
                            [(buf[:, 8:], 0), (packed, 10)], residual, gamma)
    assert got.data_ptr() == buf[:, 8:].data_ptr()
    assert torch.equal(buf, want_cat)
    assert torch.equal(packed, want[:, 10:])
    assert EP.STORES == {"concat_parts": 1, "residual_folds": 1}
    # in place, with a packed residual: no concatenation part
    packed_res = residual.contiguous(memory_format=layout)
    got = EP.bias_silu_nhwc(y.clone(), bias, act, residual=packed_res,
                            scale=gamma)
    assert torch.equal(got, want)
    assert EP.STORES == {"concat_parts": 1, "residual_folds": 2}
    assert EP.LAUNCHES["bias_silu_nhwc"] == 0


def block_cases():
    """(id, constructor, input channels, spatial size) of each block form
    the detectors build."""
    return [
        ("c3k2", lambda: TL.C3k2(16, 32, 2, False, e=0.25), 16, (8, 6)),
        ("c3k2_c3k", lambda: TL.C3k2(24, 32, 2, True), 24, (8, 6)),
        ("c3k2_c3k_no_shortcut",
         lambda: TL.C3k2(24, 32, 1, True, shortcut=False), 24, (6, 6)),
        ("c3k", lambda: TL.C3k(16, 24, 2), 16, (7, 5)),
        ("a2c2f_a2_residual",
         lambda: TL.A2C2f(64, 64, 2, True, 4, residual=True,
                          mlp_ratio=1.2), 64, (8, 8)),
        ("a2c2f_a2",
         lambda: TL.A2C2f(48, 64, 1, True, 1, residual=False), 48, (4, 6)),
        ("a2c2f_c3k",
         lambda: TL.A2C2f(40, 64, 2, False, -1, residual=True,
                          mlp_ratio=1.2), 40, (6, 4)),
    ]


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("case", block_cases(), ids=lambda c: c[0])
def test_fused_block_in_place_is_the_cat_form(case, dtype, layout):
    name, make, c1, (H, W) = case
    block = seeded_fused(make(), seed=len(name)).to(dtype,
                                                    memory_format=layout)
    x = torch.randn(2, c1, H, W, generator=torch.Generator().manual_seed(
        3)).to(dtype, memory_format=layout)
    with torch.inference_mode():
        reset_stores()
        got = block(x)
        stores = dict(EP.STORES)
        with plain_blocks():
            want = block(x)
    assert got.dtype == dtype and torch.equal(got, want)
    assert got.is_contiguous(memory_format=layout)
    assert stores["concat_parts"] > 0
    assert EP.STORES == stores          # the cat form stores no part


@pytest.mark.parametrize("case", block_cases(), ids=lambda c: c[0])
def test_training_block_keeps_its_cat_form_and_gradients(case,
                                                         monkeypatch):
    """An unfused block (training) runs ``forward_plain``: the same
    outputs and gradients, with ``torch.cat`` and without the epilogue."""
    name, make, c1, (H, W) = case
    torch.manual_seed(len(name))
    block = make().train()
    x = torch.randn(2, c1, H, W, requires_grad=True)
    want = block.forward_plain(x)
    want_grads = torch.autograd.grad(want.square().sum(),
                                     [x, *block.parameters()])
    monkeypatch.setattr(TL, "bias_silu_nhwc", lambda *a: pytest.fail(
        "a training block reached the epilogue"))
    cats = []
    real_cat = torch.cat
    monkeypatch.setattr(torch, "cat", lambda *a, **k: cats.append(1)
                        or real_cat(*a, **k))
    reset_stores()
    got = block(x)
    got_grads = torch.autograd.grad(got.square().sum(),
                                    [x, *block.parameters()])
    assert torch.equal(got, want) and cats
    assert all(torch.equal(a, b) for a, b in zip(got_grads, want_grads))
    assert EP.STORES == {"concat_parts": 0, "residual_folds": 0}
    with pytest.raises(ValueError, match="fused ConvBN"):
        block.cv2(torch.randn(1, block.cv2.conv.in_channels, 4, 4),
                  residual=torch.zeros(()))


def test_fused_ablock_calls_area_attention_with_x_alone(monkeypatch):
    """A fused ABlock reaches its ``AAttn`` through ``forward(x)`` alone, so
    a replacement of ``AAttn.forward`` taking ``x`` (as the benchmark's
    planted attention faults are) still runs; the attention's residual
    stays a separate add, the MLP's is folded."""
    calls = []
    real = TL.AAttn.forward
    monkeypatch.setattr(TL.AAttn, "forward",
                        lambda self, x: calls.append(1) or real(self, x))
    block = seeded_fused(TL.A2C2f(64, 64, 2, True, 4, residual=True,
                                  mlp_ratio=1.2), seed=2)
    x = torch.randn(2, 64, 8, 8, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        reset_stores()
        got = block(x)
        assert EP.STORES == {"concat_parts": 3, "residual_folds": 5}
        with plain_blocks():
            want = block(x)
    assert len(calls) == 8 and torch.equal(got, want)


# per forward: (concat_parts, residual_folds, torch.cat calls left: the
# head's four, and YOLO11's SPPF and C2PSA)
STORES_A_FORWARD = {"yolo11x": (YOLO11OBB, 56, 32, 6),
                    "yolo12x": (YOLO12OBB, 52, 42, 4)}


@pytest.mark.parametrize("model", sorted(STORES_A_FORWARD))
def test_stores_a_forward(model, monkeypatch):
    """A fused x-scale forward on the smallest input each model takes
    (32x32: a 1x1 map at P5) folds every block's concatenation and
    residual, as ``STORES`` counts, and leaves no block concatenation;
    its outputs are the cat form's."""
    cls, parts, folds, cats_left = STORES_A_FORWARD[model]
    net = seeded_fused(cls(nc=12, scale="x"), seed=5).to(memory_format=CL)
    x = torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(
        1)).to(memory_format=CL)
    cats = []
    real_cat = torch.cat
    with torch.inference_mode():
        with plain_blocks():
            want = net(x)
        monkeypatch.setattr(torch, "cat", lambda *a, **k: cats.append(1)
                            or real_cat(*a, **k))
        reset_stores()
        got = net(x)
    assert EP.STORES == {"concat_parts": parts, "residual_folds": folds}
    assert len(cats) == cats_left
    for key in ("box", "cls", "ang"):
        assert all(torch.equal(a, b) for a, b in zip(got[key], want[key]))


def test_pixel_stride_takes_channel_slices_of_channels_last_only():
    buf = torch.empty(2, 40, 5, 3).to(memory_format=CL)
    assert EP.pixel_stride(buf, (2, 40, 5, 3)) == 40
    assert EP.pixel_stride(buf[:, 8:24], (2, 16, 5, 3)) == 40
    with pytest.raises(ValueError, match="channels innermost"):
        EP.pixel_stride(torch.empty(2, 40, 5, 3), (2, 40, 5, 3))
    with pytest.raises(ValueError, match="shape"):
        EP.pixel_stride(buf[:, 8:24], (2, 24, 5, 3))
