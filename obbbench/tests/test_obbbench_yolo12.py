"""YOLO12-OBB in the benchmark (``archs/yolo12_obb.py``,
``reference/yolo12.py``, the cell ``yolo12_folder_sheets``), at the cell's
tiny size on the CPU: the seeded checkpoint reads the same through the
program's loader and the reference's, the FLOP counts are ultralytics'
layer table's, the area-attention readers read their span alone, a sound
run is correct and a run whose area attention is broken underneath is
not, the fp8 control fails, and a program without YOLO12 fails the cell
at once."""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tiny
from obbbench.harness import runner, spec
from obbbench.harness import trace as TR
from obbbench.reference import yolo12 as RY

CPU = torch.device("cpu")
CELL = "yolo12_folder_sheets"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("yolo12")))


@pytest.fixture(scope="module")
def small(data):
    return spec.load_cell(CELL, spec.ROOT, data)


def run(cell, seconds=1.0):
    return runner.run_cell(cell, 2 ** 31 + 99, seconds, False, CPU,
                           time.perf_counter(), lambda *a: None)


def test_checkpoint_reads_alike_in_program_and_reference(small):
    """Every key and value of the written checkpoint, through the
    program's loader (``load_checkpoint``, ``variables_from_checkpoint``,
    ``torch_state_from_jax``) and through the reference's (``ckpt.load``
    and its own key mapping), the same; the recorded architecture, scale,
    channels and tile as the configuration's."""
    from oriented_object_detection_tpu_torch.models import weights as W

    cfg = small.config
    path = RY.checkpoint(cfg, small.root)
    ck = W.load_checkpoint(path)
    assert ck["extra"] == {"arch": "yolo12", "model_scale": "l",
                           "channels": 3, "tile_size": 128}
    program = W.torch_state_from_jax(W.variables_from_checkpoint(ck))
    reference = RY.read_state(path, "l", cfg["nc"], 3)
    assert sorted(program) == sorted(reference)
    assert any(k.endswith("gamma") for k in program)
    assert any(k.startswith("model.21.cv3") for k in program)
    for k, v in reference.items():
        assert program[k].dtype == v.dtype == np.float32
        assert np.array_equal(program[k], v), k
    # written once: the same file is found again
    assert RY.checkpoint(cfg, small.root) == path


def test_flops_of_a_1024_tile_at_x():
    cell = spec.load_cell(CELL)
    cfg = cell.config
    assert cell.arch.forward_flops(cfg, 1024) == 594026889216.0
    flops, nbytes = cell.arch.area_attn_work(cfg, 1024)
    assert flops == 114284298240.0
    # 8 blocks at P4 (384 channels, 4,096 tokens), 8 at P5 (1,024 tokens),
    # 8 C N bf16 elements each and the weights
    weights = sum(p.numel() for m in RY.YOLO12OBB(nc=12, scale="x").modules()
                  if isinstance(m, RY.AAttn) for p in m.parameters())
    assert nbytes == 2.0 * (8 * 384 * (4096 + 1024) * 8 + weights)


def test_area_attention_readers(small):
    """Device ms a Mpix and the roofline share of the kernels in the
    ``forward_area_attn`` spans; nothing where there are none."""
    ms = small.module("layer_metrics", "area_attn_ms.detect_folder")
    roof = small.module("layer_metrics", "area_attn_roofline.detect_folder")
    spans = [("obb/window", 0.0, 1.0), ("obb/forward_128", 0.0, 0.5),
             ("obb/forward_area_attn", 0.1, 0.2)]
    kernels = [TR.Kernel("conv", 0.1, 0.3, "obb/forward_128"),
               TR.Kernel("flash_fwd", 0.3, 0.35, "obb/forward_area_attn")]
    tr = TR.Trace(kernels=kernels, spans=spans, window=(0.0, 1.0), units=1)
    cfg = small.config
    record = {"mpix": [0.5, 0.5],
              "flops": 10 * small.arch.forward_flops(cfg, 128)}
    assert ms.value(tr, record, small) == pytest.approx(50.0)
    flops, nbytes = small.arch.area_attn_work(cfg, 128)
    want = 100.0 * max(10 * flops / 989e12, 10 * nbytes / 3.35e12) / 0.05
    assert roof.value(tr, record, small) == pytest.approx(want)
    bare = TR.Trace(kernels=kernels[:1], spans=spans, window=(0.0, 1.0))
    assert ms.value(bare, record, small) is None
    assert roof.value(bare, record, small) is None


@contextlib.contextmanager
def patched(obj, name, make):
    inner = getattr(obj, name)
    setattr(obj, name, make(inner))
    try:
        yield
    finally:
        setattr(obj, name, inner)


def area_one(inner):
    """The P4 stage attends over one area, the whole map."""
    def fn(self, x, *args, **kw):
        area, self.area = self.area, 1
        try:
            return inner(self, x, *args, **kw)
        finally:
            self.area = area
    return fn


def column_areas(inner):
    """The P4 stage's areas are strips of columns, not of rows; a residual,
    where the call gives one, added to the output."""
    def fn(self, x, *args, **kw):
        if self.area == 1:
            return inner(self, x, *args, **kw)
        B, C, H, W = x.shape
        a, h, d = self.area, self.num_heads, self.head_dim
        qkv = self.qkv(x).transpose(2, 3).flatten(2).transpose(1, 2)
        q, k, v = qkv.reshape(B * a, H * W // a, h, 3 * d).transpose(
            1, 2).split(d, dim=-1)
        out = F.scaled_dot_product_attention(q, k, v)

        def back(t):
            return t.transpose(1, 2).reshape(B, W, H, C).permute(0, 3, 2, 1)

        y = self.proj(back(out) + self.pe(back(v).contiguous()))
        residual = kw.get("residual", args[0] if args else None)
        return y if residual is None else y + residual
    return fn


def no_pe(inner):
    """The positional branch is dropped: proj(out) alone."""
    class Zero(torch.nn.Module):
        def forward(self, t):
            return torch.zeros_like(t)

    def fn(self, x, *args, **kw):
        pe, self.pe = self.pe, Zero()
        try:
            return inner(self, x, *args, **kw)
        finally:
            self.pe = pe
    return fn


def gamma_ignored(inner):
    """The residual stage adds its output unscaled, x + out."""
    def fn(self, x):
        if self.gamma is None:
            return inner(self, x)
        ys = [self.cv1(x)]
        for m in self.m:
            ys.append(m(ys[-1]))
        return x + self.cv2(torch.cat(ys, 1))
    return fn


FAULTS = {"area_one": ("AAttn", area_one),
          "column_areas": ("AAttn", column_areas),
          "no_pe": ("AAttn", no_pe),
          "gamma_ignored": ("A2C2f", gamma_ignored)}


@pytest.mark.parametrize("fault", ["area_one", "column_areas", "no_pe"])
def test_area_attention_faults_pass_their_arguments_on(fault):
    """Each attention fault hands the arguments after ``x`` on to the
    forward it wraps, so an ``AAttn.forward`` that takes more (a residual
    folded in) is broken the same way; ``column_areas``, which rebuilds the
    forward, adds a given residual to its output."""
    from oriented_object_detection_tpu_torch.models import layers as TL

    make = FAULTS[fault][1]
    seen = []
    fn = make(lambda self, x, *a, **k: seen.append((a, k)) or x)
    one = TL.AAttn(64, 2, area=1).eval()
    x, r = torch.randn(2, 1, 64, 8, 8).unbind(0)
    with torch.no_grad():
        fn(one, x, r)
        fn(one, x, residual=r)
    assert len(seen) == 2
    assert seen[0][0][0] is r and seen[1][1]["residual"] is r
    if fault == "column_areas":
        four = TL.AAttn(64, 2, area=4).eval()
        with torch.no_grad():
            bare = fn(four, x)
            torch.testing.assert_close(fn(four, x, r), bare + r)
            torch.testing.assert_close(fn(four, x, residual=r), bare + r)


def test_sound_run_is_correct(small):
    res = run(small)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_area_attention_fault_is_not_correct(small, fault):
    from oriented_object_detection_tpu_torch.models import layers as TL

    cls, make = FAULTS[fault]
    with patched(getattr(TL, cls), "forward", make):
        res = run(small)
    assert res["correct"] is False, res["checks"]


def test_fp8_control_is_not_correct(small):
    drv = small.driver
    sess = drv.setup(small, 2 ** 32 + 3, CPU)
    drv.window(sess, 0.0, 2)
    drv.release(sess)
    got = drv.readings(sess, drv.reference(sess, "fp8"))
    limits = small.workload["limits"]
    assert any(got[k] > lim for k, lim in limits.items()), (got, limits)


def test_a_program_without_yolo12_fails_at_once(small, monkeypatch):
    """The parent of YOLO12 in the program: the cell stops in set-up,
    before any sheet, with the reason."""
    from oriented_object_detection_tpu_torch.models import archs

    monkeypatch.delitem(archs.ARCHS, "yolo12")
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="no YOLO12"):
        run(small)
    assert time.perf_counter() - t0 < 60


def test_the_reference_alone_holds_the_weights(small):
    """The reference models carry the checkpoint's weights, unfolded, in
    float32 and in eval mode, at each of the configuration's tiles."""
    models = small.arch.reference_models(small.config, small.root, CPU)
    (ts, model), = models.items()
    assert ts == 128 and not model.training
    state = RY.read_state(RY.checkpoint(small.config, small.root), "l", 12,
                          3)
    own = model.state_dict()
    for k, v in state.items():
        assert torch.equal(own[k], torch.from_numpy(v)), k
    assert os.path.basename(RY.checkpoint(small.config, small.root)
                            ).startswith("yolo12_l_c3_nc12_t128_seed18_")
