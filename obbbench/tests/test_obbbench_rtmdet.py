"""Rotated RTMDet in the benchmark (``archs/rtmdet_r.py``,
``reference/rtmdet_r.py``, the cell ``rtmdet_r_folder_sheets``), at the
cell's tiny size on the CPU: the seeded checkpoint reads the same through
the program's loader and the reference's, the FLOP counts are mmrotate's,
the depthwise readers read their span alone, a sound run is correct and a
run whose CSPNeXt blocks or decode are broken underneath is not, the fp8
control fails, and a program without RTMDet-R fails the cell at once."""

from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

import tiny
from obbbench.harness import runner, spec
from obbbench.harness import trace as TR
from obbbench.reference import rtmdet_r as RR

CPU = torch.device("cpu")
CELL = "rtmdet_r_folder_sheets"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("rtmdet")))


@pytest.fixture(scope="module")
def small(data):
    return spec.load_cell(CELL, spec.ROOT, data)


def run(cell, seconds=1.0):
    return runner.run_cell(cell, 2 ** 31 + 99, seconds, False, CPU,
                           time.perf_counter(), lambda *a: None)


def test_checkpoint_reads_alike_in_program_and_reference(small):
    """Every key and value of the written checkpoint, through the
    program's loader and through the reference's, the same; the recorded
    architecture, scale and channels as the configuration's."""
    from oriented_object_detection_tpu_torch.models import weights as W

    cfg = small.config
    path = RR.checkpoint(cfg, small.root)
    ck = W.load_checkpoint(path)
    assert ck["extra"] == {"arch": "rtmdet_r", "model_scale": "tiny",
                           "channels": 3}
    program = W.torch_state_from_jax(W.variables_from_checkpoint(ck))
    reference = RR.read_state(path, "tiny", cfg["nc"])
    assert sorted(program) == sorted(reference)
    for k, v in reference.items():
        assert program[k].dtype == v.dtype == np.float32
        assert np.array_equal(program[k], v), k
    assert RR.checkpoint(cfg, small.root) == path
    assert os.path.basename(path).startswith("rtmdet_r_tiny_c3_nc12_seed24_")


def test_flops_of_a_1024_tile_at_l():
    """408.34 GFLOP a tile (mmrotate: 204.21 GMAC); the 30 depthwise 5x5
    ConvBNs 2.36 GFLOP and 0.189 GB in bf16: 94,371,840 elements in and
    out, and their kernels and folded biases."""
    cell = spec.load_cell(CELL)
    cfg = cell.config
    assert cell.arch.forward_flops(cfg, 1024) == 408339775488.0
    flops, nbytes = cell.arch.depthwise_work(cfg, 1024)
    assert flops == 2359296000.0
    with torch.device("meta"):
        net = RR.RTMDetR(nc=12, scale="l")
    dws = [m.conv2.depthwise_conv.conv for m in net.modules()
           if isinstance(m, RR.CSPNeXtBlock)]
    assert len(dws) == 30
    weights = sum(c.weight.numel() + c.out_channels for c in dws)
    assert nbytes == 2.0 * (94371840 + weights)


def test_depthwise_readers(small):
    """Device ms a Mpix and the roofline share of the kernels in the
    ``forward_depthwise`` spans; nothing where there are none."""
    ms = small.module("layer_metrics", "depthwise_ms.detect_folder")
    roof = small.module("layer_metrics", "depthwise_roofline.detect_folder")
    spans = [("obb/window", 0.0, 1.0), ("obb/forward_128", 0.0, 0.5),
             ("obb/forward_depthwise", 0.1, 0.2)]
    kernels = [TR.Kernel("conv", 0.1, 0.3, "obb/forward_128"),
               TR.Kernel("dgrad_dw", 0.3, 0.35, "obb/forward_depthwise")]
    tr = TR.Trace(kernels=kernels, spans=spans, window=(0.0, 1.0), units=1)
    cfg = small.config
    record = {"mpix": [0.5, 0.5],
              "flops": 10 * small.arch.forward_flops(cfg, 128)}
    assert ms.value(tr, record, small) == pytest.approx(50.0)
    flops, nbytes = small.arch.depthwise_work(cfg, 128)
    want = 100.0 * max(10 * flops / 989e12, 10 * nbytes / 3.35e12) / 0.05
    assert roof.value(tr, record, small) == pytest.approx(want)
    bare = TR.Trace(kernels=kernels[:1], spans=spans, window=(0.0, 1.0))
    assert ms.value(bare, record, small) is None
    assert roof.value(bare, record, small) is None


def no_identity(inner):
    """The backbone's blocks add no identity."""
    def fn(self, x, *args, **kw):
        add, self.add_identity = self.add_identity, False
        try:
            return inner(self, x, *args, **kw)
        finally:
            self.add_identity = add
    return fn


def sigmoid_gate(inner):
    """The channel attention's gate by sigmoid, not hardsigmoid."""
    def fn(self, x):
        return x * torch.sigmoid(self.fc(x.float().mean(
            dim=(2, 3), keepdim=True))).to(x.dtype)
    return fn


def angle_negated(inner):
    """The decode turns each box the other way."""
    def fn(out, img_size):
        return inner({**out, "ang": [-a for a in out["ang"]]}, img_size)
    return fn


FAULTS = {"no_identity": ("CSPNeXtBlock", no_identity),
          "sigmoid_gate": ("ChannelAttention", sigmoid_gate),
          "angle_negated": (None, angle_negated)}


def test_sound_run_is_correct(small):
    res = run(small)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(small, fault, monkeypatch):
    """A block or the attention broken in ``models/layers.py``, or the
    architecture's decode in ``models/archs.py``."""
    from oriented_object_detection_tpu_torch.models import archs
    from oriented_object_detection_tpu_torch.models import layers as TL

    cls, make = FAULTS[fault]
    if cls is None:
        arch = archs.ARCHS["rtmdet_r"]
        monkeypatch.setitem(archs.ARCHS, "rtmdet_r", type(arch)(
            arch.model, arch.pixels, arch.normalise, make(arch.decode),
            arch.bn_eps))
    else:
        monkeypatch.setattr(getattr(TL, cls), "forward",
                            make(getattr(TL, cls).forward))
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


def test_a_program_without_rtmdet_fails_at_once(small, monkeypatch):
    """The parent of RTMDet-R in the program: the cell stops in set-up,
    before any sheet, with the reason."""
    from oriented_object_detection_tpu_torch.models import archs

    monkeypatch.delitem(archs.ARCHS, "rtmdet_r")
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="no RTMDet-R"):
        run(small)
    assert time.perf_counter() - t0 < 60


def test_the_reference_alone_holds_the_weights(small):
    """The reference models carry the checkpoint's weights, unfolded, in
    float32 and in eval mode, the head's convs shared by its levels."""
    models = small.arch.reference_models(small.config, small.root, CPU)
    (ts, model), = models.items()
    assert ts == 128 and not model.training
    state = RR.read_state(RR.checkpoint(small.config, small.root), "tiny",
                          12)
    own = model.state_dict()
    for k, v in state.items():
        assert torch.equal(own[k], torch.from_numpy(v)), k
    head = model.bbox_head
    assert head.cls_convs[2][1].conv is head.cls_convs[0][1].conv
    assert head.reg_convs[1][0].bn is not head.reg_convs[0][0].bn
