"""The detect harness reaches the model only through the configuration's
architecture module (``archs/<model>.py``): YOLO11-OBB's module gives what
the reference models and the FLOP count gave before there were modules,
bit for bit, and an architecture added as files, with its configuration,
cell and tiny sizes, runs a whole cell with no file of the benchmark
edited: on YOLO's reference input and decode, and on its own, which the
check is seen to run."""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import pytest
import torch

import tiny
from obbbench.harness import detection as DT
from obbbench.harness import flops as FL
from obbbench.harness import runner, spec, synth
from obbbench.reference import ckpt
from obbbench.reference import detect as RD
from obbbench.reference import model as M

CPU = torch.device("cpu")
CELL = "dual_folder_sheets"


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    data = tiny.make(str(tmp_path_factory.mktemp("archs")))
    return spec.load_cell(CELL, spec.ROOT, data)


def checkpoint_models(cfg, root, device, precision):
    """The reference models as they were built before the architecture
    modules: each scale's checkpoint into ``model.build``."""
    return {sc["tile_size"]: M.build(
        ckpt.state_dict(ckpt.load(f"{root}/{sc['checkpoint']}")),
        cfg["model_scale"], cfg["nc"], cfg["channels"],
        device).eval().set_precision(precision) for sc in cfg["scales"]}


def test_config_names_its_module(small):
    assert small.config["model"] == "YOLO11-OBB"
    assert small.arch.__file__ == os.path.join(spec.BENCH_DIR, "archs",
                                               "yolo11_obb.py")


def test_map_flops_as_before(small):
    cfg = small.config
    before = sum(len(synth.tile_grid(640, 640, s["tile_size"], s["overlap"]))
                 * FL.forward_flops(cfg["model_scale"], s["tile_size"],
                                    cfg["nc"], cfg["channels"])
                 for s in cfg["scales"])
    assert DT.map_flops(small, 640, 640) == before == 37944247712.0
    # the real cell: 1,764 + 169 tiles of YOLO11x-OBB a 4096 sheet
    real = spec.load_cell(CELL)
    assert DT.map_flops(real, 4096, 4096) == 28796487003072.0


@pytest.mark.parametrize("precision", ["float32", "fp8"])
def test_reference_models_as_before(small, precision):
    """Every weight and buffer bit-equal, and every layer at the same
    precision, as the checkpoint path built them."""
    cfg = DT.reference_config(small.config)
    got = small.arch.reference_models(cfg, small.root, CPU, precision)
    want = checkpoint_models(cfg, small.root, CPU, precision)
    assert sorted(got) == sorted(want) == [128, 416]
    for ts in want:
        g, w = got[ts].state_dict(), want[ts].state_dict()
        assert list(g) == list(w)
        for k in w:
            assert torch.equal(g[k], w[k]), (ts, k)
        assert [(type(m), getattr(m, "precision", None), m.training)
                for m in got[ts].modules()] == [
            (type(m), getattr(m, "precision", None), m.training)
            for m in want[ts].modules()]


def test_reference_rows_as_before(small):
    """Float32 rows of a map bit-equal to the checkpoint path's. (The fp8
    rows are held by their models above: on the CPU, in a parallel test
    run, two calls of bit-equal fp8 models once gave rows that differed
    by up to 1e-3 px, so the CPU's fp8 path is not reproducible to the
    bit; on the card a 4096 sheet's rows were bit-equal in both
    precisions.)"""
    cfg = DT.reference_config(small.config)
    image = synth.synthetic_map(2 ** 31 + 5, 0, 640, 640, CPU)[0]
    got = RD.detect_map(small.arch.reference_models(
        cfg, small.root, CPU, "float32"), image, cfg, CPU, DT.FLOOR)
    want = RD.detect_map(checkpoint_models(cfg, small.root, CPU, "float32"),
                         image, cfg, CPU, DT.FLOOR)
    assert len(want["merged_for_pr"]) > 10
    for ts in want["by_scale"]:
        np.testing.assert_array_equal(got["by_scale"][ts],
                                      want["by_scale"][ts])
    np.testing.assert_array_equal(got["merged_for_pr"],
                                  want["merged_for_pr"])


STANDIN = '''"""A stand-in architecture: YOLO11-OBB's module, each call recorded."""
import os

from obbbench.harness import spec

BASE = spec.load_module(os.path.join(spec.BENCH_DIR, "archs",
                                     "yolo11_obb.py"))
CALLS = []


def program_detector(cell, device):
    CALLS.append("program_detector")
    return BASE.program_detector(cell, device)


def reference_models(cfg, root, device, precision="float32"):
    CALLS.append("reference_models")
    return BASE.reference_models(cfg, root, device, precision)


def forward_flops(cfg, tile):
    CALLS.append("forward_flops")
    return BASE.forward_flops(cfg, tile)
'''


def _tree(path: str) -> dict:
    """{file: digest} of the files under ``path``, bytecode caches left
    out."""
    out = {}
    for d, dirs, files in os.walk(path):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, path)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _write(path, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(obj if isinstance(obj, str) else json.dumps(obj))


def _standin_cell(tmp: str, source: str):
    """The cell ``standin_sheets`` on the configuration
    ``standin_obb_dual``, whose ``model`` names the architecture
    ``source``, all new files in the directory ``tmp``, at tiny sizes."""
    bench = tiny.merged_bench()
    bench["configs"].append({
        "name": "standin_obb_dual", "source": "https://example.org/standin",
        "file": "obbbench/configs/standin_obb_dual.json", "reduced": [],
        "why": "a stand-in architecture"})
    bench["workloads"].append({
        "name": "standin_sheets", "config": "standin_obb_dual",
        "traffic": "standin_sheets_640", "chips": 1,
        "why": "the stand-in's sheets through detect_stream"})
    for m in bench["end_to_end"]:
        if m["name"] == "detect_mpix_per_s":
            m["workloads"].append("standin_sheets")
    _write(os.path.join(tmp, "BENCHMARK.json"), bench)
    _write(os.path.join(tmp, "archs", "standin_obb.py"), source)
    cfg = spec.read_json(os.path.join(spec.BENCH_DIR, "configs",
                                      "yolo11x_obb_dual_bf16.json"))
    cfg.update(name="standin_obb_dual", model="Standin-OBB")
    _write(os.path.join(tmp, "configs", "standin_obb_dual.json"), cfg)
    wl = spec.read_json(os.path.join(spec.BENCH_DIR, "workloads",
                                     f"{CELL}.json"))
    wl.update(name="standin_sheets", config="standin_obb_dual",
              traffic="standin_sheets_640")
    _write(os.path.join(tmp, "workloads", "standin_sheets.json"), wl)
    _write(os.path.join(tmp, "tiny", "configs", "standin_obb_dual.json"),
           spec.read_json(tiny.tiny_file("configs",
                                         "yolo11x_obb_dual_bf16")))
    _write(os.path.join(tmp, "tiny", "workloads", "standin_sheets.json"),
           {"params": {"height": 640, "width": 640, "pool": 2,
                       "warm_maps": 2}})
    tiny.make(tmp)
    cell = spec.load_cell("standin_sheets", spec.ROOT, tmp)
    assert cell.arch.__file__ == os.path.join(tmp, "archs", "standin_obb.py")
    return cell


def _run(cell):
    return runner.run_cell(cell, 2 ** 31 + 41, 1.0, False, CPU,
                           time.perf_counter(), lambda *a: None)


def test_architecture_added_as_files_runs_a_cell(tmp_path, monkeypatch):
    """An architecture module, a configuration whose ``model`` names it, a
    cell on ``detect_stream`` and their tiny sizes, all new files in a
    directory of the test's own: the cell runs on the CPU, ``correct``,
    through the stand-in's three functions, and no file under
    ``obbbench/`` was added or changed."""
    before = _tree(spec.BENCH_DIR)
    cell = _standin_cell(str(tmp_path), STANDIN)
    arch = cell.arch
    # every call into YOLO11-OBB's module goes through the stand-in
    base_calls = []
    for fn in ("program_detector", "reference_models", "forward_flops"):
        inner = getattr(arch.BASE, fn)
        monkeypatch.setattr(arch.BASE, fn, lambda *a, _f=fn, _i=inner, **k:
                            base_calls.append(_f) or _i(*a, **k))
    arch.CALLS.clear()
    res = _run(cell)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0
    assert sorted(set(arch.CALLS)) == ["forward_flops", "program_detector",
                                       "reference_models"]
    assert base_calls == arch.CALLS
    assert _tree(spec.BENCH_DIR) == before


STANDIN_OWN = '''"""A stand-in architecture whose reference is not YOLO's at its edges:
RTMDet's input (BGR, less the mean, over the std), undone inside a wrapper
around YOLO11-OBB's reference model, and a decode of its own."""
import os

import torch

from obbbench.harness import spec
from obbbench.reference import model as M

BASE = spec.load_module(os.path.join(spec.BENCH_DIR, "archs",
                                     "yolo11_obb.py"))
MEAN = (103.53, 116.28, 123.675)
STD = (57.375, 57.12, 58.395)
CALLS = []
program_detector = BASE.program_detector
forward_flops = BASE.forward_flops


def _stats(device):
    return (torch.tensor(MEAN, device=device).view(1, 3, 1, 1),
            torch.tensor(STD, device=device).view(1, 3, 1, 1))


class Normalised(torch.nn.Module):
    """YOLO11-OBB's reference model on RTMDet's input."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        mean, std = _stats(x.device)
        return self.inner((x * std + mean).flip(1) / 255.0)


def reference_models(cfg, root, device, precision="float32"):
    return {ts: Normalised(m).eval() for ts, m in
            BASE.reference_models(cfg, root, device, precision).items()}


def reference_input(tiles):
    CALLS.append("reference_input")
    mean, std = _stats(tiles.device)
    return (tiles.permute(0, 3, 1, 2).to(torch.float32) - mean) / std


def reference_decode(out, tile):
    CALLS.append("reference_decode")
    return M.decode(out, tile)
'''


def anchors_at_corners(out, tile):
    """YOLO's decode with the anchor points at offset 0 of a cell, not at
    its centre: every box half a stride up and to the left."""
    box, cls = M.flatten_levels(out["box"]), M.flatten_levels(out["cls"])
    ang = M.flatten_levels(out["ang"])[..., 0]
    pts, strides = M.make_anchors(tile, box.device, offset=0.0)
    rb = M.dist2rbox(M.dfl_expectation(box), M.decode_angle(ang), pts[None])
    return (torch.cat([rb[..., :4] * strides[None, :, None], rb[..., 4:]],
                      -1), torch.sigmoid(cls))


def test_architecture_with_its_own_input_and_decode_runs_a_cell(tmp_path):
    """A stand-in whose module defines ``reference_input`` and
    ``reference_decode``, added as files: the cell runs ``correct`` on the
    CPU through both, and no file under ``obbbench/`` was added or
    changed."""
    before = _tree(spec.BENCH_DIR)
    cell = _standin_cell(str(tmp_path), STANDIN_OWN)
    arch = cell.arch
    arch.CALLS.clear()
    res = _run(cell)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0
    assert sorted(set(arch.CALLS)) == ["reference_decode", "reference_input"]
    assert _tree(spec.BENCH_DIR) == before


def test_a_wrong_decode_of_the_architecture_is_not_correct(tmp_path,
                                                           monkeypatch):
    """The same stand-in with its anchors planted at offset 0: the check
    runs the architecture's decode, so the cell is not ``correct``."""
    cell = _standin_cell(str(tmp_path), STANDIN_OWN)
    monkeypatch.setattr(cell.arch, "reference_decode", anchors_at_corners)
    res = _run(cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("given", ["named", "inline"])
def test_default_input_and_decode_are_yolos(small, given):
    """Rows of ``detect_map`` on its defaults bit-equal to the same call
    given YOLO's two functions: by name, and as the arithmetic the
    reference inlined before an architecture could give its own."""
    hooks = {"named": {"reference_input": RD.yolo_input,
                       "reference_decode": M.decode},
             "inline": {"reference_input": lambda t: t.flip(-1).permute(
                 0, 3, 1, 2).to(torch.float32) / 255.0,
                 "reference_decode": lambda out, ts: M.decode(out, ts)}}
    cfg = DT.reference_config(small.config)
    image = synth.synthetic_map(2 ** 31 + 9, 0, 640, 640, CPU)[0]
    models = small.arch.reference_models(cfg, small.root, CPU, "float32")
    got = RD.detect_map(models, image, cfg, CPU, DT.FLOOR)
    want = RD.detect_map(models, image, cfg, CPU, DT.FLOOR, **hooks[given])
    assert len(want["merged_for_pr"]) > 10
    for ts in want["by_scale"]:
        np.testing.assert_array_equal(got["by_scale"][ts],
                                      want["by_scale"][ts])
    np.testing.assert_array_equal(got["merged_for_pr"],
                                  want["merged_for_pr"])


def test_a_missing_tiny_file_is_named(tmp_path):
    bench = tiny.merged_bench()
    bench["workloads"].append({"name": "no_size_cell", "config":
                               "yolo11x_obb_dual_bf16", "traffic": "x",
                               "chips": 1, "why": "no tiny size"})
    _write(str(tmp_path / "BENCHMARK.json"), bench)
    _write(str(tmp_path / "workloads" / "no_size_cell.json"),
           spec.read_json(os.path.join(spec.BENCH_DIR, "workloads",
                                       f"{CELL}.json")))
    with pytest.raises(FileNotFoundError,
                       match="obbbench/tests/tiny/workloads/no_size_cell"):
        tiny.make(str(tmp_path))
