"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole: the program's name begins with the JAX package's), a run that loads
one gives no result, and the reference, also as each architecture module
hands it out, imports nothing of the program."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys
import time

import pytest
import torch

import tiny
from obbbench.harness import runner, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "oriented_object_detection_tpu"}
PROGRAM = "oriented_object_detection_tpu_torch"


def _run(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=spec.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split()[-1].split(","))


def test_a_run_loads_no_jax(tmp_path):
    data = tiny.make(str(tmp_path))
    code = f"""
import sys, time
sys.path.insert(0, {spec.ROOT!r})
import torch
from obbbench.harness import runner, spec
for name in ("dual_single_maps", "train416_b16"):
    cell = spec.load_cell(name, {spec.ROOT!r}, {data!r})
    runner.run_cell(cell, 11, 0.5, False, torch.device("cpu"),
                    time.perf_counter(), lambda *a: None)
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    top = _run(code)
    assert PROGRAM in top
    assert not top & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(spec.BENCH_DIR, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {PROGRAM}, (path, n)
    code = f"""
import sys
sys.path.insert(0, {spec.ROOT!r})
import obbbench.reference.ckpt, obbbench.reference.model
import obbbench.reference.merge, obbbench.reference.detect
import obbbench.reference.train
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    top = _run(code)
    assert not top & (FORBIDDEN | {PROGRAM})


ARCHS = sorted(glob.glob(os.path.join(spec.BENCH_DIR, "archs", "*.py")))


@pytest.mark.parametrize("path", ARCHS, ids=os.path.basename)
def test_an_architecture_hands_out_a_reference_free_of_the_program(
        tmp_path, path):
    """Each architecture's ``reference_models`` and ``forward_flops``, on
    every configuration of a detection cell that names it, at its tiny
    size, in a fresh process: nothing of the program or of JAX is
    loaded."""
    data = tiny.make(str(tmp_path))
    arch = os.path.basename(path)[:-len(".py")]
    configs = sorted({
        os.path.join(data, "configs", f"{w['config']}.json")
        for w in tiny.merged_bench()["workloads"]
        if spec.read_json(os.path.join(data, "workloads", f"{w['name']}.json")
                          )["driver"].startswith("detect")})
    configs = [p for p in configs if spec.read_json(p)["model"].lower()
               .replace("-", "_") == arch]
    assert configs, f"no configuration names {arch}"
    code = f"""
import sys
sys.path.insert(0, {spec.ROOT!r})
import torch
from obbbench.harness import spec
arch = spec.load_module({path!r})
for path in {configs!r}:
    cfg = spec.read_json(path)
    models = arch.reference_models(cfg, {spec.ROOT!r}, torch.device("cpu"))
    assert sorted(models) == sorted(s["tile_size"] for s in cfg["scales"])
    assert all(arch.forward_flops(cfg, t) > 0 for t in models)
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    top = _run(code)
    assert not top & (FORBIDDEN | {PROGRAM})


STANDINS = {
    # the configuration's architecture, whose reference is built after the
    # window
    "reference_models": ("archs", "yolo11_obb", """import os
import sys
import types

from obbbench.harness import spec

BASE = spec.load_module(os.path.join(spec.BENCH_DIR, "archs",
                                     "yolo11_obb.py"))
program_detector = BASE.program_detector
forward_flops = BASE.forward_flops


def reference_models(cfg, root, device, precision="float32"):
    sys.modules.setdefault("jax", types.ModuleType("jax"))
    return BASE.reference_models(cfg, root, device, precision)
"""),
    # an end-to-end metric, loaded and read after the window
    "metric": ("end_to_end", "detect_mpix_per_s", """import sys
import types

sys.modules.setdefault("jax", types.ModuleType("jax"))


def value(record, cell):
    return 1.0
"""),
}


@pytest.mark.parametrize("where", sorted(STANDINS))
def test_jax_loaded_after_the_window_gives_no_result(tmp_path, where):
    """A module of JAX that code run after the window loads (the
    architecture's reference, a metric module) stops the run with its name
    and no result."""
    group, name, source = STANDINS[where]
    data = tiny.make(str(tmp_path))
    os.makedirs(os.path.join(data, group))
    with open(os.path.join(data, group, f"{name}.py"), "w") as f:
        f.write(source)
    cell = spec.load_cell("dual_folder_sheets", spec.ROOT, data)
    assert "jax" not in sys.modules
    try:
        with pytest.raises(SystemExit, match="jax"):
            runner.run_cell(cell, 2 ** 31 + 17, 0.5, False,
                            torch.device("cpu"), time.perf_counter(),
                            lambda *a: None)
        assert "jax" in sys.modules
    finally:
        sys.modules.pop("jax", None)
