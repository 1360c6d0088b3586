"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole: the program's name begins with the JAX package's), and the
reference imports nothing of the program."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

import tiny
from obbbench.harness import spec

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
