"""The control, the reference computed in fp8 in the program's place (the
next precision below the configuration's bf16), fails the cell's limits;
at a size the CPU holds (the chip's readings at the cells' own sizes are
in PERF.md)."""

from __future__ import annotations

import pytest
import torch

import tiny
from obbbench.harness import spec

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("control")))


@pytest.mark.parametrize("name", ["dual_single_maps", "train416_b16"])
def test_fp8_control_is_not_correct(data, name):
    cell = spec.load_cell(name, spec.ROOT, data)
    drv = cell.driver
    sess = drv.setup(cell, 2 ** 32 + 3, CPU)
    drv.window(sess, 0.0, 4)
    drv.release(sess)
    got = drv.readings(sess, drv.reference(sess, "fp8"))
    limits = cell.workload["limits"]
    assert any(got[k] > lim for k, lim in limits.items()), (got, limits)


@pytest.mark.card
def test_cells_run_on_the_card():
    """Each cell of BENCHMARK.json, its whole run with a short window, on
    the card (skips here)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import os
    import subprocess
    import sys

    bench = spec.read_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    for name in [w["name"] for w in bench["workloads"]]:
        out = subprocess.run(
            [sys.executable, "obbbench/run.py", "--workload", name, "--seed",
             "2147483659", "--seconds", "2", "--trace", "0"],
            cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        assert '"correct": true' in out.stdout.splitlines()[-1]
