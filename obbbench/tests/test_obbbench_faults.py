"""A run with its timed path broken underneath comes out not correct: the
rest of a run (the look for a card skipped, small cells on the CPU) with
each fault a cell can have planted in the program."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import pytest
import torch

import tiny
from obbbench.harness import runner, spec

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("faults")))


def run(data, name, seconds=1.0):
    cell = spec.load_cell(name, spec.ROOT, data)
    return runner.run_cell(cell, 2 ** 31 + 99, seconds, False, CPU,
                           time.perf_counter(), lambda *a: None)


@contextlib.contextmanager
def patched(obj, name, make):
    inner = getattr(obj, name)
    setattr(obj, name, make(inner))
    try:
        yield
    finally:
        setattr(obj, name, inner)


def stale_answer(inner):
    """Each call returns the previous call's answers: the state of the
    detector never moves on."""
    last = {}

    def fn(self, fetched, n):
        out = inner(self, fetched, n)
        prev = last.get("out", out)
        last["out"] = out
        return prev if len(prev) == len(out) else out
    return fn


def half_tiles(inner):
    """The second half of each forward's tiles is left out."""
    def fn(self, tiles, grid_t, first, ts):
        rows = inner(self, tiles, grid_t, first, ts)
        rows[len(rows) // 2:, :, 11] = 0.0
        return rows
    return fn


def altered_answer(inner):
    """Every row's class is changed where the rows are produced."""
    def fn(self, tiles, grid_t, first, ts):
        rows = inner(self, tiles, grid_t, first, ts)
        rows[..., 8] = torch.remainder(rows[..., 8] + 1, 12)
        return rows
    return fn


def detector_faults():
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        TiledDetector as T)

    return {"stale_answer": (T, "_split_and_finalize", stale_answer),
            "half_tiles": (T, "_tile_rows", half_tiles),
            "altered_answer": (T, "_tile_rows", altered_answer)}


@pytest.mark.parametrize("name", ["dual_single_maps", "dual_folder_sheets"])
@pytest.mark.parametrize("fault", ["stale_answer", "half_tiles",
                                   "altered_answer"])
def test_detection_fault_is_not_correct(data, name, fault):
    obj, attr, make = detector_faults()[fault]
    with patched(obj, attr, make):
        res = run(data, name)
    assert res["correct"] is False, res["checks"]


def unchanged_state(inner):
    """The step computes but leaves parameters, momentum and EMA as they
    were."""
    def fn(state, batch, cfg):
        keep = [p.detach().clone() for p in state.model.parameters()]
        ema = [e.detach().clone() for e in state.ema_shards]
        m = inner(state, batch, cfg)
        with torch.no_grad():
            for p, k in zip(state.model.parameters(), keep):
                p.copy_(k)
            for e, k in zip(state.ema_shards, ema):
                e.copy_(k)
        return m
    return fn


def half_batch(inner):
    """Half of each batch is left out; the loss's mean is over the rest."""
    def fn(state, batch, cfg):
        return inner(state, {k: v[:len(v) // 2] for k, v in batch.items()},
                     cfg)
    return fn


@pytest.mark.parametrize("fault", [unchanged_state, half_batch])
def test_training_fault_is_not_correct(data, fault):
    from oriented_object_detection_tpu_torch.train import trainer as TRN

    with patched(TRN, "train_step", fault):
        res = run(data, "train416_b16", 0.5)
    assert res["correct"] is False, res["checks"]


def test_sound_runs_are_correct(data):
    for name in ("dual_single_maps", "train416_b16"):
        res = run(data, name, 0.5)
        assert res["correct"] is True, (name, res["checks"])
        assert list(res)[-1] == "checks"
        assert np.isfinite([c["value"] for c in res["checks"].values()]).all()
