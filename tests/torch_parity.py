"""Helpers shared by the port's parity tests: the row comparison, a
fixture that runs a module's PyTorch work on one intra-op thread, and the
float32 pin of the port's configs for the entry points that name no
dtype."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from oriented_object_detection_tpu_torch import config as C
from oriented_object_detection_tpu_torch.infer import pipeline as P


@dataclasses.dataclass(frozen=True)
class DetectConfig32(C.DetectConfig):
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class TrainConfig32(C.TrainConfig):
    compute_dtype: str = "float32"


# every name through which an entry point builds a config with the default
# dtype: ``cli.py``'s commands import ``TrainConfig`` from ``config`` when
# they run, ``build_detector`` reads ``pipeline.DetectConfig``
_FLOAT32_NAMES = ((C, "DetectConfig", DetectConfig32),
                  (P, "DetectConfig", DetectConfig32),
                  (C, "TrainConfig", TrainConfig32))


@contextlib.contextmanager
def port_float32():
    """The port's configs default to ``compute_dtype="float32"`` inside the
    block: for a test that holds float32 equalities through ``cli.py``,
    which has no dtype flag (the JAX CLI has none either)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, cls in _FLOAT32_NAMES:
            mp.setattr(mod, name, cls)
        yield


def float32_cli_main() -> None:
    """``cli.main`` under ``port_float32``, for a test's CLI subprocess:
    ``python -c 'import torch_parity; torch_parity.float32_cli_main()'
    ARGS`` with ``tests/`` on ``PYTHONPATH``."""
    import sys

    from oriented_object_detection_tpu_torch import cli

    with port_float32():
        cli.main(sys.argv[1:])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module: parallel test workers (six in
    the full run) share the cores, and their spinning thread pools slow
    each other down many times over (a 1 s CPU train step took 60 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def match_one_to_one(got, ref, skip_near=()):
    """Pair every [N, 11] row of ``got`` with one of ``ref``: same class,
    conf within 1e-3, corners within 0.05 px, Strike angle within 0.01
    degree. Rows whose conf lies within 1e-3 of a threshold in
    ``skip_near`` are left out on both sides: the consensus filter may
    keep or drop them on a last-bit difference."""
    def keep(rows):
        near = np.zeros(len(rows), bool)
        for t in skip_near:
            near |= np.abs(rows[:, 9] - t) < 1e-3
        return rows[~near]

    got, ref = keep(got), keep(ref)
    assert got.shape == ref.shape
    used = np.zeros(len(ref), bool)
    for r in got:
        ok = (~used & (ref[:, 8] == r[8]) & (np.abs(ref[:, 9] - r[9]) <= 1e-3)
              & (np.abs(ref[:, :8] - r[:8]).max(1) <= 0.05))
        assert ok.any(), f"no JAX partner for {r.tolist()}"
        used[np.flatnonzero(ok)[0]] = True
    np.testing.assert_allclose(got[:, 10], ref[:, 10], atol=1e-2)
