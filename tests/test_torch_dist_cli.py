"""The port's ``train``, ``val`` and ``detect`` with ``--dist --device cpu``
in two gloo processes, launched as separate commands through the JAX
package's flags (``--coordinator/--num-processes/--process-id``) and
through torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), against the same commands in one
process. Each process gets its own ``--ckpt-dir``/``--output``: process 0
alone writes them, and builds the dataset. Every command runs with the
port's configs pinned to float32 (``torch_parity.port_float32``), where the
bounds below hold."""

import csv
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

from oriented_object_detection_tpu.utils.xlsx import read_xlsx
from oriented_object_detection_tpu_torch import cli
from oriented_object_detection_tpu_torch.data import labels as TL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "bench_ckpts", "train128.ckpt")
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
from tools.train_synthetic import gen_map  # noqa: E402
from torch_parity import one_torch_thread, port_float32  # noqa: E402,F401

cv2 = pytest.importorskip("cv2")
TS, WORLD = 64, 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_two(argv_of, via: str) -> list:
    """The port's CLI (``torch_parity.float32_cli_main``) once per process
    with ``argv_of(rank)``, joined
    through the flags or torchrun's environment; retried on a port-bind
    race. Returns each process's output."""
    for attempt in range(3):
        port = _free_port()
        procs = []
        for r in range(WORLD):
            env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
            env["OMP_NUM_THREADS"] = "1"
            env["PYTHONPATH"] = os.pathsep.join(
                [os.path.join(REPO, "tests"), env.get("PYTHONPATH", "")])
            argv = argv_of(r) + ["--dist", "--device", "cpu"]
            if via == "flags":
                argv += ["--coordinator", f"localhost:{port}",
                         "--num-processes", str(WORLD), "--process-id",
                         str(r)]
            else:
                env.update(RANK=str(r), LOCAL_RANK=str(r),
                           WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost",
                           MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import torch_parity; "
                 "torch_parity.float32_cli_main()"] + argv, env=env,
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=240)[0].decode(
                    errors="replace"))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                pytest.fail("distributed commands timed out")
        if all(p.returncode == 0 for p in procs):
            return logs
        if attempt == 2 or not any("Address already in use" in log
                                   for log in logs):
            for p, log in zip(procs, logs):
                assert p.returncode == 0, log[-3000:]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A two-map train split, a one-map val split and a detect input folder
    (the val map with its labels)."""
    root = tmp_path_factory.mktemp("ds")
    rng = np.random.RandomState(3)
    for split, n, size in (("train", 2, 160), ("val", 1, 192)):
        os.makedirs(root / "images" / split)
        os.makedirs(root / "labels" / split)
        for k in range(n):
            img, lab = gen_map(rng, H=size, W=size, n_obj=12)
            cv2.imwrite(str(root / "images" / split / f"m{k}.png"), img)
            TL.write_labels(str(root / "labels" / split / f"m{k}.txt"), lab)
    os.makedirs(root / "in")
    img, lab = gen_map(rng, H=260, W=300, n_obj=14)
    cv2.imwrite(str(root / "in" / "t0.png"), img)
    TL.write_labels(str(root / "in" / "t0.txt"), lab)
    return root


def _train_argv(root, ckpt_dir) -> list:
    return ["train", "--data-root", str(root), "--tile-size", str(TS),
            "--overlap", "0", "--epochs", "1", "--batch-size", "4",
            "--scale", "n", "--skip-augmentation", "--init-ckpt", CKPT,
            "--ckpt-dir", str(ckpt_dir)]


@pytest.fixture(scope="module")
def trained(data):
    logs = _run_two(lambda r: _train_argv(data, data / f"run{r}"), "flags")
    return logs


def test_train_dist_builds_and_writes_from_process_0(data, trained):
    assert "AUTO keep_fraction" in trained[0]
    assert "AUTO keep_fraction" not in trained[1]
    assert "[TRAIN]" not in trained[1] and "epoch 0 step" not in trained[1]
    assert not (data / "run1").exists()
    files = set(os.listdir(data / "run0"))
    assert {"best.ckpt", "last.ckpt", "results.csv", "args.yaml"} <= files
    # the same epoch in one process, on the tiles process 0 built
    with port_float32():
        cli.main(_train_argv(data, data / "one") + ["--skip-cropping",
                                                    "--device", "cpu"])
    rows = []
    for d in ("run0", "one"):
        with open(data / d / "results.csv") as f:
            rows.append(next(csv.DictReader(f)))
    for k in ("loss", "box", "cls", "dfl"):
        np.testing.assert_allclose(float(rows[0][k]), float(rows[1][k]),
                                   rtol=1e-4, err_msg=k)


def test_val_dist_through_torchrun_env(data, trained, capsys):
    argv = ["val", "--ckpt", str(data / "run0" / "last.ckpt"), "--data-root",
            str(data), "--batch-size", "3"]
    logs = _run_two(lambda r: argv, "env")
    with port_float32():
        cli.main(argv + ["--device", "cpu"])
    one = capsys.readouterr().out
    line = lambda out: re.search(r"\[VAL\] mAP@0\.5=.*", out).group(0)
    assert line(logs[0]) == line(one)
    assert "[VAL]" not in logs[1]


@pytest.mark.parametrize("via", ["flags", "env"])
def test_detect_dist_writes_once_and_matches_one_process(data, via):
    argv = ["detect", "--input", str(data / "in"), "--scales",
            f"128:30={CKPT}", "--metrics"]
    out = data / f"det_{via}"
    logs = _run_two(lambda r: argv + ["--output", f"{out}{r}"], via)
    assert "Results saved for t0.png" in logs[0]
    assert "[detect] --dist implies --batch" in logs[0]
    assert "Results saved" not in logs[1]
    assert not os.path.exists(f"{out}1")
    got = set(os.listdir(f"{out}0"))
    assert {"t0_detected.jpg", "t0.xlsx",
            "fusion_classwise_metrics.xlsx"} <= got
    one = data / "det_one"
    if not one.exists():
        with port_float32():
            cli.main(argv + ["--output", str(one), "--batch", "--device",
                             "cpu"])
    a, b = (np.asarray([r[1:] for r in read_xlsx(str(d / "t0.xlsx"))[1:]],
                       np.float64) for d in (one, out.with_name(
                           out.name + "0")))
    assert a.shape == b.shape and len(a) > 0
    np.testing.assert_allclose(b[:, 8], a[:, 8], rtol=0, atol=1e-5)
    np.testing.assert_allclose(b[:, :8], a[:, :8], rtol=0, atol=1e-3)
