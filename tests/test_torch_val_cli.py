"""``validate_tiles`` and the port's ``train`` and ``val`` commands on the
CPU: one epoch of ``cli train --device cpu`` on a tiny seeded `gen_map`
dataset (warm-started from the committed ``train128.ckpt``) writes
``last.ckpt``, ``best.ckpt`` and ``results.csv``; the port's fitness on
the same weights and val tiles is the JAX package's, and ``cli val`` on the
port's checkpoint prints the JAX ``val``'s mAPs."""

import csv
import os
import re
import sys

import jax
import numpy as np
import pytest

from oriented_object_detection_tpu import cli as jax_cli
from oriented_object_detection_tpu.config import TrainConfig as JaxCfg
from oriented_object_detection_tpu.data.loader import TileDataset as JaxDS
from oriented_object_detection_tpu.eval.val import validate_tiles as jax_val
from oriented_object_detection_tpu.models import YOLO11OBB as JaxModel
from oriented_object_detection_tpu.train.trainer import load_checkpoint
from oriented_object_detection_tpu_torch import cli
from oriented_object_detection_tpu_torch.config import TrainConfig
from oriented_object_detection_tpu_torch.data import labels as TL
from oriented_object_detection_tpu_torch.data.loader import TileDataset
from oriented_object_detection_tpu_torch.eval.val import validate_tiles
from oriented_object_detection_tpu_torch.models import weights as TW
from oriented_object_detection_tpu_torch.models.yolo11_obb import YOLO11OBB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "bench_ckpts", "train128.ckpt")
sys.path.insert(0, REPO)
from tools.train_synthetic import gen_map  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

cv2 = pytest.importorskip("cv2")
TS = 64


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A two-map train split and a one-map val split, then one epoch of the
    port's ``train`` on the CPU."""
    root = tmp_path_factory.mktemp("ds")
    rng = np.random.RandomState(3)
    for split, n, size in (("train", 2, 160), ("val", 1, 192)):
        os.makedirs(root / "images" / split)
        os.makedirs(root / "labels" / split)
        for k in range(n):
            img, lab = gen_map(rng, H=size, W=size, n_obj=12)
            cv2.imwrite(str(root / "images" / split / f"m{k}.png"), img)
            TL.write_labels(str(root / "labels" / split / f"m{k}.txt"), lab)
    run_dir = root / "run"
    state = cli.main(["train", "--data-root", str(root), "--tile-size",
                      str(TS), "--overlap", "0", "--epochs", "1",
                      "--batch-size", "4", "--scale", "n",
                      "--skip-augmentation", "--init-ckpt", CKPT,
                      "--ckpt-dir", str(run_dir), "--device", "cpu"])
    return root, run_dir, state


def test_cli_train_writes_checkpoints_and_results(run):
    root, run_dir, state = run
    for f in ("last.ckpt", "best.ckpt", "results.csv"):
        assert (run_dir / f).exists(), f
    with open(run_dir / "results.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    for k in ("loss", "box", "cls", "dfl", "fitness", "lr"):
        assert np.isfinite(float(rows[0][k])), k
    assert state.step > 0
    ck = load_checkpoint(str(run_dir / "last.ckpt"))
    assert ck["step"] == state.step
    assert ck["extra"]["model_scale"] == "n"
    assert ck["extra"]["tile_size"] == TS and ck["extra"]["channels"] == 3
    assert int(ck["extra"]["epoch"]) == 0


def test_validate_tiles_matches_jax(run):
    """The committed weights over the val tiles of the build."""
    root = run[0]
    vlist = str(root / f"val_cropped{TS}.txt")
    v = TW.variables_from_checkpoint(CKPT)
    model = YOLO11OBB(nc=12, scale="n")
    TW.load_state(model, TW.torch_state_from_jax(v))
    fit, comps = validate_tiles(model.eval(), TileDataset(
        vlist, TS, 3, device="cpu"), TrainConfig(tile_size=TS),
        batch_size=4, return_components=True)

    class _State:
        params = ema_params = v["params"]
        batch_stats = v["batch_stats"]

    with jax.enable_x64(False):
        ref, rcomps = jax_val(JaxModel(nc=12, scale="n"), _State,
                              JaxDS(vlist, TS, 3),
                              JaxCfg(tile_size=TS, model_scale="n"),
                              batch_size=4, return_components=True)
    assert comps["n_tiles"] == rcomps["n_tiles"] > 0
    assert rcomps["mAP@0.5"] > 0.1
    np.testing.assert_allclose(fit, ref, rtol=0, atol=1e-6)
    for k in ("mAP@0.5", "mAP@[0.5:0.95]"):
        np.testing.assert_allclose(comps[k], rcomps[k], rtol=0, atol=1e-6)


def test_cli_val_prints_the_jax_maps(run, capsys):
    root, run_dir = run[:2]
    argv = ["val", "--ckpt", str(run_dir / "last.ckpt"), "--data-root",
            str(root), "--batch-size", "4"]
    got = cli.main(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    with jax.enable_x64(False):
        ref = jax_cli.main(argv)
    jax_out = capsys.readouterr().out
    line = lambda out: re.search(r"\[VAL\] mAP@0\.5=.*", out).group(0)
    assert line(port_out) == line(jax_out)
    np.testing.assert_allclose(got["fitness"], ref["fitness"], rtol=0,
                               atol=1e-6)
