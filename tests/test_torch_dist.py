"""The port's data parallelism (``parallel/``, ``--dist``) in two gloo
processes on the CPU (``tests/torch_dist_worker.py``, one launch for the
file), held to one process on the whole global batch:

* BatchNorm in training mode on a split batch: output, input and parameter
  gradients and running statistics against one process on the whole batch
  (within 1e-6) and against flax's ``nn.BatchNorm`` (within 1e-5), with one
  all-reduce a layer forward and one backward;
* one train step of YOLO11n-OBB at tile 64 from ``train128.ckpt`` (one row
  a process of a global batch of two) against the JAX package's
  single-process ``make_train_step`` on the global batch, within
  ``test_torch_train.py``'s bounds (loss 1e-5; parameters, EMA and BN
  statistics 1e-4; momentum 1e-3), and the two processes' states equal bit
  for bit;
* ``fit`` for one epoch of two steps: process 0 alone writes the run
  directory, the processes end bit-equal and near a one-process ``fit``,
  and a state that differs on one process is refused at the start;
* ``validate_tiles(shard_across_processes=True)`` against unsharded;
* ``detect_images`` and ``detect_stream`` rows, 3 and 4 channels, against
  one process;
* a global batch the processes do not divide raises ``SystemExit``.
"""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oriented_object_detection_tpu.config import TrainConfig as JaxCfg
from oriented_object_detection_tpu.models import YOLO11OBB as JaxModel
from oriented_object_detection_tpu.train import trainer as JT
from oriented_object_detection_tpu.train.loss import LossConfig as JaxLoss
from oriented_object_detection_tpu_torch.config import TrainConfig
from oriented_object_detection_tpu_torch.data import labels as TL
from oriented_object_detection_tpu_torch.data.loader import TileDataset
from oriented_object_detection_tpu_torch.eval.val import validate_tiles
from oriented_object_detection_tpu_torch.infer.pipeline import build_detector
from oriented_object_detection_tpu_torch.models import layers as TLY
from oriented_object_detection_tpu_torch.models import weights as TW
from oriented_object_detection_tpu_torch.ops import geometry as G
from oriented_object_detection_tpu_torch.train import trainer as TT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "bench_ckpts", "train128.ckpt")
CKPT4 = os.path.join(REPO, "assets", "bench_ckpts", "train416_4ch.ckpt")
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
from tools.train_synthetic import gen_map  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

TS, B, M, WORLD = 64, 2, 16, 2
# float32, as the JAX step it is held to (the port's default is bf16)
STEP_CFG = dict(tile_size=TS, batch_size=B, model_scale="n", epochs=3,
                compute_dtype="float32")
FIT_CFG = dict(tile_size=TS, batch_size=4, model_scale="n", epochs=1,
               compute_dtype="float32")


def _max_rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(a)).max(), 1e-6))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _assert_trees_close(got, ref, rtol):
    n = 0
    for path, r in _leaves(jax.tree.map(np.asarray, ref)):
        g = _get(got, path)
        assert g.shape == r.shape, path
        assert _max_rel(r, g) <= rtol, (path, _max_rel(r, g))
        n += 1
    assert n > 100


def _assert_trees_equal(a, b):
    for path, x in _leaves(a):
        np.testing.assert_array_equal(x, _get(b, path), err_msg=str(path))


def _step_batch():
    """Two 64 tiles of one seeded map with their boxes in pixels (the batch
    of ``test_torch_train.py``)."""
    img, lab = gen_map(np.random.RandomState(1), H=TS, W=TS * B, n_obj=8)
    imgs = np.stack([img[:, i * TS:(i + 1) * TS]
                     for i in range(B)]).astype(np.float32) / 255.0
    lab[:, 1::2] *= TS * B
    lab[:, 2::2] *= TS
    gl = np.zeros((B, M), np.int32)
    gm = np.zeros((B, M), bool)
    gb = np.zeros((B, M, 5), np.float32)
    for i in range(B):
        cx = lab[:, 1::2].mean(1)
        sel = lab[(cx >= i * TS) & (cx < (i + 1) * TS)]
        c8 = sel[:, 1:].copy()
        c8[:, 0::2] -= i * TS
        gl[i, :len(sel)] = sel[:, 0]
        gm[i, :len(sel)] = True
        gb[i, :len(sel)] = G.corners8_to_xywhr_np(c8)
    assert gm.sum(1).min() > 0
    return imgs, gl, gb, gm


def _tiles(root):
    """Eight 64 tiles of two seeded maps with their label files and list."""
    os.makedirs(root / "images" / "t", exist_ok=True)
    os.makedirs(root / "labels" / "t", exist_ok=True)
    pixels = {}
    for m in range(2):
        img, lab = gen_map(np.random.RandomState(20 + m), H=TS * 2,
                           W=TS * 2, n_obj=10)
        for t in range(4):
            y, x = divmod(t, 2)
            tile = img[y * TS:(y + 1) * TS, x * TS:(x + 1) * TS]
            c8 = lab[:, 1:] * (TS * 2)
            c8[:, 0::2] -= x * TS
            c8[:, 1::2] -= y * TS
            cx, cy = c8[:, 0::2].mean(1), c8[:, 1::2].mean(1)
            keep = (cx >= 0) & (cx < TS) & (cy >= 0) & (cy < TS)
            path = str(root / "images" / "t" / f"m{m}_{t}.png")
            TL.write_labels(path.replace("images", "labels")[:-4] + ".txt",
                            np.concatenate([lab[keep, :1],
                                            c8[keep] / TS], axis=1))
            pixels[path] = np.ascontiguousarray(tile[..., ::-1])
    lst = str(root / "list.txt")
    with open(lst, "w") as f:
        f.write("\n".join(pixels) + "\n")
    return lst, pixels


def _start(inp: str, outs: list) -> list:
    """The two worker processes, started on a free port."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    return [subprocess.Popen(
        [sys.executable, WORKER, f"localhost:{port}", str(WORLD), str(r),
         inp, outs[r]], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(WORLD)]


def _wait(procs: list) -> tuple:
    """(all exited 0, their logs); kills both on a timeout."""
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0].decode(
                errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out")
    return all(p.returncode == 0 for p in procs), logs


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    rng = np.random.RandomState(0)
    weights = TW.variables_from_checkpoint(CKPT)
    lst, pixels = _tiles(root / "tiles")
    maps = [gen_map(np.random.RandomState(30 + i), H=h, W=w, n_obj=12)[0]
            for i, (h, w) in enumerate(((250, 300), (300, 180)))]
    mrng = np.random.RandomState(5)
    imgs, gl, gb, gm = _step_batch()
    return {
        "root": root,
        "x": (rng.randn(4, 16, 3, 3) * 3 + 1).astype(np.float32),
        "w": rng.randn(4, 16, 3, 3).astype(np.float32),
        "scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
        "bias": rng.randn(16).astype(np.float32),
        "mean": rng.randn(16).astype(np.float32),
        "var": rng.uniform(0.5, 2, 16).astype(np.float32),
        "cfg": STEP_CFG, "fit_cfg": FIT_CFG, "weights": weights,
        "mom": jax.tree.map(lambda a: (mrng.randn(*a.shape) * 1e-3).astype(
            np.float32), weights["params"]),
        "batch": {"images": imgs.transpose(0, 3, 1, 2).copy(),
                  "gt_labels": gl.astype(np.int64), "gt_xywhr": gb,
                  "gt_mask": gm},
        "list": lst, "pixels": pixels, "run_root": str(root / "runs"),
        "ckpt128": CKPT, "ckpt4ch": CKPT4, "maps": maps, "odd_batch": 3,
    }


@pytest.fixture(scope="module")
def started(inputs):
    """The workers, started before the JAX reference step compiles."""
    inp = str(inputs["root"] / "in.pkl")
    with open(inp, "wb") as f:
        pickle.dump({k: v for k, v in inputs.items() if k != "root"}, f)
    outs = [str(inputs["root"] / f"out{r}.pkl") for r in range(WORLD)]
    return inp, outs, _start(inp, outs)


@pytest.fixture(scope="module")
def jax_step(inputs, started):
    """The JAX package's one-process step on the global batch of two, from
    the same weights, momentum and step."""
    weights, mom, b = inputs["weights"], inputs["mom"], inputs["batch"]
    jcfg = dataclasses.replace(JaxCfg(), tile_size=TS, batch_size=B,
                               model_scale="n", compute_dtype="float32",
                               epochs=3)
    sched = TT.make_sched_vector(TrainConfig(**STEP_CFG), 4)
    with jax.enable_x64(False):
        state = JT.TrainState(
            step=jnp.asarray(2, jnp.int32),
            params=jax.tree.map(jnp.asarray, weights["params"]),
            batch_stats=jax.tree.map(jnp.asarray, weights["batch_stats"]),
            opt_state=jax.tree.map(jnp.asarray, mom),
            ema_params=jax.tree.map(jnp.array, weights["params"]),
            sched=jnp.asarray(sched))
        step_fn = JT.make_train_step(JaxModel(nc=12, scale="n"), None, jcfg,
                                     JaxLoss(nc=12, img_size=TS))
        new, metrics = step_fn(state, {
            "images": jnp.asarray(b["images"].transpose(0, 2, 3, 1)),
            "gt_labels": jnp.asarray(b["gt_labels"].astype(np.int32)),
            "gt_xywhr": jnp.asarray(b["gt_xywhr"]),
            "gt_mask": jnp.asarray(b["gt_mask"])})
        return jax.tree.map(np.asarray, (new, metrics))


@pytest.fixture(scope="module")
def ranks(started, jax_step):
    """The workers' results, per rank (relaunched on a port-bind race)."""
    inp, outs, procs = started
    for attempt in range(3):
        ok, logs = _wait(procs)
        if ok:
            break
        if attempt == 2 or not any("Address already in use" in log
                                   for log in logs):
            for p, log in zip(procs, logs):
                assert p.returncode == 0, log[-3000:]
        procs = _start(inp, outs)
    res = []
    for o in outs:
        with open(o, "rb") as f:
            res.append(pickle.load(f))
    return res


def test_group_is_gloo_on_the_cpu(ranks):
    for r, res in enumerate(ranks):
        assert (res["rank"], res["world"]) == (r, WORLD)
        assert res["backend"] == "gloo" and res["device"] == "cpu"


def _bn_reference(d):
    layer = TLY.BatchNorm(16)
    with torch.no_grad():
        for t, k in ((layer.weight, "scale"), (layer.bias, "bias"),
                     (layer.running_mean, "mean"), (layer.running_var, "var")):
            t.copy_(torch.from_numpy(d[k]))
    x = torch.from_numpy(d["x"]).requires_grad_(True)
    y = layer.train()(x)
    (y * torch.from_numpy(d["w"])).sum().backward()
    return layer, x, y


def test_batchnorm_split_batch_matches_one_process_and_flax(inputs, ranks):
    layer, x, y = _bn_reference(inputs)
    got_y = np.concatenate([r["bn"]["y"] for r in ranks])
    np.testing.assert_allclose(got_y, y.detach().numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        np.concatenate([r["bn"]["x_grad"] for r in ranks]), x.grad.numpy(),
        rtol=0, atol=1e-6)
    for r in ranks:
        assert r["bn"]["all_reduces"] == 2   # forward and backward
        for k, ref in (("weight_grad", layer.weight.grad),
                       ("bias_grad", layer.bias.grad),
                       ("running_mean", layer.running_mean),
                       ("running_var", layer.running_var)):
            np.testing.assert_allclose(r["bn"][k], ref.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    bn = fnn.BatchNorm(use_running_average=False, epsilon=1e-3,
                       momentum=0.97)
    with jax.enable_x64(False):
        fy, upd = bn.apply(
            {"params": {"scale": inputs["scale"], "bias": inputs["bias"]},
             "batch_stats": {"mean": inputs["mean"], "var": inputs["var"]}},
            inputs["x"].transpose(0, 2, 3, 1), mutable=["batch_stats"])
    np.testing.assert_allclose(got_y.transpose(0, 2, 3, 1), np.asarray(fy),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ranks[0]["bn"]["running_mean"],
                               upd["batch_stats"]["mean"], rtol=1e-6)
    np.testing.assert_allclose(ranks[0]["bn"]["running_var"],
                               upd["batch_stats"]["var"], rtol=1e-5)


def test_two_process_step_matches_jax_global_batch(ranks, jax_step):
    """The JAX package's one-process step on the global batch of two; the
    port's two processes each step on one row."""
    new, metrics = jax_step
    got = ranks[0]["step"]["metrics"]
    assert got[4] == metrics[4] > 0                     # fg count
    np.testing.assert_allclose(got[:4], metrics[:4], rtol=1e-5)
    out = ranks[0]["step"]["payload"]
    assert out["step"] == int(new.step) == 3
    _assert_trees_close(out["params"], new.params, 1e-4)
    _assert_trees_close(out["ema_params"], new.ema_params, 1e-4)
    _assert_trees_close(out["batch_stats"], new.batch_stats, 1e-4)
    _assert_trees_close(out["opt_state"], new.opt_state, 1e-3)
    np.testing.assert_array_equal(ranks[1]["step"]["metrics"], got)
    for key in ("params", "ema_params", "batch_stats", "opt_state"):
        _assert_trees_equal(ranks[1]["step"]["payload"][key], out[key])
    # two all-reduces a BatchNorm layer, the loss normaliser, the gradient
    # bucket and the metrics
    n_bn = sum(isinstance(m, TLY.BatchNorm) for m in TT.create_train_state(
        TrainConfig(**STEP_CFG), 1, device="cpu").model.modules())
    assert ranks[0]["step"]["collectives"] == 2 * n_bn + 3


def _one_process_fit(inputs, tmp_path):
    cfg = TrainConfig(**FIT_CFG)
    ds = TileDataset(inputs["list"], TS, device="cpu",
                     reader=inputs["pixels"].__getitem__)
    st = TT.create_train_state(cfg, len(ds) // cfg.batch_size, device="cpu")
    rng = np.random.RandomState(cfg.seed)
    TT.fit(st, cfg, lambda e: ds.batches(cfg.batch_size, rng),
           val_fn=lambda s: validate_tiles(s.eval_model(), ds, cfg),
           ckpt_dir=str(tmp_path / "one"), init_ckpt=CKPT)
    return st


def test_fit_writes_from_process_0_only(inputs, ranks, tmp_path):
    run_root = inputs["root"] / "runs"
    files = set(os.listdir(run_root / "rank0"))
    assert {"best.ckpt", "last.ckpt", "results.csv", "args.yaml"} <= files
    assert not (run_root / "rank1").exists()
    assert not any(n.endswith("_bad") for n in os.listdir(run_root))
    np.testing.assert_array_equal(ranks[0]["fit"]["checksums"],
                                  ranks[1]["fit"]["checksums"])
    assert ranks[0]["fit"]["fitness"] == ranks[1]["fit"]["fitness"]
    for r in ranks:
        assert "differs between process 0 and process 1" in \
            r["fit"]["refused"]
    st = _one_process_fit(inputs, tmp_path)
    one = TT.checkpoint_payload(st)
    assert ranks[0]["fit"]["payload"]["step"] == one["step"] == 2
    for key in ("params", "ema_params", "batch_stats"):
        _assert_trees_close(ranks[0]["fit"]["payload"][key], one[key], 1e-4)


def test_sharded_validation_matches_unsharded(inputs, ranks):
    cfg = TrainConfig(**FIT_CFG)
    ds = TileDataset(inputs["list"], TS, device="cpu",
                     reader=inputs["pixels"].__getitem__)
    st = TT.warm_start_state(CKPT, TT.create_train_state(cfg, 1, "cpu"))
    ref = validate_tiles(st.eval_model(), ds, cfg, batch_size=3,
                         return_components=True)
    assert ref[0] > 0.1
    for r in ranks:
        assert r["val"][1] == ref[1]
        assert abs(r["val"][0] - ref[0]) <= 1e-6


@pytest.mark.parametrize("channels", ["3ch", "4ch"])
def test_detect_rows_match_one_process(inputs, ranks, channels):
    """Each process returns every map's result; its rows equal one process's
    in order, class and corners within 1e-3 px, conf within 1e-5 (the
    processes' forwards take other batch sizes)."""
    triples, ch = (([(128, 30, CKPT)], 3) if channels == "3ch"
                   else ([(416, 100, CKPT4)], 4))
    ref = build_detector(triples, channels=ch, device="cpu",
                         compute_dtype="float32").detect_images(
        inputs["maps"])
    assert sum(len(r["merged_for_pr"]) for r in ref) > 0
    for r in ranks:
        for mode in ("images", "stream"):
            for got, one in zip(r["detect"][channels][mode], ref):
                for k in ("merged_for_pr",):
                    a, b = got[k], one[k]
                    assert a.shape == b.shape
                    np.testing.assert_array_equal(a[:, 8], b[:, 8])
                    np.testing.assert_allclose(a[:, 9], b[:, 9], rtol=0,
                                               atol=1e-5)
                    np.testing.assert_allclose(a[:, :8], b[:, :8], rtol=0,
                                               atol=1e-3)
    for mode in ("images", "stream"):
        for a, b in zip(ranks[0]["detect"][channels][mode],
                        ranks[1]["detect"][channels][mode]):
            np.testing.assert_array_equal(a["merged_for_pr"],
                                          b["merged_for_pr"])


def test_batch_the_processes_do_not_divide_raises(ranks):
    for r in ranks:
        assert r["odd_batch"] == "--batch-size 3 must divide by the 2 " \
                                 "processes"
