"""The port's model axis (``parallel/mesh.py``: ``make_mesh``,
``shard_model``, ``shard_train_state``) against the JAX package's
``parallel/mesh.py`` and against the port's own unsharded step, in gloo
processes on the CPU (``tests/torch_dist_worker.py``, two launches for the
file, started together: two processes and four).

* The layout: every leaf's shard on every model index equals the slice
  that JAX's ``shard_model`` puts on that model index of a (data 4, model
  2) mesh of the 8 virtual CPU devices, mapped through the converter; odd
  leaves replicate.
* (data 1, model 2): three steps of YOLO11n-OBB at tile 64 from
  ``train128.ckpt`` on the global batch of two, each bit-equal to one
  process's (metrics and the gathered parameters, EMA, momentum and
  BatchNorm statistics); the shards keep their layout; each process owns
  about half the unsharded state; a checkpoint restored into a sharded
  state comes back bit-equal.
* (data 2, model 2): one step, bit-equal to the data-only (2, 1) step on
  the same global batch (a reduction over the world instead of the data
  group would double the gradient and the loss normaliser), so within
  ``test_torch_dist.py``'s bounds of the JAX package's global-batch step.
* With ``n_model = 1`` the state stays replicated: the (2, 1) mesh's step
  is the world's data-parallel step bit for bit.
"""

import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from oriented_object_detection_tpu.parallel import mesh as JM
from oriented_object_detection_tpu_torch.models import layers as TLY
from oriented_object_detection_tpu_torch.models import weights as TW
from oriented_object_detection_tpu_torch.models.yolo11_obb import YOLO11OBB
from oriented_object_detection_tpu_torch.parallel import distributed as PD
from oriented_object_detection_tpu_torch.parallel import mesh as PM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "bench_ckpts", "train128.ckpt")
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_parity import one_torch_thread  # noqa: E402,F401
from torch_parity import (  # noqa: E402
    assert_trees_close, assert_trees_equal, jax_global_step, step_batch)

TS, B, M = 64, 2, 16
STEP_CFG = dict(tile_size=TS, batch_size=B, model_scale="n", epochs=3,
                compute_dtype="float32")
TREES = ("params", "ema_params", "batch_stats", "opt_state")
# (world, cases) of the two launches
LAUNCHES = {2: "one_process,mesh_1x2,plain_2,mesh_2x1", 4: "mesh_2x2"}
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("axis")
    weights = TW.variables_from_checkpoint(CKPT)
    rng = np.random.RandomState(5)
    imgs, gl, gb, gm = step_batch(1, TS, B, M)
    return {"root": root, "cfg": STEP_CFG, "weights": weights,
            "mom": jax.tree.map(lambda a: (rng.randn(*a.shape) * 1e-3
                                           ).astype(np.float32),
                                weights["params"]),
            "batch": {"images": imgs.transpose(0, 3, 1, 2).copy(),
                      "gt_labels": gl.astype(np.int64), "gt_xywhr": gb,
                      "gt_mask": gm},
            "run_root": str(root)}


def _ports(n: int) -> list:
    """``n`` distinct free ports (the sockets held together, so two
    launches cannot draw the same one)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


@pytest.fixture(scope="module", autouse=True)
def started(inputs):
    """Both launches, started together as the module starts, before its
    JAX work: ({world: output paths}, processes)."""
    root = inputs["root"]
    inp = str(root / "in.pkl")
    with open(inp, "wb") as f:
        pickle.dump({k: v for k, v in inputs.items() if k != "root"}, f)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs, outs = [], {}
    for (world, cases), port in zip(LAUNCHES.items(), _ports(len(LAUNCHES))):
        outs[world] = [str(root / f"out{world}_{r}.pkl")
                       for r in range(world)]
        procs += [subprocess.Popen(
            [sys.executable, WORKER, f"localhost:{port}", str(world), str(r),
             inp, outs[world][r], cases], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]
    yield outs, procs
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def jax_step(inputs, started):
    """The JAX package's one-process step on the global batch of two,
    compiled while the workers run."""
    return jax_global_step(inputs["weights"], inputs["mom"], inputs["batch"],
                           STEP_CFG)


@pytest.fixture(scope="module")
def ranks(started, jax_step):
    """{world: the workers' results per rank}."""
    outs, procs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(
                errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail("model-axis workers timed out")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = {}
    for world, paths in outs.items():
        res[world] = []
        for o in paths:
            with open(o, "rb") as f:
                res[world].append(pickle.load(f))
    return res


@pytest.fixture(scope="module")
def model():
    """YOLO11n-OBB with ``train128.ckpt``'s weights."""
    m = YOLO11OBB(nc=12, scale="n")
    TW.load_state(m, TW.torch_state_from_jax(
        TW.variables_from_checkpoint(CKPT)))
    return m


def test_shard_spec_follows_the_converter():
    """The flax leaf's trailing axis: dim 0 of an OIHW kernel and of a 1-D
    leaf; replicated where it does not divide, and at ``n_model = 1``."""
    assert PM.shard_spec("model.0.conv.weight", (16, 3, 3, 3), 2) == 0
    assert TW.KERNEL_AXES.index(3) == 0
    assert PM.shard_spec("model.0.bn.weight", (16,), 2) == 0
    assert PM.shard_spec("model.23.cv4.0.2.bias", (1,), 2) is None
    assert PM.shard_spec("model.2.cv1.conv.weight", (33, 8, 1, 1), 2) is None
    assert PM.shard_spec("model.0.conv.weight", (16, 3, 3, 3), 1) is None
    assert PM.shard_spec("model.0.conv.weight", (48, 3, 3, 3), 3) == 0


def test_make_mesh_without_a_group_is_one_by_one():
    assert not torch.distributed.is_initialized()
    assert PM.make_mesh() == PM.Mesh(1, 1, 0, 0, None, None)
    with pytest.raises(ValueError, match="needs 2 processes, not 1"):
        PM.make_mesh(1, 2)


def test_layout_matches_jax_shard_model(model):
    """For every leaf and every device of JAX's (data 4, model 2) mesh, the
    port's shard at that device's coordinates equals the device's slice
    of JAX's ``shard_model``, mapped through the converter (no JAX
    compile: ``device_put`` only)."""
    params = TW.variables_from_checkpoint(CKPT)["params"]
    jmesh = JM.make_mesh(n_data=4, n_model=2)
    sharded = JM.shard_model(params, jmesh)
    leaves, treedef = jax.tree.flatten(sharded)
    split = 0
    for rank, dev in enumerate(jax.devices()):
        d, m = PM.mesh_coords(rank, 2)
        assert jmesh.devices[d, m] == dev
        jax_tree = jax.tree.unflatten(treedef, [
            np.asarray(next(s.data for s in x.addressable_shards
                            if s.device == dev)) for x in leaves])
        want = TW.torch_state_from_jax({"params": jax_tree})
        got = PM.shard_model(model, PM.Mesh(4, 2, d, m))
        assert set(got) == set(want)
        for name, t in got.items():
            np.testing.assert_array_equal(t.detach().numpy(), want[name],
                                          err_msg=name)
            full = dict(model.named_parameters())[name]
            spec = PM.shard_spec(name, full.shape, 2)
            assert (t.shape == full.shape) == (spec is None), name
            split += spec is not None
    n_odd = sum(PM.shard_spec(n, p.shape, 2) is None
                for n, p in model.named_parameters())
    assert split > 0 and n_odd > 0
    # JAX's odd leaves sit whole on every device, as the port's do
    assert all(len({s.index[-1] for s in x.addressable_shards}) == 1
               for x in leaves if x.shape[-1] % 2)


def test_groups_follow_jax_reshape(ranks):
    """Process r at (r // 2, r % 2); its data group the processes of its
    model index, its model group those of its data index."""
    for r, res in enumerate(ranks[4]):
        assert res["mesh_2x2"]["mesh"] == (2, 2, r // 2, r % 2)
    for r, res in enumerate(ranks[2]):
        assert res["mesh_1x2"]["mesh"] == (1, 2, 0, r)


@pytest.mark.parametrize("step", range(3))
def test_model_axis_1x2_bit_equal_to_one_process(ranks, step):
    """(data 1, model 2) each step: both processes' metrics and gathered
    state equal one process's on the same rows bit for bit."""
    one = ranks[2][0]["one_process"]
    for res in ranks[2]:
        got = res["mesh_1x2"]
        np.testing.assert_array_equal(got["metrics"][step],
                                      one["metrics"][step])
        assert got["payloads"][step]["step"] == one["payloads"][step][
            "step"] == 3 + step
        for key in TREES:
            assert_trees_equal(got["payloads"][step][key],
                               one["payloads"][step][key])


def test_shards_keep_their_layout(ranks, model):
    """After three steps each process holds, of every divisible leaf of
    the master parameters, the EMA and the momentum, its model index's
    half of the gathered tree, and of every other leaf the whole."""
    for r, res in enumerate(ranks[2]):
        got = res["mesh_1x2"]
        assert got["sharded"]
        last = got["payloads"][-1]
        full, ema, mom = (TW.torch_state_from_jax({"params": last[key]})
                          for key in ("params", "ema_params", "opt_state"))
        for name, p in model.named_parameters():
            spec = PM.shard_spec(name, p.shape, 2)
            for part, whole in ((got["master"], full), (got["ema"], ema),
                                (got["momentum"], mom)):
                want = whole[name] if spec is None else np.split(
                    whole[name], 2, axis=spec)[r]
                np.testing.assert_array_equal(part[name], want, name)


def test_owned_state_is_about_half(ranks, model):
    """Owned bytes a process: the master, momentum and EMA shards (whole
    where replicated), the BatchNorm buffers, the step and the schedule,
    reckoned from the shapes; near half the unsharded state at n_model 2,
    the same at n_model 1."""
    params = list(model.named_parameters())
    halves = sum(p.numel() // 2 if PM.shard_spec(n, p.shape, 2) is not None
                 else p.numel() for n, p in params)
    rest = sum(b.numel() * b.element_size() for b in model.buffers()) \
        + 7 * 4 + 8
    whole = 3 * 4 * sum(p.numel() for _, p in params) + rest
    for res in ranks[2] + ranks[4]:
        got = res["mesh_1x2" if "mesh_1x2" in res else "mesh_2x2"]["bytes"]
        assert got == {"owned": 3 * 4 * halves + rest, "unsharded": whole}
        assert 0.5 <= got["owned"] / got["unsharded"] <= 0.51
    plain = ranks[2][0]["mesh_2x1"]["bytes"]
    assert plain["owned"] == plain["unsharded"] == whole


def test_gathers_go_in_buckets(ranks, model, monkeypatch):
    """At (1, 2), in buckets of 2^18 elements, the payload after a step
    gathers the parameters, the EMA and the momentum over the model group
    in as many flat buckets each as the shards fill, and nothing over the
    world."""
    import torch_dist_worker as WK

    shards = [torch.empty(p.numel() // 2) for n, p in model.named_parameters()
              if PM.shard_spec(n, p.shape, 2) is not None]
    monkeypatch.setattr(PD, "GRAD_BUCKET_NUMEL", WK.SMALL_BUCKET_NUMEL)
    n = len(PD.buckets(shards))
    assert n > 2
    for res in ranks[2]:
        for c in res["mesh_1x2"]["payload_collectives"]:
            assert c["model"] == 3 * n and c.get("world", 0) == 0


def test_sharded_checkpoint_restores_bit_equal(ranks):
    """The gathered ``last`` payload of (1, 2), written by process 0,
    restored into a fresh sharded state on both processes: its payload is
    the written one bit for bit."""
    written = ranks[2][0]["mesh_1x2"]["payloads"][-1]
    for res in ranks[2]:
        back = res["mesh_1x2"]["restored"]
        assert back["step"] == written["step"] == 5
        for key in TREES:
            assert_trees_equal(back[key], written[key])


def test_n_model_1_is_replicated_data_parallelism(ranks):
    """``shard_train_state`` on a (2, 1) mesh leaves the state replicated
    with the world's group, and its step is the world's data-parallel step
    bit for bit."""
    for res in ranks[2]:
        got, plain = res["mesh_2x1"], res["plain_2"]
        assert not got["sharded"] and got["groups"] == (None, None)
        np.testing.assert_array_equal(got["metrics"][0], plain["metrics"][0])
        for key in TREES:
            assert_trees_equal(got["payloads"][0][key],
                               plain["payloads"][0][key])


def test_model_axis_2x2_bit_equal_to_data_only_and_near_jax(ranks, model,
                                                            jax_step):
    """(data 2, model 2) against the data-only (2, 1) step on the same
    global batch of two, bit for bit on every process, its global-batch
    reductions over the data group alone (two a BatchNorm layer, the loss
    normaliser, the gradient bucket, the metrics; none over the world);
    and so within ``test_torch_dist.py``'s bounds of the JAX package's
    step on the global batch (loss 1e-5; parameters, EMA and statistics
    1e-4; momentum 1e-3). The (1, 2) steps reduce over no data group."""
    plain = ranks[2][0]["plain_2"]
    for res in ranks[4]:
        got = res["mesh_2x2"]
        np.testing.assert_array_equal(got["metrics"][0], plain["metrics"][0])
        for key in TREES:
            assert_trees_equal(got["payloads"][0][key],
                               plain["payloads"][0][key])
        assert got["collectives"][0].get("world", 0) == 0
        n_bn = sum(isinstance(m, TLY.BatchNorm) for m in model.modules())
        assert got["collectives"][0]["data"] == 2 * n_bn + 3
    for res in ranks[2]:
        for c in res["mesh_1x2"]["collectives"]:
            assert c.get("world", 0) == c.get("data", 0) == 0
    new, metrics = jax_step
    got = ranks[4][0]["mesh_2x2"]
    assert got["metrics"][0][4] == metrics[4] > 0
    np.testing.assert_allclose(got["metrics"][0][:4], metrics[:4], rtol=1e-5)
    out = got["payloads"][0]
    assert out["step"] == int(new.step) == 3
    assert_trees_close(out["params"], new.params, 1e-4)
    assert_trees_close(out["ema_params"], new.ema_params, 1e-4)
    assert_trees_close(out["batch_stats"], new.batch_stats, 1e-4)
    assert_trees_close(out["opt_state"], new.opt_state, 1e-3)
