"""The port's trainer against the JAX package's, on the CPU in float32.

* BatchNorm in training mode against flax: the layer on two samples a
  channel (where ``nn.BatchNorm2d``'s unbiased running variance would be
  twice flax's), and the whole n-scale model's training forward with its
  running-statistics update.
* The schedule, the SGD update and the EMA on small trees.
* One whole train step from the committed ``train128.ckpt`` weights (with
  momentum and step carried in) against ``make_train_step``: loss,
  parameters, momentum, EMA and BatchNorm statistics.
* A checkpoint the port writes reads in the JAX package with the same
  forward; resume restores the momentum; a warm start refuses another
  architecture.

The whole-model checks run at tile 64, batch 2. At tile 32, batch 2 the
stride-32 level normalizes two values a channel, and there BatchNorm
multiplies a float32 rounding difference by up to 1/sqrt(eps) = 31.6 a
layer: the two packages' training forwards then differ by O(1) at the head,
though each layer agrees within 1e-5. With eight values a channel (tile 64)
they agree within 5e-5. ``tools/torch_train_parity.py`` prints both.
"""

import dataclasses
import os
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
from oriented_object_detection_tpu_torch.models import layers as TLY
from oriented_object_detection_tpu_torch.models import weights as TW
from oriented_object_detection_tpu_torch.ops import geometry as G
from oriented_object_detection_tpu_torch.train import trainer as TT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "bench_ckpts", "train128.ckpt")
sys.path.insert(0, REPO)
from tools.train_synthetic import gen_map  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

TS, B, M = 64, 2, 16


def _max_rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(a)).max(), 1e-6))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _assert_trees_close(got, ref, rtol):
    """Each leaf within ``rtol`` of the reference leaf's largest value."""
    n = 0
    for path, r in _leaves(jax.tree.map(np.asarray, ref)):
        g = _get(got, path)
        assert g.shape == r.shape, path
        assert _max_rel(r, g) <= rtol, (path, _max_rel(r, g))
        n += 1
    assert n > 100


@pytest.fixture(scope="module")
def weights():
    return TW.variables_from_checkpoint(CKPT)


@pytest.fixture(scope="module")
def batch():
    """Two 64 tiles of one seeded map with their boxes in pixels."""
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


def _torch_batch(imgs, gl, gb, gm):
    return {"images": torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous(),
            "gt_labels": torch.from_numpy(gl).long(),
            "gt_xywhr": torch.from_numpy(gb), "gt_mask": torch.from_numpy(gm)}


@pytest.mark.parametrize("hw", [1, 8])
def test_batchnorm_training_matches_flax(hw):
    """Two samples a channel at hw=1: flax moves the running variance by the
    biased batch variance, nn.BatchNorm2d by twice that."""
    rng = np.random.RandomState(hw)
    x = (rng.randn(2, 16, hw, hw) * 3 + 1).astype(np.float32)
    mean0 = rng.randn(16).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 16).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.randn(16).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, epsilon=1e-3,
                       momentum=0.97)
    with jax.enable_x64(False):
        y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": {"mean": mean0, "var": var0}},
                          x.transpose(0, 2, 3, 1), mutable=["batch_stats"])
    layer = TLY.BatchNorm(16)
    with torch.no_grad():
        for t, a in ((layer.weight, scale), (layer.bias, bias),
                     (layer.running_mean, mean0), (layer.running_var, var0)):
            t.copy_(torch.from_numpy(a))
    got = layer.train()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), np.asarray(y),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(layer.running_mean.numpy(),
                               upd["batch_stats"]["mean"], rtol=1e-6)
    np.testing.assert_allclose(layer.running_var.numpy(),
                               upd["batch_stats"]["var"], rtol=1e-5)
    torch_bn = torch.nn.BatchNorm2d(16, eps=1e-3, momentum=0.03)
    torch_bn.running_var.copy_(torch.from_numpy(var0))
    torch_bn.train()(torch.from_numpy(x))
    n = 2 * hw * hw
    biased = x.transpose(1, 0, 2, 3).reshape(16, -1).var(1)
    np.testing.assert_allclose(
        torch_bn.running_var.numpy() - 0.97 * var0,
        0.03 * biased * n / (n - 1), rtol=1e-4)


def test_model_training_forward_and_statistics_match_flax(weights, batch):
    imgs = batch[0]
    with jax.enable_x64(False):
        jm = JaxModel(nc=12, scale="n", in_channels=3)
        out, upd = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats"]))(weights, imgs)
    model = TT.create_train_state(
        TrainConfig(model_scale="n", tile_size=TS), device="cpu").model
    TW.load_state(model, TW.torch_state_from_jax(weights))
    got = model.train()(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    for k in ("box", "cls", "ang"):
        for a, b in zip(out[k], got[k]):
            assert _max_rel(np.asarray(a).transpose(0, 3, 1, 2),
                            b.detach().numpy()) <= 1e-3
    _assert_trees_close(
        TW.jax_trees_from_torch_state(model.state_dict())["batch_stats"],
        upd["batch_stats"], rtol=1e-4)


def test_schedule_matches_jax():
    cfg = TrainConfig(epochs=7, warmup_epochs=1.5)
    sched = TT.make_sched_vector(cfg, 13)
    jcfg = dataclasses.replace(JaxCfg(), epochs=7, warmup_epochs=1.5)
    np.testing.assert_array_equal(sched, np.asarray(
        JT.make_sched_vector(jcfg, 13)))
    with jax.enable_x64(False):
        fn = jax.jit(JT.schedule_hypers)
        for step in (0, 1, 7, 19, 20, 50, 90, 91, 200):
            ref = fn(jnp.asarray(sched), jnp.asarray(step, jnp.int32))
            got = TT.schedule_hypers(sched, step)
            for k in ("lr", "lr_bias", "momentum"):
                np.testing.assert_allclose(got[k], float(ref[k]),
                                           rtol=2e-7, atol=1e-12)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c = torch.nn.Conv2d(3, 4, 3)
        self.bn = torch.nn.BatchNorm2d(4)


def _tiny_tree(named):
    return {"c": {"kernel": named["c.weight"], "bias": named["c.bias"]},
            "bn": {"scale": named["bn.weight"], "bias": named["bn.bias"]}}


def test_sgd_and_ema_match_jax_on_a_small_tree():
    """Three steps of the port's SGD groups against ``sgd_apply`` (decay
    on the 4-D kernel only, the bias lr on every bias), and the EMA
    against ``ema_update``."""
    torch.manual_seed(0)
    m = _Tiny()
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.randn_like(p))
    cfg = TrainConfig(weight_decay=0.01)
    opt = TT.make_optimizer(m, cfg)
    assert {g["name"]: len(g["params"]) for g in opt.param_groups} == \
        {"decay": 1, "no_decay": 1, "bias": 2}
    named = lambda: {n: p.detach().numpy().copy()
                     for n, p in m.named_parameters()}
    params = _tiny_tree(named())
    mu = jax.tree.map(np.zeros_like, params)
    ema_t = [p.detach().clone() for p in m.parameters()]
    ema_j = jax.tree.map(np.copy, params)
    sched = TT.make_sched_vector(TrainConfig(epochs=2), 3)
    rng = np.random.RandomState(1)
    for step in range(3):
        grads = {n: rng.randn(*p.shape).astype(np.float32)
                 for n, p in m.named_parameters()}
        hyp = TT.schedule_hypers(sched, step)
        TT.set_hypers(opt, hyp)
        for n, p in m.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        TT.ema_update(ema_t, list(m.parameters()), step + 1, 0.9999, 2.0)
        with jax.enable_x64(False):
            jp = jax.tree.map(jnp.asarray, params)
            params, mu = JT.sgd_apply(
                jp, jax.tree.map(jnp.asarray, _tiny_tree(grads)), mu,
                {k: jnp.float32(v) for k, v in hyp.items()}, 0.01,
                JT.decay_mask(jp), JT.bias_labels(jp))
            ema_j = JT.ema_update(ema_j, params,
                                  jnp.asarray(step + 1, jnp.int32),
                                  0.9999, 2.0)
        _assert_small_tree(named(), params, 2e-6)
        _assert_small_tree({n: opt.state[p]["momentum_buffer"].numpy()
                            for n, p in m.named_parameters()}, mu, 2e-6)
        _assert_small_tree({n: e.numpy() for n, e in zip(
            dict(m.named_parameters()), ema_t)}, ema_j, 2e-6)


def _assert_small_tree(named, ref, rtol):
    got = _tiny_tree(named)
    for path, r in _leaves(jax.tree.map(np.asarray, ref)):
        assert _max_rel(r, _get(got, path)) <= rtol, path


def test_train_step_matches_jax_make_train_step(weights, batch):
    """One step at step 2 of the warmup with random momentum buffers.
    Tolerances, of each leaf's largest value: parameters, EMA and BN
    statistics 1e-4, momentum 1e-3 (a gradient's reduction order); the loss
    1e-5 (``tools/torch_train_parity.py`` prints the measured values)."""
    imgs, gl, gb, gm = batch
    cfg = TrainConfig(tile_size=TS, batch_size=B, model_scale="n", epochs=3,
                      compute_dtype="float32")
    jcfg = dataclasses.replace(JaxCfg(), tile_size=TS, batch_size=B,
                               model_scale="n", compute_dtype="float32",
                               epochs=3)
    rng = np.random.RandomState(5)
    mom = jax.tree.map(lambda a: (rng.randn(*a.shape) * 1e-3).astype(
        np.float32), weights["params"])
    sched = TT.make_sched_vector(cfg, 4)
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
            "images": jnp.asarray(imgs), "gt_labels": jnp.asarray(gl),
            "gt_xywhr": jnp.asarray(gb), "gt_mask": jnp.asarray(gm)})
        new, metrics = jax.tree.map(np.asarray, (new, metrics))

    st = TT.create_train_state(cfg, steps_per_epoch=4, device="cpu")
    TW.load_state(st.model, TW.torch_state_from_jax(weights))
    st.reset_ema()
    st.step = 2
    mt = TW.torch_state_from_jax({"params": mom})
    for n, p in st.model.named_parameters():
        st.opt.state[p]["momentum_buffer"] = torch.from_numpy(mt[n].copy())
    got = TT.train_step(st, _torch_batch(imgs, gl, gb, gm), cfg).numpy()

    assert got[4] == metrics[4] > 0                     # fg count
    np.testing.assert_allclose(got[:4], metrics[:4], rtol=1e-5)
    out = TT.checkpoint_payload(st)
    assert out["step"] == int(new.step) == 3
    _assert_trees_close(out["params"], new.params, 1e-4)
    _assert_trees_close(out["ema_params"], new.ema_params, 1e-4)
    _assert_trees_close(out["batch_stats"], new.batch_stats, 1e-4)
    _assert_trees_close(out["opt_state"], new.opt_state, 1e-3)
    # the step moved the parameters far more than the tolerance
    moved = max(_max_rel(_get(weights["params"], p), _get(out["params"], p))
                for p, _ in _leaves(out["params"]))
    assert moved > 1e-2


def test_checkpoint_reads_in_jax_with_the_same_forward(weights, batch,
                                                       tmp_path):
    cfg = TrainConfig(tile_size=TS, batch_size=B, model_scale="n", epochs=3)
    st = TT.create_train_state(cfg, 4, device="cpu")
    TW.load_state(st.model, TW.torch_state_from_jax(weights))
    st.reset_ema()
    TT.train_step(st, _torch_batch(*batch), cfg)
    path = str(tmp_path / "last.ckpt")
    TT.save_checkpoint(path, st, {"model_scale": "n", "channels": 3,
                                  "tile_size": TS})
    ck = JT.load_checkpoint(path)
    assert set(ck) >= {"step", "params", "batch_stats", "ema_params",
                       "opt_state", "sched", "extra"}
    v = JT.variables_from_checkpoint(path)
    x = batch[0]
    with jax.enable_x64(False):
        ref = jax.jit(lambda v, x: JaxModel(nc=12, scale="n").apply(v, x))(
            v, x)
    with torch.no_grad():
        got = st.eval_model()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in ("box", "cls", "ang"):
        for a, b in zip(ref[k], got[k]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a).transpose(
                0, 3, 1, 2), rtol=0, atol=1e-4)


def test_resume_restores_momentum(weights, batch, tmp_path):
    cfg = TrainConfig(tile_size=TS, batch_size=B, model_scale="n", epochs=3)
    st = TT.create_train_state(cfg, 4, device="cpu")
    TW.load_state(st.model, TW.torch_state_from_jax(weights))
    st.reset_ema()
    tb = _torch_batch(*batch)
    TT.train_step(st, tb, cfg)
    path = str(tmp_path / "last.ckpt")
    TT.save_checkpoint(path, st)
    fresh = TT.restore_train_state(path, TT.create_train_state(cfg, 4,
                                                               "cpu"))
    assert fresh.step == st.step == 1
    moved = 0
    for (n, p), q in zip(st.model.named_parameters(),
                         fresh.model.parameters()):
        assert torch.equal(st.opt.state[p]["momentum_buffer"],
                           fresh.opt.state[q]["momentum_buffer"]), n
        moved += bool(st.opt.state[p]["momentum_buffer"].abs().max() > 0)
    assert moved > 100
    for a, b in zip(st.ema_tensors(), fresh.ema_tensors()):
        assert torch.equal(a, b)
    m1 = TT.train_step(st, tb, cfg)
    m2 = TT.train_step(fresh, tb, cfg)
    torch.testing.assert_close(m1, m2, rtol=1e-5, atol=1e-6)


def test_warm_start_rejects_a_mismatched_architecture(tmp_path):
    cfg = TrainConfig(tile_size=32, model_scale="n")
    st = TT.create_train_state(cfg, 4, device="cpu")
    path = str(tmp_path / "n.ckpt")
    TT.save_checkpoint(path, st, {"model_scale": "n", "channels": 3})
    for expect in ({"model_scale": "x", "channels": 3},
                   {"model_scale": "n", "channels": 4}):
        with pytest.raises(SystemExit, match="checkpoint was saved with"):
            TT.warm_start_state(path, TT.create_train_state(cfg, 4, "cpu"),
                                expect=expect)
    warm = TT.warm_start_state(path, TT.create_train_state(
        dataclasses.replace(cfg, seed=7), 4, "cpu"),
        expect={"model_scale": "n", "channels": 3})
    for a, b, e in zip(st.model.parameters(), warm.model.parameters(),
                       warm.ema_tensors()):
        assert torch.equal(a, b) and torch.equal(b, e)
    assert warm.step == 0
