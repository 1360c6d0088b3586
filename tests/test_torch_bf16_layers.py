"""bf16 layers against flax's, at the JAX package's cast points: ConvBN
(folded, BatchNorm eval and train) and Attention within 2 bf16 ulps, the
running statistics, SiLU's rounding against XLA's CPU, the float32 batch
moments of a bf16 tensor, and ``cli.py train`` at the default dtype
(steps in bf16, validation in float32).

A "bf16 ulp" of an element is the spacing of bf16 numbers at the larger of
its two values' magnitudes, or at the reference output's mean magnitude
where both are smaller: where a sum cancels to near zero, the rounding of
its terms, not of the result, sets the difference."""

import os
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.linen.normalization import _compute_stats

from oriented_object_detection_tpu.models import layers as JL
from oriented_object_detection_tpu_torch import cli
from oriented_object_detection_tpu_torch.data import labels as TLB
from oriented_object_detection_tpu_torch.eval import val as TV
from oriented_object_detection_tpu_torch.models import layers as TL
from oriented_object_detection_tpu_torch.train import trainer as TT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.train_synthetic import gen_map  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401


def bf16_ulps(ref: np.ndarray, got: np.ndarray) -> np.ndarray:
    """|ref - got| in bf16 ulps (module docstring)."""
    ref, got = ref.astype(np.float32), got.astype(np.float32)
    mag = np.maximum(np.maximum(np.abs(ref), np.abs(got)),
                     np.abs(ref).mean())
    return np.abs(ref - got) / np.exp2(np.floor(np.log2(mag)) - 7)


def _nchw(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32)).transpose(0, 3, 1, 2)


def _convbn_state(p: dict, s: dict) -> dict:
    """flax ConvBN {'conv', 'bn'} params and stats -> the port's keys."""
    return {"conv.weight": torch.from_numpy(
        np.asarray(p["conv"]["kernel"]).transpose(3, 2, 0, 1).copy()),
        "bn.weight": torch.from_numpy(np.asarray(p["bn"]["scale"])),
        "bn.bias": torch.from_numpy(np.asarray(p["bn"]["bias"])),
        "bn.running_mean": torch.from_numpy(np.asarray(s["bn"]["mean"])),
        "bn.running_var": torch.from_numpy(np.asarray(s["bn"]["var"]))}


def _convbn_variables(rng, c1: int, c2: int, k: int) -> dict:
    return {"params": {
        "conv": {"kernel": (rng.randn(k, k, c1, c2) / np.sqrt(k * k * c1)
                            ).astype(np.float32)},
        "bn": {"scale": (1 + 0.2 * rng.randn(c2)).astype(np.float32),
               "bias": (0.3 * rng.randn(c2)).astype(np.float32)}},
        "batch_stats": {"bn": {
            "mean": (0.2 * rng.randn(c2)).astype(np.float32),
            "var": rng.uniform(0.6, 1.6, c2).astype(np.float32)}}}


def _fold(v: dict) -> dict:
    """The JAX package's fold of one ConvBN's variables (models/fold.py)."""
    p, s = v["params"], v["batch_stats"]["bn"]
    inv = p["bn"]["scale"] / np.sqrt(s["var"] + TL.BN_EPS)
    c = len(inv)
    return {"params": {
        "conv": {"kernel": (p["conv"]["kernel"] * inv).astype(np.float32)},
        "bn": {"scale": np.ones(c, np.float32),
               "bias": (p["bn"]["bias"] - s["mean"] * inv).astype(
                   np.float32)}},
        "batch_stats": {"bn": {"mean": np.zeros(c, np.float32),
                               "var": np.full(c, 1 - TL.BN_EPS,
                                              np.float32)}}}


@pytest.mark.parametrize("mode", ["folded", "eval", "train"])
def test_convbn_bf16_matches_flax(mode):
    """The cast points of a 3x3 ConvBN in bf16 (conv, folded bias or
    BatchNorm in float32, cast back), SiLU off, within 2 ulps of flax's;
    with SiLU, the port's single-rounded SiLU of flax's pre-activation
    within 2 ulps of the port's layer. Training: the running statistics
    within 1e-6 of flax's, relative to each one's largest value."""
    rng = np.random.RandomState(0)
    c1, c2 = 32, 64
    x = rng.randn(2, 24, 20, c1).astype(np.float32)
    v = _convbn_variables(rng, c1, c2, 3)
    if mode == "folded":
        v = _fold(v)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2)).bfloat16()
    train = mode == "train"
    token = JL._FUSED_BN.set(mode == "folded")
    try:
        with jax.enable_x64(False):
            ref, upd = JL.ConvBN(c2, 3, act=False).apply(
                v, xb, train=train, mutable=["batch_stats"])
    finally:
        JL._FUSED_BN.reset(token)
    ref = _nchw(ref)
    for act in (False, True):
        layer = TL.ConvBN(c1, c2, 3, act=act)
        layer.load_state_dict(_convbn_state(v["params"], v["batch_stats"]),
                              strict=False)
        layer.fused = mode == "folded"
        with torch.no_grad():
            got = layer.train(train)(xt)
        assert got.dtype == torch.bfloat16
        want = (F.silu(torch.from_numpy(ref).bfloat16()).float().numpy()
                if act else ref)
        u = bf16_ulps(want, got.float().numpy())
        print(f"ConvBN {mode} act={act}: max {u.max():.1f} ulps, "
              f"{(u == 0).mean():.3f} equal")
        assert u.max() <= 2
    if train:
        for ours, key in ((layer.bn.running_mean, "mean"),
                          (layer.bn.running_var, "var")):
            r = np.asarray(upd["batch_stats"]["bn"][key])
            assert ours.dtype == torch.float32
            rel = np.abs(ours.numpy() - r).max() / np.abs(r).max()
            print(f"running {key}: max rel {rel:.2e}")
            assert rel <= 1e-6


def test_silu_rounding_gap_with_xla_cpu():
    """XLA's CPU rounds every primitive of a bf16 sigmoid (exp, +1, 1/x,
    product) to bf16; torch rounds SiLU once. On the same bf16 inputs the
    two stay within 2 ulps (printed: the share of equal elements)."""
    z = (np.random.RandomState(1).randn(20000) * 3).astype(np.float32)
    zb = jnp.asarray(z, jnp.bfloat16)
    with jax.enable_x64(False):
        ref = np.asarray(jnp.asarray(fnn.silu(zb), jnp.float32))
    got = F.silu(torch.from_numpy(np.asarray(jnp.asarray(
        zb, jnp.float32))).bfloat16()).float().numpy()
    u = bf16_ulps(ref, got)
    print(f"SiLU: max {u.max():.1f} ulps, {(u == 0).mean():.3f} equal")
    assert u.max() <= 2 and (u == 0).mean() > 0.5


def test_attention_bf16_matches_flax():
    """PSA attention with two heads (qkv, logits and softmax in float32,
    probabilities cast back, product with v in bf16, positional branch,
    projection): within 2 ulps of flax's."""
    rng = np.random.RandomState(2)
    dim, heads = 128, 2
    x = rng.randn(2, 8, 6, dim).astype(np.float32)
    layer = TL.Attention(dim, heads)
    sizes = {"qkv": (dim, dim + 2 * heads * layer.key_dim, 1),
             "proj": (dim, dim, 1), "pe": (1, dim, 3)}
    v = {"params": {}, "batch_stats": {}}
    state = {}
    for name, (c1, c2, k) in sizes.items():
        sub = _convbn_variables(rng, c1, c2, k)
        v["params"][name] = sub["params"]
        v["batch_stats"][name] = sub["batch_stats"]
        state.update({f"{name}.{key}": t for key, t in _convbn_state(
            sub["params"], sub["batch_stats"]).items()})
    with jax.enable_x64(False):
        ref = _nchw(JL.Attention(dim, heads).apply(
            v, jnp.asarray(x, jnp.bfloat16)))
    layer.load_state_dict(state, strict=False)
    with torch.no_grad():
        got = layer.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2))
                           .bfloat16())
    assert got.dtype == torch.bfloat16
    u = bf16_ulps(ref, got.float().numpy())
    print(f"Attention: max {u.max():.1f} ulps, {(u == 0).mean():.3f} equal")
    assert u.max() <= 2


def test_global_moments_of_bf16_are_flax_float32_stats():
    """``global_moments`` (one process: the all-reduce is the identity) of
    a bf16 tensor: float32 moments bit-equal to flax's ``_compute_stats``.
    The values are multiples of 1/64 below 2 in magnitude, so every float32
    sum is exact in any order and the test holds the promotion, not an
    order; bf16 sums of them round."""
    k = np.random.RandomState(3).randint(-127, 128, (2, 8, 8, 16))
    x = (k / 64.0).astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).bfloat16()
    mean, var = TL.global_moments(xt)
    with jax.enable_x64(False):
        ref = _compute_stats(jnp.asarray(x, jnp.bfloat16), (0, 1, 2), None)
    assert mean.dtype == var.dtype == torch.float32
    np.testing.assert_array_equal(mean.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(var.numpy(), np.asarray(ref[1]))
    rounded = xt.sum(dim=(0, 2, 3)) / xt[:, 0].numel()
    assert not torch.equal(rounded.float(), mean)



def test_cli_train_computes_bf16_and_validates_float32(tmp_path,
                                                       monkeypatch):
    """``cli.py train`` with no dtype setting steps in bf16 (the head
    outputs of every step are bf16) and validates in float32."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(3)
    for split, n in (("train", 1), ("val", 1)):
        os.makedirs(tmp_path / "images" / split)
        os.makedirs(tmp_path / "labels" / split)
        for k in range(n):
            img, lab = gen_map(rng, H=128, W=128, n_obj=6)
            cv2.imwrite(str(tmp_path / "images" / split / f"m{k}.png"), img)
            TLB.write_labels(str(tmp_path / "labels" / split / f"m{k}.txt"),
                             lab)
    seen = {"step": set(), "val": set()}
    step, val = TT.train_step, TV.validate_tiles

    def spy_step(state, batch, cfg):
        h = state.model.register_forward_hook(
            lambda m, i, o: seen["step"].add(o["cls"][0].dtype))
        try:
            return step(state, batch, cfg)
        finally:
            h.remove()

    def spy_val(model, *a, **k):
        h = model.register_forward_hook(
            lambda m, i, o: seen["val"].add(o["cls"][0].dtype))
        try:
            return val(model, *a, **k)
        finally:
            h.remove()

    monkeypatch.setattr(TT, "train_step", spy_step)
    monkeypatch.setattr(TV, "validate_tiles", spy_val)
    cli.main(["train", "--data-root", str(tmp_path), "--tile-size", "64",
              "--overlap", "0", "--epochs", "1", "--batch-size", "2",
              "--scale", "n", "--skip-augmentation", "--ckpt-dir",
              str(tmp_path / "run"), "--device", "cpu"])
    assert seen == {"step": {torch.bfloat16}, "val": {torch.float32}}
