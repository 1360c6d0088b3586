"""The bf16 box-loss probe: the JAX package's bf16 head outputs of one
training-mode forward of YOLO11n-OBB (``train128.ckpt``, tile 64) fed,
unchanged, into the JAX package's ``obb_loss`` and into the port's.

The port's bf16 train step's box loss lies about twice the JAX package's
own bf16-versus-float32 gap from JAX's float32 step
(``tests/test_torch_bf16_train.py``). If the two losses agree on the same
bf16 head outputs to float32 rounding, the loss treats a bf16 input as the
JAX package's does and the gap comes from the forward; if not, the port's
loss is at fault. Four seeded batches of two tiles, as the bf16 step test
uses."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oriented_object_detection_tpu.models import YOLO11OBB as JaxModel
from oriented_object_detection_tpu.train import loss as JL
from oriented_object_detection_tpu_torch.models import weights as TW
from oriented_object_detection_tpu_torch.train import loss as TL
from oriented_object_detection_tpu_torch.train import trainer as TT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "bench_ckpts", "train128.ckpt")
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_parity import one_torch_thread  # noqa: E402,F401
from torch_parity import step_batch  # noqa: E402

TS, B, M = 64, 2, 16
SEEDS = (1, 11, 21, 31)
# float32 sums of the same float32 terms in two orders (XLA's and torch's)
RTOL = 1e-5


@pytest.fixture(scope="module")
def losses():
    """Per batch: (JAX loss [total, box, cls, dfl, fg], port loss) on the
    JAX package's bf16 head outputs."""
    weights = TW.variables_from_checkpoint(CKPT)
    model = JaxModel(nc=12, scale="n")
    cfg = JL.LossConfig(nc=12, img_size=TS)
    out = []
    with jax.enable_x64(False):
        variables = jax.tree.map(jnp.asarray, weights)

        @jax.jit
        def forward(x):
            return model.apply(variables, x.astype(jnp.bfloat16), train=True,
                               mutable=["batch_stats"])[0]

        jax_loss = jax.jit(JL.obb_loss, static_argnames=("cfg",))
        for seed in SEEDS:
            imgs, gl, gb, gm = step_batch(seed, TS, B, M)
            raw = forward(jnp.asarray(imgs))
            assert {x.dtype for k in ("box", "cls", "ang")
                    for x in raw[k]} == {jnp.dtype(jnp.bfloat16)}
            total, parts = jax_loss(raw, jnp.asarray(gl), jnp.asarray(gb),
                                    jnp.asarray(gm), cfg=cfg)
            want = np.asarray([total] + [parts[k] for k in
                                         TT.METRIC_KEYS[1:]], np.float64)
            # NHWC bf16 -> the port's NCHW bf16: the same values
            raw_t = {k: [torch.from_numpy(np.asarray(x, np.float32)).permute(
                0, 3, 1, 2).to(torch.bfloat16) for x in raw[k]]
                for k in ("box", "cls", "ang")}
            total_t, parts_t = TL.obb_loss(
                raw_t, torch.from_numpy(gl).long(), torch.from_numpy(gb),
                torch.from_numpy(gm), TL.LossConfig(nc=12, img_size=TS))
            got = np.asarray([float(total_t)] + [float(parts_t[k]) for k in
                                                 TT.METRIC_KEYS[1:]])
            out.append((want, got))
    return out


@pytest.mark.parametrize("part", TT.METRIC_KEYS)
def test_port_loss_matches_jax_on_jax_bf16_head_outputs(losses, part):
    """Each part of the loss on identical bf16 head outputs: the fg counts
    equal, the losses within float32 rounding (1e-5 relative)."""
    i = TT.METRIC_KEYS.index(part)
    for want, got in losses:
        print(f"{part}: jax {want[i]:.8g} port {got[i]:.8g} rel "
              f"{abs(got[i] - want[i]) / max(abs(want[i]), 1e-12):.2e}")
        if part == "fg_count":
            assert got[i] == want[i] > 0
        else:
            np.testing.assert_allclose(got[i], want[i], rtol=RTOL)
