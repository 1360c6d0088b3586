"""The port's decode and engine NMS (models/decode.py, ops/nms.py) against
the JAX package's, from the same head outputs: the same kept boxes in the
same order, coordinates within 1e-4."""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oriented_object_detection_tpu.models import decode as JD
from oriented_object_detection_tpu.ops import geometry as JG
from oriented_object_detection_tpu.ops import nms as JN
from oriented_object_detection_tpu_torch.models import decode as TD
from oriented_object_detection_tpu_torch.models import weights as W
from oriented_object_detection_tpu_torch.models.yolo11_obb import YOLO11OBB
from oriented_object_detection_tpu_torch.ops import dtedge as TDT
from oriented_object_detection_tpu_torch.ops import nms as TN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tools.train_synthetic import gen_map  # noqa: E402

pytest.importorskip("cv2")
TS = 416


@pytest.fixture(scope="module")
def head_out():
    """Raw head outputs of the committed 4ch checkpoint on two synthetic
    tiles, as NCHW numpy arrays."""
    rng = np.random.RandomState(2)
    tiles = np.stack([gen_map(rng, H=TS, W=TS, n_obj=25)[0]
                      for _ in range(2)])
    model = YOLO11OBB(nc=12, scale="n", in_channels=4)
    W.load_state(model, W.torch_state_from_jax(W.variables_from_checkpoint(
        os.path.join(REPO, "assets", "bench_ckpts", "train416_4ch.ckpt"))))
    with torch.no_grad():
        out = model.eval()(TDT.build_multich(torch.from_numpy(tiles), 4)
                           / 255.0)
    return {k: [t.numpy() for t in v] for k, v in out.items()}


def _jax_out(out):
    return {k: [jnp.asarray(a.transpose(0, 2, 3, 1)) for a in v]
            for k, v in out.items()}


def _torch_out(out):
    return {k: [torch.from_numpy(a) for a in v] for k, v in out.items()}


@pytest.fixture(scope="module")
def decoded(head_out):
    """JAX's decode in float32, as it runs outside this suite's x64 mode
    (under x64 its anchor grid is float64 and promotes x and y)."""
    with jax.enable_x64(False):
        rb, sc = JD.decode_raw(_jax_out(head_out), TS)
        return np.array(rb), np.array(sc)


def test_decode_raw_matches_jax(head_out, decoded):
    """Within 1e-4 px plus 1e-6 relative: XLA's CPU sin, cos and exp and
    PyTorch's differ in the last ulps, and a float32 ulp is 3e-5 px at
    256-512 px."""
    rb, sc = TD.decode_raw(_torch_out(head_out), TS)
    assert decoded[0].dtype == np.float32
    np.testing.assert_allclose(rb.numpy(), decoded[0], rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(sc.numpy(), decoded[1], rtol=0, atol=1e-6)


def test_anchors_match_jax():
    pj, sj = JD.make_anchors(TS)
    pt, st = TD.make_anchors(TS, "cpu")
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("conf_thr", [0.001, 0.25])
def test_postprocess_matches_jax(decoded, conf_thr):
    rb, sc = decoded
    ref = JD.postprocess_batch(jnp.asarray(rb), jnp.asarray(sc), conf_thr,
                               0.7, max_det=64, pre_topk=256)
    got = TD.postprocess_batch(torch.tensor(rb), torch.tensor(sc),
                               conf_thr, 0.7, max_det=64, pre_topk=256)
    valid = np.asarray(ref["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert valid.sum() > 0
    for key in ("cls", "conf"):
        np.testing.assert_array_equal(got[key].numpy()[valid],
                                      np.asarray(ref[key])[valid])
    for key in ("xywhr", "corners8"):
        np.testing.assert_allclose(got[key].numpy()[valid],
                                   np.asarray(ref[key])[valid],
                                   rtol=0, atol=1e-4)


def test_nms_keep_and_order_match_jax(decoded):
    """On the top-256 candidates of each tile at a low threshold (so that
    suppression happens): identical keep masks and compaction order."""
    rb, sc = decoded
    suppressed = 0
    for b in range(rb.shape[0]):
        conf = sc[b].max(-1)
        cls = sc[b].argmax(-1).astype(np.int32)
        idx = np.argsort(-conf, kind="stable")[:256]
        c8 = np.array(JG.xywhr_to_corners8(jnp.asarray(rb[b][idx])),
                        np.float32)
        cf, cl = conf[idx], cls[idx]
        valid = cf >= 0.001
        kj = np.array(JN.nms_keep_mask_oneshot(
            jnp.asarray(c8), jnp.asarray(cl), jnp.asarray(cf),
            jnp.asarray(valid), 0.7))
        kt = TN.nms_keep_mask_oneshot(
            torch.from_numpy(c8), torch.from_numpy(cl), torch.from_numpy(cf),
            torch.from_numpy(valid), 0.7).numpy()
        np.testing.assert_array_equal(kt, kj)
        suppressed += int((valid & ~kj).sum())
        oj, vj = JN.compact_topk(jnp.asarray(cf), jnp.asarray(kj), 64)
        ot, vt = TN.compact_topk(torch.from_numpy(cf), torch.from_numpy(kj),
                                 64)
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert suppressed > 0


def test_compact_topk_ties_keep_index_order():
    conf = torch.tensor([0.5, 0.9, 0.5, 0.9, 0.1])
    keep = torch.tensor([True, True, True, True, False])
    order, valid = TN.compact_topk(conf, keep, 5)
    assert order.tolist() == [1, 3, 0, 2, 4]
    assert valid.tolist() == [True, True, True, True, False]
    oj, _ = JN.compact_topk(jnp.asarray(conf.numpy()),
                            jnp.asarray(keep.numpy()), 5)
    assert np.asarray(oj).tolist() == order.tolist()


def test_topk_ties_take_lower_index_first():
    """postprocess_batch ranks candidates like lax.top_k: equal scores in
    index order."""
    sc = np.zeros((1, 6, 2), np.float32)
    sc[0, :, 0] = [0.3, 0.8, 0.3, 0.8, 0.5, 0.3]
    rb = np.zeros((1, 6, 5), np.float32)
    rb[0, :, 0] = np.arange(6) * 50.0 + 20
    rb[0, :, 1] = 20.0
    rb[0, :, 2:4] = 10.0
    ref = JD.postprocess_batch(jnp.asarray(rb), jnp.asarray(sc), 0.1, 0.7,
                               max_det=4, pre_topk=4)
    got = TD.postprocess_batch(torch.tensor(rb), torch.tensor(sc),
                               0.1, 0.7, max_det=4, pre_topk=4)
    np.testing.assert_array_equal(got["xywhr"].numpy(),
                                  np.asarray(ref["xywhr"]))
    assert got["xywhr"][0, :, 0].tolist() == [70.0, 170.0, 220.0, 20.0]
