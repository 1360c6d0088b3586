"""The port's ``.pt`` reader (models/pt_reader.py), its ultralytics
conversion (models/weights.py: ``convert_state_dict``, ``validate_against``,
``export_state_dict``) and ``cli.py convert``, against the JAX package's on
checkpoints written here with ``torch.save``; and the reader's refusal of
crafted files, which only the port's reader is given (the JAX reader reads
past a storage on them)."""

import io
import os
import pickle
import sys
import types
import zipfile
from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

import oriented_object_detection_tpu.models as JM
from oriented_object_detection_tpu import cli as jax_cli
from oriented_object_detection_tpu.models import pt_reader as JR
from oriented_object_detection_tpu.models import weights as JW
from oriented_object_detection_tpu_torch import cli
from oriented_object_detection_tpu_torch.models import pt_reader as PR
from oriented_object_detection_tpu_torch.models import weights as PW
from oriented_object_detection_tpu_torch.models.yolo11_obb import YOLO11OBB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
from tools.train_synthetic import gen_map  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

CKPT_4CH = os.path.join(REPO, "assets", "bench_ckpts", "train416_4ch.ckpt")
JAX_YOLO = JM.YOLO11OBB


def _same_state_dicts(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_tensor_zoo_equals_the_jax_reader(tmp_path):
    t = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    base = torch.arange(10, dtype=torch.float32)
    zoo = {
        "a": t,
        "b": t.t(),                        # non-contiguous, shared storage
        "h": torch.randn(3, 3).half(),
        "bf": torch.randn(2, 5).bfloat16(),
        "i": torch.arange(7, dtype=torch.int64),
        "slice": base[2:9],                # nonzero storage offset
        "strided": base[::3],
        "scalar": torch.tensor(3.5),
        "empty": torch.zeros(0, 3),
        "bool": torch.tensor([True, False, True]),
    }
    p = str(tmp_path / "zoo.pt")
    torch.save(zoo, p)
    got = PR.read_pt_state_dict(p)
    _same_state_dicts(got, JR.read_pt_state_dict(p))
    for k, v in zoo.items():
        ref = v.float() if v.dtype in (torch.float16, torch.bfloat16) else v
        np.testing.assert_array_equal(got[k], ref.numpy())
    assert got["h"].dtype == got["bf"].dtype == np.float32


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, bias=False)
        self.bn = nn.BatchNorm2d(8)


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.model = nn.Sequential(_Block(), nn.Conv2d(8, 4, 1))


def test_ema_preference_equals_the_jax_reader(tmp_path):
    m, ema = _Tiny().half(), _Tiny()
    with torch.no_grad():
        for q in ema.parameters():
            q.fill_(7.0)
    p = str(tmp_path / "ck.pt")
    torch.save({"epoch": 3, "model": m, "ema": None,
                "train_args": {"imgsz": 416}}, p)
    got = PR.read_pt_state_dict(p)
    _same_state_dicts(got, JR.read_pt_state_dict(p))
    _same_state_dicts(got, {k: v.float().numpy() if v.is_floating_point()
                            else v.numpy() for k, v in m.state_dict().items()})
    torch.save({"model": m, "ema": ema}, p)
    got = PR.read_pt_state_dict(p)
    _same_state_dicts(got, JR.read_pt_state_dict(p))
    assert (got["model.1.weight"] == 7.0).all()


class _StorageRef:
    pass


class _View:
    """Pickles as ``_rebuild_tensor_v2(storage, offset, size, stride)``."""

    def __init__(self, offset, size, stride):
        self.args = (offset, size, stride)

    def __reduce__(self):
        return (torch._utils._rebuild_tensor_v2,
                (_StorageRef(), *self.args, False, OrderedDict()))


def _crafted_pt(path, view: _View, numel: int, nbytes: int) -> None:
    """A torch zip checkpoint {'w': view} of one float32 storage that
    declares ``numel`` elements and holds ``nbytes`` bytes."""
    class P(pickle.Pickler):
        def persistent_id(self, obj):
            if isinstance(obj, _StorageRef):
                return ("storage", torch.FloatStorage, "0", "cpu", numel)
            return None

    buf = io.BytesIO()
    P(buf, protocol=2).dump(OrderedDict(w=view))
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("archive/data.pkl", buf.getvalue())
        zf.writestr("archive/version", "3\n")
        zf.writestr("archive/byteorder", "little")
        zf.writestr("archive/data/0", bytes(nbytes))


@pytest.mark.parametrize("view, numel, nbytes", [
    (_View(0, (4096,), (1,)), 4, 16),
    (_View(0, (3, 2), (2, 1)), 4, 16),
    (_View(3, (2,), (1,)), 4, 16),
    (_View(-1, (2,), (1,)), 4, 16),
    (_View(2, (2,), (-1,)), 4, 16),
    (_View(0, (-2,), (1,)), 4, 16),
    (_View(0, (4,), (1,)), 8, 16),
], ids=["size_past_storage", "stride_past_storage", "offset_past_storage",
        "negative_offset", "negative_stride", "negative_size",
        "storage_shorter_than_numel"])
def test_reader_refuses_views_outside_their_storage(tmp_path, view, numel,
                                                    nbytes):
    p = str(tmp_path / "crafted.pt")
    _crafted_pt(p, view, numel, nbytes)
    with pytest.raises(pickle.UnpicklingError):
        PR.read_pt_state_dict(p)


def test_reader_takes_a_view_that_ends_on_the_storage(tmp_path):
    p = str(tmp_path / "edge.pt")
    _crafted_pt(p, _View(1, (3,), (1,)), 4, 16)
    np.testing.assert_array_equal(PR.read_pt_state_dict(p)["w"],
                                  np.zeros(3, np.float32))


@pytest.mark.parametrize("shape", ["cycle", "deep"])
def test_module_walk_refuses_cyclic_and_deep_graphs(tmp_path, shape):
    root = nn.Module()
    root.register_parameter("w", nn.Parameter(torch.ones(2)))
    if shape == "cycle":
        child = nn.Module()
        root.add_module("child", child)
        child._modules["back"] = root
    else:
        node = root
        for _ in range(PR.MAX_MODULE_DEPTH + 1):
            nxt = nn.Module()
            node.add_module("m", nxt)
            node = nxt
    p = str(tmp_path / "graph.pt")
    torch.save({"model": root}, p)
    with pytest.raises(pickle.UnpicklingError, match=shape[:4]):
        PR.read_pt_state_dict(p)


def _fake_ultralytics_pt(path, scale: str, channels: int, seed: int,
                         monkeypatch) -> dict:
    """``torch.save`` of {'model': <the port's YOLO11OBB tree under a stub
    ``ultralytics.nn.tasks.OBBModel``>, 'ema': None}, in fp16 as
    ultralytics saves, with the DFL conv ultralytics keeps; the stub module
    is in ``sys.modules`` only while saving. Returns its state dict."""
    torch.manual_seed(seed)
    m = YOLO11OBB(nc=12, scale=scale, in_channels=channels)
    m.model["23"].add_module("dfl", nn.Module())
    m.model["23"].dfl.add_module("conv", nn.Conv2d(16, 1, 1, bias=False))
    with torch.no_grad():
        for name, b in m.named_buffers():
            if b.is_floating_point():
                b.uniform_(0.5, 1.5)
    m = m.half()
    pkg = types.ModuleType("ultralytics.nn.tasks")

    class OBBModel(nn.Module):
        pass

    OBBModel.__module__ = "ultralytics.nn.tasks"
    OBBModel.__qualname__ = "OBBModel"
    pkg.OBBModel = OBBModel
    wrapper = OBBModel()
    wrapper.model = m.model
    with monkeypatch.context() as mp:
        for k in ("ultralytics", "ultralytics.nn"):
            mp.setitem(sys.modules, k, types.ModuleType(k))
        mp.setitem(sys.modules, "ultralytics.nn.tasks", pkg)
        torch.save({"epoch": 9, "model": wrapper, "ema": None,
                    "train_args": {"imgsz": 64, "task": "obb"}}, path)
    assert "ultralytics" not in sys.modules
    return wrapper.state_dict()


class _JaxShapeModel:
    """The JAX ``convert``'s reference model with ``init`` evaluated
    abstractly: the flax init's tree and shapes, as zeros, without its 45 s
    of eager init on the CPU."""

    def __init__(self, **kw):
        self.m = JAX_YOLO(**kw)

    def init(self, rng, x):
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                            jax.eval_shape(self.m.init, rng, x))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("channels", [3, 4])
def test_convert_equals_the_jax_convert(tmp_path, monkeypatch, capsys,
                                        channels):
    """The same fake ultralytics checkpoint through both packages'
    ``convert``: the written checkpoints array for array, the same
    ``extra`` and the same report (all 453 arrays, none missing)."""
    pt = str(tmp_path / "best.pt")
    _fake_ultralytics_pt(pt, "n", channels, channels, monkeypatch)
    argv = ["convert", pt, "--scale", "n", "--channels", str(channels),
            "--imgsz", "64"]
    cli.main(argv + ["--out", str(tmp_path / "port.ckpt")])
    port_out = capsys.readouterr().out
    monkeypatch.setattr(JM, "YOLO11OBB", _JaxShapeModel)
    jax_cli.main(argv + ["--out", str(tmp_path / "jax.ckpt")])
    jax_out = capsys.readouterr().out
    report = [ln for ln in port_out.splitlines() if "matched" in ln]
    assert report == ["[Convert] matched 453 arrays; missing=0 extra=0 "
                      "mismatched=0"]
    assert report == [ln for ln in jax_out.splitlines() if "matched" in ln]

    with open(tmp_path / "port.ckpt", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax.ckpt", "rb") as f:
        ref = pickle.load(f)
    assert got["extra"] == ref["extra"] and got["step"] == ref["step"] == 0
    for key in ("params", "batch_stats", "ema_params"):
        g, r = dict(_flat(got[key])), dict(_flat(ref[key]))
        assert list(g) == list(r)
        for k in g:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=str(k))


def test_stem_channels_reverse_and_round_trip():
    """A 4-channel stem reverses all four input channels both ways, and
    ``export_state_dict`` inverts ``convert_state_dict`` as the JAX
    package's does."""
    from oriented_object_detection_tpu_torch.models.weights import (
        load_checkpoint, variables_from_checkpoint)

    variables = variables_from_checkpoint(load_checkpoint(CKPT_4CH))
    for rev in (False, True):
        sd = PW.export_state_dict(variables, reverse_stem_channels=rev)
        ref = JW.export_state_dict(variables, reverse_stem_channels=rev)
        assert list(sd) == list(ref)
        for k in sd:
            np.testing.assert_array_equal(sd[k], ref[k])
        back = PW.convert_state_dict(sd, reverse_stem_channels=rev)
        for coll in ("params", "batch_stats"):
            a, b = dict(_flat(back[coll])), dict(_flat(variables[coll]))
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    k = PW.export_state_dict(variables, True)["model.0.conv.weight"]
    np.testing.assert_array_equal(
        k, variables["params"]["l0"]["conv"]["kernel"][:, :, ::-1, :]
        .transpose(3, 2, 0, 1))


def test_validate_against_equals_jax_and_convert_refuses_gaps(tmp_path):
    """A state dict missing one conv and with one wrong shape: the same
    report in both packages, and ``convert`` refuses it unless
    ``--force``; an ``.npz`` dump is read as a ``.pt`` is."""
    sd = {k: v.numpy() for k, v in YOLO11OBB(nc=12, scale="n")
          .state_dict().items()}
    del sd["model.2.cv1.conv.weight"]
    sd["model.0.bn.weight"] = np.zeros(3, np.float32)
    sd["model.9.extra.weight"] = np.zeros(2, np.float32)
    variables = PW.convert_state_dict(sd)
    ref_vars = PW.jax_trees_from_torch_state(
        YOLO11OBB(nc=12, scale="n").state_dict())
    rep = PW.validate_against(variables, ref_vars)
    jrep = JW.validate_against(JW.convert_state_dict(sd), ref_vars)
    assert rep == jrep
    assert rep["missing"] == [("l2", "cv1", "conv", "kernel")]
    assert [m[0] for m in rep["mismatched"]] == [("l0", "bn", "scale")]

    npz = str(tmp_path / "sd.npz")
    np.savez(npz, **sd)
    out = str(tmp_path / "o.ckpt")
    with pytest.raises(SystemExit, match="conversion incomplete"):
        cli.main(["convert", npz, "--out", out, "--scale", "n"])
    assert not os.path.exists(out)
    cli.main(["convert", npz, "--out", out, "--scale", "n", "--force"])
    with open(out, "rb") as f:
        ck = pickle.load(f)
    np.testing.assert_array_equal(ck["params"]["l0"]["bn"]["scale"],
                                  np.zeros(3, np.float32))


def test_convert_refuses_a_crafted_pt(tmp_path):
    p = str(tmp_path / "crafted.pt")
    _crafted_pt(p, _View(0, (4096,), (1,)), 4, 16)
    with pytest.raises(SystemExit, match="cannot read"):
        cli.main(["convert", p, "--out", str(tmp_path / "o.ckpt")])


def test_converted_checkpoint_detects_as_the_original(tmp_path, monkeypatch):
    """``train416_4ch.ckpt`` exported as a fake ultralytics ``.pt``
    (``reverse_stem_channels``), converted back: the same rows from the
    same map."""
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        build_detector)
    from oriented_object_detection_tpu_torch.models.weights import (
        load_checkpoint, variables_from_checkpoint)

    sd = PW.export_state_dict(variables_from_checkpoint(
        load_checkpoint(CKPT_4CH)), reverse_stem_channels=True)
    tree = nn.Module()
    for key, val in sd.items():
        *mods, leaf = key.split(".")
        node = tree
        for name in mods:
            if name not in node._modules:
                node.add_module(name, nn.Module())
            node = node._modules[name]
        node.register_buffer(leaf, torch.from_numpy(np.ascontiguousarray(
            val)))
    pt = str(tmp_path / "exported.pt")
    torch.save({"model": tree, "ema": None}, pt)
    out = str(tmp_path / "back.ckpt")
    cli.main(["convert", pt, "--out", out, "--scale", "n", "--channels",
              "4", "--imgsz", "416"])
    img = gen_map(np.random.RandomState(7), H=420, W=430, n_obj=12)[0]
    a, b = (build_detector([(416, 100, ck)], channels=4, device="cpu")
            .predict_crop(img) for ck in (CKPT_4CH, out))
    assert len(a) > 0
    np.testing.assert_array_equal(a.rows, b.rows)
