"""The PyTorch port stands alone: importing every module of it (and the
chip smoke script) pulls in no jax, flax, cv2 or PIL and no module of the
JAX package, and its entry points never fall back to the CPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "oriented_object_detection_tpu_torch",
    "oriented_object_detection_tpu_torch.config",
    "oriented_object_detection_tpu_torch.cli",
    "oriented_object_detection_tpu_torch.infer.pipeline",
    "oriented_object_detection_tpu_torch.models.decode",
    "oriented_object_detection_tpu_torch.models.fold",
    "oriented_object_detection_tpu_torch.models.layers",
    "oriented_object_detection_tpu_torch.models.weights",
    "oriented_object_detection_tpu_torch.models.yolo11_obb",
    "oriented_object_detection_tpu_torch.ops.dtedge",
    "oriented_object_detection_tpu_torch.ops.edt",
    "oriented_object_detection_tpu_torch.ops.geometry",
    "oriented_object_detection_tpu_torch.ops.nms",
    "oriented_object_detection_tpu_torch.ops.tiling",
    "oriented_object_detection_tpu_torch.utils.build",
    "oriented_object_detection_tpu_torch.utils.native",
    "oriented_object_detection_tpu_torch.utils.runtime",
    "oriented_object_detection_tpu_torch.utils.xlsx",
    "chip_smoke",
]


def test_port_imports_no_jax_cv2_or_jax_package():
    code = textwrap.dedent(f"""
        import importlib, json, sys
        sys.path.insert(0, {REPO!r})
        for name in {PORT_MODULES!r}:
            importlib.import_module(name)
        import chip_smoke
        chip_smoke.synthetic_map(0, H=64, W=64, n_obj=2, n_lines=1)
        pkg = "oriented_object_detection_tpu"
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2",
                                            "PIL")
                     or m == pkg or m.startswith(pkg + "."))
        print(json.dumps(bad))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_import_check_is_prefix_safe():
    """The JAX package's name is a prefix of the port's: the check above
    must flag the one and not the other."""
    pkg = "oriented_object_detection_tpu"
    flag = lambda m: m == pkg or m.startswith(pkg + ".")
    assert flag("oriented_object_detection_tpu.ops.edt")
    assert flag(pkg)
    assert not flag("oriented_object_detection_tpu_torch.ops.edt")


def test_default_device_without_cuda_raises(monkeypatch):
    from oriented_object_detection_tpu_torch.utils import runtime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.resolve_device(None)
    assert runtime.resolve_device("cpu") == torch.device("cpu")


def test_detector_without_cuda_raises(monkeypatch):
    from oriented_object_detection_tpu_torch.infer.pipeline import (
        detector_from_checkpoint)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detector_from_checkpoint(
            os.path.join(REPO, "assets/bench_ckpts/train416_4ch.ckpt"))


@pytest.mark.parametrize("fn", ["edt_pass1_columns", "edt_pass2_rows"])
def test_kernel_wrappers_never_fall_back_off_the_cpu(fn):
    """A tensor that is not on the CPU never takes the plain version: here
    a meta tensor is refused outright."""
    from oriented_object_detection_tpu_torch.ops import edt as E

    x = torch.empty((2, 8, 8) if fn == "edt_pass1_columns" else (8, 8),
                    dtype=torch.bool if fn == "edt_pass1_columns"
                    else torch.float32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(E, fn)(x)


def test_chip_smoke_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this checks the run on a machine without CUDA")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_synthetic_map_is_seeded():
    sys.path.insert(0, REPO)
    import chip_smoke

    a = chip_smoke.synthetic_map(3, H=96, W=128, n_obj=4, n_lines=2)
    b = chip_smoke.synthetic_map(3, H=96, W=128, n_obj=4, n_lines=2)
    assert a.shape == (96, 128, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
