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
    "oriented_object_detection_tpu_torch.data.labels",
    "oriented_object_detection_tpu_torch.eval.metrics",
    "oriented_object_detection_tpu_torch.infer.fusion",
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
        import numpy as np
        from oriented_object_detection_tpu_torch.eval import metrics
        from oriented_object_detection_tpu_torch.infer import fusion
        d = np.zeros((1, 11))
        d[0, :8] = [0, 0, 9, 0, 9, 9, 0, 9]
        d[0, 9] = 0.9
        fusion.cross_scale_consensus_filter({{128: d, 416: d}})
        cache = metrics.GTCache(loader=lambda _: np.zeros((0, 9)))
        metrics.evaluate_map({{"a": d}}, ["a"], [0.5], cache)
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


def test_cv2_is_imported_only_where_images_are_read():
    """The card's machine has no cv2: only the functions that read or draw
    images import it, inside their bodies."""
    import ast

    allowed = {("cli.py", "_detect"), ("data/labels.py", "load_gt_as_pixels"),
               ("infer/pipeline.py", "draw_detections"),
               ("infer/pipeline.py", "process_image")}
    root = os.path.join(REPO, "oriented_object_detection_tpu_torch")
    found = set()
    for dirpath, _, files in os.walk(root):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root)
            with open(path) as f:
                tree = ast.parse(f.read())
            parent = {c: n for n in ast.walk(tree)
                      for c in ast.iter_child_nodes(n)}
            for node in ast.walk(tree):
                names = [a.name for a in node.names] if isinstance(
                    node, ast.Import) else [node.module] if isinstance(
                    node, ast.ImportFrom) else []
                if not any(n and n.split(".")[0] == "cv2" for n in names):
                    continue
                fn = parent.get(node)
                while fn is not None and not isinstance(fn, ast.FunctionDef):
                    fn = parent.get(fn)
                found.add((rel, fn.name if fn else "<module>"))
    assert found == allowed


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
        build_detector)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_detector([(416, 100, os.path.join(
            REPO, "assets/bench_ckpts/train416_4ch.ckpt"))], channels=4)


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
    """Seeded map and ground truth; the last rectangle drawn is where its
    ground truth says, in its class's palette color."""
    sys.path.insert(0, REPO)
    import chip_smoke

    a, gt_a = chip_smoke.synthetic_map(3, H=96, W=128, n_obj=4, n_lines=2)
    b, gt_b = chip_smoke.synthetic_map(3, H=96, W=128, n_obj=4, n_lines=2)
    assert a.shape == (96, 128, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gt_a, gt_b)
    assert gt_a.shape == (4, 9)
    assert set(gt_a[:, 0]) <= set(range(len(chip_smoke.PALETTE)))
    assert (gt_a[:, 1::2] >= 0).all() and (gt_a[:, 1::2] <= 128).all()
    assert (gt_a[:, 2::2] >= 0).all() and (gt_a[:, 2::2] <= 96).all()
    cx, cy = gt_a[-1, 1::2].mean(), gt_a[-1, 2::2].mean()
    assert tuple(a[int(round(cy)), int(round(cx))]) == \
        chip_smoke.PALETTE[int(gt_a[-1, 0])]
