"""The PyTorch port stands alone: importing every module of it (and the
chip smoke script) pulls in no jax, flax, cv2, PIL, matplotlib or yaml and
no module of the JAX package, and its entry points never fall back to the
CPU."""

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
    "oriented_object_detection_tpu_torch.data.config_yaml",
    "oriented_object_detection_tpu_torch.data.dataset",
    "oriented_object_detection_tpu_torch.data.labels",
    "oriented_object_detection_tpu_torch.data.loader",
    "oriented_object_detection_tpu_torch.eval.metrics",
    "oriented_object_detection_tpu_torch.eval.val",
    "oriented_object_detection_tpu_torch.infer.fusion",
    "oriented_object_detection_tpu_torch.infer.pipeline",
    "oriented_object_detection_tpu_torch.models.calibrate",
    "oriented_object_detection_tpu_torch.models.decode",
    "oriented_object_detection_tpu_torch.models.fold",
    "oriented_object_detection_tpu_torch.models.layers",
    "oriented_object_detection_tpu_torch.models.pt_reader",
    "oriented_object_detection_tpu_torch.models.weights",
    "oriented_object_detection_tpu_torch.models.yolo11_obb",
    "oriented_object_detection_tpu_torch.ops.dtedge",
    "oriented_object_detection_tpu_torch.ops.edt",
    "oriented_object_detection_tpu_torch.ops.augment",
    "oriented_object_detection_tpu_torch.ops.geometry",
    "oriented_object_detection_tpu_torch.ops.image",
    "oriented_object_detection_tpu_torch.ops.nms",
    "oriented_object_detection_tpu_torch.ops.tiling",
    "oriented_object_detection_tpu_torch.ops.warp",
    "oriented_object_detection_tpu_torch.train.assigner",
    "oriented_object_detection_tpu_torch.train.loss",
    "oriented_object_detection_tpu_torch.train.trainer",
    "oriented_object_detection_tpu_torch.utils.build",
    "oriented_object_detection_tpu_torch.utils.native",
    "oriented_object_detection_tpu_torch.utils.plots",
    "oriented_object_detection_tpu_torch.utils.profiling",
    "oriented_object_detection_tpu_torch.utils.runtime",
    "oriented_object_detection_tpu_torch.utils.xlsx",
    "chip_smoke",
]


def test_port_imports_no_jax_cv2_or_jax_package():
    code = textwrap.dedent(f"""
        import importlib, json, sys
        import torch
        torch.set_num_threads(1)  # parallel test workers share the cores
        sys.path.insert(0, {REPO!r})
        for name in {PORT_MODULES!r}:
            importlib.import_module(name)
        # the plots import matplotlib and yaml where they are installed,
        # inside the functions that write the run directory's files
        at_import = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("matplotlib", "yaml"))
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
        # a loader batch, a train step with its checkpoint, and a
        # validation, all from tiles fed through the reader
        import os, tempfile
        from oriented_object_detection_tpu_torch.config import TrainConfig
        from oriented_object_detection_tpu_torch.data import labels
        from oriented_object_detection_tpu_torch.data.loader import (
            TileDataset)
        from oriented_object_detection_tpu_torch.eval.val import (
            validate_tiles)
        from oriented_object_detection_tpu_torch.train import trainer
        with tempfile.TemporaryDirectory() as tmp:
            os.makedirs(tmp + "/images/t")
            os.makedirs(tmp + "/labels/t")
            paths = [f"{{tmp}}/images/t/{{k}}.jpg" for k in range(2)]
            for p in paths:
                labels.write_labels(p.replace("images", "labels")[:-4]
                                    + ".txt", np.array([[1, .2, .2, .6, .2,
                                                         .6, .5, .2, .5]]))
            with open(tmp + "/list.txt", "w") as f:
                f.write("\\n".join(paths))
            tiles = {{p: np.full((32, 32, 3), 40 * k, np.uint8)
                     for k, p in enumerate(paths)}}
            ds = TileDataset(tmp + "/list.txt", 32, device="cpu",
                             reader=tiles.__getitem__)
            cfg = TrainConfig(tile_size=32, batch_size=2, model_scale="n",
                              epochs=1, plots=False)
            st = trainer.create_train_state(cfg, 1, device="cpu")
            trainer.fit(st, cfg, lambda e: ds.batches(
                2, np.random.RandomState(0)), val_fn=lambda s:
                validate_tiles(s.eval_model(), ds, cfg), ckpt_dir=tmp)
            assert os.path.exists(tmp + "/last.ckpt")
            # the new modules at work: a .pt read back, a letterbox, a
            # density calibration, a timed stage
            from oriented_object_detection_tpu_torch.models import (
                calibrate, pt_reader)
            from oriented_object_detection_tpu_torch.models.yolo11_obb \
                import YOLO11OBB
            from oriented_object_detection_tpu_torch.ops import image
            from oriented_object_detection_tpu_torch.utils import profiling
            torch.save({{"w": torch.ones(3).half()}}, tmp + "/w.pt")
            assert pt_reader.read_pt_state_dict(tmp + "/w.pt")["w"].sum() == 3
            with profiling.timed("letterbox"):
                image.letterbox(torch.zeros((5, 7, 3)), 8)
            from oriented_object_detection_tpu_torch.infer.pipeline import (
                random_variables)
            calibrate.calibrate_density(YOLO11OBB(scale="n"),
                                        random_variables(12, "n", 3), 32, 3,
                                        device="cpu")
        pkg = "oriented_object_detection_tpu"
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2",
                                            "PIL")
                     or m == pkg or m.startswith(pkg + ".")) + at_import
        print(json.dumps(bad))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


IMPORTED_INSIDE = {
    "cv2": {("cli.py", "_detect"), ("data/labels.py", "load_gt_as_pixels"),
            ("infer/pipeline.py", "draw_detections"),
            ("infer/pipeline.py", "process_image"),
            ("infer/pipeline.py", "write_outputs"),
            ("data/dataset.py", "build_train_tiles"),
            ("data/dataset.py", "save_selected_empty_tiles"),
            ("data/dataset.py", "build_val_tiles"),
            ("data/dataset.py", "_augment_tile"),
            ("data/dataset.py", "balance_classes"),
            ("data/dataset.py", "convert_folder_to_4ch_tiff"),
            ("data/loader.py", "load_tile"),
            ("data/loader.py", "_read_sized"),
            ("eval/val.py", "_letterbox_np"),
            ("utils/plots.py", "_plot_train_batch")},
    "matplotlib": {("utils/plots.py", "_plot")},
    "yaml": {("data/config_yaml.py", "load_data_yaml"),
             ("utils/plots.py", "write_args_yaml")},
}


def test_cv2_is_imported_only_where_images_are_read():
    """The card's machine has no cv2: only the functions that read, write
    or draw images import it, inside their bodies."""
    assert _importers("cv2") == IMPORTED_INSIDE["cv2"]


@pytest.mark.parametrize("lib", ["matplotlib", "yaml"])
def test_plot_and_yaml_libraries_are_imported_only_inside(lib):
    """Nor matplotlib or yaml: only the plot and yaml functions import
    them, inside their bodies."""
    assert _importers(lib) == IMPORTED_INSIDE[lib]


def _importers(lib: str) -> set:
    """(file, enclosing function) of every import of ``lib`` in the port."""
    import ast

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
                if not any(n and n.split(".")[0] == lib for n in names):
                    continue
                fn = parent.get(node)
                while fn is not None and not isinstance(fn, ast.FunctionDef):
                    fn = parent.get(fn)
                found.add((rel, fn.name if fn else "<module>"))
    return found


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


@pytest.mark.parametrize("cmd", ["train", "val"])
def test_train_and_val_without_cuda_raise(cmd, monkeypatch, tmp_path):
    """Without --device cpu both commands want the card, before any work."""
    from oriented_object_detection_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"train": ["train", "--data-root", str(tmp_path)],
            "val": ["val", "--ckpt", os.path.join(
                REPO, "assets/bench_ckpts/train128.ckpt"), "--data-root",
                str(tmp_path)]}[cmd]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    assert not os.listdir(tmp_path)


def test_4ch_core_never_takes_the_plain_edt_off_the_cpu():
    """The 4-channel dataset core on a tensor that is not on the CPU goes
    to the EDT kernels' wrappers, which refuse a meta tensor outright."""
    from oriented_object_detection_tpu_torch.data import dataset as DS

    with pytest.raises(ValueError, match="unsupported device"):
        DS.tiles_to_4ch(torch.zeros((2, 32, 32, 3), dtype=torch.uint8,
                                    device="meta"))


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
