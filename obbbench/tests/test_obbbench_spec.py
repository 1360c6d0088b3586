"""Every configuration, cell and metric of BENCHMARK.json loads by name,
and a cell, a configuration or a metric added as files is found with no
edit of the harness."""

from __future__ import annotations

import json
import os
import shutil

import pytest

import tiny
from obbbench.harness import spec

BENCH = spec.read_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
ALL = tiny.merged_bench()


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    """Every cell, the held-back ones too, at its own size."""
    return tiny.make(str(tmp_path_factory.mktemp("full")), small=False)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_benchmark_cell_loads_by_name(name):
    cell = spec.load_cell(name)
    assert cell.workload["limits"] and cell.per_layer


@pytest.mark.parametrize("name", [w["name"] for w in ALL["workloads"]])
def test_cell_loads_by_name(full, name):
    cell = spec.load_cell(name, spec.ROOT, full)
    assert cell.config["name"] == cell.workload["config"]
    for fn in ("setup", "window", "release", "reference", "readings"):
        assert callable(getattr(cell.driver, fn))
    assert cell.workload["limits"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end:
        assert callable(cell.module("end_to_end", m["name"]).value)
    for m in cell.per_layer:
        assert callable(cell.module("layer_metrics", m["name"]).value)
        assert m["moves"] in names


@pytest.mark.parametrize("kind,name", [
    (kind, e["name"]) for kind in ("configs", "workloads") for e in ALL[kind]])
def test_every_cell_and_config_has_a_tiny_file(kind, name):
    """Each cell and configuration, held-back ones too, has its size for
    the CPU tests, which changes only values the real file has."""
    small = tiny.sizes(kind, name)
    real = spec.read_json(
        os.path.join(spec.ROOT, {c["name"]: c["file"]
                                 for c in ALL["configs"]}[name])
        if kind == "configs" else
        os.path.join(spec.BENCH_DIR, "workloads", f"{name}.json"))
    assert small and set(small) <= set(real)
    assert set(small.get("params", {})) <= set(real.get("params", {}))


def test_every_config_file_is_under_paths():
    for c in ALL["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        cfg = spec.read_json(os.path.join(spec.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]


def test_added_cell_is_found_as_files(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "dual_folder_sheets_2048", "config": "yolo11x_obb_dual_bf16",
        "traffic": "folder_sheets_2048", "chips": 1, "why": "smaller sheets"})
    for m in bench["end_to_end"]:
        if m["name"] == "detect_mpix_per_s":
            m["workloads"].append("dual_folder_sheets_2048")
    (tmp_path / "workloads").mkdir()
    (tmp_path / "configs").mkdir()
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    wl = spec.read_json(os.path.join(spec.BENCH_DIR, "workloads",
                                     "dual_folder_sheets.json"))
    wl.update(name="dual_folder_sheets_2048", traffic="folder_sheets_2048")
    wl["params"].update(height=2048, width=2048)
    with open(tmp_path / "workloads" / "dual_folder_sheets_2048.json",
              "w") as f:
        json.dump(wl, f)
    shutil.copy(os.path.join(spec.BENCH_DIR, "configs",
                             "yolo11x_obb_dual_bf16.json"),
                tmp_path / "configs")
    cell = spec.load_cell("dual_folder_sheets_2048", spec.ROOT,
                          str(tmp_path))
    assert cell.workload["params"]["height"] == 2048
    assert cell.driver.__name__.endswith("detect_stream")
    assert {m["name"] for m in cell.end_to_end} == {
        "detect_mpix_per_s", "peak_mem_gib", "setup_s"}
    assert cell.per_layer == []       # no per-layer metric lists it yet


def test_added_metric_is_found_as_a_file(tmp_path):
    (tmp_path / "layer_metrics").mkdir()
    (tmp_path / "layer_metrics" / "new_metric.detect_folder.py").write_text(
        "def value(trace, record, cell):\n    return 42.0\n")
    cell = spec.load_cell("dual_folder_sheets")
    cell.data_dir = str(tmp_path)
    mod = cell.module("layer_metrics", "new_metric.detect_folder")
    assert mod.value(None, {}, cell) == 42.0


@pytest.mark.parametrize("own_first", [False, True])
def test_a_data_directory_module_is_its_own(tmp_path, own_first):
    """A module of one group and name, from the benchmark's folder and
    from a data directory, loads as two modules in one process, in either
    order, each from its own file."""
    name = "detect_mpix_per_s"
    (tmp_path / "end_to_end").mkdir()
    (tmp_path / "end_to_end" / f"{name}.py").write_text(
        "def value(record, cell):\n    return -1.0\n")
    bench_cell = spec.load_cell("dual_folder_sheets")
    own_cell = spec.load_cell("dual_folder_sheets")
    own_cell.data_dir = str(tmp_path)
    order = [own_cell, bench_cell] if own_first else [bench_cell, own_cell]
    mods = {id(c): c.module("end_to_end", name) for c in order}
    own, theirs = mods[id(own_cell)], mods[id(bench_cell)]
    assert own is not theirs
    assert own.__file__ == str(tmp_path / "end_to_end" / f"{name}.py")
    assert theirs.__file__ == os.path.join(spec.BENCH_DIR, "end_to_end",
                                           f"{name}.py")
    assert own.value({}, own_cell) == -1.0


def test_metric_without_workloads_follows_its_end_to_end_metric(tmp_path):
    bench = json.loads(json.dumps(ALL))
    bench["per_layer"].append({
        "name": "steps_seen", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "device",
        "moves": "train_step_s"})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    shutil.copytree(os.path.join(spec.BENCH_DIR, "workloads"),
                    tmp_path / "workloads")
    shutil.copytree(os.path.join(spec.BENCH_DIR, "configs"),
                    tmp_path / "configs")
    train = spec.load_cell("train416_b16", spec.ROOT, str(tmp_path))
    detect = spec.load_cell("dual_folder_sheets", spec.ROOT, str(tmp_path))
    assert "steps_seen" in {m["name"] for m in train.per_layer}
    assert "steps_seen" not in {m["name"] for m in detect.per_layer}
