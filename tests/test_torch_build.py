"""The port's build-at-first-use helper (utils/build.py): content-hashed
library names, reuse without rebuilding, and a loud failure."""

import pytest

from oriented_object_detection_tpu_torch.utils import build


def _cmd():
    return ["g++", "-O1", "-fPIC", "-shared"]


def test_builds_loads_and_reuses(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "b"))
    src = tmp_path / "one.cpp"
    src.write_text('extern "C" int one() { return 1; }\n')
    lib = build.build_shared_library("one", [str(src)], _cmd())
    assert lib.one() == 1
    built = sorted(p.name for p in (tmp_path / "b").iterdir())
    assert len(built) == 1 and built[0].startswith("libone-")
    mtime = (tmp_path / "b" / built[0]).stat().st_mtime_ns
    build.build_shared_library("one", [str(src)], _cmd())
    assert (tmp_path / "b" / built[0]).stat().st_mtime_ns == mtime


def test_edited_source_gets_a_new_library(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "b"))
    src = tmp_path / "v.cpp"
    src.write_text('extern "C" int v() { return 1; }\n')
    assert build.build_shared_library("v", [str(src)], _cmd()).v() == 1
    src.write_text('extern "C" int v() { return 2; }\n')
    assert build.build_shared_library("v", [str(src)], _cmd()).v() == 2
    assert len(list((tmp_path / "b").iterdir())) == 2


def test_compile_error_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "b"))
    src = tmp_path / "bad.cpp"
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="building bad failed"):
        build.build_shared_library("bad", [str(src)], _cmd())
    assert list((tmp_path / "b").iterdir()) == []   # no partial output
