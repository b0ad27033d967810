"""The kernel builder (ops/_build.py) on the CPU: what names a library.

A library is named by a hash of its source, every header that source
includes from `csrc/`, and nvcc's flags, so that editing any of them builds
a new library instead of loading a stale one.  Run on a copy of `csrc/`;
nothing is compiled.
"""

import shutil
from pathlib import Path

import pytest

from blindshadowremoval_tpu_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    shutil.copytree(_build._PKG / "csrc", tmp_path / "csrc")
    monkeypatch.setattr(_build, "_PKG", tmp_path)
    return tmp_path / "csrc"


def test_source_files_follow_quoted_includes(csrc_copy):
    assert [p.name for p in _build.source_files("nonlocal_attn")] == [
        "nonlocal_attn.cu", "hopper.cuh"]
    assert [p.name for p in _build.source_files("nonlocal_attn_bwd")] == [
        "nonlocal_attn_bwd.cu", "hopper.cuh"]
    assert [p.name for p in _build.source_files("rasterize")] == [
        "rasterize.cu"]


def test_source_files_follow_nested_includes(csrc_copy):
    (csrc_copy / "inner.cuh").write_text("// nested\n")
    header = csrc_copy / "hopper.cuh"
    header.write_text('#include "inner.cuh"\n' + header.read_text())
    assert [p.name for p in _build.source_files("nonlocal_attn")] == [
        "nonlocal_attn.cu", "hopper.cuh", "inner.cuh"]


@pytest.mark.parametrize("edited,name,moves", [
    ("hopper.cuh", "nonlocal_attn", True),        # an included header
    ("nonlocal_attn.cu", "nonlocal_attn", True),  # the source itself
    ("hopper.cuh", "nonlocal_attn_bwd", True),    # the header K2 shares
    ("nonlocal_attn_bwd.cu", "nonlocal_attn_bwd", True),
    ("nonlocal_attn.cu", "nonlocal_attn_bwd", False),   # a source it does
    ("nonlocal_attn_bwd.cu", "nonlocal_attn", False),   # not include
    ("rasterize.cu", "rasterize", True),
    ("hopper.cuh", "rasterize", False),
    ("rasterize.cu", "nonlocal_attn", False),
])
def test_library_path_follows_what_the_source_includes(csrc_copy, edited,
                                                       name, moves):
    before = _build.library_path(name)
    path = csrc_copy / edited
    path.write_text(path.read_text() + "\n// edited\n")
    assert (_build.library_path(name) != before) is moves


def test_library_path_follows_the_flags(csrc_copy, monkeypatch):
    before = _build.library_path("nonlocal_attn")
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        _build.NVCC_FLAGS + ("-I", "/elsewhere"))
    assert _build.library_path("nonlocal_attn") != before


def test_library_path_is_stable(csrc_copy):
    first = _build.library_path("nonlocal_attn")
    assert _build.library_path("nonlocal_attn") == first
    assert first.parent == _build.BUILD_DIR
    assert first.name.startswith("libnonlocal_attn-")
    assert Path(first).suffix == ".so"
