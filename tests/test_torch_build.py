"""The port's kernel build cache: a library's name hashes its source, every
header the source includes and the flags, so an edited header rebuilds the
kernels that include it. Needs no nvcc: only the target paths are computed."""

import shutil

import pytest

from vitsom_tpu_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A temporary copy of ``csrc/`` that ``_build`` reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", copy)
    return copy


@pytest.mark.parametrize("name", ["attention", "block"])
def test_sources_list_the_shared_header(name):
    assert [p.name for p in _build.sources(name)] == [f"{name}.cu", "tf32_mma.cuh"]


@pytest.mark.parametrize("name", ["attention", "block"])
def test_editing_a_header_changes_the_target(csrc_copy, name):
    before = _build.target_path(name)
    assert before == _build.target_path(name)  # stable for unchanged bytes
    header = csrc_copy / "tf32_mma.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert _build.target_path(name) != before


def test_editing_a_header_leaves_other_sources(csrc_copy):
    before = _build.target_path("som_fused")
    header = csrc_copy / "tf32_mma.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert _build.target_path("som_fused") == before


def test_editing_the_source_changes_the_target(csrc_copy):
    before = _build.target_path("block")
    src = csrc_copy / "block.cu"
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    assert _build.target_path("block") != before
