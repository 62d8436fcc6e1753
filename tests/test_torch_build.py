"""The port's kernel build (``dreamllm_tpu_torch/ops/_build.py``) on the CPU:
which sources it compiles and when a library's name, and so a rebuild,
changes. Nothing here runs nvcc."""

from __future__ import annotations

import shutil

import pytest

from dreamllm_tpu_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """A private copy of ``csrc/`` and build directory for ``_build``."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return src


def test_sources_include_the_shared_header():
    headers = sorted(p.name for p in _build.CSRC.glob("*.cuh"))
    assert headers == ["sm90.cuh"]
    for name in ("flash_fwd.cu", "flash_bwd.cu", "w4a16.cu"):
        assert '#include "sm90.cuh"' in (_build.CSRC / name).read_text()


def test_flash_backward_runs_on_wgmma_and_tma():
    """K2's products are wgmma on TMA-staged tiles: no mma.sync, no cp.async ring."""
    src = (_build.CSRC / "flash_bwd.cu").read_text()
    for used in ("issue_ss<D, N>", "issue_rs<D, N>", "tma_load_4d", "mbar_wait",
                 "setmaxnreg_inc", "setmaxnreg_dec"):
        assert used in src, used
    for gone in ("mma.sync", "mma_bf16_16816", "cp.async", "ldmatrix"):
        assert gone not in src, gone


@pytest.mark.parametrize("source", ["flash_fwd.cu", "w4a16.cu", "flash_bwd.cu", "adam8bit.cu"])
def test_editing_a_header_renames_every_library(csrc_copy, source):
    before = _build._target(source)
    assert before.parent == _build.BUILD_DIR and before.name.startswith(source[:-3] + "-")
    assert _build._target(source) == before  # stable while nothing changes
    header = csrc_copy / "sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._target(source) != before


def test_editing_a_source_renames_only_its_library(csrc_copy):
    names = ("flash_fwd.cu", "w4a16.cu")
    before = {n: _build._target(n) for n in names}
    (csrc_copy / "w4a16.cu").write_text((csrc_copy / "w4a16.cu").read_text() + "\n")
    assert _build._target("w4a16.cu") != before["w4a16.cu"]
    assert _build._target("flash_fwd.cu") == before["flash_fwd.cu"]


def test_a_new_header_renames_the_libraries(csrc_copy):
    before = _build._target("adam8bit.cu")
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build._target("adam8bit.cu") != before


def test_build_all_compiles_only_the_sources(csrc_copy, monkeypatch):
    started = []
    monkeypatch.setattr(_build, "_start", lambda name: started.append(name))
    names = _build.build_all()
    assert names == started == sorted(p.name for p in csrc_copy.glob("*.cu"))
    assert not any(n.endswith(".cuh") for n in names)
    assert set(names) == {"adam8bit.cu", "flash_bwd.cu", "flash_fwd.cu", "w4a16.cu"}
