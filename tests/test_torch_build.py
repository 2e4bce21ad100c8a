"""The port's kernel build keying (ops/cuda/_build.py), on the CPU.

A library's file name carries a hash of its ``.cu`` source, of every
``csrc/`` header that source includes (and those headers' own includes),
and of the nvcc flags, so that an edited header never loads a stale
library. Nothing is compiled here.
"""

import pytest

from tpu_cfd_torch.ops.cuda import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\nint a;\n')
    (tmp_path / "b.cuh").write_text("#pragma once\nint b;\n")
    (tmp_path / "other.cuh").write_text("int other;\n")
    return tmp_path


def test_sources_follow_quoted_includes(csrc):
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]


@pytest.mark.parametrize("edited", ["k.cu", "a.cuh", "b.cuh"])
def test_an_edited_source_or_header_changes_the_library(csrc, edited):
    before = _build.library_path("k")
    assert _build.library_path("k") == before          # unchanged: same library
    (csrc / "other.cuh").write_text("int other2;\n")  # not included: same library
    assert _build.library_path("k") == before
    (csrc / edited).write_text((csrc / edited).read_text() + "// edited\n")
    after = _build.library_path("k")
    assert after != before and after.parent == before.parent
    assert after.name.startswith("libk_") and after.suffix == ".so"


def test_the_tensor_core_kernels_share_the_tf32_header():
    for name in ("ffn", "spectral_conv"):
        assert [p.name for p in _build.sources(name)] == [f"{name}.cu", "tf32_mma.cuh"]
    for name in ("spectral_step", "adam"):
        assert [p.name for p in _build.sources(name)] == [f"{name}.cu"]
