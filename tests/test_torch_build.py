"""The port's kernel build (``repro_torch.kernels.build``) without
``nvcc``: a library is named by a hash of its source, every header
under ``csrc/`` and the flags, so an edited header never loads a stale
binary."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "h.cuh"\n__global__ void f() {}\n')
    (src / "h.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    return src


def test_library_name_follows_source_headers_and_flags(csrc, monkeypatch):
    first = build.library_path("k")
    assert first.parent == csrc.parent / "out"
    assert first.name.startswith("libk_") and first.suffix == ".so"
    assert build.library_path("k") == first          # stable
    (csrc / "h.cuh").write_text("#pragma once\n// edited\n")
    edited_header = build.library_path("k")
    assert edited_header != first
    (csrc / "other.cuh").write_text("#pragma once\n")
    new_header = build.library_path("k")
    assert new_header not in (first, edited_header)
    (csrc / "k.cu").write_text("__global__ void g() {}\n")
    edited_source = build.library_path("k")
    assert edited_source not in (first, edited_header, new_header)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path("k") != edited_source
