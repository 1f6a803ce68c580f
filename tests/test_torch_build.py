"""The CUDA build and binding layer, checked where it can be without a
card: the ctypes signatures against the C entry points in the sources,
the build key, and that a missing nvcc raises instead of falling back."""

import re
import shutil
import types
from pathlib import Path

import ctypes
import pytest

from rtl_power_fftw_tpu_torch.ops.kernels import _build


def c_entry_points(text):
    """{name: [param types]} of the ``int rpf_*(...)`` functions."""
    out = {}
    for m in re.finditer(r"^int (rpf_\w+)\(([^)]*)\)", text, re.M):
        out[m.group(1)] = [" ".join(p.split()[:-1])
                           for p in m.group(2).split(",")]
    return out


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signatures_match_the_sources(name):
    entry = c_entry_points(_build.source(name).read_text())
    assert set(entry) == set(_build.SIGNATURES[name])
    for fn, argtypes in _build.SIGNATURES[name].items():
        params = entry[fn]
        assert len(params) == len(argtypes), fn
        for ctype, argtype in zip(params, argtypes):
            # Every pointer and the stream are c_void_p (64 bits).
            want = (ctypes.c_void_p if ctype.endswith("*")
                    else ctypes.c_float if ctype == "float"
                    else ctypes.c_int)
            assert argtype is want, (fn, ctype)


def test_every_source_is_built():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) \
        == sorted(_build.SIGNATURES)


def test_build_key_covers_source_headers_and_flags(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.SIGNATURES}
    header = csrc / "psd_sum.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after_header = {n: _build.library_path(n) for n in _build.SIGNATURES}
    assert all(before[n] != after_header[n] for n in before)
    src = csrc / "fused_psd_fast.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path("fused_psd_fast") \
        != after_header["fused_psd_fast"]
    assert _build.library_path("fused_psd") == after_header["fused_psd"]
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("fused_psd") != after_header["fused_psd"]


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: (_ for _ in ()).throw(
        _build.KernelBuildError("nvcc not found")))
    with pytest.raises(_build.KernelBuildError):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_a_load_builds_only_its_own_library(tmp_path, monkeypatch):
    """The first load of ``fused_psd`` (a session's) compiles that source
    alone, never the probes' library; a later load of ``fused_psd_probe``
    builds it then. nvcc is faked by a script that writes its -o file."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then : > \"$2\"; fi\n"
                    "  shift\ndone\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    loaded = []

    class FakeLib:
        def __init__(self, path):
            loaded.append(Path(path).name)

        def __getattr__(self, fn):
            return types.SimpleNamespace()

    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)

    def built():
        return sorted(p.name.split("-")[0]
                      for p in (tmp_path / "build").glob("*.so"))

    _build.load("fused_psd")
    assert built() == ["libfused_psd"]
    _build.load("fused_psd")
    assert len(loaded) == 1
    _build.load("fused_psd_probe")
    assert built() == ["libfused_psd", "libfused_psd_probe"]
    assert loaded == [_build.library_path("fused_psd").name,
                      _build.library_path("fused_psd_probe").name]
