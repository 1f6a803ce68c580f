"""Every C entry of the port's CUDA libraries sets the caller's device
through the one ``use_device`` of csrc/device.cuh, which skips the call
where the thread is already on that device: no source calls
``cudaSetDevice(`` anywhere else, and no other source defines its own
``use_device``."""

import re
from pathlib import Path

import pytest

CSRC = (Path(__file__).resolve().parents[1]
        / "rtl_power_fftw_tpu_torch/ops/kernels/csrc")
SOURCES = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def code(path):
    """The source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", path.read_text(), flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def use_device_body():
    text = code(CSRC / "device.cuh")
    start = text.index("cudaError_t use_device(int device)")
    return start, text.index("\n}", start)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_bare_cuda_set_device(path):
    text = code(path)
    calls = [m.start() for m in re.finditer(r"\bcudaSetDevice\s*\(", text)]
    if path.name != "device.cuh":
        assert calls == [], f"{path.name} calls cudaSetDevice directly"
        return
    start, end = use_device_body()
    assert len(calls) == 1 and start < calls[0] < end


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_one_use_device(path):
    defines = re.findall(r"cudaError_t\s+use_device\s*\(int device\)\s*\{",
                         code(path))
    assert len(defines) == (path.name == "device.cuh")


def test_every_library_that_sets_a_device_includes_the_header():
    for path in sorted(CSRC.glob("*.cu")):
        text = code(path)
        if "use_device(" in text:
            assert '#include "device.cuh"' in text or any(
                f'#include "{h.name}"' in text
                for h in CSRC.glob("*.cuh")
                if '#include "device.cuh"' in h.read_text()), path.name
