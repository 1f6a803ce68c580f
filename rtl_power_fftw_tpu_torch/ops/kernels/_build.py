"""Build the CUDA sources with nvcc and load them with ctypes, at first use.

The kernels have a plain C interface (``csrc/fused_psd.cu``), so they are
compiled by ``nvcc`` alone into a shared library, without PyTorch's
headers, and bound with :mod:`ctypes`. The library is keyed on a hash of
the source and the flags, so an edited source rebuilds. It is written
under a temporary name and renamed, so a concurrent process never loads a
half-written file. A failed build raises with nvcc's own message; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).with_name("csrc") / "fused_psd.cu"
#: Build outputs; listed in .gitignore.
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the source."""


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float        # 0.0 when an existing library was reused
    log: str              # nvcc's output (ptxas register/smem report)


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes()
                         + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfused_psd-{key}.so"


def build() -> BuildInfo:
    """Compile the library unless a build of this exact source exists."""
    out = _library_path()
    if out.is_file():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, out)
    return BuildInfo(out, time.perf_counter() - t0, proc.stdout + proc.stderr)


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call in a process)."""
    global _lib
    with _lock:
        if _lib is None:
            info = build()
            lib = ctypes.CDLL(str(info.path))
            lib.rpf_fused_psd.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            lib.rpf_fused_psd.restype = ctypes.c_int
            lib.rpf_cuda_error_string.argtypes = [ctypes.c_int]
            lib.rpf_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
