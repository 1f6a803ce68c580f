"""Build the CUDA sources with nvcc and load them with ctypes, at first use.

Each ``csrc/*.cu`` has a plain C interface and is compiled by ``nvcc``
alone into its own shared library, without PyTorch's headers, and bound
with :mod:`ctypes`. The first :func:`load` in a process starts one
``nvcc`` per source that has no library yet, all at once, and waits for
them. A library is keyed on a hash of its source, every ``csrc/*.cuh``
header and the flags, so an edited source rebuilds. It is written under a
temporary name and renamed, so a concurrent process never loads a
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
from typing import Dict

CSRC = Path(__file__).with_name("csrc")
#: Build outputs; listed in .gitignore.
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: Exported C functions of each library: name -> argtypes (all return int).
#: Every pointer and the stream are c_void_p, so ctypes does not cut them
#: to 32 bits.
SIGNATURES = {
    "fused_psd": {
        # raw, twiddle, window, partial, out, device, log2n, F, group,
        # n_valid, stream
        "rpf_fused_psd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # raw, twiddle, window, n_valid, partial, out, device, log2n, S, F,
        # group, stream
        "rpf_fused_psd_streams": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _P],
    },
    "fused_psd_fast": {
        # raw, window, w1r, w1i, twiddle, w2, partial, out, device, log2n,
        # F, group, n_valid, stream
        "rpf_fused_psd_fast": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _P],
    },
    "fused_psd_large": {
        # raw, twiddle, inter, window, scratch, partial, out, device, log2n,
        # F, group, n_valid, stream
        "rpf_fused_psd_large": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _P],
    },
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float        # 0.0 when an existing library was reused
    log: str              # nvcc's output (ptxas register/smem report)


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


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


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    h = hashlib.sha256(source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build() -> Dict[str, BuildInfo]:
    """Compile every library that has no build of its exact sources, one
    nvcc process per source, all started together."""
    outs = {name: library_path(name) for name in SIGNATURES}
    infos = {name: BuildInfo(out, 0.0, "") for name, out in outs.items()
             if out.is_file()}
    missing = [name for name in outs if name not in infos]
    if not missing:
        return infos
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = {}
    for name in missing:
        tmp = outs[name].with_name(f"{outs[name].name}.{os.getpid()}.tmp")
        running[name] = tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    failures = []
    for name, (tmp, proc) in running.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on {source(name).name} with exit "
                            f"code {proc.returncode}:\n{stderr}")
            continue
        os.replace(tmp, outs[name])
        infos[name] = BuildInfo(outs[name], time.perf_counter() - t0,
                                stdout + stderr)
    if failures:
        raise KernelBuildError("\n".join(failures))
    return infos


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (all are built on the first call in a
    process)."""
    with _lock:
        if not _libs:
            for lib_name, info in build().items():
                lib = ctypes.CDLL(str(info.path))
                for fn, argtypes in SIGNATURES[lib_name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                lib.rpf_cuda_error_string.argtypes = [ctypes.c_int]
                lib.rpf_cuda_error_string.restype = ctypes.c_char_p
                _libs[lib_name] = lib
        return _libs[name]
