"""ctypes binding for the native C++ stream loader (loader.cpp).

The shared library builds lazily on first use (g++ -O3) and is cached next
to the source; if the toolchain is unavailable the framework falls back to
the pure-Python producer path automatically (``native_available()``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "loader.cpp")
_SO = os.path.join(_DIR, "librpf_loader.so")

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def _build() -> Optional[str]:
    """Compile the shared library if needed. Returns an error message or None."""
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return None
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC,
           "-o", _SO, "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"native build failed to run: {e}"
    if proc.returncode != 0:
        return f"native build failed: {proc.stderr[:500]}"
    return None


def _load():
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        err = _build()
        if err is not None:
            _build_error = err
            return None
        lib = ctypes.CDLL(_SO)
        lib.rpf_loader_create.restype = ctypes.c_void_p
        lib.rpf_loader_create.argtypes = [ctypes.c_size_t, ctypes.c_int]
        lib.rpf_loader_start_fd.restype = ctypes.c_int
        lib.rpf_loader_start_fd.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_double,
                                            ctypes.c_int]
        lib.rpf_loader_start_fd2.restype = ctypes.c_int
        lib.rpf_loader_start_fd2.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                             ctypes.c_int, ctypes.c_double,
                                             ctypes.c_int, ctypes.c_int]
        lib.rpf_loader_acquire.restype = ctypes.c_int
        lib.rpf_loader_acquire.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                                           ctypes.POINTER(ctypes.c_size_t),
                                           ctypes.c_int]
        lib.rpf_loader_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rpf_loader_histogram.argtypes = [ctypes.c_void_p,
                                             ctypes.POINTER(ctypes.c_long),
                                             ctypes.c_int]
        lib.rpf_loader_bytes_read.restype = ctypes.c_long
        lib.rpf_loader_bytes_read.argtypes = [ctypes.c_void_p]
        lib.rpf_loader_at_eof.restype = ctypes.c_int
        lib.rpf_loader_at_eof.argtypes = [ctypes.c_void_p]
        lib.rpf_loader_stop.argtypes = [ctypes.c_void_p]
        lib.rpf_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeLoader:
    """Python handle on the C++ buffer-pool loader.

    Usage::

        with NativeLoader(buf_bytes, n_buffers) as ld:
            ld.start_fd(fd, loop=False, pace_bytes_per_s=0)
            while True:
                item = ld.acquire(timeout_ms=1000)
                if item is None:          # end of stream
                    break
                slot, view = item         # view: zero-copy numpy array
                consume(view)
                ld.release(slot)
    """

    def __init__(self, buf_bytes: int, n_buffers: int):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        self._h = lib.rpf_loader_create(buf_bytes, n_buffers)
        if not self._h:
            raise RuntimeError("rpf_loader_create failed")
        self.n_buffers = n_buffers
        self.buf_bytes = buf_bytes

    def start_fd(self, fd: int, loop: bool = False,
                 pace_bytes_per_s: float = 0.0, readers: int = 1,
                 mmap: str | bool = "auto") -> None:
        """``readers`` > 1 enables parallel pread readers with ordered
        (sequential-exact) delivery — only takes effect for seekable fds
        of known size with no pacing; the loader caps it at half the pool
        depth and falls back to one reader otherwise. Keep
        ``n_buffers >= consumer pins + readers`` to avoid starving the
        reorder stage against a stalled consumer.

        ``mmap``: "auto" (default) maps unpaced seekable files of known
        size and delivers in-bounds chunks as ZERO-COPY views of the
        mapping — the kernel read copy drops out of the ingest chain
        (measured 3.6 -> memcpy-class GB/s on this host,
        BENCHMARKS "Host-chain attribution") — with reader threads
        demoted to page-fault prefetchers; loop-wrap chunks are
        assembled in slot buffers so every mode stays byte-identical to
        the sequential reader. ``False`` forces the pread path,
        ``True`` requests mmap explicitly (still falls back where the
        fd cannot be mapped)."""
        m = -1 if mmap == "auto" else (1 if mmap else 0)
        rc = self._lib.rpf_loader_start_fd2(self._h, fd, int(loop),
                                            float(pace_bytes_per_s),
                                            int(readers), m)
        if rc != 0:
            raise RuntimeError("rpf_loader_start_fd failed")

    def acquire(self, timeout_ms: int = -1) -> Optional[Tuple[int, np.ndarray]]:
        """Next filled buffer as (slot, zero-copy uint8 view), or None at
        end-of-stream. Raises TimeoutError on timeout."""
        data = ctypes.POINTER(ctypes.c_uint8)()
        length = ctypes.c_size_t()
        rc = self._lib.rpf_loader_acquire(self._h, ctypes.byref(data),
                                          ctypes.byref(length), timeout_ms)
        if rc == -2:
            return None
        if rc == -1:
            raise TimeoutError("native loader: acquire timed out")
        view = np.ctypeslib.as_array(data, shape=(length.value,))
        return rc, view

    def release(self, slot: int) -> None:
        if not self._h:
            return  # closed (e.g. a zero-copy view finalizer firing late)
        self._lib.rpf_loader_release(self._h, slot)

    def histogram(self) -> np.ndarray:
        out = (ctypes.c_long * (self.n_buffers + 1))()
        self._lib.rpf_loader_histogram(self._h, out, self.n_buffers + 1)
        return np.array(out[:], dtype=np.int64)

    def bytes_read(self) -> int:
        return int(self._lib.rpf_loader_bytes_read(self._h))

    def at_eof(self) -> bool:
        return bool(self._lib.rpf_loader_at_eof(self._h))

    def stop(self) -> None:
        self._lib.rpf_loader_stop(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.rpf_loader_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
