"""Recorded-stream IQ source: raw interleaved u8 IQ from a file.

The reference can only read from live hardware; recorded input is the
natural TPU-framework equivalent for reproducible runs and benchmarks
(BASELINE.json config 1: "recorded 2.048 MS/s int8 IQ buffer").
"""

from __future__ import annotations

import weakref
from typing import List, Optional, Tuple

import numpy as np

from ..exceptions import ReturnValue, RPFexception, StreamEOF
from .base import IQSource


class FileSource(IQSource):
    """Raw u8 IQ from a file.

    When the native C++ loader is available (rtl_power_fftw_tpu.native),
    reads are served from its buffer pool: a C++ reader thread prefetches
    ahead of the Python consumer, so the byte-moving path stays out of
    Python (set ``use_native=False`` to force the plain path).
    """

    def __init__(self, path: str, sample_rate: int = 2_048_000,
                 loop: bool = False, use_native: bool = True,
                 native_buf_bytes: Optional[int] = None,
                 native_buffers: int = 12, native_readers: int = 4,
                 native_mmap: "str | bool" = "auto"):
        """``native_buf_bytes=None`` (default) sizes the loader's pool
        slots to the FIRST read request, enabling the zero-copy path:
        full reads then return pool views directly (recycled by a
        refcount finalizer when the consumer drops them) instead of being
        copied out. An explicit size keeps fixed slots (copy path).

        Pool-depth note: with zero-copy views the pool must be deeper
        than the number of buffers the downstream consumer can pin at
        once (the Datastore's bounded queue holds up to ``--buffers``,
        default 5) PLUS the parallel reader count (``native_readers``
        preads chunks concurrently; ordered delivery can hold up to
        readers−1 out-of-order slots). The default 12-deep pool covers
        5 pins + 4 readers with headroom — a temporarily starved pool
        degrades to dropped-samples retries, never a deadlock.

        Lifetime: call ``close()`` only after the consumer has drained
        all outstanding views (the session joins its consumer thread
        before closing sources); views must not be read after close —
        the C++ pool memory is freed then. Late finalizers are safe
        (release() no-ops on a closed loader)."""
        self.path = path
        self._rate = int(sample_rate)
        self.loop = loop
        try:
            self._file = open(path, "rb")
        except OSError as e:
            raise RPFexception(
                f"Could not open IQ file {path}: {e}", ReturnValue.InvalidInput)
        self._freq = 0
        self._gain = 0
        self._native = None
        self._native_cfg = None
        self._held = None    # (slot, view, offset): partially-consumed pool slot
        self._stash = None   # leftover copied bytes after a timeout (rare)
        if use_native:
            try:
                from ..native import native_available
                if native_available():
                    # Lazy start: slot size is decided at the first read.
                    self._native_cfg = (native_buf_bytes, native_buffers,
                                        native_readers, native_mmap)
            except Exception:
                pass

    def _ensure_native(self, nbytes: int) -> None:
        if self._native is not None or self._native_cfg is None:
            return
        buf_bytes, n_buffers, n_readers, n_mmap = self._native_cfg
        if buf_bytes is None:
            buf_bytes = min(max(int(nbytes), 1 << 16), 32 << 20)
        try:
            from ..native import NativeLoader
            self._native = NativeLoader(buf_bytes, n_buffers)
            # Parallel readers overlap I/O latency (page cache, NVMe,
            # network FS), which needs no extra cores — don't cap by
            # cpu_count; the loader caps at half the pool depth. mmap
            # "auto" (default) serves in-bounds chunks as zero-copy
            # views of the file mapping — see NativeLoader.start_fd.
            self._native.start_fd(self._file.fileno(), loop=self.loop,
                                  readers=max(1, int(n_readers)),
                                  mmap=n_mmap)
        except Exception:
            self._native = None       # silent fallback to the Python path
            self._native_cfg = None

    def gains(self) -> List[int]:
        return [0]

    def sample_rate(self) -> int:
        return self._rate

    def frequency(self) -> int:
        return self._freq

    def set_frequency(self, frequency: int) -> None:
        # Recorded data has no tuner; record the request so the frequency
        # axis of the output is labeled as asked.
        self._freq = int(frequency)

    def set_sample_rate(self, sample_rate: int) -> None:
        self._rate = int(sample_rate)

    def set_gain(self, gain: int) -> None:
        self._gain = int(gain)

    def _eof(self, chunks=None):
        """End of the recording: a definite stop, not a transient
        dropped-samples condition.  Raised as ``StreamEOF`` so the session
        finishes the partial spectrum instead of dying with exit 6 — a
        file-based framework hits stream ends constantly where the
        reference's live hardware cannot (acquisition.cxx:326-331 partial
        semantics)."""
        partial = None
        if chunks:
            partial = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        raise StreamEOF(f"End of recorded IQ stream {self.path}.", partial)

    def _read_native(self, nbytes: int) -> Tuple[np.ndarray, bool]:
        """Single-copy native read: each pool view is copied exactly once,
        straight into the output buffer; a partially-consumed slot stays
        loaned (released only when drained), so there is no intermediate
        pending-chunk list or concatenation pass. This is what lets the
        host pipeline run at memcpy-class speed (measured 2× the previous
        copy+concat formulation in bench_ingest.py)."""
        if (self._held is None and nbytes == self._native.buf_bytes
                and (self._stash is None or not len(self._stash))):
            # ZERO-COPY fast path: a full read exactly matches one pool
            # slot, so the pool view is handed out directly. The slot
            # recycles when the LAST reference to the view (or any slice
            # of it) is dropped — CPython refcounting makes that prompt:
            # the Datastore consumer direct-feeds views into the device
            # step, which copies at dispatch, then drops them.
            try:
                item = self._native.acquire(timeout_ms=30_000)
            except TimeoutError:
                return np.zeros(nbytes, dtype=np.uint8), False
            if item is None:
                self._eof(None)
            slot, view = item
            if len(view) == nbytes:
                weakref.finalize(view, self._native.release, slot)
                return view, True
            # Short slot (stream tail): fall through to the copy path.
            self._held = (slot, view, 0)
        out = np.empty(nbytes, dtype=np.uint8)
        filled = 0
        if self._stash is not None and len(self._stash):
            take = min(len(self._stash), nbytes)
            out[:take] = self._stash[:take]
            self._stash = self._stash[take:] if take < len(self._stash) else None
            filled = take
        while filled < nbytes:
            if self._held is None:
                try:
                    item = self._native.acquire(timeout_ms=30_000)
                except TimeoutError:
                    # I/O stall (slow or network-mounted recording): report
                    # dropped samples so the caller retries; bytes already
                    # copied stay stashed, keeping the stream contiguous.
                    self._stash = out[:filled] if filled else None
                    return np.zeros(nbytes, dtype=np.uint8), False
                if item is None:
                    self._eof([out[:filled]] if filled else None)
                slot, view = item
                self._held = (slot, view, 0)
            slot, view, off = self._held
            take = min(len(view) - off, nbytes - filled)
            out[filled:filled + take] = view[off:off + take]
            filled += take
            off += take
            if off == len(view):
                self._native.release(slot)
                self._held = None
            else:
                self._held = (slot, view, off)
        return out, True

    def read(self, nbytes: int) -> Tuple[np.ndarray, bool]:
        self._ensure_native(nbytes)
        if self._native is not None:
            return self._read_native(nbytes)
        chunks = []
        remaining = nbytes
        while remaining > 0:
            data = self._file.read(remaining)
            if not data:
                if self.loop:
                    self._file.seek(0)
                    continue
                self._eof(chunks)
            chunks.append(np.frombuffer(data, dtype=np.uint8))
            remaining -= len(data)
        return np.concatenate(chunks) if len(chunks) > 1 else chunks[0], True

    def close(self) -> None:
        if self._native is not None:
            if self._held is not None:
                self._native.release(self._held[0])
                self._held = None
            self._native.stop()
            self._native.close()
            self._native = None
        self._file.close()
