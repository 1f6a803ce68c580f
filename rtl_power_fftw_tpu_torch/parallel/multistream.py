"""Multi-stream acquisition: S parallel IQ sources -> one averaged spectrum.

Port of ``rtl_power_fftw_tpu/parallel/multistream.py`` (which imports jax)
for BASELINE config 5, 16 parallel IQ streams. Each stream gets its own
producer thread feeding a BOUNDED queue of fixed-shape frame batches: the
multi-stream form of the reference's single producer loop with
backpressure (acquisition.cxx:276-332). A producer blocks when its queue
is full, and the free-slot count is histogrammed at every hand-off (the
"first number nonzero => compute too slow" diagnostic,
doc/rtl_power_fftw.1.md:136-148). The consumer assembles one (S, F, 2N)
round, runs it as one multi-stream device step (``ShardedPsdStep``, the
CUDA kernel K4) and keeps a small in-flight window so acquisition,
host-to-device copies and compute overlap.

On a CUDA device a round is packed into a pinned host slot, with its (S,)
valid counts in a pinned slot beside it, and both are copied to the device
asynchronously on the consumer's own CUDA stream. ``MAX_IN_FLIGHT + 1``
slot pairs form a ring (the single-stream ``Datastore``'s ``SlotRing``); a
pair is refilled only after the event recorded behind its copies has
fired, so a step never reads a later round's frames or counts. The kernel
never reads frames at or above a stream's count, so a slot is not zeroed
between rounds.

Memory is O(S · queue depth · F · 2N) whatever ``repeats`` is: a long
``-t`` run streams through, it does not buffer the whole measurement. The
result equals running the reference S times and summing the ``pwr``
accumulators: power accumulation commutes with any partition of the
spectra.
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import sys
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import BASE_BUF, Params
from ..exceptions import RPFexception, StreamEOF, TuneError
from ..interrupts import InterruptState, check_interrupt
from ..sources.base import IQSource

from ..ops.spectral import _SUM_CHUNK, FrameSlicer
from ..pipeline.datastore import (SlotRing, print_queue_histogram,
                                  stream_bytes_needed, unique_complex_samples,
                                  welch_hop)
from .sharded import ShardedPsdStep


@dataclasses.dataclass
class MultiStreamResult:
    pwr: np.ndarray             # (N,) float64 combined, unshifted bins
    per_stream_pwr: np.ndarray  # (S, N) float64, unshifted bins
    repeats_done: np.ndarray    # (S,) int64 spectra per stream
    device_readouts: int = 0    # summed over streams
    successful_readouts: int = 0
    stream_eof: bool = False    # any stream's recording ran dry


class MultiStreamAcquisition:
    """Drive S sources for ``repeats`` spectra each and reduce them on
    ``devices`` (``mesh.make_mesh``)."""

    #: bounded batches buffered per stream (the reference's default buffer
    #: pool is 5 deep, params.h:44 — same backpressure role).
    QUEUE_DEPTH = 4

    #: straggler window: once at least one stream has a batch ready, how
    #: long a round waits for the remaining on-pace streams before
    #: shipping partially filled. The window ADAPTS to the measured
    #: batch cadence (PACE_WINDOW × the median inter-batch period of the
    #: on-pace streams, EMA'd from producer-side timestamps), so
    #: same-rate streams coalesce into one device step even when their
    #: phases are offset by more than the jitter floor — a fixed
    #: jitter-scale window fragments S phase-offset streams into S
    #: single-stream device rounds. STRAGGLER_TIMEOUT is the floor
    #: (pre-pace-estimate jitter cover), STRAGGLER_CAP bounds the added
    #: latency. A genuinely slower stream still misses the window, gets
    #: flagged after LAG_ROUNDS consecutive misses, and stops gating
    #: dispatch entirely (it rejoins the moment its data arrives). That
    #: way one stalled/slow source cannot throttle the other S−1 — the
    #: multi-stream analogue of the reference's
    #: backpressure-without-a-global-barrier (acquisition.cxx:276-332).
    STRAGGLER_TIMEOUT = 0.01
    STRAGGLER_CAP = 0.25
    PACE_WINDOW = 1.25
    LAG_ROUNDS = 2

    #: device steps that may run while the next round is packed.
    MAX_IN_FLIGHT = 2

    def __init__(self, params: Params, sources: Sequence[IQSource],
                 devices: Sequence[torch.device],
                 window: Optional[np.ndarray] = None,
                 frames_per_step: int = 0):
        self.params = params
        self.sources = list(sources)
        S = len(self.sources)
        if frames_per_step <= 0:
            frames_per_step = max(
                _SUM_CHUNK,
                min(params.buf_length // (2 * params.N), 2048))
        self.step = ShardedPsdStep(devices, params.N, frames_per_step,
                                   streams=S, window=window,
                                   backend=params.fft_backend)
        self.S = S
        self.device = self.step.device
        self._ring = SlotRing(
            self.device, [((S, self.step.F, 2 * params.N), torch.uint8),
                          ((S,), torch.int32)], self.MAX_IN_FLIGHT)
        # Welch overlap applies per stream, same as the single-stream
        # Datastore (shared formula).
        self._hop = welch_hop(params.N, params.welch_overlap)
        # Queue-pressure histogram over free slots, summed across streams
        # (the multi-stream analogue of datastore.h:45's per-grab count).
        self.queue_histogram: List[int] = [0] * (self.QUEUE_DEPTH + 1)
        self._hist_lock = threading.Lock()
        self._record_files: Optional[List] = None

    def start_recording(self, base_path: str, stderr=None) -> None:
        """Raw-IQ capture (extension): one file per stream, written by
        that stream's producer thread (no cross-thread sharing)."""
        err = stderr if stderr is not None else sys.stderr
        # Track every opened file as we go so a failure partway (e.g. an
        # unwritable directory) closes the files already opened.
        self._record_files = []
        try:
            for i in range(self.S):
                self._record_files.append(open(f"{base_path}.s{i}", "wb"))
        except OSError:
            self.stop_recording()
            raise
        print(f"Recording raw IQ to {base_path}.s0..s{self.S - 1}", file=err)

    def stop_recording(self) -> None:
        for f in self._record_files or []:
            f.close()
        self._record_files = None

    def print_queue_histogram(self, stderr=None) -> None:
        """Free-slot histogram summed over stream queues (the multistream
        analogue of datastore.cxx:98-103)."""
        print_queue_histogram(self.queue_histogram, stderr)

    def _bytes_needed(self) -> int:
        """Unique stream bytes per acquisition (Welch-aware; shared
        formula with Datastore.bytes_needed)."""
        return stream_bytes_needed(self.params.N, self._hop,
                                   self.params.repeats)

    def unique_samples(self, repeats_done) -> int:
        """Unique (complex) samples summed over the per-stream repeat
        counts (shared per-stream formula with Datastore)."""
        return int(sum(unique_complex_samples(self.params.N, self._hop,
                                              int(r))
                       for r in np.asarray(repeats_done).ravel()))

    def tune_all(self, freq: int) -> None:
        """Tune every stream with the reference's 3-try persuasion
        (acquisition.cxx:229-249); any persistently dead stream raises
        TuneError so the session drops the frequency, not the session."""
        for src in self.sources:
            tuned = False
            for _try in range(3):
                try:
                    src.set_frequency(freq)
                    if src.frequency() != 0:
                        tuned = True
                        break
                except RPFexception:
                    pass
            if not tuned:
                raise TuneError(freq)

    def run(self, freq: int) -> MultiStreamResult:
        params = self.params
        N, F, S = params.N, self.step.F, self.S
        fb = 2 * N

        self.tune_all(freq)  # idempotent if the session pre-tuned

        queues = [_queue.Queue(maxsize=self.QUEUE_DEPTH) for _ in range(S)]
        items_sem = threading.Semaphore(0)  # one permit per queued item
        errors: List[BaseException] = []
        err_lock = threading.Lock()
        counters = np.zeros((S, 2), dtype=np.int64)  # readouts, successes
        eof_flags = [False] * S
        stop_producers = threading.Event()

        # Strict-time deadline applies to the whole acquisition
        # (acquisition.cxx:267-269,326-327).
        stop_time = (time.monotonic() + params.integration_time
                     if params.strict_time else None)

        def produce(s: int) -> None:
            src = self.sources[s]
            slicer = FrameSlicer(N, hop=self._hop)
            staging = np.zeros((F, fb), dtype=np.uint8)
            staged = 0

            def flush() -> None:
                nonlocal staged
                if staged:
                    with self._hist_lock:
                        free = self.QUEUE_DEPTH - queues[s].qsize()
                        self.queue_histogram[
                            max(0, min(free, self.QUEUE_DEPTH))] += 1
                    # Blocks when the queue is full: backpressure. The
                    # timestamp is the PRODUCER-side completion time —
                    # the consumer's pace model must see true arrival
                    # cadence, not its own (dispatch-delayed) retrieval
                    # times.
                    queues[s].put((staging[:staged].copy(), staged,
                                   time.monotonic()))
                    items_sem.release()
                    staged = 0

            def stage(frames: np.ndarray) -> None:
                nonlocal staged
                pos = 0
                while pos < len(frames):
                    take = min(F - staged, len(frames) - pos)
                    staging[staged:staged + take] = frames[pos:pos + take]
                    staged += take
                    pos += take
                    if staged == F:
                        flush()

            try:
                data_total = self._bytes_needed()
                data_read = 0
                n_frames = 0
                while data_read < data_total and not stop_producers.is_set():
                    # Partial reads round up to the BASE_BUF USB granularity
                    # like the single-stream producer (acquisition.cxx:287-302).
                    need = data_total - data_read
                    if need >= params.buf_length:
                        need = params.buf_length
                    else:
                        need = min(params.buf_length,
                                   BASE_BUF * ((need + BASE_BUF - 1) // BASE_BUF))
                    try:
                        buf, ok = src.read(need)
                    except StreamEOF as eof:
                        eof_flags[s] = True
                        if eof.partial is not None and len(eof.partial):
                            if self._record_files is not None:
                                self._record_files[s].write(
                                    eof.partial.tobytes())
                            got = slicer.push(
                                eof.partial,
                                max_frames=params.repeats - n_frames)
                            n_frames += len(got)
                            stage(got)
                        break
                    counters[s, 0] += 1
                    if ok:
                        counters[s, 1] += 1
                        data_read += need
                        if self._record_files is not None:
                            self._record_files[s].write(buf.tobytes())
                        got = slicer.push(buf,
                                          max_frames=params.repeats - n_frames)
                        n_frames += len(got)
                        stage(got)
                    # else: dropped samples — discard and retry
                    # (acquisition.cxx:307-316).
                    if stop_time is not None and time.monotonic() >= stop_time:
                        break
                    if check_interrupt(InterruptState.FinishNow):
                        break
                flush()
            except BaseException as e:
                with err_lock:
                    errors.append(e)
            finally:
                queues[s].put(None)  # end-of-stream sentinel
                items_sem.release()

        threads = [threading.Thread(target=produce, args=(s,), daemon=True)
                   for s in range(S)]
        for t in threads:
            t.start()

        try:
            with self._ring.active():
                result = self._consume(queues, items_sem)
        finally:
            stop_producers.set()
            # Keep draining each queue until its producer exits, so a
            # producer blocked on a full queue (or its final flush/sentinel)
            # can never deadlock an abnormal consumer exit.
            for s, t in enumerate(threads):
                while t.is_alive():
                    try:
                        queues[s].get_nowait()
                    except _queue.Empty:
                        pass
                    t.join(0.005)

        if errors:
            for e in errors:
                if isinstance(e, TuneError):
                    raise e  # drop the frequency, don't kill the session
            raise errors[0]

        pwr, per_stream, done = result
        return MultiStreamResult(
            pwr=pwr, per_stream_pwr=per_stream, repeats_done=done,
            device_readouts=int(counters[:, 0].sum()),
            successful_readouts=int(counters[:, 1].sum()),
            stream_eof=any(eof_flags))

    def _consume(self, queues, items_sem):
        """Consumer: one (S, F, 2N) round per step; streams that finished
        early contribute zero-valid rows. Returns (pwr, per_stream,
        repeats_done), accumulated in float64 on the host."""
        N, F, S = self.params.N, self.step.F, self.S
        per_stream = np.zeros((S, N), dtype=np.float64)
        pwr = np.zeros(N, dtype=np.float64)
        done = np.zeros(S, dtype=np.int64)
        ring = self._ring

        def accumulate(ps, combined) -> None:
            per_stream[:] += ps
            pwr[:] += combined

        active = set(range(S))
        behind = np.zeros(S, dtype=np.int64)  # consecutive missed rounds
        last_t = np.full(S, np.nan)           # last batch's put time
        period = np.full(S, np.nan)           # EMA inter-batch period
        while active:
            # --- collect one round, without a global barrier ---
            # Block until at least one item exists anywhere, then sweep
            # all queues; wait (bounded) only for streams that are on
            # pace. A stream that missed LAG_ROUNDS consecutive rounds
            # no longer gates dispatch — its producer keeps filling its
            # own bounded queue and the stream rejoins the first sweep
            # that finds its data.
            items_sem.acquire()
            credit = 1  # permits consumed ahead of items retrieved
            got: dict = {}

            def sweep() -> None:
                nonlocal credit
                for s in sorted(active):
                    if s in got:
                        continue
                    try:
                        item = queues[s].get_nowait()
                    except _queue.Empty:
                        continue
                    if credit > 0:
                        credit -= 1
                    else:
                        items_sem.acquire()  # immediate: item's permit
                    if item is None:
                        active.discard(s)
                    else:
                        got[s] = item
                        t_arr = item[2]
                        if not np.isnan(last_t[s]):
                            gap = t_arr - last_t[s]
                            period[s] = (gap if np.isnan(period[s])
                                         else 0.5 * period[s] + 0.5 * gap)
                        last_t[s] = t_arr

            sweep()
            paces = [period[s] for s in active
                     if behind[s] < self.LAG_ROUNDS
                     and not np.isnan(period[s])]
            window = (self.STRAGGLER_TIMEOUT if not paces else
                      min(self.STRAGGLER_CAP,
                          max(self.STRAGGLER_TIMEOUT,
                              self.PACE_WINDOW * float(np.median(paces)))))
            deadline = time.monotonic() + window
            while active:
                expected = [s for s in active
                            if behind[s] < self.LAG_ROUNDS]
                if all(s in got for s in expected):
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not items_sem.acquire(
                        timeout=remaining):
                    break
                credit += 1
                sweep()
            for _ in range(credit):  # return unconsumed permits
                items_sem.release()

            if got:
                # A sweep that only retired end-of-stream sentinels is
                # not a data round — bumping behind[] there would flag
                # on-pace streams as laggards for free.
                for s in list(active):
                    behind[s] = 0 if s in got else behind[s] + 1

            # --- dispatch the (possibly partial) round ---
            if not got:
                continue
            frames, counts = (t.numpy() for t in ring.slot())
            counts[:] = 0
            for s, (batch, nv, _t) in got.items():
                frames[s, :nv] = batch
                counts[s] = nv
            done[:] += counts
            ring.submit(self.step(*ring.upload()), accumulate)
        ring.drain()
        return pwr, per_stream, done
