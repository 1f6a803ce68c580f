"""The compute pipeline on PyTorch: host buffer pool feeding device steps.

Port of ``rtl_power_fftw_tpu/pipeline/datastore.py`` (which imports jax).
The shape is the reference's ``Datastore`` (datastore.{h,cxx}): a bounded
pool of byte buffers between the acquisition producer and a consumer
thread, with backpressure and a queue-depth histogram. The consumer slices
buffers into fixed-shape frame batches and runs one device step per batch.

Reference-parity details preserved:
* the producer blocks when no buffer is free; the number of free buffers
  is histogrammed at every grab (acquisition.cxx:278-285);
* frames carry across buffer boundaries (FrameSlicer);
* processing stops at exactly ``repeats`` frames (datastore.cxx:67);
* partial sums accumulate into float64 on the host (datastore.h:53).

On a CUDA device each batch is packed into a pinned host slot and copied
to the device asynchronously on the consumer's own stream. A ring of
``max_in_flight + 1`` slots (:class:`SlotRing`, which the multi-stream
consumer shares) lets up to ``max_in_flight`` steps run while the next
batch is packed; a slot is refilled only after the event recorded behind
its copy has completed. Each step's result comes back the same way: a
non-blocking copy into the slot's pinned output tensor, read only after
the event behind it has fired.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
from typing import Deque, List, Optional, Tuple

import numpy as np
import torch

from ..config import Params

from ..ops.spectral import FrameSlicer, PsdStep


@dataclasses.dataclass
class AcquisitionResult:
    pwr: np.ndarray            # (N,) float64, unshifted bins
    repeats_done: int
    # The spectral-kurtosis step's other fields (None for other steps):
    # Σ|X|⁴ (--sk-file), and under --sk-excise the clean accumulator and
    # the per-bin count of spectra kept.
    pwr2: Optional[np.ndarray] = None
    pwr_clean: Optional[np.ndarray] = None
    kept: Optional[np.ndarray] = None


def welch_hop(N: int, overlap_percent: float) -> Optional[int]:
    """Frame hop for Welch-overlap mode (None = back-to-back frames)."""
    if overlap_percent <= 0.0:
        return None
    return max(1, int(round(N * (1.0 - overlap_percent / 100.0))))


def stream_bytes_needed(N: int, hop: Optional[int], repeats: int) -> int:
    """Stream bytes one acquisition must read for ``repeats`` frames:
    the reference's 2·N·repeats (acquisition.cxx:273) without overlap;
    with a hop < N overlapping frames reuse samples, so only
    2·(hop·(repeats−1) + N) unique bytes are needed."""
    if hop is None or repeats <= 0:
        return 2 * N * repeats
    return 2 * (hop * (repeats - 1) + N)


def unique_complex_samples(N: int, hop: Optional[int],
                           repeats_done: int) -> int:
    """Unique (complex) input samples consumed by ``repeats_done``
    frames: N·repeats_done normally, hop·(repeats_done−1)+N with Welch
    overlap — the basis for effective integration time
    (acquisition.cxx:356-357 divides samples by the sample rate)."""
    if repeats_done <= 0:
        return 0
    if hop is None:
        return N * repeats_done
    return hop * (repeats_done - 1) + N


class SlotRing:
    """Host slots feeding asynchronous device steps, for one consumer.

    ``max_in_flight + 1`` slots, each a tuple of tensors of ``specs``
    ((shape, dtype) pairs) for a step's inputs and of ``out_specs`` for its
    outputs, pinned on a CUDA device. The consumer fills :meth:`slot`,
    calls :meth:`upload` for the step's inputs and hands the step's outputs
    to :meth:`submit`. On CUDA every copy runs non-blocking on the ring's
    own stream: a slot is handed out again only after the event recorded
    behind its uploads has fired, so a step never reads a later fill, and
    each step's outputs are copied into the slot's pinned output tensors
    behind an event of their own. At most ``max_in_flight`` steps' outputs
    wait; each is passed to its callback in submission order once its
    event has fired, as numpy views of the pinned slot that stay valid
    until the callback returns (the ring never rewrites a slot whose
    read-back is pending: fewer are pending than there are slots). On the
    CPU the outputs are passed as they are. Run the consumer inside
    :meth:`active`."""

    def __init__(self, device: torch.device, specs, max_in_flight: int,
                 out_specs=()):
        self.device = device
        cuda = device.type == "cuda"
        self._stream = torch.cuda.Stream(device) if cuda else None

        def pinned(spec):
            return tuple(torch.empty(shape, dtype=dtype, pin_memory=cuda)
                         for shape, dtype in spec)
        self._slots = [pinned(specs) for _ in range(max_in_flight + 1)]
        self._out = [pinned(out_specs) if cuda else ()
                     for _ in range(max_in_flight + 1)]
        self._copied: List[Optional[torch.cuda.Event]] = (
            [None] * len(self._slots))
        self._cur = 0
        self.max_in_flight = max_in_flight
        # (outputs, event or None, callback)
        self._pending: Deque = collections.deque()

    @contextlib.contextmanager
    def active(self):
        """Run the enclosed steps on the ring's stream, from a clean ring."""
        self._pending.clear()
        if self._stream is None:
            yield
            return
        # Copies of an aborted run may still read the slots.
        self._stream.synchronize()
        self._copied = [None] * len(self._slots)
        with torch.cuda.stream(self._stream):
            yield

    def slot(self) -> Tuple[torch.Tensor, ...]:
        """The host tensors that are free to fill now."""
        return self._slots[self._cur]

    def upload(self) -> Tuple[torch.Tensor, ...]:
        """The current slot's tensors on the device (the slot itself on
        the CPU, whose steps finish before returning)."""
        host = self._slots[self._cur]
        if self._stream is None:
            return host
        on_device = tuple(t.to(self.device, non_blocking=True) for t in host)
        self._copied[self._cur] = torch.cuda.Event()
        self._copied[self._cur].record(self._stream)
        return on_device

    def submit(self, outputs: Tuple[torch.Tensor, ...], callback) -> None:
        """Queue a step's outputs (on CUDA: start their copies into the
        current slot's pinned output tensors), move to the next slot
        (waiting for its last uploads to land) and read back all but
        ``max_in_flight`` queued steps: ``callback(*arrays)`` with each
        output as a numpy array."""
        read = None
        if self._stream is not None:
            host = self._out[self._cur]
            if [(tuple(t.shape), t.dtype) for t in outputs] != [
                    (tuple(h.shape), h.dtype) for h in host]:
                raise ValueError(
                    f"step outputs {[(tuple(t.shape), t.dtype) for t in outputs]}"
                    f" do not match the ring's output slots "
                    f"{[(tuple(h.shape), h.dtype) for h in host]}")
            for h, t in zip(host, outputs):
                h.copy_(t, non_blocking=True)
            read = torch.cuda.Event()
            read.record(self._stream)
            outputs = host
        self._pending.append((outputs, read, callback))
        self._cur = (self._cur + 1) % len(self._slots)
        if self._copied[self._cur] is not None:
            self._copied[self._cur].synchronize()
        self.drain(self.max_in_flight)

    def drain(self, to_len: int = 0) -> None:
        while len(self._pending) > to_len:
            outputs, read, callback = self._pending.popleft()
            if read is not None:
                read.synchronize()
            callback(*(t.numpy() for t in outputs))


def print_queue_histogram(histogram, stderr=None) -> None:
    """datastore.cxx:98-103."""
    import sys
    err = stderr if stderr is not None else sys.stderr
    print("Buffer queue histogram: "
          + " ".join(str(v) for v in histogram) + " ", file=err)


def make_step(params: Params, frames_per_step: int, device,
              window: Optional[np.ndarray] = None):
    """The session's device step, as the JAX package's Datastore picks it:
    the polyphase filterbank (``--pfb-taps``; the window option names its
    prototype's window, and ``-w`` is refused with it at parse time), the
    multitaper estimator (``--multitaper``; its tapers replace the
    window), the spectral-kurtosis step (``--sk-file``, ``--sk-excise``),
    else PsdStep."""
    if params.pfb_taps > 1:
        from ..models.pfb import PfbSessionStep
        return PfbSessionStep(params.N, frames_per_step, taps=params.pfb_taps,
                              window=params.window_function or "hann",
                              device=device)
    if params.multitaper >= 1:
        from ..models.multitaper import MultitaperSessionStep
        return MultitaperSessionStep(params.N, frames_per_step,
                                     K=params.multitaper,
                                     NW=params.time_bandwidth,
                                     device=device)
    if params.sk_file or params.sk_excise > 0.0:
        from ..models.kurtosis import SkSessionStep
        return SkSessionStep(params.N, frames_per_step, device,
                             window=window, backend=params.fft_backend,
                             excise_sigma=params.sk_excise)
    return PsdStep(params.N, frames_per_step, device, window=window,
                   backend=params.fft_backend, precision=params.precision)


class Datastore:
    """Buffer pool + device-step consumer.

    One instance is reused across all hops of a session (like the
    reference's single Datastore, rtl_power_fftw.cxx:112).
    """

    def __init__(self, params: Params, device,
                 window: Optional[np.ndarray] = None, max_in_flight: int = 4):
        self.params = params
        self.N = params.N
        hop = welch_hop(params.N, params.welch_overlap)
        self._hop = hop

        frames_per_step = params.frames_per_step
        if frames_per_step <= 0:
            # Default: one buffer's worth of frames per device step, capped
            # to keep step latency and padding waste balanced.
            frames_per_step = max(1, min(params.buf_length // (2 * params.N), 4096))
        self.device = torch.device(device)
        self.step = make_step(params, frames_per_step, self.device, window)
        # A step returns one (N,) partial per name in ``fields`` (PsdStep
        # and two of the estimators: "s1" alone); each has its own pinned
        # output row and float64 accumulator.
        self.fields = getattr(self.step, "fields", ("s1",))
        self.slicer = FrameSlicer(params.N, hop=hop)
        self._ring = SlotRing(self.device,
                              [((self.step.F, 2 * self.N), torch.uint8)],
                              max_in_flight,
                              out_specs=[((self.N,), torch.float32)]
                              * len(self.fields))

        # Buffer pool bookkeeping (datastore.h:40-47). Buffers here are just
        # numpy arrays owned by the queue; the pool bound provides the
        # backpressure and the histogram provides the diagnostics.
        self.n_buffers = params.buffers
        self.queue_histogram: List[int] = [0] * (params.buffers + 1)
        self._occupied: Deque[np.ndarray] = collections.deque()
        self._lock = threading.Lock()
        self._status_change = threading.Condition(self._lock)
        self._acquisition_finished = False

        self._acc = self._zeros()
        self.repeats_done = 0
        self._consumer: Optional[threading.Thread] = None
        self._consumer_error: Optional[BaseException] = None

    # --- producer interface (called by Acquisition) ---

    def _zeros(self) -> dict:
        return {f: np.zeros(self.N, dtype=np.float64) for f in self.fields}

    @property
    def transform_path(self) -> str:
        """Which step serves the session: "cuda", "cuda_fast",
        "cuda_large", ... (PsdStep.path), "cuda_sk", "cuda_multitaper" or
        "cuda_pfb" (the estimators'), or "plain" + the same suffix on the
        CPU."""
        return self.step.path

    def bytes_needed(self) -> int:
        """Stream bytes one acquisition must read for ``repeats`` frames."""
        return stream_bytes_needed(self.N, self._hop, self.params.repeats)

    def unique_samples(self, repeats_done: int) -> int:
        """Unique (complex) input samples consumed by ``repeats_done``
        frames."""
        return unique_complex_samples(self.N, self._hop, repeats_done)

    def begin_acquisition(self) -> None:
        """Reset accumulator and start the consumer thread (the reference
        spawns fftThread per acquisition, acquisition.cxx:256).

        A still-alive consumer of an aborted acquisition is signalled and
        joined, and stale buffers are dropped, so two consumers never
        share the accumulator and a failed hop's IQ never leaks into the
        next spectrum."""
        if self._consumer is not None and self._consumer.is_alive():
            with self._status_change:
                self._acquisition_finished = True
                self._occupied.clear()
                self._status_change.notify_all()
            self._consumer.join()
        self._occupied.clear()
        self._acc = self._zeros()
        self.repeats_done = 0
        self.slicer.reset()
        reset = getattr(self.step, "reset", None)
        if reset is not None:
            reset()  # stateful steps (PFB history) must not leak across retunes
        self._acquisition_finished = False
        self._consumer_error = None
        self._consumer = threading.Thread(target=self._consume, daemon=True)
        self._consumer.start()

    def acquire_slot(self) -> None:
        """Block until a pool slot is free; histogram the free count
        (acquisition.cxx:278-285). Re-raises a consumer failure instead of
        deadlocking the producer against a dead consumer."""
        with self._status_change:
            free = self.n_buffers - len(self._occupied)
            self.queue_histogram[max(0, min(free, self.n_buffers))] += 1
            while (self.n_buffers - len(self._occupied) <= 0
                   and self._consumer_error is None):
                self._status_change.wait()
            if self._consumer_error is not None:
                raise self._consumer_error

    def push_buffer(self, data: np.ndarray) -> None:
        """Producer hands over a filled buffer (acquisition.cxx:317-324)."""
        with self._status_change:
            self._occupied.append(data)
            self._status_change.notify_all()

    def finish_acquisition(self) -> AcquisitionResult:
        """Signal end-of-data and join the consumer
        (acquisition.cxx:343-347)."""
        with self._status_change:
            self._acquisition_finished = True
            self._status_change.notify_all()
        if self._consumer is None:
            raise RuntimeError("finish_acquisition before begin_acquisition")
        self._consumer.join()
        if self._consumer_error is not None:
            raise self._consumer_error
        return AcquisitionResult(
            pwr=self._acc["s1"], repeats_done=self.repeats_done,
            pwr2=self._acc.get("s2"), pwr_clean=self._acc.get("s1_clean"),
            kept=self._acc.get("kept"))

    # --- consumer (device dispatch) ---

    def _consume(self) -> None:
        try:
            if self.device.type == "cuda":
                # The current device is per thread in torch.
                torch.cuda.set_device(self.device)
            with self._ring.active():
                self._consume_batches()
        except BaseException as e:  # surfaced to the producer
            with self._status_change:
                self._consumer_error = e
                self._status_change.notify_all()

    def _consume_batches(self) -> None:
        accs = [self._acc[f] for f in self.fields]
        ring = self._ring

        def accumulate(*partials: np.ndarray) -> None:
            for acc, partial in zip(accs, partials):
                np.add(acc, partial, out=acc)

        F = self.step.F
        staging = ring.slot()[0].numpy()
        staged = 0

        def flush_staging() -> None:
            nonlocal staging, staged
            if staged == 0:
                return
            if staged < F:
                staging[staged:] = 0
            raw, = ring.upload()
            out = self.step(raw, staged)
            ring.submit(out if isinstance(out, tuple) else (out,), accumulate)
            self.repeats_done += staged
            staged = 0
            staging = ring.slot()[0].numpy()

        while True:
            with self._status_change:
                while not self._occupied and not self._acquisition_finished:
                    self._status_change.wait()
                if not self._occupied and self._acquisition_finished:
                    break
                buffer = self._occupied.popleft()
                self._status_change.notify_all()

            remaining = self.params.repeats - self.repeats_done - staged
            frames = self.slicer.push(buffer, max_frames=max(0, remaining))
            # Pack frames into full fixed-shape batches; a partial batch
            # stays staged so consecutive small buffers coalesce into one
            # device step instead of one step per buffer.
            pos = 0
            while pos < len(frames):
                take = min(F - staged, len(frames) - pos)
                staging[staged:staged + take] = frames[pos:pos + take]
                staged += take
                pos += take
                if staged == F:
                    flush_staging()

        flush_staging()
        ring.drain()

    # --- diagnostics ---

    def print_queue_histogram(self, stderr=None) -> None:
        print_queue_histogram(self.queue_histogram, stderr)
