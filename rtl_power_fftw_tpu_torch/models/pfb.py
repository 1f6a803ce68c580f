"""Polyphase filterbank (PFB) channelized PSD.

Port of ``rtl_power_fftw_tpu/models/pfb.py``, on one stream and over
``--streams``, and its ``pfb_channelize``, which returns the per-frame
channel voltages (the channelizer "PFB-C" of the same kernel library). The
critically-sampled PFB — a P-tap windowed-sinc prototype folded over M
branches, then an M-point FFT per output frame — sharpens channel
isolation over the plain periodogram (datastore.cxx:66-88) at the cost of
P× the input history per frame. The device step is the PFB kernel
(``ops/kernels/csrc/fused_psd_pfb.cu`` at the powers of two, its
mixed-radix form PFB-M of ``ops/kernels/csrc/fused_psd_mixed_est.cu`` at
the other even 7-smooth N up to 16384, its chirp-Z form PFB-B of
``ops/kernels/csrc/fused_psd_chirp_est.cu`` at the other even N up to 8192,
its form PFB-L of the large kernel's passes,
``ops/kernels/csrc/fused_psd_large_est.cu``, at the powers of two from
32768 to 2^22, its form PFB-ML of ML's passes,
``ops/kernels/csrc/fused_psd_mixed_large_est.cu``, at the other even
7-smooth N from 16386 to 2^22, and its form PFB-BL of BL's passes,
``ops/kernels/csrc/fused_psd_chirp_large_est.cu``, at the other even N
from 8194 to 2^21 with a prime factor above 7; their plain PyTorch
version on the CPU), which builds each
frame's polyphase sum from its history and slot rows and transforms it;
over S streams the streams form of the route's kernel on the same N, each
stream's history on the device.

``pfb_psd(prototype=np.ones(M), taps=1)`` is exactly the Bartlett
estimator (models/bartlett.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..auxdata import make_window
from ..ops.kernels.fused_psd_chirp_est import (fused_psd_pfb_chirp,
                                               fused_psd_pfb_chirp_streams)
from ..ops.kernels.fused_psd_chirp_large_est import (
    fused_psd_pfb_chirp_large, fused_psd_pfb_chirp_large_streams)
from ..ops.kernels.fused_psd_large_est import (fused_psd_pfb_large,
                                               fused_psd_pfb_large_streams)
from ..ops.kernels.fused_psd_mixed_est import (fused_psd_pfb_mixed,
                                               fused_psd_pfb_mixed_streams)
from ..ops.kernels.fused_psd_mixed_large_est import (
    fused_psd_pfb_mixed_large, fused_psd_pfb_mixed_large_streams)
from ..ops.kernels.fused_psd_pfb import (MAX_TAPS, fused_psd_pfb,
                                         fused_psd_pfb_streams)
from ..ops.kernels.fused_psd_pfb import pfb_channelize as _channelize
from ..ops.spectral import (_unported, adapt_batch, bin_frequencies,
                            estimator_route, finalize_psd)
from ..parallel.sharded import one_device, stream_batch
from ._steps import read_back_in_order, upload


def pfb_prototype(M: int, taps: int = 4,
                  window: str = "hann") -> np.ndarray:
    """Windowed-sinc prototype filter, shape (taps·M,) float32.

    sinc cutoff at one channel width (1/M), windowed over the full
    taps·M span. The absolute PSD level scales with the prototype's
    coherent gain, exactly like a window does in the reference (no
    gain compensation there either — acquisition.cxx applies the
    window and normalizes by repeats·N only)."""
    L = taps * M
    n = np.arange(L, dtype=np.float64)
    h = np.sinc((n - (L - 1) / 2.0) / M)
    if window != "boxcar":
        h *= make_window(window, L).astype(np.float64)
    return h.astype(np.float32)


#: The PFB step's kernel by ``estimator_route``'s route.
PFB_KERNELS = {"regs": fused_psd_pfb, "mixed": fused_psd_pfb_mixed,
               "bluestein": fused_psd_pfb_chirp, "large": fused_psd_pfb_large,
               "mixed_large": fused_psd_pfb_mixed_large,
               "chirp_large": fused_psd_pfb_chirp_large}
#: The PFB streams step's kernel by the same route over streams.
PFB_STREAMS_KERNELS = {"regs": fused_psd_pfb_streams,
                       "mixed": fused_psd_pfb_mixed_streams,
                       "bluestein": fused_psd_pfb_chirp_streams,
                       "large": fused_psd_pfb_large_streams,
                       "mixed_large": fused_psd_pfb_mixed_large_streams,
                       "chirp_large": fused_psd_pfb_chirp_large_streams}


class _PfbRunner:
    """The PFB kernel over consecutive steps of one stream: the (P, N)
    prototype and two (P - 1, 2N) history buffers on ``device``, swapped
    after each step (the kernel reads one and writes the next history
    into the other, on the step's stream). The kernel is the route's
    (``estimator_route``): ``fused_psd_pfb`` at the powers of two up to
    16384, ``fused_psd_pfb_mixed`` at the other even 7-smooth N up to
    16384, ``fused_psd_pfb_chirp`` at the other even N up to 8192,
    ``fused_psd_pfb_large`` at the powers of two from 32768 to 2^22,
    ``fused_psd_pfb_mixed_large`` at the other even 7-smooth N from 16386
    to 2^22, ``fused_psd_pfb_chirp_large`` at the other even N up to 2^21 with a
    prime factor above 7."""

    def __init__(self, N: int, F: int, chunk: int, h: np.ndarray, device):
        self._kernel = PFB_KERNELS[estimator_route(N, "--pfb-taps")]
        self.N, self.F, self._chunk = N, F, chunk
        self.device = torch.device(device)
        self.P = h.size // N
        self.h = torch.from_numpy(
            np.ascontiguousarray(h, np.float32).reshape(self.P, N)).to(
                self.device)
        self._history = [torch.empty((self.P - 1, 2 * N), dtype=torch.uint8,
                                     device=self.device) for _ in range(2)]
        self._fresh = True

    def reset(self, rows: Optional[np.ndarray] = None) -> None:
        """A new stream: history byte 127 (zero signal), set on the next
        step's stream; or, given (P - 1, 2N) u8 ``rows``, those rows."""
        self._fresh = rows is None
        if rows is not None:
            self._history[0].copy_(torch.from_numpy(
                np.ascontiguousarray(rows)))

    def __call__(self, raw, n_valid: int) -> torch.Tensor:
        if isinstance(raw, np.ndarray):
            raw = torch.from_numpy(np.ascontiguousarray(raw)).to(self.device)
        history, history_out = self._history
        out = self._kernel(raw, history, n_valid, self._chunk, self.h,
                           history_out, fresh=self._fresh)
        self._fresh = False
        self._history.reverse()
        return out


class PfbSessionStep:
    """PsdStep-compatible session step running the PFB estimator
    (``--pfb-taps P``): ``.F``, ``.path``, ``__call__(frames (F, 2N) u8,
    n_valid) -> (N,) f32 partial`` on ``device``, plus ``reset()``, which
    pipeline.Datastore calls per acquisition so filter history never leaks
    across retunes. Stateful on purpose: the PFB needs the previous P-1
    frames, which the step keeps on the device and updates from valid rows
    only. After a reset the history is byte 127 (zero signal,
    datastore.cxx:75), so the first P-1 outputs of each acquisition see
    zero prehistory (standard PFB warm-up) and every output frame consumes
    exactly N new samples, like the reference's spectra. ``window`` names
    the prototype's window (``--window-function``). The path is
    "cuda_pfb" on a CUDA device, "plain_pfb" on the CPU; N must be a power
    of two from 64 to 2^22 (PFB-L from 32768), another even 7-smooth N up
    to 16384 (PFB-M), another even N up to 8192 (PFB-B) or another even N
    up to 2^21 with a prime factor above 7 (PFB-BL;
    ``ops.spectral.estimator_route``)."""

    def __init__(self, N: int, frames_per_step: int, taps: int = 4,
                 window: str = "hann", *, device):
        if taps < 2:
            raise ValueError("pfb taps must be >= 2")
        self.N = N
        self.P = taps
        self.F, chunk = adapt_batch(frames_per_step)
        self.device = torch.device(device)
        self.path = ("cuda" if self.device.type == "cuda" else "plain") + \
            "_pfb"
        self._run = _PfbRunner(N, self.F, chunk,
                               pfb_prototype(N, taps, window), self.device)
        self.takes_u16 = False

    def reset(self) -> None:
        """Clear filter history (new acquisition / retune)."""
        self._run.reset()

    def __call__(self, raw, n_valid: int) -> torch.Tensor:
        """``raw``: (F, 2N) u8 (padded), a tensor on the step's device or a
        numpy array, which is copied there first."""
        return self._run(raw, n_valid)


class ShardedPfbStep:
    """The PFB step over S streams on one device (``--streams`` with
    ``--pfb-taps P``), port of the JAX package's ``ShardedPfbStep``: the
    call contract of :class:`..parallel.sharded.ShardedPsdStep`, (S, F, 2N)
    u8 frames and (S,) counts -> (per_stream (S, N) f32, combined (N,) f32,
    their sum over streams), on ``devices[0]``, plus ``reset()``. Each
    stream's filter history, (S, P - 1, 2N) u8 in two device buffers
    swapped after each step, is updated by the kernel from that stream's
    valid rows only, as :class:`PfbSessionStep`'s is (a stream with no
    valid frame keeps its history); ``reset()``, which the multi-stream
    engine calls per acquisition, sets every stream's history to byte 127
    on the next step, so history never leaks across retunes or crosses
    streams. The combined row is :class:`PfbSessionStep` run on each
    stream and summed. The rows are the route's streams kernel's
    (``fused_psd_pfb_streams``, ``fused_psd_pfb_mixed_streams``,
    ``fused_psd_pfb_chirp_streams``, ``fused_psd_pfb_large_streams``,
    ``fused_psd_pfb_mixed_large_streams`` or
    ``fused_psd_pfb_chirp_large_streams`` where the single-stream step
    takes the same family; "cuda_pfb" on a card, "plain_pfb" on the CPU); ``window``
    names the prototype's window."""

    def __init__(self, devices, N: int, frames_per_step: int, streams: int,
                 taps: int = 4, window: str = "hann"):
        one_device(devices)
        if taps < 2:
            raise ValueError("pfb taps must be >= 2")
        self._kernel = PFB_STREAMS_KERNELS[estimator_route(
            N, "--pfb-taps", sharded=True)]
        self.devices = list(devices)
        self.device = torch.device(devices[0])
        self.N = N
        self.S = streams
        self.P = taps
        self.F, self._chunk = adapt_batch(frames_per_step)
        self.path = ("cuda" if self.device.type == "cuda" else "plain") + \
            "_pfb"
        self.h = torch.from_numpy(np.ascontiguousarray(
            pfb_prototype(N, taps, window).reshape(taps, N))).to(self.device)
        self._history = [torch.empty((streams, taps - 1, 2 * N),
                                     dtype=torch.uint8, device=self.device)
                         for _ in range(2)]
        self._fresh = True

    def reset(self) -> None:
        """Clear every stream's filter history (new acquisition, retune)."""
        self._fresh = True

    def __call__(self, raw, n_valid) -> Tuple[torch.Tensor, torch.Tensor]:
        """raw: (S, F, 2N) u8 and n_valid: (S,) counts, as
        ShardedPsdStep takes them. Returns (per_stream (S, N), combined
        (N,)), on the device; on CUDA computed asynchronously on the
        current stream, the next histories written behind it."""
        raw, n_valid = stream_batch(self, raw, n_valid)
        history, history_out = self._history
        per_stream = self._kernel(raw, history, n_valid, self._chunk,
                                  self.h, history_out, fresh=self._fresh)
        self._fresh = False
        self._history.reverse()
        return per_stream, per_stream.sum(dim=0)


def pfb_psd(iq_u8: np.ndarray, M: int, sample_rate: int,
            center_freq: int = 0,
            taps: int = 4,
            repeats: Optional[int] = None,
            prototype: Optional[np.ndarray] = None,
            window: str = "hann",
            linear: bool = False,
            baseline: Optional[np.ndarray] = None,
            frames_per_step: int = 1024, *,
            device) -> Tuple[np.ndarray, np.ndarray]:
    """Channelized PSD of a raw interleaved-u8 IQ array via an M-channel,
    ``taps``-tap polyphase filterbank, on ``device``.

    prototype: optional (taps·M,) filter overriding the windowed-sinc
    default. Returns (freqs[M] Hz, psd[M]) with the reference's output
    semantics (finalize_psd: /frames/M/rate, dB unless ``linear``).
    Output frame t spans blocks t .. t + taps − 1 of the array, so the
    first batch's history is the array's own first taps − 1 blocks.
    """
    iq = np.asarray(iq_u8, dtype=np.uint8).ravel()
    if M < 2:
        raise ValueError("M must be >= 2")
    if taps < 1:
        raise ValueError("taps must be >= 1")
    estimator_route(M, "--pfb-taps")
    P = taps
    if prototype is None:
        h = pfb_prototype(M, taps, window)
    else:
        h = np.asarray(prototype, dtype=np.float32).ravel()
        if h.size != P * M:
            raise ValueError(f"prototype must have taps*M={P * M} "
                             f"coefficients, got {h.size}")
    blocks = iq.size // (2 * M)
    T_total = blocks - P + 1
    if repeats is not None:
        T_total = min(T_total, repeats)
    if T_total <= 0:
        raise ValueError("not enough samples for one PFB output frame "
                         f"(need {(P) * M} complex samples)")

    rows = iq[:(T_total + P - 1) * 2 * M].reshape(-1, 2 * M)
    F, chunk = adapt_batch(min(frames_per_step, T_total))
    run = _PfbRunner(M, F, chunk, h, device)
    run.reset(rows[:P - 1])
    pwr = np.zeros(M, dtype=np.float64)
    for start in range(0, T_total, F):
        batch = rows[P - 1 + start:P - 1 + min(start + F, T_total)]
        slot = np.zeros((F, 2 * M), np.uint8)
        slot[:len(batch)] = batch
        pwr += run(slot, len(batch)).cpu().numpy()

    with np.errstate(divide="ignore"):
        psd = finalize_psd(pwr, T_total, sample_rate, linear=linear,
                           baseline=baseline)
    return bin_frequencies(center_freq, M, sample_rate), psd


#: Output frames a step of :func:`pfb_channelize` takes at most.
CHANNELIZE_STEP = 1024


def pfb_channelize(iq_u8: np.ndarray, M: int,
                   taps: int = 4,
                   prototype: Optional[np.ndarray] = None,
                   window: str = "hann", *,
                   device) -> np.ndarray:
    """The complex channelized series itself, computed on ``device``: (T,
    M) complex64 — frame t, channel k (unshifted FFT bin order). For
    downstream detection / dedispersion-style pipelines that need the
    voltages, not the PSD.

    Steps of at most :data:`CHANNELIZE_STEP` output frames, each step's
    raw rows overlapping the last's by taps − 1 blocks (the history of its
    first frame)."""
    iq = np.asarray(iq_u8, dtype=np.uint8).ravel()
    estimator_route(M, "pfb_channelize")
    P = taps
    if not 1 <= P <= MAX_TAPS:
        raise _unported(f"pfb_channelize at {P} taps (the channelizer takes "
                        f"1 to {MAX_TAPS})")
    h = (pfb_prototype(M, taps, window) if prototype is None
         else np.asarray(prototype, dtype=np.float32).ravel())
    if h.size != P * M:
        raise ValueError(f"prototype must have taps*M={P * M} coefficients")
    blocks = iq.size // (2 * M)
    T = blocks - P + 1
    if T <= 0:
        raise ValueError("not enough samples for one PFB output frame")
    used = (T + P - 1) * 2 * M
    rows = iq[:used].reshape(-1, 2 * M)
    device = torch.device(device)
    hd = upload(h.reshape(P, M), device)
    out = np.empty((T, M), np.complex64)

    def store(item) -> None:
        t, y = item
        out[t:t + len(y)] = y.cpu().numpy()

    read_back_in_order(
        ((t0, _channelize(upload(rows[t0:t0 + CHANNELIZE_STEP + P - 1],
                                 device), hd))
         for t0 in range(0, T, CHANNELIZE_STEP)), store)
    return out
