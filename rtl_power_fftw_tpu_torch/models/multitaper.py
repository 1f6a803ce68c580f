"""Multitaper (Thomson) PSD estimate.

Port of ``rtl_power_fftw_tpu/models/multitaper.py``, on one stream and
over ``--streams``. Each
frame is windowed by K orthogonal DPSS (Slepian) tapers and the K
eigenspectra are averaged: the lowest-variance estimator family for a
fixed data length. The device step is the multitaper kernel
(``ops/kernels/csrc/fused_psd_tapers.cu`` at the powers of two, its
mixed-radix form MT-M of ``ops/kernels/csrc/fused_psd_mixed_est.cu`` at
the other even 7-smooth N up to 16384, its chirp-Z form MT-B of
``ops/kernels/csrc/fused_psd_chirp_est.cu`` at the other even N up to 8192,
its form MT-L of the large kernel's passes,
``ops/kernels/csrc/fused_psd_large_est.cu``, at the powers of two from
32768 to 2^22, its form MT-ML of ML's passes,
``ops/kernels/csrc/fused_psd_mixed_large_est.cu``, at the other even
7-smooth N from 16386 to 2^22, and its form MT-BL of BL's passes,
``ops/kernels/csrc/fused_psd_chirp_large_est.cu``, at the other even N
from 8194 to 2^21 with a prime factor above 7; their plain PyTorch
version on the CPU): one block runs every taper of its frames, each raw
frame staged once in a shared-memory ring (MT-M and MT-B: the tapers on
the grid's y axis; MT-L, MT-ML and MT-BL: the large kernel's, ML's or
BL's passes once a taper); over S streams the streams form of the route's kernel on
the same N, one row a stream. DPSS tapers come from scipy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..exceptions import ReturnValue, RPFexception
from ..ops.kernels.fused_psd_chirp_est import (
    fused_psd_tapers_chirp, fused_psd_tapers_chirp_streams)
from ..ops.kernels.fused_psd_chirp_large_est import (
    fused_psd_tapers_chirp_large, fused_psd_tapers_chirp_large_streams)
from ..ops.kernels.fused_psd_large_est import (
    fused_psd_tapers_large, fused_psd_tapers_large_streams)
from ..ops.kernels.fused_psd_mixed_est import (
    fused_psd_tapers_mixed, fused_psd_tapers_mixed_streams)
from ..ops.kernels.fused_psd_mixed_large_est import (
    fused_psd_tapers_mixed_large, fused_psd_tapers_mixed_large_streams)
from ..ops.kernels.fused_psd_tapers import (fused_psd_tapers,
                                            fused_psd_tapers_streams)
from ..ops.spectral import (FrameSlicer, adapt_batch, bin_frequencies,
                            estimator_route, pad_frames)
from ..parallel.sharded import one_device, stream_batch


def dpss_tapers(N: int, NW: float, K: int) -> np.ndarray:
    """(K, N) float32 unit-energy DPSS tapers (needs scipy)."""
    try:
        from scipy.signal.windows import dpss
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "multitaper_psd requires scipy for DPSS tapers") from e
    t = dpss(N, NW, Kmax=K)
    return np.asarray(t, dtype=np.float32)


def _session_tapers(N: int, NW: float, K: int) -> np.ndarray:
    """(K, N) DPSS tapers in the session's output-unit convention:
    unit-energy Slepians rescaled by √N so a flat spectrum matches the
    boxcar/reference normalization (same convention as multitaper_psd)."""
    try:
        t = dpss_tapers(N, NW, K)
    except (RuntimeError, ValueError) as e:
        # scipy raises ValueError for parameter-domain problems (e.g.
        # NW >= N/2); both map to the typed InvalidArgument exit.
        raise RPFexception(f"{e}. Exiting.",
                           ReturnValue.InvalidArgument) from e
    return t * np.sqrt(np.float32(N))


#: The multitaper step's kernel by ``estimator_route``'s route.
TAPERS_KERNELS = {"regs": fused_psd_tapers, "mixed": fused_psd_tapers_mixed,
                  "bluestein": fused_psd_tapers_chirp,
                  "large": fused_psd_tapers_large,
                  "mixed_large": fused_psd_tapers_mixed_large,
                  "chirp_large": fused_psd_tapers_chirp_large}
#: The multitaper streams step's kernel by the same route over streams.
TAPERS_STREAMS_KERNELS = {"regs": fused_psd_tapers_streams,
                          "mixed": fused_psd_tapers_mixed_streams,
                          "bluestein": fused_psd_tapers_chirp_streams,
                          "large": fused_psd_tapers_large_streams,
                          "mixed_large":
                              fused_psd_tapers_mixed_large_streams,
                          "chirp_large":
                              fused_psd_tapers_chirp_large_streams}


def tapers_kernel(N: int):
    """The multitaper step's kernel at N bins (``estimator_route``):
    ``fused_psd_tapers`` at the powers of two up to 16384,
    ``fused_psd_tapers_mixed`` at the other even 7-smooth N up to 16384,
    ``fused_psd_tapers_chirp`` at the other even N up to 8192,
    ``fused_psd_tapers_large`` at the powers of two from 32768 to 2^22,
    ``fused_psd_tapers_mixed_large`` at the other even 7-smooth N from
    16386 to 2^22, ``fused_psd_tapers_chirp_large`` at the other even N up to 2^21 with a
    prime factor above 7."""
    return TAPERS_KERNELS[estimator_route(N, "--multitaper")]


class MultitaperSessionStep:
    """PsdStep-compatible session step for the Thomson multitaper
    estimator (``--multitaper K``): ``.F``, ``.path``, ``__call__(frames
    (F, 2N) u8, n_valid) -> (N,) f32 partial`` on ``device``, stateless.
    Each frame still consumes exactly N new samples, so ``repeats``
    accounting, timing and `.met` semantics match the reference's spectra;
    only the per-frame estimator changes (the mean of K eigenspectra
    instead of one periodogram, datastore.cxx:66-88). The path is
    "cuda_multitaper" on a CUDA device, "plain_multitaper" on the CPU; N
    must be a power of two from 64 to 2^22 (MT-L from 32768), another even
    7-smooth N up to 16384 (MT-M), another even N up to 8192 (MT-B) or
    another even N up to 2^21 with a prime factor above 7 (MT-BL;
    ``ops.spectral.estimator_route``). ``--precision`` does not apply:
    off its TPU band the JAX package runs the strict transform at either
    precision, and so does this step."""

    def __init__(self, N: int, frames_per_step: int, K: int,
                 NW: float = 4.0, *, device):
        self._kernel = tapers_kernel(N)
        self.N = N
        self.K = K
        self.F, self._chunk = adapt_batch(frames_per_step)
        self.device = torch.device(device)
        self.path = (("cuda" if self.device.type == "cuda" else "plain")
                     + "_multitaper")
        self.tapers = torch.from_numpy(
            _session_tapers(N, NW, K)).to(self.device)
        self.takes_u16 = False

    def __call__(self, raw, n_valid: int) -> torch.Tensor:
        """``raw``: (F, 2N) u8 (padded), a tensor on the step's device or a
        numpy array, which is copied there first."""
        if isinstance(raw, np.ndarray):
            raw = torch.from_numpy(np.ascontiguousarray(raw)).to(self.device)
        return self._kernel(raw, n_valid, self._chunk, self.tapers)


class ShardedMultitaperStep:
    """The multitaper step over S streams on one device (``--streams`` with
    ``--multitaper K``), port of the JAX package's
    ``ShardedMultitaperStep``: the call contract of
    :class:`..parallel.sharded.ShardedPsdStep`, (S, F, 2N) u8 frames and
    (S,) counts -> (per_stream (S, N) f32, combined (N,) f32, their sum over
    streams), on ``devices[0]``. Stateless: the eigenspectrum sums commute
    with any partition of the frames, so the combined row is
    :class:`MultitaperSessionStep` run on each stream and summed. The rows
    are the route's streams kernel's (``fused_psd_tapers_streams``,
    ``fused_psd_tapers_mixed_streams``, ``fused_psd_tapers_chirp_streams``,
    ``fused_psd_tapers_large_streams``,
    ``fused_psd_tapers_mixed_large_streams`` or
    ``fused_psd_tapers_chirp_large_streams`` where the single-stream
    step takes the same family, the K tapers
    shared; "cuda_multitaper" on a card, "plain_multitaper" on the CPU).
    ``--precision`` does not apply, as on one stream."""

    def __init__(self, devices, N: int, frames_per_step: int, streams: int,
                 K: int, NW: float = 4.0):
        one_device(devices)
        self._kernel = TAPERS_STREAMS_KERNELS[estimator_route(
            N, "--multitaper", sharded=True)]
        self.devices = list(devices)
        self.device = torch.device(devices[0])
        self.N = N
        self.S = streams
        self.K = K
        self.F, self._chunk = adapt_batch(frames_per_step)
        self.path = (("cuda" if self.device.type == "cuda" else "plain")
                     + "_multitaper")
        self.tapers = torch.from_numpy(
            _session_tapers(N, NW, K)).to(self.device)

    def __call__(self, raw, n_valid) -> Tuple[torch.Tensor, torch.Tensor]:
        """raw: (S, F, 2N) u8 and n_valid: (S,) counts, as
        ShardedPsdStep takes them. Returns (per_stream (S, N), combined
        (N,)), on the device; on CUDA computed asynchronously on the
        current stream."""
        raw, n_valid = stream_batch(self, raw, n_valid)
        per_stream = self._kernel(raw, n_valid, self._chunk, self.tapers)
        return per_stream, per_stream.sum(dim=0)


def multitaper_psd(iq_u8: np.ndarray, N: int, sample_rate: int,
                   center_freq: int = 0,
                   NW: float = 4.0, K: Optional[int] = None,
                   repeats: Optional[int] = None,
                   linear: bool = False,
                   frames_per_step: int = 256, *,
                   device) -> Tuple[np.ndarray, np.ndarray]:
    """Thomson multitaper PSD over a raw u8 IQ array, on ``device``.

    NW: time-bandwidth product; K: number of tapers (default 2·NW−1).
    Normalization matches the framework's other estimators
    (power/N/rate, fftshifted, dB unless ``linear``); taper energy is
    unit so the eigenspectrum average is directly comparable to a
    boxcar Bartlett PSD of the same data.
    """
    K = int(2 * NW - 1) if K is None else int(K)
    kernel = tapers_kernel(N)
    # DPSS tapers from scipy are unit-energy (Σw² = 1); the session's are
    # rescaled so a flat spectrum matches the boxcar normalization (Σw² = N).
    tapers = torch.from_numpy(_session_tapers(N, NW, K)).to(device)

    slicer = FrameSlicer(N)
    frames = slicer.push(iq_u8, max_frames=repeats)
    M = len(frames)
    if M == 0:
        raise ValueError("not enough samples for a single FFT frame")
    F, chunk = adapt_batch(min(frames_per_step, M))

    acc = np.zeros(N, dtype=np.float64)
    for start in range(0, M, F):
        batch = frames[start:start + F]
        raw = torch.from_numpy(np.ascontiguousarray(pad_frames(batch, F)))
        acc += kernel(raw.to(tapers.device), len(batch), chunk,
                      tapers).cpu().numpy()

    psd = np.fft.fftshift(acc) / M / N / sample_rate
    if not linear:
        with np.errstate(divide="ignore"):
            psd = 10.0 * np.log10(psd)
    return bin_frequencies(center_freq, N, sample_rate), psd
