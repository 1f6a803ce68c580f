"""Spectral kurtosis: per-bin RFI detection alongside the averaged PSD.

Port of ``rtl_power_fftw_tpu/models/kurtosis.py``, on one stream and over
``--streams``. The
generalized spectral-kurtosis estimator of Nita & Gary (2010),

    SK = (M+1)/(M−1) · (M·S2/S1² − 1),   S1 = Σ|X|², S2 = Σ|X|⁴

over M accumulated spectra: E[SK] = 1 for Gaussian noise; tones and
time-variable interference push SK away from 1. The device step is the
spectral-kurtosis kernel (``ops/kernels/csrc/fused_psd_sk.cu`` at the
powers of two, its mixed-radix form SK-M of
``ops/kernels/csrc/fused_psd_mixed_est.cu`` at the other even 7-smooth N up
to 16384, its chirp-Z form SK-B of
``ops/kernels/csrc/fused_psd_chirp_est.cu`` at the other even N up to 8192,
its form SK-L of the large kernel's passes,
``ops/kernels/csrc/fused_psd_large_est.cu``, at the powers of two from
32768 to 2^22, its form SK-ML of ML's passes,
``ops/kernels/csrc/fused_psd_mixed_large_est.cu``, at the other even
7-smooth N from 16386 to 2^22, and its form SK-BL of BL's passes,
``ops/kernels/csrc/fused_psd_chirp_large_est.cu``, at the other even N
from 8194 to 2^21 with a prime factor above 7, the chirp-Z forms also at
any even N up to 2^21 under ``--fft-backend bluestein``; their plain
PyTorch version on the CPU), which accumulates both moments in one pass,
its s1 the plain PSD step's bit for bit; over S streams the same on every
N (the streams form of the route's kernel: ``fused_psd_sk.cu``'s entry,
SK-M-S, SK-B-S, SK-L-S, SK-ML-S or SK-BL-S),
which gates each stream on its own block before the sum over streams.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.kernels.fused_psd_chirp_est import (fused_psd_sk_chirp,
                                               fused_psd_sk_chirp_streams)
from ..ops.kernels.fused_psd_chirp_large_est import (
    fused_psd_sk_chirp_large, fused_psd_sk_chirp_large_streams)
from ..ops.kernels.fused_psd_large_est import (fused_psd_sk_large,
                                               fused_psd_sk_large_streams)
from ..ops.kernels.fused_psd_mixed_est import (fused_psd_sk_mixed,
                                               fused_psd_sk_mixed_streams)
from ..ops.kernels.fused_psd_mixed_large_est import (
    fused_psd_sk_mixed_large, fused_psd_sk_mixed_large_streams)
from ..ops.kernels.fused_psd_sk import (fused_psd_sk, fused_psd_sk_streams,
                                        sk_keep)
from ..ops.spectral import (FrameSlicer, adapt_batch, bin_frequencies,
                            estimator_route, pad_frames)
from ..parallel.sharded import one_device, stream_batch

#: The excision gate, the JAX package's ``_sk_keep`` in float32.
_sk_keep = sk_keep

#: The SK step's kernel by ``estimator_route``'s route.
SK_KERNELS = {"regs": fused_psd_sk, "mixed": fused_psd_sk_mixed,
              "bluestein": fused_psd_sk_chirp, "large": fused_psd_sk_large,
              "mixed_large": fused_psd_sk_mixed_large,
              "chirp_large": fused_psd_sk_chirp_large}
#: The SK streams step's kernel by the same route over streams.
SK_STREAMS_KERNELS = {"regs": fused_psd_sk_streams,
                      "mixed": fused_psd_sk_mixed_streams,
                      "bluestein": fused_psd_sk_chirp_streams,
                      "large": fused_psd_sk_large_streams,
                      "mixed_large": fused_psd_sk_mixed_large_streams,
                      "chirp_large": fused_psd_sk_chirp_large_streams}


def compute_sk(s1: np.ndarray, s2: np.ndarray, M: int) -> np.ndarray:
    """Generalized SK from accumulated moments (Nita & Gary 2010):
    SK = (M+1)/(M−1)·(M·S2/S1² − 1), float64, unshifted bin order."""
    s1 = np.asarray(s1, dtype=np.float64)
    s2 = np.asarray(s2, dtype=np.float64)
    return (M + 1.0) / (M - 1.0) * (
        M * s2 / np.maximum(s1 * s1, 1e-300) - 1.0)


class SkSessionStep:
    """PsdStep-compatible session step that accumulates BOTH spectral
    moments (``--sk-file``): ``__call__(frames (F, 2N) u8, n_valid)``
    returns the pair ``(s1, s2)`` of (N,) f32 partials on ``device``
    (Σ|X|², Σ|X|⁴ over valid frames), named by ``fields``, which
    pipeline.Datastore accumulates apart. ``s1`` is the plain PSD step's
    partial bit for bit, so the averaged spectrum is unchanged by the
    sidecar.

    With ``excise_sigma > 0`` (``--sk-excise``) the step also gates each
    block's per-bin contribution on the block's own SK (M = n_valid),
    returning the four fields ``(s1, s2, s1_clean, kept)``: ``s1_clean``
    sums only blocks whose |SK−1| stayed within sigma·2/√M, ``kept``
    counts the spectra that survived per bin. The block is the step's F
    frames, as in the JAX package; excision decisions depend on it.

    The path is "cuda_sk" on a CUDA device, "plain_sk" on the CPU. Only N
    of 64..16384 powers of two (the SK kernel), the other even 7-smooth N
    up to 16384 (SK-M, on the mixed-radix kernel's grid: its s1 is the
    mixed-radix PSD step's), the other even N up to 8192 (SK-B, on the
    chirp-Z kernel's grid: its s1 is the chirp-Z PSD step's), the powers
    of two from 32768 to 2^22 (SK-L, on the large kernel's grid: its s1 is
    the large kernel's), the other even 7-smooth N from 16386 to 2^22
    (SK-ML, on ML's grid: its s1 is ML's) and the other even N from 8194
    to 2^21 with a prime factor above 7 (SK-BL, on BL's grid: its s1 is
    BL's), and the
    ``--fft-backend`` names the JAX package's SK step runs its auto
    transform for, are taken; under ``bluestein`` SK-B at any even N up
    to 8192 and SK-BL at any even N in (8192, 2^21], as the PSD step runs
    B and BL there (``ops.spectral.estimator_route``)."""

    def __init__(self, N: int, frames_per_step: int, device,
                 window: Optional[np.ndarray] = None,
                 backend: str = "auto", excise_sigma: float = 0.0):
        self._sigma = float(excise_sigma)
        self._kernel = SK_KERNELS[estimator_route(
            N, "--sk-excise" if self._sigma > 0.0 else "--sk-file", backend)]
        self.N = N
        self.F, self._chunk = adapt_batch(frames_per_step)
        self.device = torch.device(device)
        self.path = ("cuda" if self.device.type == "cuda" else "plain") + "_sk"
        self.fields = (("s1", "s2", "s1_clean", "kept")
                       if self._sigma > 0.0 else ("s1", "s2"))
        self.window = None
        if window is not None:
            w = np.asarray(window, dtype=np.float32)
            self.window = torch.from_numpy(w.copy()).to(self.device)
        self.takes_u16 = False

    def __call__(self, raw, n_valid: int) -> Tuple[torch.Tensor, ...]:
        """``raw``: (F, 2N) u8 (padded), a tensor on the step's device or a
        numpy array, which is copied there first."""
        if isinstance(raw, np.ndarray):
            raw = torch.from_numpy(np.ascontiguousarray(raw)).to(self.device)
        return tuple(self._kernel(raw, n_valid, self._chunk, self.window,
                                  self._sigma))


class ShardedSkStep:
    """The spectral-kurtosis step over S streams on one device
    (``--streams`` with ``--sk-file``/``--sk-excise``), port of the JAX
    package's ``ShardedSkStep``: the call contract of
    :class:`..parallel.sharded.ShardedPsdStep`, (S, F, 2N) u8 frames and
    (S,) counts -> (per_stream (S, N) f32 s1, combined (len(fields), N)
    f32), on ``devices[0]``. ``fields`` is ("s1", "s2") and the combined
    rows the float32 sums over streams of each stream's s1 and s2 (so the
    SK sidecar's M is S·repeats, the streams' spectra together); with
    ``excise_sigma > 0`` the four fields of :class:`SkSessionStep`, each
    stream gated on its own block's SK with its own M = n_valid[s] before
    the sum over streams, so one stream's burst never touches the others.
    Stateless. Each stream's rows are those of the route's streams kernel
    (``estimator_route`` over streams: ``fused_psd_sk_streams`` at the
    powers of two up to 16384, ``fused_psd_sk_mixed_streams`` at the other
    even 7-smooth N up to 16384, ``fused_psd_sk_chirp_streams`` at the
    other even N up to 8192, ``fused_psd_sk_large_streams`` at the powers
    of two from 32768 to 2^22, ``fused_psd_sk_mixed_large_streams`` at the
    other even 7-smooth N from 16386 to 2^22 and
    ``fused_psd_sk_chirp_large_streams`` at the other even N up to 2^21
    with a prime factor above 7, the chirp-Z
    forms also under ``bluestein``; "cuda_sk" on a card, "plain_sk" on the
    CPU); only the N and ``backend`` that
    :class:`SkSessionStep` takes are taken."""

    def __init__(self, devices, N: int, frames_per_step: int, streams: int,
                 window: Optional[np.ndarray] = None,
                 excise_sigma: float = 0.0, backend: str = "auto"):
        one_device(devices)
        self._sigma = float(excise_sigma)
        self._kernel = SK_STREAMS_KERNELS[estimator_route(
            N, "--sk-excise" if self._sigma > 0.0 else "--sk-file", backend,
            sharded=True)]
        self.devices = list(devices)
        self.device = torch.device(devices[0])
        self.N = N
        self.S = streams
        self.F, self._chunk = adapt_batch(frames_per_step)
        self.path = ("cuda" if self.device.type == "cuda" else "plain") + "_sk"
        self.fields = (("s1", "s2", "s1_clean", "kept")
                       if self._sigma > 0.0 else ("s1", "s2"))
        self.window = None
        if window is not None:
            w = np.asarray(window, dtype=np.float32)
            if w.shape != (N,):
                raise ValueError("window must have shape (N,)")
            self.window = torch.from_numpy(w.copy()).to(self.device)

    def __call__(self, raw, n_valid) -> Tuple[torch.Tensor, torch.Tensor]:
        """raw: (S, F, 2N) u8 and n_valid: (S,) counts, as
        ShardedPsdStep takes them. Returns (s1 per stream (S, N), combined
        (len(fields), N)), on the device; on CUDA computed asynchronously
        on the current stream."""
        raw, n_valid = stream_batch(self, raw, n_valid)
        rows = self._kernel(raw, n_valid, self._chunk, self.window,
                            self._sigma)
        return rows[:, 0], rows.sum(dim=0)


def spectral_kurtosis(iq_u8: np.ndarray, N: int, sample_rate: int,
                      center_freq: int = 0,
                      repeats: Optional[int] = None,
                      window: Optional[np.ndarray] = None,
                      backend: str = "auto",
                      frames_per_step: int = 1024, *,
                      device) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compute (freqs, SK, psd_linear) over a raw u8 IQ array on
    ``device``.

    SK ≈ 1 for well-behaved Gaussian bins; SK ≫ 1 flags impulsive RFI,
    SK ≪ 1 flags coherent tones. ``psd_linear`` is the ordinary averaged
    PSD in linear units (same normalization as ``bartlett_psd(...,
    linear=True)`` but without DC interpolation, so flagging sees the
    true DC bin).
    """
    slicer = FrameSlicer(N)
    frames = slicer.push(iq_u8, max_frames=repeats)
    M = len(frames)
    if M < 2:
        raise ValueError("spectral kurtosis needs at least 2 spectra")
    step = SkSessionStep(N, min(frames_per_step, M), device, window=window,
                         backend=backend)
    s1 = np.zeros(N, dtype=np.float64)
    s2 = np.zeros(N, dtype=np.float64)
    for start in range(0, M, step.F):
        batch = frames[start:start + step.F]
        a, b = step(pad_frames(batch, step.F), len(batch))
        s1 += a.cpu().numpy()
        s2 += b.cpu().numpy()

    sk = compute_sk(s1, s2, M)
    psd = s1 / M / N / sample_rate
    shift = np.fft.fftshift
    return bin_frequencies(center_freq, N, sample_rate), shift(sk), shift(psd)
