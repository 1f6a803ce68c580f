"""Bartlett PSD estimate: average of non-overlapping windowed periodograms.

Port of ``rtl_power_fftw_tpu/models/bartlett.py``. This is the reference's
estimator (datastore.cxx:66-88 averages ``repeats`` back-to-back N-point
periodograms) as a one-shot library API over recorded IQ arrays, on the
port's device step (the K1 or K2 kernel on a CUDA device, its plain
version on the CPU).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.spectral import (FrameSlicer, PsdStep, bin_frequencies,
                            finalize_psd, pad_frames)
from ._steps import read_back_in_order


@functools.lru_cache(maxsize=8)
def _cached_step(N: int, F: int, window_bytes: Optional[bytes],
                 backend: str, device: torch.device) -> PsdStep:
    window = (None if window_bytes is None
              else np.frombuffer(window_bytes, dtype=np.float32))
    return PsdStep(N, F, device, window=window, backend=backend)


def _accumulate(stream: np.ndarray, N: int, repeats: Optional[int],
                window: Optional[np.ndarray], backend: str, device,
                hop: Optional[int] = None,
                frames_per_step: int = 1024) -> Tuple[np.ndarray, int]:
    slicer = FrameSlicer(N, hop=hop)
    frames = slicer.push(stream, max_frames=repeats)
    wb = None if window is None else np.asarray(window, np.float32).tobytes()
    step = _cached_step(N, min(frames_per_step, max(len(frames), 1)),
                        wb, backend, torch.device(device))
    pwr = np.zeros(N, dtype=np.float64)
    batches = (frames[start:start + step.F]
               for start in range(0, len(frames), step.F))
    read_back_in_order(
        (step(pad_frames(batch, step.F), len(batch)) for batch in batches),
        lambda p: np.add(pwr, p.cpu().numpy(), out=pwr))
    return pwr, len(frames)


def bartlett_psd(iq_u8: np.ndarray, N: int, sample_rate: int,
                 center_freq: int = 0,
                 repeats: Optional[int] = None,
                 window: Optional[np.ndarray] = None,
                 linear: bool = False,
                 baseline: Optional[np.ndarray] = None,
                 backend: str = "auto", *,
                 device) -> Tuple[np.ndarray, np.ndarray]:
    """Averaged PSD of a raw interleaved-u8 IQ array, computed on
    ``device``.

    Returns (freqs[N] in Hz, psd[N]) with the reference's output semantics
    (DC-bin interpolation, /repeats/N/rate normalization, dB unless
    ``linear``, baseline in output units).
    """
    pwr, done = _accumulate(iq_u8, N, repeats, window, backend, device)
    if done == 0:
        raise ValueError("not enough samples for a single FFT frame")
    with np.errstate(divide="ignore"):
        psd = finalize_psd(pwr, done, sample_rate, linear=linear,
                           baseline=baseline)
    return bin_frequencies(center_freq, N, sample_rate), psd
