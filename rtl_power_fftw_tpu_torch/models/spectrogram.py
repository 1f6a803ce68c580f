"""Spectrogram / waterfall: per-segment (optionally group-averaged)
spectra over time.

Port of ``rtl_power_fftw_tpu/models/spectrogram.py``. The matrix (.bin)
output of the reference is a waterfall built one scan row at a time
(acquisition.cxx:385-409); this estimator computes the same thing over a
recording: rows = time, columns = shifted frequency bins. The device step
is the frames kernel ("FR", ``ops/kernels/csrc/fused_psd_frames.cu`` on a
CUDA device, its plain PyTorch version on the CPU), which writes each
frame's fftshifted |X|^2; the host sums ``average`` rows in float64 and
finalizes them as the JAX module does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.kernels.fused_psd_frames import fused_psd_frames
from ..ops.spectral import (FrameSlicer, _unported, bin_frequencies,
                            estimator_route, finalize_psd, pad_frames)
from ._steps import device_window, read_back_in_order, upload

#: ``backend`` names the frames kernel serves (the JAX package's
#: spectrogram runs its platform FFT under both).
BACKENDS = ("auto", "pallas")


def spectrogram(iq_u8: np.ndarray, N: int, sample_rate: int,
                center_freq: int = 0,
                hop: Optional[int] = None,
                average: int = 1,
                window: Optional[np.ndarray] = None,
                linear: bool = False,
                backend: str = "auto",
                frames_per_step: int = 1024,
                dc_interp: bool = True, *,
                device) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compute a waterfall on ``device``.

    Returns (times[rows] segment-start seconds, freqs[N] Hz,
    S[rows, N]) where each row is the PSD of ``average`` consecutive
    segments in the reference's output units (dB/Hz unless ``linear``).
    ``dc_interp`` replaces the center bin with its neighbor average per
    row, exactly like every matrix-mode row in the reference
    (acquisition.cxx:376-377); pass False to keep the raw DC bin.
    """
    estimator_route(N, "spectrogram")
    if backend not in BACKENDS:
        raise _unported(f"spectrogram with backend {backend}")
    hop = N if hop is None else int(hop)
    slicer = FrameSlicer(N, hop=hop)
    frames = slicer.push(iq_u8)
    n_frames = (len(frames) // average) * average
    if n_frames == 0:
        raise ValueError("not enough samples for a single segment")
    frames = frames[:n_frames]

    device = torch.device(device)
    w = device_window(window, device)
    F = min(frames_per_step, n_frames)
    F -= F % average or 0
    F = max(F, average)

    rows = []

    def read_back(out: torch.Tensor) -> None:
        # Each step holds whole groups of ``average`` rows (F is their
        # multiple), summed in float64 as the JAX module sums them.
        pwr = out.cpu().numpy().astype(np.float64)
        rows.append(pwr.reshape(-1, average, N).sum(axis=1))

    def launches():
        for start in range(0, n_frames, F):
            batch = frames[start:start + F]
            yield fused_psd_frames(upload(pad_frames(batch, F), device),
                                   len(batch), w, "power_shifted")[:len(batch)]

    read_back_in_order(launches(), read_back)
    pwr = np.concatenate(rows)
    if dc_interp:
        # Same row finalization as the matrix writer (finalize_psd).
        with np.errstate(divide="ignore"):
            psd = finalize_psd(pwr, average, sample_rate, linear=linear,
                               already_shifted=True)
    else:
        psd = pwr / average / N / sample_rate
        if not linear:
            with np.errstate(divide="ignore"):
                psd = 10.0 * np.log10(psd)
    times = (np.arange(n_frames // average) * average * hop) / sample_rate
    return times, bin_frequencies(center_freq, N, sample_rate), psd
