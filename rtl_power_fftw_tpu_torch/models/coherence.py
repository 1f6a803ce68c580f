"""Cross-spectral density and magnitude-squared coherence of two IQ
streams.

Port of ``rtl_power_fftw_tpu/models/coherence.py``. Averaging the complex
cross-spectrum X·conj(Y) over frames reveals signals common to both
streams (the two-receiver companion to ``--streams``); coherence γ² =
|Sxy|² / (Sxx·Syy) ∈ [0, 1] measures how correlated each bin is. The
device step is the cross-spectral kernel ("CSD",
``ops/kernels/csrc/fused_psd_csd.cu`` on a CUDA device, its plain PyTorch
version on the CPU): one pass over both streams' frame batches gives
Sxx, Syy and the re/im planes of Sxy, four (N,) rows a step; the float64
accumulation, fftshift, DC-bin interpolation and normalization stay on
the host, as in the JAX module.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.kernels.fused_psd_csd import fused_psd_csd
from ..ops.spectral import (FrameSlicer, adapt_batch, bin_frequencies,
                            estimator_route, pad_frames)
from ._steps import device_window, read_back_in_order, upload


def coherence(iq_x: np.ndarray, iq_y: np.ndarray, N: int, sample_rate: int,
              center_freq: int = 0,
              repeats: Optional[int] = None,
              window: Optional[np.ndarray] = None,
              frames_per_step: int = 512, *,
              device) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Magnitude-squared coherence and complex CSD of two u8 IQ streams,
    computed on ``device``.

    Returns (freqs[N], gamma2[N] in [0,1], csd[N] complex128 — the
    averaged cross-spectral density, normalized like the PSD estimators:
    /M/N/rate), all fftshifted to the output bin order.
    """
    estimator_route(N, "coherence")
    sx = FrameSlicer(N)
    sy = FrameSlicer(N)
    fx = sx.push(iq_x, max_frames=repeats)
    fy = sy.push(iq_y, max_frames=repeats)
    M = min(len(fx), len(fy))
    if M < 2:
        raise ValueError("coherence needs at least 2 frames in each stream")
    fx, fy = fx[:M], fy[:M]

    device = torch.device(device)
    F, chunk = adapt_batch(min(frames_per_step, M))
    w = device_window(window, device)

    sxx = np.zeros(N, np.float64)
    syy = np.zeros(N, np.float64)
    sxy = np.zeros(N, np.complex128)

    def read_back(out: torch.Tensor) -> None:
        a, b, cr, ci = out.cpu().numpy().astype(np.float64)
        sxx[:] += a
        syy[:] += b
        sxy[:] += cr + 1j * ci

    read_back_in_order(
        (fused_psd_csd(upload(pad_frames(fx[start:start + F], F), device),
                       upload(pad_frames(fy[start:start + F], F), device),
                       len(fx[start:start + F]), chunk, w)
         for start in range(0, M, F)), read_back)

    shift = np.fft.fftshift
    sxx_s, syy_s, sxy_s = shift(sxx), shift(syy), shift(sxy)
    # DC-bin interpolation, like every PSD output (acquisition.cxx:376-377):
    # the deterministic (u8−127) quantizer offset is common to BOTH
    # streams, so without this the DC bin shows spurious coherence ~1 even
    # for fully independent receivers.
    c = N // 2
    for arr in (sxx_s, syy_s, sxy_s):
        arr[c] = (arr[c - 1] + arr[c + 1]) / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        gamma2 = np.abs(sxy_s) ** 2 / np.maximum((sxx_s * syy_s).real, 1e-300)
    csd = sxy_s / M / N / sample_rate
    return bin_frequencies(center_freq, N, sample_rate), gamma2, csd
