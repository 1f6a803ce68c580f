"""Cyclostationary analysis: spectral correlation over recorded IQ.

Port of ``rtl_power_fftw_tpu/models/cyclo.py:spectral_correlation``. The
spectral correlation function

    S^α(f) = E[ X(f + α) · conj(X(f)) ]

detects the periodic structure man-made signals (AM, PSK, OFDM) carry
between frequency bins, which a PSD discards. Each step runs two kernels
on a CUDA device (their plain PyTorch versions on the CPU): the frames
kernel ("FR", ``ops/kernels/csrc/fused_psd_frames.cu``) writes the step's
(F, N) spectra X, and the spectral-correlation kernel ("SCF",
``ops/kernels/csrc/fused_psd_scf.cu``) sums the shifted products over the
valid frames for each α lag (multiples of the bin width rate/N), a slab
of lags a call. The float64 accumulation, the coherence normalization
and the α axis are on the host, as in the JAX module; α = 0 is the
ordinary averaged PSD.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.kernels.fused_psd_frames import fused_psd_frames
from ..ops.kernels.fused_psd_scf import fused_psd_scf, lag_slabs
from ..ops.spectral import FrameSlicer, adapt_batch, estimator_route, \
    pad_frames
from ._steps import device_window, read_back_in_order, upload


def spectral_correlation(iq: np.ndarray, N: int, sample_rate: int,
                         max_alpha_bins: int = 16,
                         window: Optional[np.ndarray] = None, *,
                         device) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Spectral correlation surface of a recorded u8 IQ stream, computed
    on ``device``.

    iq: raw interleaved u8 bytes. Returns (alphas_hz (K,), scf (K, N)
    complex128 — the frame-averaged S^α, unshifted bins — and coherence
    (K, N) float64 in [0, 1]). Row 0 (α=0) is the ordinary averaged PSD
    (times the frame count normalization of the caller's choosing).

    α granularity is the bin width sample_rate/N; K = max_alpha_bins
    rows are computed (α = 0, Δf, 2Δf, ...).
    """
    estimator_route(N, "spectral_correlation")
    if max_alpha_bins < 1 or max_alpha_bins > N:
        raise ValueError("max_alpha_bins must be in [1, N]")
    slicer = FrameSlicer(N)
    frames = slicer.push(np.asarray(iq, dtype=np.uint8).ravel())
    M = len(frames)
    if M == 0:
        raise ValueError("stream shorter than one FFT frame")
    F, chunk = adapt_batch(min(M, 512))
    K = int(max_alpha_bins)
    if window is not None:
        w = np.asarray(window, dtype=np.float32)
        if w.shape != (N,):
            raise ValueError(f"window must have shape ({N},)")
    device = torch.device(device)
    win = device_window(window, device)
    slabs = lag_slabs(N, K)

    acc_r = np.zeros((K, N), dtype=np.float64)
    acc_i = np.zeros((K, N), dtype=np.float64)

    def read_back(item) -> None:
        k0, out = item
        r, i = out.cpu().numpy().astype(np.float64)
        acc_r[k0:k0 + len(r)] += r
        acc_i[k0:k0 + len(i)] += i

    def launches():
        for start in range(0, M, F):
            batch = frames[start:start + F]
            nv = len(batch)
            X = fused_psd_frames(upload(pad_frames(batch, F), device), nv,
                                 win, "complex")
            for k0, count in slabs:
                yield k0, fused_psd_scf(X, nv, chunk, k0, count)

    read_back_in_order(launches(), read_back)

    scf = (acc_r + 1j * acc_i) / M
    psd = scf[0].real                        # S⁰(f) ≥ 0
    denom = np.sqrt(np.maximum(
        np.stack([np.roll(psd, -k) for k in range(K)]) * psd, 1e-300))
    coherence = np.abs(scf) / denom
    alphas = np.arange(K, dtype=np.float64) * sample_rate / N
    return alphas, scf, coherence
