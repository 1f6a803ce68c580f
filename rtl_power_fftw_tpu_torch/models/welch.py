"""Welch PSD estimate: averaged periodograms over *overlapping* windowed
segments (BASELINE.json config 2).

Port of ``rtl_power_fftw_tpu/models/welch.py``: the device step of
Bartlett with a host framing stride shorter than N.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..auxdata import make_window

from ..ops.spectral import bin_frequencies, finalize_psd
from .bartlett import _accumulate


def welch_psd(iq_u8: np.ndarray, N: int, sample_rate: int,
              center_freq: int = 0,
              overlap_percent: float = 50.0,
              window: Optional[np.ndarray] | str = "hann",
              repeats: Optional[int] = None,
              linear: bool = False,
              baseline: Optional[np.ndarray] = None,
              backend: str = "auto", *,
              device) -> Tuple[np.ndarray, np.ndarray]:
    """Welch-averaged PSD on ``device``. ``window`` may be a name or an
    (N,) array.

    Returns (freqs[N], psd[N]) in the reference's output units.
    """
    if not (0.0 <= overlap_percent < 100.0):
        raise ValueError("overlap_percent must be in [0, 100)")
    if isinstance(window, str):
        window = make_window(window, N)
    hop = max(1, int(round(N * (1.0 - overlap_percent / 100.0))))
    pwr, done = _accumulate(iq_u8, N, repeats, window, backend, device,
                            hop=hop)
    if done == 0:
        raise ValueError("not enough samples for a single FFT segment")
    with np.errstate(divide="ignore"):
        psd = finalize_psd(pwr, done, sample_rate, linear=linear,
                           baseline=baseline)
    return bin_frequencies(center_freq, N, sample_rate), psd
