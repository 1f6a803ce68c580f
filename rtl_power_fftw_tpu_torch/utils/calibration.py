"""Absolute-power calibration helpers.

The reference is explicit that its output is relative: "the numbers are
NOT in dBm ... If you need absolute units, you have to calibrate your
device against a known reference signal" (doc/rtl_power_fftw.1.md:102).
These helpers do exactly that calibration — an extension the reference
leaves to the user.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def tone_power_db(freqs: np.ndarray, psd_db: np.ndarray, tone_freq: float,
                  enbw_bins: float = 3.0, search_bins: int = 16) -> float:
    """Integrated power (dB) of a tone near ``tone_freq``: the actual peak
    is searched within ±``search_bins`` of the nominal bin (tuner ppm
    offsets routinely shift a tone several bins), then linear PSD is
    summed over ±ceil(enbw_bins) around the found peak (covers leakage /
    window ENBW)."""
    freqs = np.asarray(freqs, dtype=np.float64)
    psd_db = np.asarray(psd_db, dtype=np.float64)
    nominal = int(np.argmin(np.abs(freqs - tone_freq)))
    s_lo = max(0, nominal - int(search_bins))
    s_hi = min(len(psd_db), nominal + int(search_bins) + 1)
    center = s_lo + int(np.argmax(psd_db[s_lo:s_hi]))
    half = int(np.ceil(enbw_bins))
    lo = max(0, center - half)
    hi = min(len(psd_db), center + half + 1)
    linear = 10.0 ** (psd_db[lo:hi] / 10.0)
    return 10.0 * np.log10(linear.sum())


def calibration_offset(freqs: np.ndarray, psd_db: np.ndarray,
                       ref_freq: float, ref_power_dbm: float,
                       enbw_bins: float = 3.0, search_bins: int = 16) -> float:
    """dB offset such that ``psd_db + offset`` is in dBm for this device/
    gain/rate configuration, derived from a reference tone of known
    absolute power injected at ``ref_freq``."""
    measured = tone_power_db(freqs, psd_db, ref_freq, enbw_bins, search_bins)
    return float(ref_power_dbm - measured)


def apply_calibration(psd_db: np.ndarray, offset_db: float) -> np.ndarray:
    """Shift a relative dB spectrum into absolute units (dBm)."""
    return np.asarray(psd_db, dtype=np.float64) + offset_db


def noise_floor_db(psd_db: np.ndarray,
                   mask: Optional[np.ndarray] = None) -> Tuple[float, float]:
    """Robust (median, MAD-sigma) estimate of the noise floor in dB,
    optionally excluding masked bins (e.g. RFI flagged by spectral
    kurtosis)."""
    psd = np.asarray(psd_db, dtype=np.float64)
    if mask is not None:
        psd = psd[~np.asarray(mask, dtype=bool)]
    med = float(np.median(psd))
    mad = float(np.median(np.abs(psd - med)))
    return med, 1.4826 * mad
