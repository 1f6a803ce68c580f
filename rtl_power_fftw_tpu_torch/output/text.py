"""Gnuplot-ready text output, byte-compatible with the reference.

Reproduces ``Acquisition::write_data``'s text branch
(acquisition.cxx:360-433): the ``#`` header with UTC timestamps, per-bin
``freq power`` lines under C++ ``setprecision`` semantics, a blank line
after every spectrum, and a second blank line after each measurement set
(rtl_power_fftw.cxx:184-194) — gnuplot's dataset separator.
"""

from __future__ import annotations

import math
import sys
from typing import IO, Iterable, Optional

import numpy as np

from ..utils.cxxfmt import cxx_float


def freq_precision(tuned_freq: int, actual_samplerate: int, N: int) -> int:
    """Adaptive frequency significant digits (acquisition.cxx:379-383).

    ``actual_samplerate/params.N`` is C++ int division — preserved here.
    Clamped to a sane range to avoid inf when the formula degenerates
    (rate < N), which would be UB in the reference.
    """
    extra_digits_freq = 2
    step = actual_samplerate // N
    if tuned_freq <= 0 or step <= 0:
        return 17
    places = math.ceil(math.floor(math.log10(tuned_freq))
                       - math.log10(step) + 1 + extra_digits_freq)
    return max(1, min(int(places), 40))


POWER_PRECISION = 6  # significantPlacesPwr (acquisition.cxx:383)


def _write_block(out: IO[str], freqs, values, fprec: int) -> None:
    """The per-bin data lines + the spectrum-separator blank line +
    flush, under C++ ``setprecision`` semantics — shared by the main
    writer and the SK sidecar so the two line formats cannot diverge."""
    lines = []
    for f, v in zip(np.asarray(freqs, dtype=np.float64),
                    np.asarray(values, dtype=np.float64)):
        lines.append(f"{cxx_float(f, fprec)} "
                     f"{cxx_float(v, POWER_PRECISION)}\n")
    out.write("".join(lines))
    # Consecutive spectra are separated by an empty line
    # (acquisition.cxx:428-432).
    out.write("\n")
    out.flush()


class TextWriter:
    """Writes spectra in the reference's text format."""

    def __init__(self, stream: Optional[IO[str]] = None):
        self.stream = stream if stream is not None else sys.stdout

    def write_spectrum(self, freqs: Iterable[float], values: Iterable[float],
                       start_timestamp: str, end_timestamp: str,
                       tuned_freq: int, actual_samplerate: int, N: int) -> None:
        out = self.stream
        # Header (acquisition.cxx:367-374).
        out.write("# rtl-power-fftw output\n")
        out.write(f"# Acquisition start: {start_timestamp}\n")
        out.write(f"# Acquisition end: {end_timestamp}\n")
        out.write("#\n")
        out.write("# frequency [Hz] power spectral density [dB/Hz]\n")

        _write_block(out, freqs, values,
                     freq_precision(tuned_freq, actual_samplerate, N))

    def end_measurement_set(self) -> None:
        """Additional empty line after a full measurement set
        (rtl_power_fftw.cxx:184-194)."""
        self.stream.write("\n")
        self.stream.flush()


class SkWriter:
    """Spectral-kurtosis sidecar (``--sk-file``): same line formatting,
    timestamps, and blank-line separators as the main text output so
    every downstream tool that parses one parses the other. No DC-bin
    interpolation — RFI flagging wants the true DC statistic."""

    def __init__(self, stream: IO[str]):
        self.stream = stream

    def write_sk(self, freqs: Iterable[float], sk: Iterable[float],
                 start_timestamp: str, end_timestamp: str,
                 tuned_freq: int, actual_samplerate: int, N: int,
                 spectra: int) -> None:
        out = self.stream
        out.write("# rtl-power-fftw spectral kurtosis\n")
        out.write(f"# Acquisition start: {start_timestamp}\n")
        out.write(f"# Acquisition end: {end_timestamp}\n")
        out.write(f"# Spectra accumulated: {spectra}\n")
        out.write("#\n")
        out.write("# frequency [Hz] spectral kurtosis "
                  "(Gaussian expectation 1)\n")
        _write_block(out, freqs, sk,
                     freq_precision(tuned_freq, actual_samplerate, N))

    def end_measurement_set(self) -> None:
        self.stream.write("\n")
        self.stream.flush()
