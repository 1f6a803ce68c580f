"""Measurement planning: repeats, buffer sizing, and the frequency-hop list.

Re-implements ``Plan`` (the reference's src/acquisition.cxx:158-208) with
bit-identical arithmetic: this code defines the frequency axis of every
output spectrum, so the rounding rules (C double ceil, int64 truncating
division) are preserved deliberately.
"""

from __future__ import annotations

import math
import sys
from typing import List

from .config import BASE_BUF, DEFAULT_BUF_MULTIPLIER, Params


class Plan:
    """Integration plan + hop list (reference: acquisition.cxx:158-198)."""

    def __init__(self, params: Params, actual_samplerate: int):
        self.params = params
        self.actual_samplerate = int(actual_samplerate)

        # Number of repeats according to the true sample rate
        # (acquisition.cxx:162-163); C++ ceil on double.
        if params.integration_time_isSet:
            params.repeats = int(math.ceil(
                self.actual_samplerate * params.integration_time / params.N))

        # Adjust buffer size (acquisition.cxx:165-176): if less than ~1.6 MB
        # of data is needed, shrink the buffer to the smallest multiple of
        # BASE_BUF that covers the whole measurement.
        if not params.buf_length_isSet:
            base_buf_multiplier = int(math.ceil(
                (2.0 * params.N * params.repeats) / BASE_BUF))
            if base_buf_multiplier <= DEFAULT_BUF_MULTIPLIER:
                params.buf_length = BASE_BUF * (
                    1 if base_buf_multiplier == 0 else base_buf_multiplier)

        # Frequency-hop list (acquisition.cxx:178-197). Hops overlap just
        # enough to cover [startfreq, stopfreq] exactly; the overlap is
        # spread evenly and never drops below min_overlap percent.
        self.freqs_to_tune: List[int] = []
        if params.freq_hopping_isSet:
            rate = self.actual_samplerate
            min_overhang = rate * params.min_overlap / 100.0
            hops = int(math.ceil(
                (float(params.stopfreq - params.startfreq) - min_overhang)
                / (float(rate) - min_overhang)))
            if hops > 1:
                # int64 arithmetic with truncating division (acquisition.cxx:184).
                overhang = (hops * rate - (params.stopfreq - params.startfreq)) // (hops - 1)
                # First center: startfreq + rate/2.0, truncated into int64 on
                # push_back (freqs_to_tune is std::list<int64_t>).
                self.freqs_to_tune.append(int(params.startfreq + rate / 2.0))
                for _hop in range(1, hops):
                    self.freqs_to_tune.append(self.freqs_to_tune[-1] + rate - overhang)
            else:
                self.freqs_to_tune.append((params.startfreq + params.stopfreq) // 2)
        else:
            self.freqs_to_tune.append(params.cfreq)

    def print(self, file=None) -> None:
        """Summary printout (reference: acquisition.cxx:200-208)."""
        err = file if file is not None else sys.stderr
        p = self.params
        print(f"Number of bins: {p.N}", file=err)
        print(f"Total number of (complex) samples to collect: {p.N * p.repeats}", file=err)
        print(f"Buffer length: {p.buf_length}", file=err)
        print(f"Number of averaged spectra: {p.repeats}", file=err)
        est = float(p.N) * p.repeats / self.actual_samplerate
        print(f"Estimated time of measurements: {est:g} seconds", file=err)
        if p.strict_time:
            print(f"Acquisition will unconditionally terminate after "
                  f"{p.integration_time:g} seconds.", file=err)
