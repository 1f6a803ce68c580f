"""Binary matrix output: ``.bin`` float32 stream + ``.met`` metadata sidecar.

Reproduces the reference's matrix mode: the ``.bin`` file is truncated at
session start (rtl_power_fftw.cxx:122-128) and every scan appends one row of
float32 power values (acquisition.cxx:385-409) — so a killed session keeps
its completed rows.  The nine-line ``.met`` sidecar (rtl_power_fftw.cxx:
207-220) is written at clean exit; as a resilience extension it can also be
refreshed incrementally after every pass (SURVEY §5 checkpoint/resume note).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.cxxfmt import cxx_float
from .stats import SessionStats


class MatrixWriter:
    def __init__(self, bin_file: str, meta_file: str, stats: SessionStats):
        self.bin_file = bin_file
        self.meta_file = meta_file
        self.stats = stats

    def truncate(self) -> None:
        """Start-of-session truncation (rtl_power_fftw.cxx:122-128)."""
        with open(self.bin_file, "wb"):
            pass

    def append_row(self, values: np.ndarray, tuned_freq: int, finalfreq: int) -> None:
        """Append one scan row of float32 values (acquisition.cxx:385-426).

        Bookkeeping matches the reference: metaCols counts bins only while
        metaRows == 1 (i.e. across all hops of the first pass), and metaRows
        advances when the final hop of a pass is written.
        """
        vals = np.asarray(values, dtype=np.float32)
        with open(self.bin_file, "ab") as f:
            f.write(vals.tobytes())
        if self.stats.metaRows == 1:
            self.stats.metaCols += len(vals)
        if tuned_freq >= finalfreq:
            self.stats.metaRows += 1

    def write_meta(self, N: int, repeats_done: int, actual_samplerate: int) -> None:
        """The 9-line .met sidecar (rtl_power_fftw.cxx:207-220).

        Numeric formatting matches C++ default iostream precision (6
        significant digits for floats).
        """
        s = self.stats
        eff_time = float(N) * repeats_done / actual_samplerate
        rows = s.metaRows - 1  # rows count starts from 1 in the reference
        with open(self.meta_file, "w") as f:
            f.write(f"{s.metaCols} # frequency bins (columns)\n")
            f.write(f"{rows} # scans (rows)\n")
            f.write(f"{s.startFreq} # startFreq (Hz)\n")
            f.write(f"{s.endFreq} # endFreq (Hz)\n")
            f.write(f"{s.stepFreq} # stepFreq (Hz)\n")
            f.write(f"{cxx_float(eff_time)} # effective integration time secs\n")
            f.write(f"{cxx_float(s.avgScanDur)} # avgScanDur (sec)\n")
            f.write(f"{s.firstAcqTimestamp} # firstAcqTimestamp UTC\n")
            f.write(f"{s.lastAcqTimestamp} # lastAcqTimestamp UTC\n")


def read_matrix(bin_file: str, meta_file: Optional[str] = None):
    """Convenience loader for matrix output (not in the reference): returns
    (rows × cols float32 array, metadata dict or None)."""
    data = np.fromfile(bin_file, dtype=np.float32)
    meta = None
    if meta_file:
        meta = {}
        keys = ["cols", "rows", "startFreq", "endFreq", "stepFreq",
                "effIntegrationTime", "avgScanDur", "firstAcqTimestamp",
                "lastAcqTimestamp"]
        with open(meta_file) as f:
            for key, line in zip(keys, f):
                val = line.split("#")[0].strip()
                meta[key] = val
        cols = int(meta["cols"])
        if cols > 0:
            # A session killed mid-write can leave a partial trailing row
            # (append_row is not atomic); completed rows must stay
            # readable — that recovery is this loader's whole point.
            data = data[:len(data) // cols * cols].reshape(-1, cols)
    return data, meta
