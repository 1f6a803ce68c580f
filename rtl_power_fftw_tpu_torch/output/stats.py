"""Session-wide metadata bookkeeping.

The reference keeps this state in mutable process globals
(rtl_power_fftw.cxx:39-48, metadata.h:28-33), mutated from
``Acquisition::run`` and ``write_data``.  Here it lives on one object with
identical update ordering, so the ``.met`` sidecar comes out the same.
"""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np


@dataclasses.dataclass
class SessionStats:
    # Matrix-mode counters (globals at rtl_power_fftw.cxx:40-41).
    metaRows: int = 1
    metaCols: int = 0
    # Scan-duration tracking (rtl_power_fftw.cxx:42-44): scanBeg/scanEnd
    # are time_t (whole seconds) and the sums are C floats — reproduced
    # with int seconds + float32 so the .met avgScanDur line is
    # byte-identical to the reference for the same run.
    avgScanDur: float = 0.0
    sumScanDur: float = 0.0
    scanBeg: int = 0
    scanEnd: int = 0
    # Frequency extents, computed once from the first/last hop
    # (rtl_power_fftw.cxx:155-163).
    startFreq: int = 0
    endFreq: int = 0
    stepFreq: int = 0
    freqsMetaNeeded: bool = True
    # Timestamps (rtl_power_fftw.cxx:47-48).
    firstAcqTimestamp: str = ""
    lastAcqTimestamp: str = ""
    cntTimeStamps: int = 0

    def begin_scan(self, timestamp: str) -> None:
        """Acquisition start bookkeeping (acquisition.cxx:259-264)."""
        self.scanBeg = int(_time.time())  # time(&scanBeg): whole seconds
        if self.cntTimeStamps == 0:
            self.firstAcqTimestamp = timestamp
            self.cntTimeStamps += 1

    def end_scan(self, timestamp: str) -> None:
        """Acquisition end bookkeeping (acquisition.cxx:334-339):
        difftime over time_t gives whole-second durations; sumScanDur and
        avgScanDur are C floats (metadata.h:31) — both reproduced in f32
        for .met byte parity."""
        self.scanEnd = int(_time.time())
        self.lastAcqTimestamp = timestamp
        self.sumScanDur = float(np.float32(
            np.float32(self.sumScanDur)
            + np.float32(float(self.scanEnd - self.scanBeg))))
        self.avgScanDur = float(np.float32(
            np.float32(self.sumScanDur) / np.float32(self.metaRows)))
