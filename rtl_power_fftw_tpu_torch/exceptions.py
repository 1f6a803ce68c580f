"""Typed errors and process exit codes.

TPU-native re-design of the reference's error model
(the reference's src/exceptions.h:25-47): a single exception type carrying a
message plus a ``ReturnValue`` that becomes the process exit code, and a
dedicated ``TuneError`` for recoverable tuning failures
(the reference's src/acquisition.h:66-77).
"""

from __future__ import annotations

import enum


class ReturnValue(enum.IntEnum):
    """Process exit codes (reference: exceptions.h:25-34)."""

    Success = 0
    NoDeviceFound = 1
    InvalidDeviceIndex = 2
    InvalidArgument = 3
    TCLAPerror = 4  # kept for exit-code parity: CLI-parse errors
    InvalidInput = 5
    AcquisitionError = 6
    HardwareError = 7


class RPFexception(RuntimeError):
    """Carries an error message and the exit code to return.

    Reference: exceptions.h:39-47 — caught once at the top of ``main``
    (rtl_power_fftw.cxx:227-230) and converted to the process exit status.
    """

    def __init__(self, message: str, retval: ReturnValue):
        super().__init__(message)
        self.retval = ReturnValue(retval)

    @property
    def return_value(self) -> ReturnValue:
        return self.retval


class StreamEOF(Exception):
    """A finite recorded stream ran out of data mid-acquisition.

    Not an error: the session finishes the current spectrum with however
    many frames were accumulated (``repeats_done < repeats``) and ends —
    the same partial-write semantics as a --strict-time deadline
    (reference: acquisition.cxx:326-331,350-358). ``partial`` carries any
    already-buffered tail bytes (shorter than the requested read) so the
    final frames they contain still count.
    """

    def __init__(self, message: str, partial=None):
        super().__init__(message)
        self.partial = partial


class TuneError(Exception):
    """The source could not tune to a frequency despite retries.

    Not a fatal error: the frequency may simply be a dead spot of the
    receiver, so the session drops it from the hop list and continues
    (reference: acquisition.h:62-77, rtl_power_fftw.cxx:141-147).
    """

    def __init__(self, freq: int):
        super().__init__("Could not tune to the given frequency.")
        self.freq = int(freq)

    def frequency(self) -> int:
        return self.freq
