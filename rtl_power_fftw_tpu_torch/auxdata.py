"""Auxiliary input: window-function and baseline vectors.

Re-implements ``AuxData`` (the reference's src/acquisition.cxx:32-156):
values are read one-per-line, ``#`` lines are comments, and when a line has
several columns the *last* value wins — so the program's own output can be
fed back as a baseline (doc/rtl_power_fftw.1.md:125). Window data is float32
(samples are 8-bit anyway); baseline is float64 (it may encode averages of
huge numbers of spectra).

Divergence from the reference, by documented intent: when both window and
baseline come from stdin, the reference's split is broken (acquisition.cxx:76
computes ``half_size`` from the still-empty window vector, so all 2N values
land in the baseline and the window is empty — a latent crash).  We follow
the man page instead (doc/rtl_power_fftw.1.md:127): the baseline data comes
first, followed by the window function data.

This module also provides built-in window generators (an extension; the
reference can only read windows from files).
"""

from __future__ import annotations

import re as _re
import sys
from typing import IO, List, Optional

import numpy as np

from .config import Params
from .exceptions import ReturnValue, RPFexception


_CXX_HEXFLOAT = _re.compile(
    r"[+-]?0[xX][0-9a-fA-F]+(?:\.[0-9a-fA-F]*)?(?:[pP][+-]?\d+)?")
_CXX_FLOAT = _re.compile(r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?")


def read_inputfile(stream: IO[str]) -> List[float]:
    """Parse aux input line by line (reference: acquisition.cxx:32-59).

    Takes the last parseable float on each line; skips ``#`` comments and
    lines with no numbers at all. ``lineStream >> value`` is a CHARACTER
    stream extraction, not a whitespace-token parse: it consumes the
    longest valid numeric PREFIX and stops at the first character that
    cannot continue a number — so ``1420e6 -95.3dB`` yields -95.3 (the
    'dB' suffix ends extraction AFTER a successful parse) and ``3,5``
    yields 3, exactly like the C++. num_get rejects ``nan``/``inf`` and
    Python's ``1_000`` separators; hexfloats (``0x1p-3``) parse like
    strtod's."""
    values: List[float] = []
    for line in stream:
        if line.lstrip()[:1] == "#":
            continue
        last = None
        pos, end = 0, len(line)
        while True:
            while pos < end and line[pos].isspace():  # >> skips leading ws
                pos += 1
            m = _CXX_HEXFLOAT.match(line, pos) or _CXX_FLOAT.match(line, pos)
            if m is None:
                break  # extraction failed: the rest of the line is ignored
            tok = m.group(0)
            try:
                last = (float.fromhex(tok) if "x" in tok or "X" in tok
                        else float(tok))
            except ValueError:  # pragma: no cover - regex guarantees parse
                break
            pos = m.end()
        if last is not None:
            values.append(last)
    return values


# Built-in window generators (periodic form, matching common PSD practice).
# These are coherent-gain-uncorrected, exactly as a file-supplied window
# would be in the reference.
def _hann(n: int) -> np.ndarray:
    k = np.arange(n)
    return 0.5 - 0.5 * np.cos(2 * np.pi * k / n)


def _hamming(n: int) -> np.ndarray:
    k = np.arange(n)
    return 0.54 - 0.46 * np.cos(2 * np.pi * k / n)


def _blackman(n: int) -> np.ndarray:
    k = np.arange(n)
    w = 2 * np.pi * k / n
    return 0.42 - 0.5 * np.cos(w) + 0.08 * np.cos(2 * w)


def _blackman_harris(n: int) -> np.ndarray:
    k = np.arange(n)
    w = 2 * np.pi * k / n
    return (0.35875 - 0.48829 * np.cos(w)
            + 0.14128 * np.cos(2 * w) - 0.01168 * np.cos(3 * w))


def _flattop(n: int) -> np.ndarray:
    k = np.arange(n)
    w = 2 * np.pi * k / n
    return (0.21557895 - 0.41663158 * np.cos(w) + 0.277263158 * np.cos(2 * w)
            - 0.083578947 * np.cos(3 * w) + 0.006947368 * np.cos(4 * w))


def _bartlett(n: int) -> np.ndarray:
    k = np.arange(n)
    return 1.0 - np.abs(2.0 * k / n - 1.0)


def _boxcar(n: int) -> np.ndarray:
    return np.ones(n)


WINDOW_FUNCTIONS = {
    "hann": _hann,
    "hanning": _hann,
    "hamming": _hamming,
    "blackman": _blackman,
    "blackman-harris": _blackman_harris,
    "blackmanharris": _blackman_harris,
    "flattop": _flattop,
    "bartlett": _bartlett,
    "boxcar": _boxcar,
    "rectangular": _boxcar,
}


def make_window(name: str, n: int) -> np.ndarray:
    fn = WINDOW_FUNCTIONS.get(name)
    if fn is None:
        raise RPFexception(
            f"Unknown window function '{name}'. Available: "
            + ", ".join(sorted(set(WINDOW_FUNCTIONS))) + ".",
            ReturnValue.InvalidArgument)
    return fn(n).astype(np.float32)


class AuxData:
    """Window/baseline vectors loaded per the Params (acquisition.cxx:61-156)."""

    def __init__(self, params: Params, stdin: Optional[IO[str]] = None,
                 stderr: Optional[IO[str]] = None):
        err = stderr if stderr is not None else sys.stderr
        cin = stdin if stdin is not None else sys.stdin
        self.window_values: Optional[np.ndarray] = None  # float32 (N,)
        self.baseline_values: Optional[np.ndarray] = None  # float64 (N,)

        if (params.window and params.baseline
                and params.window_file == "-" and params.baseline_file == "-"):
            print("Reading baseline and window function from stdin.", file=err)
            values = read_inputfile(cin)
            if len(values) == 2 * params.N:
                # Documented order (doc/rtl_power_fftw.1.md:127): baseline
                # first, then window. See module docstring for the reference
                # divergence.
                self.baseline_values = np.asarray(values[:params.N], dtype=np.float64)
                self.window_values = np.asarray(values[params.N:], dtype=np.float32)
                print(f"Succesfully read {len(self.window_values)} window function points.",
                      file=err)
                print(f"Succesfully read {len(self.baseline_values)} baseline points.",
                      file=err)
            else:
                raise RPFexception(
                    "Error reading window function and baseline from stdin. "
                    f"Expected {2 * params.N} values, found {len(values)}.",
                    ReturnValue.InvalidInput)
        else:
            if params.window:
                if params.window_file == "-":
                    print("Reading window function from stdin.", file=err)
                    values = read_inputfile(cin)
                else:
                    print(f"Reading window function from file {params.window_file}",
                          file=err)
                    try:
                        with open(params.window_file) as fs:
                            values = read_inputfile(fs)
                    except OSError:
                        raise RPFexception(
                            f"Could not open {params.window_file}. Quitting.",
                            ReturnValue.InvalidInput)
                if len(values) == params.N:
                    print(f"Succesfully read {len(values)} window function points.",
                          file=err)
                    self.window_values = np.asarray(values, dtype=np.float32)
                else:
                    raise RPFexception(
                        f"Error reading window function. Expected {params.N} "
                        f"values, found {len(values)}.",
                        ReturnValue.InvalidInput)
            if params.baseline:
                if params.baseline_file == "-":
                    print("Reading baseline from stdin.", file=err)
                    values = read_inputfile(cin)
                else:
                    print(f"Reading baseline from file {params.baseline_file}", file=err)
                    try:
                        with open(params.baseline_file) as fs:
                            values = read_inputfile(fs)
                    except OSError:
                        raise RPFexception(
                            f"Could not open {params.baseline_file}. Quitting.",
                            ReturnValue.InvalidInput)
                if len(values) == params.N:
                    print(f"Succesfully read {len(values)} baseline points.", file=err)
                    self.baseline_values = np.asarray(values, dtype=np.float64)
                else:
                    raise RPFexception(
                        f"Error reading baseline. Expected {params.N} "
                        f"values, found {len(values)}.",
                        ReturnValue.InvalidInput)

        # Extension: generated windows.
        if params.window_function:
            self.window_values = make_window(params.window_function, params.N)
            print(f"Using built-in {params.window_function} window "
                  f"({params.N} points).", file=err)
