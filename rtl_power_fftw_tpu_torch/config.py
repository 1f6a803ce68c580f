"""Configuration: value parsers and the ``Params`` flag system.

Re-implements the reference's option surface and validation semantics
(the reference's src/params.{h,cxx}) on top of ``argparse`` instead of TCLAP.
All defaults, derived values, rounding rules and mutual-exclusion checks
follow the reference exactly, because they define the output numerology
(bin frequencies, repeat counts, buffer sizes).

Extensions beyond the reference (all optional, all default-off) are kept in
a separate block at the end of ``Params`` and documented in README.md.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import re
import sys
from typing import List

from .exceptions import ReturnValue, RPFexception

# Reference constants (params.h:26-27). USB transfers from librtlsdr must be
# multiples of 16384 bytes; we keep the constraint for recorded-stream parity.
BASE_BUF = 16384
DEFAULT_BUF_MULTIPLIER = 100

_NUM_RE = re.compile(r"\s*([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)")


def parse_frequency(s: str) -> int:
    """Parse a frequency with optional k/M/G suffix; -1 on error.

    Mirrors params.cxx:29-43: read a double, then an optional multiplier
    token (whitespace between them is allowed), truncate to int.
    """
    m = _NUM_RE.match(s)
    if not m:
        # C++11 zero-initializes the double on extraction failure and skips
        # the multiplier read, returning 0. We deliberately return -1 so that
        # garbage is rejected instead of silently meaning "0 Hz".
        return -1
    f = float(m.group(1))
    multiplier = s[m.end():].strip()
    if multiplier == "k":
        f *= 1e3
    elif multiplier == "M":
        f *= 1e6
    elif multiplier == "G":
        f *= 1e9
    elif multiplier != "":
        return -1
    if not math.isfinite(f) or not (-2.0 ** 63 <= f < 2.0 ** 63):
        # The reference's (int64_t)f cast is UB here (overflowed istream
        # extraction yields HUGE_VAL in C++11; observed INT64_MIN garbage
        # from g++). We reject instead — pinned as divergence class 3 in
        # tests/test_cxx_parse_parity.py.
        return -1
    return int(f)


def parse_time(s: str) -> float:
    """Parse a compound duration like ``1d2h3m4s``; -1 on error.

    Mirrors params.cxx:45-88: a unitless trailing number means seconds;
    each unit may appear at most once; unconsumed input is an error.
    """
    if not s:
        return -1.0
    if s[-1] not in "dhms":
        s = s + "s"

    seconds_per = {"d": 86400.0, "h": 3600.0, "m": 60.0, "s": 1.0}
    consumed = set()
    t = 0.0
    pos = 0
    while True:
        m = _NUM_RE.match(s, pos)
        if not m or m.end() >= len(s):
            # `ss >> value` failed or no unit char followed. The C++ loop then
            # returns t if the stream is at EOF (only whitespace left before
            # the failed extraction), else -1.
            return t if s[pos:].strip() == "" else -1.0
        value = float(m.group(1))
        if not math.isfinite(value):
            # C++11 istream extraction fails on out-of-range doubles
            # (failbit, params.cxx:61) → parse error there too.
            return -1.0
        unit = s[m.end()]
        pos = m.end() + 1
        if unit in seconds_per and unit not in consumed:
            t += value * seconds_per[unit]
            consumed.add(unit)
        else:
            return -1.0


class _ArgparseError(Exception):
    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


class _Parser(argparse.ArgumentParser):
    """argparse that raises instead of exiting, for TCLAP-parity exit codes."""

    def error(self, message):  # noqa: D102
        raise _ArgparseError(message)


@dataclasses.dataclass
class Params:
    """All session options; field defaults mirror params.h:33-66."""

    N: int = 512
    dev_index: int = 0
    gain: int = 372
    cfreq: int = 1420405752
    startfreq: int = 0
    stopfreq: int = 0
    sample_rate: int = 2000000
    integration_time: float = 0.0
    integration_time_isSet: bool = False
    buffers: int = 5
    buf_length: int = BASE_BUF * DEFAULT_BUF_MULTIPLIER
    buf_length_isSet: bool = False
    min_overlap: float = 0.0
    ppm_error: int = 0
    endless: bool = False
    strict_time: bool = False
    baseline: bool = False
    baseline_file: str = ""
    window: bool = False
    window_file: str = ""
    freq_hopping_isSet: bool = False
    repeats: int = (BASE_BUF * DEFAULT_BUF_MULTIPLIER) // (2 * 512)
    outcnt: int = 0
    session_duration: float = 0.0
    session_duration_isSet: bool = False
    linear: bool = False
    talkless: bool = False
    matrixMode: bool = False
    finalfreq: int = 0
    matrix_file: str = ""
    bin_file: str = ""
    meta_file: str = ""

    # --- TPU-framework extensions (not present in the reference) ---
    # IQ source specification: "synthetic[:spec]", "file:<path>",
    # "rtl_tcp:<host>:<port>". Empty string means "real device", which in
    # this build resolves through the registered device table.
    source: str = ""
    # Built-in window generator (hann/hamming/blackman/blackman-harris/
    # flattop/bartlett/boxcar); alternative to --window file input.
    window_function: str = ""
    # Welch-style overlap between successive FFT frames, in percent of N.
    welch_overlap: float = 0.0
    # Polyphase-filterbank estimator: taps per branch (0 = plain FFT
    # periodogram, the reference's estimator). The prototype filter is a
    # windowed sinc; --window-function selects its window (default hann).
    pfb_taps: int = 0
    # Thomson multitaper estimator: number of DPSS tapers (0 = off). Each
    # frame is windowed by K orthogonal Slepian tapers and the K
    # eigenspectra are averaged — the lowest-variance estimator for a
    # fixed data length.
    multitaper: int = 0
    # DPSS time-bandwidth product NW for --multitaper (taper main-lobe
    # half-width = NW bins).
    time_bandwidth: float = 4.0
    # Spectral-kurtosis sidecar (RFI flagging): accumulate the second
    # moment Σ|X|⁴ alongside the PSD and write per-bin SK to this file
    # (empty = off). The averaged spectrum itself is unchanged.
    sk_file: str = ""
    # Real-time SK excision (0 = off): per device-step block, drop a
    # bin's contribution to the averaged spectrum when the block's
    # |SK−1| exceeds this many null standard deviations (2/√M).
    sk_excise: float = 0.0
    # Number of parallel IQ streams sharded over the device mesh.
    streams: int = 1
    # Shard each transform across the device mesh (sequence parallelism
    # for huge N: distributed four-step FFT, parallel/bigfft.py).
    shard_transform: bool = False
    # Device-step frame batch (0 = derive from buffer length).
    frames_per_step: int = 0
    # FFT backend: "auto" | "xla" | "matmul" | "fourstep" | "fft4"
    # | "hybrid" | "pallas" | "bluestein" | "fourstep4m" | "fourstep4x".
    fft_backend: str = "auto"
    # Write a jax.profiler trace of the session to this directory.
    profile_dir: str = ""
    # Transform precision: "highest" keeps the 1e-5 parity budget
    # (tone-robust); "high" picks the fastest relaxed-parity step per
    # size (see MANUAL.md for the per-path error classes).
    precision: str = "highest"
    # Append machine-readable per-scan stats (JSON lines) to this file.
    stats_json: str = ""
    # Record the raw consumed IQ bytes for replay (--source file:...).
    record_file: str = ""
    # Maintain a stitched wideband spectrum file, refreshed every pass.
    stitch_file: str = ""

    @classmethod
    def from_argv(cls, argv: List[str]) -> "Params":
        return parse_args(argv)


def _build_parser() -> _Parser:
    p = _Parser(
        prog="rtl_power_fftw_tpu",
        description="Obtain power spectrum from IQ sources using TPU-accelerated FFTs.",
        add_help=True,
    )
    # Option surface mirrors params.cxx:103-143 (same short/long names).
    p.add_argument("--buffers", type=int, default=None,
                   help="Number of read buffers (don't touch unless running out of memory).")
    p.add_argument("-w", "--window", type=str, default=None, metavar="file|-",
                   help="Use window function, from file or stdin.")
    p.add_argument("-t", "--time", type=str, default=None, metavar="seconds",
                   help="Integration time (incompatible with -n).")
    p.add_argument("-T", "--strict-time", action="store_true",
                   help="End measurement when the time set with --time option is up, "
                        "regardless of gathered samples.")
    p.add_argument("-s", "--buffer-size", type=int, default=None, metavar="bytes",
                   help="Size of read buffers (leave it unless you know what you are doing).")
    p.add_argument("-r", "--rate", type=int, default=None, metavar="samples/s",
                   help="Sample rate of the receiver.")
    p.add_argument("-q", "--quiet", action="store_true", help="Limit verbosity.")
    p.add_argument("-p", "--ppm", type=int, default=None, metavar="ppm",
                   help="Set custom ppm error in RTL-SDR device.")
    p.add_argument("-o", "--overlap", type=float, default=None, metavar="percent",
                   help="Define lower boundary for overlap when frequency hopping "
                        "(otherwise meaningless).")
    p.add_argument("-m", "--matrix", type=str, default=None, metavar="filename",
                   help="Output data in binary matrix format plus separate metadata text file.")
    p.add_argument("-n", "--repeats", type=int, default=None, metavar="repeats",
                   help="Number of scans for averaging (incompatible with -t).")
    p.add_argument("-l", "--linear", action="store_true",
                   help="Calculate linear power values instead of logarithmic.")
    p.add_argument("-g", "--gain", type=int, default=None, metavar="1/10th of dB",
                   help="Receiver gain.")
    p.add_argument("-f", "--freq", type=str, default=None, metavar="Hz|Hz:Hz",
                   help="Center frequency of the receiver or frequency range to scan.")
    p.add_argument("-e", "--elapsed", type=str, default=None, metavar="seconds",
                   help="Scan session duration.")
    p.add_argument("-d", "--device", type=int, default=None, metavar="device index",
                   help="RTL-SDR device index.")
    p.add_argument("-c", "--continue", dest="endless", action="store_true",
                   help="Repeat the same measurement endlessly.")
    p.add_argument("-b", "--bins", type=int, default=None, metavar="bins",
                   help="Number of bins in FFT spectrum (must be even number).")
    p.add_argument("-B", "--baseline", type=str, default=None, metavar="file|-",
                   help="Subtract baseline, read baseline data from file or stdin.")
    from . import __version__
    p.add_argument("--version", action="version",
                   version=f"rtl_power_fftw_tpu {__version__}")

    # Extensions.
    p.add_argument("--source", type=str, default="",
                   help="IQ source: synthetic[:spec] | file:<path> | rtl_tcp:<host>:<port>.")
    p.add_argument("--window-function", type=str, default="",
                   help="Built-in window generator (hann, hamming, blackman, "
                        "blackman-harris, flattop, bartlett, boxcar).")
    p.add_argument("--welch-overlap", type=float, default=0.0,
                   help="Welch overlap between FFT frames in percent of N (0 = Bartlett).")
    p.add_argument("--pfb-taps", type=int, default=0, metavar="P",
                   help="Use a P-tap polyphase filterbank instead of the "
                        "plain FFT periodogram (sharper channel isolation; "
                        "prototype = windowed sinc, window from "
                        "--window-function, default hann). 0 disables.")
    p.add_argument("--multitaper", type=int, default=0, metavar="K",
                   help="Average K DPSS (Slepian) eigenspectra per frame "
                        "(Thomson multitaper): lowest estimator variance "
                        "for a fixed data length. 0 disables.")
    p.add_argument("--time-bandwidth", type=float, default=4.0,
                   metavar="NW",
                   help="DPSS time-bandwidth product for --multitaper "
                        "(default 4.0; resolution-variance trade-off).")
    p.add_argument("--sk-file", type=str, default="", metavar="FILE",
                   help="Write per-bin spectral kurtosis (Nita-Gary "
                        "generalized SK; Gaussian expectation 1) to FILE "
                        "alongside each spectrum — per-bin RFI flagging "
                        "without touching the averaged PSD.")
    p.add_argument("--sk-excise", type=float, default=0.0, metavar="SIGMA",
                   help="Real-time RFI excision: per accumulation block, "
                        "drop a bin's contribution when the block's "
                        "spectral kurtosis strays more than SIGMA null "
                        "standard deviations (2/sqrt(M)) from 1. The "
                        "averaged spectrum becomes the per-bin mean over "
                        "surviving blocks; fully-flagged bins fall back "
                        "to the unexcised average.")
    p.add_argument("--streams", type=int, default=1,
                   help="Parallel IQ streams sharded across the TPU mesh.")
    p.add_argument("--shard-transform", action="store_true",
                   help="Shard each FFT across the device mesh (sequence "
                        "parallelism for huge N; power-of-two bins whose "
                        "four-step factors the mesh size divides).")
    p.add_argument("--frames-per-step", type=int, default=0,
                   help="FFT frames per device step (0 = auto).")
    p.add_argument("--fft-backend", type=str, default="auto",
                   choices=["auto", "xla", "matmul", "fourstep", "fft4",
                            "hybrid", "pallas", "bluestein", "fourstep4m",
                            "fourstep4x"],
                   help="FFT implementation used on device (hybrid = FFT "
                        "stage 1 + split twiddle + matmul stage 2, the "
                        "tone-robust default for most composite N incl. "
                        "the very-large-N modes on TPU; fft4 = two-level "
                        "FFT four-step; bluestein = chirp-Z for awkward "
                        "N, the TPU default above 8192 bins when N has "
                        "no factor >= 8; fourstep4m = compensated "
                        "four-step, the windowed very-large-N "
                        "budget-truth path; fourstep4x = split-pass "
                        "four-step, the windowed session-size "
                        "budget-truth path).")
    p.add_argument("--precision", type=str, default="highest",
                   choices=["highest", "high"],
                   help="Transform precision: 'highest' holds the "
                        "reference parity budget; 'high' picks the fastest "
                        "relaxed-parity step per size (+5-35%% at "
                        "N <= 1024).")
    p.add_argument("--record", type=str, default="", metavar="file",
                   help="Record the raw consumed IQ bytes to this file "
                        "(replayable with --source file:<file>; with "
                        "--streams S, one file per stream: <file>.s<i>).")
    p.add_argument("--stitch-out", type=str, default="", metavar="file",
                   help="Maintain a stitched wideband spectrum in this "
                        "file (hop overlaps averaged in linear power), "
                        "rewritten after every completed pass — a live "
                        "view for endless scans.")
    p.add_argument("--stats-json", type=str, default="", metavar="file",
                   help="Append per-scan stats as JSON lines (timestamps, "
                        "tuned freq, repeats, readouts, effective "
                        "integration time, queue histogram).")
    p.add_argument("--profile", type=str, default="", metavar="dir",
                   help="Capture a jax.profiler trace of the session into "
                        "this directory (view with TensorBoard/Perfetto).")
    return p


def _ensure_positive(name: str, value) -> None:
    """ensure_positive_arg (params.cxx:90-99): reject negatives (zero is OK)."""
    if value is not None and value < 0:
        raise RPFexception(
            f"Argument to '{name}' must be a positive number.",
            ReturnValue.InvalidArgument)


def parse_args(argv: List[str], stderr=None) -> Params:
    """Parse argv into a validated Params (reference Params::Params,
    params.cxx:101-272). Raises RPFexception with the reference's exit codes.
    """
    err = stderr if stderr is not None else sys.stderr
    parser = _build_parser()
    try:
        ns = parser.parse_args(argv)
    except _ArgparseError as e:
        # TCLAP parse errors exit with code 4 (params.cxx:267-271).
        raise RPFexception(f"Error: {e.message}", ReturnValue.TCLAPerror)

    params = Params()

    _ensure_positive("bins", ns.bins)
    _ensure_positive("rate", ns.rate)
    _ensure_positive("gain", ns.gain)
    _ensure_positive("device", ns.device)
    _ensure_positive("buffers", ns.buffers)
    _ensure_positive("buffer-size", ns.buffer_size)
    _ensure_positive("repeats", ns.repeats)

    if ns.device is not None:
        params.dev_index = ns.device
    if ns.bins is not None:
        params.N = ns.bins
    # Bins must be even so the shifted spectrum aligns cleanly
    # (params.cxx:151-155).
    if params.N % 2 != 0:
        params.N += 1
        print(f"Number of bins should be even, changing to {params.N}.", file=err)
    if params.N == 0:
        # The reference divides by 2N unchecked (params.cxx:217 — UB for
        # N=0); reject explicitly instead.
        raise RPFexception("Argument to 'bins' must be nonzero.",
                           ReturnValue.InvalidArgument)
    params.linear = bool(ns.linear)
    if ns.gain is not None:
        params.gain = ns.gain
    if ns.rate is not None:
        params.sample_rate = ns.rate
    if ns.buffers is not None:
        params.buffers = ns.buffers
    if ns.buffer_size is not None:
        params.buf_length = ns.buffer_size
    params.endless = bool(ns.endless)
    params.talkless = bool(ns.quiet)
    params.strict_time = bool(ns.strict_time)
    if ns.overlap is not None:
        params.min_overlap = ns.overlap
    # The hop-count denominator in the plan is (rate - rate*min_overlap/100)
    # (acquisition.cxx:181-183): at 100% it is exactly zero and beyond it
    # negative — the reference divides anyway (inf/UB); validate instead.
    if not (0.0 <= params.min_overlap < 100.0):
        raise RPFexception(
            "--overlap must be in [0, 100). Exiting.",
            ReturnValue.InvalidArgument)

    # Reads from recorded RTL streams keep the USB granularity constraint:
    # buffer length must be a multiple of 16384 (params.cxx:167-175),
    # rounded half-up.
    if params.buf_length % BASE_BUF != 0:
        params.buf_length = int(math.floor(params.buf_length / BASE_BUF + 0.5)) * BASE_BUF
        print(f"Buffer length should be multiple of {BASE_BUF}, "
              f"changing to {params.buf_length}.", file=err)

    if ns.ppm is not None:
        params.ppm_error = ns.ppm

    if ns.freq is not None:
        a_freq = ns.freq
        if ":" in a_freq:
            start_s, _, stop_s = a_freq.partition(":")
            if start_s != "" and stop_s != "":
                params.startfreq = parse_frequency(start_s)
                params.stopfreq = parse_frequency(stop_s)
                if (params.startfreq < 0 or params.stopfreq < 0
                        or params.stopfreq < params.startfreq):
                    raise RPFexception(
                        f"Invalid frequency range given to --freq: {a_freq}.\n"
                        "Expecting positive numbers in ascending order, allowing "
                        "the k,M,G multipliers. Exiting.",
                        ReturnValue.InvalidArgument)
                params.freq_hopping_isSet = True
                params.cfreq = (params.startfreq + params.stopfreq) // 2
            else:
                raise RPFexception(
                    f"Could not parse frequency range given to --freq: {a_freq}.\n"
                    "Expecting form startfreq:stopfreq. Exiting.",
                    ReturnValue.InvalidArgument)
        else:
            params.cfreq = parse_frequency(a_freq)
            if params.cfreq < 0:
                raise RPFexception(
                    f"Invalid frequency given to --freq: {params.cfreq}.\n"
                    "Expecting a positive number, allowing the k,M,G multipliers. "
                    "Exiting.",
                    ReturnValue.InvalidArgument)

    if ns.repeats is not None:
        params.repeats = ns.repeats
    else:
        # "It is senseless to waste a full buffer of data unless instructed
        # to do so" (params.h:54-55); derived default uses the adjusted
        # buf_length and N (params.cxx:214-217).
        params.repeats = params.buf_length // (2 * params.N)

    if ns.time is not None:
        params.integration_time = parse_time(ns.time)
        if params.integration_time <= 0:
            raise RPFexception(
                "Could not parse the value given to --time. "
                "Expecting format [WdXhYm]Z[s]. Exiting.",
                ReturnValue.InvalidArgument)
        params.integration_time_isSet = True

    if ns.time is not None and ns.repeats is not None:
        raise RPFexception(
            "Options -n and -t are mutually exclusive. Exiting.",
            ReturnValue.InvalidArgument)

    if ns.strict_time and ns.time is None:
        print("Warning: option --strict-time has no effect without --time.", file=err)
        params.strict_time = False

    if ns.buffer_size is not None:
        params.buf_length_isSet = True

    params.baseline = ns.baseline is not None
    if params.baseline:
        params.baseline_file = ns.baseline

    params.window = ns.window is not None
    if params.window:
        params.window_file = ns.window

    params.matrixMode = ns.matrix is not None
    if params.matrixMode:
        params.matrix_file = ns.matrix
        params.bin_file = params.matrix_file + ".bin"
        params.meta_file = params.matrix_file + ".met"

    if ns.elapsed is not None:
        params.session_duration = parse_time(ns.elapsed)
        if params.session_duration <= 0:
            raise RPFexception(
                "Could not parse the value given to --time. "
                "Expecting format [WdXhYm]Z[s]. Exiting.",
                ReturnValue.InvalidArgument)
        params.session_duration_isSet = True

    # Extensions.
    params.source = ns.source
    params.window_function = ns.window_function.lower()
    params.welch_overlap = ns.welch_overlap
    params.pfb_taps = ns.pfb_taps
    params.multitaper = ns.multitaper
    params.time_bandwidth = ns.time_bandwidth
    params.sk_file = ns.sk_file
    params.sk_excise = ns.sk_excise
    if ns.streams < 1:
        raise RPFexception(
            f"--streams must be at least 1 (got {ns.streams}). Exiting.",
            ReturnValue.InvalidArgument)
    params.streams = ns.streams
    params.shard_transform = ns.shard_transform
    params.frames_per_step = ns.frames_per_step
    params.fft_backend = ns.fft_backend
    params.profile_dir = ns.profile
    params.precision = ns.precision
    params.stats_json = ns.stats_json
    params.record_file = ns.record
    params.stitch_file = ns.stitch_out
    if params.window and params.window_function:
        raise RPFexception(
            "Options --window and --window-function are mutually exclusive. Exiting.",
            ReturnValue.InvalidArgument)
    if not (0.0 <= params.welch_overlap < 100.0):
        raise RPFexception(
            "--welch-overlap must be in [0, 100). Exiting.",
            ReturnValue.InvalidArgument)
    if params.pfb_taps:
        if not (2 <= params.pfb_taps <= 32):
            raise RPFexception(
                "--pfb-taps must be in [2, 32] (0 disables). Exiting.",
                ReturnValue.InvalidArgument)
        conflicts = []
        if params.window:
            conflicts.append("--window (the PFB prototype replaces the "
                             "window; use --window-function to shape it)")
        if params.welch_overlap > 0.0:
            conflicts.append("--welch-overlap")
        if params.shard_transform:
            conflicts.append("--shard-transform")
        if conflicts:
            raise RPFexception(
                "--pfb-taps cannot be combined with "
                + ", ".join(conflicts) + ". Exiting.",
                ReturnValue.InvalidArgument)
        ignored = []
        if params.fft_backend != "auto":
            ignored.append("--fft-backend")
        if params.precision != "highest":
            ignored.append("--precision")
        if ignored:
            verb = "is" if len(ignored) == 1 else "are"
            print("Warning: the polyphase filterbank uses its own batched "
                  f"FFT step; {' and '.join(ignored)} {verb} ignored "
                  "with --pfb-taps.", file=err)
    if params.multitaper:
        if not (1 <= params.multitaper <= 32):
            raise RPFexception(
                "--multitaper must be in [1, 32] (0 disables). Exiting.",
                ReturnValue.InvalidArgument)
        if params.multitaper > params.N:
            raise RPFexception(
                f"--multitaper K ({params.multitaper}) cannot exceed the "
                f"number of bins ({params.N}). Exiting.",
                ReturnValue.InvalidArgument)
        if not (1.0 <= params.time_bandwidth <= 64.0):
            raise RPFexception(
                "--time-bandwidth must be in [1, 64]. Exiting.",
                ReturnValue.InvalidArgument)
        if params.time_bandwidth >= params.N / 2.0:
            # scipy's DPSS solver requires NW < N/2 (it would raise an
            # untyped ValueError deep in the session otherwise).
            raise RPFexception(
                f"--time-bandwidth ({params.time_bandwidth:g}) must be "
                f"below half the number of bins ({params.N}/2). Exiting.",
                ReturnValue.InvalidArgument)
        conflicts = []
        if params.window:
            conflicts.append("--window (DPSS tapers replace the window)")
        if params.window_function:
            conflicts.append("--window-function")
        if params.welch_overlap > 0.0:
            conflicts.append("--welch-overlap")
        if params.pfb_taps:
            conflicts.append("--pfb-taps")
        if params.shard_transform:
            conflicts.append("--shard-transform")
        if conflicts:
            raise RPFexception(
                "--multitaper cannot be combined with "
                + ", ".join(conflicts) + ". Exiting.",
                ReturnValue.InvalidArgument)
        if params.multitaper > 2 * params.time_bandwidth - 1:
            print(f"Warning: only the first ~2NW-1 = "
                  f"{int(2 * params.time_bandwidth - 1)} DPSS tapers are "
                  "well concentrated; extra tapers raise leakage. Consider "
                  "a larger --time-bandwidth.", file=err)
        if params.fft_backend != "auto":
            print("Warning: the multitaper estimator uses its own batched "
                  "transform step; --fft-backend is ignored with "
                  "--multitaper.", file=err)
    elif params.time_bandwidth != 4.0:
        print("Warning: --time-bandwidth has no effect without "
              "--multitaper.", file=err)
    if params.sk_excise < 0.0:
        raise RPFexception(
            "--sk-excise must be positive (null standard deviations). "
            "Exiting.", ReturnValue.InvalidArgument)
    if params.sk_file or params.sk_excise > 0.0:
        flag = "--sk-file" if params.sk_file else "--sk-excise"
        conflicts = []
        if params.welch_overlap > 0.0:
            # Overlapped frames are correlated; the SK null distribution
            # assumes independent spectra.
            conflicts.append("--welch-overlap")
        if params.pfb_taps:
            conflicts.append("--pfb-taps")
        if params.multitaper:
            conflicts.append("--multitaper")
        if params.shard_transform:
            conflicts.append("--shard-transform")
        if conflicts:
            raise RPFexception(
                f"{flag} cannot be combined with "
                + ", ".join(conflicts) + ". Exiting.",
                ReturnValue.InvalidArgument)
        if params.fft_backend in ("pallas", "hybrid", "fft4"):
            # (fourstep4m/fourstep4x DO expose per-frame spectra —
            # dft_power_fourstep4m/4x — and are honored verbatim by
            # the SK family's _sk_mode, so no warning for those.)
            print(f"Warning: {flag} needs per-frame spectra for the "
                  "second moment, which the fused "
                  f"'{params.fft_backend}' path does not expose; using "
                  "the auto per-frame transform instead.", file=err)
        if params.precision != "highest":
            print(f"Warning: {flag}: --precision is ignored (the SK "
                  "step runs the per-frame transform at its default "
                  "precision).", file=err)
    if params.shard_transform and params.N & (params.N - 1):
        raise RPFexception(
            "--shard-transform requires a power-of-two number of bins. "
            "Exiting.", ReturnValue.InvalidArgument)
    if params.shard_transform and params.fft_backend != "auto":
        print("Warning: --shard-transform uses the distributed four-step "
              "transform; --fft-backend is ignored.", file=err)

    return params
