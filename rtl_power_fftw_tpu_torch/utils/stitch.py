"""Stitch overlapping frequency-hop spectra into one wideband spectrum.

The reference emits each hop's spectrum raw and leaves combining the
overlap regions to the user ("the rest is up to you ... with a plotting
utility", doc/rtl_power_fftw.1.md:114-120, example gnuplot pipelines
:159-170).  This module is the framework's built-in answer:

* ``merge_spectra`` — align every hop to the common bin grid (all hops
  share the spacing Δ = rate/N; centers may sit off-grid by < Δ/2 and
  snap to the nearest bin) and average the overlap regions in LINEAR
  power (dB values are delogged, averaged, relogged — averaging dB
  directly would bias overlaps low);
* ``parse_text`` — read the reference-format text output (``#``
  comments, one blank line between spectra, two between measurement
  sets) back into arrays, so stitching composes with existing captures;
* CLI: ``python -m rtl_power_fftw_tpu.stitch [file|-]`` writes the
  stitched two-column spectrum (one block per measurement set).

Usable both on live ScanRunner results (models/scan.py ``stitch="merge"``)
and on saved output files.
"""

from __future__ import annotations

import sys
from typing import IO, List, Optional, Sequence, Tuple

import numpy as np

Spectrum = Tuple[np.ndarray, np.ndarray]


def merge_spectra(spectra: Sequence[Spectrum], db: bool = True,
                  grid_step: Optional[float] = None) -> Spectrum:
    """Combine overlapping spectra into one (freqs, values) pair.

    ``spectra``: iterable of (freqs, values), each sorted ascending with
    uniform spacing (every hop of one scan shares rate/N). Overlapping
    bins are averaged in linear power; ``db=False`` treats the values as
    already linear (``--linear`` output).
    """
    spectra = [(np.atleast_1d(np.asarray(f, np.float64)),
                np.atleast_1d(np.asarray(v, np.float64)))
               for f, v in spectra if len(np.atleast_1d(f))]
    if not spectra:
        raise ValueError("no spectra to stitch")
    if grid_step is None:
        # Infer the common bin width from each spectrum's full span —
        # (last − first)/(n − 1) averages out the per-line rounding of
        # text output (6-7 significant digits at ~100 MHz rounds each
        # frequency by ~100 Hz; a median of adjacent diffs would inherit
        # that error and drift bin indices across a wide scan).
        steps = [(float(f[-1]) - float(f[0])) / (len(f) - 1)
                 for f, _ in spectra if len(f) > 1]
        if not steps:
            grid_step = 1.0
        else:
            grid_step = float(np.median(steps))
            if grid_step <= 0:
                raise ValueError("spectra must be sorted ascending")
    f0 = min(float(f[0]) for f, _ in spectra)

    all_idx = np.concatenate(
        [np.round((f - f0) / grid_step).astype(np.int64) for f, _ in spectra])
    all_lin = np.concatenate(
        [10.0 ** (v / 10.0) if db else v for _, v in spectra])
    keys, inverse = np.unique(all_idx, return_inverse=True)
    mean = (np.bincount(inverse, weights=all_lin)
            / np.bincount(inverse))
    freqs = f0 + keys * grid_step
    if db:
        with np.errstate(divide="ignore"):
            mean = 10.0 * np.log10(mean)
    return freqs, mean


def parse_text(stream: IO[str]) -> List[List[Spectrum]]:
    """Parse reference-format text output into measurement sets.

    Returns a list of measurement sets, each a list of (freqs, values)
    spectra — the inverse of output/text.py's structure (one blank line
    separates spectra, a second separates sets; ``#`` lines are headers,
    acquisition.cxx:367-432).
    """
    sets: List[List[Spectrum]] = []
    cur_set: List[Spectrum] = []
    cur_f: List[float] = []
    cur_v: List[float] = []
    blank_run = 0

    def close_spectrum() -> None:
        nonlocal cur_f, cur_v
        if cur_f:
            cur_set.append((np.array(cur_f), np.array(cur_v)))
            cur_f, cur_v = [], []

    def close_set() -> None:
        nonlocal cur_set
        close_spectrum()
        if cur_set:
            sets.append(cur_set)
            cur_set = []

    for line in stream:
        s = line.strip()
        if not s:
            blank_run += 1
            if blank_run == 1:
                close_spectrum()
            elif blank_run == 2:
                close_set()
            continue
        blank_run = 0
        if s.startswith("#"):
            continue
        parts = s.split()
        # last-value-per-line wins for power, like the AuxData reader
        # (acquisition.cxx:44-56) — the output format has exactly two
        # columns, but be liberal in what we accept.
        cur_f.append(float(parts[0]))
        cur_v.append(float(parts[-1]))
    close_set()
    return sets


def main(argv: Optional[Sequence[str]] = None,
         stdout: Optional[IO[str]] = None,
         stderr: Optional[IO[str]] = None) -> int:
    import argparse

    out = stdout if stdout is not None else sys.stdout
    err = stderr if stderr is not None else sys.stderr
    ap = argparse.ArgumentParser(
        prog="rtl_power_fftw_tpu.stitch",
        description="Stitch overlapping frequency-hop spectra from "
                    "rtl_power_fftw_tpu/rtl_power_fftw text output into "
                    "one wideband spectrum per measurement set.")
    ap.add_argument("input", nargs="?", default="-",
                    help="input file ('-' = stdin)")
    ap.add_argument("--linear", action="store_true",
                    help="values are linear power (from --linear output), "
                         "not dB")
    args = ap.parse_args(argv)

    if args.input == "-":
        sets = parse_text(sys.stdin)
    else:
        with open(args.input) as fh:
            sets = parse_text(fh)
    if not sets:
        print("stitch: no spectra found in input", file=err)
        return 1
    try:
        for si, spectra in enumerate(sets):
            freqs, vals = merge_spectra(spectra, db=not args.linear)
            out.write(f"# stitched spectrum: measurement set {si + 1}, "
                      f"{len(spectra)} hops, {len(freqs)} bins\n")
            for f, v in zip(freqs, vals):
                out.write(f"{f:.10g} {v:.6g}\n")
            out.write("\n")
    except BrokenPipeError:   # downstream (head, plot) closed the pipe
        return 0
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via -m
    raise SystemExit(main())
