"""Smoke run of rtl_power_fftw_tpu_torch on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):

1. machine: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles every CUDA source in ``ops/kernels/csrc`` with nvcc,
   one process per source, started together;
3. K1 (``fused_psd``) against its plain PyTorch version on the card, at
   the shapes the main path gives it and at N = 256, 2048, 16384, with a
   masked ``n_valid`` case, against a float64 transcription of
   ``tests/golden.py:golden_accumulate``, and under 35 dB tones against
   the scipy float32 FFT (the FFTW-class error budget);
4. K2 (``fused_psd`` with a window) against its plain version and the
   windowed float64 golden (Hann and Blackman, N = 256, 2048, 8192, one
   masked case, run twice for determinism), and its admission yard: 60
   seeds of 35 dB tones with a Hann window at N = 2048, 8192 (BASELINE
   config 2's size) and 16384 against the scipy float32 FFT of the same
   windowed input, with the per-seed p99 of the ratio;
5. K3 (``fused_psd_fast``, ``--precision high``) against its plain
   version and the golden, unwindowed, Hann and Blackman, at the step
   the ``--precision high`` drive gives it, and under 12 seeds of
   35 dB tones against the JAX fast scheme's own error on the same
   realizations;
6. K4 (``fused_psd_streams``, the ``--streams`` step) against its plain
   version, the per-stream float64 golden and K1 (or K2) run on each
   stream's own frames and count, at BASELINE config 5's step (16
   streams, 2048 bins, 256 frames), at 4 streams of 8192 bins with Hann,
   at 3 streams of 256 bins with counts (F, 0, 5) and at the windowed
   streams scan drive's own step (4 streams, 256 bins, Hann, the frames
   per step its acquisition picks, 32 valid frames per stream), each run
   twice for determinism, rows of zero count exactly 0; then 12 seeds of
   35 dB tones at config 5's step, the combined sum against the scipy
   float32 FFT (the FFTW-class budget);
7. times of K1, K2, K3, K4 and their plain versions with CUDA events;
8. end to end through ``cli.main`` in-process: the canonical 2048-bin
   20,000-spectrum drive (K1), a hopping matrix drive with a dead hop
   (K1), BASELINE config 2 (8192 bins, Hann, 50% Welch overlap; K2)
   against a float64 Welch transcription of the recorded stream, fed
   back to itself with ``-B``, a ``--precision high`` drive with a
   Blackman window file (K3), BASELINE config 5 (``--streams 16``; K4)
   against the float64 golden of the 16 recorded streams, and a windowed
   hopping matrix drive over 4 streams with a dead hop (K4 windowed).
   Every launch counter is reset just before each drive; the drive's
   kernel must have launched and no plain version may have run.

Stdout ends with a ``{"kernels": [...]}`` line and then the result line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CSRC = "rtl_power_fftw_tpu_torch/ops/kernels/csrc/"
TPU_KERNEL = "rtl_power_fftw_tpu/ops/kernels/fused_psd.py:"
UNIFORM_RTOL = 1e-5
GOLDEN_RTOL = 1e-5
# K3 against its plain version: the same split, terms and bf16 products;
# only the order of f32 sums differs (tensor-core accumulation against
# cuBLAS f32), so a per-bin relative bound far inside the relaxed tier.
FAST_VS_PLAIN_RTOL = 2e-5
# The relaxed tier (tests/test_kernels.py:144) and the JAX fast kernel's
# documented floors (fused_psd.py:300-302): ~2e-6 uniform, ~4e-5 under a
# 35 dB tone.
RELAXED_RTOL = 1e-4
FAST_FLOOR_UNIFORM = 2e-6
FAST_FLOOR_TONE = 4e-5
# The drives' synthetic source: a 35 dB tone at 100.2 MHz, 2 MS/s.
SOURCE = "synthetic:tone=100.2M/35,noise=6,seed=1"
RATE = 2_000_000
# BASELINE config 5 (bench_configs.py:159-198): 16 streams.
C5_STREAMS = 16
# The windowed hopping matrix drive over 4 streams (K4 windowed), less its
# "-m <path>".
STREAMS_SCAN_ARGV = ["-f", "100M:106M", "-n", "32", "-b", "256",
                     "--streams", "4", "--window-function", "hann", "-q",
                     "--source",
                     "synthetic:tone=104.9M/40,noise=5,seed=2,dead=103M"]


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def max_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max())


def golden_partial(raw: np.ndarray, n_valid: int,
                   window=None) -> np.ndarray:
    """float64 transcription of tests/golden.py:golden_accumulate over the
    first ``n_valid`` frames, returned in unshifted bin order (the
    reference's (-1)^n flip pre-shifts; ifftshift undoes it)."""
    N = raw.shape[1] // 2
    flip = np.where(np.arange(N) % 2 == 0, 1.0, -1.0)
    if window is not None:
        flip = flip * np.asarray(window, np.float64)
    pwr = np.zeros(N, np.float64)
    for lo in range(0, n_valid, 256):
        part = raw[lo:min(lo + 256, n_valid)].astype(np.float64)
        z = (part[:, 0::2] - 127.0) + 1j * (part[:, 1::2] - 127.0)
        X = np.fft.fft(z * flip, axis=1)
        pwr += (X.real ** 2 + X.imag ** 2).sum(axis=0)
    return np.fft.ifftshift(pwr)


def golden_finalize_linear(pwr_shifted: np.ndarray, repeats: int,
                           rate: int) -> np.ndarray:
    """tests/golden.py:golden_finalize with linear=True, vectorized."""
    p = pwr_shifted.copy()
    N = len(p)
    p[N // 2] = (p[N // 2 - 1] + p[N // 2 + 1]) / 2.0
    return p / repeats / N / rate


def tone_frames(N: int, F: int, seed: int) -> np.ndarray:
    """A 35 dB tone (amplitude 100 over unit noise) at a random frequency
    and phase, as in tests/test_numerics.py."""
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(0.05, 0.45)
    ph = rng.uniform(0, 2 * np.pi)
    t = np.arange(F * N)
    x = 100.0 * np.exp(1j * (2 * np.pi * f0 * t + ph)) + (
        rng.standard_normal(F * N) + 1j * rng.standard_normal(F * N))
    re8 = np.clip(np.round(x.real + 127), 0, 255).astype(np.uint8)
    im8 = np.clip(np.round(x.imag + 127), 0, 255).astype(np.uint8)
    return np.stack([re8, im8], axis=-1).reshape(F, 2 * N)


def scipy_f32_class(raw: np.ndarray, window=None) -> np.ndarray:
    """The FFTW-class yardstick: scipy's float32 FFT of the same (windowed)
    input, |X|^2 summed over frames in float64, unshifted bins."""
    import scipy.fft
    z = ((raw[:, 0::2].astype(np.float64) - 127.0)
         + 1j * (raw[:, 1::2].astype(np.float64) - 127.0))
    if window is not None:
        z = z * np.asarray(window, np.float64)
    Xc = scipy.fft.fft(z.astype(np.complex64), axis=1)
    return (Xc.real.astype(np.float64) ** 2
            + Xc.imag.astype(np.float64) ** 2).sum(0)


def jax_fast_n1(N: int) -> int:
    """N1 of the JAX fast kernel's split (fused_psd.py:_split): N2 the
    larger of 128 and floor(sqrt(N)) as a power of two."""
    return N // max(128, 1 << ((N.bit_length() - 1) >> 1))


def last_digit_unit(text: str) -> float:
    """One unit in the last printed digit of a decimal number."""
    mant, _, exp = text.lower().partition("e")
    return 10.0 ** (int(exp or 0) - len(mant.partition(".")[2]))


def spectrum(out: str):
    rows = [line.split() for line in out.splitlines()
            if line and not line.startswith("#")]
    return (np.array([float(f) for f, _ in rows]),
            np.array([float(v) for _, v in rows]), [v for _, v in rows])


def event_times_us(fn, iters: int = 60, warmup: int = 10) -> float:
    """Median device time of one call, from CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return 1000.0 * statistics.median(s.elapsed_time(e) for s, e in pairs)


def run_cli(argv, main):
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def phase_k2(dev, rng, fp, adapt_batch, make_window):
    """K2 against its plain version and the windowed golden, then its
    60-seed tone yard. Returns K2's max abs error at N=2048 F=4096."""
    cases = [  # (label, N, frames_per_step, n_valid or None, window)
        ("N=256 hann", 256, 1024, None, "hann"),
        ("N=2048 F=4096 blackman", 2048, 4096, None, "blackman"),
        ("N=2048 hann masked", 2048, 4096, 1000, "hann"),
        ("N=8192 hann (config 2 step)", 8192, 104, None, "hann"),
        ("N=8192 F=1024 blackman", 8192, 1024, None, "blackman"),
    ]
    fp.COUNTS.reset()
    max_abs = None
    for label, N, fps, n_valid, wname in cases:
        F, chunk = adapt_batch(fps)
        nv = F if n_valid is None else n_valid
        w_np = make_window(wname, N)
        w = torch.from_numpy(w_np).to(dev)
        raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        got = fp.fused_psd(raw, nv, chunk, w)
        again = fp.fused_psd(raw, nv, chunk, w)
        want = fp.fused_psd_reference(raw, nv, chunk, w)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"K2 {label}: not deterministic")
        got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
        gold = golden_partial(raw_np, nv, w_np)
        err_plain, err_gold = max_rel(got_np, want_np), max_rel(got_np, gold)
        print(f"K2 {label} (N={N} F={F} chunk={chunk} n_valid={nv}): max "
              f"rel vs plain {err_plain:.3e}, vs float64 golden "
              f"{err_gold:.3e} (plain vs golden "
              f"{max_rel(want_np, gold):.3e})")
        check(np.all(np.isfinite(got_np)), f"K2 {label}: non-finite output")
        check(err_plain <= UNIFORM_RTOL, f"K2 {label}: {err_plain} vs plain")
        check(err_gold <= GOLDEN_RTOL, f"K2 {label}: {err_gold} vs golden")
        if label.startswith("N=2048 F=4096"):
            max_abs = float(np.abs(got_np.astype(np.float64) - want_np).max())
    check(fp.COUNTS.kernel_windowed == 2 * len(cases)
          and fp.COUNTS.kernel == 0 and fp.COUNTS.plain == 0,
          f"K2 launch counter did not move as expected: {vars(fp.COUNTS)}")

    # Admission yard (ROADMAP): 60 seeds, Hann, 35 dB tones, median <=
    # 1.5x and max <= 3x the scipy float32 class, per-seed p99 printed.
    for N, F in ((2048, 64), (8192, 64), (16384, 32)):
        w_np = make_window("hann", N)
        w = torch.from_numpy(w_np).to(dev)
        ours, cls, plain = [], [], []
        for seed in range(60):
            raw_np = tone_frames(N, F, 3000 + seed)
            gold = golden_partial(raw_np, F, w_np)
            raw = torch.from_numpy(raw_np).to(dev)
            ours.append(max_rel(fp.fused_psd(raw, F, F, w).cpu().numpy(),
                                gold))
            plain.append(max_rel(fp.fused_psd_reference(raw, F, F, w)
                                 .cpu().numpy(), gold))
            cls.append(max_rel(scipy_f32_class(raw_np, w_np), gold))
        e, c = np.asarray(ours), np.asarray(cls)
        r = e / c
        med_r, max_r = np.median(e) / np.median(c), e.max() / c.max()
        print(f"K2 yard N={N} F={F} hann, 60 seeds of 35 dB tones: max rel "
              f"median {np.median(e):.3e} / max {e.max():.3e}; scipy f32 "
              f"{np.median(c):.3e} / {c.max():.3e}; plain (cuFFT) "
              f"{np.median(plain):.3e} / {max(plain):.3e}; ratio median "
              f"{med_r:.2f}x (<= 1.5), max {max_r:.2f}x (<= 3), per-seed "
              f"p99 {np.quantile(r, 0.99):.2f}x, per-seed max {r.max():.2f}x")
        check(med_r <= 1.5 and max_r <= 3.0,
              f"K2 yard N={N}: above the FFTW-class budget")
    return max_abs


def phase_k3(dev, rng, ff, adapt_batch, make_window):
    """K3 against its plain version, the golden and the JAX fast scheme.
    Returns K3's max abs error at N=2048 F=4096."""
    ff.COUNTS.reset()
    max_abs = None
    cases = [  # (label, N, frames_per_step, n_valid or None, window, bound)
        ("N=2048 F=4096", 2048, 4096, None, None, 2 * FAST_FLOOR_UNIFORM),
        ("N=2048 F=4096 hann", 2048, 4096, None, "hann",
         2 * FAST_FLOOR_UNIFORM),
        ("N=256 masked", 256, 1024, 700, None, RELAXED_RTOL),
        ("precision-high drive step", 2048, 400, None, "blackman",
         RELAXED_RTOL),
        ("N=8192 F=1024 hann", 8192, 1024, None, "hann", RELAXED_RTOL),
        ("N=16384 F=64 blackman", 16384, 64, None, "blackman", RELAXED_RTOL),
    ]
    for label, N, fps, n_valid, wname, bound in cases:
        F, chunk = adapt_batch(fps)
        nv = F if n_valid is None else n_valid
        w_np = None if wname is None else make_window(wname, N)
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        got = ff.fused_psd_fast(raw, nv, chunk, w)
        again = ff.fused_psd_fast(raw, nv, chunk, w)
        want = ff.fused_psd_fast_reference(raw, nv, chunk, w)
        jax_scheme = ff.fused_psd_fast_reference(raw, nv, chunk, w,
                                                 n1=jax_fast_n1(N))
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"K3 {label}: not deterministic")
        got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
        gold = golden_partial(raw_np, nv, w_np)
        err_plain, err_gold = max_rel(got_np, want_np), max_rel(got_np, gold)
        print(f"K3 {label} (N={N} F={F} chunk={chunk} n_valid={nv} window="
              f"{wname}; N1 x N2 = {ff.fast_split(N)}): max rel vs plain "
              f"{err_plain:.3e} (<= {FAST_VS_PLAIN_RTOL:g}), vs float64 "
              f"golden {err_gold:.3e} (<= {bound:g}); plain vs golden "
              f"{max_rel(want_np, gold):.3e}; JAX split "
              f"N1={jax_fast_n1(N)} vs golden "
              f"{max_rel(jax_scheme.cpu().numpy(), gold):.3e}")
        check(np.all(np.isfinite(got_np)), f"K3 {label}: non-finite output")
        check(err_plain <= FAST_VS_PLAIN_RTOL, f"K3 {label}: vs plain")
        check(err_gold <= bound, f"K3 {label}: vs golden")
        if label == "N=2048 F=4096":
            max_abs = float(np.abs(got_np.astype(np.float64) - want_np).max())
    check(ff.COUNTS.kernel == 2 * len(cases) and ff.COUNTS.plain == 0,
          f"K3 launch counter did not move as expected: {vars(ff.COUNTS)}")

    # Under 35 dB tones: within 2x of the JAX fast scheme's own error on
    # the same realizations (its split, run by the plain transcription).
    N, F = 2048, 64
    ours, plain, jax_s = [], [], []
    for seed in range(12):
        raw_np = tone_frames(N, F, 500 + seed)
        gold = golden_partial(raw_np, F)
        raw = torch.from_numpy(raw_np).to(dev)
        ours.append(max_rel(ff.fused_psd_fast(raw, F, 64).cpu().numpy(),
                            gold))
        plain.append(max_rel(ff.fused_psd_fast_reference(raw, F, 64)
                             .cpu().numpy(), gold))
        jax_s.append(max_rel(ff.fused_psd_fast_reference(
            raw, F, 64, n1=jax_fast_n1(N)).cpu().numpy(), gold))
    med_r = statistics.median(ours) / statistics.median(jax_s)
    max_r = max(ours) / max(jax_s)
    print(f"K3 35 dB tone N={N} F={F}, 12 seeds: max rel median "
          f"{statistics.median(ours):.3e} / max {max(ours):.3e}; plain "
          f"{statistics.median(plain):.3e} / {max(plain):.3e}; JAX fast "
          f"scheme (N1={jax_fast_n1(N)}) {statistics.median(jax_s):.3e} / "
          f"{max(jax_s):.3e}; ratios median {med_r:.2f}x, max "
          f"{max_r:.2f}x (<= 2); documented floor {FAST_FLOOR_TONE:g}")
    check(med_r <= 2.0 and max_r <= 2.0,
          "K3 tone error above 2x the JAX fast scheme's")
    return max_abs


def streams_scan_plan(dev) -> dict:
    """The step the streams scan drive runs: its options parsed as the CLI
    parses them, and the shape the multi-stream acquisition builds from
    them (a stand-in source per stream; only their number is read)."""
    from rtl_power_fftw_tpu.config import parse_args
    from rtl_power_fftw_tpu_torch.parallel.multistream import (
        MultiStreamAcquisition)
    params = parse_args(STREAMS_SCAN_ARGV + ["-m", "unused"])
    acq = MultiStreamAcquisition(params, [None] * params.streams, [dev],
                                 frames_per_step=params.frames_per_step)
    return {"S": acq.S, "N": params.N, "F": acq.step.F,
            "chunk": acq.step._chunk, "repeats": params.repeats}


def phase_k4(dev, rng, fp, adapt_batch, make_window, ShardedPsdStep):
    """K4 against its plain version, the per-stream golden and K1/K2 on
    each stream alone, then 35 dB tones at config 5's step. Returns K4's
    max abs error at config 5's step, unwindowed and with Hann."""
    scan = streams_scan_plan(dev)
    cases = [  # (label, S, N, frames_per_step, counts or None for F, window)
        ("config 5 step", C5_STREAMS, 2048, 256, None, None),
        ("config 5 step hann", C5_STREAMS, 2048, 256, None, "hann"),
        ("S=4 N=8192 hann", 4, 8192, 64, None, "hann"),
        ("S=3 N=256 uneven", 3, 256, 64, lambda F: [F, 0, 5], None),
        ("streams scan drive step", scan["S"], scan["N"], scan["F"],
         lambda F: [scan["repeats"]] * scan["S"], "hann"),
    ]
    max_abs = {}
    for label, S, N, fps, counts, wname in cases:
        F, chunk = adapt_batch(fps)
        if label.startswith("streams scan"):
            check((F, chunk) == (scan["F"], scan["chunk"]),
                  f"K4 {label}: step {F}/{chunk} is not the drive's {scan}")
        nv = np.array(counts(F) if counts else [F] * S, np.int32)
        w_np = None if wname is None else make_window(wname, N)
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        raw_np = rng.integers(0, 256, (S, F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        nv_dev = torch.from_numpy(nv).to(dev)
        fp.COUNTS.reset()
        got = fp.fused_psd_streams(raw, nv_dev, chunk, w)
        again = fp.fused_psd_streams(raw, nv_dev, chunk, w)
        want = fp.fused_psd_streams_reference(raw, nv_dev, chunk, w)
        alone = torch.stack([fp.fused_psd(raw[s], int(nv[s]), chunk, w)
                             for s in range(S)])
        torch.cuda.synchronize()
        k4 = ("kernel_streams" if w is None else "kernel_streams_windowed")
        check(getattr(fp.COUNTS, k4) == 2 and fp.COUNTS.plain == 0,
              f"K4 {label}: launch counter {vars(fp.COUNTS)}")
        check(torch.equal(got, again), f"K4 {label}: not deterministic")
        got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
        alone_np = alone.cpu().numpy()
        check(np.all(np.isfinite(got_np)), f"K4 {label}: non-finite output")
        check(not got_np[nv == 0].any(), f"K4 {label}: a zero-count row "
              "is not exactly 0")
        errs = []
        for s in range(S):
            gold = golden_partial(raw_np[s], int(nv[s]), w_np)
            errs.append((max_rel(got_np[s], want_np[s]),
                         max_rel(got_np[s], gold),
                         max_rel(got_np[s], alone_np[s])))
        e_plain, e_gold, e_alone = (max(e[i] for e in errs) for i in range(3))
        print(f"K4 {label} (S={S} N={N} F={F} chunk={chunk} frames/block "
              f"{fp.frames_per_block(S * F, chunk)} n_valid="
              f"{nv.tolist() if counts else F}): max rel per stream vs plain "
              f"{e_plain:.3e}, vs float64 golden {e_gold:.3e}, vs "
              f"{'K1' if w is None else 'K2'} on the stream alone "
              f"{e_alone:.3e}")
        check(e_plain <= UNIFORM_RTOL, f"K4 {label}: {e_plain} vs plain")
        check(e_gold <= GOLDEN_RTOL, f"K4 {label}: {e_gold} vs golden")
        check(e_alone <= UNIFORM_RTOL, f"K4 {label}: {e_alone} vs K1/K2")
        if label.startswith("config 5 step"):
            max_abs[wname] = float(np.abs(got_np.astype(np.float64)
                                          - want_np).max())

    # Under 35 dB tones: the combined sum of config 5's step within the
    # FFTW-class budget, median <= 1.5x and max <= 3x the scipy float32
    # FFT's error.
    S, N, F = C5_STREAMS, 2048, 256
    step = ShardedPsdStep([dev], N, F, streams=S)
    full = np.full(S, F, np.int32)
    ours, plain, yard = [], [], []
    for seed in range(12):
        raw_np = tone_frames(N, S * F, 700 + seed)
        gold = golden_partial(raw_np, S * F)
        _, combined = step(raw_np.reshape(S, F, 2 * N), full)
        ours.append(max_rel(combined.cpu().numpy(), gold))
        raw = torch.from_numpy(raw_np.reshape(S, F, 2 * N)).to(dev)
        plain.append(max_rel(fp.fused_psd_streams_reference(
            raw, torch.from_numpy(full).to(dev), 64).sum(0).cpu().numpy(),
            gold))
        yard.append(max_rel(scipy_f32_class(raw_np), gold))
    med_r = statistics.median(ours) / statistics.median(yard)
    max_r = max(ours) / max(yard)
    print(f"K4 35 dB tone, config 5 step (S={S} N={N} F={F}), combined, "
          f"12 seeds: max rel median {statistics.median(ours):.3e} / max "
          f"{max(ours):.3e}; scipy f32 {statistics.median(yard):.3e} / "
          f"{max(yard):.3e}; plain (cuFFT) {statistics.median(plain):.3e} / "
          f"{max(plain):.3e}; ratios median {med_r:.2f}x (<= 1.5), max "
          f"{max_r:.2f}x (<= 3)")
    check(med_r <= 1.5 and max_r <= 3.0,
          "K4 tone error above the FFTW-class budget")
    return max_abs


def phase_times(dev, rng, fp, ff, adapt_batch, make_window, card):
    """Median CUDA-event times (us/step): kernel, plain, kernel again."""
    times = {}
    shapes = [("K1", 2048, 4096, None), ("K1", 2048, 400, None),
              ("K2", 2048, 4096, "hann"), ("K2", 8192, 1024, "hann"),
              ("K2", 8192, 104, "hann"), ("K3", 2048, 4096, None),
              ("K3", 2048, 4096, "hann"), ("K3", 8192, 1024, None),
              ("K3", 2048, 400, "blackman"), ("K4", 2048, 256, None),
              ("K4", 2048, 256, "hann")]
    for name, N, fps, wname in shapes:
        F, chunk = adapt_batch(fps)
        S = C5_STREAMS if name == "K4" else 1
        raw = torch.from_numpy(rng.integers(
            0, 256, (S, F, 2 * N) if name == "K4" else (F, 2 * N),
            dtype=np.uint8)).to(dev)
        w = (None if wname is None
             else torch.from_numpy(make_window(wname, N)).to(dev))
        nv = F
        if name == "K4":
            kernel, plain = fp.fused_psd_streams, fp.fused_psd_streams_reference
            nv = torch.full((S,), F, dtype=torch.int32, device=dev)
        elif name == "K3":
            kernel, plain = ff.fused_psd_fast, ff.fused_psd_fast_reference
        else:
            kernel, plain = fp.fused_psd, fp.fused_psd_reference
        k_us = event_times_us(lambda: kernel(raw, nv, chunk, w))
        p_us = event_times_us(lambda: plain(raw, nv, chunk, w))
        k_us2 = event_times_us(lambda: kernel(raw, nv, chunk, w))
        times[(name, N, F, wname)] = (k_us, p_us, k_us2)
        frames = S * F
        print(f"time {name} N={N} F={F}{f' S={S}' if S > 1 else ''} window="
              f"{wname} on {card}: kernel {k_us:.1f} us/step "
              f"({frames * N / k_us / 1e3:.2f} GS/s; repeat {k_us2:.1f} us), "
              f"plain {p_us:.1f} us/step "
              f"({frames * N / p_us / 1e3:.2f} GS/s)")
    return times


def reset_counts(fp, ff) -> None:
    fp.COUNTS.reset()
    ff.COUNTS.reset()


def launch_counts(fp, ff) -> dict:
    """Every launch counter by the kernel (or plain version) it counts."""
    return {"K1": fp.COUNTS.kernel, "K2": fp.COUNTS.kernel_windowed,
            "K3": ff.COUNTS.kernel, "K4": fp.COUNTS.kernel_streams,
            "K4 windowed": fp.COUNTS.kernel_streams_windowed,
            "plain": fp.COUNTS.plain, "plain_fast": ff.COUNTS.plain}


def check_only(counts: dict, kernel: str, label: str) -> None:
    others = {k: v for k, v in counts.items() if k != kernel and v}
    check(counts[kernel] > 0 and not others,
          f"{label} did not run through {kernel} alone: {counts}")


def drive(label, argv, cli, fp, ff, kernel, N, golden_fn, rtol, streams=1):
    """One drive through ``cli.main`` with every launch counter reset just
    before it: exit 0, the transform path of ``kernel`` (over ``streams``
    streams), a finite N-bin linear spectrum peaking at 100.2 MHz within
    ``rtol`` of ``golden_fn()``, and launches of ``kernel`` alone. Returns
    its launches."""
    reset_counts(fp, ff)
    rc, out, err, wall = run_cli(argv, cli.main)
    counts = launch_counts(fp, ff)
    log(err[-1200:])
    check(rc == 0, f"{label} drive exited {rc}")
    path = "cuda_fast" if kernel == "K3" else "cuda"
    check(f"Transform path: {path} " in err, f"{label} drive off {kernel}")
    if streams > 1:
        check(f"Parallel streams: {streams} (mesh size 1)" in err,
              f"{label} drive: not over {streams} streams")
    freqs, vals, _ = spectrum(out)
    check(len(vals) == N and np.all(np.isfinite(vals)),
          f"{label} drive: malformed spectrum")
    peak = freqs[int(np.argmax(vals))]
    check(abs(peak - 100.2e6) <= RATE / N, f"{label} drive: peak at {peak}")
    err_gold = max_rel(vals, golden_fn())
    hist = [line for line in err.splitlines()
            if line.startswith("Buffer queue histogram:")]
    print(f"e2e {label} ({' '.join(argv)}): exit 0 in {wall:.2f} s wall; "
          f"peak {peak / 1e6:.4f} MHz; max rel vs float64 golden "
          f"{err_gold:.3e} (<= {rtol:g}); {hist[-1] if hist else ''}; "
          f"launches {counts}")
    check(err_gold <= rtol, f"{label} drive vs float64 golden")
    check_only(counts, kernel, f"{label} drive")
    return counts[kernel]


def recorded_golden(record, N, repeats, hop, window=None):
    """Linear float64 golden spectrum of a recorded stream, frames of N
    samples at a hop of ``hop`` samples (Welch overlap when hop < N)."""
    stream = np.fromfile(record, dtype=np.uint8)
    check(len(stream) >= 2 * (hop * (repeats - 1) + N),
          f"recorded stream {record} too short")
    pwr = np.zeros(N)
    for f0 in range(0, repeats, 256):
        frames = np.stack([stream[2 * hop * f:2 * hop * f + 2 * N]
                           for f in range(f0, min(f0 + 256, repeats))])
        pwr += golden_partial(frames, len(frames), window)
    return golden_finalize_linear(np.fft.fftshift(pwr), repeats, RATE)


def drive_config2(cli, fp, ff, make_window, tmp):
    """BASELINE config 2 through the CLI (K2): linear spectrum against a
    float64 Welch transcription of the recorded stream, then the dB run
    fed back to itself with -B. Returns the K2 launches of the drive."""
    N, repeats, hop = 8192, 4000, 4096
    record = os.path.join(tmp, "config2.iq")
    base = ["-f", "100M", "-n", str(repeats), "-b", str(N),
            "--window-function", "hann", "--welch-overlap", "50",
            "--source", SOURCE]
    w = make_window("hann", N)
    launches = drive(
        "config 2", base + ["-l", "--record", record], cli, fp, ff, "K2", N,
        lambda: recorded_golden(record, N, repeats, hop, w), GOLDEN_RTOL)

    # Baseline feedback: the same drive in dB, then with its own output as
    # -B: every residual is the rounding of the printed baseline.
    reset_counts(fp, ff)
    rc, out_db, _, wall_db = run_cli(base, cli.main)
    check(rc == 0, f"config 2 dB drive exited {rc}")
    baseline = os.path.join(tmp, "config2_baseline.dat")
    with open(baseline, "w") as f:
        f.write(out_db)
    rc, out_res, _, wall_res = run_cli(base + ["-B", baseline], cli.main)
    check(rc == 0, f"config 2 baseline drive exited {rc}")
    _, _, db_text = spectrum(out_db)
    _, res, _ = spectrum(out_res)
    units = np.array([last_digit_unit(v) for v in db_text])
    worst = float(np.max(np.abs(res) / units))
    counts = launch_counts(fp, ff)
    print(f"e2e config 2 in dB then -B its own output: exit 0 in "
          f"{wall_db:.2f} s + {wall_res:.2f} s wall; max |residual| "
          f"{np.abs(res).max():.3g} dB = {worst:.2f} units of the sixth "
          f"printed digit; launches {counts}")
    check(worst <= 1.0, "config 2 baseline residual above one printed unit")
    check_only(counts, "K2", "config 2 baseline drives")
    return launches


def drive_precision_high(cli, fp, ff, make_window, tmp):
    """--precision high with a Blackman window file through the CLI (K3).
    Returns the K3 launches of the drive."""
    N, repeats = 2048, 2000
    w = make_window("blackman", N)
    wfile = os.path.join(tmp, "blackman.txt")
    with open(wfile, "w") as f:
        f.write("\n".join(f"{v:.9g}" for v in w) + "\n")
    record = os.path.join(tmp, "high.iq")
    argv = ["-f", "100M", "-n", str(repeats), "-b", str(N), "--precision",
            "high", "-w", wfile, "-l", "--record", record, "--source", SOURCE]
    return drive("precision high", argv, cli, fp, ff, "K3", N,
                 lambda: recorded_golden(record, N, repeats, N, w),
                 RELAXED_RTOL)


def drive_config5(cli, fp, ff, tmp):
    """BASELINE config 5 through the CLI (K4): 16 streams, the combined
    linear spectrum against the float64 golden of the 16 recorded
    streams. Returns the K4 launches of the drive."""
    N, repeats = 2048, 4000
    record = os.path.join(tmp, "config5.iq")
    argv = ["-f", "100M", "-n", str(repeats), "-b", str(N), "--streams",
            str(C5_STREAMS), "--frames-per-step", "256", "-l", "--record",
            record, "--source", SOURCE]

    def golden():
        # The combined spectrum averages S·repeats spectra: the mean of
        # the per-stream linear goldens.
        return sum(recorded_golden(f"{record}.s{s}", N, repeats, N)
                   for s in range(C5_STREAMS)) / C5_STREAMS

    return drive("config 5", argv, cli, fp, ff, "K4", N, golden, GOLDEN_RTOL,
                 streams=C5_STREAMS)


def drive_streams_scan(cli, fp, ff, tmp):
    """A windowed hopping matrix drive over 4 streams with a dead hop
    (K4 windowed). Returns its launches."""
    scan = os.path.join(tmp, "streams_scan")
    argv = STREAMS_SCAN_ARGV + ["-m", scan]
    reset_counts(fp, ff)
    rc, _, err, wall = run_cli(argv, cli.main)
    counts = launch_counts(fp, ff)
    log(err[-800:])
    check(rc == 0, f"streams scan drive exited {rc}")
    check("Parallel streams: 4 (mesh size 1)" in err
          and "Transform path: cuda " in err, "streams scan drive off K4")
    check("Unable to tune to 103000000. Dropping from frequency list."
          in err, "streams scan drive: dead hop not dropped")
    with open(scan + ".met") as f:
        meta = [line.split("#")[0].strip() for line in f]
    cols, nrows = int(meta[0]), int(meta[1])
    data = np.fromfile(scan + ".bin", dtype=np.float32)
    check(cols == 2 * 256 and nrows == 1 and data.size == cols
          and np.all(np.isfinite(data)),
          f"streams scan drive: .met says {cols}x{nrows}, .bin has "
          f"{data.size}")
    hop = int(np.argmax(data)) // 256
    peak = 105e6 + (int(np.argmax(data)) % 256 - 128) * RATE / 256
    check(hop == 1 and abs(peak - 104.9e6) <= RATE / 256,
          f"streams scan drive: peak at {peak} Hz in hop {hop}")
    print(f"e2e streams scan drive ({' '.join(STREAMS_SCAN_ARGV)}): exit 0 in "
          f"{wall:.2f} s wall; dead hop dropped; .met {cols}x{nrows}, .bin "
          f"{data.nbytes} bytes; peak {peak / 1e6:.4f} MHz; launches {counts}")
    check_only(counts, "K4 windowed", "streams scan drive")
    return counts["K4 windowed"]


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing was run.")
        return 1

    from rtl_power_fftw_tpu.auxdata import make_window
    from rtl_power_fftw_tpu_torch import cli
    from rtl_power_fftw_tpu_torch.ops.kernels import _build
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_fast as ff
    from rtl_power_fftw_tpu_torch.ops.spectral import adapt_batch
    from rtl_power_fftw_tpu_torch.parallel import ShardedPsdStep
    COUNTS, fused_psd, fused_psd_reference = (fp.COUNTS, fp.fused_psd,
                                              fp.fused_psd_reference)

    # 1. Machine.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"machine: {kind}; torch {torch.__version__}; "
          f"CUDA {torch.version.cuda}; python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)

    # 2. Build.
    t0 = time.perf_counter()
    infos = _build.build()
    for name in _build.SIGNATURES:
        _build.load(name)
    for name, info in infos.items():
        log(info.log.strip())
        print(f"build: {info.path.name} by nvcc in {info.seconds:.1f} s")
    print(f"build: all sources in {time.perf_counter() - t0:.1f} s wall")

    # 3. K1 against the plain version (and the float64 golden).
    rng = np.random.default_rng(20261016)
    cases = [  # (label, N, frames_per_step, n_valid or None for all)
        ("canonical drive step", 2048, 400, None),
        ("scan drive step", 256, 3200, 16),
        ("N=256", 256, 1024, None),
        ("N=2048 F=4096", 2048, 4096, None),
        ("N=2048 masked", 2048, 4096, 1000),
        ("N=16384", 16384, 64, None),
    ]
    COUNTS.reset()
    max_abs_2048 = None
    for label, N, fps, n_valid in cases:
        F, chunk = adapt_batch(fps)
        nv = F if n_valid is None else n_valid
        raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        got = fused_psd(raw, nv, chunk)
        again = fused_psd(raw, nv, chunk)
        want = fused_psd_reference(raw, nv, chunk)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{label}: kernel not deterministic")
        got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
        err_plain = max_rel(got_np, want_np)
        gold = golden_partial(raw_np, nv)
        err_gold = max_rel(got_np, gold)
        err_plain_gold = max_rel(want_np, gold)
        print(f"kernel {label} (N={N} F={F} chunk={chunk} n_valid={nv}): "
              f"max rel vs plain {err_plain:.3e}, vs float64 golden "
              f"{err_gold:.3e} (plain vs golden {err_plain_gold:.3e})")
        check(np.all(np.isfinite(got_np)), f"{label}: non-finite output")
        check(err_plain <= UNIFORM_RTOL, f"{label}: {err_plain} vs plain")
        check(err_gold <= GOLDEN_RTOL, f"{label}: {err_gold} vs golden")
        if label == "N=2048 F=4096":
            max_abs_2048 = float(np.abs(got_np.astype(np.float64)
                                        - want_np).max())
    check(COUNTS.kernel == 2 * len(cases) and COUNTS.plain == 0,
          f"launch counter did not move as expected: {vars(COUNTS)}")

    # Under a 35 dB tone the f32 error is class-relative (CLAUDE.md):
    # median <= 1.5x and max <= 3x the scipy float32 FFT's error.
    N, F = 2048, 64
    ours, plain, yard = [], [], []
    for seed in range(12):
        raw_np = tone_frames(N, F, 500 + seed)
        gold = golden_partial(raw_np, F)
        raw = torch.from_numpy(raw_np).to(dev)
        ours.append(max_rel(fused_psd(raw, F, 64).cpu().numpy(), gold))
        plain.append(max_rel(fused_psd_reference(raw, F, 64).cpu().numpy(),
                             gold))
        yard.append(max_rel(scipy_f32_class(raw_np), gold))
    med_ratio = statistics.median(ours) / statistics.median(yard)
    max_ratio = max(ours) / max(yard)
    print(f"kernel 35 dB tone N={N} F={F}, 12 seeds: max rel median "
          f"{statistics.median(ours):.3e} / max {max(ours):.3e}; scipy f32 "
          f"{statistics.median(yard):.3e} / {max(yard):.3e}; plain (cuFFT) "
          f"{statistics.median(plain):.3e} / {max(plain):.3e}; ratios "
          f"median {med_ratio:.2f}x, max {max_ratio:.2f}x")
    check(med_ratio <= 1.5 and max_ratio <= 3.0,
          "tone error above the FFTW-class budget")

    # 4.-6. K2, K3 and K4.
    k2_abs = phase_k2(dev, rng, fp, adapt_batch, make_window)
    k3_abs = phase_k3(dev, rng, ff, adapt_batch, make_window)
    k4_abs = phase_k4(dev, rng, fp, adapt_batch, make_window, ShardedPsdStep)

    # 7. Times (median of 60 event-timed calls after 10 warm-ups).
    times = phase_times(dev, rng, fp, ff, adapt_batch, make_window, card)

    # 8. End to end, in-process through the CLI.
    with tempfile.TemporaryDirectory() as tmp:
        record = os.path.join(tmp, "canonical.iq")
        N, repeats = 2048, 20000
        launches = drive(
            "canonical", ["-f", "100M", "-n", str(repeats), "-b", str(N),
                          "-l", "--record", record, "--source", SOURCE],
            cli, fp, ff, "K1", N,
            lambda: recorded_golden(record, N, repeats, N), GOLDEN_RTOL)

        scan = os.path.join(tmp, "scan")
        argv = ["-f", "100M:106M", "-n", "16", "-b", "256", "-q", "-m", scan,
                "--source", "synthetic:tone=104.9M/40,noise=5,seed=2,"
                "dead=103M"]
        reset_counts(fp, ff)
        rc, out, err, wall = run_cli(argv, cli.main)
        counts = launch_counts(fp, ff)
        log(err[-800:])
        check(rc == 0, f"scan drive exited {rc}")
        check("Unable to tune to 103000000. Dropping from frequency list."
              in err, "scan drive: dead hop not dropped")
        with open(scan + ".met") as f:
            meta = [line.split("#")[0].strip() for line in f]
        cols, nrows = int(meta[0]), int(meta[1])
        data = np.fromfile(scan + ".bin", dtype=np.float32)
        check(cols == 2 * 256 and nrows == 1 and data.size == cols,
              f"scan drive: .met says {cols}x{nrows}, .bin has {data.size}")
        hop = int(np.argmax(data)) // 256
        peak = 105e6 + (int(np.argmax(data)) % 256 - 128) * RATE / 256
        check(hop == 1 and abs(peak - 104.9e6) <= RATE / 256,
              f"scan drive: peak at {peak} Hz in hop {hop}")
        print(f"e2e scan drive: exit 0 in {wall:.2f} s wall; dead hop "
              f"dropped; .met {cols}x{nrows}, .bin {data.nbytes} bytes; "
              f"peak {peak / 1e6:.4f} MHz; launches {counts}")
        check_only(counts, "K1", "scan drive")

        k2_launches = drive_config2(cli, fp, ff, make_window, tmp)
        k3_launches = drive_precision_high(cli, fp, ff, make_window, tmp)
        k4_launches = drive_config5(cli, fp, ff, tmp)
        k4w_launches = drive_streams_scan(cli, fp, ff, tmp)

    check(not any(m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes")
                  for m in sys.modules), "jax was imported")

    def entry(name, source, replaces, launches, max_abs, key):
        k_us, p_us, _ = times[key]
        return {"name": name, "route": "cuda", "source": CSRC + source,
                "replaces": TPU_KERNEL + replaces, "launches": launches,
                "max_abs_err": max_abs, "ms": k_us / 1000.0,
                "plain_ms": p_us / 1000.0}

    print(json.dumps({"kernels": [
        entry("fused_psd", "fused_psd.cu", "435", launches, max_abs_2048,
              ("K1", 2048, 4096, None)),
        entry("fused_psd (windowed)", "fused_psd.cu", "261", k2_launches,
              k2_abs, ("K2", 2048, 4096, "hann")),
        entry("fused_psd_fast", "fused_psd_fast.cu", "298", k3_launches,
              k3_abs, ("K3", 2048, 4096, None)),
        entry("fused_psd_streams", "fused_psd.cu", "327", k4_launches,
              k4_abs[None], ("K4", 2048, 256, None)),
        entry("fused_psd_streams (windowed)", "fused_psd.cu", "327",
              k4w_launches, k4_abs["hann"], ("K4", 2048, 256, "hann")),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
