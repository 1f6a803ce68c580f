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
7. times of K1, K2, K3, K4, the large-N kernel, their plain versions and
   ``torch.fft.fft`` with CUDA events;
8. end to end through ``cli.main`` in-process: the canonical 2048-bin
   20,000-spectrum drive (K1), a hopping matrix drive with a dead hop
   (K1), BASELINE config 2 (8192 bins, Hann, 50% Welch overlap; K2)
   against a float64 Welch transcription of the recorded stream, fed
   back to itself with ``-B``, a ``--precision high`` drive with a
   Blackman window file (K3), BASELINE config 5 (``--streams 16``; K4)
   against the float64 golden of the 16 recorded streams, and a windowed
   hopping matrix drive over 4 streams with a dead hop (K4 windowed).
   Then BASELINE config 3 (``-b 1048576 -t 10``, the large-N kernel)
   against the float64 golden of its recorded stream, a windowed
   large-N drive (``-b 65536 --window-function hann``), and a sweep of
   8-spectrum matrix-mode drives at every size the large kernel takes
   (32768 to 2^22), unwindowed and with Hann, each against its recorded
   stream's golden (1e-5, or 3x the scipy float32 FFT's error on the same
   frames where that is larger).
   Every launch counter is reset just before each drive; the drive's
   kernel must have launched and no plain version may have run;
9. the large-N kernel (``fused_psd_large``, K1/K2 from 32768 and P15 at
   2^20): against its plain version and the float64 golden at every size
   from N = 32768 to 2^22, with and without windows and masked, each run
   twice for determinism; its 60-seed tone yard at 32768, 65536 and 2^20,
   unwindowed and Hann, against the scipy float32 class with the
   per-seed p99; its times, and ptxas's register and spill lines for
   every instantiation. (Runs before the drives; numbered here for the
   kernels line.)
10. a profile of the config 3 drive under ``torch.profiler``: device time
   by kernel and copy per step (the result's read-back into pinned memory
   among them), and the device's busy share of the wall; and one more
   config 5 drive with the consumer's calls timed on its own thread: its
   rounds split into waiting for the producers, filling the pinned slot,
   the upload, the step's enqueue, the event waits and the float64
   accumulation;
11. the stage-attribution, stage-2, stage-1 packing, Karatsuba and
   K-stacking probes (``fused_psd_probe``: P1, P18, P13, P14, P16, P19,
   P11, P17, P2, P6, P5, P3, P4, P7, P8, P9 and P10 as variants of K3's
   template, K1's cuts, P12's relayouts), right after the build: every
   variant against its plain version at N = 2048,
   F = 4096, with all frames valid and with 1000, twice for determinism;
   P1 ``full`` and ``dg3d``, P2 ``pack8`` and P9 ``v5left`` bit-identical
   to the shipping K3, ``k1_full`` to K1, the layout variants and the
   schedules (P19 ``ilv``, ``ilv4``, P11 ``pipe``) of the 6-product
   scheme and its order from Z's 3-term split planes (``tpu6_zplanes``)
   to its ``full``, P17 ``u32t`` to P16 ``e2``, P4 ``s1cat`` to P3
   ``dg3dall``; P10 ``v6k``'s largest difference from the 6-product
   scheme printed; P12 equal to torch's
   reshape/permute; ptxas's
   registers and spills of every instantiation at N = 2048 (the shipping
   K1 and K3 beside them); each variant's slope time (the probes' own
   method), its plain version's, its bound and ``torch.fft.fft``'s;
   and device time by kernel under ``torch.profiler`` for K3, ``dg3d``,
   K1 and the gather cut (the row sum's own time beside each group
   kernel's); then each variant's registers, spill, shared memory and
   resident blocks per SM, and its time again with its occupancy pinned
   to that of the whole kernel it is compared with (K3's and the
   6-product scheme's for K3's template, and for the 6-product scheme's
   variants, the left forms (P9 ``v5left`` among them), K3 and the other
   variants that get fewer blocks than K3 also the least any of the
   6-product family gets; K1's for K1's cuts), its output unchanged;
12. the probes' entry points (``python -m
   rtl_power_fftw_tpu_torch.probes.{profile_kernel,s1_lanes,s1_lanes2,
   cast_test,s2_fourmult,s2_left,s2_ilv,s2_pipe,s2_u32t}``, and
   ``profile_kernel pack8c s1wide s1wide:8``, ``profile_kernel dg3dall
   s1cat s1k32 s1k96 best best:8`` and ``profile_kernel v5 v5left v6
   v6k``) in-process, each with every launch
   counter reset just before it: exit 0, one line per variant run, and
   every one of those variants launched (the probes' ``launches`` are
   this run's); then ``profile_kernel`` again over a
   sweep of frames per block (``variant:tile``) for K3, ``dg3d`` and K1,
   and ``s2_pipe`` and ``s2_ilv`` at 16 frames a block, their launches on
   lines of their own.

Every kernel entry of the ``{"kernels": [...]}`` line carries its bound
(the larger of its bytes over 3.35 TB/s and its operations over the
card's peak for their type, from the entry's shape), its launches in its
drive, and the time of ``torch.fft.fft`` on the same frames already in
complex64 on the card (the transform alone, not the whole function).

Stdout ends with that line and then the result line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
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
# The large-N drives' source: a weak line (amplitude 2 counts, under the
# noise's 6) in noise, as long integrations look for. Under SOURCE's
# stronger tone the float32 error of any FFT at 2^20 (the scipy float32
# class's too) exceeds 1e-5 of the golden in the bins far below the tone;
# the tone yard holds the kernel to that class instead.
LINE_SOURCE = "synthetic:tone=100.2M/2,noise=6,seed=1"
# BASELINE config 3 (bench_configs.py:149-153): 2^20 bins; -t 10 cuts its
# time-limited continuous accumulation to 10 s of stream (20 spectra).
C3_N = 1 << 20
C3_SECONDS = 10
# The card's published peaks (NVIDIA's H100 SXM data sheet, at 700 W):
# device memory, FP32 on the CUDA cores, dense bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
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
    from rtl_power_fftw_tpu_torch.config import parse_args
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


def phase_times(dev, rng, fp, ff, fl, adapt_batch, make_window, card):
    """Median CUDA-event times (us/step): kernel, plain, kernel again, and
    torch.fft.fft over the same frames already in complex64 on the card
    (the transform alone: the library yardstick)."""
    times = {}
    shapes = [("K1", 2048, 4096, None), ("K1", 2048, 400, None),
              ("K2", 2048, 4096, "hann"), ("K2", 8192, 1024, "hann"),
              ("K2", 8192, 104, "hann"), ("K3", 2048, 4096, None),
              ("K3", 2048, 4096, "hann"), ("K3", 8192, 1024, None),
              ("K3", 2048, 400, "blackman"), ("K4", 2048, 256, None),
              ("K4", 2048, 256, "hann"), ("L", C3_N, 8, None),
              ("L", C3_N, 8, "hann"), ("L", 65536, 16, "hann"),
              ("L", 32768, 32, None), ("L", 1 << 22, 8, None)]
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
        elif name == "L":
            kernel, plain = fl.fused_psd_large, fl.fused_psd_large_reference
        else:
            kernel, plain = fp.fused_psd, fp.fused_psd_reference
        flat = raw.reshape(S * F, 2 * N)
        z = torch.complex(flat[:, 0::2].float() - 127.0,
                          flat[:, 1::2].float() - 127.0)
        k_us = event_times_us(lambda: kernel(raw, nv, chunk, w))
        p_us = event_times_us(lambda: plain(raw, nv, chunk, w))
        lib_us = event_times_us(lambda: torch.fft.fft(z, dim=-1))
        k_us2 = event_times_us(lambda: kernel(raw, nv, chunk, w))
        b_ms, b_by = bound_ms(name, S * F, N, w is not None, S)
        times[(name, N, F, wname)] = (k_us, p_us, k_us2, lib_us, b_ms, b_by)
        frames = S * F
        print(f"time {name} N={N} F={F}{f' S={S}' if S > 1 else ''} window="
              f"{wname} on {card}: kernel {k_us:.1f} us/step "
              f"({frames * N / k_us / 1e3:.2f} GS/s; repeat {k_us2:.1f} us), "
              f"plain {p_us:.1f} us/step "
              f"({frames * N / p_us / 1e3:.2f} GS/s), torch.fft.fft of the "
              f"complex64 frames {lib_us:.1f} us, bound {1e3 * b_ms:.1f} us "
              f"({b_by})")
    return times


def reset_counts(fp, ff) -> None:
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    fp.COUNTS.reset()
    ff.COUNTS.reset()
    fpp.COUNTS.reset()


def launch_counts(fp, ff) -> dict:
    """Every launch counter by the kernel (or plain version) it counts;
    "L" is the large-N kernel, "probes" every probe variant together."""
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    return {"K1": fp.COUNTS.kernel, "K2": fp.COUNTS.kernel_windowed,
            "K3": ff.COUNTS.kernel, "K4": fp.COUNTS.kernel_streams,
            "K4 windowed": fp.COUNTS.kernel_streams_windowed,
            "L": fp.COUNTS.kernel_large,
            "L windowed": fp.COUNTS.kernel_large_windowed,
            "plain": fp.COUNTS.plain, "plain_fast": ff.COUNTS.plain,
            "probes": sum(fpp.COUNTS.kernel.values())
            + sum(fpp.COUNTS.plain.values())}


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
    path = {"K3": "cuda_fast", "L": "cuda_large",
            "L windowed": "cuda_large"}.get(kernel, "cuda")
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


def config5_argv(record: str):
    """BASELINE config 5's drive: 16 streams of 4,000 2048-bin spectra,
    256 frames a step, recorded to ``record``.s<i>."""
    return ["-f", "100M", "-n", "4000", "-b", "2048", "--streams",
            str(C5_STREAMS), "--frames-per-step", "256", "-l", "--record",
            record, "--source", SOURCE]


def drive_config5(cli, fp, ff, tmp):
    """BASELINE config 5 through the CLI (K4): 16 streams, the combined
    linear spectrum against the float64 golden of the 16 recorded
    streams. Returns the K4 launches of the drive."""
    N, repeats = 2048, 4000
    record = os.path.join(tmp, "config5.iq")
    argv = config5_argv(record)

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


def tone_frames_dev(N: int, F: int, seed: int, dev) -> torch.Tensor:
    """tone_frames made on the card (a torch generator seeded with
    ``seed``): (F, 2N) uint8, a 35 dB tone at a random frequency and
    phase over unit noise."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f0 = 0.05 + 0.4 * torch.rand((), generator=g, device=dev,
                                 dtype=torch.float64)
    ph = 2 * np.pi * torch.rand((), generator=g, device=dev,
                                dtype=torch.float64)
    t = torch.arange(F * N, device=dev, dtype=torch.float64)
    arg = 2 * np.pi * f0 * t + ph
    noise = torch.randn((2, F * N), generator=g, device=dev,
                        dtype=torch.float64)
    re = torch.clamp(torch.round(100.0 * torch.cos(arg) + noise[0] + 127),
                     0, 255)
    im = torch.clamp(torch.round(100.0 * torch.sin(arg) + noise[1] + 127),
                     0, 255)
    return torch.stack([re, im], dim=-1).to(torch.uint8).reshape(F, 2 * N)


def golden_partial_dev(raw: torch.Tensor, window=None) -> np.ndarray:
    """The float64 golden of every frame of ``raw`` computed on the card
    (cuFFT in float64), unshifted bins: for the tone yards at sizes where
    the numpy golden would take minutes."""
    z = torch.complex(raw[:, 0::2].double() - 127.0,
                      raw[:, 1::2].double() - 127.0)
    if window is not None:
        z = z * window.double()
    X = torch.fft.fft(z, dim=1)
    return (X.real ** 2 + X.imag ** 2).sum(0).cpu().numpy()


def rate_bound_ms(nbytes: float, bf16_flops: float, fp32_ops: float):
    """The least time the card could take for this work, and what bounds
    it: the larger of the bytes over the memory rate and the operations
    over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = bf16_flops / BF16_FLOP_PER_S + fp32_ops / FP32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def bound_ms(kind: str, frames: int, N: int, windowed: bool,
             out_rows: int = 1):
    """rate_bound_ms of one call: K3's work as the probes count it
    (fused_psd_probe.k3_work; 2 N (12 N1 + 9 N2) bf16 flops per frame, 24
    N1 windowed), and the FFT-based steps' (K1, K2, K4, the large-N
    kernel "L") as k1_work does (~5 N log2 N FP32 flops per frame)."""
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    if kind == "K3":
        return rate_bound_ms(*fpp.k3_work(frames, N, 6 if windowed else 3,
                                          windowed=windowed))
    return rate_bound_ms(*fpp.k1_work(frames, N, windowed=windowed,
                                      out_rows=out_rows,
                                      twiddle_table=kind != "L"))


def phase_large(dev, rng, fp, fl, adapt_batch, make_window):
    """The large-N kernel against its plain version and the float64
    golden, twice each, then its 60-seed tone yard. Returns its max abs
    error against the plain version at config 3's step and at the
    windowed drive's step."""
    cases = [  # (label, N, frames_per_step, n_valid or None, window)
        ("N=32768 F=8", 32768, 8, None, None),
        ("N=32768 F=8 hann", 32768, 8, None, "hann"),
        ("N=32768 session step", 32768, 25, None, None),
        ("N=65536 F=8", 65536, 8, None, None),
        ("N=65536 F=8 hann masked", 65536, 8, 5, "hann"),
        ("N=65536 hann (windowed drive step)", 65536, 12, None, "hann"),
        ("N=2^17 F=8 hann", 1 << 17, 1, None, "hann"),
        ("N=2^18 F=8", 1 << 18, 1, None, None),
        ("N=2^19 F=8 masked", 1 << 19, 1, 6, None),
        ("N=2^20 F=8 (config 3 step)", C3_N, 1, None, None),
        ("N=2^20 F=8 hann", C3_N, 1, None, "hann"),
        ("N=2^20 F=8 masked", C3_N, 1, 3, None),
        ("N=2^21 F=8 hann", 1 << 21, 1, None, "hann"),
        ("N=2^22 F=8 blackman", 1 << 22, 1, None, "blackman"),
    ]
    fp.COUNTS.reset()
    max_abs = {}
    n_windowed = 0
    for label, N, fps, n_valid, wname in cases:
        F, chunk = adapt_batch(fps)
        nv = F if n_valid is None else n_valid
        w_np = None if wname is None else make_window(wname, N)
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        n_windowed += w is not None
        raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        got = fl.fused_psd_large(raw, nv, chunk, w)
        again = fl.fused_psd_large(raw, nv, chunk, w)
        want = fl.fused_psd_large_reference(raw, nv, chunk, w)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"large {label}: not deterministic")
        got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
        gold = golden_partial(raw_np, nv, w_np)
        err_plain, err_gold = max_rel(got_np, want_np), max_rel(got_np, gold)
        print(f"large {label} (N={N} F={F} chunk={chunk} n_valid={nv} "
              f"window={wname}; N1 x N2 = {fl.large_split(N)}, frames/block "
              f"{fl.frames_per_block(F, chunk, N)}): max rel vs plain "
              f"{err_plain:.3e}, vs float64 golden {err_gold:.3e} (plain vs "
              f"golden {max_rel(want_np, gold):.3e})")
        check(np.all(np.isfinite(got_np)), f"large {label}: non-finite")
        check(err_plain <= UNIFORM_RTOL, f"large {label}: {err_plain} vs plain")
        check(err_gold <= GOLDEN_RTOL, f"large {label}: {err_gold} vs golden")
        if label.startswith("N=2^20 F=8 (config 3") or "drive step" in label:
            max_abs[wname] = float(np.abs(got_np.astype(np.float64)
                                          - want_np).max())
    check(fp.COUNTS.kernel_large == 2 * (len(cases) - n_windowed)
          and fp.COUNTS.kernel_large_windowed == 2 * n_windowed
          and fp.COUNTS.plain == 0,
          f"large launch counter did not move as expected: {vars(fp.COUNTS)}")

    # Admission yard: 60 seeds of 35 dB tones per size, unwindowed and
    # Hann, median <= 1.5x and max <= 3x the scipy float32 class.
    for N, fps in ((32768, 32), (65536, 16), (C3_N, 8)):
        F, chunk = adapt_batch(fps)
        for wname in (None, "hann"):
            w_np = None if wname is None else make_window(wname, N)
            w = None if w_np is None else torch.from_numpy(w_np).to(dev)
            ours, cls, plain = [], [], []
            for seed in range(60):
                raw = tone_frames_dev(N, F, 9000 + seed, dev)
                gold = golden_partial_dev(raw, w)
                ours.append(max_rel(fl.fused_psd_large(raw, F, chunk, w)
                                    .cpu().numpy(), gold))
                plain.append(max_rel(fl.fused_psd_large_reference(
                    raw, F, chunk, w).cpu().numpy(), gold))
                cls.append(max_rel(scipy_f32_class(raw.cpu().numpy(), w_np),
                                   gold))
            e, c = np.asarray(ours), np.asarray(cls)
            r = e / c
            med_r, max_r = np.median(e) / np.median(c), e.max() / c.max()
            print(f"large yard N={N} F={F} window={wname}, 60 seeds of 35 dB "
                  f"tones: max rel median {np.median(e):.3e} / max "
                  f"{e.max():.3e}; scipy f32 {np.median(c):.3e} / "
                  f"{c.max():.3e}; plain {np.median(plain):.3e} / "
                  f"{max(plain):.3e}; ratio median {med_r:.2f}x (<= 1.5), "
                  f"max {max_r:.2f}x (<= 3), per-seed p99 "
                  f"{np.quantile(r, 0.99):.2f}x, per-seed max {r.max():.2f}x")
            check(med_r <= 1.5 and max_r <= 3.0,
                  f"large yard N={N} window={wname}: above the FFTW-class "
                  "budget")
    return max_abs


def drive_config3(cli, fp, ff, tmp):
    """BASELINE config 3 through the CLI (the large-N kernel): 2^20 bins,
    -t 10, against the float64 golden of the recorded stream. Returns the
    kernel's launches and the drive's argv."""
    N = C3_N
    repeats = math.ceil(RATE * C3_SECONDS / N)
    record = os.path.join(tmp, "config3.iq")
    argv = ["-f", "100M", "-b", str(N), "-t", str(C3_SECONDS), "-l",
            "--record", record, "--source", LINE_SOURCE]
    launches = drive("config 3", argv, cli, fp, ff, "L", N,
                     lambda: recorded_golden(record, N, repeats, N),
                     GOLDEN_RTOL)
    return launches, argv


def drive_large_windowed(cli, fp, ff, make_window, tmp):
    """A windowed large-N drive (-b 65536 --window-function hann) against
    the windowed float64 golden of its recorded stream. Returns the
    kernel's windowed launches."""
    N, repeats = 65536, 500
    record = os.path.join(tmp, "large_hann.iq")
    argv = ["-f", "100M", "-n", str(repeats), "-b", str(N),
            "--window-function", "hann", "-l", "--record", record,
            "--source", LINE_SOURCE]
    w = make_window("hann", N)
    return drive("large windowed", argv, cli, fp, ff, "L windowed", N,
                 lambda: recorded_golden(record, N, repeats, N, w),
                 GOLDEN_RTOL)


def drive_large_sweep(cli, fp, ff, make_window, tmp) -> None:
    """Every size the large-N kernel takes (32768 to 2^22), unwindowed and
    with Hann, through the CLI in matrix mode: 8 spectra each, through the
    large kernel alone, the float32 ``.bin`` row (no printed digits to
    round) against the float64 golden of the recorded stream, within 1e-5
    or 3x the scipy float32 FFT's error on the same frames (the FFTW-class
    budget), whichever is larger."""
    repeats = 8
    for log2n in range(15, 23):
        N = 1 << log2n
        for wname in (None, "hann"):
            label = f"large sweep 2^{log2n}" + (f" {wname}" if wname else "")
            kernel = "L" if wname is None else "L windowed"
            record = os.path.join(tmp, "sweep.iq")
            matrix = os.path.join(tmp, "sweep")
            argv = (["-f", "100M", "-n", str(repeats), "-b", str(N), "-l",
                     "-q", "-m", matrix, "--record", record, "--source",
                     LINE_SOURCE]
                    + ([] if wname is None else ["--window-function", wname]))
            reset_counts(fp, ff)
            rc, _, err, wall = run_cli(argv, cli.main)
            counts = launch_counts(fp, ff)
            check(rc == 0, f"{label} drive exited {rc}")
            check_only(counts, kernel, f"{label} drive")
            vals = np.fromfile(matrix + ".bin", dtype=np.float32)
            check(vals.size == N and np.all(np.isfinite(vals)),
                  f"{label} drive: .bin holds {vals.size} values")
            peak = 100e6 + (int(np.argmax(vals)) - N // 2) * RATE / N
            check(abs(peak - 100.2e6) <= RATE / N,
                  f"{label} drive: peak at {peak}")
            w = None if wname is None else make_window(wname, N)
            frames = np.fromfile(record, dtype=np.uint8)[:2 * N * repeats] \
                .reshape(repeats, 2 * N)
            gold = golden_finalize_linear(
                np.fft.fftshift(golden_partial(frames, repeats, w)), repeats,
                RATE)
            cls = golden_finalize_linear(
                np.fft.fftshift(scipy_f32_class(frames, w)), repeats, RATE)
            err_gold, err_cls = max_rel(vals, gold), max_rel(cls, gold)
            # 1e-5, or 3x the float32 class where the class itself is near
            # it: at 2^22 the deepest of 4M bins of 8 spectra take scipy's
            # float32 FFT to ~1.1e-5 of the golden on this stream.
            budget = max(GOLDEN_RTOL, 3.0 * err_cls)
            print(f"e2e {label} ({' '.join(argv)}): exit 0 in {wall:.2f} s "
                  f"wall; peak {peak / 1e6:.4f} MHz; .bin max rel vs float64 "
                  f"golden {err_gold:.3e} (<= {budget:.3g}); scipy float32 on "
                  f"the same frames {err_cls:.3e}; launches {counts}")
            check(err_gold <= budget, f"{label} drive vs float64 golden")


def device_rows(prof):
    """[(kernel or copy name, calls, device us)] of a torch.profiler run."""
    from torch.autograd import DeviceType
    return [(evt.key, evt.count,
             getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0)))
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA]


def profile_drive(label, argv, cli, markers) -> None:
    """One more run of a drive under torch.profiler: device time by
    kernel (and copy) name, per call, and the device's busy share of the
    drive's wall time. Prints "not measured" where the profiler sees no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        rc, _, _, wall = run_cli(argv, cli.main)
    check(rc == 0, f"profiled {label} drive exited {rc}")
    rows = device_rows(prof)
    busy = sum(us for _, _, us in rows)
    if not rows or busy <= 0:
        print(f"profile {label}: the profiler recorded no device time "
              "(device times not measured)")
        return
    parts = []
    for marker in markers:
        hit = [(k, n, us) for k, n, us in rows if marker in k]
        n = sum(c for _, c, _ in hit)
        us = sum(t for _, _, t in hit)
        parts.append(f"{marker}: {n} calls, {us / max(n, 1):.1f} us/call, "
                     f"{us / 1e3:.2f} ms")
    print(f"profile {label} ({' '.join(argv)}): wall {wall:.2f} s, device "
          f"busy {busy / 1e3:.2f} ms ({100.0 * busy / 1e6 / wall:.3f}% of "
          f"wall); " + "; ".join(parts))


def profile_consumer(label, argv, cli) -> None:
    """One more run of a ``--streams`` drive with the consumer's calls
    timed on the host clock, on the consumer's thread only (the one that
    runs ``MultiStreamAcquisition._consume``): its rounds split into
    waiting for the producers' batches (the semaphore), filling the pinned
    slot (``_fill``), the upload (``SlotRing.upload``), the step's enqueue
    (``ShardedPsdStep.__call__``), the waits on CUDA events (slot reuse and
    read-back) and the float64 accumulation (the read-back's callback), per
    round. cProfile is not used: from Python 3.12 it traces every thread
    on one stack, and the producers' frames land in the consumer's."""
    import threading
    from rtl_power_fftw_tpu_torch.parallel import multistream, sharded
    from rtl_power_fftw_tpu_torch.pipeline import datastore
    spent, calls, consumer = {}, {}, []

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            if key != "consumer" and (
                    not consumer or threading.get_ident() != consumer[0]):
                return fn(*args, **kwargs)
            if key == "consumer":
                consumer.append(threading.get_ident())
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
                calls[key] = calls.get(key, 0) + 1
        return wrapper

    submit = datastore.SlotRing.submit
    patches = [
        (multistream.MultiStreamAcquisition, "_consume", "consumer"),
        (multistream.MultiStreamAcquisition, "_fill", "fill"),
        (datastore.SlotRing, "upload", "upload"),
        (sharded.ShardedPsdStep, "__call__", "step enqueue"),
        (torch.cuda.Event, "synchronize", "event waits"),
        (threading.Semaphore, "acquire", "wait for producers")]
    saved = [(owner, name, owner.__dict__[name]) for owner, name, _ in patches]
    try:
        for owner, name, key in patches:
            fn = getattr(owner, name)
            wrapped = timed(key, fn)
            setattr(owner, name, staticmethod(wrapped)
                    if isinstance(owner.__dict__[name], staticmethod)
                    else wrapped)
        datastore.SlotRing.submit = lambda self, outputs, callback: submit(
            self, outputs, timed("float64 accumulation", callback))
        rc, _, _, wall = run_cli(argv, cli.main)
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
        datastore.SlotRing.submit = submit
    check(rc == 0, f"timed {label} drive exited {rc}")
    rounds, total = calls.get("fill", 0), spent.get("consumer", 0.0)
    check(rounds > 0 and total > 0, f"{label}: no consumer rounds timed")
    parts = [(key, spent.get(key, 0.0)) for _, _, key in patches[1:]] + [
        ("float64 accumulation", spent.get("float64 accumulation", 0.0))]
    rest = total - sum(t for _, t in parts)
    print(f"profile {label} consumer (host clock, {' '.join(argv)}): wall "
          f"{wall:.2f} s, consumer {total:.3f} s over {rounds} rounds, "
          f"{1e3 * total / rounds:.2f} ms a round: "
          + ", ".join(f"{name} {1e3 * t / rounds:.2f} ms"
                      for name, t in parts)
          + f", the rest (sweeps, bookkeeping) {1e3 * rest / rounds:.2f} ms")


def template_ptxas(log_text: str, marker: str, first_arg: str = ""):
    """(marker<template arguments>, registers/spill summary) for each
    instantiation ptxas reports in ``log_text`` whose mangled name holds
    ``marker`` (and whose first template argument is ``first_arg``, when
    given): the integer and bool arguments in order, variant parameters
    included."""
    out, name, spill = [], None, ""
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1] if "'" in line else line
            args = re.findall(r"L[ib](\d+)E", mangled)
            name = (f"{marker}<{', '.join(args)}>"
                    if marker in mangled and args
                    and (not first_arg or args[0] == first_arg) else None)
            spill = ""
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            out.append((name, line.split("ptxas info    :")[-1].strip()
                        + "; " + spill))
            name = None
    return out


def phase_probes(dev, rng, fpp, ff, fp, adapt_batch, card):
    """Every stage-attribution probe variant against its plain version and
    its parity class, twice each, then its time. Returns {variant or P12
    case: (ms, plain_ms, bound_ms, bound_by, max_abs, library_ms)}."""
    from rtl_power_fftw_tpu_torch.probes._timing import slope_us
    N = fpp.N
    F, chunk = adapt_batch(4096)
    raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                        dtype=np.uint8)).to(dev)
    z = torch.complex(raw[:, 0::2].float() - 127.0,
                      raw[:, 1::2].float() - 127.0)
    fft_us = event_times_us(lambda: torch.fft.fft(z, dim=-1))
    masked = min(1000, F // 4)   # 1000 of the 4096 frames
    ship = {("K3", nv): ff.fused_psd_fast(raw, nv, chunk) for nv in (F, masked)}
    ship.update({("K1", nv): fp.fused_psd(raw, nv, chunk)
                 for nv in (F, masked)})
    fpp.COUNTS.reset()
    results, launched = {}, 0
    for name, v in fpp.VARIANTS.items():
        errs = []
        for nv in (F, masked):
            got = fpp.fused_psd_probe(name, raw, nv, chunk)
            again = fpp.fused_psd_probe(name, raw, nv, chunk)
            want = fpp.fused_psd_probe_reference(name, raw, nv, chunk)
            torch.cuda.synchronize()
            launched += 2
            check(torch.equal(got, again), f"probe {name}: not deterministic")
            check(bool(torch.isfinite(got).all()), f"probe {name}: non-finite")
            err = max_rel(got.cpu().numpy(), want.cpu().numpy())
            errs.append(err)
            check(err <= v.rtol, f"probe {name} n_valid={nv}: {err} vs plain "
                  f"(<= {v.rtol:g})")
            if v.parity != "plain":
                # the shipping K3 or K1, or a variant run before it
                check(torch.equal(got, ship[(v.parity, nv)]),
                      f"probe {name} n_valid={nv}: not bit-identical to "
                      f"{v.parity}")
            ship[(name, nv)] = got
            if v.s2_form == fpp.KSTACKED:
                # the 6-product scheme's products in another f32 order
                vs = max_rel(got.cpu().numpy(),
                             ship[("tpu6", nv)].cpu().numpy())
                print(f"probe {name} n_valid={nv} against tpu6: max rel "
                      f"{vs:.3e}")
            if nv == F:
                max_abs = float((got.double() - want.double()).abs().max())
        k_us = slope_us(lambda it: fpp.fused_psd_probe(name, raw, F, chunk,
                                                       iters=it))
        p_us = event_times_us(
            lambda: fpp.fused_psd_probe_reference(name, raw, F, chunk),
            iters=20, warmup=3)
        b_ms, b_by = rate_bound_ms(*v.work(F))
        done = ""
        if v.s1_form in fpp.ZERO_BLOCK_FORMS:
            # the bound is the spectrum's work; this, the zero blocks' too
            d_ms, d_by = rate_bound_ms(*v.work(F, zero_blocks=True))
            done = f" ({1e3 * d_ms:.1f} us, {d_by}, with its zero blocks)"
        results[name] = (k_us / 1e3, p_us / 1e3, b_ms, b_by, max_abs,
                         fft_us / 1e3)
        print(f"probe {name} ({'; '.join(v.tpu)}) N={N} F={F} chunk={chunk} "
              f"frames/block {fp.frames_per_block(F, chunk)} on {card}: "
              f"{k_us:.1f} us/step ({F * N / k_us / 1e3:.2f} GS/s), plain "
              f"{p_us:.1f} us, bound {1e3 * b_ms:.1f} us ({b_by}){done}, "
              f"torch.fft.fft {fft_us:.1f} us; max rel vs plain "
              f"{errs[0]:.3e} / masked {errs[1]:.3e} (<= {v.rtol:g}); "
              f"parity {v.parity}")
    check(sum(fpp.COUNTS.kernel.values()) >= launched
          and not fpp.COUNTS.plain,
          f"probe launch counter did not move as expected: {fpp.COUNTS.kernel}"
          f", plain {fpp.COUNTS.plain}")
    for name in ("k3", "zplanes", "k1_full", "gather"):
        profile_calls(f"probe {name} N={N} F={F}",
                      lambda: fpp.fused_psd_probe(name, raw, F, chunk),
                      ("group_kernel", "psd_sum_kernel"))
    probe_occupancy(fpp, raw, F, chunk, card, slope_us)

    n = fpp.T * fpp._N1 * fpp._N2
    for case, r in fpp.RELAYOUTS.items():
        x = torch.arange(n, dtype=torch.float32, device=dev).reshape(r.in_shape)
        got = fpp.relayout(case, x)
        want = fpp.relayout_reference(case, x)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"P12 {r.name}: not equal to torch's")
        k_us = slope_us(lambda it: fpp.relayout(case, x, iters=it))
        p_us = event_times_us(lambda: fpp.relayout_reference(case, x))
        lib_us = event_times_us(lambda: r.fn(x).contiguous())
        b_ms, b_by = rate_bound_ms(2 * 4 * n, 0.0, 0.0)
        results[case] = (k_us / 1e3, p_us / 1e3, b_ms, b_by, 0.0,
                         lib_us / 1e3)
        print(f"probe P12 {r.name} {r.in_shape} -> {r.out_shape} on {card}: "
              f"{k_us:.2f} us/step, plain (torch, contiguous) {p_us:.2f} us, "
              f"bound {1e3 * b_ms:.3f} us ({b_by}); exact")
    return results


def probe_occupancy(fpp, raw, F, chunk, card, slope_us) -> None:
    """Each probe variant's registers, spill, shared memory and resident
    blocks per SM as it launches, and its time again at the occupancy of
    the whole kernels it is compared with: K3's and the 6-product scheme's
    (every variant of K3's template at both; the 6-product scheme's
    variants, and K3 and those of the others that get fewer blocks than
    K3, also at the least occupancy any of that family gets), K1's (K1's
    cuts). A pinned
    launch pads the block's shared memory (largest carveout) so that no
    more blocks reside; its output must not change. K3 pinned at its own
    occupancy is the control: what the padding and carveout alone cost."""
    own = {name: fpp.probe_attributes(name)["blocks_per_sm"]
           for name in fpp.VARIANTS}
    pins = {"k3": own["k3"], "tpu6": own["tpu6"], "k1": own["k1_full"]}
    # The chained variants' and the wide stage 1's registers allow one
    # block a SM. The left forms (P16's, P9's) run at this family's pins
    # too.
    tpu6_family = [n for n, v in fpp.VARIANTS.items()
                   if n.startswith("tpu6") or v.s2_form == fpp.LEFT]
    least_tpu6 = min(own[n] for n in tpu6_family)
    least_k3 = min(own[n] for n, v in fpp.VARIANTS.items()
                   if v.kernel == "k3" and n not in tpu6_family)

    def pins_of(name: str, v) -> set:
        if v.kernel == "k1":
            return {pins["k1"]}
        both = {pins["k3"], pins["tpu6"]}
        if name in tpu6_family:
            return both | {least_tpu6}
        if name == "k3" or own[name] < pins["k3"]:
            return both | {least_k3}
        return both

    for name, v in fpp.VARIANTS.items():
        a = fpp.probe_attributes(name)
        base = fpp.fused_psd_probe(name, raw, F, chunk)
        k_us = slope_us(lambda it: fpp.fused_psd_probe(name, raw, F, chunk,
                                                       iters=it))
        parts = []
        for b in sorted(pins_of(name, v), reverse=True):
            p = fpp.probe_attributes(name, b)
            got = fpp.fused_psd_probe(name, raw, F, chunk, blocks_per_sm=b)
            torch.cuda.synchronize()
            check(torch.equal(got, base), f"probe {name} at {b} blocks/SM: "
                  "output changed")
            check(p["blocks_per_sm"] <= b, f"probe {name}: {p} at pin {b}")
            p_us = slope_us(lambda it: fpp.fused_psd_probe(
                name, raw, F, chunk, iters=it, blocks_per_sm=b))
            parts.append(f"at {b} blocks/SM ({p['blocks_per_sm']} resident, "
                         f"{p['dynamic_smem']} B dynamic) {p_us:.1f} us/step")
        print(f"probe occupancy {name} on {card}: {a['registers']} registers, "
              f"{a['spill_bytes']} B spill, {a['static_smem']} + "
              f"{a['dynamic_smem']} B shared, {a['blocks_per_sm']} "
              f"blocks/SM: {k_us:.1f} us/step; " + "; ".join(parts))


def profile_calls(label, fn, markers, calls: int = 10) -> None:
    """Device time by kernel name of ``calls`` calls of ``fn`` under
    torch.profiler, per call ("not measured" where the profiler sees no
    device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    if not rows or sum(us for _, _, us in rows) <= 0:
        print(f"profile {label}: the profiler recorded no device time "
              "(device times not measured)")
        return
    parts = []
    for marker in markers:
        hit = [(n, us) for k, n, us in rows if marker in k]
        parts.append(f"{marker} {sum(us for _, us in hit) / calls:.1f} us/call"
                     f" ({sum(n for n, _ in hit)} launches)")
    print(f"profile {label}, {calls} calls: " + "; ".join(parts))


#: profile_kernel's frames-per-block sweep (the default is 4 at F = 4096),
#: and the schedules' at 16 frames a block beside the 6-product scheme's.
TILE_SWEEP = ["full:1", "full:2", "full:8", "full:16", "dg3d:1", "dg3d:16",
              "k1_full:1", "k1_full:2", "k1_full:8", "k1_full:16"]
SCHEDULE_SWEEP = {"s2_pipe": ["base:16", "pipe:16"],
                  "s2_ilv": ["ilv:16", "ilv4:16"]}


#: The probes' entry-point runs: (module, argv, the TPU probes it drives).
#: profile_kernel's run without argv is P1's, then P2's (pack8), as the
#: TPU module's; P6, P5, P3, P4, P7, P8, P9 and P10 are its builds by
#: name, s1wide and best at 4 and 8 frames a block (the TPU's tiles 128
#: and 256, profile_pallas.py:508-511, 782-787).
PROBE_RUNS = (("profile_kernel", [], ("P1", "P2")),
              ("profile_kernel", ["pack8c", "s1wide", "s1wide:8"],
               ("P6", "P5")),
              ("profile_kernel", ["dg3dall", "s1cat", "s1k32", "s1k96",
                                  "best", "best:8"],
               ("P3", "P4", "P7", "P8")),
              ("profile_kernel", ["v5", "v5left", "v6", "v6k"],
               ("P9", "P10")),
              ("s1_lanes", [], ("P18",)), ("s1_lanes2", [], ("P13",)),
              ("cast_test", [], ("P12",)), ("s2_fourmult", [], ("P14",)),
              ("s2_left", [], ("P16",)), ("s2_ilv", [], ("P19",)),
              ("s2_pipe", [], ("P11",)), ("s2_u32t", [], ("P17",)))


def drive_probes(fpp) -> dict:
    """The probes' entry points in-process (PROBE_RUNS), every launch
    counter reset just before each run: exit 0, one line per variant run,
    each of those variants launched and no plain version run. Returns
    {TPU probe: launches of its variants in the run that drove it}."""
    import importlib
    launches = {}
    for module, argv, tpus in PROBE_RUNS:
        entry = importlib.import_module(
            f"rtl_power_fftw_tpu_torch.probes.{module}")
        fpp.COUNTS.reset()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = entry.main(list(argv))
        wall = time.perf_counter() - t0
        text = out.getvalue()
        print(text, end="")
        lines = [ln for ln in text.splitlines() if not ln.startswith("#")]
        if tpus == ("P12",):
            want, runs = list(fpp.RELAYOUTS), len(fpp.RELAYOUTS)
        else:
            want = [p.variants[name] for p, name in fpp.entry_variants(
                tpus[0], [a.partition(":")[0] for a in argv])]
            runs = len(want)
        missing = [v for v in want if fpp.COUNTS.kernel[v] == 0]
        print(f"e2e probe {' '.join([module] + argv)} ({', '.join(tpus)}): "
              f"exit {rc} in {wall:.2f} s wall; {len(lines)} lines; launches "
              f"{dict(fpp.COUNTS.kernel)}")
        check(rc == 0, f"probe entry {module} exited {rc}")
        check(len(lines) == runs, f"probe entry {module}: {len(lines)} "
              f"lines for {runs} variant runs")
        check(not missing and not fpp.COUNTS.plain,
              f"probe entry {module}: not launched {missing}, plain "
              f"{dict(fpp.COUNTS.plain)}")
        for tpu in tpus:
            own = (fpp.RELAYOUTS if tpu == "P12"
                   else set(fpp.PROBES[tpu].variants.values()))
            launches[tpu] = sum(fpp.COUNTS.kernel[v] for v in own)
    from rtl_power_fftw_tpu_torch.probes import profile_kernel
    fpp.COUNTS.reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = profile_kernel.main(TILE_SWEEP)
    print(out.getvalue(), end="")
    check(rc == 0 and len(out.getvalue().splitlines()) == len(TILE_SWEEP) + 1,
          f"profile_kernel tile sweep exited {rc}")
    print(f"e2e probe profile_kernel tile sweep (P1): launches "
          f"{dict(fpp.COUNTS.kernel)}")
    for module, specs in SCHEDULE_SWEEP.items():
        entry = importlib.import_module(
            f"rtl_power_fftw_tpu_torch.probes.{module}")
        fpp.COUNTS.reset()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = entry.main(specs)
        print(out.getvalue(), end="")
        check(rc == 0 and len(out.getvalue().splitlines()) == len(specs) + 1,
              f"{module} tile sweep exited {rc}")
        print(f"e2e probe {module} tile sweep: launches "
              f"{dict(fpp.COUNTS.kernel)}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing was run.")
        return 1

    from rtl_power_fftw_tpu_torch.auxdata import make_window
    from rtl_power_fftw_tpu_torch import cli
    from rtl_power_fftw_tpu_torch.ops.kernels import _build
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_fast as ff
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_large as fl
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    from rtl_power_fftw_tpu_torch.ops.spectral import adapt_batch
    from rtl_power_fftw_tpu_torch.parallel import ShardedPsdStep
    COUNTS, fused_psd, fused_psd_reference = (fp.COUNTS, fp.fused_psd,
                                              fp.fused_psd_reference)
    t_start = time.perf_counter()

    def lap(phase: str) -> None:
        print(f"wall: {phase} done at {time.perf_counter() - t_start:.1f} s")

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
    large_ptxas = [line for marker in ("large_pass_a", "large_pass_b")
                   for line in template_ptxas(infos["fused_psd_large"].log,
                                              marker)]
    check(len(large_ptxas) == 24 or not infos["fused_psd_large"].log,
          f"ptxas reported {len(large_ptxas)} large-N instantiations, not 24")
    for lib, marker, first in (
            ("fused_psd_large", "large_pass_a", ""),
            ("fused_psd_large", "large_pass_b", ""),
            ("fused_psd", "psd_group_kernel", "11"),
            ("fused_psd_fast", "psd_fast_group_kernel", "11"),
            ("fused_psd_probe", "psd_group_kernel", "11"),
            ("fused_psd_probe", "psd_fast_group_kernel", "11")):
        for entry_name, summary in template_ptxas(infos[lib].log, marker,
                                                  first):
            print(f"ptxas {lib} {entry_name}: {summary}")
    print(f"build: all sources in {time.perf_counter() - t0:.1f} s wall")

    # 11.-12. The stage-attribution probes, then their entry points.
    probe_times = phase_probes(dev, np.random.default_rng(0), fpp, ff, fp,
                               adapt_batch, card)
    lap("probe variants")
    probe_launches = drive_probes(fpp)
    lap("probe entry points")

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
    lap("K1 to K4 against plain")
    large_abs = phase_large(dev, rng, fp, fl, adapt_batch, make_window)
    lap("the large kernel against plain")

    # 7. Times (median of 60 event-timed calls after 10 warm-ups).
    times = phase_times(dev, rng, fp, ff, fl, adapt_batch, make_window, card)
    lap("times")

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
        large_launches, c3_argv = drive_config3(cli, fp, ff, tmp)
        large_w_launches = drive_large_windowed(cli, fp, ff, make_window,
                                                tmp)
        drive_large_sweep(cli, fp, ff, make_window, tmp)
        lap("drives")
        # 10. Where the config 3 drive's device time goes, and config 5's
        # consumer's host time.
        profile_drive("config 3", c3_argv, cli,
                      ["Memcpy HtoD", "large_pass_a", "large_pass_b",
                       "psd_sum_kernel", "Memcpy DtoH"])
        profile_consumer("config 5", config5_argv(
            os.path.join(tmp, "config5_profiled.iq")), cli)
        lap("profiles")

    check(not any(m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes")
                  for m in sys.modules), "jax was imported")

    def entry(name, source, replaces, launches, max_abs, key):
        k_us, p_us, _, lib_us, b_ms, b_by = times[key]
        return {"name": name, "route": "cuda", "source": CSRC + source,
                "replaces": (replaces if ".py:" in replaces
                             else TPU_KERNEL + replaces),
                "launches": launches, "max_abs_err": max_abs,
                "ms": k_us / 1000.0, "plain_ms": p_us / 1000.0,
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_us / 1000.0}

    def probe_entry(name, tpu, key):
        ms, plain_ms, b_ms, b_by, max_abs, lib_ms = probe_times[key]
        source = ("probes/cast_test.py:16" if tpu == "P12"
                  else fpp.PROBES[tpu].source)
        return {"name": name, "route": "cuda",
                "source": CSRC + "fused_psd_probe.cu", "replaces": source,
                "launches": probe_launches[tpu], "max_abs_err": max_abs,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms}

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
        entry("fused_psd_large", "fused_psd_large.cu",
              "probes/big_kernel.py:113", large_launches, large_abs[None],
              ("L", C3_N, 8, None)),
        entry("fused_psd_large (windowed)", "fused_psd_large.cu", "261",
              large_w_launches, large_abs["hann"],
              ("L", 65536, 16, "hann")),
    ] + [probe_entry(name, tpu, key)
         for name, tpu, key in (("fused_psd_probe P1 (profile_kernel: full)",
                                 "P1", "k3"),
                                ("fused_psd_probe P18 (s1_lanes: full)",
                                 "P18", "tpu6"),
                                ("fused_psd_probe P13 (s1_lanes2: i32tr)",
                                 "P13", "tpu6_wide32"),
                                ("relayout_probe P12 (cast_test: C control)",
                                 "P12", "C"),
                                ("fused_psd_probe P14 (s2_fourmult: v7)",
                                 "P14", "tpu6_4mult"),
                                ("fused_psd_probe P16 (s2_left: e2left)",
                                 "P16", "tpu6_e2left"),
                                ("fused_psd_probe P19 (s2_ilv: ilv)",
                                 "P19", "tpu6_ilv2"),
                                ("fused_psd_probe P11 (s2_pipe: pipe)",
                                 "P11", "tpu6_pipe"),
                                ("fused_psd_probe P17 (s2_u32t: u32t)",
                                 "P17", "tpu6_u32t"),
                                ("fused_psd_probe P2 (profile_kernel: pack8)",
                                 "P2", "k3_pack"),
                                ("fused_psd_probe P6 (profile_kernel: "
                                 "pack8c)", "P6", "k3_pack_pq"),
                                ("fused_psd_probe P5 (profile_kernel: "
                                 "s1wide)", "P5", "k3_s1wide"),
                                ("fused_psd_probe P3 (profile_kernel: "
                                 "dg3dall)", "P3", "k3_dg3dall"),
                                ("fused_psd_probe P4 (profile_kernel: "
                                 "s1cat)", "P4", "k3_s1cat"),
                                ("fused_psd_probe P7 (profile_kernel: "
                                 "s1k32)", "P7", "k3_s1k32"),
                                ("fused_psd_probe P8 (profile_kernel: "
                                 "best)", "P8", "k3_best"),
                                ("fused_psd_probe P9 (profile_kernel: "
                                 "v5left)", "P9", "k3_left"),
                                ("fused_psd_probe P10 (profile_kernel: "
                                 "v6k)", "P10", "tpu6_kstack"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
