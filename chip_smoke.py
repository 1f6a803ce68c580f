"""Smoke run of rtl_power_fftw_tpu_torch on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):

1. machine: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles the CUDA kernel from ``ops/kernels/csrc`` with nvcc;
3. kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it and at N = 256, 2048, 16384, with a masked
   ``n_valid`` case, against a float64 transcription of
   ``tests/golden.py:golden_accumulate``, and under 35 dB tones against
   the scipy float32 FFT (the FFTW-class error budget);
4. times of the kernel and the plain version with CUDA events;
5. end to end: ``cli.main`` in-process on the canonical 2048-bin,
   20,000-spectrum drive (linear output, so the six printed digits carry
   the 1e-5 comparison with the float64 golden) and on a hopping matrix
   drive with a dead hop. The kernel's launch counter is reset just
   before the canonical drive and must be > 0 after it, the plain
   version's must stay 0.

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

KERNEL_SOURCE = "rtl_power_fftw_tpu_torch/ops/kernels/csrc/fused_psd.cu"
REPLACES = "rtl_power_fftw_tpu/ops/kernels/fused_psd.py:435"
UNIFORM_RTOL = 1e-5
GOLDEN_RTOL = 1e-5


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


def golden_partial(raw: np.ndarray, n_valid: int) -> np.ndarray:
    """float64 transcription of tests/golden.py:golden_accumulate over the
    first ``n_valid`` frames, returned in unshifted bin order (the
    reference's (-1)^n flip pre-shifts; ifftshift undoes it)."""
    N = raw.shape[1] // 2
    flip = np.where(np.arange(N) % 2 == 0, 1.0, -1.0)
    pwr = np.zeros(N, np.float64)
    for lo in range(0, n_valid, 1024):
        part = raw[lo:min(lo + 1024, n_valid)].astype(np.float64)
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


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing was run.")
        return 1

    from rtl_power_fftw_tpu_torch import cli
    from rtl_power_fftw_tpu_torch.ops.kernels import _build
    from rtl_power_fftw_tpu_torch.ops.kernels.fused_psd import (
        COUNTS, fused_psd, fused_psd_reference)
    from rtl_power_fftw_tpu_torch.ops.spectral import adapt_batch

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
    info = _build.build()
    _build.load()
    log(info.log.strip())
    print(f"build: {info.path.name} by nvcc in {info.seconds:.1f} s")

    # 3. Kernel against the plain version (and the float64 golden).
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
    import scipy.fft
    N, F = 2048, 64
    ours, plain, yard = [], [], []
    for seed in range(12):
        raw_np = tone_frames(N, F, 500 + seed)
        gold = golden_partial(raw_np, F)
        raw = torch.from_numpy(raw_np).to(dev)
        ours.append(max_rel(fused_psd(raw, F, 64).cpu().numpy(), gold))
        plain.append(max_rel(fused_psd_reference(raw, F, 64).cpu().numpy(),
                             gold))
        z32 = ((raw_np[:, 0::2].astype(np.float32) - 127)
               + 1j * (raw_np[:, 1::2].astype(np.float32) - 127))
        Xc = scipy.fft.fft(z32.astype(np.complex64), axis=1)
        yard.append(max_rel((Xc.real.astype(np.float64) ** 2
                             + Xc.imag.astype(np.float64) ** 2).sum(0),
                            gold))
    med_ratio = statistics.median(ours) / statistics.median(yard)
    max_ratio = max(ours) / max(yard)
    print(f"kernel 35 dB tone N={N} F={F}, 12 seeds: max rel median "
          f"{statistics.median(ours):.3e} / max {max(ours):.3e}; scipy f32 "
          f"{statistics.median(yard):.3e} / {max(yard):.3e}; plain (cuFFT) "
          f"{statistics.median(plain):.3e} / {max(plain):.3e}; ratios "
          f"median {med_ratio:.2f}x, max {max_ratio:.2f}x")
    check(med_ratio <= 1.5 and max_ratio <= 3.0,
          "tone error above the FFTW-class budget")

    # 4. Times (median of 60 event-timed calls after 10 warm-ups).
    times = {}
    for fps in (4096, 400):
        F, chunk = adapt_batch(fps)
        N = 2048
        raw = torch.from_numpy(
            rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)).to(dev)
        k_us = event_times_us(lambda: fused_psd(raw, F, chunk))
        p_us = event_times_us(lambda: fused_psd_reference(raw, F, chunk))
        k_us2 = event_times_us(lambda: fused_psd(raw, F, chunk))
        times[F] = (k_us, p_us, k_us2)
        print(f"time N={N} F={F} on {card}: kernel {k_us:.1f} us/step "
              f"({F * N / k_us / 1e3:.2f} GS/s; repeat {k_us2:.1f} us), "
              f"plain {p_us:.1f} us/step ({F * N / p_us / 1e3:.2f} GS/s)")

    # 5. End to end, in-process through the CLI.
    with tempfile.TemporaryDirectory() as tmp:
        record = os.path.join(tmp, "canonical.iq")
        N, repeats, rate = 2048, 20000, 2_000_000
        argv = ["-f", "100M", "-n", str(repeats), "-b", str(N), "-l",
                "--record", record,
                "--source", "synthetic:tone=100.2M/35,noise=6,seed=1"]
        COUNTS.reset()
        rc, out, err, wall = run_cli(argv, cli.main)
        launches, plain_calls = COUNTS.kernel, COUNTS.plain
        log(err[-1500:])
        check(rc == 0, f"canonical drive exited {rc}")
        check("Transform path: cuda" in err, "canonical drive off the kernel")
        rows = [line.split() for line in out.splitlines()
                if line and not line.startswith("#")]
        freqs = np.array([float(f) for f, _ in rows])
        vals = np.array([float(v) for _, v in rows])
        check(len(vals) == N and np.all(np.isfinite(vals)),
              "canonical drive: malformed spectrum")
        peak = freqs[int(np.argmax(vals))]
        check(abs(peak - 100.2e6) <= rate / N,
              f"canonical drive: peak at {peak} Hz")
        stream = np.fromfile(record, dtype=np.uint8)
        check(len(stream) == 2 * N * repeats, "recorded stream length")
        gold = golden_finalize_linear(
            np.fft.fftshift(golden_partial(stream.reshape(repeats, 2 * N),
                                           repeats)), repeats, rate)
        err_gold = max_rel(vals, gold)
        print(f"e2e canonical drive ({' '.join(argv)}): exit 0 in "
              f"{wall:.2f} s wall; peak {peak / 1e6:.4f} MHz; max rel vs "
              f"float64 golden {err_gold:.3e}; kernel launches {launches}, "
              f"plain calls {plain_calls}")
        check(err_gold <= GOLDEN_RTOL, "canonical drive vs golden")
        check(launches > 0 and plain_calls == 0,
              "canonical drive did not run through the kernel")

        scan = os.path.join(tmp, "scan")
        argv = ["-f", "100M:106M", "-n", "16", "-b", "256", "-q", "-m", scan,
                "--source", "synthetic:tone=104.9M/40,noise=5,seed=2,"
                "dead=103M"]
        COUNTS.reset()
        rc, out, err, wall = run_cli(argv, cli.main)
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
        peak = 105e6 + (int(np.argmax(data)) % 256 - 128) * rate / 256
        check(hop == 1 and abs(peak - 104.9e6) <= rate / 256,
              f"scan drive: peak at {peak} Hz in hop {hop}")
        check(COUNTS.kernel > 0 and COUNTS.plain == 0,
              "scan drive did not run through the kernel")
        print(f"e2e scan drive: exit 0 in {wall:.2f} s wall; dead hop "
              f"dropped; .met {cols}x{nrows}, .bin {data.nbytes} bytes; "
              f"peak {peak / 1e6:.4f} MHz; kernel launches {COUNTS.kernel}")

    check(not any(m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes")
                  for m in sys.modules), "jax was imported")

    k_us, p_us, _ = times[4096]
    print(json.dumps({"kernels": [{
        "name": "fused_psd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max_abs_2048, "ms": k_us / 1000.0,
        "plain_ms": p_us / 1000.0}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
