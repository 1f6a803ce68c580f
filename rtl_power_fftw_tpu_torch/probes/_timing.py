"""What the probe entry points share: argument parsing, the frames (random
u8 IQ, or the TPU probes' 35 dB tone) and their float64 golden, and the
TPU probes' slope timing.

The timing is the probes' slope method (``probes/profile_pallas.py:
134-146``): CUDA events around ``ITER_LO`` and ``ITER_HI`` launches
chained on one stream, the least of ``REPS`` repetitions of each, and the
time per step = their difference / (ITER_HI - ITER_LO), which drops the
fixed cost of a call. GS/s = F·N / step.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.kernels import fused_psd_probe as fpp
from ..ops.spectral import adapt_batch

ITER_LO, ITER_HI, REPS = 32, 96, 3
#: The probes' step: F = 4096 frames of N = 2048 (profile_pallas.py:16).
FRAMES = 4096
#: The step of a ``--device cpu`` run, which times nothing: few frames, so
#: that the plain versions stay quick.
CPU_FRAMES = 16


def slope_us(launch: Callable[[int], object], lo: int = ITER_LO,
             hi: int = ITER_HI, reps: int = REPS) -> float:
    """Device µs per step of ``launch(iters)``, which enqueues ``iters``
    steps on the current stream."""
    launch(lo)
    torch.cuda.synchronize()

    def best(iters: int) -> float:
        t = float("inf")
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(iters)
            end.record()
            end.synchronize()
            t = min(t, start.elapsed_time(end))
        return t

    return 1000.0 * (best(hi) - best(lo)) / (hi - lo)


def parse(argv: Optional[Sequence[str]], prog: str, doc: str):
    p = argparse.ArgumentParser(prog=prog, description=doc)
    p.add_argument("variants", nargs="*", metavar="variant[:tile]")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the card (default) or the plain versions "
                        "on the CPU")
    return p.parse_args(argv)


def device_or_none(name: str) -> Optional[torch.device]:
    """The device to run on; None (after a message) when it is the card
    and there is none."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print("no CUDA device (use --device cpu for the plain versions)",
              file=sys.stderr)
        return None
    return torch.device("cuda", torch.cuda.current_device())


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu (plain versions, no device times)"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.splitlines()[dev.index or 0].strip()
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(dev)


def tone_frames(F: int, N: int) -> np.ndarray:
    """The TPU probes' tone input (``probes/s2_fourmult.py:150-163``):
    a 35 dB tone at 0.1303 of the sample rate, amplitude 100 over unit
    complex noise, quantized to u8 IQ; (F, 2N) uint8."""
    rng = np.random.default_rng(0)
    t = np.arange(F * N)
    x = 100.0 * np.exp(2j * np.pi * 0.1303 * t) + (
        rng.standard_normal(F * N) + 1j * rng.standard_normal(F * N))
    re = np.clip(np.round(x.real + 127), 0, 255).astype(np.uint8)
    im = np.clip(np.round(x.imag + 127), 0, 255).astype(np.uint8)
    return np.stack([re, im], axis=-1).reshape(F, 2 * N)


def split_specs(specs: Iterable[str]) -> List[Tuple[str, Optional[int]]]:
    """"name[:tile]" -> (name, tile or None)."""
    out = []
    for spec in specs:
        name, _, tile = spec.partition(":")
        out.append((name, int(tile) if tile else None))
    return out


def run_probe(tpu: str, argv: Optional[Sequence[str]] = None) -> int:
    """The entry point of TPU probe ``tpu`` (a key of ``fpp.PROBES``):
    each variant once against the float64 golden where its output is a
    spectrum, then its slope time on the card. It also takes the variant
    names of the other probes of its module (``fpp.entry_variants``), each
    run under its own probe's header. A probe that takes ``tone`` (as its
    TPU probe does) then runs on the tone input."""
    probe = fpp.PROBES[tpu]
    args = parse(argv, f"python -m rtl_power_fftw_tpu_torch.probes."
                       f"{probe.module}",
                 f"{tpu} ({probe.source}) on the port's kernels"
                 + (" ('tone': on the TPU probe's 35 dB tone)"
                    if probe.tone else ""))
    tone = probe.tone and "tone" in args.variants
    try:
        specs = split_specs([a for a in args.variants
                             if not (tone and a == "tone")])
    except ValueError as e:
        print(f"bad variant[:tile]: {e}", file=sys.stderr)
        return 2
    known = [name for p in fpp.entry_probes(tpu) for name in p.variants]
    unknown = [name for name, _ in specs if name not in known]
    if unknown:
        print(f"unknown {tpu} variant(s) {', '.join(unknown)}; known: "
              f"{', '.join(known)}"
              + (" (and 'tone')" if probe.tone else ""), file=sys.stderr)
        return 2
    runs = fpp.entry_variants(tpu, [name for name, _ in specs])
    tiles = [tile for _, tile in specs] or [None] * len(runs)
    dev = device_or_none(args.device)
    if dev is None:
        return 1
    F, chunk = adapt_batch(FRAMES if dev.type == "cuda" else CPU_FRAMES)
    try:
        groups = [fpp.block_frames(p.variants[name], F, chunk, tile)
                  for (p, name), tile in zip(runs, tiles)]
    except ValueError as e:
        print(f"bad variant[:tile]: {e}", file=sys.stderr)
        return 2
    if tone:
        raw_np = tone_frames(F, fpp.N)
    else:
        raw_np = np.random.default_rng(0).integers(0, 256, (F, 2 * fpp.N),
                                                   dtype=np.uint8)
    raw = torch.from_numpy(raw_np).to(dev)
    z = torch.complex(raw[:, 0::2].double() - 127.0,
                      raw[:, 1::2].double() - 127.0)
    X = torch.fft.fft(z, dim=1)
    gold = (X.real ** 2 + X.imag ** 2).sum(0)
    head = None
    for (p, name), group in zip(runs, groups):
        if p is not head:
            head = p
            print(f"# {p.tpu} ({p.source}) on {card(dev)}: N = {fpp.N} "
                  f"(N1 x N2 = {fpp.N1} x {fpp.N2}), F = {F}, chunk {chunk}"
                  + (", 35 dB tone" if tone else ""))
        v = fpp.VARIANTS[p.variants[name]]
        got = fpp.fused_psd_probe(v.name, raw, F, chunk, group=group)
        if v.psd:
            rel = ((got.double() - gold).abs() / gold.abs().clamp_min(1e-30))
            parity = f"max_rel={float(rel.max()):.2e}"
        else:
            parity = "(timing only)"
        if dev.type == "cuda":
            per = slope_us(lambda it: fpp.fused_psd_probe(
                v.name, raw, F, chunk, group=group, iters=it))
            timing = f"per-step {per:8.1f} us  {F * fpp.N / per / 1e3:7.3f} GS/s"
        else:
            timing = "per-step not measured (cpu)"
        print(f"{name:9s} tile={group:3d} {timing}  {parity}  [{v.name}]",
              flush=True)
    return 0
