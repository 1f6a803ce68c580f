"""The spectral core on PyTorch: host helpers and the device step.

The host helpers are copies of those in ``rtl_power_fftw_tpu/ops/spectral.py``
(that module imports jax); tests pin each to the original. The semantics
they preserve from the reference are described there: (u8 - 127)
dequantization, unshifted accumulation with one fftshift at finalization,
frames carried across buffers, f32 two-stage sums on the device and
float64 accumulation on the host.
"""

from __future__ import annotations

import sys
from typing import Optional, Tuple

import numpy as np
import torch

from ..exceptions import ReturnValue, RPFexception
from .kernels.fused_psd import MIN_N, fused_psd, fused_psd_eligible
from .kernels.fused_psd_fast import fused_psd_fast, fused_psd_fast_eligible
from .kernels.fused_psd_large import (MAX_N, fused_psd_large,
                                      fused_psd_large_eligible)

# Frames are reduced in chunks of this size before the cross-chunk sum;
# two-stage summation keeps f32 rounding error at ~(CHUNK + F/CHUNK)·ε.
_SUM_CHUNK = 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def adapt_batch(frames_per_step: int) -> Tuple[int, int]:
    """Shared frame-batch sizing: (F, chunk) with F rounded to a multiple
    of 8 and chunk the largest power-of-two divisor ≤ _SUM_CHUNK — the
    two-stage-tree-sum invariant every device step relies on."""
    F = _round_up(max(int(frames_per_step), 1), 8)
    chunk = _SUM_CHUNK
    while F % chunk != 0:
        chunk //= 2
    return F, chunk


def pad_frames(batch: np.ndarray, F: int) -> np.ndarray:
    """Zero-pad a (n, 2N) frame batch up to the step's fixed (F, 2N)."""
    n = len(batch)
    if n >= F:
        return batch
    return np.concatenate(
        [batch, np.zeros((F - n, batch.shape[1]), np.uint8)])


def check_step_ported(N: int, backend: str, fast: bool = False) -> None:
    """Raise RPFexception(InvalidArgument) unless a CUDA step of this
    package takes ``N`` bins with ``backend`` (at relaxed precision when
    ``fast``). Above the tensor-core step's sizes ``--precision high`` runs
    the large-N kernel at full precision, as the JAX package's own ladder
    does there, but not under an explicit ``--fft-backend pallas``."""
    unported = None
    if backend not in ("auto", "pallas"):
        unported = f"--fft-backend {backend}"
    elif fast and not fused_psd_fast_eligible(N) and not (
            backend == "auto" and fused_psd_large_eligible(N)):
        unported = (f"--precision high at {N} bins with --fft-backend "
                    f"{backend} (the tensor-core step takes powers of two "
                    "from 256 to 16384)")
    elif not (fused_psd_eligible(N) or fused_psd_large_eligible(N)):
        unported = (f"{N} bins (the CUDA steps take powers of two "
                    f"from {MIN_N} to {MAX_N})")
    if unported is not None:
        raise RPFexception(
            f"Not yet ported to the PyTorch/CUDA package: {unported}. "
            "Exiting.", ReturnValue.InvalidArgument)


class PsdStep:
    """A device step: (F, 2N) u8 frames -> (N,) f32 partial power sum.

    ``n_valid`` masks out padding rows so the step shape never changes.
    On a CUDA device the step is a hand-written kernel: up to 16384 bins,
    at the default precision ``kernels/csrc/fused_psd.cu`` (K1, or K2 with
    a window) and at ``precision="high"`` the tensor-core kernel
    ``kernels/csrc/fused_psd_fast.cu`` (K3), windowed or not; from 32768
    to 2^22 bins the two-pass four-step ``kernels/csrc/fused_psd_large.cu``
    at full precision, windowed or not. On the CPU it is the kernel's plain
    PyTorch version. The result is a tensor on ``device``; on CUDA it is
    computed asynchronously on the current stream. The window is copied to
    the device once, here.
    """

    def __init__(self, N: int, frames_per_step: int, device,
                 window: Optional[np.ndarray] = None,
                 backend: str = "auto",
                 precision: str = "highest"):
        if N % 2 != 0:
            raise ValueError("N must be even")
        if precision not in ("highest", "high"):
            raise ValueError("precision must be 'highest' or 'high'")
        fast = precision == "high"
        check_step_ported(N, backend, fast)
        self.N = N
        self.F, self._chunk = adapt_batch(frames_per_step)
        self.device = torch.device(device)
        self.backend = backend
        self.window = None
        if window is not None:
            w = np.asarray(window, dtype=np.float32)
            if w.shape != (N,):
                raise ValueError(f"window must have shape ({N},), got "
                                 f"{w.shape}")
            self.window = torch.from_numpy(w.copy()).to(self.device)
        on_card = "cuda" if self.device.type == "cuda" else "plain"
        #: "cuda", "cuda_fast" or "cuda_large" (the hand-written kernel at
        #: default or relaxed precision, or the large-N one), "plain",
        #: "plain_fast" or "plain_large" (its PyTorch version, on the CPU).
        if fused_psd_large_eligible(N):
            if fast:
                # The JAX package's CPU ladder says the same of its FFT
                # four-step rung above 16384 (ops/spectral.py there).
                print("Note: --precision high is a no-op on the FFT "
                      f"four-step path selected here (backend={backend}, "
                      f"N={N}): its FFT stages have no matmul precision "
                      "knob.", file=sys.stderr)
            self._kernel = fused_psd_large
            self.path = on_card + "_large"
        else:
            self._kernel = fused_psd_fast if fast else fused_psd
            self.path = on_card + ("_fast" if fast else "")
        self.takes_u16 = False

    def __call__(self, raw, n_valid: int) -> torch.Tensor:
        """Run one step. ``raw`` is (F, 2N) u8 (padded): a tensor on the
        step's device, or a numpy array, which is copied there first."""
        if isinstance(raw, np.ndarray):
            raw = torch.from_numpy(np.ascontiguousarray(raw)).to(self.device)
        return self._kernel(raw, n_valid, self._chunk, self.window)


class FrameSlicer:
    """Splits an arbitrary byte stream into (F, 2N) u8 frame batches.

    Host-side replacement for the reference's carry of ``fft_pointer``
    across buffers (datastore.cxx:52,66-80): remainder bytes from one
    buffer prepend the next. Optionally frames overlap (Welch mode,
    an extension): ``hop_bytes`` < frame_bytes keeps a tail overlap.
    """

    def __init__(self, N: int, hop: Optional[int] = None):
        self.frame_bytes = 2 * N
        hop = N if hop is None else int(hop)
        if not (0 < hop):
            raise ValueError("hop must be positive")
        self.hop_bytes = 2 * hop
        self._carry = np.zeros(0, dtype=np.uint8)

    def reset(self) -> None:
        self._carry = np.zeros(0, dtype=np.uint8)

    def push(self, data: np.ndarray, max_frames: Optional[int] = None) -> np.ndarray:
        """Append bytes; return all complete frames as (n, 2N) u8.

        ``max_frames`` caps the frames produced (reference stops filling
        FFTs once ``repeats`` is reached, datastore.cxx:67 — remaining
        bytes are discarded by the caller simply by not pushing more).

        CONTRACT: on the aligned fast path the returned frames are a
        zero-copy VIEW of ``data`` — consume or copy them before reusing
        or mutating the input buffer. The internal carry is always an
        owned copy, never an alias of caller memory.
        """
        fb, hb = self.frame_bytes, self.hop_bytes
        if max_frames is not None and int(max_frames) <= 0:
            # The acquisition already has all the frames it will ever take
            # (datastore.cxx:67 stops at ``repeats``): discard instead of
            # growing the carry.
            self._carry = np.zeros(0, dtype=np.uint8)
            return np.zeros((0, fb), dtype=np.uint8)
        data = np.asarray(data, dtype=np.uint8).ravel()
        if len(self._carry):
            buf = np.concatenate([self._carry, data])
        else:
            buf = data  # aligned fast path: no copy of the whole buffer
        if len(buf) < fb:
            self._carry = np.array(buf, copy=True)
            return np.zeros((0, fb), dtype=np.uint8)
        n = 1 + (len(buf) - fb) // hb
        if max_frames is not None:
            n = min(n, int(max_frames))
        if hb == fb:
            flat = buf[:n * fb]
            frames = flat.reshape(n, fb)  # view, no copy
        else:
            idx = (np.arange(n)[:, None] * hb) + np.arange(fb)[None, :]
            frames = buf[idx]
        # Detach the (small) carry so it doesn't pin the whole buffer.
        self._carry = np.array(buf[n * hb:], copy=True)
        return frames


def bin_frequencies(tuned_freq: int, N: int, actual_samplerate: int) -> np.ndarray:
    """Per-bin frequency axis (acquisition.cxx:391):
    freq_i = tuned_freq + (i − N/2.0)·actual_samplerate/N, in float64."""
    i = np.arange(N, dtype=np.float64)
    return tuned_freq + (i - N / 2.0) * actual_samplerate / N


def finalize_psd(pwr: np.ndarray, repeats_done: int, actual_samplerate: int,
                 linear: bool = False,
                 baseline: Optional[np.ndarray] = None,
                 already_shifted: bool = False) -> np.ndarray:
    """Turn an accumulated (unshifted) power vector into output PSD values.

    Mirrors acquisition.cxx:376-399 in float64:
      fftshift → DC-bin interpolation → /repeats/N/rate → 10·log10 (unless
      linear) → baseline subtraction (baseline is in *output* units, i.e.
      subtracted after the dB conversion).
    Returns the per-bin values; the caller formats/writes them.
    """
    pwr = np.asarray(pwr, dtype=np.float64)
    N = pwr.shape[-1]
    shifted = pwr.copy() if already_shifted else np.fft.fftshift(pwr, axes=-1)
    # Interpolate the central point to cancel DC bias (acquisition.cxx:376-377).
    shifted[..., N // 2] = (shifted[..., N // 2 - 1] + shifted[..., N // 2 + 1]) / 2.0
    psd = shifted / repeats_done / N / actual_samplerate
    if not linear:
        with np.errstate(divide="ignore"):
            psd = 10.0 * np.log10(psd)
    if baseline is not None:
        psd = psd - np.asarray(baseline, dtype=np.float64)
    return psd
