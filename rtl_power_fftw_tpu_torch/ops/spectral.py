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
from .kernels.fused_psd import MAX_N as REGS_MAX_N
from .kernels.fused_psd import MIN_N, fused_psd, fused_psd_eligible
from .kernels.fused_psd_bluestein import (fused_psd_bluestein,
                                          fused_psd_bluestein_eligible)
from .kernels.fused_psd_chirp_large import MAX_N as CHIRP_LARGE_MAX_N
from .kernels.fused_psd_chirp_large import (fused_psd_chirp_large,
                                            fused_psd_chirp_large_eligible)
from .kernels.fused_psd_chirp_large_est import \
    fused_psd_chirp_large_est_eligible
from .kernels.fused_psd_fast import fused_psd_fast, fused_psd_fast_eligible
from .kernels.fused_psd_large import (MAX_N, fused_psd_large,
                                      fused_psd_large_eligible)
from .kernels.fused_psd_large_est import fused_psd_large_est_eligible
from .kernels.fused_psd_mixed import fused_psd_mixed, fused_psd_mixed_eligible
from .kernels.fused_psd_mixed_large import (fused_psd_mixed_large,
                                            fused_psd_mixed_large_eligible)
from .kernels.fused_psd_mixed_large_est import \
    fused_psd_mixed_large_est_eligible

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


#: The kernels a step may run, by :func:`transform_route`: K1/K2
#: (``fused_psd``), K3 (``fused_psd_fast``), the large-N kernel, the
#: mixed-radix kernel, the chirp-Z kernel and their large forms (ML, BL);
#: each route's path names the kernel on the card ("cuda" + suffix) or its
#: plain version on the CPU ("plain" + suffix).
ROUTES = {"regs": (fused_psd, ""), "fast": (fused_psd_fast, "_fast"),
          "large": (fused_psd_large, "_large"),
          "mixed": (fused_psd_mixed, "_mixed"),
          "bluestein": (fused_psd_bluestein, "_bluestein"),
          "mixed_large": (fused_psd_mixed_large, "_mixed_large"),
          "chirp_large": (fused_psd_chirp_large, "_chirp_large")}


def _unported(what: str) -> RPFexception:
    return RPFexception(f"Not yet ported to the PyTorch/CUDA package: {what}."
                        " Exiting.", ReturnValue.InvalidArgument)


def transform_route(N: int, backend: str = "auto", fast: bool = False
                    ) -> str:
    """The kernel a step of ``N`` bins runs with ``--fft-backend
    backend`` (at ``--precision high`` when ``fast``): "regs" (K1/K2,
    powers of two 64..16384), "fast" (K3, powers of two 256..16384 at
    relaxed precision), "large" (powers of two 32768..2^22), "mixed" (the
    mixed-radix kernel: every other even 7-smooth N up to 16384, 2..32
    among them), "bluestein" (the chirp-Z kernel: every other even N up
    to 8192, and any even N up to 8192 under ``--fft-backend
    bluestein``), "mixed_large" (ML: every even 7-smooth N from 16386 to
    2^22 that is not a power of two) or "chirp_large" (BL: every other
    even N from 8194 to 2^21, and any even N there under ``--fft-backend
    bluestein``). ``auto`` and ``pallas`` route alike, but for
    ``--precision high``: above the tensor-core step's sizes it runs the
    large-N kernel at full precision under ``auto`` (as the JAX package's
    own ladder does there), not under ``pallas``; at the N only the
    mixed-radix and chirp-Z kernels take, it runs them at full precision.
    Raises RPFexception(InvalidArgument), "Not yet ported", for every
    other case. PsdStep and ShardedPsdStep read this one function."""
    if backend == "bluestein":
        if fused_psd_bluestein_eligible(N):
            return "bluestein"
        if fused_psd_chirp_large_eligible(N):
            return "chirp_large"
        raise _unported(f"--fft-backend bluestein at {N} bins (the chirp-Z "
                        f"steps take even N up to {CHIRP_LARGE_MAX_N})")
    if backend not in ("auto", "pallas"):
        raise _unported(f"--fft-backend {backend}")
    if fused_psd_eligible(N) or fused_psd_large_eligible(N):
        route = "regs" if fused_psd_eligible(N) else "large"
        if not fast:
            return route
        if fused_psd_fast_eligible(N):
            return "fast"
        if route == "large" and backend == "auto":
            return route
        raise _unported(f"--precision high at {N} bins with --fft-backend "
                        f"{backend} (the tensor-core step takes powers of "
                        "two from 256 to 16384)")
    for route, eligible in (("mixed", fused_psd_mixed_eligible),
                            ("bluestein", fused_psd_bluestein_eligible),
                            ("mixed_large", fused_psd_mixed_large_eligible),
                            ("chirp_large", fused_psd_chirp_large_eligible)):
        if eligible(N):
            return route
    raise _unported(f"{N} bins (the CUDA steps take powers of two from "
                    f"{MIN_N} to {MAX_N}, even 7-smooth N up to {MAX_N} "
                    f"and other even N up to {CHIRP_LARGE_MAX_N})")


#: ``--fft-backend`` names under which the spectral-kurtosis step runs its
#: kernel at its N: the JAX package's SK step runs its auto per-frame
#: transform for each of them (its config warns of the fused ones). Under
#: ``bluestein`` it runs the chirp-Z transform, and so does the port's
#: (:func:`estimator_route`).
SK_BACKENDS = ("auto", "pallas", "hybrid", "fft4")


#: The session's estimator options: on one stream and over ``--streams``
#: they take every even N up to 2^21 and every even 7-smooth N up to 2^22:
#: the powers of two up to 16384 on K1's variants, those above on the
#: estimators' forms of the large kernel's passes
#: (``kernels/csrc/fused_psd_large_est.cu``), the other even 7-smooth N
#: above 16384 on their forms of ML's passes
#: (``kernels/csrc/fused_psd_mixed_large_est.cu``), and the other N on
#: their forms of the mixed-radix kernel, of the chirp-Z kernel and of BL's
#: passes (``kernels/csrc/fused_psd_mixed_est.cu``,
#: ``kernels/csrc/fused_psd_chirp_est.cu``,
#: ``kernels/csrc/fused_psd_chirp_large_est.cu``), each form with S >= 1
#: streams: every N the PSD step takes. The even N in (2^21, 2^22] with a
#: prime factor above 7 (4194302), N above 2^22 and odd N exit 3, as the
#: PSD step does there.
CLI_ESTIMATORS = ("--sk-file", "--sk-excise", "--multitaper", "--pfb-taps")

#: What the session's estimators take, as their exit-3 messages state it.
_EST_RANGE = (f"the estimator kernels take every even N up to "
              f"{CHIRP_LARGE_MAX_N} and every even 7-smooth N up to "
              f"{MAX_N}; not the other even N above {CHIRP_LARGE_MAX_N}, "
              "nor odd N")


def estimator_route(N: int, flag: str, backend: str = "auto",
                    sharded: bool = False) -> str:
    """The kernel family of the estimator of ``flag`` at N bins, on one
    stream or over streams (``sharded``: the ``--streams`` steps, each
    family's streams form): "regs" (variants of K1's group kernel, the
    powers of two from 64 to 16384), "mixed" (the session's estimators,
    :data:`CLI_ESTIMATORS`, at the other even 7-smooth N up to 16384:
    forms of the mixed-radix kernel), "bluestein" (the same at the other
    even N up to 8192: forms of the chirp-Z kernel), "large" (the same at
    the powers of two from 32768 to 2^22: forms of the large kernel's two
    passes), "mixed_large" (the same at the even 7-smooth N from 16386 to
    2^22 that are not powers of two, 20000, 49152, 100000 and 10^6 among
    them: forms of ML's two passes) or "chirp_large" (the same at the even
    N from 8194 to 2^21 with a prime factor above 7, 9998, 16382, 20002 and
    99998 among them: forms of BL's three passes). The spectral-kurtosis
    step under ``--fft-backend bluestein`` runs the chirp-Z forms at any
    even N up to 2^21, as the PSD step takes that name: "bluestein" up to
    8192, "chirp_large" above. Raise RPFexception(InvalidArgument), "Not
    yet ported", anywhere else: the library-only estimators (``flag`` their
    names) at other N, and the session's where the PSD step exits 3 too,
    at the even N above 2^21 with a prime factor above 7 (4194302), above
    2^22 and at odd N. The spectral-kurtosis step also takes
    only the ``--fft-backend`` names of :data:`SK_BACKENDS` and
    ``bluestein`` (the other two estimators ignore the option, as the JAX
    package's do). The same check and message on the CPU and on the
    card."""
    session = flag in CLI_ESTIMATORS
    over = " over --streams" if sharded else ""
    if session and flag.startswith("--sk") and backend == "bluestein":
        if fused_psd_bluestein_eligible(N):
            return "bluestein"
        if fused_psd_chirp_large_est_eligible(N):
            return "chirp_large"
        raise _unported(f"{flag}{over} with --fft-backend bluestein at "
                        f"{N} bins (the chirp-Z estimator kernels take "
                        f"even N up to {CHIRP_LARGE_MAX_N})")
    if fused_psd_eligible(N):
        route = "regs"
    elif session and fused_psd_mixed_eligible(N):
        route = "mixed"
    elif session and fused_psd_bluestein_eligible(N):
        route = "bluestein"
    elif session and fused_psd_large_est_eligible(N):
        route = "large"
    elif session and fused_psd_mixed_large_est_eligible(N):
        route = "mixed_large"
    elif session and fused_psd_chirp_large_est_eligible(N):
        route = "chirp_large"
    elif session:
        raise _unported(f"{flag}{over} at {N} bins ({_EST_RANGE})")
    else:
        raise _unported(f"{flag} at {N} bins (the estimator kernels take "
                        f"powers of two from {MIN_N} to {REGS_MAX_N})")
    if flag.startswith("--sk") and backend not in SK_BACKENDS:
        raise _unported(f"{flag}{over} with --fft-backend {backend}")
    return route


class PsdStep:
    """A device step: (F, 2N) u8 frames -> (N,) f32 partial power sum.

    ``n_valid`` masks out padding rows so the step shape never changes.
    On a CUDA device the step is a hand-written kernel, by
    :func:`transform_route`: up to 16384 bins, at the default precision
    ``kernels/csrc/fused_psd.cu`` (K1, or K2 with a window) and at
    ``precision="high"`` the tensor-core kernel
    ``kernels/csrc/fused_psd_fast.cu`` (K3), windowed or not; from 32768
    to 2^22 bins the two-pass four-step ``kernels/csrc/fused_psd_large.cu``
    at full precision, windowed or not; at the other even 7-smooth N up
    to 16384 the mixed-radix kernel and at every other even N up to 8192
    the chirp-Z kernel, both of ``kernels/csrc/fused_psd_mixed.cu``; at
    the other even 7-smooth N up to 2^22 the four-step mixed-radix kernel
    ML (``kernels/csrc/fused_psd_mixed_large.cu``) and at every other even
    N up to 2^21 the three-pass chirp-Z kernel BL
    (``kernels/csrc/fused_psd_chirp_large.cu``); each at full precision,
    windowed or not. On a CUDA device it runs the kernel; only for CPU
    tensors does it run the kernel's plain PyTorch version.
    The result is a tensor on ``device``; on CUDA it is computed
    asynchronously on the current stream. The window is copied to the
    device once, here.
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
        route = transform_route(N, backend, fast)
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
        if fast and route != "fast":
            # The JAX package's CPU ladder says the same of its FFT
            # four-step rung above 16384 (ops/spectral.py there).
            kind = {"large": "FFT four-step", "mixed": "mixed-radix FFT",
                    "bluestein": "chirp-Z FFT",
                    "mixed_large": "FFT four-step",
                    "chirp_large": "chirp-Z FFT"}[route]
            print(f"Note: --precision high is a no-op on the {kind} path "
                  f"selected here (backend={backend}, N={N}): its FFT "
                  "stages have no matmul precision knob.", file=sys.stderr)
        #: "cuda", "cuda_fast", "cuda_large", "cuda_mixed",
        #: "cuda_bluestein", "cuda_mixed_large" or "cuda_chirp_large" (the
        #: hand-written kernel of the route), or "plain" + the same suffix
        #: (its PyTorch version, on the CPU).
        self._kernel, suffix = ROUTES[route]
        self.path = ("cuda" if self.device.type == "cuda" else "plain") + \
            suffix
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
