"""Chirp-Z (Bluestein) fused PSD step: raw u8 IQ frames -> (N,) f32
partial power sum, at any even N up to 8192.

Replaces ``rtl_power_fftw_tpu/ops/dft.py:bluestein_psd_partial`` (the JAX
package's chirp-Z rung, run through XLA's FFT, no Pallas kernel) with a
CUDA C++ kernel written for Hopper: the chirp-Z instantiation of the
awkward-N template (``csrc/fused_psd_mixed.cuh``), in the library of
``csrc/fused_psd_mixed.cu`` and launched by
:func:`.fused_psd_mixed.launch`. It computes the function of
:func:`fused_psd <.fused_psd.fused_psd>` (dequantize, [window,] length-N
DFT, |X|^2, mask, sum over frames, bins in natural order) with the N-point
DFT as one circular convolution of length M = next_pow2(2N - 1) <= 16384:

    X[k] = a[k] * IFFT_M(FFT_M(x * a) * B)[k],  a[n] = e^(-i pi n^2 / N),
    B = FFT_M(v),  v[m] = conj(a[|m|]) for |m| < N laid out circularly,

with the tables of :func:`bluestein_constants` (the JAX package's
``_bluestein_constants`` in natural order: built in float64 with exact
integer angle reduction and rounded once to complex64). The kernel's
transforms are the register passes of ``csrc/fft_mixed.cuh`` over M's
pow-2 plan (:func:`bluestein_plan`); its tables are B / M permuted into
the forward transform's output order (:func:`spectrum_table`) and a
(:func:`chirp_table`); a window multiplies the samples before the chirp,
as in ``bluestein_psd_partial``. :func:`fused_psd_bluestein_streams` does
it for S streams at once, as K4 does.

:func:`fused_psd_bluestein` and :func:`fused_psd_bluestein_streams`
dispatch on the tensor's device: a CPU tensor goes to the plain PyTorch
version (:func:`bluestein_psd_reference`, the same chirp-Z algorithm in
torch ops); a CUDA tensor goes to the kernel, or raises.
``COUNTS.kernel_bluestein`` and ``COUNTS.kernel_bluestein_streams`` (in
:mod:`.fused_psd`) count its launches.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .fused_psd import COUNTS, _on_cuda, check_args, check_streams_args
from .fused_psd_mixed import (MixedLaunch, element_of_bin, launch,
                              launch_shape, mixed_plan)

#: Largest N the kernel takes: M = next_pow2(2N - 1) <= 16384, whose
#: padded complex frame (139 KB) and N-float accumulator fit the 227 KB
#: of shared memory a Hopper block may use.
MAX_N = 8192


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, n - 1).bit_length()


def fused_psd_bluestein_eligible(N: int) -> bool:
    """True iff the kernel takes N bins: even, 2..8192."""
    return 2 <= N <= MAX_N and N % 2 == 0


def _chirp64(N: int) -> np.ndarray:
    """a[n] = e^(-i pi n^2 / N), n < N, in float64, the angle reduced
    exactly (n^2 mod 2N in int64)."""
    n = np.arange(N, dtype=np.int64)
    ang = -np.pi * ((n * n) % (2 * N)).astype(np.float64) / N
    return np.cos(ang) + 1j * np.sin(ang)


@functools.lru_cache(maxsize=8)
def bluestein_constants(N: int) -> Tuple[int, np.ndarray, np.ndarray]:
    """(M, a, B): M = next_pow2(2N - 1), the chirp a[n] = e^(-i pi n^2 / N)
    (N,) complex64, and B = FFT_M(v) (M,) complex64 in natural order, v
    the conjugate chirp laid out circularly (v[m] = conj(a[m]) and
    v[M - m] = conj(a[m]), 0 < m < N). Built in float64 with exact integer
    angle reduction (n^2 mod 2N in int64) and rounded once, as
    ``rtl_power_fftw_tpu/ops/dft.py:_bluestein_constants`` builds them
    (which holds B in its four-step layout)."""
    M = next_pow2(2 * N - 1)
    a = _chirp64(N)
    v = np.zeros(M, np.complex128)
    v[:N] = np.conj(a)
    v[M - N + 1:] = np.conj(a[1:][::-1])
    B = np.fft.fft(v)
    return M, a.astype(np.complex64), B.astype(np.complex64)


def bluestein_plan(N: int) -> Tuple[int, ...]:
    """The pow-2 plan of M's transforms: :func:`.fused_psd_mixed.mixed_plan`
    of M, its one pass split in two where it has one (M <= 16), since the
    turn between the transforms is the last pass's butterfly."""
    M = next_pow2(2 * N - 1)
    plan = mixed_plan(M)
    if len(plan) == 1:
        plan = {4: (2, 2), 8: (4, 2), 16: (4, 4)}[M]
    return plan


def spectrum_table(N: int) -> np.ndarray:
    """B / M as (M, 2) float32 (re, im) in the forward transform's output
    order: row q holds the bin :func:`.fused_psd_mixed.element_of_bin`
    puts at element q. (M is a power of two, so B / M rounds nothing.)"""
    M, _, B = bluestein_constants(N)
    plan = bluestein_plan(N)
    order = np.empty(M, np.int64)
    order[element_of_bin(plan, np.arange(M))] = np.arange(M)
    S = (B[order] / np.float32(M)).astype(np.complex64)
    return np.stack([S.real, S.imag], -1).astype(np.float32)


def chirp_table(N: int) -> np.ndarray:
    """The kernel's chirp a, (N, 2) float32 (re, im)."""
    a = bluestein_constants(N)[1]
    return np.stack([a.real, a.imag], -1).astype(np.float32)


@functools.lru_cache(maxsize=64)
def bluestein_launch(N: int) -> MixedLaunch:
    """The kernel's block layout at N: M's plan, N bins summed."""
    return launch_shape(bluestein_plan(N), N)


def _power(raw_u8: torch.Tensor,
           window: Optional[torch.Tensor]) -> torch.Tensor:
    """|DFT|^2 of every frame by the chirp-Z algorithm in torch ops:
    (..., 2N) uint8 -> (..., N) float32."""
    N = raw_u8.shape[-1] // 2
    M, a_np, B_np = bluestein_constants(N)
    a = torch.from_numpy(a_np).to(raw_u8.device)
    B = torch.from_numpy(B_np).to(raw_u8.device)
    v = raw_u8.reshape(*raw_u8.shape[:-1], N, 2).to(torch.int32)
    re = (v[..., 0] - 127).to(torch.float32)
    im = (v[..., 1] - 127).to(torch.float32)
    if window is not None:
        re = re * window
        im = im * window
    u = torch.complex(re, im) * a
    y = torch.fft.ifft(torch.fft.fft(u, n=M, dim=-1) * B, dim=-1)
    X = y[..., :N] * a
    return X.real * X.real + X.imag * X.imag


def bluestein_psd_reference(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                            window: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The plain PyTorch version: (F, 2N) uint8 -> (N,) float32, the
    chirp-Z algorithm of ``bluestein_psd_partial`` (dequantize, [window in
    float32,] times a, FFT_M, times B, IFFT_M, times a, |.|^2, frames f >=
    n_valid dropped, a two-stage sum)."""
    F, two_n = raw_u8.shape
    N = two_n // 2
    pwr = _power(raw_u8, window)
    pwr[n_valid:] = 0.0
    return pwr.reshape(F // chunk, chunk, N).sum(dim=1).sum(dim=0)


def bluestein_psd_streams_reference(raw_u8: torch.Tensor,
                                    n_valid: torch.Tensor, chunk: int,
                                    window: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """The plain version of the streams entry: (S, F, 2N) uint8, (S,)
    counts -> (S, N) float32 (a count outside [0, F] acts as its nearest
    bound)."""
    S, F, two_n = raw_u8.shape
    N = two_n // 2
    pwr = _power(raw_u8, window)
    keep = (torch.arange(F, device=raw_u8.device)[None, :]
            < n_valid.to(raw_u8.device)[:, None])
    pwr = torch.where(keep[..., None], pwr, 0.0)
    return pwr.reshape(S, F // chunk, chunk, N).sum(dim=2).sum(dim=1)


@functools.lru_cache(maxsize=16)
def device_tables(N: int, device: torch.device):
    """The chirp a and B / M in element order, on the device."""
    return (torch.from_numpy(chirp_table(N)).to(device),
            torch.from_numpy(spectrum_table(N)).to(device))


def fused_psd_bluestein(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                        window: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(F, 2N) uint8 frames, N even up to 8192, ``n_valid`` real frames ->
    (N,) float32 sum of |DFT|^2 over those frames, on the tensor's device.
    ``window``: an (N,) float32 tensor on the same device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously);
    a CPU tensor runs the plain version."""
    n_valid = int(n_valid)
    check_args("fused_psd_bluestein", fused_psd_bluestein_eligible, raw_u8,
               n_valid, chunk, window)
    if not _on_cuda("fused_psd_bluestein", raw_u8):
        COUNTS.plain += 1
        return bluestein_psd_reference(raw_u8, n_valid, chunk, window)
    N = raw_u8.shape[1] // 2
    out = launch("fused_psd_bluestein", bluestein_launch(N), raw_u8,
                 n_valid, chunk, window, device_tables(N, raw_u8.device))
    COUNTS.kernel_bluestein += 1
    return out


def fused_psd_bluestein_streams(raw_u8: torch.Tensor, n_valid: torch.Tensor,
                                chunk: int,
                                window: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """(S, F, 2N) uint8 frames of S streams, ``n_valid`` (S,) int32 real
    frames per stream on the frames' device -> (S, N) float32, row s the
    sum of |DFT|^2 over stream s's first n_valid[s] frames. ``window``: an
    (N,) float32 tensor on the same device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously);
    a CPU tensor runs the plain version. On the card the result is a view
    of (S, N rounded up to 32) rows."""
    check_streams_args(raw_u8, n_valid, chunk, window,
                       "fused_psd_bluestein_streams",
                       fused_psd_bluestein_eligible)
    if not _on_cuda("fused_psd_bluestein_streams", raw_u8):
        COUNTS.plain += 1
        return bluestein_psd_streams_reference(raw_u8, n_valid, chunk,
                                               window)
    N = raw_u8.shape[2] // 2
    out = launch("fused_psd_bluestein_streams", bluestein_launch(N), raw_u8,
                 n_valid, chunk, window, device_tables(N, raw_u8.device))
    COUNTS.kernel_bluestein_streams += 1
    return out
