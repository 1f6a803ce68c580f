"""Fused averaged-PSD step: raw u8 IQ frames -> (N,) f32 partial power sum.

Replaces ``rtl_power_fftw_tpu/ops/kernels/fused_psd.py:make_fused_psd_fn``
(the unwindowed, single-stream, default-precision kernel, K1) with a CUDA
C++ kernel written for Hopper (``csrc/fused_psd.cu``). The computation:

1. dequantize: re = byte[2n] - 127, im = byte[2n+1] - 127;
2. length-N DFT in float32;
3. |X|^2;
4. zero the frames f >= ``n_valid``;
5. sum over frames (two stages, so f32 rounding stays small);

with bins in natural, unshifted order (``finalize_psd`` applies the
fftshift once, per the JAX package's convention).

What bounds the kernel on an H100, and what its design does about it, is
stated at the top of the CUDA source: a radix-2 transform in shared
memory is bound by shared-memory traffic and per-stage barriers, not by
the 2 bytes per sample it reads from device memory.

:func:`fused_psd` dispatches on the tensor's device: a CPU tensor goes to
the plain PyTorch version :func:`fused_psd_reference`; a CUDA tensor goes
to the kernel, or raises. :data:`COUNTS` records which one served each
call, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

#: Eligible sizes: powers of two whose complex f32 frame (8N bytes) fits
#: the 227 KB of shared memory a Hopper block may use (N = 16384 takes
#: 128 KB; 32768 would take 256 KB), from the size whose N/2 butterflies
#: fill one warp. Kept in step with kMinLog2N/kMaxLog2N in the source.
MIN_N = 64
MAX_N = 16384

#: Blocks the launch aims for: eight 256-thread blocks fill the 2048
#: resident threads of each of the H100's 132 SMs (1056 blocks).
_TARGET_BLOCKS = 1024


class KernelLaunchError(RuntimeError):
    """The CUDA launcher returned an error code."""


class LaunchCounts:
    """Calls served by the CUDA kernel and by the plain version.

    Incremented by :func:`fused_psd` only; a session's single consumer
    thread is its only caller while a session runs."""

    def __init__(self) -> None:
        self.kernel = 0
        self.plain = 0

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0


COUNTS = LaunchCounts()


def fused_psd_eligible(N: int) -> bool:
    """True iff the kernel takes N bins."""
    return MIN_N <= N <= MAX_N and (N & (N - 1)) == 0


def stage_twiddles(N: int) -> np.ndarray:
    """Per-stage twiddle table, (N - 1, 2) float32 (re, im).

    The radix-2 stage of half-span m (m = 1, 2, 4, ..., N/2) reads
    W_{2m}^k = exp(-2*pi*i*k / (2m)), k < m, at rows m - 1 .. 2m - 2.
    Computed in float64 and rounded once to float32."""
    parts = []
    m = 1
    while m < N:
        ang = -np.pi * np.arange(m, dtype=np.float64) / m
        parts.append(np.stack([np.cos(ang), np.sin(ang)], axis=-1))
        m *= 2
    return np.concatenate(parts).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_twiddles(N: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(stage_twiddles(N)).to(device)


def frames_per_block(F: int, chunk: int) -> int:
    """Frames one kernel block sums: ``chunk`` (the two-stage sum's first
    stage), halved while that leaves fewer than the target block count."""
    group = chunk
    while group > 1 and F // group < _TARGET_BLOCKS:
        group //= 2
    return group


def fused_psd_reference(raw_u8: torch.Tensor, n_valid: int,
                        chunk: int) -> torch.Tensor:
    """The plain PyTorch version: (F, 2N) uint8 -> (N,) float32."""
    F, two_n = raw_u8.shape
    N = two_n // 2
    v = raw_u8.reshape(F, N, 2).to(torch.int32)
    re = (v[..., 0] - 127).to(torch.float32)
    im = (v[..., 1] - 127).to(torch.float32)
    X = torch.fft.fft(torch.complex(re, im), dim=-1)
    pwr = X.real * X.real + X.imag * X.imag
    pwr[n_valid:] = 0.0
    return pwr.reshape(F // chunk, chunk, N).sum(dim=1).sum(dim=0)


def _check(raw_u8: torch.Tensor, n_valid: int, chunk: int) -> None:
    if not isinstance(raw_u8, torch.Tensor) or raw_u8.dtype != torch.uint8:
        raise TypeError("fused_psd takes a uint8 tensor of raw IQ frames")
    if raw_u8.dim() != 2 or raw_u8.shape[0] < 1 or raw_u8.shape[1] % 2:
        raise ValueError(f"raw frames must be (F, 2N), got "
                         f"{tuple(raw_u8.shape)}")
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    if not fused_psd_eligible(N):
        raise ValueError(f"fused_psd takes power-of-two N in "
                         f"[{MIN_N}, {MAX_N}], got N={N}")
    if not raw_u8.is_contiguous():
        raise ValueError("raw frames must be contiguous")
    if chunk < 1 or F % chunk:
        raise ValueError(f"chunk={chunk} must divide F={F}")
    if not 0 <= n_valid <= F:
        raise ValueError(f"n_valid={n_valid} outside [0, {F}]")


def fused_psd(raw_u8: torch.Tensor, n_valid: int, chunk: int) -> torch.Tensor:
    """(F, 2N) uint8 frames, ``n_valid`` real frames -> (N,) float32 sum of
    |DFT|^2 over those frames, on the tensor's device.

    A CUDA tensor runs the kernel on the current stream (asynchronously);
    a CPU tensor runs the plain version."""
    n_valid = int(n_valid)
    _check(raw_u8, n_valid, chunk)
    if raw_u8.device.type == "cpu":
        COUNTS.plain += 1
        return fused_psd_reference(raw_u8, n_valid, chunk)
    if raw_u8.device.type != "cuda":
        raise ValueError(f"fused_psd runs on cuda or cpu tensors, not "
                         f"{raw_u8.device}")
    if raw_u8.data_ptr() % 4:
        raise ValueError("raw frames must be 4-byte aligned on the device")
    from . import _build
    lib = _build.load()
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    group = frames_per_block(F, chunk)
    device = raw_u8.device
    partial = torch.empty((-(-F // group), N), dtype=torch.float32,
                          device=device)
    out = torch.empty(N, dtype=torch.float32, device=device)
    twiddle = _device_twiddles(N, device)
    stream = torch.cuda.current_stream(device)
    err = lib.rpf_fused_psd(raw_u8.data_ptr(), twiddle.data_ptr(),
                            partial.data_ptr(), out.data_ptr(), device.index,
                            N.bit_length() - 1, F, group, n_valid,
                            stream.cuda_stream)
    if err != 0:
        raise KernelLaunchError(
            f"fused_psd launch failed: "
            f"{lib.rpf_cuda_error_string(err).decode()} (cudaError {err})")
    COUNTS.kernel += 1
    return out
