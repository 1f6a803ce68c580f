"""Fused averaged-PSD step: raw u8 IQ frames -> (N,) f32 partial power sum.

Replaces ``rtl_power_fftw_tpu/ops/kernels/fused_psd.py:make_fused_psd_fn``
at default precision, unwindowed (K1) and windowed (K2), single-stream or
with ``streams=S>1`` (K4), with a CUDA C++ kernel written for Hopper
(``csrc/fused_psd.cu``). The computation:

1. dequantize: re = byte[2n] - 127, im = byte[2n+1] - 127; with a
   window, re·w[n] and im·w[n] in float32;
2. length-N DFT in float32;
3. |X|^2;
4. zero the frames f >= ``n_valid``;
5. sum over frames (two stages, so f32 rounding stays small);

with bins in natural, unshifted order (``finalize_psd`` applies the
fftshift once, per the JAX package's convention). :func:`fused_psd_streams`
(K4) does this for S streams of F frames at once, each with its own
valid count, one output row per stream.

What bounds the kernel on an H100, and what its design does about it, is
stated at the top of the CUDA source: a radix-2 transform in shared
memory is bound by shared-memory traffic and per-stage barriers, not by
the 2 bytes per sample it reads from device memory.

:func:`fused_psd` and :func:`fused_psd_streams` dispatch on the tensor's
device: a CPU tensor goes to the plain PyTorch version
(:func:`fused_psd_reference`, :func:`fused_psd_streams_reference`); a CUDA
tensor goes to the kernel, or raises. :data:`COUNTS` records which one
served each call (K1, K2 and K4's two forms apart), so a run can show that
its main path went through the kernel.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

#: Eligible sizes: powers of two whose complex f32 frame (8N bytes) fits
#: the 227 KB of shared memory a Hopper block may use (N = 16384 takes
#: 128 KB; 32768 would take 256 KB and goes to fused_psd_large), from the
#: size whose N/2 butterflies fill one warp. Kept in step with
#: kMinLog2N/kMaxLog2N in the source.
MIN_N = 64
MAX_N = 16384

#: Blocks the launch aims for: eight 256-thread blocks fill the 2048
#: resident threads of each of the H100's 132 SMs (1056 blocks).
_TARGET_BLOCKS = 1024


class KernelLaunchError(RuntimeError):
    """The CUDA launcher returned an error code."""


class LaunchCounts:
    """Calls served by the CUDA kernels of this module and of
    :mod:`.fused_psd_large`, and by their plain versions; ``kernel_windowed``
    counts the kernel's windowed launches (K2) apart from its unwindowed
    ones (``kernel``, K1), ``kernel_streams`` / ``kernel_streams_windowed``
    the streams launches (K4) likewise, and ``kernel_large`` /
    ``kernel_large_windowed`` the large-N kernel's.

    Incremented by the wrappers only; a session's single consumer thread
    is their only caller while a session runs."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.kernel = 0
        self.kernel_windowed = 0
        self.kernel_streams = 0
        self.kernel_streams_windowed = 0
        self.kernel_large = 0
        self.kernel_large_windowed = 0
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


def _frame_power(raw_u8: torch.Tensor,
                 window: Optional[torch.Tensor]) -> torch.Tensor:
    """|DFT|^2 of every frame: (..., 2N) uint8 -> (..., N) float32."""
    N = raw_u8.shape[-1] // 2
    v = raw_u8.reshape(*raw_u8.shape[:-1], N, 2).to(torch.int32)
    re = (v[..., 0] - 127).to(torch.float32)
    im = (v[..., 1] - 127).to(torch.float32)
    if window is not None:
        re = re * window
        im = im * window
    X = torch.fft.fft(torch.complex(re, im), dim=-1)
    return X.real * X.real + X.imag * X.imag


def fused_psd_reference(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                        window: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The plain PyTorch version: (F, 2N) uint8 -> (N,) float32."""
    F, two_n = raw_u8.shape
    N = two_n // 2
    pwr = _frame_power(raw_u8, window)
    pwr[n_valid:] = 0.0
    return pwr.reshape(F // chunk, chunk, N).sum(dim=1).sum(dim=0)


def fused_psd_streams_reference(raw_u8: torch.Tensor, n_valid: torch.Tensor,
                                chunk: int,
                                window: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """The plain PyTorch version of K4: (S, F, 2N) uint8 frames, (S,)
    valid counts -> (S, N) float32, each stream's frames f >= n_valid[s]
    dropped (a count outside [0, F] acts as its nearest bound, as in the
    kernel)."""
    S, F, two_n = raw_u8.shape
    N = two_n // 2
    pwr = _frame_power(raw_u8, window)
    keep = (torch.arange(F, device=raw_u8.device)[None, :]
            < n_valid.to(raw_u8.device)[:, None])
    pwr = torch.where(keep[..., None], pwr, 0.0)
    return pwr.reshape(S, F // chunk, chunk, N).sum(dim=2).sum(dim=1)


def check_args(kernel: str, eligible, raw_u8: torch.Tensor, n_valid: int,
               chunk: int, window: Optional[torch.Tensor]) -> None:
    """Raise on arguments ``kernel``'s wrapper does not take: frames that
    are not a contiguous (F, 2N) uint8 tensor with ``eligible(N)``, a
    ``chunk`` that does not divide F, ``n_valid`` outside [0, F], or a
    window that is not None or an (N,) contiguous float32 tensor on the
    frames' device."""
    if not isinstance(raw_u8, torch.Tensor) or raw_u8.dtype != torch.uint8:
        raise TypeError(f"{kernel} takes a uint8 tensor of raw IQ frames")
    if raw_u8.dim() != 2 or raw_u8.shape[0] < 1 or raw_u8.shape[1] % 2:
        raise ValueError(f"raw frames must be (F, 2N), got "
                         f"{tuple(raw_u8.shape)}")
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    if not eligible(N):
        raise ValueError(f"{kernel} does not take N={N}")
    if not raw_u8.is_contiguous():
        raise ValueError("raw frames must be contiguous")
    if chunk < 1 or F % chunk:
        raise ValueError(f"chunk={chunk} must divide F={F}")
    if not 0 <= n_valid <= F:
        raise ValueError(f"n_valid={n_valid} outside [0, {F}]")
    if window is None:
        return
    if (not isinstance(window, torch.Tensor)
            or window.dtype != torch.float32 or window.shape != (N,)
            or not window.is_contiguous()):
        raise ValueError(f"window must be a contiguous ({N},) float32 "
                         "tensor")
    if window.device != raw_u8.device:
        raise ValueError(f"window on {window.device}, frames on "
                         f"{raw_u8.device}")


def check_streams_args(raw_u8: torch.Tensor, n_valid: torch.Tensor,
                       chunk: int, window: Optional[torch.Tensor]) -> None:
    """Raise on arguments :func:`fused_psd_streams` does not take: frames
    that are not a contiguous (S, F, 2N) uint8 tensor (each stream's
    (F, 2N) block as :func:`check_args` takes it), or counts that are not
    an (S,) contiguous int32 tensor on the frames' device."""
    if not isinstance(raw_u8, torch.Tensor) or raw_u8.dim() != 3:
        raise ValueError("raw frames must be an (S, F, 2N) tensor")
    S = raw_u8.shape[0]
    if S < 1 or not raw_u8.is_contiguous():
        raise ValueError(f"raw frames must be a contiguous (S, F, 2N) "
                         f"tensor with S >= 1, got {tuple(raw_u8.shape)}")
    check_args("fused_psd_streams", fused_psd_eligible, raw_u8[0], 0, chunk,
               window)
    if (not isinstance(n_valid, torch.Tensor)
            or n_valid.dtype != torch.int32 or n_valid.shape != (S,)
            or not n_valid.is_contiguous()):
        raise ValueError(f"n_valid must be a contiguous ({S},) int32 tensor")
    if n_valid.device != raw_u8.device:
        raise ValueError(f"n_valid on {n_valid.device}, frames on "
                         f"{raw_u8.device}")


def check_alignment(kernel: str, raw_u8: torch.Tensor, raw_align: int,
                    window: Optional[torch.Tensor], window_align: int) -> None:
    """Raise unless the pointers meet ``kernel``'s vector loads: frames
    ``raw_align``-byte aligned, the window ``window_align``-byte aligned
    (a misaligned load is a sticky error that breaks the CUDA context)."""
    if raw_u8.data_ptr() % raw_align:
        raise ValueError(f"{kernel}: raw frames must be {raw_align}-byte "
                         "aligned on the device")
    if window is not None and window.data_ptr() % window_align:
        raise ValueError(f"{kernel}: window must be {window_align}-byte "
                         "aligned on the device")


def _on_cuda(kernel: str, raw_u8: torch.Tensor) -> bool:
    """True for frames on a CUDA device, False on the CPU; raise on any
    other device."""
    if raw_u8.device.type in ("cpu", "cuda"):
        return raw_u8.device.type == "cuda"
    raise ValueError(f"{kernel} runs on cuda or cpu tensors, not "
                     f"{raw_u8.device}")


def _launch(kernel: str, raw_u8: torch.Tensor,
            window: Optional[torch.Tensor], rows: int, out_shape,
            call) -> torch.Tensor:
    """The launch :func:`fused_psd` and :func:`fused_psd_streams` share:
    check the vector loads' alignment (32-bit IQ words; the window as
    float2, two samples per word), make the (rows, N) partial and the
    output, and run ``call(lib, raw, twiddle, window, partial, out,
    stream)`` with device pointers and the current stream's handle, on
    which the kernel runs asynchronously. Returns the output."""
    check_alignment(kernel, raw_u8, 4, window, 8)
    from . import _build
    lib = _build.load("fused_psd")
    N = raw_u8.shape[-1] // 2
    device = raw_u8.device
    partial = torch.empty((rows, N), dtype=torch.float32, device=device)
    out = torch.empty(out_shape, dtype=torch.float32, device=device)
    err = call(lib, raw_u8.data_ptr(), _device_twiddles(N, device).data_ptr(),
               None if window is None else window.data_ptr(),
               partial.data_ptr(), out.data_ptr(),
               torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(
            f"{kernel} launch failed: "
            f"{lib.rpf_cuda_error_string(err).decode()} (cudaError {err})")
    return out


def fused_psd(raw_u8: torch.Tensor, n_valid: int, chunk: int,
              window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(F, 2N) uint8 frames, ``n_valid`` real frames -> (N,) float32 sum of
    |DFT|^2 over those frames, on the tensor's device. ``window``: an
    (N,) float32 tensor on the same device (K2), or None (K1).

    A CUDA tensor runs the kernel on the current stream (asynchronously);
    a CPU tensor runs the plain version."""
    n_valid = int(n_valid)
    check_args("fused_psd", fused_psd_eligible, raw_u8, n_valid, chunk,
               window)
    if not _on_cuda("fused_psd", raw_u8):
        COUNTS.plain += 1
        return fused_psd_reference(raw_u8, n_valid, chunk, window)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    group = frames_per_block(F, chunk)
    index = raw_u8.device.index
    out = _launch(
        "fused_psd", raw_u8, window, -(-F // group), (N,),
        lambda lib, raw, twiddle, win, partial, out, stream:
        lib.rpf_fused_psd(raw, twiddle, win, partial, out, index,
                          N.bit_length() - 1, F, group, n_valid, stream))
    if window is None:
        COUNTS.kernel += 1
    else:
        COUNTS.kernel_windowed += 1
    return out


def fused_psd_streams(raw_u8: torch.Tensor, n_valid: torch.Tensor,
                      chunk: int, window: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """K4: (S, F, 2N) uint8 frames of S streams, ``n_valid`` (S,) int32
    real frames per stream, on the frames' device -> (S, N) float32, row s
    the sum of |DFT|^2 over stream s's first n_valid[s] frames (a count
    outside [0, F] acts as its nearest bound). ``window``: an (N,) float32
    tensor on the same device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously:
    the kernel reads ``n_valid`` from device memory when it runs); a CPU
    tensor runs the plain version."""
    check_streams_args(raw_u8, n_valid, chunk, window)
    if not _on_cuda("fused_psd_streams", raw_u8):
        COUNTS.plain += 1
        return fused_psd_streams_reference(raw_u8, n_valid, chunk, window)
    S, F, N = raw_u8.shape[0], raw_u8.shape[1], raw_u8.shape[2] // 2
    # Blocks are counted over all S*F frames; a group is a power of two no
    # larger than chunk, which divides F, so no block crosses a stream.
    group = frames_per_block(S * F, chunk)
    if F % group:
        raise ValueError(f"frames per block {group} must divide F={F}")
    index = raw_u8.device.index
    out = _launch(
        "fused_psd_streams", raw_u8, window, S * (F // group), (S, N),
        lambda lib, raw, twiddle, win, partial, out, stream:
        lib.rpf_fused_psd_streams(raw, twiddle, win, n_valid.data_ptr(),
                                  partial, out, index, N.bit_length() - 1,
                                  S, F, group, stream))
    if window is None:
        COUNTS.kernel_streams += 1
    else:
        COUNTS.kernel_streams_windowed += 1
    return out
