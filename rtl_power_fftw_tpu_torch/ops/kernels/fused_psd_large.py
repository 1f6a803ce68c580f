"""Large-N fused PSD step: raw u8 IQ frames -> (N,) f32 partial power sum,
for powers of two from 32768 to 2^22.

Replaces ``rtl_power_fftw_tpu/ops/kernels/fused_psd.py:make_fused_psd_fn``
at default precision from 32768 to 65536, unwindowed (K1) and windowed
(K2), where the port's ``fused_psd`` stops (its whole frame lives in
shared memory), and ``probes/big_kernel.py``'s 1M-point kernel (P15,
BASELINE config 3), with a CUDA C++ kernel written for Hopper
(``csrc/fused_psd_large.cu``). It computes what :func:`fused_psd
<.fused_psd.fused_psd>` computes, as a four-step FFT over device memory:
N = N1·N2 (:func:`large_split`), sample n = n1·N2 + n2, bin k = k1 + N1·k2:

1. dequantize (u8 - 127) [× window in float32];
2. length-N1 DFTs over n1 of each column n2;
3. × the inter-stage twiddle W_N^(n2·k1), the float32 rounding of a
   product of two float64 table entries (:func:`inter_tables`);
4. length-N2 DFTs over n2 of each row k1;
5. |X|^2, frames f >= ``n_valid`` dropped, sum over frames in two stages.

What bounds the kernel on an H100, and what its design does about it, is
stated at the top of the CUDA source: the complex scratch between its two
passes crosses device memory twice per frame.

:func:`fused_psd_large` dispatches on the tensor's device: a CPU tensor
goes to the plain PyTorch version (:func:`fused_psd_large_reference`, the
same four steps in torch ops, so their index arithmetic runs on the CPU);
a CUDA tensor goes to the kernel, or raises. ``COUNTS.kernel_large`` and
``COUNTS.kernel_large_windowed`` (in :mod:`.fused_psd`) count its launches.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .fused_psd import (COUNTS, KernelLaunchError, _on_cuda, check_alignment,
                        check_args, stage_twiddles)

#: Eligible sizes: powers of two above fused_psd's 16384, up to the size
#: whose N1 and N2 (2048 each) keep pass A's and pass B's tiles within the
#: 227 KB of shared memory a Hopper block may use. Kept in step with
#: kMinLog2N/kMaxLog2N in the source.
MIN_N = 32768
MAX_N = 1 << 22

#: Blocks a pass aims for per launch: about one per SM of the H100's 132
#: (pass A holds 131 KB of shared memory at N1 = 1024, one block per SM).
_TARGET_BLOCKS = 128


def fused_psd_large_eligible(N: int) -> bool:
    """True iff the kernel takes N bins."""
    return MIN_N <= N <= MAX_N and (N & (N - 1)) == 0


def large_split(N: int) -> Tuple[int, int]:
    """(N1, N2): N1 = 2^floor(log2 N / 2) column length, N2 = N / N1 row
    length (128 x 256 at 32768, 1024 x 1024 at 2^20)."""
    n1 = 1 << ((N.bit_length() - 1) // 2)
    return n1, N // n1


def large_tiles(N: int) -> dict:
    """The kernel's tiles at N (``Large<LOG2N>`` in the source): C columns
    per pass-A block, R rows per pass-B block, and the tile counts."""
    n1, n2 = large_split(N)
    c = 16 if n1 <= 1024 else 8
    r = 8 if n2 <= 1024 else 4
    return {"N1": n1, "N2": n2, "C": c, "R": r, "tiles_a": n2 // c,
            "tiles_b": n1 // r}


def frames_per_block(F: int, chunk: int, N: int) -> int:
    """Frames one block of either pass takes: ``chunk`` (the two-stage
    sum's first stage), halved while the pass with fewer tiles would get
    fewer than the target block count."""
    t = large_tiles(N)
    tiles = min(t["tiles_a"], t["tiles_b"])
    group = chunk
    while group > 1 and tiles * (F // group) < _TARGET_BLOCKS:
        group //= 2
    return group


def inter_tables(N: int) -> np.ndarray:
    """The inter-stage twiddle tables, (N2 + N1, 2) float64 (re, im):
    W_N^l for l < N2, then W_N^(N2·h) for h < N1, so that W_N^m =
    row[m mod N2] · row[N2 + m // N2] for any m < N."""
    n1, n2 = large_split(N)
    ang = np.concatenate([np.arange(n2, dtype=np.float64),
                          n2 * np.arange(n1, dtype=np.float64)])
    ang *= -2.0 * np.pi / N
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1)


def inter_twiddle(N: int) -> np.ndarray:
    """(N1, N2) complex64: W_N^(k1·n2) as the kernel forms it, the float64
    product of the two table entries rounded once to float32."""
    n1, n2 = large_split(N)
    tab = inter_tables(N)
    tab = tab[:, 0] + 1j * tab[:, 1]
    m = np.arange(n1)[:, None] * np.arange(n2)[None, :]
    return (tab[m % n2] * tab[n2 + m // n2]).astype(np.complex64)


@functools.lru_cache(maxsize=4)
def _plain_twiddle(N: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(inter_twiddle(N)).to(device)


@functools.lru_cache(maxsize=8)
def _device_tables(N: int, device: torch.device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's tables on ``device``: the per-stage twiddles of N1 then
    N2 (float32) and the inter-stage tables (float64)."""
    n1, n2 = large_split(N)
    stages = np.concatenate([stage_twiddles(n1), stage_twiddles(n2)])
    return (torch.from_numpy(stages).to(device),
            torch.from_numpy(inter_tables(N)).to(device))


def fused_psd_large_reference(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                              window: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The plain PyTorch version: (F, 2N) uint8 -> (N,) float32, the four
    steps written out in torch ops."""
    F, two_n = raw_u8.shape
    N = two_n // 2
    n1, n2 = large_split(N)
    v = raw_u8.reshape(F, N, 2).to(torch.int32)
    re = (v[..., 0] - 127).to(torch.float32)
    im = (v[..., 1] - 127).to(torch.float32)
    if window is not None:
        re = re * window
        im = im * window
    x = torch.complex(re, im).reshape(F, n1, n2)        # [f, n1, n2]
    y = torch.fft.fft(x, dim=1)                         # [f, k1, n2]
    y = y * _plain_twiddle(N, raw_u8.device)
    X = torch.fft.fft(y, dim=2)                         # [f, k1, k2]
    pwr = X.real * X.real + X.imag * X.imag
    pwr[n_valid:] = 0.0
    # Bin k1 + N1·k2: read [f, k2, k1] flat.
    pwr = pwr.transpose(1, 2).reshape(F, N)
    return pwr.reshape(F // chunk, chunk, N).sum(dim=1).sum(dim=0)


def fused_psd_large(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                    window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(F, 2N) uint8 frames, 32768 <= N <= 2^22, ``n_valid`` real frames ->
    (N,) float32 sum of |DFT|^2 over those frames, on the tensor's device.
    ``window``: an (N,) float32 tensor on the same device (K2), or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously);
    a CPU tensor runs the plain version."""
    n_valid = int(n_valid)
    check_args("fused_psd_large", fused_psd_large_eligible, raw_u8, n_valid,
               chunk, window)
    if not _on_cuda("fused_psd_large", raw_u8):
        COUNTS.plain += 1
        return fused_psd_large_reference(raw_u8, n_valid, chunk, window)
    # 32-bit IQ words; the window as float2, two samples per word.
    check_alignment("fused_psd_large", raw_u8, 4, window, 8)
    from . import _build
    lib = _build.load("fused_psd_large")
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    group = frames_per_block(F, chunk, N)
    device = raw_u8.device
    twiddle, inter = _device_tables(N, device)
    scratch = torch.empty((F, N, 2), dtype=torch.float32, device=device)
    partial = torch.empty((-(-F // group), N), dtype=torch.float32,
                          device=device)
    out = torch.empty((N,), dtype=torch.float32, device=device)
    err = lib.rpf_fused_psd_large(
        raw_u8.data_ptr(), twiddle.data_ptr(), inter.data_ptr(),
        None if window is None else window.data_ptr(), scratch.data_ptr(),
        partial.data_ptr(), out.data_ptr(), device.index,
        N.bit_length() - 1, F, group, n_valid,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(
            f"fused_psd_large launch failed: "
            f"{lib.rpf_cuda_error_string(err).decode()} (cudaError {err})")
    if window is None:
        COUNTS.kernel_large += 1
    else:
        COUNTS.kernel_large_windowed += 1
    return out
