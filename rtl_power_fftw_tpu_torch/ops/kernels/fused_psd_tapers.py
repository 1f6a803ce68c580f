"""Multitaper step: raw u8 IQ frames -> the summed mean eigenspectrum.

Replaces the device step of ``rtl_power_fftw_tpu/models/multitaper.py``
(``_mt_core``, XLA there) with a CUDA C++ kernel written for Hopper
(``csrc/fused_psd_tapers.cu``): each valid frame of an (F, 2N) batch is
tapered by each of the K rows of a (K, N) float32 table, transformed, and
|X|^2 summed over frames and tapers; the total is divided by K in
float32. Bins in natural order.

The kernel is K2's windowed group kernel (``csrc/fused_psd_regs.cuh``)
with a taper axis on its grid: block (g, k) runs K2 on frames [g * group,
(g + 1) * group) under taper row k and writes partial row k * G + g
(taper k's rows are one plane); one float64 row sum over all K * G rows
gives the total. Each block gets frames for K2's grid over resident / K blocks
(:func:`tapers_group`), so that the K * G blocks are about one wave.

:func:`fused_psd_tapers` dispatches on the tensor's device: a CPU tensor
runs the plain PyTorch version (:func:`fused_psd_tapers_reference`), a
CUDA tensor the kernel, or raises. ``COUNTS.kernel_tapers`` counts the
kernel's launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import fused_psd as fp

#: Tapers a call takes (``--multitaper`` accepts 1..32).
MAX_TAPERS = 32


def tapers_group(F: int, chunk: int, K: int, resident: int) -> int:
    """Frames a block sums: :func:`.fused_psd.k1_group` over the blocks
    the card holds at once for each of the K tapers."""
    return fp.k1_group(F, chunk, max(1, resident // K))


def check_tapers(tapers: torch.Tensor, raw_u8: torch.Tensor) -> None:
    """Raise unless ``tapers`` is a contiguous (K, N) float32 tensor on the
    frames' device, 1 <= K <= :data:`MAX_TAPERS`."""
    N = raw_u8.shape[-1] // 2
    if (not isinstance(tapers, torch.Tensor) or tapers.dtype != torch.float32
            or tapers.dim() != 2 or tapers.shape[1] != N
            or not 1 <= tapers.shape[0] <= MAX_TAPERS
            or not tapers.is_contiguous()):
        raise ValueError(f"tapers must be a contiguous (K, {N}) float32 "
                         f"tensor with 1 <= K <= {MAX_TAPERS}")
    if tapers.device != raw_u8.device:
        raise ValueError(f"tapers on {tapers.device}, frames on "
                         f"{raw_u8.device}")


def fused_psd_tapers_reference(raw_u8: torch.Tensor, n_valid: int,
                               chunk: int, tapers: torch.Tensor
                               ) -> torch.Tensor:
    """The plain PyTorch version, in the JAX package's ``_mt_core`` order:
    the (F * K, N) tapered batch (frame-major), |FFT|^2, frames f >=
    n_valid dropped, the chunked sum over its rows, divided by K."""
    F, two_n = raw_u8.shape
    N = two_n // 2
    K = tapers.shape[0]
    v = raw_u8.reshape(F, N, 2).to(torch.int32)
    re = (v[..., 0] - 127).to(torch.float32)
    im = (v[..., 1] - 127).to(torch.float32)
    re_t = (re[:, None, :] * tapers[None]).reshape(F * K, N)
    im_t = (im[:, None, :] * tapers[None]).reshape(F * K, N)
    X = torch.fft.fft(torch.complex(re_t, im_t), dim=-1)
    p = X.real * X.real + X.imag * X.imag
    p[n_valid * K:] = 0.0
    total = p.reshape(F * K // chunk, chunk, N).sum(dim=1).sum(dim=0)
    return total / torch.tensor(K, dtype=torch.float32)


def fused_psd_tapers(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                     tapers: torch.Tensor) -> torch.Tensor:
    """(F, 2N) uint8 frames, ``n_valid`` real frames, (K, N) float32
    ``tapers`` on the same device -> (N,) float32: the sum over those
    frames of the mean over the K tapers of |DFT(x * taper_k)|^2.

    A CUDA tensor runs the kernel on the current stream (asynchronously);
    a CPU tensor runs the plain version."""
    n_valid = int(n_valid)
    fp.check_args("fused_psd_tapers", fp.fused_psd_eligible, raw_u8, n_valid,
                  chunk, None)
    check_tapers(tapers, raw_u8)
    if not fp._on_cuda("fused_psd_tapers", raw_u8):
        fp.COUNTS.plain += 1
        return fused_psd_tapers_reference(raw_u8, n_valid, chunk, tapers)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    K = tapers.shape[0]
    index = raw_u8.device.index
    group = tapers_group(F, chunk, K, fp.resident_blocks(N, True, index))
    out = fp._launch(
        "fused_psd_tapers", raw_u8, tapers, K * -(-F // group), (N,),
        lambda lib, raw, twiddle, tp, partial, out, stream:
        lib.rpf_fused_psd_tapers(raw, twiddle, tp, partial, out, index,
                                 N.bit_length() - 1, F, group, K, n_valid,
                                 stream),
        library="fused_psd_tapers")
    fp.COUNTS.kernel_tapers += 1
    return out


def kernel_attributes(N: int, device: Optional[torch.device] = None
                      ) -> dict:
    """What the first pass gets at N bins on the card, as
    :func:`.fused_psd.kernel_attributes` gives K2's. Launches nothing."""
    return fp.library_attributes("fused_psd_tapers", N, device=device)
