"""Spectral correlation sums: (F, N) complex64 X -> (2, K, N) f32 ("SCF").

Replaces the products and sums of ``rtl_power_fftw_tpu/models/cyclo.py``
(``_scf_step``, XLA there, no Pallas kernel) with a CUDA C++ kernel
written for Hopper (``csrc/fused_psd_scf.cu``). Its input is one step's
frame spectra X (the frames kernel's complex store,
:func:`.fused_psd_frames.fused_psd_frames`); for the lags k = k0 .. k0 +
K - 1 it computes

    S[k, f] = sum over m < n_valid of X_m[(f + k) mod N] · conj(X_m[f])

within groups of ``chunk`` frames and then over the groups (the JAX
step's tree (g, chunk)), as (2, K, N) float32: the real parts, then the
imaginary.

Pass 1 (``scf_group_kernel``) runs a grid of (bin tile, lag tile, group):
a block owns :data:`TILE_BINS` bins by :data:`TILE_LAGS` lags of one group
of frames, stages the group's X at its bins and at its bins shifted by
its first lag in shared memory :data:`BATCH` frames at a time, and keeps
its sums in registers (each of its 256 threads one bin and TILE_LAGS / 8
lags), adding the group's float32 products in order in float64 (the
group's sum rounded once to float32); pass 2 is psd_sum.cuh's float64
row sum over the groups. A call covers at most
:data:`SLAB` values of K N: the caller tiles the lags, because K may be
as large as N.

:func:`fused_psd_scf` dispatches on the tensor's device: a CPU tensor
runs the plain PyTorch version (:func:`fused_psd_scf_reference`), a CUDA
tensor the kernel, or raises. ``COUNTS.kernel_scf`` counts its launches,
``COUNTS.plain_scf`` the plain version's (each also in ``COUNTS.plain``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import fused_psd as fp
from .fused_psd_large import _raw_stream

#: The kernel's tiles, kept in step with kScfBins, kScfLags, kScfRows and
#: kScfBatch in the source.
TILE_BINS = 32
TILE_LAGS = 32
LAG_ROWS = 8
BATCH = 16
#: The most values of K N one call covers (its output 8 MiB; its partial
#: rows 8 MiB a group).
SLAB = 1 << 20


def lag_slabs(N: int, K: int) -> Tuple[Tuple[int, int], ...]:
    """The (k0, count) slabs of lags 0 .. K - 1 at N bins, each at most
    :data:`SLAB` values of count N, in order."""
    per = max(1, SLAB // N)
    return tuple((k0, min(per, K - k0)) for k0 in range(0, K, per))


def fused_psd_scf_reference(X: torch.Tensor, n_valid: int, chunk: int,
                            k0: int = 0, K: int = 1) -> torch.Tensor:
    """The plain PyTorch version: (F, N) complex64 -> (2, K, N) float32,
    the JAX step's rolled products and tree sums."""
    F, N = X.shape
    mask = (torch.arange(F, device=X.device) < n_valid).to(
        torch.float32)[:, None]
    Xm = X * mask

    def tree(a):
        return a.reshape(F // chunk, chunk, N).sum(1).sum(0)

    re, im = [], []
    for k in range(k0, k0 + K):
        prod = torch.roll(Xm, -k, dims=-1) * torch.conj(Xm)
        re.append(tree(prod.real))
        im.append(tree(prod.imag))
    return torch.stack([torch.stack(re), torch.stack(im)])


def check_scf_args(X: torch.Tensor, n_valid: int, chunk: int, k0: int,
                   K: int) -> None:
    """Raise unless ``X`` is a contiguous (F, N) complex64 tensor with N a
    power of two from 64 to 16384, ``chunk`` divides F, 0 <= n_valid <= F
    and the lags k0 .. k0 + K - 1 lie in [0, N) and number at most
    :data:`SLAB` // N."""
    if (not isinstance(X, torch.Tensor) or X.dtype != torch.complex64
            or X.dim() != 2 or not X.is_contiguous()):
        raise ValueError("X must be a contiguous (F, N) complex64 tensor")
    F, N = X.shape
    if not fp.fused_psd_eligible(N):
        raise ValueError(f"fused_psd_scf does not take N={N}")
    if chunk < 1 or F % chunk:
        raise ValueError(f"chunk={chunk} must divide F={F}")
    if not 0 <= n_valid <= F:
        raise ValueError(f"n_valid={n_valid} outside [0, {F}]")
    if K < 1 or k0 < 0 or k0 + K > N or K * N > max(SLAB, N):
        raise ValueError(f"lags {k0}..{k0 + K - 1} at N={N}: each call "
                         f"takes lags in [0, N), at most {max(1, SLAB // N)}")


def fused_psd_scf(X: torch.Tensor, n_valid: int, chunk: int, k0: int = 0,
                  K: int = 1) -> torch.Tensor:
    """(F, N) complex64 spectra, ``n_valid`` real frames -> (2, K, N)
    float32, the sums over those frames of X_m[(f + k) mod N] conj(X_m[f])
    for the lags k = k0 .. k0 + K - 1 (real parts, then imaginary), on the
    tensor's device.

    A CUDA tensor runs the kernel on the current stream (asynchronously);
    a CPU tensor runs the plain version."""
    n_valid, k0, K = int(n_valid), int(k0), int(K)
    check_scf_args(X, n_valid, chunk, k0, K)
    if not fp._on_cuda("fused_psd_scf", X):
        fp.COUNTS.plain += 1
        fp.COUNTS.plain_scf += 1
        return fused_psd_scf_reference(X, n_valid, chunk, k0, K)
    from . import _build
    lib = _build.load("fused_psd_scf")
    F, N = X.shape
    device = X.device
    G = F // chunk
    # One allocation: the (G, 2, K, N) partial rows, then the output.
    buf = torch.empty((G + 1) * 2 * K * N, dtype=torch.float32,
                      device=device)
    out = buf[G * 2 * K * N:].view(2, K, N)
    err = lib.rpf_fused_psd_scf(X.data_ptr(), buf.data_ptr(), out.data_ptr(),
                                device.index, N, F, K, k0, chunk, n_valid,
                                _raw_stream(device.index))
    if err != 0:
        raise fp.launch_error("fused_psd_scf", lib, err)
    fp.COUNTS.kernel_scf += 1
    return out


def kernel_attributes(device: Optional[torch.device] = None) -> dict:
    """What ``scf_group_kernel`` gets on the card: registers and spill
    bytes a thread, static and dynamic shared bytes and threads a block,
    and the blocks that reside on one SM. Launches nothing."""
    import ctypes
    from . import _build
    device = device or torch.device("cuda", torch.cuda.current_device())
    lib = _build.load("fused_psd_scf")
    attrs = (ctypes.c_int * 6)()
    err = lib.rpf_fused_psd_scf_attributes(device.index or 0, attrs)
    if err != 0:
        raise fp.launch_error("fused_psd_scf attributes", lib, err)
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "dynamic_smem", "threads", "blocks_per_sm"), attrs))
