"""Spectral-kurtosis step: raw u8 IQ frames -> both spectral moments.

Replaces the device step of ``rtl_power_fftw_tpu/models/kurtosis.py``
(``_sk_step``, XLA there) with a CUDA C++ kernel written for Hopper
(``csrc/fused_psd_sk.cu``): over the valid frames of an (F, 2N) batch,
s1 = the sum of |X|^2 and s2 = the sum of |X|^4, each (N,) float32 in
natural bin order; with ``sigma > 0`` (``--sk-excise``) also the block's
excision gate on its own spectral kurtosis (:func:`sk_keep`), s1 * keep and
n_valid * keep.

The kernel is K1/K2's group kernel (``csrc/fused_psd_regs.cuh``) with a
sum of |X|^4 beside each sum of |X|^2, on K1's own grid
(:func:`.fused_psd.k1_group` from K1's occupancy, not its own), so that s1
is :func:`.fused_psd.fused_psd`'s output bit for bit on the same frames,
``n_valid`` and ``chunk``; its second pass is psd_sum's float64 row sum
over both planes, with the gate as its epilogue. Where the plane fits a
block (:func:`plane_fits`: up to 8192 bins) the |X|^4 sums live in a
shared-memory plane (the ``kRegsSkPlane`` cut), so the kernel keeps K1's
registers and occupancy and K1's grid runs in one wave; at 16384 bins the
route is the kernel it was redesigned from (``kRegsSk``: the sums in
registers), which :func:`fused_psd_sk_control` runs at every size. Both
give the same s2 bits.

:func:`fused_psd_sk_streams` runs S streams of F frames at once (the
``--streams`` step): the same first pass with S folded into its grid as K4
folds it into K1's, each stream's count read from an (S,) array on the
device, and a second pass (``est_streams_kernel``) that gives each stream
its own rows and gates each on its own moments and count, before any sum
over streams; on K4's grid, so each stream's s1 is K4's row bit for bit.

:func:`fused_psd_sk` and :func:`fused_psd_sk_streams` dispatch on the
tensor's device: a CPU tensor runs the plain PyTorch version
(:func:`fused_psd_sk_reference`, whose s1 is
:func:`.fused_psd.fused_psd_reference`'s bit for bit, and
:func:`fused_psd_sk_streams_reference`), a CUDA tensor the kernel, or
raises. ``COUNTS.kernel_sk_plane`` counts the plane kernel's launches,
``COUNTS.kernel_sk`` the control's, ``COUNTS.kernel_sk_streams`` and
``COUNTS.kernel_sk_streams_control`` their streams launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import fused_psd as fp


def sk_keep(s1: torch.Tensor, s2: torch.Tensor, M, sigma: float
            ) -> torch.Tensor:
    """The Nita-Gary excision gate in float32, in the order of the JAX
    package's ``models/kurtosis.py:_sk_keep``: 1.0 where the block's
    |SK - 1| is within 2 sigma / sqrt(M) of the Gaussian null (or M < 2),
    else 0.0, with SK = (M + 1) / max(M - 1, 1) * (M s2 / max(s1^2, 1e-30)
    - 1). ``M`` is a number (the block's spectra) or a tensor that
    broadcasts against s1 and s2."""
    f32 = torch.float32
    M = torch.as_tensor(M, dtype=f32, device=s1.device)
    one = torch.ones((), dtype=f32, device=s1.device)
    sk = ((M + one) / torch.maximum(M - one, one)
          * (M * s2 / torch.maximum(s1 * s1, torch.tensor(1e-30, dtype=f32,
                                                           device=s1.device))
             - one))
    limit = (torch.tensor(sigma * 2.0, dtype=f32, device=s1.device)
             / torch.sqrt(torch.maximum(M, one)))
    return ((torch.abs(sk - one) <= limit) | (M < 2.0)).to(f32)


def fused_psd_sk_reference(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                           window: Optional[torch.Tensor] = None,
                           sigma: float = 0.0,
                           frame_power=fp._frame_power) -> torch.Tensor:
    """The plain PyTorch version: (F, 2N) uint8 -> (2, N) float32 (s1, s2),
    with ``sigma > 0`` (4, N) (s1, s2, s1 * keep, n_valid * keep).
    ``frame_power(raw_u8, window)`` gives each frame's |DFT|^2 (the
    chirp-Z form passes its own)."""
    F, two_n = raw_u8.shape
    N = two_n // 2
    p = frame_power(raw_u8, window)
    p[n_valid:] = 0.0
    s1 = p.reshape(F // chunk, chunk, N).sum(dim=1).sum(dim=0)
    s2 = (p * p).reshape(F // chunk, chunk, N).sum(dim=1).sum(dim=0)
    if sigma <= 0.0:
        return torch.stack([s1, s2])
    M = float(n_valid)
    keep = sk_keep(s1, s2, M, sigma)
    return torch.stack([s1, s2, s1 * keep, M * keep])


def fused_psd_sk_streams_reference(raw_u8: torch.Tensor,
                                   n_valid: torch.Tensor, chunk: int,
                                   window: Optional[torch.Tensor] = None,
                                   sigma: float = 0.0,
                                   frame_power=fp._frame_power
                                   ) -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_psd_sk_streams`: (S, F,
    2N) uint8, (S,) counts -> (S, 2, N) float32 (s1, s2) of each stream's
    first n_valid[s] frames (a count outside [0, F] acts as its nearest
    bound), with ``sigma > 0`` (S, 4, N), each stream gated on its own
    moments with M = its count. ``frame_power`` as
    :func:`fused_psd_sk_reference` takes it."""
    S, F, two_n = raw_u8.shape
    N = two_n // 2
    counts = n_valid.to(raw_u8.device).clamp(0, F)
    p = frame_power(raw_u8, window)
    keep = torch.arange(F, device=raw_u8.device)[None, :] < counts[:, None]
    p = torch.where(keep[..., None], p, 0.0)
    s1 = p.reshape(S, F // chunk, chunk, N).sum(dim=2).sum(dim=1)
    s2 = (p * p).reshape(S, F // chunk, chunk, N).sum(dim=2).sum(dim=1)
    if sigma <= 0.0:
        return torch.stack([s1, s2], dim=1)
    M = counts.to(torch.float32)[:, None]
    gate = sk_keep(s1, s2, M, sigma)
    return torch.stack([s1, s2, s1 * gate, M * gate], dim=1)


def plane_stride(N: int) -> int:
    """Floats a lane's row of the plane takes at N bins (PLANE_STRIDE): N,
    and TF more where a warp holds several lanes (TF < 32), so that their
    rows fall on other banks."""
    TF = fp.regs_shape(N).TF
    return N + TF if TF < 32 else N


def plane_smem(N: int) -> int:
    """Bytes of shared memory a block of the plane kernel takes at N bins:
    K1's, and the plane of |X|^4 sums, LANES rows of
    :func:`plane_stride` float32."""
    shape = fp.regs_shape(N)
    return shape.smem + shape.lanes * plane_stride(N) * 4


def plane_fits(N: int) -> bool:
    """The route at N bins: the plane kernel where its shared memory fits a
    block (N <= 8192), else the control."""
    return plane_smem(N) <= fp.SMEM_PER_BLOCK


def fused_psd_sk(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                 window: Optional[torch.Tensor] = None,
                 sigma: float = 0.0, group: Optional[int] = None
                 ) -> torch.Tensor:
    """(F, 2N) uint8 frames, ``n_valid`` real frames -> (2, N) float32 rows
    s1 = sum of |DFT|^2 and s2 = sum of |DFT|^4 over those frames, on the
    tensor's device; with ``sigma > 0`` (4, N), adding s1 * keep and
    n_valid * keep (:func:`sk_keep` of this call's s1, s2 and n_valid).
    ``window``: an (N,) float32 tensor on the same device, or None.

    A CUDA tensor runs the kernel :func:`plane_fits` picks on the current
    stream (asynchronously), on ``group`` frames a block where given (a
    streams call's, for a comparison on its grid), else on K1's grid; a CPU
    tensor runs the plain version."""
    return _sk("fused_psd_sk", raw_u8, n_valid, chunk, window, sigma, False,
               group)


def fused_psd_sk_control(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                         window: Optional[torch.Tensor] = None,
                         sigma: float = 0.0) -> torch.Tensor:
    """:func:`fused_psd_sk` on the kernel it was redesigned from (the
    |X|^4 sums in registers) at every N; a CPU tensor runs the plain
    version."""
    return _sk("fused_psd_sk_control", raw_u8, n_valid, chunk, window,
               sigma, True, None)


def _sk(kernel: str, raw_u8: torch.Tensor, n_valid: int, chunk: int,
        window: Optional[torch.Tensor], sigma: float,
        control: bool, group: Optional[int]) -> torch.Tensor:
    """Check, then run the plain version (CPU), or on the card the control
    (``control``) or else the kernel :func:`plane_fits` picks."""
    n_valid = int(n_valid)
    sigma = float(sigma)
    fp.check_args(kernel, fp.fused_psd_eligible, raw_u8, n_valid, chunk,
                  window)
    if not sigma >= 0.0:
        raise ValueError(f"sigma={sigma} must be >= 0")
    if group is not None and not 1 <= group <= raw_u8.shape[0]:
        raise ValueError(f"group={group} outside [1, {raw_u8.shape[0]}]")
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return fused_psd_sk_reference(raw_u8, n_valid, chunk, window, sigma)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    plane = not control and plane_fits(N)
    index = raw_u8.device.index
    # K1's (K2's) grid, from K1's occupancy: the s1 plane is K1's output.
    if group is None:
        group = fp.k1_group(F, chunk, fp.resident_blocks(
            N, window is not None, index))
    out = fp._launch(
        kernel, raw_u8, window, 2 * -(-F // group),
        (4 if sigma > 0.0 else 2, N),
        lambda lib, raw, twiddle, win, partial, out, stream:
        lib.rpf_fused_psd_sk(raw, twiddle, win, partial, out, index,
                             N.bit_length() - 1, F, group, n_valid,
                             2.0 * sigma, int(plane), stream),
        library="fused_psd_sk")
    if plane:
        fp.COUNTS.kernel_sk_plane += 1
    else:
        fp.COUNTS.kernel_sk += 1
    return out


def fused_psd_sk_streams(raw_u8: torch.Tensor, n_valid: torch.Tensor,
                         chunk: int, window: Optional[torch.Tensor] = None,
                         sigma: float = 0.0) -> torch.Tensor:
    """(S, F, 2N) uint8 frames of S streams, ``n_valid`` (S,) int32 real
    frames per stream on the frames' device -> (S, 2, N) float32, rows s1
    and s2 of each stream's first n_valid[s] frames (a count outside [0, F]
    acts as its nearest bound); with ``sigma > 0`` (S, 4, N), adding s1 *
    keep and n_valid[s] * keep, each stream gated on its own moments and
    count (:func:`sk_keep`). ``window``: an (N,) float32 tensor on the same
    device, or None.

    A CUDA tensor runs the first pass :func:`plane_fits` picks on the
    current stream (asynchronously: the kernels read ``n_valid`` from
    device memory when they run), on K4's grid; a CPU tensor runs the
    plain version."""
    return _sk_streams("fused_psd_sk_streams", raw_u8, n_valid, chunk,
                       window, sigma, False)


def fused_psd_sk_streams_control(raw_u8: torch.Tensor,
                                 n_valid: torch.Tensor, chunk: int,
                                 window: Optional[torch.Tensor] = None,
                                 sigma: float = 0.0) -> torch.Tensor:
    """:func:`fused_psd_sk_streams` with the |X|^4 sums in registers (the
    control's cut, the route at 16384 bins) at every N."""
    return _sk_streams("fused_psd_sk_streams_control", raw_u8, n_valid,
                       chunk, window, sigma, True)


def _sk_streams(kernel: str, raw_u8: torch.Tensor, n_valid: torch.Tensor,
                chunk: int, window: Optional[torch.Tensor], sigma: float,
                control: bool) -> torch.Tensor:
    sigma = float(sigma)
    fp.check_streams_args(raw_u8, n_valid, chunk, window, kernel)
    if not sigma >= 0.0:
        raise ValueError(f"sigma={sigma} must be >= 0")
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return fused_psd_sk_streams_reference(raw_u8, n_valid, chunk, window,
                                              sigma)
    S, F, N = raw_u8.shape[0], raw_u8.shape[1], raw_u8.shape[2] // 2
    plane = not control and plane_fits(N)
    index = raw_u8.device.index
    group = fp.k1_group(S * F, chunk, fp.resident_blocks(
        N, window is not None, index))
    out = fp._launch(
        kernel, raw_u8, window, 2 * S * -(-F // group),
        (S, 4 if sigma > 0.0 else 2, N),
        lambda lib, raw, twiddle, win, partial, out, stream:
        lib.rpf_fused_psd_sk_streams(raw, twiddle, win, n_valid.data_ptr(),
                                     partial, out, index, N.bit_length() - 1,
                                     S, F, group, 2.0 * sigma, int(plane),
                                     stream),
        library="fused_psd_sk")
    if plane:
        fp.COUNTS.kernel_sk_streams += 1
    else:
        fp.COUNTS.kernel_sk_streams_control += 1
    return out


def kernel_attributes(N: int, windowed: bool, plane: bool,
                      device: Optional[torch.device] = None) -> dict:
    """What the first pass gets at N bins on the card, as
    :func:`.fused_psd.kernel_attributes` gives K1's: the plane kernel's
    (``plane``) or the control's. Launches nothing."""
    return fp.library_attributes("fused_psd_sk", N, int(windowed),
                                 int(plane), device=device)
