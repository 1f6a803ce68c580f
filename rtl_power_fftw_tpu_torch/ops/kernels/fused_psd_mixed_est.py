"""The CLI estimators' steps at the awkward bin counts: spectral kurtosis
(SK-M), the multitaper (MT-M) and the polyphase filterbank (PFB-M) at the
even 7-smooth N up to 16384 (:func:`.fused_psd_mixed.fused_psd_mixed_eligible`:
500, 2400, 12000, 16000, and 2..32 among them).

The JAX package computes these estimators in XLA at every N
(``rtl_power_fftw_tpu/models/kurtosis.py:_sk_step``,
``multitaper.py:_mt_core``, ``pfb.py:_pfb_core``), with no Pallas kernel.
At the powers of two from 64 to 16384 the port runs them on K1's group
kernel (:mod:`.fused_psd_sk`, :mod:`.fused_psd_tapers`,
:mod:`.fused_psd_pfb`); here, on forms of the mixed-radix ring kernel
(``csrc/fused_psd_mixed_est.cu``: ``psd_ring_est_kernel``, the body of
``csrc/fused_psd_mixed_ring.cuh``'s kernel with a cut), each the function
of its power-of-two counterpart:

* :func:`fused_psd_sk_mixed`: (F, 2N) frames -> (2, N) s1 = the sum of
  |X|^2, s2 = the sum of |X|^4 over the valid frames; with ``sigma > 0``
  (4, N), the block's gate (:func:`.fused_psd_sk.sk_keep`) as the second
  pass's epilogue. The |X|^4 sums sit in registers beside the |X|^2 sums,
  whose expression is the mixed-radix kernel's; on that kernel's grid
  (:func:`.fused_psd_mixed.mixed_group` from its own residency, which this
  wrapper takes) s1 is :func:`.fused_psd_mixed.fused_psd_mixed`'s output
  bit for bit.
* :func:`fused_psd_tapers_mixed`: the mean over K tapers of |DFT(x *
  taper_k)|^2 summed over the valid frames, the tapers on the grid's y
  axis (block (g, k) under taper k writes partial row k G + g), the K G
  rows summed in float64 and divided by K.
* :func:`fused_psd_pfb_mixed`: |DFT(S_j)|^2 of the polyphase sums S_j =
  sum over p of h[p] x_{j+p} (p in order from zero, float32, no FMA) over P
  - 1 history rows and the F slot rows, the next history written to
  ``history_out`` on the stream; the ring slot holds each frame's own row,
  the P - 1 older rows are read through L1/L2.

Each dispatches on the tensor's device: a CPU tensor runs the plain
PyTorch version of its power-of-two counterpart
(:func:`.fused_psd_sk.fused_psd_sk_reference`,
:func:`.fused_psd_tapers.fused_psd_tapers_reference`,
:func:`.fused_psd_pfb.fused_psd_pfb_reference`; ``torch.fft.fft`` takes any
N on the CPU); a CUDA tensor the kernel, or raises. ``COUNTS.kernel_sk_mixed``,
``COUNTS.kernel_tapers_mixed`` and ``COUNTS.kernel_pfb_mixed`` (in
:mod:`.fused_psd`) count their launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import fused_psd as fp
from . import fused_psd_mixed as fm
from .fused_psd_large import _raw_stream
from .fused_psd_pfb import check_pfb_args, fused_psd_pfb_reference
from .fused_psd_sk import fused_psd_sk_reference
from .fused_psd_tapers import check_tapers, fused_psd_tapers_reference

#: The cuts of psd_ring_est_kernel, kept in step with the source (kRingSk,
#: kRingTapers, kRingPfb).
SK, TAPERS, PFB = 1, 2, 3
LIBRARY = "fused_psd_mixed_est"


@functools.lru_cache(maxsize=64)
def _plan_ints(shape: fm.RingLaunch) -> ctypes.Array:
    """The ring plan ints of ``shape`` as the entries take them."""
    ints = shape.ints()
    return (ctypes.c_int * len(ints))(*ints)


def kernel_attributes(N: int, cut: int, windowed: bool = False,
                      device: Optional[torch.device] = None) -> dict:
    """What the first pass of ``cut`` (:data:`SK`, :data:`TAPERS`,
    :data:`PFB`) gets at N bins on the card: registers and spill bytes a
    thread, static and dynamic shared bytes and threads a block, and the
    blocks that reside on one SM. Launches nothing."""
    from . import _build
    device = device or torch.device("cuda", torch.cuda.current_device())
    lib = _build.load(LIBRARY)
    attrs = (ctypes.c_int * 6)()
    err = lib.rpf_fused_psd_mixed_est_attributes(
        ctypes.addressof(_plan_ints(fm.ring_launch(N))), cut, int(windowed),
        device.index or 0, attrs)
    if err != 0:
        raise fp.launch_error(f"{LIBRARY} attributes of cut {cut} at N={N}",
                              lib, err)
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "dynamic_smem", "threads", "blocks_per_sm"), attrs))


@functools.lru_cache(maxsize=64)
def resident_blocks(N: int, cut: int, windowed: bool, index: int) -> int:
    """Blocks of ``cut``'s kernel at N bins that card ``index`` holds
    resident. Asked of the card once per key."""
    return fp.resident_of(kernel_attributes(N, cut, windowed,
                                            torch.device("cuda", index)),
                          index)


def sk_group(F: int, chunk: int, N: int, windowed: bool, index: int) -> int:
    """Frames a block of SK-M sums: the mixed-radix kernel's own grid
    (mixed_group over its residency), so that s1 is its output."""
    shape = fm.ring_launch(N)
    return fm.mixed_group(F, chunk, fm.ring_resident_blocks(shape, windowed,
                                                            index),
                          shape.lanes)


def tapers_group(F: int, chunk: int, N: int, K: int, index: int) -> int:
    """Frames a block of MT-M sums: mixed_group over the blocks the card
    holds at once for each of the K tapers."""
    return fm.mixed_group(F, chunk,
                          max(1, resident_blocks(N, TAPERS, True, index) // K),
                          fm.ring_launch(N).lanes)


def pfb_group(F: int, chunk: int, N: int, index: int) -> int:
    """Frames a block of PFB-M sums: mixed_group over its residency."""
    return fm.mixed_group(F, chunk, resident_blocks(N, PFB, False, index),
                          fm.ring_launch(N).lanes)


def _launch(kernel: str, raw_u8: torch.Tensor, extra: Optional[torch.Tensor],
            rows: int, out_rows: int, call) -> torch.Tensor:
    """Check the loads' alignment, take the (rows, row) partial rows and
    make the (out_rows, row) output, then run ``call(lib, twiddle, order,
    plan, partial, out, width, stream)`` on the current stream, with the
    mixed-radix kernel's tables (plan_twiddles, element_of_bin, the ring
    plan ints) at N. Returns the output's first N columns, (N,) where
    ``out_rows`` is 1."""
    from . import _build
    fp.check_alignment(kernel, raw_u8, fm.RING_RAW_ALIGN, extra,
                       fm.WINDOW_ALIGN)
    N = raw_u8.shape[1] // 2
    shape = fm.ring_launch(N)
    device = raw_u8.device
    stream = _raw_stream(device.index)
    lib = _build.load(LIBRARY)
    partial = fm.partial_rows(shape.row, rows, device, stream)
    out = torch.empty((out_rows, shape.row), dtype=torch.float32,
                      device=device)
    err = call(lib, fm._device_twiddles(shape.plan, device).data_ptr(),
               fm._device_order(shape.plan, device).data_ptr(),
               ctypes.addressof(_plan_ints(shape)), partial, out.data_ptr(),
               fm.copy_width(N, raw_u8.data_ptr()), stream)
    if err != 0:
        raise fp.launch_error(kernel, lib, err)
    return out[0, :N] if out_rows == 1 else out[:, :N]


def fused_psd_sk_mixed(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                       window: Optional[torch.Tensor] = None,
                       sigma: float = 0.0) -> torch.Tensor:
    """SK-M: (F, 2N) uint8 frames, N even and 7-smooth up to 16384,
    ``n_valid`` real frames -> (2, N) float32 rows s1 = sum of |DFT|^2 and
    s2 = sum of |DFT|^4 over those frames; with ``sigma > 0`` (4, N),
    adding s1 * keep and n_valid * keep. ``window``: an (N,) float32
    tensor on the same device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously),
    on the mixed-radix kernel's grid (:func:`sk_group`); a CPU tensor runs
    the plain version."""
    kernel = "fused_psd_sk_mixed"
    n_valid, sigma = int(n_valid), float(sigma)
    fp.check_args(kernel, fm.fused_psd_mixed_eligible, raw_u8, n_valid, chunk,
                  window)
    if not sigma >= 0.0:
        raise ValueError(f"sigma={sigma} must be >= 0")
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return fused_psd_sk_reference(raw_u8, n_valid, chunk, window, sigma)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    device = raw_u8.device
    group = sk_group(F, chunk, N, window is not None, device.index)
    out = _launch(
        kernel, raw_u8, window, 2 * -(-F // group), 4 if sigma > 0.0 else 2,
        lambda lib, twiddle, order, plan, partial, out, width, stream:
        lib.rpf_fused_psd_sk_mixed(
            raw_u8.data_ptr(), twiddle, order,
            None if window is None else window.data_ptr(), partial, out,
            plan, device.index, F, group, n_valid, 2.0 * sigma, width,
            stream))
    fp.COUNTS.kernel_sk_mixed += 1
    return out


def fused_psd_tapers_mixed(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                           tapers: torch.Tensor) -> torch.Tensor:
    """MT-M: (F, 2N) uint8 frames, N even and 7-smooth up to 16384,
    ``n_valid`` real frames, (K, N) float32 ``tapers`` on the same device
    -> (N,) float32: the sum over those frames of the mean over the K
    tapers of |DFT(x * taper_k)|^2.

    A CUDA tensor runs the kernel on the current stream (asynchronously),
    on :func:`tapers_group`'s grid; a CPU tensor runs the plain version."""
    kernel = "fused_psd_tapers_mixed"
    n_valid = int(n_valid)
    fp.check_args(kernel, fm.fused_psd_mixed_eligible, raw_u8, n_valid, chunk,
                  None)
    check_tapers(tapers, raw_u8)
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return fused_psd_tapers_reference(raw_u8, n_valid, chunk, tapers)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    K = tapers.shape[0]
    device = raw_u8.device
    group = tapers_group(F, chunk, N, K, device.index)
    out = _launch(
        kernel, raw_u8, tapers, K * -(-F // group), 1,
        lambda lib, twiddle, order, plan, partial, out, width, stream:
        lib.rpf_fused_psd_tapers_mixed(
            raw_u8.data_ptr(), twiddle, order, tapers.data_ptr(), partial,
            out, plan, device.index, F, group, K, n_valid, width, stream))
    fp.COUNTS.kernel_tapers_mixed += 1
    return out


def fused_psd_pfb_mixed(raw_u8: torch.Tensor, history: torch.Tensor,
                        n_valid: int, chunk: int, h: torch.Tensor,
                        history_out: torch.Tensor, fresh: bool = False
                        ) -> torch.Tensor:
    """PFB-M: (F, 2N) uint8 frames (N even and 7-smooth up to 16384) after
    (P - 1, 2N) uint8 ``history`` rows, ``n_valid`` real frames, a (P, N)
    float32 prototype ``h`` -> (N,) float32 sum over those frames of
    |DFT(polyphase sum)|^2; the next history goes to ``history_out``
    (distinct from ``history``). With ``fresh`` the history is taken as
    byte 127 (a reset) and set so. All on the frames' device.

    A CUDA tensor runs the kernel on the current stream (asynchronously:
    ``history_out`` is written after the kernel on that stream), on
    :func:`pfb_group`'s grid; a CPU tensor runs the plain version."""
    kernel = "fused_psd_pfb_mixed"
    n_valid = int(n_valid)
    fp.check_args(kernel, fm.fused_psd_mixed_eligible, raw_u8, n_valid, chunk,
                  None)
    check_pfb_args(raw_u8, history, h, history_out)
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return fused_psd_pfb_reference(raw_u8, history, n_valid, chunk, h,
                                       history_out, fresh)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    P = h.shape[0]
    device = raw_u8.device
    if history.data_ptr() % 2:
        raise ValueError(f"{kernel}: history must be 2-byte aligned on the "
                         "device")
    group = pfb_group(F, chunk, N, device.index)
    out = _launch(
        kernel, raw_u8, h, -(-F // group), 1,
        lambda lib, twiddle, order, plan, partial, out, width, stream:
        lib.rpf_fused_psd_pfb_mixed(
            raw_u8.data_ptr(), history.data_ptr() or None, twiddle, order,
            h.data_ptr(), partial, out, history_out.data_ptr() or None, plan,
            device.index, F, group, n_valid, P, int(fresh), width, stream))
    fp.COUNTS.kernel_pfb_mixed += 1
    return out
