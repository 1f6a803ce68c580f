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

:func:`fused_psd_sk_mixed_streams`, :func:`fused_psd_tapers_mixed_streams`
and :func:`fused_psd_pfb_mixed_streams` (SK-M-S, MT-M-S, PFB-M-S) run S
streams of F frames at once (the ``--streams`` steps): the same forms with
the stream folded into the grid's x axis as the mixed-radix kernel's
streams entry folds it (block g serves stream g / G_s), each stream's
count read from an (S,) array on the device; SK's and the multitaper's
second pass is ``est_streams_kernel`` (each stream's rows in one stream's
order, each stream gated on its own moments and count), the PFB's the
row sum, then each stream's next history (``pfb_history.cuh``). On the
same grid each stream's rows are the one-stream form's, and SK-M-S's s1
is :func:`.fused_psd_mixed.fused_psd_mixed_streams`'s row bit for bit.

Each dispatches on the tensor's device: a CPU tensor runs the plain
PyTorch version of its power-of-two counterpart
(:func:`.fused_psd_sk.fused_psd_sk_reference`,
:func:`.fused_psd_tapers.fused_psd_tapers_reference`,
:func:`.fused_psd_pfb.fused_psd_pfb_reference` and their streams forms;
``torch.fft.fft`` takes any N on the CPU); a CUDA tensor the kernel, or
raises. ``COUNTS.kernel_sk_mixed``, ``COUNTS.kernel_tapers_mixed`` and
``COUNTS.kernel_pfb_mixed`` (in :mod:`.fused_psd`) count their launches,
with ``_streams`` after each the streams forms'.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import fused_psd as fp
from . import fused_psd_mixed as fm
from .fused_psd_large import _raw_stream
from .fused_psd_pfb import (check_pfb_args, check_pfb_streams_args,
                            fused_psd_pfb_reference,
                            fused_psd_pfb_streams_reference)
from .fused_psd_sk import (fused_psd_sk_reference,
                           fused_psd_sk_streams_reference)
from .fused_psd_tapers import (check_tapers, fused_psd_tapers_reference,
                               fused_psd_tapers_streams_reference)

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
                      device: Optional[torch.device] = None,
                      streams: bool = False) -> dict:
    """What the first pass of ``cut`` (:data:`SK`, :data:`TAPERS`,
    :data:`PFB`; its streams form where ``streams``) gets at N bins on the
    card: registers and spill bytes a thread, static and dynamic shared
    bytes and threads a block, and the blocks that reside on one SM.
    Launches nothing."""
    from . import _build
    device = device or torch.device("cuda", torch.cuda.current_device())
    lib = _build.load(LIBRARY)
    attrs = (ctypes.c_int * 6)()
    entry = (lib.rpf_fused_psd_mixed_est_streams_attributes if streams
             else lib.rpf_fused_psd_mixed_est_attributes)
    err = entry(ctypes.addressof(_plan_ints(fm.ring_launch(N))), cut,
                int(windowed), device.index or 0, attrs)
    if err != 0:
        raise fp.launch_error(f"{LIBRARY} attributes of cut {cut} at N={N}",
                              lib, err)
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "dynamic_smem", "threads", "blocks_per_sm"), attrs))


@functools.lru_cache(maxsize=64)
def resident_blocks(N: int, cut: int, windowed: bool, index: int,
                    streams: bool = False) -> int:
    """Blocks of ``cut``'s kernel (its streams form where ``streams``) at
    N bins that card ``index`` holds resident. Asked of the card once per
    key."""
    return fp.resident_of(kernel_attributes(N, cut, windowed,
                                            torch.device("cuda", index),
                                            streams), index)


def sk_group(F: int, chunk: int, N: int, windowed: bool, index: int) -> int:
    """Frames a block of SK-M sums over F frames (S F for SK-M-S): the
    mixed-radix kernel's own grid (mixed_group over its residency, as
    :func:`.fused_psd_mixed.fused_psd_mixed` and its streams entry take
    it), so that s1 is its output."""
    shape = fm.ring_launch(N)
    return fm.mixed_group(F, chunk, fm.ring_resident_blocks(shape, windowed,
                                                            index),
                          shape.lanes)


def tapers_group(F: int, chunk: int, N: int, K: int, index: int,
                 streams: bool = False) -> int:
    """Frames a block of MT-M sums over F frames (S F for MT-M-S,
    ``streams``): mixed_group over the blocks the card holds at once for
    each of the K tapers."""
    resident = resident_blocks(N, TAPERS, True, index, streams)
    return fm.mixed_group(F, chunk, max(1, resident // K),
                          fm.ring_launch(N).lanes)


def pfb_group(F: int, chunk: int, N: int, index: int,
              streams: bool = False) -> int:
    """Frames a block of PFB-M sums over F frames (S F for PFB-M-S,
    ``streams``): mixed_group over its residency."""
    return fm.mixed_group(F, chunk,
                          resident_blocks(N, PFB, False, index, streams),
                          fm.ring_launch(N).lanes)


def check_group(group: Optional[int], F: int) -> None:
    """Raise unless ``group`` (frames a block, where given) is in [1,
    F]."""
    if group is not None and not 1 <= group <= F:
        raise ValueError(f"group={group} outside [1, {F}]")


def _launch(kernel: str, raw_u8: torch.Tensor, extra: Optional[torch.Tensor],
            rows: int, out_shape: tuple, call) -> torch.Tensor:
    """Check the loads' alignment, take the (rows, row) partial rows and
    make the (*out_shape, row) output, then run ``call(lib, twiddle,
    order, plan, partial, out, width, stream)`` on the current stream,
    with the mixed-radix kernel's tables (plan_twiddles, element_of_bin,
    the ring plan ints) at N. ``raw_u8`` is (F, 2N) or (S, F, 2N): a
    stream's first row lies 2N F bytes past the last's, and the copy width
    divides 2N, so the width the base takes every stream's rows take.
    Returns the output's first N columns, (*out_shape, N)."""
    from . import _build
    fp.check_alignment(kernel, raw_u8, fm.RING_RAW_ALIGN, extra,
                       fm.WINDOW_ALIGN)
    N = raw_u8.shape[-1] // 2
    shape = fm.ring_launch(N)
    device = raw_u8.device
    stream = _raw_stream(device.index)
    lib = _build.load(LIBRARY)
    partial = fm.partial_rows(shape.row, rows, device, stream)
    out = torch.empty((*out_shape, shape.row), dtype=torch.float32,
                      device=device)
    err = call(lib, fm._device_twiddles(shape.plan, device).data_ptr(),
               fm._device_order(shape.plan, device).data_ptr(),
               ctypes.addressof(_plan_ints(shape)), partial, out.data_ptr(),
               fm.copy_width(N, raw_u8.data_ptr()), stream)
    if err != 0:
        raise fp.launch_error(kernel, lib, err)
    return out[..., :N]


def fused_psd_sk_mixed(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                       window: Optional[torch.Tensor] = None,
                       sigma: float = 0.0, group: Optional[int] = None
                       ) -> torch.Tensor:
    """SK-M: (F, 2N) uint8 frames, N even and 7-smooth up to 16384,
    ``n_valid`` real frames -> (2, N) float32 rows s1 = sum of |DFT|^2 and
    s2 = sum of |DFT|^4 over those frames; with ``sigma > 0`` (4, N),
    adding s1 * keep and n_valid * keep. ``window``: an (N,) float32
    tensor on the same device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously),
    on ``group`` frames a block where given (a streams call's, for a
    comparison on its grid), else on the mixed-radix kernel's grid
    (:func:`sk_group`); a CPU tensor runs the plain version."""
    kernel = "fused_psd_sk_mixed"
    n_valid, sigma = int(n_valid), float(sigma)
    fp.check_args(kernel, fm.fused_psd_mixed_eligible, raw_u8, n_valid, chunk,
                  window)
    if not sigma >= 0.0:
        raise ValueError(f"sigma={sigma} must be >= 0")
    check_group(group, raw_u8.shape[0])
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return fused_psd_sk_reference(raw_u8, n_valid, chunk, window, sigma)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    device = raw_u8.device
    group = group or sk_group(F, chunk, N, window is not None, device.index)
    out = _launch(
        kernel, raw_u8, window, 2 * -(-F // group),
        (4 if sigma > 0.0 else 2,),
        lambda lib, twiddle, order, plan, partial, out, width, stream:
        lib.rpf_fused_psd_sk_mixed(
            raw_u8.data_ptr(), twiddle, order,
            None if window is None else window.data_ptr(), partial, out,
            plan, device.index, F, group, n_valid, 2.0 * sigma, width,
            stream))
    fp.COUNTS.kernel_sk_mixed += 1
    return out


def fused_psd_tapers_mixed(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                           tapers: torch.Tensor, group: Optional[int] = None
                           ) -> torch.Tensor:
    """MT-M: (F, 2N) uint8 frames, N even and 7-smooth up to 16384,
    ``n_valid`` real frames, (K, N) float32 ``tapers`` on the same device
    -> (N,) float32: the sum over those frames of the mean over the K
    tapers of |DFT(x * taper_k)|^2.

    A CUDA tensor runs the kernel on the current stream (asynchronously),
    on ``group`` frames a block where given, else on :func:`tapers_group`'s
    grid; a CPU tensor runs the plain version."""
    kernel = "fused_psd_tapers_mixed"
    n_valid = int(n_valid)
    fp.check_args(kernel, fm.fused_psd_mixed_eligible, raw_u8, n_valid, chunk,
                  None)
    check_tapers(tapers, raw_u8)
    check_group(group, raw_u8.shape[0])
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return fused_psd_tapers_reference(raw_u8, n_valid, chunk, tapers)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    K = tapers.shape[0]
    device = raw_u8.device
    group = group or tapers_group(F, chunk, N, K, device.index)
    out = _launch(
        kernel, raw_u8, tapers, K * -(-F // group), (),
        lambda lib, twiddle, order, plan, partial, out, width, stream:
        lib.rpf_fused_psd_tapers_mixed(
            raw_u8.data_ptr(), twiddle, order, tapers.data_ptr(), partial,
            out, plan, device.index, F, group, K, n_valid, width, stream))
    fp.COUNTS.kernel_tapers_mixed += 1
    return out


def fused_psd_pfb_mixed(raw_u8: torch.Tensor, history: torch.Tensor,
                        n_valid: int, chunk: int, h: torch.Tensor,
                        history_out: torch.Tensor, fresh: bool = False,
                        group: Optional[int] = None) -> torch.Tensor:
    """PFB-M: (F, 2N) uint8 frames (N even and 7-smooth up to 16384) after
    (P - 1, 2N) uint8 ``history`` rows, ``n_valid`` real frames, a (P, N)
    float32 prototype ``h`` -> (N,) float32 sum over those frames of
    |DFT(polyphase sum)|^2; the next history goes to ``history_out``
    (distinct from ``history``). With ``fresh`` the history is taken as
    byte 127 (a reset) and set so. All on the frames' device.

    A CUDA tensor runs the kernel on the current stream (asynchronously:
    ``history_out`` is written after the kernel on that stream), on
    ``group`` frames a block where given, else on :func:`pfb_group`'s
    grid; a CPU tensor runs the plain version."""
    kernel = "fused_psd_pfb_mixed"
    n_valid = int(n_valid)
    fp.check_args(kernel, fm.fused_psd_mixed_eligible, raw_u8, n_valid, chunk,
                  None)
    check_pfb_args(raw_u8, history, h, history_out)
    check_group(group, raw_u8.shape[0])
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
    group = group or pfb_group(F, chunk, N, device.index)
    out = _launch(
        kernel, raw_u8, h, -(-F // group), (),
        lambda lib, twiddle, order, plan, partial, out, width, stream:
        lib.rpf_fused_psd_pfb_mixed(
            raw_u8.data_ptr(), history.data_ptr() or None, twiddle, order,
            h.data_ptr(), partial, out, history_out.data_ptr() or None, plan,
            device.index, F, group, n_valid, P, int(fresh), width, stream))
    fp.COUNTS.kernel_pfb_mixed += 1
    return out


def check_streams_histories(kernel: str, history: torch.Tensor,
                            history_out: torch.Tensor) -> None:
    """Raise unless both (S, P - 1, 2N) histories on the card are 4-byte
    aligned, as the kernel that writes the next ones reads and writes them
    4 bytes a thread (pfb_history.cuh)."""
    for name, t in (("history", history), ("history_out", history_out)):
        if t.data_ptr() % 4:
            raise ValueError(f"{kernel}: {name} must be 4-byte aligned on "
                             "the device")


def fused_psd_sk_mixed_streams(raw_u8: torch.Tensor, n_valid: torch.Tensor,
                               chunk: int,
                               window: Optional[torch.Tensor] = None,
                               sigma: float = 0.0) -> torch.Tensor:
    """SK-M-S: (S, F, 2N) uint8 frames of S streams (N even and 7-smooth
    up to 16384), ``n_valid`` (S,) int32 real frames per stream on the
    frames' device -> (S, 2, N) float32, rows s1 and s2 of each stream's
    first n_valid[s] frames (a count outside [0, F] acts as its nearest
    bound); with ``sigma > 0`` (S, 4, N), adding s1 * keep and n_valid[s]
    * keep, each stream gated on its own moments and count. ``window``: an
    (N,) float32 tensor on the same device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously:
    the kernels read ``n_valid`` from device memory when they run), on
    :func:`.fused_psd_mixed.fused_psd_mixed_streams`'s grid
    (:func:`sk_group` over all S F frames), so that each stream's s1 is its
    row; a CPU tensor runs the plain version."""
    kernel = "fused_psd_sk_mixed_streams"
    sigma = float(sigma)
    fp.check_streams_args(raw_u8, n_valid, chunk, window, kernel,
                          fm.fused_psd_mixed_eligible)
    if not sigma >= 0.0:
        raise ValueError(f"sigma={sigma} must be >= 0")
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return fused_psd_sk_streams_reference(raw_u8, n_valid, chunk, window,
                                              sigma)
    S, F, N = raw_u8.shape[0], raw_u8.shape[1], raw_u8.shape[2] // 2
    device = raw_u8.device
    group = sk_group(S * F, chunk, N, window is not None, device.index)
    out = _launch(
        kernel, raw_u8, window, 2 * S * (F // group),
        (S, 4 if sigma > 0.0 else 2),
        lambda lib, twiddle, order, plan, partial, out, width, stream:
        lib.rpf_fused_psd_sk_mixed_streams(
            raw_u8.data_ptr(), twiddle, order,
            None if window is None else window.data_ptr(),
            n_valid.data_ptr(), partial, out, plan, device.index, S, F,
            group, 2.0 * sigma, width, stream))
    fp.COUNTS.kernel_sk_mixed_streams += 1
    return out


def fused_psd_tapers_mixed_streams(raw_u8: torch.Tensor,
                                   n_valid: torch.Tensor, chunk: int,
                                   tapers: torch.Tensor) -> torch.Tensor:
    """MT-M-S: (S, F, 2N) uint8 frames of S streams, ``n_valid`` (S,)
    int32 real frames per stream, (K, N) float32 ``tapers``, all on one
    device -> (S, N) float32: row s the sum over stream s's first
    n_valid[s] frames of the mean over the K tapers of |DFT(x *
    taper_k)|^2.

    A CUDA tensor runs the kernel on the current stream (asynchronously),
    on :func:`tapers_group`'s grid over all S F frames, the tapers on the
    grid's y axis; a CPU tensor runs the plain version."""
    kernel = "fused_psd_tapers_mixed_streams"
    fp.check_streams_args(raw_u8, n_valid, chunk, None, kernel,
                          fm.fused_psd_mixed_eligible)
    check_tapers(tapers, raw_u8)
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return fused_psd_tapers_streams_reference(raw_u8, n_valid, chunk,
                                                  tapers)
    S, F, N = raw_u8.shape[0], raw_u8.shape[1], raw_u8.shape[2] // 2
    K = tapers.shape[0]
    device = raw_u8.device
    group = tapers_group(S * F, chunk, N, K, device.index, streams=True)
    out = _launch(
        kernel, raw_u8, tapers, K * S * (F // group), (S,),
        lambda lib, twiddle, order, plan, partial, out, width, stream:
        lib.rpf_fused_psd_tapers_mixed_streams(
            raw_u8.data_ptr(), twiddle, order, tapers.data_ptr(),
            n_valid.data_ptr(), partial, out, plan, device.index, S, F,
            group, K, width, stream))
    fp.COUNTS.kernel_tapers_mixed_streams += 1
    return out


def fused_psd_pfb_mixed_streams(raw_u8: torch.Tensor, history: torch.Tensor,
                                n_valid: torch.Tensor, chunk: int,
                                h: torch.Tensor, history_out: torch.Tensor,
                                fresh: bool = False) -> torch.Tensor:
    """PFB-M-S: (S, F, 2N) uint8 frames of S streams (N even and 7-smooth
    up to 16384), each after its (P - 1, 2N) rows of the (S, P - 1, 2N)
    uint8 ``history``, ``n_valid`` (S,) int32 real frames per stream, a
    (P, N) float32 prototype ``h`` -> (S, N) float32, row s
    :func:`fused_psd_pfb_mixed` of stream s (a count outside [0, F] acts
    as its nearest bound); each stream's next history goes to its rows of
    ``history_out`` (distinct from ``history``); with ``fresh`` every
    stream's history is taken as byte 127 (a reset) and set so. All on the
    frames' device.

    A CUDA tensor runs the kernel on the current stream (asynchronously:
    the kernels read ``n_valid`` from device memory when they run, and
    write ``history_out`` after the sum), on :func:`pfb_group`'s grid over
    all S F frames; a CPU tensor runs the plain version."""
    kernel = "fused_psd_pfb_mixed_streams"
    fp.check_streams_args(raw_u8, n_valid, chunk, None, kernel,
                          fm.fused_psd_mixed_eligible)
    check_pfb_streams_args(raw_u8, history, h, history_out)
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return fused_psd_pfb_streams_reference(raw_u8, history, n_valid,
                                               chunk, h, history_out, fresh)
    S, F, N = raw_u8.shape[0], raw_u8.shape[1], raw_u8.shape[2] // 2
    P = h.shape[0]
    device = raw_u8.device
    check_streams_histories(kernel, history, history_out)
    group = pfb_group(S * F, chunk, N, device.index, streams=True)
    out = _launch(
        kernel, raw_u8, h, S * (F // group), (S,),
        lambda lib, twiddle, order, plan, partial, out, width, stream:
        lib.rpf_fused_psd_pfb_mixed_streams(
            raw_u8.data_ptr(), history.data_ptr() or None, twiddle, order,
            h.data_ptr(), n_valid.data_ptr(), partial, out,
            history_out.data_ptr() or None, plan, device.index, S, F, group,
            P, int(fresh), width, stream))
    fp.COUNTS.kernel_pfb_mixed_streams += 1
    return out
