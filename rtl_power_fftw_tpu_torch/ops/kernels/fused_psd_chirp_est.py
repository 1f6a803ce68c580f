"""The CLI estimators' steps at the chirp-Z bin counts: spectral kurtosis
(SK-B), the multitaper (MT-B) and the polyphase filterbank (PFB-B) at the
even N up to 8192 (:func:`.fused_psd_bluestein.fused_psd_bluestein_eligible`:
998, 4094, 8188 and 22 among them, and the powers of two under
``--fft-backend bluestein``).

The JAX package computes these estimators in XLA at every N
(``rtl_power_fftw_tpu/models/kurtosis.py:_sk_step``,
``multitaper.py:_mt_core``, ``pfb.py:_pfb_core``; under ``bluestein`` its
SK step runs ``ops/dft.py:dft_power_bluestein``), with no Pallas kernel.
Here they are forms of the chirp-Z kernel B (``csrc/fused_psd_chirp_est.cu``:
``psd_chirp_est_kernel``, the body of ``csrc/fused_psd_chirp.cuh``'s
kernel with a cut), each the function of its power-of-two counterpart:

* :func:`fused_psd_sk_chirp`: (F, 2N) frames -> (2, N) s1 = the sum of
  |X|^2, s2 = the sum of |X|^4 over the valid frames; with ``sigma > 0``
  (4, N), the block's gate (:func:`.fused_psd_sk.sk_keep`) as the second
  pass's epilogue. The |X|^4 sums sit in registers beside the |X|^2 sums,
  whose expression is B's; on B's grid (:func:`.fused_psd.k1_group` over
  :func:`.fused_psd_bluestein.chirp_resident_blocks`, which this wrapper
  takes) s1 is :func:`.fused_psd_bluestein.fused_psd_bluestein`'s output
  bit for bit.
* :func:`fused_psd_tapers_chirp`: the mean over K tapers of |DFT(x *
  taper_k)|^2 summed over the valid frames, the tapers on the grid's y
  axis (block (g, k) under taper k writes partial row k G + g), the K G
  rows summed in float64 and divided by K.
* :func:`fused_psd_pfb_chirp`: |DFT(S_j)|^2 of the polyphase sums S_j =
  sum over p of h[p] x_{j+p} (p in order from zero, float32, no FMA), each
  taken before the chirp product, over P - 1 history rows and the F slot
  rows, the next history written to ``history_out`` on the stream; the
  ring slot holds each frame's own row, the P - 1 older rows are read
  through L1/L2.

:func:`fused_psd_sk_chirp_streams`, :func:`fused_psd_tapers_chirp_streams`
and :func:`fused_psd_pfb_chirp_streams` (SK-B-S, MT-B-S, PFB-B-S) run S
streams of F frames at once (the ``--streams`` steps): the same forms with
the stream folded into the grid's x axis as B's streams entry folds it
(block g serves stream g / G_s), each stream's count read from an (S,)
array on the device; the second passes as the mixed-radix forms'
(:mod:`.fused_psd_mixed_est`). On the same grid each stream's rows are the
one-stream form's, and SK-B-S's s1 is
:func:`.fused_psd_bluestein.fused_psd_bluestein_streams`'s row bit for
bit.

Each dispatches on the tensor's device: a CPU tensor runs the plain
PyTorch version (:func:`sk_chirp_reference`, :func:`tapers_chirp_reference`,
:func:`pfb_chirp_reference` and their streams forms: its power-of-two
counterpart's, with the chirp-Z algorithm of
:func:`.fused_psd_bluestein.chirp_power` in torch ops for the transform);
a CUDA tensor the kernel, or raises. ``COUNTS.kernel_sk_chirp``,
``COUNTS.kernel_tapers_chirp`` and ``COUNTS.kernel_pfb_chirp`` (in
:mod:`.fused_psd`) count their launches, with ``_streams`` after each the
streams forms'.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import fused_psd as fp
from . import fused_psd_bluestein as fb
from .fused_psd_large import _raw_stream
from .fused_psd_mixed import (RING_RAW_ALIGN, WINDOW_ALIGN, copy_width,
                              partial_rows)
from .fused_psd_mixed_est import check_group, check_streams_histories
from .fused_psd_pfb import (check_pfb_args, check_pfb_streams_args,
                            fused_psd_pfb_reference,
                            fused_psd_pfb_streams_reference)
from .fused_psd_sk import (fused_psd_sk_reference,
                           fused_psd_sk_streams_reference)
from .fused_psd_tapers import (check_tapers, fused_psd_tapers_reference,
                               fused_psd_tapers_streams_reference)

#: The cuts of psd_chirp_est_kernel, kept in step with the source
#: (kChirpSk, kChirpTapers, kChirpPfb).
SK, TAPERS, PFB = 1, 2, 3
LIBRARY = "fused_psd_chirp_est"


def sk_chirp_reference(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                       window: Optional[torch.Tensor] = None,
                       sigma: float = 0.0) -> torch.Tensor:
    """The plain version of :func:`fused_psd_sk_chirp`: the SK step's on
    B's plain |DFT|^2, so that its s1 is
    :func:`.fused_psd_bluestein.bluestein_psd_reference`'s bit for bit."""
    return fused_psd_sk_reference(raw_u8, n_valid, chunk, window, sigma,
                                  frame_power=fb._power)


def tapers_chirp_reference(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                           tapers: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`fused_psd_tapers_chirp`."""
    return fused_psd_tapers_reference(raw_u8, n_valid, chunk, tapers,
                                      dft_power=fb.chirp_power)


def pfb_chirp_reference(raw_u8: torch.Tensor, history: torch.Tensor,
                        n_valid: int, chunk: int, h: torch.Tensor,
                        history_out: torch.Tensor, fresh: bool = False
                        ) -> torch.Tensor:
    """The plain version of :func:`fused_psd_pfb_chirp`."""
    return fused_psd_pfb_reference(raw_u8, history, n_valid, chunk, h,
                                   history_out, fresh,
                                   dft_power=fb.chirp_power)


def sk_chirp_streams_reference(raw_u8: torch.Tensor, n_valid: torch.Tensor,
                               chunk: int,
                               window: Optional[torch.Tensor] = None,
                               sigma: float = 0.0) -> torch.Tensor:
    """The plain version of :func:`fused_psd_sk_chirp_streams`: the SK
    streams step's on B's plain |DFT|^2, so that each stream's s1 is
    :func:`.fused_psd_bluestein.bluestein_psd_streams_reference`'s row bit
    for bit."""
    return fused_psd_sk_streams_reference(raw_u8, n_valid, chunk, window,
                                          sigma, frame_power=fb._power)


def tapers_chirp_streams_reference(raw_u8: torch.Tensor,
                                   n_valid: torch.Tensor, chunk: int,
                                   tapers: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`fused_psd_tapers_chirp_streams`."""
    return fused_psd_tapers_streams_reference(raw_u8, n_valid, chunk, tapers,
                                              dft_power=fb.chirp_power)


def pfb_chirp_streams_reference(raw_u8: torch.Tensor, history: torch.Tensor,
                                n_valid: torch.Tensor, chunk: int,
                                h: torch.Tensor, history_out: torch.Tensor,
                                fresh: bool = False) -> torch.Tensor:
    """The plain version of :func:`fused_psd_pfb_chirp_streams`."""
    return fused_psd_pfb_streams_reference(raw_u8, history, n_valid, chunk,
                                           h, history_out, fresh,
                                           dft_power=fb.chirp_power)


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
    entry = (lib.rpf_fused_psd_chirp_est_streams_attributes if streams
             else lib.rpf_fused_psd_chirp_est_attributes)
    err = entry(fb.chirp_launch(N).log2m, N, cut, int(windowed),
                device.index or 0, attrs)
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
    """Frames a block of SK-B sums over F frames (S F for SK-B-S): B's own
    grid (k1_group over its residency, as
    :func:`.fused_psd_bluestein.fused_psd_bluestein` and its streams entry
    take it), so that s1 is its output."""
    return fp.k1_group(F, chunk, fb.chirp_resident_blocks(N, windowed, index))


def tapers_group(F: int, chunk: int, N: int, K: int, index: int,
                 streams: bool = False) -> int:
    """Frames a block of MT-B sums over F frames (S F for MT-B-S,
    ``streams``): k1_group over the blocks the card holds at once for each
    of the K tapers."""
    resident = resident_blocks(N, TAPERS, True, index, streams)
    return fp.k1_group(F, chunk, max(1, resident // K))


def pfb_group(F: int, chunk: int, N: int, index: int,
              streams: bool = False) -> int:
    """Frames a block of PFB-B sums over F frames (S F for PFB-B-S,
    ``streams``): k1_group over its residency."""
    return fp.k1_group(F, chunk,
                       resident_blocks(N, PFB, False, index, streams))


@functools.lru_cache(maxsize=16)
def _tables(N: int, device: torch.device):
    """B's tables at N on the device: pass_twiddles(M), the chirp a and B /
    M in the element order of M's register plan."""
    return (fp._device_pass_twiddles(fb.chirp_size(N), device),
            *fb.device_tables(N, device))


def _launch(kernel: str, raw_u8: torch.Tensor, extra: Optional[torch.Tensor],
            rows: int, out_shape: tuple, call) -> torch.Tensor:
    """Check the loads' alignment, take the (rows, row) partial rows and
    make the (*out_shape, row) output, then run ``call(lib, twiddle,
    chirp, spectrum, log2m, partial, out, width, stream)`` on the current
    stream, with B's tables at N. ``raw_u8`` is (F, 2N) or (S, F, 2N),
    every stream's rows at the base's copy width (it divides 2N). Returns
    the output's first N columns, (*out_shape, N)."""
    from . import _build
    fp.check_alignment(kernel, raw_u8, RING_RAW_ALIGN, extra, WINDOW_ALIGN)
    N = raw_u8.shape[-1] // 2
    shape = fb.chirp_launch(N)
    device = raw_u8.device
    stream = _raw_stream(device.index)
    lib = _build.load(LIBRARY)
    partial = partial_rows(shape.row, rows, device, stream)
    out = torch.empty((*out_shape, shape.row), dtype=torch.float32,
                      device=device)
    twiddle, chirp, spectrum = (t.data_ptr() for t in _tables(N, device))
    err = call(lib, twiddle, chirp, spectrum, shape.log2m, partial,
               out.data_ptr(), copy_width(N, raw_u8.data_ptr()), stream)
    if err != 0:
        raise fp.launch_error(kernel, lib, err)
    return out[..., :N]


def fused_psd_sk_chirp(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                       window: Optional[torch.Tensor] = None,
                       sigma: float = 0.0, group: Optional[int] = None
                       ) -> torch.Tensor:
    """SK-B: (F, 2N) uint8 frames, N even up to 8192, ``n_valid`` real
    frames -> (2, N) float32 rows s1 = sum of |DFT|^2 and s2 = sum of
    |DFT|^4 over those frames; with ``sigma > 0`` (4, N), adding s1 * keep
    and n_valid * keep. ``window``: an (N,) float32 tensor on the same
    device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously),
    on ``group`` frames a block where given (a streams call's, for a
    comparison on its grid), else on B's grid (:func:`sk_group`); a CPU
    tensor runs the plain version."""
    kernel = "fused_psd_sk_chirp"
    n_valid, sigma = int(n_valid), float(sigma)
    fp.check_args(kernel, fb.fused_psd_bluestein_eligible, raw_u8, n_valid,
                  chunk, window)
    if not sigma >= 0.0:
        raise ValueError(f"sigma={sigma} must be >= 0")
    check_group(group, raw_u8.shape[0])
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return sk_chirp_reference(raw_u8, n_valid, chunk, window, sigma)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    device = raw_u8.device
    group = group or sk_group(F, chunk, N, window is not None, device.index)
    out = _launch(
        kernel, raw_u8, window, 2 * -(-F // group),
        (4 if sigma > 0.0 else 2,),
        lambda lib, twiddle, chirp, spectrum, log2m, partial, out, width,
        stream: lib.rpf_fused_psd_sk_chirp(
            raw_u8.data_ptr(), twiddle,
            None if window is None else window.data_ptr(), chirp, spectrum,
            partial, out, device.index, log2m, N, F, group, n_valid,
            2.0 * sigma, width, stream))
    fp.COUNTS.kernel_sk_chirp += 1
    return out


def fused_psd_tapers_chirp(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                           tapers: torch.Tensor, group: Optional[int] = None
                           ) -> torch.Tensor:
    """MT-B: (F, 2N) uint8 frames, N even up to 8192, ``n_valid`` real
    frames, (K, N) float32 ``tapers`` on the same device -> (N,) float32:
    the sum over those frames of the mean over the K tapers of |DFT(x *
    taper_k)|^2.

    A CUDA tensor runs the kernel on the current stream (asynchronously),
    on ``group`` frames a block where given, else on :func:`tapers_group`'s
    grid; a CPU tensor runs the plain version."""
    kernel = "fused_psd_tapers_chirp"
    n_valid = int(n_valid)
    fp.check_args(kernel, fb.fused_psd_bluestein_eligible, raw_u8, n_valid,
                  chunk, None)
    check_tapers(tapers, raw_u8)
    check_group(group, raw_u8.shape[0])
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return tapers_chirp_reference(raw_u8, n_valid, chunk, tapers)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    K = tapers.shape[0]
    device = raw_u8.device
    group = group or tapers_group(F, chunk, N, K, device.index)
    out = _launch(
        kernel, raw_u8, tapers, K * -(-F // group), (),
        lambda lib, twiddle, chirp, spectrum, log2m, partial, out, width,
        stream: lib.rpf_fused_psd_tapers_chirp(
            raw_u8.data_ptr(), twiddle, tapers.data_ptr(), chirp, spectrum,
            partial, out, device.index, log2m, N, F, group, K, n_valid,
            width, stream))
    fp.COUNTS.kernel_tapers_chirp += 1
    return out


def fused_psd_pfb_chirp(raw_u8: torch.Tensor, history: torch.Tensor,
                        n_valid: int, chunk: int, h: torch.Tensor,
                        history_out: torch.Tensor, fresh: bool = False,
                        group: Optional[int] = None) -> torch.Tensor:
    """PFB-B: (F, 2N) uint8 frames (N even up to 8192) after (P - 1, 2N)
    uint8 ``history`` rows, ``n_valid`` real frames, a (P, N) float32
    prototype ``h`` -> (N,) float32 sum over those frames of |DFT(polyphase
    sum)|^2; the next history goes to ``history_out`` (distinct from
    ``history``). With ``fresh`` the history is taken as byte 127 (a reset)
    and set so. All on the frames' device.

    A CUDA tensor runs the kernel on the current stream (asynchronously:
    ``history_out`` is written after the kernel on that stream), on
    ``group`` frames a block where given, else on :func:`pfb_group`'s
    grid; a CPU tensor runs the plain version."""
    kernel = "fused_psd_pfb_chirp"
    n_valid = int(n_valid)
    fp.check_args(kernel, fb.fused_psd_bluestein_eligible, raw_u8, n_valid,
                  chunk, None)
    check_pfb_args(raw_u8, history, h, history_out)
    check_group(group, raw_u8.shape[0])
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return pfb_chirp_reference(raw_u8, history, n_valid, chunk, h,
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
        lambda lib, twiddle, chirp, spectrum, log2m, partial, out, width,
        stream: lib.rpf_fused_psd_pfb_chirp(
            raw_u8.data_ptr(), history.data_ptr() or None, twiddle,
            h.data_ptr(), chirp, spectrum, partial, out,
            history_out.data_ptr() or None, device.index, log2m, N, F, group,
            n_valid, P, int(fresh), width, stream))
    fp.COUNTS.kernel_pfb_chirp += 1
    return out


def fused_psd_sk_chirp_streams(raw_u8: torch.Tensor, n_valid: torch.Tensor,
                               chunk: int,
                               window: Optional[torch.Tensor] = None,
                               sigma: float = 0.0) -> torch.Tensor:
    """SK-B-S: (S, F, 2N) uint8 frames of S streams (N even up to 8192),
    ``n_valid`` (S,) int32 real frames per stream on the frames' device ->
    (S, 2, N) float32, rows s1 and s2 of each stream's first n_valid[s]
    frames (a count outside [0, F] acts as its nearest bound); with
    ``sigma > 0`` (S, 4, N), adding s1 * keep and n_valid[s] * keep, each
    stream gated on its own moments and count. ``window``: an (N,) float32
    tensor on the same device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously:
    the kernels read ``n_valid`` from device memory when they run), on
    :func:`.fused_psd_bluestein.fused_psd_bluestein_streams`'s grid
    (:func:`sk_group` over all S F frames), so that each stream's s1 is its
    row; a CPU tensor runs the plain version."""
    kernel = "fused_psd_sk_chirp_streams"
    sigma = float(sigma)
    fp.check_streams_args(raw_u8, n_valid, chunk, window, kernel,
                          fb.fused_psd_bluestein_eligible)
    if not sigma >= 0.0:
        raise ValueError(f"sigma={sigma} must be >= 0")
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return sk_chirp_streams_reference(raw_u8, n_valid, chunk, window,
                                          sigma)
    S, F, N = raw_u8.shape[0], raw_u8.shape[1], raw_u8.shape[2] // 2
    device = raw_u8.device
    group = sk_group(S * F, chunk, N, window is not None, device.index)
    out = _launch(
        kernel, raw_u8, window, 2 * S * (F // group),
        (S, 4 if sigma > 0.0 else 2),
        lambda lib, twiddle, chirp, spectrum, log2m, partial, out, width,
        stream: lib.rpf_fused_psd_sk_chirp_streams(
            raw_u8.data_ptr(), twiddle,
            None if window is None else window.data_ptr(), chirp, spectrum,
            n_valid.data_ptr(), partial, out, device.index, log2m, N, S, F,
            group, 2.0 * sigma, width, stream))
    fp.COUNTS.kernel_sk_chirp_streams += 1
    return out


def fused_psd_tapers_chirp_streams(raw_u8: torch.Tensor,
                                   n_valid: torch.Tensor, chunk: int,
                                   tapers: torch.Tensor) -> torch.Tensor:
    """MT-B-S: (S, F, 2N) uint8 frames of S streams, ``n_valid`` (S,)
    int32 real frames per stream, (K, N) float32 ``tapers``, all on one
    device -> (S, N) float32: row s the sum over stream s's first
    n_valid[s] frames of the mean over the K tapers of |DFT(x *
    taper_k)|^2.

    A CUDA tensor runs the kernel on the current stream (asynchronously),
    on :func:`tapers_group`'s grid over all S F frames, the tapers on the
    grid's y axis; a CPU tensor runs the plain version."""
    kernel = "fused_psd_tapers_chirp_streams"
    fp.check_streams_args(raw_u8, n_valid, chunk, None, kernel,
                          fb.fused_psd_bluestein_eligible)
    check_tapers(tapers, raw_u8)
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return tapers_chirp_streams_reference(raw_u8, n_valid, chunk, tapers)
    S, F, N = raw_u8.shape[0], raw_u8.shape[1], raw_u8.shape[2] // 2
    K = tapers.shape[0]
    device = raw_u8.device
    group = tapers_group(S * F, chunk, N, K, device.index, streams=True)
    out = _launch(
        kernel, raw_u8, tapers, K * S * (F // group), (S,),
        lambda lib, twiddle, chirp, spectrum, log2m, partial, out, width,
        stream: lib.rpf_fused_psd_tapers_chirp_streams(
            raw_u8.data_ptr(), twiddle, tapers.data_ptr(), chirp, spectrum,
            n_valid.data_ptr(), partial, out, device.index, log2m, N, S, F,
            group, K, width, stream))
    fp.COUNTS.kernel_tapers_chirp_streams += 1
    return out


def fused_psd_pfb_chirp_streams(raw_u8: torch.Tensor, history: torch.Tensor,
                                n_valid: torch.Tensor, chunk: int,
                                h: torch.Tensor, history_out: torch.Tensor,
                                fresh: bool = False) -> torch.Tensor:
    """PFB-B-S: (S, F, 2N) uint8 frames of S streams (N even up to 8192),
    each after its (P - 1, 2N) rows of the (S, P - 1, 2N) uint8
    ``history``, ``n_valid`` (S,) int32 real frames per stream, a (P, N)
    float32 prototype ``h`` -> (S, N) float32, row s
    :func:`fused_psd_pfb_chirp` of stream s (a count outside [0, F] acts as
    its nearest bound); each stream's next history goes to its rows of
    ``history_out`` (distinct from ``history``); with ``fresh`` every
    stream's history is taken as byte 127 (a reset) and set so. All on the
    frames' device.

    A CUDA tensor runs the kernel on the current stream (asynchronously:
    the kernels read ``n_valid`` from device memory when they run, and
    write ``history_out`` after the sum), on :func:`pfb_group`'s grid over
    all S F frames; a CPU tensor runs the plain version."""
    kernel = "fused_psd_pfb_chirp_streams"
    fp.check_streams_args(raw_u8, n_valid, chunk, None, kernel,
                          fb.fused_psd_bluestein_eligible)
    check_pfb_streams_args(raw_u8, history, h, history_out)
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return pfb_chirp_streams_reference(raw_u8, history, n_valid, chunk,
                                           h, history_out, fresh)
    S, F, N = raw_u8.shape[0], raw_u8.shape[1], raw_u8.shape[2] // 2
    P = h.shape[0]
    device = raw_u8.device
    check_streams_histories(kernel, history, history_out)
    group = pfb_group(S * F, chunk, N, device.index, streams=True)
    out = _launch(
        kernel, raw_u8, h, S * (F // group), (S,),
        lambda lib, twiddle, chirp, spectrum, log2m, partial, out, width,
        stream: lib.rpf_fused_psd_pfb_chirp_streams(
            raw_u8.data_ptr(), history.data_ptr() or None, twiddle,
            h.data_ptr(), chirp, spectrum, n_valid.data_ptr(), partial, out,
            history_out.data_ptr() or None, device.index, log2m, N, S, F,
            group, P, int(fresh), width, stream))
    fp.COUNTS.kernel_pfb_chirp_streams += 1
    return out
