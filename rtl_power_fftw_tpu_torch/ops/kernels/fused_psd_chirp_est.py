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

Each dispatches on the tensor's device: a CPU tensor runs the plain
PyTorch version (:func:`sk_chirp_reference`, :func:`tapers_chirp_reference`,
:func:`pfb_chirp_reference`: its power-of-two counterpart's, with the
chirp-Z algorithm of :func:`.fused_psd_bluestein.chirp_power` in torch ops
for the transform); a CUDA tensor the kernel, or raises.
``COUNTS.kernel_sk_chirp``, ``COUNTS.kernel_tapers_chirp`` and
``COUNTS.kernel_pfb_chirp`` (in :mod:`.fused_psd`) count their launches.
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
from .fused_psd_pfb import check_pfb_args, fused_psd_pfb_reference
from .fused_psd_sk import fused_psd_sk_reference
from .fused_psd_tapers import check_tapers, fused_psd_tapers_reference

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
    err = lib.rpf_fused_psd_chirp_est_attributes(
        fb.chirp_launch(N).log2m, N, cut, int(windowed), device.index or 0,
        attrs)
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
    """Frames a block of SK-B sums: B's own grid (k1_group over its
    residency), so that s1 is its output."""
    return fp.k1_group(F, chunk, fb.chirp_resident_blocks(N, windowed, index))


def tapers_group(F: int, chunk: int, N: int, K: int, index: int) -> int:
    """Frames a block of MT-B sums: k1_group over the blocks the card
    holds at once for each of the K tapers."""
    return fp.k1_group(F, chunk,
                       max(1, resident_blocks(N, TAPERS, True, index) // K))


def pfb_group(F: int, chunk: int, N: int, index: int) -> int:
    """Frames a block of PFB-B sums: k1_group over its residency."""
    return fp.k1_group(F, chunk, resident_blocks(N, PFB, False, index))


@functools.lru_cache(maxsize=16)
def _tables(N: int, device: torch.device):
    """B's tables at N on the device: pass_twiddles(M), the chirp a and B /
    M in the element order of M's register plan."""
    return (fp._device_pass_twiddles(fb.chirp_size(N), device),
            *fb.device_tables(N, device))


def _launch(kernel: str, raw_u8: torch.Tensor, extra: Optional[torch.Tensor],
            rows: int, out_rows: int, call) -> torch.Tensor:
    """Check the loads' alignment, take the (rows, row) partial rows and
    make the (out_rows, row) output, then run ``call(lib, twiddle, chirp,
    spectrum, log2m, partial, out, width, stream)`` on the current stream,
    with B's tables at N. Returns the output's first N columns, (N,) where
    ``out_rows`` is 1."""
    from . import _build
    fp.check_alignment(kernel, raw_u8, RING_RAW_ALIGN, extra, WINDOW_ALIGN)
    N = raw_u8.shape[1] // 2
    shape = fb.chirp_launch(N)
    device = raw_u8.device
    stream = _raw_stream(device.index)
    lib = _build.load(LIBRARY)
    partial = partial_rows(shape.row, rows, device, stream)
    out = torch.empty((out_rows, shape.row), dtype=torch.float32,
                      device=device)
    twiddle, chirp, spectrum = (t.data_ptr() for t in _tables(N, device))
    err = call(lib, twiddle, chirp, spectrum, shape.log2m, partial,
               out.data_ptr(), copy_width(N, raw_u8.data_ptr()), stream)
    if err != 0:
        raise fp.launch_error(kernel, lib, err)
    return out[0, :N] if out_rows == 1 else out[:, :N]


def fused_psd_sk_chirp(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                       window: Optional[torch.Tensor] = None,
                       sigma: float = 0.0) -> torch.Tensor:
    """SK-B: (F, 2N) uint8 frames, N even up to 8192, ``n_valid`` real
    frames -> (2, N) float32 rows s1 = sum of |DFT|^2 and s2 = sum of
    |DFT|^4 over those frames; with ``sigma > 0`` (4, N), adding s1 * keep
    and n_valid * keep. ``window``: an (N,) float32 tensor on the same
    device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously),
    on B's grid (:func:`sk_group`); a CPU tensor runs the plain version."""
    kernel = "fused_psd_sk_chirp"
    n_valid, sigma = int(n_valid), float(sigma)
    fp.check_args(kernel, fb.fused_psd_bluestein_eligible, raw_u8, n_valid,
                  chunk, window)
    if not sigma >= 0.0:
        raise ValueError(f"sigma={sigma} must be >= 0")
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return sk_chirp_reference(raw_u8, n_valid, chunk, window, sigma)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    device = raw_u8.device
    group = sk_group(F, chunk, N, window is not None, device.index)
    out = _launch(
        kernel, raw_u8, window, 2 * -(-F // group), 4 if sigma > 0.0 else 2,
        lambda lib, twiddle, chirp, spectrum, log2m, partial, out, width,
        stream: lib.rpf_fused_psd_sk_chirp(
            raw_u8.data_ptr(), twiddle,
            None if window is None else window.data_ptr(), chirp, spectrum,
            partial, out, device.index, log2m, N, F, group, n_valid,
            2.0 * sigma, width, stream))
    fp.COUNTS.kernel_sk_chirp += 1
    return out


def fused_psd_tapers_chirp(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                           tapers: torch.Tensor) -> torch.Tensor:
    """MT-B: (F, 2N) uint8 frames, N even up to 8192, ``n_valid`` real
    frames, (K, N) float32 ``tapers`` on the same device -> (N,) float32:
    the sum over those frames of the mean over the K tapers of |DFT(x *
    taper_k)|^2.

    A CUDA tensor runs the kernel on the current stream (asynchronously),
    on :func:`tapers_group`'s grid; a CPU tensor runs the plain version."""
    kernel = "fused_psd_tapers_chirp"
    n_valid = int(n_valid)
    fp.check_args(kernel, fb.fused_psd_bluestein_eligible, raw_u8, n_valid,
                  chunk, None)
    check_tapers(tapers, raw_u8)
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return tapers_chirp_reference(raw_u8, n_valid, chunk, tapers)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    K = tapers.shape[0]
    device = raw_u8.device
    group = tapers_group(F, chunk, N, K, device.index)
    out = _launch(
        kernel, raw_u8, tapers, K * -(-F // group), 1,
        lambda lib, twiddle, chirp, spectrum, log2m, partial, out, width,
        stream: lib.rpf_fused_psd_tapers_chirp(
            raw_u8.data_ptr(), twiddle, tapers.data_ptr(), chirp, spectrum,
            partial, out, device.index, log2m, N, F, group, K, n_valid,
            width, stream))
    fp.COUNTS.kernel_tapers_chirp += 1
    return out


def fused_psd_pfb_chirp(raw_u8: torch.Tensor, history: torch.Tensor,
                        n_valid: int, chunk: int, h: torch.Tensor,
                        history_out: torch.Tensor, fresh: bool = False
                        ) -> torch.Tensor:
    """PFB-B: (F, 2N) uint8 frames (N even up to 8192) after (P - 1, 2N)
    uint8 ``history`` rows, ``n_valid`` real frames, a (P, N) float32
    prototype ``h`` -> (N,) float32 sum over those frames of |DFT(polyphase
    sum)|^2; the next history goes to ``history_out`` (distinct from
    ``history``). With ``fresh`` the history is taken as byte 127 (a reset)
    and set so. All on the frames' device.

    A CUDA tensor runs the kernel on the current stream (asynchronously:
    ``history_out`` is written after the kernel on that stream), on
    :func:`pfb_group`'s grid; a CPU tensor runs the plain version."""
    kernel = "fused_psd_pfb_chirp"
    n_valid = int(n_valid)
    fp.check_args(kernel, fb.fused_psd_bluestein_eligible, raw_u8, n_valid,
                  chunk, None)
    check_pfb_args(raw_u8, history, h, history_out)
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
    group = pfb_group(F, chunk, N, device.index)
    out = _launch(
        kernel, raw_u8, h, -(-F // group), 1,
        lambda lib, twiddle, chirp, spectrum, log2m, partial, out, width,
        stream: lib.rpf_fused_psd_pfb_chirp(
            raw_u8.data_ptr(), history.data_ptr() or None, twiddle,
            h.data_ptr(), chirp, spectrum, partial, out,
            history_out.data_ptr() or None, device.index, log2m, N, F, group,
            n_valid, P, int(fresh), width, stream))
    fp.COUNTS.kernel_pfb_chirp += 1
    return out
