"""The CLI estimators' steps at the large even 7-smooth bin counts: spectral
kurtosis (SK-ML), the multitaper (MT-ML) and the polyphase filterbank
(PFB-ML) at every even 7-smooth N from 16386 to 2^22 that is not a power
of two (20000, 49152, 100000, 10^6 and 4167450 among the 1192).

The JAX package computes these estimators in XLA at every N
(``rtl_power_fftw_tpu/models/kurtosis.py:_sk_step``,
``multitaper.py:_mt_core``, ``pfb.py:_pfb_core``; at these N its transform
is XLA's FFT), with no Pallas kernel. Here they are forms of ML's two
passes (:mod:`.fused_psd_mixed_large`,
``csrc/fused_psd_mixed_large_est.cu``, on ML's streams passes of
``csrc/fused_psd_mixed_large_streams.cuh``), each the function of its
counterpart at the other N (:mod:`.fused_psd_large_est`), and each written
once for S >= 1 streams with an (S,) count array on the card; the
one-stream wrappers call it at S = 1:

* :func:`fused_psd_sk_mixed_large`: (F, 2N) frames -> (2, N) s1 = the sum
  of |X|^2, s2 = the sum of |X|^4 over the valid frames; with ``sigma >
  0`` (4, N), the gate (:func:`.fused_psd_sk.sk_keep`) as the sum's
  epilogue. ML's pass A, and a pass B that keeps the |X|^4 sums beside its
  |X|^2 sums; on ML's grid (which the wrapper takes) s1 is
  :func:`.fused_psd_mixed_large.fused_psd_mixed_large`'s output bit for
  bit.
* :func:`fused_psd_tapers_mixed_large`: the mean over K tapers of |DFT(x *
  taper_k)|^2 summed over the valid frames: both passes once a taper (pass
  A windowed by the taper) over one scratch, taper k's rows in plane k of
  the partial rows, summed in float64 and divided by K.
* :func:`fused_psd_pfb_mixed_large`: |DFT(S_j)|^2 of the polyphase sums
  S_j = sum over p of h[p] x_{j+p} (p in order from zero, float32, no FMA),
  each taken in pass A's pass 0 (the frame's own tile from pass A's ring,
  the P - 1 older rows through L1/L2), over P - 1 history rows and the F
  frames; the next history written to ``history_out`` on the stream.

:func:`fused_psd_sk_mixed_large_streams`,
:func:`fused_psd_tapers_mixed_large_streams` and
:func:`fused_psd_pfb_mixed_large_streams` (SK-ML-S, MT-ML-S, PFB-ML-S) take
S streams of F frames, (S, F, 2N), on ML-S's grid
(:func:`.fused_psd_mixed_large.streams_grid`): each stream's rows are the
one-stream form's on the same groups (the one-stream wrappers'
``group_b``), and SK-ML-S's s1 is :func:`.fused_psd_mixed_large.
fused_psd_mixed_large_streams`'s row bit for bit.

Each dispatches on the tensor's device: a CPU tensor runs the plain
PyTorch version (:func:`sk_mixed_large_reference`,
:func:`tapers_mixed_large_reference`, :func:`pfb_mixed_large_reference` and
their streams forms: the power-of-two counterparts' with ML's plain four
steps, :func:`.fused_psd_mixed_large.mixed_large_dft_power`, for the
transform, so that SK's s1 is :func:`.fused_psd_mixed_large.
fused_psd_mixed_large_reference`'s bit for bit); a CUDA tensor the
kernels, or raises. ``COUNTS.kernel_sk_mixed_large``,
``kernel_tapers_mixed_large`` and ``kernel_pfb_mixed_large`` (in
:mod:`.fused_psd`) count their launches, with ``_streams`` after each the
streams wrappers'.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import fused_psd as fp
from . import fused_psd_mixed_large as ml
from .fused_psd_large import _raw_stream
from .fused_psd_mixed_est import check_group, check_streams_histories
from .fused_psd_pfb import (check_pfb_args, check_pfb_streams_args,
                            fused_psd_pfb_reference,
                            fused_psd_pfb_streams_reference)
from .fused_psd_sk import (fused_psd_sk_reference,
                           fused_psd_sk_streams_reference)
from .fused_psd_tapers import (check_tapers, fused_psd_tapers_reference,
                               fused_psd_tapers_streams_reference)

LIBRARY = "fused_psd_mixed_large_est"
#: The bins the forms take: ML's, the even 7-smooth N from 16386 to 2^22
#: that are not powers of two.
MIN_N = ml.MIN_N
MAX_N = ml.MAX_N
#: The passes :func:`kernel_attributes` asks of: ML-S's pass A
#: (unwindowed, windowed) and B, SK's pass B and the PFB's pass A (pass B
#: and SK's pass B at the class of sums N's plan takes).
PASS_A, PASS_A_WINDOWED, PASS_B, SK_PASS_B, PFB_PASS_A = range(5)


def fused_psd_mixed_large_est_eligible(N: int) -> bool:
    """True iff the forms take N bins: ML's, even, 7-smooth and not a
    power of two in (16384, 2^22]."""
    return ml.fused_psd_mixed_large_eligible(N)


def sk_mixed_large_reference(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                             window: Optional[torch.Tensor] = None,
                             sigma: float = 0.0) -> torch.Tensor:
    """The plain version of :func:`fused_psd_sk_mixed_large`: the SK step's
    on ML's plain |DFT|^2, so that its s1 is
    :func:`.fused_psd_mixed_large.fused_psd_mixed_large_reference`'s bit
    for bit."""
    return fused_psd_sk_reference(raw_u8, n_valid, chunk, window, sigma,
                                  frame_power=ml.mixed_large_power)


def tapers_mixed_large_reference(raw_u8: torch.Tensor, n_valid: int,
                                 chunk: int, tapers: torch.Tensor
                                 ) -> torch.Tensor:
    """The plain version of :func:`fused_psd_tapers_mixed_large`."""
    return fused_psd_tapers_reference(raw_u8, n_valid, chunk, tapers,
                                      dft_power=ml.mixed_large_dft_power)


def pfb_mixed_large_reference(raw_u8: torch.Tensor, history: torch.Tensor,
                              n_valid: int, chunk: int, h: torch.Tensor,
                              history_out: torch.Tensor, fresh: bool = False
                              ) -> torch.Tensor:
    """The plain version of :func:`fused_psd_pfb_mixed_large`."""
    return fused_psd_pfb_reference(raw_u8, history, n_valid, chunk, h,
                                   history_out, fresh,
                                   dft_power=ml.mixed_large_dft_power)


def sk_mixed_large_streams_reference(raw_u8: torch.Tensor,
                                     n_valid: torch.Tensor, chunk: int,
                                     window: Optional[torch.Tensor] = None,
                                     sigma: float = 0.0) -> torch.Tensor:
    """The plain version of :func:`fused_psd_sk_mixed_large_streams`: each
    stream's s1 is :func:`.fused_psd_mixed_large.
    fused_psd_mixed_large_streams_reference`'s row bit for bit."""
    return fused_psd_sk_streams_reference(raw_u8, n_valid, chunk, window,
                                          sigma,
                                          frame_power=ml.mixed_large_power)


def tapers_mixed_large_streams_reference(raw_u8: torch.Tensor,
                                         n_valid: torch.Tensor, chunk: int,
                                         tapers: torch.Tensor
                                         ) -> torch.Tensor:
    """The plain version of :func:`fused_psd_tapers_mixed_large_streams`."""
    return fused_psd_tapers_streams_reference(
        raw_u8, n_valid, chunk, tapers, dft_power=ml.mixed_large_dft_power)


def pfb_mixed_large_streams_reference(raw_u8: torch.Tensor,
                                      history: torch.Tensor,
                                      n_valid: torch.Tensor, chunk: int,
                                      h: torch.Tensor,
                                      history_out: torch.Tensor,
                                      fresh: bool = False) -> torch.Tensor:
    """The plain version of :func:`fused_psd_pfb_mixed_large_streams`."""
    return fused_psd_pfb_streams_reference(
        raw_u8, history, n_valid, chunk, h, history_out, fresh,
        dft_power=ml.mixed_large_dft_power)


def source_pass(N: int, which: int) -> int:
    """The source's number of pass ``which`` (:data:`PASS_A` ..
    :data:`PFB_PASS_A`) at N (the attributes entry's: 0, 1 ML-S's pass A,
    2, 3 its pass B with the small and the large class of sums, 4, 5 SK's
    pass B likewise, 6 the PFB's pass A)."""
    large = ml.ml_layout(N).which_b == ml.PASS_B_LARGE
    return {PASS_A: 0, PASS_A_WINDOWED: 1, PASS_B: 2 + large,
            SK_PASS_B: 4 + large, PFB_PASS_A: 6}[which]


def kernel_attributes(N: int, which: int,
                      device: Optional[torch.device] = None) -> dict:
    """What a pass of the forms at N bins gets on the card (``which``:
    :data:`PASS_A` .. :data:`PFB_PASS_A`, at the class of sums N's plan
    takes): registers and spill bytes a thread, static and dynamic shared
    bytes and threads a block, and the blocks that reside on one SM.
    Launches nothing."""
    t = ml.ml_layout(N)
    index = (device or torch.device(
        "cuda", torch.cuda.current_device())).index or 0
    b = which in (PASS_B, SK_PASS_B)
    return ml.library_attributes(
        LIBRARY, f"pass {which}",
        lambda lib, attrs: lib.rpf_fused_psd_mixed_large_est_attributes(
            source_pass(N, which), t.smem[b], t.threads[b], index, attrs))


@functools.lru_cache(maxsize=64)
def grid(N: int, S: int, F: int, windowed: bool,
         index: int) -> Tuple[int, int, int]:
    """(frames a pass-A block, frames a pass-B block, partial rows a
    stream) over S streams of F frames at N: ML-S's grid from ML's
    residency (:func:`.fused_psd_mixed_large.streams_grid`; at S = 1 ML's
    own), so that SK-ML's s1 is ML's output."""
    return ml.streams_grid(S, F, N, windowed, index)


def _launch(kernel: str, raw3: torch.Tensor, extra: Optional[torch.Tensor],
            planes: int, out_shape: tuple, windowed: bool,
            group_b: Optional[int], call) -> torch.Tensor:
    """Check the loads' alignment, take the (S F, N1, N2p) complex64
    scratch and ``planes`` planes of each stream's partial rows, make the
    (*out_shape, row) output, and run ``call(lib, tables, plans, scratch,
    partial, out, layout, width, groups, stream)`` on the current stream
    with ML's tables at N; ``raw3`` is (S, F, 2N). Returns the output's
    first N columns."""
    from . import _build
    fp.check_alignment(kernel, raw3, ml.RAW_ALIGN, extra, ml.WINDOW_ALIGN)
    S, F, N = raw3.shape[0], raw3.shape[1], raw3.shape[2] // 2
    device = raw3.device
    t = ml.ml_layout(N)
    groups = grid(N, S, F, windowed, device.index)[:2]
    if group_b is not None:
        groups = (groups[0], int(group_b))
    rows = planes * S * -(-F // groups[1])
    lib = _build.load(LIBRARY)
    stream = _raw_stream(device.index)
    scratch, partial = ml.workspace(
        (LIBRARY, N, S * F, rows, device.index, stream),
        2 * S * F * t.N1 * t.n2p, rows * t.row, device)
    out = torch.empty((*out_shape, t.row), dtype=torch.float32,
                      device=device)
    keep, ints = ml.device_tables(N, device.index)
    err = call(lib, tuple(k.data_ptr() for k in keep),
               tuple(ctypes.addressof(i) for i in ints), scratch, partial,
               out.data_ptr(), t, ml.ml_copy_width(N, raw3.data_ptr()),
               groups, stream)
    if err != 0:
        raise fp.launch_error(kernel, lib, err)
    return out[..., :N]


def _one_count(n_valid: int, device: torch.device) -> torch.Tensor:
    """A one-stream call's count as the forms read it: (1,) int32 on the
    card."""
    return torch.full((1,), n_valid, dtype=torch.int32, device=device)


def _sk(kernel, raw3, counts, window, sigma, group_b):
    S, F = raw3.shape[0], raw3.shape[1]
    device = raw3.device

    def call(lib, tabs, plans, scratch, partial, out, t, width, groups,
             stream):
        tw1, bin1, inter, tw2, order2 = tabs
        return lib.rpf_fused_psd_sk_mixed_large(
            raw3.data_ptr(), tw1, bin1, inter,
            None if window is None else window.data_ptr(), tw2, order2,
            counts.data_ptr(), scratch, partial, out, *plans, device.index,
            t.log2c, t.n2p, width, S, F, *groups, 2.0 * sigma, stream)
    return _launch(kernel, raw3, window, 2, (S, 4 if sigma > 0.0 else 2),
                   window is not None, group_b, call)


def _tapers(kernel, raw3, counts, tapers, group_b):
    S, F = raw3.shape[0], raw3.shape[1]
    K = tapers.shape[0]
    device = raw3.device

    def call(lib, tabs, plans, scratch, partial, out, t, width, groups,
             stream):
        tw1, bin1, inter, tw2, order2 = tabs
        return lib.rpf_fused_psd_tapers_mixed_large(
            raw3.data_ptr(), tw1, bin1, inter, tapers.data_ptr(), tw2,
            order2, counts.data_ptr(), scratch, partial, out, *plans,
            device.index, t.log2c, t.n2p, width, S, F, *groups, K, stream)
    return _launch(kernel, raw3, tapers, K, (S,), True, group_b, call)


def _pfb(kernel, raw3, history, counts, h, history_out, fresh, group_b):
    S, F = raw3.shape[0], raw3.shape[1]
    P = h.shape[0]
    device = raw3.device
    if P > 1:
        check_streams_histories(kernel, history, history_out)

    def call(lib, tabs, plans, scratch, partial, out, t, width, groups,
             stream):
        tw1, bin1, inter, tw2, order2 = tabs
        return lib.rpf_fused_psd_pfb_mixed_large(
            raw3.data_ptr(), history.data_ptr() if P > 1 else None, tw1,
            bin1, inter, h.data_ptr(), tw2, order2, counts.data_ptr(),
            scratch, partial, out,
            history_out.data_ptr() if P > 1 else None, *plans, device.index,
            t.log2c, t.n2p, width, S, F, *groups, P, int(fresh), stream)
    return _launch(kernel, raw3, h, 1, (S,), False, group_b, call)


def fused_psd_sk_mixed_large(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                             window: Optional[torch.Tensor] = None,
                             sigma: float = 0.0,
                             group_b: Optional[int] = None) -> torch.Tensor:
    """SK-ML: (F, 2N) uint8 frames, N even, 7-smooth and not a power of two
    in (16384, 2^22], ``n_valid`` real frames -> (2, N) float32 rows s1 =
    sum of |DFT|^2 and s2 = sum of |DFT|^4 over those frames; with ``sigma
    > 0`` (4, N), adding s1 * keep and n_valid * keep. ``window``: an (N,)
    float32 tensor on the same device, or None.

    A CUDA tensor runs the kernels on the current stream (asynchronously),
    on ML's grid, or with ``group_b`` frames a pass-B block where given (a
    streams call's, for a comparison on its groups); a CPU tensor runs the
    plain version."""
    kernel = "fused_psd_sk_mixed_large"
    n_valid, sigma = int(n_valid), float(sigma)
    fp.check_args(kernel, fused_psd_mixed_large_est_eligible, raw_u8,
                  n_valid, chunk, window)
    if not sigma >= 0.0:
        raise ValueError(f"sigma={sigma} must be >= 0")
    check_group(group_b, raw_u8.shape[0])
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return sk_mixed_large_reference(raw_u8, n_valid, chunk, window, sigma)
    out = _sk(kernel, raw_u8[None], _one_count(n_valid, raw_u8.device),
              window, sigma, group_b)
    fp.COUNTS.kernel_sk_mixed_large += 1
    return out[0]


def fused_psd_tapers_mixed_large(raw_u8: torch.Tensor, n_valid: int,
                                 chunk: int, tapers: torch.Tensor,
                                 group_b: Optional[int] = None
                                 ) -> torch.Tensor:
    """MT-ML: (F, 2N) uint8 frames at an N :func:`fused_psd_sk_mixed_large`
    takes, ``n_valid`` real frames, (K, N) float32 ``tapers`` on the same
    device -> (N,) float32: the sum over those frames of the mean over the
    K tapers of |DFT(x * taper_k)|^2.

    A CUDA tensor runs the kernels on the current stream (asynchronously),
    on ML's windowed grid, or with ``group_b`` frames a pass-B block where
    given; a CPU tensor runs the plain version."""
    kernel = "fused_psd_tapers_mixed_large"
    n_valid = int(n_valid)
    fp.check_args(kernel, fused_psd_mixed_large_est_eligible, raw_u8,
                  n_valid, chunk, None)
    check_tapers(tapers, raw_u8)
    check_group(group_b, raw_u8.shape[0])
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return tapers_mixed_large_reference(raw_u8, n_valid, chunk, tapers)
    out = _tapers(kernel, raw_u8[None], _one_count(n_valid, raw_u8.device),
                  tapers, group_b)
    fp.COUNTS.kernel_tapers_mixed_large += 1
    return out[0]


def fused_psd_pfb_mixed_large(raw_u8: torch.Tensor, history: torch.Tensor,
                              n_valid: int, chunk: int, h: torch.Tensor,
                              history_out: torch.Tensor, fresh: bool = False,
                              group_b: Optional[int] = None) -> torch.Tensor:
    """PFB-ML: (F, 2N) uint8 frames (an N :func:`fused_psd_sk_mixed_large`
    takes) after (P - 1, 2N) uint8 ``history`` rows, ``n_valid`` real
    frames, a (P, N) float32 prototype ``h`` -> (N,) float32 sum over those
    frames of |DFT(polyphase sum)|^2; the next history goes to
    ``history_out`` (distinct from ``history``). With ``fresh`` the history
    is taken as byte 127 (a reset) and set so. All on the frames' device.

    A CUDA tensor runs the kernels on the current stream (asynchronously:
    ``history_out`` is written after the sum on that stream), on ML's grid,
    or with ``group_b`` frames a pass-B block where given; a CPU tensor
    runs the plain version."""
    kernel = "fused_psd_pfb_mixed_large"
    n_valid = int(n_valid)
    fp.check_args(kernel, fused_psd_mixed_large_est_eligible, raw_u8,
                  n_valid, chunk, None)
    check_pfb_args(raw_u8, history, h, history_out)
    check_group(group_b, raw_u8.shape[0])
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return pfb_mixed_large_reference(raw_u8, history, n_valid, chunk, h,
                                         history_out, fresh)
    out = _pfb(kernel, raw_u8[None], history,
               _one_count(n_valid, raw_u8.device), h, history_out, fresh,
               group_b)
    fp.COUNTS.kernel_pfb_mixed_large += 1
    return out[0]


def fused_psd_sk_mixed_large_streams(raw_u8: torch.Tensor,
                                     n_valid: torch.Tensor, chunk: int,
                                     window: Optional[torch.Tensor] = None,
                                     sigma: float = 0.0) -> torch.Tensor:
    """SK-ML-S: (S, F, 2N) uint8 frames of S streams (an N
    :func:`fused_psd_sk_mixed_large` takes), ``n_valid`` (S,) int32 real
    frames per stream on the frames' device -> (S, 2, N) float32, rows s1
    and s2 of each stream's first n_valid[s] frames (a count outside [0,
    F] acts as its nearest bound); with ``sigma > 0`` (S, 4, N), adding s1
    * keep and n_valid[s] * keep, each stream gated on its own moments and
    count. ``window``: an (N,) float32 tensor on the same device, or None.

    A CUDA tensor runs the kernels on the current stream (asynchronously:
    they read ``n_valid`` from device memory when they run) on ML-S's
    grid, so that each stream's s1 is its row; a CPU tensor runs the plain
    version."""
    kernel = "fused_psd_sk_mixed_large_streams"
    sigma = float(sigma)
    fp.check_streams_args(raw_u8, n_valid, chunk, window, kernel,
                          fused_psd_mixed_large_est_eligible)
    if not sigma >= 0.0:
        raise ValueError(f"sigma={sigma} must be >= 0")
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return sk_mixed_large_streams_reference(raw_u8, n_valid, chunk,
                                                window, sigma)
    out = _sk(kernel, raw_u8, n_valid, window, sigma, None)
    fp.COUNTS.kernel_sk_mixed_large_streams += 1
    return out


def fused_psd_tapers_mixed_large_streams(raw_u8: torch.Tensor,
                                         n_valid: torch.Tensor, chunk: int,
                                         tapers: torch.Tensor
                                         ) -> torch.Tensor:
    """MT-ML-S: (S, F, 2N) uint8 frames of S streams, ``n_valid`` (S,)
    int32 real frames per stream, (K, N) float32 ``tapers``, all on one
    device -> (S, N) float32: row s the sum over stream s's first
    n_valid[s] frames of the mean over the K tapers of |DFT(x *
    taper_k)|^2.

    A CUDA tensor runs the kernels on the current stream (asynchronously)
    on ML-S's windowed grid; a CPU tensor runs the plain version."""
    kernel = "fused_psd_tapers_mixed_large_streams"
    fp.check_streams_args(raw_u8, n_valid, chunk, None, kernel,
                          fused_psd_mixed_large_est_eligible)
    check_tapers(tapers, raw_u8)
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return tapers_mixed_large_streams_reference(raw_u8, n_valid, chunk,
                                                    tapers)
    out = _tapers(kernel, raw_u8, n_valid, tapers, None)
    fp.COUNTS.kernel_tapers_mixed_large_streams += 1
    return out


def fused_psd_pfb_mixed_large_streams(raw_u8: torch.Tensor,
                                      history: torch.Tensor,
                                      n_valid: torch.Tensor, chunk: int,
                                      h: torch.Tensor,
                                      history_out: torch.Tensor,
                                      fresh: bool = False) -> torch.Tensor:
    """PFB-ML-S: (S, F, 2N) uint8 frames of S streams (an N
    :func:`fused_psd_sk_mixed_large` takes), each after its (P - 1, 2N)
    rows of the (S, P - 1, 2N) uint8 ``history``, ``n_valid`` (S,) int32
    real frames per stream, a (P, N) float32 prototype ``h`` -> (S, N)
    float32, row s :func:`fused_psd_pfb_mixed_large` of stream s (a count
    outside [0, F] acts as its nearest bound); each stream's next history
    goes to its rows of ``history_out`` (distinct from ``history``); with
    ``fresh`` every stream's history is taken as byte 127 (a reset) and set
    so. All on the frames' device.

    A CUDA tensor runs the kernels on the current stream (asynchronously:
    they read ``n_valid`` from device memory when they run, and write
    ``history_out`` after the sum) on ML-S's grid; a CPU tensor runs the
    plain version."""
    kernel = "fused_psd_pfb_mixed_large_streams"
    fp.check_streams_args(raw_u8, n_valid, chunk, None, kernel,
                          fused_psd_mixed_large_est_eligible)
    check_pfb_streams_args(raw_u8, history, h, history_out)
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return pfb_mixed_large_streams_reference(raw_u8, history, n_valid,
                                                 chunk, h, history_out,
                                                 fresh)
    out = _pfb(kernel, raw_u8, history, n_valid, h, history_out, fresh,
               None)
    fp.COUNTS.kernel_pfb_mixed_large_streams += 1
    return out
