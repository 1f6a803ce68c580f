"""The CLI estimators' steps at the large chirp-Z bin counts: spectral
kurtosis (SK-BL), the multitaper (MT-BL) and the polyphase filterbank
(PFB-BL) at the even N from 8194 to 2^21 with a prime factor above 7
(9998, 16382, 20002, 99998, 2097150 among them; BL's M = chirp_size(N)
from 2^15 to 2^22), and SK-BL at any even N there under ``--fft-backend
bluestein`` (10000, 16384 and 32768 too).

The JAX package computes these estimators in XLA at every N
(``rtl_power_fftw_tpu/models/kurtosis.py:_sk_step``,
``multitaper.py:_mt_core``, ``pfb.py:_pfb_core``; at these N its transform
is ``ops/dft.py:bluestein_psd_partial``), with no Pallas kernel. Here they
are forms of BL's three register passes (:mod:`.fused_psd_chirp_large`,
``csrc/fused_psd_chirp_large_est.cu``), each the function of its chirp-Z
counterpart at N <= 8192 (:mod:`.fused_psd_chirp_est`), and each written
once for S >= 1 streams with an (S,) count array on the card; the
one-stream wrappers call it at S = 1:

* :func:`fused_psd_sk_chirp_large`: (F, 2N) frames -> (2, N) s1 = the sum
  of |X|^2, s2 = the sum of |X|^4 over the valid frames; with ``sigma >
  0`` (4, N), the gate (:func:`.fused_psd_sk.sk_keep`) as the sum's
  epilogue. BL's passes A and B, and a pass C that keeps the |X|^4 sums
  beside BL's |X|^2 sums; on BL's grid (which the wrapper takes) s1 is
  :func:`.fused_psd_chirp_large.fused_psd_chirp_large`'s output bit for
  bit.
* :func:`fused_psd_tapers_chirp_large`: the mean over K tapers of |DFT(x *
  taper_k)|^2 summed over the valid frames: BL's three passes once a
  taper (pass A windowed by the taper) over one scratch, taper k's rows in
  plane k of the partial rows, summed in float64 and divided by K.
* :func:`fused_psd_pfb_chirp_large`: |DFT(S_j)|^2 of the polyphase sums
  S_j = sum over p of h[p] x_{j+p} (p in order from zero, float32, no FMA)
  over P - 1 history rows and the F frames, formed by the pre-pass of
  ``csrc/pfb_sums.cuh`` (rows n1 < M1 / 2, n < N) into the scratch in pass
  A's threads' order (:func:`.fused_psd_large_est.sums_place` of
  :func:`sums_shape`), which pass A reads back in place of its ring
  before the chirp product; the next history written to ``history_out``
  on the stream. :func:`fused_psd_pfb_chirp_large_control`
  runs its first form, the sums in pass A's load (the own row from the
  ring, the older rows and h through L1/L2), on the same arguments: the
  same bits.

:func:`fused_psd_sk_chirp_large_streams`,
:func:`fused_psd_tapers_chirp_large_streams` and
:func:`fused_psd_pfb_chirp_large_streams` (SK-BL-S, MT-BL-S, PFB-BL-S) take
S streams of F frames, (S, F, 2N), on BL-S's grid
(:func:`.fused_psd_chirp_large.streams_grid`): each stream's rows are the
one-stream form's on the same groups (the one-stream wrappers' ``group_c``),
and SK-BL-S's s1 is :func:`.fused_psd_chirp_large.
fused_psd_chirp_large_streams`'s row bit for bit; PFB-BL-S's control is
:func:`fused_psd_pfb_chirp_large_streams_control`.

Each dispatches on the tensor's device: a CPU tensor runs the plain
PyTorch version (:func:`sk_chirp_large_reference`,
:func:`tapers_chirp_large_reference`, :func:`pfb_chirp_large_reference` and
their streams forms: the power-of-two counterparts' with BL's three passes
in torch ops, :func:`.fused_psd_chirp_large.chirp_large_dft_power`, for the
transform); a CUDA tensor the kernels, or raises. ``COUNTS.
kernel_sk_chirp_large``, ``kernel_tapers_chirp_large`` and
``kernel_pfb_chirp_large`` (in :mod:`.fused_psd`) count their launches,
with ``_streams`` after each the streams wrappers', and
``kernel_pfb_chirp_large_control`` and
``kernel_pfb_chirp_large_streams_control`` the controls'.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import fused_psd as fp
from . import fused_psd_chirp_large as bl
from . import fused_psd_large as fl
from .fused_psd_large import _raw_stream
from .fused_psd_mixed import copy_width
from .fused_psd_mixed_est import check_group, check_streams_histories
from .fused_psd_mixed_large import (RAW_ALIGN, WINDOW_ALIGN,
                                    library_attributes, workspace)
from .fused_psd_pfb import (check_pfb_args, check_pfb_streams_args,
                            fused_psd_pfb_reference,
                            fused_psd_pfb_streams_reference)
from .fused_psd_sk import (fused_psd_sk_reference,
                           fused_psd_sk_streams_reference)
from .fused_psd_tapers import (check_tapers, fused_psd_tapers_reference,
                               fused_psd_tapers_streams_reference)

LIBRARY = "fused_psd_chirp_large_est"
#: The bins the forms take: BL's, every even N from 8194 to 2^21 (M =
#: chirp_size(N) from 2^15 to 2^22, each instantiated in the source).
MIN_N = bl.MIN_N
MAX_N = bl.MAX_N
#: The passes :func:`kernel_attributes` asks of, kept in step with the
#: source's attributes entry: BL-S's pass A (unwindowed, windowed), B and
#: C, SK's pass C, the PFB's pass A, its pre-pass at the tap classes 4 and
#: 32 and the control's PFB pass A.
(PASS_A, PASS_A_WINDOWED, PASS_B, PASS_C, SK_PASS_C, PFB_PASS_A, PFB_SUMS,
 PFB_SUMS_32, PFB_CONTROL_A) = range(9)


def fused_psd_chirp_large_est_eligible(N: int) -> bool:
    """True iff the forms take N bins: even, 8194..2^21."""
    return bl.fused_psd_chirp_large_eligible(N)


def pfb_route(N: int, P: int, frames: int) -> str:
    """PFB-BL's route at N bins, P taps and ``frames`` a call, as PFB-L's
    (:func:`.fused_psd_large_est.pfb_route`): "sums" (the pre-pass, then
    pass A on its sums) at every N, P and frame count, where the card
    measured it faster than the first form's pass A ("load", which the
    control runs)."""
    return "sums"


def pfb_smem(N: int, route: str, P: int = 4) -> int:
    """Dynamic shared memory of the PFB's pass A on a route at N (at
    every P taps): the
    first form's, BL's pass A (the exchange and two slots of the tile's
    rows below M1 / 2); on the sums, the exchange and two slots of a
    batch's 8 THREADS_A sums (``sums_a_smem`` of the source)."""
    r = bl.chirp_regs_layout(N).regs
    xbytes = 8 * r["B"] * r["XS"]
    if route == "load":
        return xbytes + 2 * (r["N1"] // 2) * 2 * r["C"]
    return xbytes + 2 * 8 * r["threads_a"] * 8


def sums_shape(N: int) -> dict:
    """The PFB pre-pass's ``SumsShape`` at N (:func:`.fused_psd_large_est.
    sums_shape`'s fields): M's (n1, n2) array, the rows n1 < M1 / 2 that
    hold samples, M float2 a frame of scratch."""
    t = bl.chirp_regs_layout(N)
    r = t.regs
    lg = lambda x: x.bit_length() - 1
    return {"bins": N, "log2n2": lg(r["N2"]), "log2n1": lg(r["N1"]),
            "log2b": lg(r["B"]), "log2v": lg(r["V"]), "rows": r["N1"] // 2,
            "frame": t.M}


def sk_chirp_large_reference(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                             window: Optional[torch.Tensor] = None,
                             sigma: float = 0.0) -> torch.Tensor:
    """The plain version of :func:`fused_psd_sk_chirp_large`: the SK step's
    on BL's plain |DFT|^2, so that its s1 is
    :func:`.fused_psd_chirp_large.chirp_large_reference`'s bit for bit."""
    return fused_psd_sk_reference(raw_u8, n_valid, chunk, window, sigma,
                                  frame_power=bl.chirp_large_power)


def tapers_chirp_large_reference(raw_u8: torch.Tensor, n_valid: int,
                                 chunk: int, tapers: torch.Tensor
                                 ) -> torch.Tensor:
    """The plain version of :func:`fused_psd_tapers_chirp_large`."""
    return fused_psd_tapers_reference(raw_u8, n_valid, chunk, tapers,
                                      dft_power=bl.chirp_large_dft_power)


def pfb_chirp_large_reference(raw_u8: torch.Tensor, history: torch.Tensor,
                              n_valid: int, chunk: int, h: torch.Tensor,
                              history_out: torch.Tensor, fresh: bool = False
                              ) -> torch.Tensor:
    """The plain version of :func:`fused_psd_pfb_chirp_large`."""
    return fused_psd_pfb_reference(raw_u8, history, n_valid, chunk, h,
                                   history_out, fresh,
                                   dft_power=bl.chirp_large_dft_power)


def sk_chirp_large_streams_reference(raw_u8: torch.Tensor,
                                     n_valid: torch.Tensor, chunk: int,
                                     window: Optional[torch.Tensor] = None,
                                     sigma: float = 0.0) -> torch.Tensor:
    """The plain version of :func:`fused_psd_sk_chirp_large_streams`: each
    stream's s1 is :func:`.fused_psd_chirp_large.
    chirp_large_streams_reference`'s row bit for bit."""
    return fused_psd_sk_streams_reference(raw_u8, n_valid, chunk, window,
                                          sigma,
                                          frame_power=bl.chirp_large_power)


def tapers_chirp_large_streams_reference(raw_u8: torch.Tensor,
                                         n_valid: torch.Tensor, chunk: int,
                                         tapers: torch.Tensor
                                         ) -> torch.Tensor:
    """The plain version of :func:`fused_psd_tapers_chirp_large_streams`."""
    return fused_psd_tapers_streams_reference(
        raw_u8, n_valid, chunk, tapers, dft_power=bl.chirp_large_dft_power)


def pfb_chirp_large_streams_reference(raw_u8: torch.Tensor,
                                      history: torch.Tensor,
                                      n_valid: torch.Tensor, chunk: int,
                                      h: torch.Tensor,
                                      history_out: torch.Tensor,
                                      fresh: bool = False) -> torch.Tensor:
    """The plain version of :func:`fused_psd_pfb_chirp_large_streams`."""
    return fused_psd_pfb_streams_reference(
        raw_u8, history, n_valid, chunk, h, history_out, fresh,
        dft_power=bl.chirp_large_dft_power)


def kernel_attributes(N: int, which: int,
                      device: Optional[torch.device] = None) -> dict:
    """What a pass of the forms at N bins gets on the card (``which``:
    :data:`PASS_A` .. :data:`PFB_PASS_A`): registers and spill bytes a
    thread, static and dynamic shared bytes and threads a block, and the
    blocks that reside on one SM. Launches nothing."""
    index = (device or torch.device(
        "cuda", torch.cuda.current_device())).index or 0
    log2m = bl.chirp_regs_layout(N).log2m
    return library_attributes(
        LIBRARY, f"pass {which}",
        lambda lib, attrs: lib.rpf_fused_psd_chirp_large_est_attributes(
            log2m, which, index, attrs))


@functools.lru_cache(maxsize=64)
def grid(N: int, S: int, F: int, windowed: bool,
         index: int) -> Tuple[int, int, int]:
    """Frames a block of passes A, B and C over S streams of F frames at N:
    BL-S's grid from BL's residency (:func:`.fused_psd_chirp_large.
    streams_grid`; at S = 1 BL's own), so that SK-BL's s1 is BL's."""
    return bl.streams_grid(S, F, N, bl.pass_residency(N, windowed, index))


@functools.lru_cache(maxsize=64)
def sums_resident(N: int, index: int) -> int:
    """Blocks of PFB-BL's pass A on the pre-pass's sums that card
    ``index`` holds at once: its SMs times the blocks one SM holds."""
    device = torch.device("cuda", index)
    per_sm = kernel_attributes(N, PFB_PASS_A, device)["blocks_per_sm"]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * max(1, per_sm)


def _launch(kernel: str, raw3: torch.Tensor, extra: Optional[torch.Tensor],
            planes: int, out_shape: tuple, windowed: bool,
            group_c: Optional[int], call,
            sums_a: bool = False) -> torch.Tensor:
    """Check the loads' alignment, take the (S F, M) complex64 scratch and
    ``planes`` planes of each stream's partial rows, make the (*out_shape,
    row) output, and run ``call(lib, twiddle, inter, chirp, spectrum,
    scratch, partial, out, log2m, width, groups, stream)`` on the current
    stream with BL's tables at N; ``raw3`` is (S, F, 2N). Returns the
    output's first N columns. With ``sums_a`` pass A runs on the PFB
    pre-pass's sums, on a grid from its own residency
    (:func:`sums_resident`); pass A's frames a block change no bit."""
    from . import _build
    fp.check_alignment(kernel, raw3, RAW_ALIGN, extra, WINDOW_ALIGN)
    S, F, N = raw3.shape[0], raw3.shape[1], raw3.shape[2] // 2
    device = raw3.device
    t = bl.chirp_regs_layout(N)
    groups = grid(N, S, F, windowed, device.index)
    if group_c is not None:
        groups = (*groups[:2], int(group_c))
    if sums_a:
        groups = (fl.large_group(F, S * t.regs["tiles_a"],
                                 sums_resident(N, device.index)),
                  *groups[1:])
    rows = planes * S * -(-F // groups[2])
    lib = _build.load(LIBRARY)
    stream = _raw_stream(device.index)
    scratch, partial = workspace((LIBRARY, N, S * F, rows, device.index,
                                  stream), 2 * S * F * t.M, rows * t.row,
                                 device)
    out = torch.empty((*out_shape, t.row), dtype=torch.float32,
                      device=device)
    twiddle, inter, chirp, spectrum = (
        x.data_ptr() for x in bl.device_tables(N, device))
    err = call(lib, twiddle, inter, chirp, spectrum, scratch, partial,
               out.data_ptr(), t.log2m, copy_width(N, raw3.data_ptr()),
               groups, stream)
    if err != 0:
        raise fp.launch_error(kernel, lib, err)
    return out[..., :N]


def _one_count(n_valid: int, device: torch.device) -> torch.Tensor:
    """A one-stream call's count as the forms read it: (1,) int32 on the
    card."""
    return torch.full((1,), n_valid, dtype=torch.int32, device=device)


def _sk(kernel, raw3, counts, window, sigma, group_c):
    S, F, N = raw3.shape[0], raw3.shape[1], raw3.shape[2] // 2
    device = raw3.device
    return _launch(
        kernel, raw3, window, 2, (S, 4 if sigma > 0.0 else 2),
        window is not None, group_c,
        lambda lib, twiddle, inter, chirp, spectrum, scratch, partial, out,
        log2m, width, groups, stream: lib.rpf_fused_psd_sk_chirp_large(
            raw3.data_ptr(), twiddle, inter,
            None if window is None else window.data_ptr(), chirp, spectrum,
            counts.data_ptr(), scratch, partial, out, device.index, log2m, N,
            width, S, F, *groups, 2.0 * sigma, stream))


def _tapers(kernel, raw3, counts, tapers, group_c):
    S, F, N = raw3.shape[0], raw3.shape[1], raw3.shape[2] // 2
    K = tapers.shape[0]
    device = raw3.device
    return _launch(
        kernel, raw3, tapers, K, (S,), True, group_c,
        lambda lib, twiddle, inter, chirp, spectrum, scratch, partial, out,
        log2m, width, groups, stream: lib.rpf_fused_psd_tapers_chirp_large(
            raw3.data_ptr(), twiddle, inter, tapers.data_ptr(), chirp,
            spectrum, counts.data_ptr(), scratch, partial, out, device.index,
            log2m, N, width, S, F, *groups, K, stream))


def _pfb(kernel, raw3, history, counts, h, history_out, fresh, group_c,
         control=False):
    S, F, N = raw3.shape[0], raw3.shape[1], raw3.shape[2] // 2
    P = h.shape[0]
    device = raw3.device
    if P > 1:
        check_streams_histories(kernel, history, history_out)
    return _launch(
        kernel, raw3, h, 1, (S,), False, group_c,
        lambda lib, twiddle, inter, chirp, spectrum, scratch, partial, out,
        log2m, width, groups, stream: (
            lib.rpf_fused_psd_pfb_chirp_large_control if control
            else lib.rpf_fused_psd_pfb_chirp_large)(
            raw3.data_ptr(), history.data_ptr() if P > 1 else None, twiddle,
            inter, h.data_ptr(), chirp, spectrum, counts.data_ptr(), scratch,
            partial, out, history_out.data_ptr() if P > 1 else None,
            device.index, log2m, N, width, S, F, *groups, P, int(fresh),
            stream),
        sums_a=not control and pfb_route(N, P, S * F) == "sums")



def _counted(count: str, out: torch.Tensor) -> torch.Tensor:
    """``out``, one launch more in ``COUNTS.<count>``."""
    setattr(fp.COUNTS, count, getattr(fp.COUNTS, count) + 1)
    return out


def _pfb_one(kernel, count, control, raw_u8, history, n_valid, chunk, h,
             history_out, fresh, group_c):
    """The one-stream PFB wrappers' body: the form, or with ``control``
    its first form, counted in ``COUNTS.<count>``; a CPU tensor the plain
    version."""
    n_valid = int(n_valid)
    fp.check_args(kernel, fused_psd_chirp_large_est_eligible, raw_u8, n_valid,
                  chunk, None)
    check_pfb_args(raw_u8, history, h, history_out)
    check_group(group_c, raw_u8.shape[0])
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return pfb_chirp_large_reference(raw_u8, history, n_valid, chunk, h,
                                         history_out, fresh)
    return _counted(count, _pfb(
        kernel, raw_u8[None], history, _one_count(n_valid, raw_u8.device),
        h, history_out, fresh, group_c, control)[0])


def _pfb_streams(kernel, count, control, raw_u8, history, n_valid, chunk, h,
                 history_out, fresh):
    """The streams PFB wrappers' body: the form, or with ``control`` its
    first form, counted in ``COUNTS.<count>``; a CPU tensor the plain
    version."""
    fp.check_streams_args(raw_u8, n_valid, chunk, None, kernel,
                          fused_psd_chirp_large_est_eligible)
    check_pfb_streams_args(raw_u8, history, h, history_out)
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return pfb_chirp_large_streams_reference(raw_u8, history, n_valid,
                                                 chunk, h, history_out, fresh)
    return _counted(count, _pfb(kernel, raw_u8, history, n_valid, h,
                                history_out, fresh, None, control))


def fused_psd_sk_chirp_large(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                             window: Optional[torch.Tensor] = None,
                             sigma: float = 0.0,
                             group_c: Optional[int] = None) -> torch.Tensor:
    """SK-BL: (F, 2N) uint8 frames, N even in (8192, 2^21], ``n_valid``
    real frames -> (2, N) float32 rows s1 = sum of |DFT|^2 and s2 = sum of
    |DFT|^4 over those frames; with ``sigma > 0`` (4, N), adding s1 * keep
    and n_valid * keep. ``window``: an (N,) float32 tensor on the same
    device, or None.

    A CUDA tensor runs the kernels on the current stream (asynchronously),
    on BL's grid, or with ``group_c`` frames a pass-C block where given (a
    streams call's, for a comparison on its groups); a CPU tensor runs the
    plain version."""
    kernel = "fused_psd_sk_chirp_large"
    n_valid, sigma = int(n_valid), float(sigma)
    fp.check_args(kernel, fused_psd_chirp_large_est_eligible, raw_u8, n_valid,
                  chunk, window)
    if not sigma >= 0.0:
        raise ValueError(f"sigma={sigma} must be >= 0")
    check_group(group_c, raw_u8.shape[0])
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return sk_chirp_large_reference(raw_u8, n_valid, chunk, window, sigma)
    out = _sk(kernel, raw_u8[None], _one_count(n_valid, raw_u8.device),
              window, sigma, group_c)
    fp.COUNTS.kernel_sk_chirp_large += 1
    return out[0]


def fused_psd_tapers_chirp_large(raw_u8: torch.Tensor, n_valid: int,
                                 chunk: int, tapers: torch.Tensor,
                                 group_c: Optional[int] = None
                                 ) -> torch.Tensor:
    """MT-BL: (F, 2N) uint8 frames, N even in (8192, 2^21], ``n_valid``
    real frames, (K, N) float32 ``tapers`` on the same device -> (N,)
    float32: the sum over those frames of the mean over the K tapers of
    |DFT(x * taper_k)|^2.

    A CUDA tensor runs the kernels on the current stream (asynchronously),
    on BL's windowed grid, or with ``group_c`` frames a pass-C block where
    given; a CPU tensor runs the plain version."""
    kernel = "fused_psd_tapers_chirp_large"
    n_valid = int(n_valid)
    fp.check_args(kernel, fused_psd_chirp_large_est_eligible, raw_u8, n_valid,
                  chunk, None)
    check_tapers(tapers, raw_u8)
    check_group(group_c, raw_u8.shape[0])
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return tapers_chirp_large_reference(raw_u8, n_valid, chunk, tapers)
    out = _tapers(kernel, raw_u8[None], _one_count(n_valid, raw_u8.device),
                  tapers, group_c)
    fp.COUNTS.kernel_tapers_chirp_large += 1
    return out[0]


def fused_psd_pfb_chirp_large(raw_u8: torch.Tensor, history: torch.Tensor,
                              n_valid: int, chunk: int, h: torch.Tensor,
                              history_out: torch.Tensor, fresh: bool = False,
                              group_c: Optional[int] = None) -> torch.Tensor:
    """PFB-BL: (F, 2N) uint8 frames (N even in (8192, 2^21]) after (P - 1,
    2N) uint8 ``history`` rows, ``n_valid`` real frames, a (P, N) float32
    prototype ``h`` -> (N,) float32 sum over those frames of |DFT(polyphase
    sum)|^2; the next history goes to ``history_out`` (distinct from
    ``history``). With ``fresh`` the history is taken as byte 127 (a reset)
    and set so. All on the frames' device.

    A CUDA tensor runs the kernels on the current stream (asynchronously:
    ``history_out`` is written after the sum on that stream), on BL's grid,
    or with ``group_c`` frames a pass-C block where given; a CPU tensor
    runs the plain version."""
    return _pfb_one("fused_psd_pfb_chirp_large", "kernel_pfb_chirp_large",
                    False, raw_u8, history, n_valid, chunk, h, history_out,
                    fresh, group_c)


def fused_psd_pfb_chirp_large_control(raw_u8: torch.Tensor,
                                      history: torch.Tensor, n_valid: int,
                                      chunk: int, h: torch.Tensor,
                                      history_out: torch.Tensor,
                                      fresh: bool = False,
                                      group_c: Optional[int] = None
                                      ) -> torch.Tensor:
    """:func:`fused_psd_pfb_chirp_large` by its first form (the control,
    timed beside it): the polyphase sums in pass A's load. The same
    arguments, output and next history, bit for bit. Counted in
    ``COUNTS.kernel_pfb_chirp_large_control``; a CPU tensor runs the plain
    version."""
    return _pfb_one("fused_psd_pfb_chirp_large_control",
                    "kernel_pfb_chirp_large_control", True, raw_u8, history,
                    n_valid, chunk, h, history_out, fresh, group_c)


def fused_psd_sk_chirp_large_streams(raw_u8: torch.Tensor,
                                     n_valid: torch.Tensor, chunk: int,
                                     window: Optional[torch.Tensor] = None,
                                     sigma: float = 0.0) -> torch.Tensor:
    """SK-BL-S: (S, F, 2N) uint8 frames of S streams (N even in (8192,
    2^21]), ``n_valid`` (S,) int32 real frames per stream on the frames'
    device -> (S, 2, N) float32, rows s1 and s2 of each stream's first
    n_valid[s] frames (a count outside [0, F] acts as its nearest bound);
    with ``sigma > 0`` (S, 4, N), adding s1 * keep and n_valid[s] * keep,
    each stream gated on its own moments and count. ``window``: an (N,)
    float32 tensor on the same device, or None.

    A CUDA tensor runs the kernels on the current stream (asynchronously:
    they read ``n_valid`` from device memory when they run) on BL-S's
    grid, so that each stream's s1 is its row; a CPU tensor runs the plain
    version."""
    kernel = "fused_psd_sk_chirp_large_streams"
    sigma = float(sigma)
    fp.check_streams_args(raw_u8, n_valid, chunk, window, kernel,
                          fused_psd_chirp_large_est_eligible)
    if not sigma >= 0.0:
        raise ValueError(f"sigma={sigma} must be >= 0")
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return sk_chirp_large_streams_reference(raw_u8, n_valid, chunk,
                                                window, sigma)
    out = _sk(kernel, raw_u8, n_valid, window, sigma, None)
    fp.COUNTS.kernel_sk_chirp_large_streams += 1
    return out


def fused_psd_tapers_chirp_large_streams(raw_u8: torch.Tensor,
                                         n_valid: torch.Tensor, chunk: int,
                                         tapers: torch.Tensor
                                         ) -> torch.Tensor:
    """MT-BL-S: (S, F, 2N) uint8 frames of S streams, ``n_valid`` (S,)
    int32 real frames per stream, (K, N) float32 ``tapers``, all on one
    device -> (S, N) float32: row s the sum over stream s's first
    n_valid[s] frames of the mean over the K tapers of |DFT(x *
    taper_k)|^2.

    A CUDA tensor runs the kernels on the current stream (asynchronously)
    on BL-S's windowed grid; a CPU tensor runs the plain version."""
    kernel = "fused_psd_tapers_chirp_large_streams"
    fp.check_streams_args(raw_u8, n_valid, chunk, None, kernel,
                          fused_psd_chirp_large_est_eligible)
    check_tapers(tapers, raw_u8)
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return tapers_chirp_large_streams_reference(raw_u8, n_valid, chunk,
                                                    tapers)
    out = _tapers(kernel, raw_u8, n_valid, tapers, None)
    fp.COUNTS.kernel_tapers_chirp_large_streams += 1
    return out


def fused_psd_pfb_chirp_large_streams(raw_u8: torch.Tensor,
                                      history: torch.Tensor,
                                      n_valid: torch.Tensor, chunk: int,
                                      h: torch.Tensor,
                                      history_out: torch.Tensor,
                                      fresh: bool = False) -> torch.Tensor:
    """PFB-BL-S: (S, F, 2N) uint8 frames of S streams (N even in (8192,
    2^21]), each after its (P - 1, 2N) rows of the (S, P - 1, 2N) uint8
    ``history``, ``n_valid`` (S,) int32 real frames per stream, a (P, N)
    float32 prototype ``h`` -> (S, N) float32, row s
    :func:`fused_psd_pfb_chirp_large` of stream s (a count outside [0, F]
    acts as its nearest bound); each stream's next history goes to its
    rows of ``history_out`` (distinct from ``history``); with ``fresh``
    every stream's history is taken as byte 127 (a reset) and set so. All
    on the frames' device.

    A CUDA tensor runs the kernels on the current stream (asynchronously:
    they read ``n_valid`` from device memory when they run, and write
    ``history_out`` after the sum) on BL-S's grid; a CPU tensor runs the
    plain version."""
    return _pfb_streams("fused_psd_pfb_chirp_large_streams",
                        "kernel_pfb_chirp_large_streams", False, raw_u8,
                        history, n_valid, chunk, h, history_out, fresh)


def fused_psd_pfb_chirp_large_streams_control(raw_u8: torch.Tensor,
                                              history: torch.Tensor,
                                              n_valid: torch.Tensor,
                                              chunk: int, h: torch.Tensor,
                                              history_out: torch.Tensor,
                                              fresh: bool = False
                                              ) -> torch.Tensor:
    """:func:`fused_psd_pfb_chirp_large_streams` by its first form (the
    control): the same arguments, output and next histories, bit for bit.
    Counted in ``COUNTS.kernel_pfb_chirp_large_streams_control``; a CPU
    tensor runs the plain version."""
    return _pfb_streams("fused_psd_pfb_chirp_large_streams_control",
                        "kernel_pfb_chirp_large_streams_control", True, raw_u8,
                        history, n_valid, chunk, h, history_out, fresh)
