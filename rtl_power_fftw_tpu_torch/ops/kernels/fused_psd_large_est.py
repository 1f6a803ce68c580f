"""The CLI estimators' steps at the large powers of two: spectral kurtosis
(SK-L), the multitaper (MT-L) and the polyphase filterbank (PFB-L) at every
power of two N from 32768 to 2^22.

The JAX package computes these estimators in XLA at every N
(``rtl_power_fftw_tpu/models/kurtosis.py:_sk_step``,
``multitaper.py:_mt_core``, ``pfb.py:_pfb_core``; at these N its transform
is ``ops/dft.py:fourstep4m_psd_partial`` or ``fourstep_psd_partial``), with
no Pallas kernel. Here they are forms of the large kernel's two register
passes (:mod:`.fused_psd_large`, ``csrc/fused_psd_large_est.cu``), each the
function of its counterpart at N <= 16384 (:mod:`.fused_psd_sk`,
:mod:`.fused_psd_tapers`, :mod:`.fused_psd_pfb`), and each written once
for S >= 1 streams with an (S,) count array on the card; the one-stream
wrappers call it at S = 1:

* :func:`fused_psd_sk_large`: (F, 2N) frames -> (2, N) s1 = the sum of
  |X|^2, s2 = the sum of |X|^4 over the valid frames; with ``sigma > 0``
  (4, N), the gate (:func:`.fused_psd_sk.sk_keep`) as the sum's epilogue.
  The large kernel's pass A, and a pass B that keeps the |X|^4 sums beside
  its |X|^2 sums; on the large kernel's grid (which the wrapper takes) s1
  is :func:`.fused_psd_large.fused_psd_large`'s output bit for bit.
* :func:`fused_psd_tapers_large`: the mean over K tapers of |DFT(x *
  taper_k)|^2 summed over the valid frames: both passes once a taper (pass
  A windowed by the taper) over one scratch, taper k's rows in plane k of
  the partial rows, summed in float64 and divided by K.
* :func:`fused_psd_pfb_large`: |DFT(S_j)|^2 of the polyphase sums S_j =
  sum over p of h[p] x_{j+p} (p in order from zero, float32, no FMA) over
  P - 1 history rows and the F frames, formed by a pre-pass
  (``csrc/pfb_sums.cuh``: one streaming pass over n, h and the older rows
  in registers) into the scratch, in pass A's threads' order where pass A
  writes its batch (:func:`sums_place`), which pass A reads back in place
  of its ring; the next history written to ``history_out`` on the
  stream.
  :func:`fused_psd_pfb_large_control` runs its first form, the sums in
  pass A's load (the own row from the ring, the older rows and h through
  L1/L2), on the same arguments: the same bits.

:func:`fused_psd_sk_large_streams`, :func:`fused_psd_tapers_large_streams`
and :func:`fused_psd_pfb_large_streams` (SK-L-S, MT-L-S, PFB-L-S; PFB-L-S's
control :func:`fused_psd_pfb_large_streams_control`) take S streams of F
frames, (S, F, 2N), on L-S's grid
(:func:`.fused_psd_large.streams_grid`): each stream's rows are the
one-stream form's on the same groups (the one-stream wrappers'
``group_b``), and SK-L-S's s1 is :func:`.fused_psd_large.
fused_psd_large_streams`'s row bit for bit.

Each dispatches on the tensor's device: a CPU tensor runs the plain
PyTorch version (:func:`sk_large_reference`, :func:`tapers_large_reference`,
:func:`pfb_large_reference` and their streams forms: the power-of-two
counterparts' with the large kernel's four steps in torch ops,
:func:`.fused_psd_large.large_dft_power`, for the transform); a CUDA
tensor the kernels, or raises. ``COUNTS.kernel_sk_large``,
``kernel_tapers_large`` and ``kernel_pfb_large`` (in :mod:`.fused_psd`)
count their launches, with ``_streams`` after each the streams wrappers',
and ``kernel_pfb_large_control`` and ``kernel_pfb_large_streams_control``
the controls'.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import fused_psd as fp
from . import fused_psd_large as fl
from .fused_psd_mixed_est import check_group, check_streams_histories
from .fused_psd_mixed_large import library_attributes, workspace
from .fused_psd_pfb import (check_pfb_args, check_pfb_streams_args,
                            fused_psd_pfb_reference,
                            fused_psd_pfb_streams_reference)
from .fused_psd_sk import (fused_psd_sk_reference,
                           fused_psd_sk_streams_reference)
from .fused_psd_tapers import (check_tapers, fused_psd_tapers_reference,
                               fused_psd_tapers_streams_reference)

LIBRARY = "fused_psd_large_est"
#: The bins the forms take: the large kernel's, the powers of two from
#: 32768 to 2^22.
MIN_N = fl.MIN_N
MAX_N = fl.MAX_N
#: The passes :func:`kernel_attributes` asks of, kept in step with the
#: source's attributes entry: L-S's pass A (unwindowed, windowed) and B,
#: SK's pass B, the PFB's pass A, its pre-pass at the tap classes 4 and 32
#: (:func:`sums_taps`), the control's PFB pass A, and the PFB's pass A on
#: the ring at P = 4, h streamed and h resident (N <= 2^21).
(PASS_A, PASS_A_WINDOWED, PASS_B, SK_PASS_B, PFB_PASS_A, PFB_SUMS,
 PFB_SUMS_32, PFB_CONTROL_A, PFB_RING_A, PFB_RING_RES_A) = range(10)
#: The PFB pre-pass's block: SUMS_ROWS rows of SUMS_COLS samples, two a
#: thread, and the blocks its grid aims at (``kSumsRows``, ``kSumsCols``,
#: ``kSumsBlocks`` of ``csrc/pfb_sums.cuh``).
SUMS_ROWS, SUMS_COLS, SUMS_BLOCKS = 16, 32, 2048
#: The pre-pass's turn through shared memory: SUMS_TURN float2 a column
#: (its 16 rows and a pad; ``kSumsTurn``).
SUMS_TURN = 17
#: The tap classes of the pre-pass's registers (``sums_taps``).
TAP_CLASSES = (2, 4, 8, 16, 32)
#: PFB-L's routes, as ``PfbRoute`` of the source numbers them: the
#: pre-pass and pass A on its sums; the first form (the polyphase sums in
#: pass A's load, which the control runs at every P); pass A on the ring of
#: virtual rows, h streamed tap by tap or resident.
ROUTES = ("sums", "load", "ring", "ring_res")
#: PFB-L's route table (``kPfbRoute`` of the source): by log2 N, for few
#: frames a call (S F < MANY_FRAMES) then many, the index in ROUTES of
#: each tap class of TAP_CLASSES, whichever the card measured faster
#: (``probes/large_estimator_builds.py``'s route sweep).
PFB_ROUTE = {15: ((1, 1, 1, 1, 1), (3, 3, 3, 0, 0)),
             16: ((1, 1, 1, 1, 1), (1, 3, 3, 0, 0)),
             17: ((1, 1, 3, 0, 0), (1, 3, 3, 0, 0)),
             18: ((2, 2, 0, 0, 0), (2, 2, 0, 0, 0)),
             19: ((2, 2, 0, 0, 0), (2, 2, 0, 0, 0)),
             20: ((3, 3, 0, 0, 0), (3, 3, 0, 0, 0)),
             21: ((3, 3, 0, 0, 0), (3, 3, 0, 0, 0)),
             22: ((0, 0, 0, 0, 0), (0, 0, 0, 0, 0))}
#: Frames a call (S F) from which the table's second column holds
#: (``kPfbManyFrames``).
MANY_FRAMES = 64
#: The largest N the ring routes take: an h tile row of B >= 4 floats.
RING_MAX_N = 1 << 21


def fused_psd_large_est_eligible(N: int) -> bool:
    """True iff the forms take N bins: a power of two, 32768..2^22."""
    return fl.fused_psd_large_eligible(N)


def pfb_route(N: int, P: int, frames: int) -> str:
    """PFB-L's route at N bins, P taps and ``frames`` (S F) a call, one of
    ROUTES."""
    return ROUTES[PFB_ROUTE[N.bit_length() - 1][int(frames >= MANY_FRAMES)][
        TAP_CLASSES.index(sums_taps(P))]]


def pfb_smem(N: int, route: str, P: int = 4) -> int:
    """Dynamic shared memory of the PFB's pass A on a route at N and P
    taps: the first form's, the large kernel's pass A (the exchange and two
    raw tile slots); on the sums, the exchange and two slots of a batch's
    sums (``sums_a_smem`` of the source); on the ring, the exchange, P raw
    tile slots and, h resident, h's (P, N1, C) slice (``ring_a_smem``).
    The pre-pass takes 4352 B of static shared memory at every N and P."""
    t = fl.regs_layout(N)
    exchange = 8 * t["B"] * t["XS"]
    if route == "load":
        return t["smem_a"]
    if route == "sums":
        return exchange + 2 * t["N1"] * t["B"] * 8
    resident = 4 * P * t["N1"] * t["C"] if route == "ring_res" else 0
    return exchange + P * t["N1"] * 2 * t["C"] + resident


def sums_taps(P: int) -> int:
    """The tap class the pre-pass's registers are sized for at P taps
    (``sums_taps`` of ``csrc/pfb_sums.cuh``): 2, 4, 8, 16 or 32."""
    return next(c for c in TAP_CLASSES if P <= c)


def sums_shape(N: int) -> dict:
    """The pre-pass's ``SumsShape`` at N: bins, log2 N2, log2 N1, log2 B,
    log2 V (pass A's layout, :func:`.fused_psd_large.regs_layout`), the
    rows with a sample and the float2 a frame of scratch."""
    t = fl.regs_layout(N)
    lg = lambda x: x.bit_length() - 1
    return {"bins": N, "log2n2": lg(t["N2"]), "log2n1": lg(t["N1"]),
            "log2b": lg(t["B"]), "log2v": lg(t["V"]), "rows": t["N1"],
            "frame": N}


def sums_place(shape: dict, n1, n2):
    """Where the pre-pass writes sum (n1, n2) of a frame (``sums_place``
    of the source): value k of pass A's thread tid of batch n2 / B, tid
    the thread of column c = n2 mod B that holds row n1 = t + k TF1
    (:func:`.fused_psd_large.thread_map` inverted), at (n2 / B) N1 B + k
    THREADS_A + tid: the run that batch writes, in its threads' order."""
    b, v, l1 = 1 << shape["log2b"], 1 << shape["log2v"], shape["log2n1"]
    tf = 1 << (l1 - 4)
    c, t, k = n2 & (b - 1), n1 & (tf - 1), n1 >> (l1 - 4)
    per = 16 >> shape["log2v"]
    tid = (c & (v - 1)) + v * (t % per) + 16 * ((c >> shape["log2v"])
                                              + (b // v) * (t // per))
    return ((n2 >> shape["log2b"]) << (l1 + shape["log2b"])) + k * b * tf \
        + tid


def sums_frames(shape: dict, S: int, F: int) -> int:
    """The pre-pass's frames a block over S streams of F frames
    (``sums_frames`` of the source): all F where its (rows / 16) (N2 / 32)
    S blocks a frame reach SUMS_BLOCKS, else the frames split into the
    fewest groups that do, at most one a frame."""
    blocks = ((shape["rows"] // SUMS_ROWS)
              * ((1 << shape["log2n2"]) // SUMS_COLS) * S)
    groups = min(F, max(1, -(-SUMS_BLOCKS // blocks)))
    return -(-F // groups)


def sums_grid(shape: dict, S: int, F: int) -> Tuple[int, int, int]:
    """The pre-pass's grid over S streams of F frames: (rows / 16) (N2 /
    32) blocks of 16 x 32 samples, a row of them a stream, a plane of rows
    a group of :func:`sums_frames` frames."""
    return ((shape["rows"] // SUMS_ROWS)
            * ((1 << shape["log2n2"]) // SUMS_COLS), S,
            -(-F // sums_frames(shape, S, F)))


def sk_large_reference(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                       window: Optional[torch.Tensor] = None,
                       sigma: float = 0.0) -> torch.Tensor:
    """The plain version of :func:`fused_psd_sk_large`: the SK step's on
    the large kernel's plain |DFT|^2, so that its s1 is
    :func:`.fused_psd_large.fused_psd_large_reference`'s bit for bit."""
    return fused_psd_sk_reference(raw_u8, n_valid, chunk, window, sigma,
                                  frame_power=fl.large_power)


def tapers_large_reference(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                           tapers: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`fused_psd_tapers_large`."""
    return fused_psd_tapers_reference(raw_u8, n_valid, chunk, tapers,
                                      dft_power=fl.large_dft_power)


def pfb_large_reference(raw_u8: torch.Tensor, history: torch.Tensor,
                        n_valid: int, chunk: int, h: torch.Tensor,
                        history_out: torch.Tensor, fresh: bool = False
                        ) -> torch.Tensor:
    """The plain version of :func:`fused_psd_pfb_large`."""
    return fused_psd_pfb_reference(raw_u8, history, n_valid, chunk, h,
                                   history_out, fresh,
                                   dft_power=fl.large_dft_power)


def sk_large_streams_reference(raw_u8: torch.Tensor, n_valid: torch.Tensor,
                               chunk: int,
                               window: Optional[torch.Tensor] = None,
                               sigma: float = 0.0) -> torch.Tensor:
    """The plain version of :func:`fused_psd_sk_large_streams`."""
    return fused_psd_sk_streams_reference(raw_u8, n_valid, chunk, window,
                                          sigma, frame_power=fl.large_power)


def tapers_large_streams_reference(raw_u8: torch.Tensor,
                                   n_valid: torch.Tensor, chunk: int,
                                   tapers: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`fused_psd_tapers_large_streams`."""
    return fused_psd_tapers_streams_reference(
        raw_u8, n_valid, chunk, tapers, dft_power=fl.large_dft_power)


def pfb_large_streams_reference(raw_u8: torch.Tensor, history: torch.Tensor,
                                n_valid: torch.Tensor, chunk: int,
                                h: torch.Tensor, history_out: torch.Tensor,
                                fresh: bool = False) -> torch.Tensor:
    """The plain version of :func:`fused_psd_pfb_large_streams`."""
    return fused_psd_pfb_streams_reference(
        raw_u8, history, n_valid, chunk, h, history_out, fresh,
        dft_power=fl.large_dft_power)


def kernel_attributes(N: int, which: int,
                      device: Optional[torch.device] = None) -> dict:
    """What a pass of the forms at N bins gets on the card (``which``:
    :data:`PASS_A` .. :data:`PFB_PASS_A`): registers and spill bytes a
    thread, static and dynamic shared bytes and threads a block, and the
    blocks that reside on one SM. Launches nothing."""
    index = (device or torch.device(
        "cuda", torch.cuda.current_device())).index or 0
    return library_attributes(
        LIBRARY, f"pass {which}",
        lambda lib, attrs: lib.rpf_fused_psd_large_est_attributes(
            N.bit_length() - 1, which, index, attrs))


@functools.lru_cache(maxsize=64)
def grid(N: int, S: int, F: int, windowed: bool,
         index: int) -> Tuple[int, int, int]:
    """(frames a pass-A block, frames a pass-B block, partial rows a
    stream) over S streams of F frames at N: L-S's grid from the large
    kernel's residency (:func:`.fused_psd_large.streams_grid`; at S = 1
    its own :func:`.fused_psd_large.regs_grid`), so that SK-L's s1 is the
    large kernel's output."""
    return fl.streams_grid(
        S, F, N,
        fl.resident_blocks(N, fl.PASS_A_WINDOWED if windowed else fl.PASS_A,
                           index),
        fl.resident_blocks(N, fl.PASS_B, index))


@functools.lru_cache(maxsize=64)
def sums_resident(N: int, index: int) -> int:
    """Blocks of PFB-L's pass A on the pre-pass's sums that card ``index``
    holds at once: its SMs times the blocks one SM holds (two)."""
    device = torch.device("cuda", index)
    per_sm = kernel_attributes(N, PFB_PASS_A, device)["blocks_per_sm"]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * max(1, per_sm)


def _launch(kernel: str, raw3: torch.Tensor, extra: Optional[torch.Tensor],
            planes: int, out_shape: tuple, windowed: bool,
            group_b: Optional[int], call,
            sums_a: bool = False) -> torch.Tensor:
    """Check the loads' alignment, take the (S F, N) complex64 scratch and
    ``planes`` planes of each stream's partial rows, make the (*out_shape,
    N) output, and run ``call(lib, twiddle, inter, scratch, partial, out,
    log2n, groups, stream)`` on the current stream with the large kernel's
    tables at N; ``raw3`` is (S, F, 2N). With ``sums_a`` pass A runs on
    the PFB pre-pass's sums, on a grid from its own residency
    (:func:`sums_resident`: two blocks an SM where the large kernel's pass
    A holds three); pass A's frames a block change no bit."""
    from . import _build
    fp.check_alignment(kernel, raw3, fl.RAW_ALIGN, extra, fl.WINDOW_ALIGN)
    S, F, N = raw3.shape[0], raw3.shape[1], raw3.shape[2] // 2
    device = raw3.device
    groups = grid(N, S, F, windowed, device.index)[:2]
    if group_b is not None:
        groups = (groups[0], int(group_b))
    if sums_a:
        groups = (fl.large_group(F, S * fl.regs_layout(N)["tiles_a"],
                                 sums_resident(N, device.index)), groups[1])
    rows = planes * S * -(-F // groups[1])
    lib = _build.load(LIBRARY)
    stream = fl._raw_stream(device.index)
    scratch, partial = workspace((LIBRARY, N, S * F, rows, device.index,
                                  stream), 2 * S * F * N, rows * N, device)
    out = torch.empty((*out_shape, N), dtype=torch.float32, device=device)
    twiddle, inter = (x.data_ptr() for x in fl.device_tables(N, device))
    err = call(lib, twiddle, inter, scratch, partial, out.data_ptr(),
               N.bit_length() - 1, groups, stream)
    if err != 0:
        raise fp.launch_error(kernel, lib, err)
    return out


def _one_count(n_valid: int, device: torch.device) -> torch.Tensor:
    """A one-stream call's count as the forms read it: (1,) int32 on the
    card."""
    return torch.full((1,), n_valid, dtype=torch.int32, device=device)


def _sk(kernel, raw3, counts, window, sigma, group_b):
    S, F = raw3.shape[0], raw3.shape[1]
    device = raw3.device
    return _launch(
        kernel, raw3, window, 2, (S, 4 if sigma > 0.0 else 2),
        window is not None, group_b,
        lambda lib, twiddle, inter, scratch, partial, out, log2n, groups,
        stream: lib.rpf_fused_psd_sk_large(
            raw3.data_ptr(), twiddle, inter,
            None if window is None else window.data_ptr(),
            counts.data_ptr(), scratch, partial, out, device.index, log2n,
            S, F, *groups, 2.0 * sigma, stream))


def _tapers(kernel, raw3, counts, tapers, group_b):
    S, F = raw3.shape[0], raw3.shape[1]
    K = tapers.shape[0]
    device = raw3.device
    return _launch(
        kernel, raw3, tapers, K, (S,), True, group_b,
        lambda lib, twiddle, inter, scratch, partial, out, log2n, groups,
        stream: lib.rpf_fused_psd_tapers_large(
            raw3.data_ptr(), twiddle, inter, tapers.data_ptr(),
            counts.data_ptr(), scratch, partial, out, device.index, log2n,
            S, F, *groups, K, stream))


def _pfb(kernel, raw3, history, counts, h, history_out, fresh, group_b,
         control=False):
    S, F = raw3.shape[0], raw3.shape[1]
    P = h.shape[0]
    device = raw3.device
    if P > 1:
        check_streams_histories(kernel, history, history_out)
    return _launch(
        kernel, raw3, h, 1, (S,), False, group_b,
        lambda lib, twiddle, inter, scratch, partial, out, log2n, groups,
        stream: (lib.rpf_fused_psd_pfb_large_control if control
                 else lib.rpf_fused_psd_pfb_large)(
            raw3.data_ptr(), history.data_ptr() if P > 1 else None, twiddle,
            inter, h.data_ptr(), counts.data_ptr(), scratch, partial, out,
            history_out.data_ptr() if P > 1 else None, device.index, log2n,
            S, F, *groups, P, int(fresh), stream),
        sums_a=not control and pfb_route(raw3.shape[2] // 2, P,
                                          S * F) == "sums")



def _counted(count: str, out: torch.Tensor) -> torch.Tensor:
    """``out``, one launch more in ``COUNTS.<count>``."""
    setattr(fp.COUNTS, count, getattr(fp.COUNTS, count) + 1)
    return out


def _pfb_one(kernel, count, control, raw_u8, history, n_valid, chunk, h,
             history_out, fresh, group_b):
    """The one-stream PFB wrappers' body: the form, or with ``control``
    its first form, counted in ``COUNTS.<count>``; a CPU tensor the plain
    version."""
    n_valid = int(n_valid)
    fp.check_args(kernel, fused_psd_large_est_eligible, raw_u8, n_valid,
                  chunk, None)
    check_pfb_args(raw_u8, history, h, history_out)
    check_group(group_b, raw_u8.shape[0])
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return pfb_large_reference(raw_u8, history, n_valid, chunk, h,
                                   history_out, fresh)
    return _counted(count, _pfb(
        kernel, raw_u8[None], history, _one_count(n_valid, raw_u8.device),
        h, history_out, fresh, group_b, control)[0])


def _pfb_streams(kernel, count, control, raw_u8, history, n_valid, chunk, h,
                 history_out, fresh):
    """The streams PFB wrappers' body: the form, or with ``control`` its
    first form, counted in ``COUNTS.<count>``; a CPU tensor the plain
    version."""
    fp.check_streams_args(raw_u8, n_valid, chunk, None, kernel,
                          fused_psd_large_est_eligible)
    check_pfb_streams_args(raw_u8, history, h, history_out)
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return pfb_large_streams_reference(raw_u8, history, n_valid,
                                           chunk, h, history_out, fresh)
    return _counted(count, _pfb(kernel, raw_u8, history, n_valid, h,
                                history_out, fresh, None, control))


def fused_psd_sk_large(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                       window: Optional[torch.Tensor] = None,
                       sigma: float = 0.0,
                       group_b: Optional[int] = None) -> torch.Tensor:
    """SK-L: (F, 2N) uint8 frames, N a power of two in [32768, 2^22],
    ``n_valid`` real frames -> (2, N) float32 rows s1 = sum of |DFT|^2 and
    s2 = sum of |DFT|^4 over those frames; with ``sigma > 0`` (4, N),
    adding s1 * keep and n_valid * keep. ``window``: an (N,) float32 tensor
    on the same device, or None.

    A CUDA tensor runs the kernels on the current stream (asynchronously),
    on the large kernel's grid, or with ``group_b`` frames a pass-B block
    where given (a streams call's, for a comparison on its groups); a CPU
    tensor runs the plain version."""
    kernel = "fused_psd_sk_large"
    n_valid, sigma = int(n_valid), float(sigma)
    fp.check_args(kernel, fused_psd_large_est_eligible, raw_u8, n_valid,
                  chunk, window)
    if not sigma >= 0.0:
        raise ValueError(f"sigma={sigma} must be >= 0")
    check_group(group_b, raw_u8.shape[0])
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return sk_large_reference(raw_u8, n_valid, chunk, window, sigma)
    out = _sk(kernel, raw_u8[None], _one_count(n_valid, raw_u8.device),
              window, sigma, group_b)
    fp.COUNTS.kernel_sk_large += 1
    return out[0]


def fused_psd_tapers_large(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                           tapers: torch.Tensor,
                           group_b: Optional[int] = None) -> torch.Tensor:
    """MT-L: (F, 2N) uint8 frames, N a power of two in [32768, 2^22],
    ``n_valid`` real frames, (K, N) float32 ``tapers`` on the same device
    -> (N,) float32: the sum over those frames of the mean over the K
    tapers of |DFT(x * taper_k)|^2.

    A CUDA tensor runs the kernels on the current stream (asynchronously),
    on the large kernel's windowed grid, or with ``group_b`` frames a
    pass-B block where given; a CPU tensor runs the plain version."""
    kernel = "fused_psd_tapers_large"
    n_valid = int(n_valid)
    fp.check_args(kernel, fused_psd_large_est_eligible, raw_u8, n_valid,
                  chunk, None)
    check_tapers(tapers, raw_u8)
    check_group(group_b, raw_u8.shape[0])
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return tapers_large_reference(raw_u8, n_valid, chunk, tapers)
    out = _tapers(kernel, raw_u8[None], _one_count(n_valid, raw_u8.device),
                  tapers, group_b)
    fp.COUNTS.kernel_tapers_large += 1
    return out[0]


def fused_psd_pfb_large(raw_u8: torch.Tensor, history: torch.Tensor,
                        n_valid: int, chunk: int, h: torch.Tensor,
                        history_out: torch.Tensor, fresh: bool = False,
                        group_b: Optional[int] = None) -> torch.Tensor:
    """PFB-L: (F, 2N) uint8 frames (N a power of two in [32768, 2^22])
    after (P - 1, 2N) uint8 ``history`` rows, ``n_valid`` real frames, a
    (P, N) float32 prototype ``h`` -> (N,) float32 sum over those frames
    of |DFT(polyphase sum)|^2; the next history goes to ``history_out``
    (distinct from ``history``). With ``fresh`` the history is taken as
    byte 127 (a reset) and set so. All on the frames' device.

    A CUDA tensor runs the kernels on the current stream (asynchronously:
    ``history_out`` is written after the sum on that stream), on the large
    kernel's grid, or with ``group_b`` frames a pass-B block where given; a
    CPU tensor runs the plain version."""
    return _pfb_one("fused_psd_pfb_large", "kernel_pfb_large", False,
                    raw_u8, history, n_valid, chunk, h, history_out, fresh,
                    group_b)


def fused_psd_pfb_large_control(raw_u8: torch.Tensor, history: torch.Tensor,
                                n_valid: int, chunk: int, h: torch.Tensor,
                                history_out: torch.Tensor,
                                fresh: bool = False,
                                group_b: Optional[int] = None
                                ) -> torch.Tensor:
    """:func:`fused_psd_pfb_large` by its first form (the control, timed
    beside it): the polyphase sums in pass A's load. The same arguments,
    output and next history, bit for bit. Counted in
    ``COUNTS.kernel_pfb_large_control``; a CPU tensor runs the plain
    version."""
    return _pfb_one("fused_psd_pfb_large_control",
                    "kernel_pfb_large_control", True, raw_u8, history,
                    n_valid, chunk, h, history_out, fresh, group_b)


def fused_psd_sk_large_streams(raw_u8: torch.Tensor, n_valid: torch.Tensor,
                               chunk: int,
                               window: Optional[torch.Tensor] = None,
                               sigma: float = 0.0) -> torch.Tensor:
    """SK-L-S: (S, F, 2N) uint8 frames of S streams (N a power of two in
    [32768, 2^22]), ``n_valid`` (S,) int32 real frames per stream on the
    frames' device -> (S, 2, N) float32, rows s1 and s2 of each stream's
    first n_valid[s] frames (a count outside [0, F] acts as its nearest
    bound); with ``sigma > 0`` (S, 4, N), adding s1 * keep and n_valid[s]
    * keep, each stream gated on its own moments and count. ``window``: an
    (N,) float32 tensor on the same device, or None.

    A CUDA tensor runs the kernels on the current stream (asynchronously:
    they read ``n_valid`` from device memory when they run) on L-S's grid,
    so that each stream's s1 is its row; a CPU tensor runs the plain
    version."""
    kernel = "fused_psd_sk_large_streams"
    sigma = float(sigma)
    fp.check_streams_args(raw_u8, n_valid, chunk, window, kernel,
                          fused_psd_large_est_eligible)
    if not sigma >= 0.0:
        raise ValueError(f"sigma={sigma} must be >= 0")
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return sk_large_streams_reference(raw_u8, n_valid, chunk, window,
                                          sigma)
    out = _sk(kernel, raw_u8, n_valid, window, sigma, None)
    fp.COUNTS.kernel_sk_large_streams += 1
    return out


def fused_psd_tapers_large_streams(raw_u8: torch.Tensor,
                                   n_valid: torch.Tensor, chunk: int,
                                   tapers: torch.Tensor) -> torch.Tensor:
    """MT-L-S: (S, F, 2N) uint8 frames of S streams, ``n_valid`` (S,)
    int32 real frames per stream, (K, N) float32 ``tapers``, all on one
    device -> (S, N) float32: row s the sum over stream s's first
    n_valid[s] frames of the mean over the K tapers of |DFT(x *
    taper_k)|^2.

    A CUDA tensor runs the kernels on the current stream (asynchronously)
    on L-S's windowed grid; a CPU tensor runs the plain version."""
    kernel = "fused_psd_tapers_large_streams"
    fp.check_streams_args(raw_u8, n_valid, chunk, None, kernel,
                          fused_psd_large_est_eligible)
    check_tapers(tapers, raw_u8)
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return tapers_large_streams_reference(raw_u8, n_valid, chunk,
                                              tapers)
    out = _tapers(kernel, raw_u8, n_valid, tapers, None)
    fp.COUNTS.kernel_tapers_large_streams += 1
    return out


def fused_psd_pfb_large_streams(raw_u8: torch.Tensor, history: torch.Tensor,
                                n_valid: torch.Tensor, chunk: int,
                                h: torch.Tensor, history_out: torch.Tensor,
                                fresh: bool = False) -> torch.Tensor:
    """PFB-L-S: (S, F, 2N) uint8 frames of S streams (N a power of two in
    [32768, 2^22]), each after its (P - 1, 2N) rows of the (S, P - 1, 2N)
    uint8 ``history``, ``n_valid`` (S,) int32 real frames per stream, a
    (P, N) float32 prototype ``h`` -> (S, N) float32, row s
    :func:`fused_psd_pfb_large` of stream s (a count outside [0, F] acts as
    its nearest bound); each stream's next history goes to its rows of
    ``history_out`` (distinct from ``history``); with ``fresh`` every
    stream's history is taken as byte 127 (a reset) and set so. All on the
    frames' device.

    A CUDA tensor runs the kernels on the current stream (asynchronously:
    they read ``n_valid`` from device memory when they run, and write
    ``history_out`` after the sum) on L-S's grid; a CPU tensor runs the
    plain version."""
    return _pfb_streams("fused_psd_pfb_large_streams",
                        "kernel_pfb_large_streams", False, raw_u8, history,
                        n_valid, chunk, h, history_out, fresh)


def fused_psd_pfb_large_streams_control(raw_u8: torch.Tensor,
                                        history: torch.Tensor,
                                        n_valid: torch.Tensor, chunk: int,
                                        h: torch.Tensor,
                                        history_out: torch.Tensor,
                                        fresh: bool = False
                                        ) -> torch.Tensor:
    """:func:`fused_psd_pfb_large_streams` by its first form (the
    control): the same arguments, output and next histories, bit for bit.
    Counted in ``COUNTS.kernel_pfb_large_streams_control``; a CPU tensor
    runs the plain version."""
    return _pfb_streams("fused_psd_pfb_large_streams_control",
                        "kernel_pfb_large_streams_control", True, raw_u8,
                        history, n_valid, chunk, h, history_out, fresh)
