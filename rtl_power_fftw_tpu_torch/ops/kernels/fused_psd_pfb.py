"""Polyphase-filterbank step: raw u8 IQ rows -> (N,) f32 channelized power.

Replaces the device step of ``rtl_power_fftw_tpu/models/pfb.py``
(``_pfb_core`` as ``_pfb_session_step`` runs it, XLA there) with a CUDA
C++ kernel written for Hopper (``csrc/fused_psd_pfb.cu``). Its input is
one virtual array of F + P - 1 raw rows: P - 1 history rows (the last rows
the acquisition consumed) and then the (F, 2N) slot of new frames. Output
frame j is the polyphase sum S_j = sum over p = 0 .. P-1 of h[p] *
x_{j+p}, in that order from zero and in float32 without FMA, of the
dequantized rows x (u8 - 127); then |DFT(S_j)|^2, frames j >= n_valid
dropped, summed over frames; bins in natural order. After the step the
next history (rows n_valid .. n_valid + P - 2 of the virtual array) is
written to ``history_out`` on the same stream.

The kernels are K1's register transform and sums
(``csrc/fused_psd_regs.cuh`` and ``fft_regs.cuh``) after a load stage of
their own, on K1's grid rule (:func:`.fused_psd.k1_group`) over their own
occupancy. The ring kernel stages each raw row of a block once in a
shared-memory ring of 2 LANES + P - 1 rows by ``cp.async``, the next
LANES rows in flight, and the (P, N) prototype beside it where that still
leaves two blocks an SM (:func:`ring_shape`, a rule on (N, P) alone); it
is the route wherever its ring fits a block. Elsewhere (16384 bins at P
>= 2) the route is the kernel it was redesigned from, which reads P rows
a frame and the prototype through L2 (:func:`fused_psd_pfb_control` runs
it at every size). On the same grid both give the same bits.

:func:`fused_psd_pfb_streams` runs S streams of F frames at once (the
``--streams`` step) on the kernel :func:`ring_shape` picks, S folded into
its grid as K4 folds it into K1's: (S, P - 1, 2N) histories in two device
buffers the caller swaps, each stream's count read from an (S,) array on
the device, one output row a stream, and each stream's next history taken
from its own valid rows on the device (``pfb_history_kernel``).

:func:`fused_psd_pfb` and :func:`fused_psd_pfb_streams` dispatch on the
tensor's device: a CPU tensor runs the plain PyTorch version
(:func:`fused_psd_pfb_reference`, :func:`fused_psd_pfb_streams_reference`),
a CUDA tensor the kernel, or raises. ``COUNTS.kernel_pfb_ring`` counts the
ring kernel's launches, ``COUNTS.kernel_pfb`` the control's, and
``COUNTS.kernel_pfb_streams`` and ``COUNTS.kernel_pfb_streams_control``
their streams launches.

:func:`pfb_channelize` ("PFB-C") is the channelizer of the JAX package's
``models/pfb.py:pfb_channelize``: the same polyphase sums over one (T + P -
1, 2N) array of raw rows (its first P - 1 rows the history of output
frame 0) and K1's register transform, with X itself stored as row j of a
(T, N) complex64 output (``pfb_channelize_kernel``, through the lane's
exchange buffer) in place of the sum of |X|^2; the ring kernel's load
where :func:`ring_shape` fits a block, else the control's.
``COUNTS.kernel_pfb_channelize`` counts its launches,
``COUNTS.plain_pfb_channelize`` its plain version's (also in
``COUNTS.plain``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from . import fused_psd as fp
from .fused_psd_large import _raw_stream

#: Taps a call takes (the session's ``--pfb-taps`` accepts 2..32; the
#: library's ``pfb_psd`` 1 too).
MAX_TAPS = 32
#: The control reads the rows as u16 pairs and the prototype as floats;
#: the ring kernel copies rows (and a staged prototype) 16 bytes a thread.
RAW_ALIGN = 4
RING_ALIGN = 16
#: A ring slot's bytes past its row: the next lane's row on other banks.
ROW_PAD = 32


class RingShape(NamedTuple):
    """The ring kernel's block at (N, P): ``slots`` row slots of 2N +
    :data:`ROW_PAD` bytes, whether the prototype is staged beside them
    (``stage_h``), its shared memory (``smem`` bytes) and the blocks one SM
    holds by threads and shared memory (``blocks_per_sm``)."""
    slots: int
    stage_h: bool
    smem: int
    blocks_per_sm: int


@functools.lru_cache(maxsize=256)
def ring_shape(N: int, P: int) -> Optional[RingShape]:
    """The route's rule at N bins and P taps: None (the control) where the
    ring of 2 LANES + P - 1 rows and the exchange buffers exceed a block's
    shared memory, else the ring kernel's :class:`RingShape`, with the
    (P, N) float32 prototype staged where it fits beside them and still
    leaves two blocks an SM. Worked out once per (N, P)."""
    shape = fp.regs_shape(N)
    slots = 2 * shape.lanes + P - 1
    ring = shape.exchange + slots * (2 * N + ROW_PAD)
    if ring > fp.SMEM_PER_BLOCK:
        return None
    with_h = ring + 4 * P * N
    stage_h = fp.smem_blocks_per_sm(with_h, shape.threads) >= 2
    smem = with_h if stage_h else ring
    return RingShape(slots, stage_h, smem,
                     fp.smem_blocks_per_sm(smem, shape.threads))


def check_pfb_args(raw_u8: torch.Tensor, history: torch.Tensor,
                   h: torch.Tensor, history_out: torch.Tensor) -> None:
    """Raise unless ``h`` is a contiguous (P, N) float32 tensor, 1 <= P <=
    :data:`MAX_TAPS`, and ``history`` and ``history_out`` are distinct
    contiguous (P - 1, 2N) uint8 tensors, all on the frames' device."""
    two_n = raw_u8.shape[-1]
    if (not isinstance(h, torch.Tensor) or h.dtype != torch.float32
            or h.dim() != 2 or h.shape[1] != two_n // 2
            or not 1 <= h.shape[0] <= MAX_TAPS or not h.is_contiguous()):
        raise ValueError(f"h must be a contiguous (P, {two_n // 2}) float32 "
                         f"tensor with 1 <= P <= {MAX_TAPS}")
    P = h.shape[0]
    for name, t in (("history", history), ("history_out", history_out)):
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.uint8
                or tuple(t.shape) != (P - 1, two_n) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({P - 1}, "
                             f"{two_n}) uint8 tensor")
    if P > 1 and history.data_ptr() == history_out.data_ptr():
        raise ValueError("history and history_out must be distinct")
    for name, t in (("h", h), ("history", history),
                    ("history_out", history_out)):
        if t.device != raw_u8.device:
            raise ValueError(f"{name} on {t.device}, frames on "
                             f"{raw_u8.device}")


def check_pfb_streams_args(raw_u8: torch.Tensor, history: torch.Tensor,
                           h: torch.Tensor, history_out: torch.Tensor
                           ) -> None:
    """:func:`check_pfb_args` for S streams: ``history`` and
    ``history_out`` distinct contiguous (S, P - 1, 2N) uint8 tensors."""
    S = raw_u8.shape[0]
    for name, t in (("history", history), ("history_out", history_out)):
        if not isinstance(t, torch.Tensor) or t.dim() != 3 or t.shape[0] != S:
            raise ValueError(f"{name} must be an ({S}, P - 1, 2N) tensor")
    check_pfb_args(raw_u8[0], history[0], h, history_out[0])
    for name, t in (("history", history), ("history_out", history_out)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if h.shape[0] > 1 and history.data_ptr() == history_out.data_ptr():
        raise ValueError("history and history_out must be distinct")


def pfb_sums_reference(virtual: torch.Tensor, h: torch.Tensor, F: int
                       ) -> torch.Tensor:
    """The polyphase sums of the plain version: (F + P - 1, 2N) uint8 rows
    -> (F, N) complex64, S_j = sum over p of h[p] * x_{j+p} in float32, p
    in order from zero (each product and each sum rounded on its own)."""
    P, N = h.shape
    v = virtual.reshape(-1, N, 2).to(torch.int32)
    xr = (v[..., 0] - 127).to(torch.float32)
    xi = (v[..., 1] - 127).to(torch.float32)
    sr = torch.zeros((F, N), dtype=torch.float32, device=virtual.device)
    si = torch.zeros((F, N), dtype=torch.float32, device=virtual.device)
    for p in range(P):
        sr = sr + xr[p:p + F] * h[p][None, :]
        si = si + xi[p:p + F] * h[p][None, :]
    return torch.complex(sr, si)


def fused_psd_pfb_reference(raw_u8: torch.Tensor, history: torch.Tensor,
                            n_valid: int, chunk: int, h: torch.Tensor,
                            history_out: torch.Tensor,
                            fresh: bool = False,
                            dft_power=fp.dft_power) -> torch.Tensor:
    """The plain PyTorch version: (N,) float32, and the next history
    written into ``history_out`` (``fresh``: the history set to byte 127
    first). ``dft_power`` gives |DFT|^2 of the polyphase sums (the chirp-Z
    form passes its own)."""
    F, two_n = raw_u8.shape
    N = two_n // 2
    if fresh:
        history.fill_(127)
    virtual = torch.cat([history, raw_u8])
    pwr = dft_power(pfb_sums_reference(virtual, h, F))
    pwr[n_valid:] = 0.0
    history_out.copy_(virtual[n_valid:n_valid + h.shape[0] - 1])
    return pwr.reshape(F // chunk, chunk, N).sum(dim=1).sum(dim=0)


def fused_psd_pfb_streams_reference(raw_u8: torch.Tensor,
                                    history: torch.Tensor,
                                    n_valid: torch.Tensor, chunk: int,
                                    h: torch.Tensor,
                                    history_out: torch.Tensor,
                                    fresh: bool = False,
                                    dft_power=fp.dft_power) -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_psd_pfb_streams`: each
    stream as :func:`fused_psd_pfb_reference` takes it (``dft_power``
    too), with its count clamped to [0, F], -> (S, N), and each stream's
    next history written into its rows of ``history_out``."""
    S, F = raw_u8.shape[:2]
    counts = n_valid.clamp(0, F).tolist()
    if fresh:
        history.fill_(127)
    return torch.stack([
        fused_psd_pfb_reference(raw_u8[s], history[s], counts[s], chunk, h,
                                history_out[s], dft_power=dft_power)
        for s in range(S)])


def fused_psd_pfb(raw_u8: torch.Tensor, history: torch.Tensor, n_valid: int,
                  chunk: int, h: torch.Tensor, history_out: torch.Tensor,
                  fresh: bool = False, group: Optional[int] = None
                  ) -> torch.Tensor:
    """(F, 2N) uint8 frames after (P - 1, 2N) uint8 ``history`` rows,
    ``n_valid`` real frames, a (P, N) float32 prototype ``h`` -> (N,)
    float32 sum over those frames of |DFT(polyphase sum)|^2; the next
    history goes to ``history_out`` (distinct from ``history``). With
    ``fresh`` the history is taken as byte 127 (a reset) and set so. All on
    the frames' device.

    A CUDA tensor runs the kernel :func:`ring_shape` picks on the current
    stream (asynchronously: ``history_out`` is written after the kernel on
    that stream), on ``group`` frames a block where given (a streams
    call's, for a comparison on its grid), else on :func:`pfb_group`'s; a
    CPU tensor runs the plain version."""
    return _pfb("fused_psd_pfb", raw_u8, history, n_valid, chunk, h,
                history_out, fresh, False, group)


def fused_psd_pfb_control(raw_u8: torch.Tensor, history: torch.Tensor,
                          n_valid: int, chunk: int, h: torch.Tensor,
                          history_out: torch.Tensor, fresh: bool = False,
                          group: Optional[int] = None) -> torch.Tensor:
    """:func:`fused_psd_pfb` on the kernel it was redesigned from (P rows
    a frame through L2) at every N, on ``group`` frames a block where
    given (the ring kernel's, :func:`pfb_group`, for a comparison on the
    same grid), else on its own grid; a CPU tensor runs the plain
    version."""
    return _pfb("fused_psd_pfb_control", raw_u8, history, n_valid, chunk, h,
                history_out, fresh, True, group)


def pfb_group(F: int, chunk: int, N: int, P: int, index: int,
              ring: bool) -> int:
    """Frames a block of the ring kernel (``ring``) or of the control sums
    at (F, chunk, N, P) on card ``index``: K1's rule over the kernel's own
    residency."""
    resident = (ring_resident_blocks(N, P, index) if ring
                else resident_blocks(N, index))
    return fp.k1_group(F, chunk, resident)


def _pfb(kernel: str, raw_u8: torch.Tensor, history: torch.Tensor,
         n_valid: int, chunk: int, h: torch.Tensor,
         history_out: torch.Tensor, fresh: bool, control: bool,
         group: Optional[int]) -> torch.Tensor:
    """Check, then run the plain version (CPU), or on the card the control
    (``control``) or else the kernel :func:`ring_shape` picks."""
    n_valid = int(n_valid)
    fp.check_args(kernel, fp.fused_psd_eligible, raw_u8, n_valid, chunk,
                  None)
    check_pfb_args(raw_u8, history, h, history_out)
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return fused_psd_pfb_reference(raw_u8, history, n_valid, chunk, h,
                                       history_out, fresh)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    P = h.shape[0]
    shape = None if control else ring_shape(N, P)
    index = raw_u8.device.index
    if group is None:
        group = pfb_group(F, chunk, N, P, index, shape is not None)
    align = RAW_ALIGN if shape is None else RING_ALIGN
    h_align = RING_ALIGN if shape is not None and shape.stage_h else RAW_ALIGN
    for name, t, a in (("history", history, align), ("h", h, h_align)):
        if t.data_ptr() % a:
            raise ValueError(f"{kernel}: {name} must be {a}-byte aligned on "
                             "the device")
    out = fp._launch(
        kernel, raw_u8, h, -(-F // group), (N,),
        lambda lib, raw, twiddle, hp, partial, out, stream:
        lib.rpf_fused_psd_pfb(raw, history.data_ptr(), twiddle, hp, partial,
                              out, history_out.data_ptr(), index,
                              N.bit_length() - 1, F, group, n_valid, P,
                              int(fresh), int(shape is not None),
                              int(shape is not None and shape.stage_h),
                              stream),
        library="fused_psd_pfb", raw_align=align)
    if shape is None:
        fp.COUNTS.kernel_pfb += 1
    else:
        fp.COUNTS.kernel_pfb_ring += 1
    return out


def fused_psd_pfb_streams(raw_u8: torch.Tensor, history: torch.Tensor,
                          n_valid: torch.Tensor, chunk: int, h: torch.Tensor,
                          history_out: torch.Tensor, fresh: bool = False
                          ) -> torch.Tensor:
    """(S, F, 2N) uint8 frames of S streams, each after its (P - 1, 2N)
    rows of the (S, P - 1, 2N) uint8 ``history``, ``n_valid`` (S,) int32
    real frames per stream, a (P, N) float32 prototype ``h`` -> (S, N)
    float32, row s :func:`fused_psd_pfb` of stream s (a count outside [0,
    F] acts as its nearest bound); each stream's next history goes to its
    rows of ``history_out`` (distinct from ``history``); with ``fresh``
    every stream's history is taken as byte 127 (a reset) and set so. All
    on the frames' device.

    A CUDA tensor runs the kernel :func:`ring_shape` picks on the current
    stream (asynchronously: the kernels read ``n_valid`` from device memory
    when they run, and write ``history_out`` after the sum), on K1's rule
    over all S * F frames and the kernel's residency; a CPU tensor runs
    the plain version."""
    kernel = "fused_psd_pfb_streams"
    fp.check_streams_args(raw_u8, n_valid, chunk, None, kernel)
    check_pfb_streams_args(raw_u8, history, h, history_out)
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return fused_psd_pfb_streams_reference(raw_u8, history, n_valid,
                                               chunk, h, history_out, fresh)
    S, F, N = raw_u8.shape[0], raw_u8.shape[1], raw_u8.shape[2] // 2
    P = h.shape[0]
    shape = ring_shape(N, P)
    index = raw_u8.device.index
    group = pfb_group(S * F, chunk, N, P, index, shape is not None)
    align = RAW_ALIGN if shape is None else RING_ALIGN
    h_align = RING_ALIGN if shape is not None and shape.stage_h else RAW_ALIGN
    for name, t, a in (("history", history, align), ("h", h, h_align)):
        if t.data_ptr() % a:
            raise ValueError(f"{kernel}: {name} must be {a}-byte aligned on "
                             "the device")
    out = fp._launch(
        kernel, raw_u8, h, S * -(-F // group), (S, N),
        lambda lib, raw, twiddle, hp, partial, out, stream:
        lib.rpf_fused_psd_pfb_streams(
            raw, history.data_ptr(), twiddle, hp, n_valid.data_ptr(), partial,
            out, history_out.data_ptr(), index, N.bit_length() - 1, S, F,
            group, P, int(fresh), int(shape is not None),
            int(shape is not None and shape.stage_h), stream),
        library="fused_psd_pfb", raw_align=align)
    if shape is None:
        fp.COUNTS.kernel_pfb_streams_control += 1
    else:
        fp.COUNTS.kernel_pfb_streams += 1
    return out


def kernel_attributes(N: int, P: int, ring: bool,
                      device: Optional[torch.device] = None) -> dict:
    """What a kernel gets at N bins and P taps on the card, as
    :func:`.fused_psd.kernel_attributes` gives K1's: the ring kernel's
    (``ring``) at its :func:`ring_shape`, or the control's. Launches
    nothing."""
    shape = ring_shape(N, P) if ring else None
    if ring and shape is None:
        raise ValueError(f"the ring kernel does not fit N={N}, P={P}")
    return fp.library_attributes(
        "fused_psd_pfb", N, P, int(shape is not None),
        int(shape is not None and shape.stage_h), device=device)


@functools.lru_cache(maxsize=64)
def resident_blocks(N: int, index: int) -> int:
    """Blocks of the control at N bins that card ``index`` holds resident:
    its SMs times :func:`kernel_attributes`' blocks per SM."""
    device = torch.device("cuda", index)
    return fp.resident_of(kernel_attributes(N, 1, False, device), index)


@functools.lru_cache(maxsize=64)
def ring_resident_blocks(N: int, P: int, index: int) -> int:
    """Blocks of the ring kernel at N bins and P taps that card ``index``
    holds resident."""
    device = torch.device("cuda", index)
    return fp.resident_of(kernel_attributes(N, P, True, device), index)


def pfb_channelize_reference(rows: torch.Tensor, h: torch.Tensor
                             ) -> torch.Tensor:
    """The plain PyTorch version of :func:`pfb_channelize`: (T + P - 1, 2N)
    uint8 rows, (P, N) float32 prototype -> (T, N) complex64, the DFT of
    :func:`pfb_sums_reference`'s sums."""
    T = rows.shape[0] - h.shape[0] + 1
    return torch.fft.fft(pfb_sums_reference(rows, h, T), dim=-1)


def check_channelize_args(rows: torch.Tensor, h: torch.Tensor) -> int:
    """Raise unless ``rows`` is a contiguous (T + P - 1, 2N) uint8 tensor
    with N a power of two from 64 to 16384 and T >= 1, and ``h`` a
    contiguous (P, N) float32 tensor on its device, 1 <= P <=
    :data:`MAX_TAPS`; returns T."""
    if (not isinstance(rows, torch.Tensor) or rows.dtype != torch.uint8
            or rows.dim() != 2 or rows.shape[1] % 2
            or not rows.is_contiguous()):
        raise ValueError("rows must be a contiguous (T + P - 1, 2N) uint8 "
                         "tensor")
    N = rows.shape[1] // 2
    if not fp.fused_psd_eligible(N):
        raise ValueError(f"pfb_channelize does not take N={N}")
    if (not isinstance(h, torch.Tensor) or h.dtype != torch.float32
            or h.dim() != 2 or h.shape[1] != N
            or not 1 <= h.shape[0] <= MAX_TAPS or not h.is_contiguous()):
        raise ValueError(f"h must be a contiguous (P, {N}) float32 tensor "
                         f"with 1 <= P <= {MAX_TAPS}")
    if h.device != rows.device:
        raise ValueError(f"h on {h.device}, rows on {rows.device}")
    T = rows.shape[0] - h.shape[0] + 1
    if T < 1:
        raise ValueError(f"{rows.shape[0]} rows make no output frame at "
                         f"P={h.shape[0]}")
    return T


def pfb_channelize(rows: torch.Tensor, h: torch.Tensor,
                   ring: Optional[bool] = None) -> torch.Tensor:
    """PFB-C: (T + P - 1, 2N) uint8 raw rows, a (P, N) float32 prototype
    ``h`` -> (T, N) complex64, row j the DFT (natural bin order) of the
    polyphase sum S_j = sum over p of h[p] x_{j+p} (float32, p in order
    from zero, no FMA), on the rows' device.

    A CUDA tensor runs the kernel on the current stream (asynchronously),
    in the form :func:`ring_shape` picks (``ring=False``: the control's
    load at any N); a CPU tensor runs the plain version."""
    T = check_channelize_args(rows, h)
    if not fp._on_cuda("pfb_channelize", rows):
        fp.COUNTS.plain += 1
        fp.COUNTS.plain_pfb_channelize += 1
        return pfb_channelize_reference(rows, h)
    N, P = rows.shape[1] // 2, h.shape[0]
    shape = ring_shape(N, P) if ring is not False else None
    ring, stage_h = shape is not None, shape is not None and shape.stage_h
    for name, t, a in (("rows", rows, RING_ALIGN if ring else RAW_ALIGN),
                       ("h", h, RING_ALIGN if stage_h else RAW_ALIGN)):
        if t.data_ptr() % a:
            raise ValueError(f"pfb_channelize: {name} must be {a}-byte "
                             "aligned on the device")
    device = rows.device
    plan = fp.library_plan("fused_psd_pfb", N, T, CHANNELIZE_CHUNK,
                           device.index, P, int(ring), int(stage_h),
                           entry="rpf_pfb_channelize_attributes")
    out = torch.empty((T, N), dtype=torch.complex64, device=device)
    err = plan.lib.rpf_pfb_channelize(
        rows.data_ptr(), plan.twiddle, h.data_ptr(), out.data_ptr(),
        device.index, plan.log2n, T, plan.group, P, int(ring), int(stage_h),
        _raw_stream(device.index))
    if err != 0:
        raise fp.launch_error("pfb_channelize", plan.lib, err)
    fp.COUNTS.kernel_pfb_channelize += 1
    return out


#: Frames a block of the channelizer takes at most: K1's grid rule with
#: this chunk.
CHANNELIZE_CHUNK = 64


def channelize_attributes(N: int, P: int, ring: Optional[bool] = None,
                          device: Optional[torch.device] = None) -> dict:
    """What the channelizer's form (:func:`ring_shape`'s; ``ring=False``
    the control's load) gets at N bins and P taps on the card, as
    :func:`kernel_attributes` gives the PFB kernels'. Launches nothing."""
    shape = ring_shape(N, P) if ring is not False else None
    return fp.library_attributes(
        "fused_psd_pfb", N, P, int(shape is not None),
        int(shape is not None and shape.stage_h), device=device,
        entry="rpf_pfb_channelize_attributes")
