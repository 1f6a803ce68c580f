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

The kernel is K1's register transform and sums (``csrc/fused_psd_regs.cuh``
and ``fft_regs.cuh``) with a load stage that reads P rows a frame through
L2, on K1's grid rule (:func:`.fused_psd.k1_group`) over its own
occupancy (:func:`resident_blocks`).

:func:`fused_psd_pfb` dispatches on the tensor's device: a CPU tensor runs
the plain PyTorch version (:func:`fused_psd_pfb_reference`), a CUDA tensor
the kernel, or raises. ``COUNTS.kernel_pfb`` counts the kernel's
launches.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from . import fused_psd as fp

#: Taps a call takes (the session's ``--pfb-taps`` accepts 2..32; the
#: library's ``pfb_psd`` 1 too).
MAX_TAPS = 32
#: The kernel reads the rows as u16 pairs and the prototype as floats.
RAW_ALIGN = 4


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
                            fresh: bool = False) -> torch.Tensor:
    """The plain PyTorch version: (N,) float32, and the next history
    written into ``history_out`` (``fresh``: the history set to byte 127
    first)."""
    F, two_n = raw_u8.shape
    N = two_n // 2
    if fresh:
        history.fill_(127)
    virtual = torch.cat([history, raw_u8])
    X = torch.fft.fft(pfb_sums_reference(virtual, h, F), dim=-1)
    pwr = X.real * X.real + X.imag * X.imag
    pwr[n_valid:] = 0.0
    history_out.copy_(virtual[n_valid:n_valid + h.shape[0] - 1])
    return pwr.reshape(F // chunk, chunk, N).sum(dim=1).sum(dim=0)


def fused_psd_pfb(raw_u8: torch.Tensor, history: torch.Tensor, n_valid: int,
                  chunk: int, h: torch.Tensor, history_out: torch.Tensor,
                  fresh: bool = False) -> torch.Tensor:
    """(F, 2N) uint8 frames after (P - 1, 2N) uint8 ``history`` rows,
    ``n_valid`` real frames, a (P, N) float32 prototype ``h`` -> (N,)
    float32 sum over those frames of |DFT(polyphase sum)|^2; the next
    history goes to ``history_out`` (distinct from ``history``). With
    ``fresh`` the history is taken as byte 127 (a reset) and set so. All on
    the frames' device.

    A CUDA tensor runs the kernel on the current stream (asynchronously:
    ``history_out`` is written after the kernel on that stream); a CPU
    tensor runs the plain version."""
    n_valid = int(n_valid)
    fp.check_args("fused_psd_pfb", fp.fused_psd_eligible, raw_u8, n_valid,
                  chunk, None)
    check_pfb_args(raw_u8, history, h, history_out)
    if not fp._on_cuda("fused_psd_pfb", raw_u8):
        fp.COUNTS.plain += 1
        return fused_psd_pfb_reference(raw_u8, history, n_valid, chunk, h,
                                       history_out, fresh)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    P = h.shape[0]
    index = raw_u8.device.index
    group = fp.k1_group(F, chunk, resident_blocks(N, index))
    fp.check_alignment("fused_psd_pfb", history, RAW_ALIGN, None, 1)
    out = fp._launch(
        "fused_psd_pfb", raw_u8, h, -(-F // group), (N,),
        lambda lib, raw, twiddle, hp, partial, out, stream:
        lib.rpf_fused_psd_pfb(raw, history.data_ptr(), twiddle, hp, partial,
                              out, history_out.data_ptr(), index,
                              N.bit_length() - 1, F, group, n_valid, P,
                              int(fresh), stream),
        library="fused_psd_pfb", raw_align=RAW_ALIGN)
    fp.COUNTS.kernel_pfb += 1
    return out


def kernel_attributes(N: int, device: Optional[torch.device] = None
                      ) -> dict:
    """What the kernel gets at N bins on the card, as
    :func:`.fused_psd.kernel_attributes` gives K1's. Launches nothing."""
    return fp.library_attributes("fused_psd_pfb", N, device=device)


@functools.lru_cache(maxsize=64)
def resident_blocks(N: int, index: int) -> int:
    """Blocks of the kernel at N bins that card ``index`` holds resident:
    its SMs times :func:`kernel_attributes`' blocks per SM."""
    device = torch.device("cuda", index)
    per_sm = kernel_attributes(N, device)["blocks_per_sm"]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * max(1, per_sm)
