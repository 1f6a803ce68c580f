"""Chirp-Z (Bluestein) fused PSD step: raw u8 IQ frames -> (N,) f32
partial power sum, at any even N up to 8192.

Replaces ``rtl_power_fftw_tpu/ops/dft.py:bluestein_psd_partial`` (the JAX
package's chirp-Z rung, run through XLA's FFT, no Pallas kernel) with a
CUDA C++ kernel written for Hopper, ``psd_chirp_kernel`` of
``csrc/fused_psd_chirp.cuh`` in the library of ``csrc/fused_psd_mixed.cu``.
It computes the function of :func:`fused_psd <.fused_psd.fused_psd>`
(dequantize, [window,] length-N DFT, |X|^2, mask, sum over frames, bins in
natural order) with the N-point DFT as one circular convolution of length
M >= 2N - 1:

    X[k] = a[k] * IFFT_M(FFT_M(x * a) * B)[k],  a[n] = e^(-i pi n^2 / N),
    B = FFT_M(v),  v[m] = conj(a[|m|]) for |m| < N laid out circularly,

with the tables of :func:`bluestein_constants` (the JAX package's
``_bluestein_constants`` in natural order: built in float64 with exact
integer angle reduction and rounded once to complex64). The kernel's M is
:func:`chirp_size` (the least power of two, at least 64), its transforms
K1's register FFT (``csrc/fft_regs.cuh``) by M's pass plan
(:func:`chirp_plan`, ``fused_psd.PASS_PLAN``), the inverse as its
transposed passes; its tables are B / M permuted into the forward
transform's output order of that plan (:func:`spectrum_table`) and a
(:func:`chirp_table`); a window multiplies the samples before the chirp,
as in ``bluestein_psd_partial``. Its grid is K1's rule
(``fused_psd.k1_group``) over its own residency
(:func:`chirp_resident_blocks`). :func:`fused_psd_bluestein_streams` does
it for S streams at once, as K4 does.

:func:`fused_psd_bluestein` and :func:`fused_psd_bluestein_streams`
dispatch on the tensor's device: a CPU tensor goes to the plain PyTorch
version (:func:`bluestein_psd_reference`, the same chirp-Z algorithm in
torch ops); a CUDA tensor goes to the kernel, or raises.
``COUNTS.kernel_bluestein`` and ``COUNTS.kernel_bluestein_streams`` (in
:mod:`.fused_psd`) count its launches. The kernel it replaced, the chirp-Z
instantiation of the control template (``csrc/fused_psd_mixed.cuh`` over
M's mixed-radix plan :func:`bluestein_plan`, with the table of that
plan), runs only as :func:`fused_psd_bluestein_control`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .fused_psd import (COUNTS, PASS_PLAN, _device_pass_twiddles, _on_cuda,
                        check_alignment, check_args, check_streams_args,
                        k1_group, resident_of)
from .fused_psd_large import _raw_stream
from .fused_psd_mixed import (CONTROL_COUNTS, RING_RAW_ALIGN, SUM_BINS,
                              WINDOW_ALIGN, MixedLaunch, _attributes,
                              check_either, copy_width, element_of_bin,
                              launch_control, launch_error, launch_shape,
                              mixed_plan, partial_rows, ring_slot)

#: Largest N the kernel takes: M = next_pow2(2N - 1) <= 16384, whose
#: padded complex frame (139 KB) and two ring slots fit the 227 KB of
#: shared memory a Hopper block may use.
MAX_N = 8192
#: The kernel's smallest M: the register FFT's smallest size.
MIN_M = 64
#: Threads a block of the kernel has at least (kRegsMinThreads).
MIN_THREADS = 256


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, n - 1).bit_length()


def fused_psd_bluestein_eligible(N: int) -> bool:
    """True iff the kernel takes N bins: even, 2..8192."""
    return 2 <= N <= MAX_N and N % 2 == 0


def _chirp64(N: int) -> np.ndarray:
    """a[n] = e^(-i pi n^2 / N), n < N, in float64, the angle reduced
    exactly (n^2 mod 2N in int64)."""
    n = np.arange(N, dtype=np.int64)
    ang = -np.pi * ((n * n) % (2 * N)).astype(np.float64) / N
    return np.cos(ang) + 1j * np.sin(ang)


def chirp_size(N: int) -> int:
    """The kernel's transform length at N: the least power of two
    >= 2N - 1, at least MIN_M."""
    return max(MIN_M, next_pow2(2 * N - 1))


@functools.lru_cache(maxsize=8)
def bluestein_constants(N: int, M: Optional[int] = None
                        ) -> Tuple[int, np.ndarray, np.ndarray]:
    """(M, a, B): M (default next_pow2(2N - 1); any M >= 2N - 1), the chirp
    a[n] = e^(-i pi n^2 / N) (N,) complex64, and B = FFT_M(v) (M,)
    complex64 in natural order, v the conjugate chirp laid out circularly
    (v[m] = conj(a[m]) and v[M - m] = conj(a[m]), 0 < m < N). Built in
    float64 with exact integer angle reduction (n^2 mod 2N in int64) and
    rounded once, as ``rtl_power_fftw_tpu/ops/dft.py:_bluestein_constants``
    builds them (which holds B in its four-step layout)."""
    M = next_pow2(2 * N - 1) if M is None else M
    if M < 2 * N - 1:
        raise ValueError(f"M={M} is below 2N - 1 at N={N}")
    a = _chirp64(N)
    v = np.zeros(M, np.complex128)
    v[:N] = np.conj(a)
    v[M - N + 1:] = np.conj(a[1:][::-1])
    B = np.fft.fft(v)
    return M, a.astype(np.complex64), B.astype(np.complex64)


def bluestein_plan(N: int) -> Tuple[int, ...]:
    """The control's pow-2 plan of M's transforms:
    :func:`.fused_psd_mixed.mixed_plan` of M = next_pow2(2N - 1), its one
    pass split in two where it has one (M <= 16), since the turn between
    the transforms is the last pass's butterfly."""
    M = next_pow2(2 * N - 1)
    plan = mixed_plan(M)
    if len(plan) == 1:
        plan = {4: (2, 2), 8: (4, 2), 16: (4, 4)}[M]
    return plan


def chirp_plan(N: int) -> Tuple[int, ...]:
    """The kernel's plan at N: the register FFT's pass plan of
    :func:`chirp_size` (fused_psd.PASS_PLAN, pass_radix in
    csrc/fft_regs.cuh)."""
    return PASS_PLAN[chirp_size(N)]


def spectrum_table(N: int, plan: Optional[Tuple[int, ...]] = None
                   ) -> np.ndarray:
    """B / M as (M, 2) float32 (re, im) in the output order of the forward
    transform by ``plan`` (M its product; default the control's
    :func:`bluestein_plan`, :func:`chirp_plan` for the kernel): row q holds
    the bin :func:`.fused_psd_mixed.element_of_bin` puts at element q. (M
    is a power of two, so B / M rounds nothing.)"""
    plan = bluestein_plan(N) if plan is None else tuple(plan)
    M, _, B = bluestein_constants(N, int(np.prod(plan)))
    order = np.empty(M, np.int64)
    order[element_of_bin(plan, np.arange(M))] = np.arange(M)
    S = (B[order] / np.float32(M)).astype(np.complex64)
    return np.stack([S.real, S.imag], -1).astype(np.float32)


def chirp_table(N: int) -> np.ndarray:
    """The kernel's chirp a, (N, 2) float32 (re, im)."""
    a = bluestein_constants(N)[1]
    return np.stack([a.real, a.imag], -1).astype(np.float32)


@functools.lru_cache(maxsize=64)
def bluestein_launch(N: int) -> MixedLaunch:
    """The control's block layout at N: M's plan, N bins summed."""
    return launch_shape(bluestein_plan(N), N)


class ChirpLaunch(NamedTuple):
    """The kernel's layout at N (ChirpShape in csrc/fused_psd_chirp.cuh):
    K1's register layout of M."""
    bins: int       # N
    M: int          # chirp_size(N)
    R: int          # values a thread holds (the plan's first radix)

    @property
    def log2m(self) -> int:
        return self.M.bit_length() - 1

    @property
    def tf(self) -> int:
        """Threads a frame lane: M / R."""
        return self.M // self.R

    @property
    def threads(self) -> int:
        return max(MIN_THREADS, self.tf)

    @property
    def lanes(self) -> int:
        return self.threads // self.tf

    @property
    def row(self) -> int:
        return -(-self.bins // SUM_BINS) * SUM_BINS

    @property
    def smem(self) -> int:
        """Shared bytes a block: the padded exchange buffers, then the
        lanes' rings (two slots and 32 bytes each)."""
        return self.lanes * ((self.M + self.M // 16) * 8
                             + 2 * ring_slot(self.bins) + 32)


@functools.lru_cache(maxsize=64)
def chirp_launch(N: int) -> ChirpLaunch:
    """The kernel's block layout at N bins."""
    if not fused_psd_bluestein_eligible(N):
        raise ValueError(f"fused_psd_bluestein does not take N={N}")
    return ChirpLaunch(N, chirp_size(N), chirp_plan(N)[0])


def chirp_power(z: torch.Tensor) -> torch.Tensor:
    """|DFT|^2 along the last axis by the chirp-Z algorithm in torch ops
    (times a, FFT_M, times B, IFFT_M, times a): (..., N) complex64 ->
    (..., N) float32."""
    N = z.shape[-1]
    M, a_np, B_np = bluestein_constants(N)
    a = torch.from_numpy(a_np).to(z.device)
    B = torch.from_numpy(B_np).to(z.device)
    y = torch.fft.ifft(torch.fft.fft(z * a, n=M, dim=-1) * B, dim=-1)
    X = y[..., :N] * a
    return X.real * X.real + X.imag * X.imag


def _power(raw_u8: torch.Tensor,
           window: Optional[torch.Tensor]) -> torch.Tensor:
    """|DFT|^2 of every frame by the chirp-Z algorithm in torch ops:
    (..., 2N) uint8 -> (..., N) float32."""
    N = raw_u8.shape[-1] // 2
    v = raw_u8.reshape(*raw_u8.shape[:-1], N, 2).to(torch.int32)
    re = (v[..., 0] - 127).to(torch.float32)
    im = (v[..., 1] - 127).to(torch.float32)
    if window is not None:
        re = re * window
        im = im * window
    return chirp_power(torch.complex(re, im))


def bluestein_psd_reference(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                            window: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The plain PyTorch version: (F, 2N) uint8 -> (N,) float32, the
    chirp-Z algorithm of ``bluestein_psd_partial`` (dequantize, [window in
    float32,] times a, FFT_M, times B, IFFT_M, times a, |.|^2, frames f >=
    n_valid dropped, a two-stage sum)."""
    F, two_n = raw_u8.shape
    N = two_n // 2
    pwr = _power(raw_u8, window)
    pwr[n_valid:] = 0.0
    return pwr.reshape(F // chunk, chunk, N).sum(dim=1).sum(dim=0)


def bluestein_psd_streams_reference(raw_u8: torch.Tensor,
                                    n_valid: torch.Tensor, chunk: int,
                                    window: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """The plain version of the streams entry: (S, F, 2N) uint8, (S,)
    counts -> (S, N) float32 (a count outside [0, F] acts as its nearest
    bound)."""
    S, F, two_n = raw_u8.shape
    N = two_n // 2
    pwr = _power(raw_u8, window)
    keep = (torch.arange(F, device=raw_u8.device)[None, :]
            < n_valid.to(raw_u8.device)[:, None])
    pwr = torch.where(keep[..., None], pwr, 0.0)
    return pwr.reshape(S, F // chunk, chunk, N).sum(dim=2).sum(dim=1)


@functools.lru_cache(maxsize=16)
def device_tables(N: int, device: torch.device, kernel: bool = True):
    """The chirp a and B / M in element order, on the device: of the
    kernel's plan (:func:`chirp_plan`), or of the control's
    (:func:`bluestein_plan`) where ``kernel`` is False."""
    plan = chirp_plan(N) if kernel else bluestein_plan(N)
    return (torch.from_numpy(chirp_table(N)).to(device),
            torch.from_numpy(spectrum_table(N, plan)).to(device))


def chirp_attributes(N: int, windowed: bool = False,
                     device: Optional[torch.device] = None) -> dict:
    """What the kernel at N bins (windowed or not) gets on the card:
    registers and spill bytes a thread, static and dynamic shared bytes
    and threads a block, and the blocks that reside on one SM. Launches
    nothing."""
    device = device or torch.device("cuda", torch.cuda.current_device())
    shape = chirp_launch(N)
    return _attributes(f"the chirp-Z kernel at N={N}", lambda lib, attrs:
                       lib.rpf_fused_psd_chirp_attributes(
                           shape.log2m, N, int(windowed), device.index or 0,
                           attrs))


@functools.lru_cache(maxsize=64)
def chirp_resident_blocks(N: int, windowed: bool, index: int) -> int:
    """Blocks of the kernel at N bins that card ``index`` holds resident.
    Asked of the card once per key."""
    return resident_of(chirp_attributes(N, windowed,
                                      torch.device("cuda", index)), index)


class _ChirpPlan(NamedTuple):
    lib: object         # the loaded library
    group: int          # frames a block
    rows: int           # partial rows (blocks)
    tables: tuple       # twiddle, chirp and spectrum device pointers
    keep: tuple         # the tensors behind them


_plans: dict = {}


def _plan(N: int, F: int, chunk: int, windowed: bool, streams: int,
          device: torch.device) -> _ChirpPlan:
    """The kernel's launch of F frames a stream over ``streams`` streams,
    cached per key."""
    key = (N, F, chunk, windowed, streams, device.index)
    plan = _plans.get(key)
    if plan is None:
        from . import _build
        group = k1_group(streams * F, chunk,
                         chirp_resident_blocks(N, windowed, device.index))
        keep = (_device_pass_twiddles(chirp_size(N), device),
                *device_tables(N, device))
        plan = _plans[key] = _ChirpPlan(
            _build.load("fused_psd_mixed"), group, streams * -(-F // group),
            tuple(t.data_ptr() for t in keep), keep)
    return plan


def launch_chirp(kernel: str, raw_u8: torch.Tensor, n_valid, chunk: int,
                 window: Optional[torch.Tensor]) -> torch.Tensor:
    """Runs the kernel on CUDA frames, on the current stream
    (asynchronously): (F, 2N) frames with an int ``n_valid`` -> (N,), or
    (S, F, 2N) frames with (S,) int32 counts on the device -> (S, N), a
    view of (S, N rounded up to 32) rows. ``kernel`` names the entry in
    errors."""
    check_alignment(kernel, raw_u8, RING_RAW_ALIGN, window, WINDOW_ALIGN)
    streams = raw_u8.dim() == 3
    S = raw_u8.shape[0] if streams else 1
    F, N = raw_u8.shape[-2], raw_u8.shape[-1] // 2
    device = raw_u8.device
    shape = chirp_launch(N)
    width = copy_width(N, raw_u8.data_ptr())
    plan = _plan(N, F, chunk, window is not None, S, device)
    stream = _raw_stream(device.index)
    partial = partial_rows(shape.row, plan.rows, device, stream)
    out = torch.empty((S, shape.row), dtype=torch.float32, device=device)
    twiddle, chirp, spectrum = plan.tables
    tables = (raw_u8.data_ptr(), twiddle,
              None if window is None else window.data_ptr(), chirp, spectrum)
    if streams:
        err = plan.lib.rpf_fused_psd_chirp_streams(
            *tables, n_valid.data_ptr(), partial, out.data_ptr(),
            device.index, shape.log2m, N, S, F, plan.group, width, stream)
    else:
        err = plan.lib.rpf_fused_psd_chirp(
            *tables, partial, out.data_ptr(), device.index, shape.log2m, N,
            F, plan.group, n_valid, width, stream)
    if err != 0:
        raise launch_error(kernel, plan.lib, err)
    return out[:, :N] if streams else out[0, :N]


def fused_psd_bluestein(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                        window: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(F, 2N) uint8 frames, N even up to 8192, ``n_valid`` real frames ->
    (N,) float32 sum of |DFT|^2 over those frames, on the tensor's device.
    ``window``: an (N,) float32 tensor on the same device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously);
    a CPU tensor runs the plain version."""
    n_valid = int(n_valid)
    check_args("fused_psd_bluestein", fused_psd_bluestein_eligible, raw_u8,
               n_valid, chunk, window)
    if not _on_cuda("fused_psd_bluestein", raw_u8):
        COUNTS.plain += 1
        return bluestein_psd_reference(raw_u8, n_valid, chunk, window)
    out = launch_chirp("fused_psd_bluestein", raw_u8, n_valid, chunk, window)
    COUNTS.kernel_bluestein += 1
    return out


def fused_psd_bluestein_streams(raw_u8: torch.Tensor, n_valid: torch.Tensor,
                                chunk: int,
                                window: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """(S, F, 2N) uint8 frames of S streams, ``n_valid`` (S,) int32 real
    frames per stream on the frames' device -> (S, N) float32, row s the
    sum of |DFT|^2 over stream s's first n_valid[s] frames. ``window``: an
    (N,) float32 tensor on the same device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously);
    a CPU tensor runs the plain version. On the card the result is a view
    of (S, N rounded up to 32) rows."""
    check_streams_args(raw_u8, n_valid, chunk, window,
                       "fused_psd_bluestein_streams",
                       fused_psd_bluestein_eligible)
    if not _on_cuda("fused_psd_bluestein_streams", raw_u8):
        COUNTS.plain += 1
        return bluestein_psd_streams_reference(raw_u8, n_valid, chunk,
                                               window)
    out = launch_chirp("fused_psd_bluestein_streams", raw_u8, n_valid, chunk,
                       window)
    COUNTS.kernel_bluestein_streams += 1
    return out


def fused_psd_bluestein_control(raw_u8: torch.Tensor, n_valid, chunk: int,
                                window: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """The control, the kernel :func:`fused_psd_bluestein` replaced: the
    function of :func:`fused_psd_bluestein` on (F, 2N) frames with an int
    ``n_valid``, or of :func:`fused_psd_bluestein_streams` on (S, F, 2N)
    frames with (S,) int32 counts. A CUDA tensor runs the control; a CPU
    tensor the plain version. Counted in
    ``fused_psd_mixed.CONTROL_COUNTS``."""
    n_valid = check_either("fused_psd_bluestein_control",
                           fused_psd_bluestein_eligible, raw_u8, n_valid,
                           chunk, window)
    if not _on_cuda("fused_psd_bluestein_control", raw_u8):
        CONTROL_COUNTS.plain += 1
        plain = (bluestein_psd_streams_reference if raw_u8.dim() == 3
                 else bluestein_psd_reference)
        return plain(raw_u8, n_valid, chunk, window)
    N = raw_u8.shape[-1] // 2
    out = launch_control("fused_psd_bluestein_control", bluestein_launch(N),
                         raw_u8, n_valid, chunk, window,
                         device_tables(N, raw_u8.device, False))
    CONTROL_COUNTS.kernel_bluestein += 1
    return out
