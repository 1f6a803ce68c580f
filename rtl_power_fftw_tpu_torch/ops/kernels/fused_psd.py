"""Fused averaged-PSD step: raw u8 IQ frames -> (N,) f32 partial power sum.

Replaces ``rtl_power_fftw_tpu/ops/kernels/fused_psd.py:make_fused_psd_fn``
at default precision, unwindowed (K1) and windowed (K2), single-stream or
with ``streams=S>1`` (K4), with a CUDA C++ kernel written for Hopper
(``csrc/fused_psd.cu``). The computation:

1. dequantize: re = byte[2n] - 127, im = byte[2n+1] - 127; with a
   window, re·w[n] and im·w[n] in float32;
2. length-N DFT in float32;
3. |X|^2;
4. zero the frames f >= ``n_valid``;
5. sum over frames (two stages, so f32 rounding stays small);

with bins in natural, unshifted order (``finalize_psd`` applies the
fftshift once, per the JAX package's convention). :func:`fused_psd_streams`
(K4) does this for S streams of F frames at once, each with its own
valid count, one output row per stream.

What bounds the kernel on an H100, and what its design does about it, is
stated at the top of the CUDA source: the traffic through shared memory
and the barriers around it, not the 2 bytes per sample it reads from
device memory; its transform runs in registers (``csrc/fft_regs.cuh``:
radix-16 passes, one shared-memory exchange between passes, by the pass
plan :data:`PASS_PLAN`, twiddles from :func:`pass_twiddles`), the next
frame's bytes are copied into shared memory while the current one is
transformed, and each block sums as many frames as put the grid within
the blocks the card holds resident (:func:`k1_group`,
:func:`resident_blocks`). The radix-2
kernel it replaced (``csrc/fused_psd.cuh``, with :func:`stage_twiddles`
and :func:`frames_per_block`) stays as the probes' control.

:func:`fused_psd` and :func:`fused_psd_streams` dispatch on the tensor's
device: a CPU tensor goes to the plain PyTorch version
(:func:`fused_psd_reference`, :func:`fused_psd_streams_reference`); a CUDA
tensor goes to the kernel, or raises. :data:`COUNTS` records which one
served each call (K1, K2 and K4's two forms apart), so a run can show that
its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

#: Eligible sizes: powers of two whose complex f32 frame (8N bytes) fits
#: the 227 KB of shared memory a Hopper block may use (N = 16384 takes
#: 128 KB; 32768 would take 256 KB and goes to fused_psd_large), from the
#: size whose N/2 butterflies fill one warp. Kept in step with
#: kMinLog2N/kMaxLog2N in the source.
MIN_N = 64
MAX_N = 16384

#: Blocks the radix-2 kernel's launch aimed for (:func:`frames_per_block`,
#: which K3 and the probes still use): eight 256-thread blocks fill the
#: 2048 resident threads of each of the H100's 132 SMs (1056 blocks).
_TARGET_BLOCKS = 1024

#: The pass plan of the register transform: radices of its passes, first
#: to last; the first is the values a thread holds. Kept in step with
#: pass_radix in csrc/fft_regs.cuh.
PASS_PLAN = {64: (8, 8), 128: (16, 8), 256: (16, 16), 512: (16, 16, 2),
             1024: (16, 16, 4), 2048: (16, 16, 8), 4096: (16, 16, 16),
             8192: (16, 16, 16, 2), 16384: (16, 16, 16, 4)}

#: Alignment the group kernel's loads need: the frames are copied into
#: shared memory 16 bytes a thread, the window read as floats.
RAW_ALIGN = 16
WINDOW_ALIGN = 4

#: Shared memory on a Hopper SM: the most one block may use (227 KB), the
#: SM's whole (228 KB), and the 1 KB the system reserves for each
#: resident block.
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024
#: Threads a block of the group kernel has at least (kRegsMinThreads).
MIN_THREADS = 256


class RegsShape(NamedTuple):
    """The group kernel's block at N bins (``RegsShape`` of
    ``csrc/fused_psd_regs.cuh``): R values a thread, TF threads a frame,
    ``threads`` a block in ``lanes`` frame lanes, the lanes' padded
    exchange buffers (``exchange`` bytes), and with the two ring slots of
    each lane K1's whole shared memory (``smem`` bytes)."""
    R: int
    TF: int
    threads: int
    lanes: int
    exchange: int
    smem: int


def regs_shape(N: int) -> RegsShape:
    """:class:`RegsShape` at N bins (a key of :data:`PASS_PLAN`)."""
    R = PASS_PLAN[N][0]
    TF = N // R
    threads = max(MIN_THREADS, TF)
    lanes = threads // TF
    exchange = lanes * (N + N // 16) * 8
    return RegsShape(R, TF, threads, lanes, exchange,
                     exchange + lanes * (4 * N + 32))


def smem_blocks_per_sm(smem: int, threads: int) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes of shared memory
    that one Hopper SM holds by threads and shared memory alone (registers
    may hold fewer)."""
    return min(2048 // threads, SMEM_PER_SM // (smem + SMEM_RESERVED))


class KernelLaunchError(RuntimeError):
    """The CUDA launcher returned an error code."""


def launch_error(what: str, lib, err: int) -> KernelLaunchError:
    """The error of a library's launch or attributes call ``what`` that
    returned the cudaError ``err``, with the runtime's text for it."""
    return KernelLaunchError(
        f"{what} launch failed: {lib.rpf_cuda_error_string(err).decode()} "
        f"(cudaError {err})")


class LaunchCounts:
    """Calls served by the CUDA kernels of this module, of
    :mod:`.fused_psd_large`, :mod:`.fused_psd_mixed`,
    :mod:`.fused_psd_bluestein` and of the estimators'
    (:mod:`.fused_psd_sk`, :mod:`.fused_psd_tapers`, :mod:`.fused_psd_pfb`),
    and by their plain versions;
    ``kernel_windowed`` counts the kernel's windowed launches (K2) apart
    from its unwindowed ones (``kernel``, K1), ``kernel_streams`` /
    ``kernel_streams_windowed`` the streams launches (K4) likewise,
    ``kernel_large`` / ``kernel_large_windowed`` the large-N kernel's, and
    ``kernel_mixed`` / ``kernel_mixed_streams`` and ``kernel_bluestein`` /
    ``kernel_bluestein_streams`` the awkward-N kernels' (windowed or not),
    ``kernel_mixed_large`` / ``kernel_mixed_large_windowed`` and
    ``kernel_chirp_large`` / ``kernel_chirp_large_windowed`` the large
    awkward-N kernels' (:mod:`.fused_psd_mixed_large`,
    :mod:`.fused_psd_chirp_large`),
    and ``kernel_sk_plane``, ``kernel_tapers`` and ``kernel_pfb_ring`` the
    spectral kurtosis, multitaper and polyphase-filterbank kernels', with
    ``kernel_sk``, ``kernel_tapers_control`` and ``kernel_pfb`` the
    kernels they were redesigned from (the controls, and the route where
    the new ones do not fit a block), and ``kernel_sk_streams``,
    ``kernel_tapers_streams`` and ``kernel_pfb_streams`` (with
    ``_control`` after each, the controls') their streams entries', and
    ``kernel_large_streams``, ``kernel_mixed_large_streams`` and
    ``kernel_chirp_large_streams`` (with ``_windowed`` after each, their
    windowed launches) the streams entries of the large kernel, ML and
    BL, and ``kernel_frames`` / ``kernel_frames_windowed``,
    ``kernel_pfb_channelize``, ``kernel_csd`` / ``kernel_csd_windowed``
    and ``kernel_scf`` the library estimators' kernels
    (:mod:`.fused_psd_frames`, the channelizer of :mod:`.fused_psd_pfb`,
    :mod:`.fused_psd_csd`, :mod:`.fused_psd_scf`), and
    ``kernel_sk_mixed``, ``kernel_tapers_mixed`` and ``kernel_pfb_mixed``
    the estimators' forms of the mixed-radix kernel
    (:mod:`.fused_psd_mixed_est`: SK-M, MT-M, PFB-M), and
    ``kernel_sk_chirp``, ``kernel_tapers_chirp`` and ``kernel_pfb_chirp``
    their forms of the chirp-Z kernel (:mod:`.fused_psd_chirp_est`: SK-B,
    MT-B, PFB-B), with ``_streams`` after each of those six the streams
    forms' (SK-M-S ... PFB-B-S), and ``kernel_sk_chirp_large``,
    ``kernel_tapers_chirp_large`` and ``kernel_pfb_chirp_large`` their
    forms of BL's passes (:mod:`.fused_psd_chirp_large_est`: SK-BL, MT-BL,
    PFB-BL), with ``_streams`` after each the calls over streams (SK-BL-S
    ... PFB-BL-S), and ``kernel_sk_large``, ``kernel_tapers_large`` and
    ``kernel_pfb_large`` their forms of the large kernel's passes
    (:mod:`.fused_psd_large_est`: SK-L, MT-L, PFB-L), with ``_streams``
    after each the calls over streams (SK-L-S ... PFB-L-S), and
    ``kernel_pfb_large_control``, ``kernel_pfb_large_streams_control``,
    ``kernel_pfb_chirp_large_control`` and
    ``kernel_pfb_chirp_large_streams_control`` the first forms of PFB-L,
    PFB-L-S, PFB-BL and PFB-BL-S (the controls of their redesign), and
    ``kernel_sk_mixed_large``, ``kernel_tapers_mixed_large`` and
    ``kernel_pfb_mixed_large`` their forms of ML's passes
    (:mod:`.fused_psd_mixed_large_est`: SK-ML, MT-ML, PFB-ML), with
    ``_streams`` after each the calls over streams (SK-ML-S ... PFB-ML-S),
    and ``plain_frames``,
    ``plain_pfb_channelize``, ``plain_csd`` and ``plain_scf`` their plain
    versions' calls (each also counted in ``plain``, every plain
    version's).

    Incremented by the wrappers only; a session's single consumer thread
    is their only caller while a session runs."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.kernel = 0
        self.kernel_windowed = 0
        self.kernel_streams = 0
        self.kernel_streams_windowed = 0
        self.kernel_large = 0
        self.kernel_large_windowed = 0
        self.kernel_mixed = 0
        self.kernel_mixed_streams = 0
        self.kernel_bluestein = 0
        self.kernel_bluestein_streams = 0
        self.kernel_mixed_large = 0
        self.kernel_mixed_large_windowed = 0
        self.kernel_chirp_large = 0
        self.kernel_chirp_large_windowed = 0
        self.kernel_sk = 0
        self.kernel_sk_plane = 0
        self.kernel_tapers = 0
        self.kernel_tapers_control = 0
        self.kernel_pfb = 0
        self.kernel_pfb_ring = 0
        self.kernel_sk_streams = 0
        self.kernel_sk_streams_control = 0
        self.kernel_tapers_streams = 0
        self.kernel_tapers_streams_control = 0
        self.kernel_pfb_streams = 0
        self.kernel_pfb_streams_control = 0
        self.kernel_large_streams = 0
        self.kernel_large_streams_windowed = 0
        self.kernel_mixed_large_streams = 0
        self.kernel_mixed_large_streams_windowed = 0
        self.kernel_chirp_large_streams = 0
        self.kernel_chirp_large_streams_windowed = 0
        self.kernel_frames = 0
        self.kernel_frames_windowed = 0
        self.kernel_pfb_channelize = 0
        self.kernel_csd = 0
        self.kernel_csd_windowed = 0
        self.kernel_scf = 0
        self.kernel_sk_mixed = 0
        self.kernel_tapers_mixed = 0
        self.kernel_pfb_mixed = 0
        self.kernel_sk_chirp = 0
        self.kernel_tapers_chirp = 0
        self.kernel_pfb_chirp = 0
        self.kernel_sk_mixed_streams = 0
        self.kernel_tapers_mixed_streams = 0
        self.kernel_pfb_mixed_streams = 0
        self.kernel_sk_chirp_streams = 0
        self.kernel_tapers_chirp_streams = 0
        self.kernel_pfb_chirp_streams = 0
        self.kernel_sk_chirp_large = 0
        self.kernel_tapers_chirp_large = 0
        self.kernel_pfb_chirp_large = 0
        self.kernel_sk_chirp_large_streams = 0
        self.kernel_tapers_chirp_large_streams = 0
        self.kernel_pfb_chirp_large_streams = 0
        self.kernel_sk_large = 0
        self.kernel_tapers_large = 0
        self.kernel_pfb_large = 0
        self.kernel_sk_large_streams = 0
        self.kernel_tapers_large_streams = 0
        self.kernel_pfb_large_streams = 0
        self.kernel_pfb_large_control = 0
        self.kernel_pfb_large_streams_control = 0
        self.kernel_pfb_chirp_large_control = 0
        self.kernel_pfb_chirp_large_streams_control = 0
        self.kernel_sk_mixed_large = 0
        self.kernel_tapers_mixed_large = 0
        self.kernel_pfb_mixed_large = 0
        self.kernel_sk_mixed_large_streams = 0
        self.kernel_tapers_mixed_large_streams = 0
        self.kernel_pfb_mixed_large_streams = 0
        self.plain = 0
        self.plain_frames = 0
        self.plain_pfb_channelize = 0
        self.plain_csd = 0
        self.plain_scf = 0


COUNTS = LaunchCounts()


def fused_psd_eligible(N: int) -> bool:
    """True iff the kernel takes N bins."""
    return MIN_N <= N <= MAX_N and (N & (N - 1)) == 0


def stage_twiddles(N: int) -> np.ndarray:
    """Per-stage twiddle table, (N - 1, 2) float32 (re, im).

    The radix-2 stage of half-span m (m = 1, 2, 4, ..., N/2) reads
    W_{2m}^k = exp(-2*pi*i*k / (2m)), k < m, at rows m - 1 .. 2m - 2.
    Computed in float64 and rounded once to float32."""
    parts = []
    m = 1
    while m < N:
        ang = -np.pi * np.arange(m, dtype=np.float64) / m
        parts.append(np.stack([np.cos(ang), np.sin(ang)], axis=-1))
        m *= 2
    return np.concatenate(parts).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_twiddles(N: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(stage_twiddles(N)).to(device)


def pass_twiddles(N: int) -> np.ndarray:
    """The register transform's twiddles between passes, (rows, 2)
    float32 (re, im): for each pass j but the last, of radix R_j over
    blocks of span L_j (L_0 = N, L_{j+1} = L_j / R_j) and stride
    S_j = L_j / R_j, the L_j values W_{L_j}^(n2 k1) at row
    offset_j + k1 S_j + n2 (k1 < R_j, n2 < S_j; offset_j the spans before
    it). Computed in float64 and rounded once to float32."""
    parts = []
    L = N
    for r in PASS_PLAN[N][:-1]:
        S = L // r
        kn = np.arange(r)[:, None] * np.arange(S)[None, :] % L
        ang = -2.0 * np.pi * kn.astype(np.float64) / L
        parts.append(np.stack([np.cos(ang), np.sin(ang)], -1).reshape(L, 2))
        L = S
    return np.concatenate(parts).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_pass_twiddles(N: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(pass_twiddles(N)).to(device)


def frames_per_block(F: int, chunk: int) -> int:
    """Frames one block of the radix-2 kernel (K3's and the probes' grid)
    sums: ``chunk`` (the two-stage sum's first stage), halved while that
    leaves fewer than the target block count."""
    group = chunk
    while group > 1 and F // group < _TARGET_BLOCKS:
        group //= 2
    return group


def k1_group(F: int, chunk: int, resident: int) -> int:
    """Frames one block of the group kernel (K1, K2, K4) sums over F
    frames: the least divisor of ``chunk`` (the two-stage sum's first
    stage) for which the ceil(F / group) blocks fit ``resident``, the
    blocks the card holds at once (:func:`resident_blocks`), so that the
    grid runs in one wave; ``chunk`` itself where none does. A divisor of
    chunk divides F too, so for K4 (F all S*F frames) no block crosses a
    stream."""
    for group in range(-(-F // resident), chunk):
        if chunk % group == 0:
            return group
    return chunk


@functools.lru_cache(maxsize=64)
def resident_blocks(N: int, windowed: bool, index: int) -> int:
    """Blocks of the group kernel at N bins (windowed: K2's instantiation)
    that card ``index`` holds resident: its SMs times the blocks one SM
    holds, as cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them
    (:func:`kernel_attributes`). Asked of the card once per key."""
    return library_resident_blocks("fused_psd", N, int(windowed),
                                   index=index)


def resident_of(attrs: dict, index) -> int:
    """Blocks of a kernel with ``attrs`` (a ``kernel_attributes`` dict)
    that card ``index`` holds resident: its SMs times the blocks one SM
    holds."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * max(1, attrs["blocks_per_sm"])


@functools.lru_cache(maxsize=256)
def library_resident_blocks(library: str, N: int, *args, index: int,
                            entry: Optional[str] = None) -> int:
    """:func:`resident_of` the register kernel of ``library`` that
    :func:`library_attributes` describes at N bins and ``args``. Asked of
    the card once per key."""
    return resident_of(library_attributes(
        library, N, *args, device=torch.device("cuda", index), entry=entry),
        index)


class LibraryPlan(NamedTuple):
    """What a call of a register kernel of the library estimators needs
    beyond its arguments: the library, log2 N, the grid's frames a block
    (:func:`k1_group`) and blocks, and the twiddles' device pointer."""
    lib: ctypes.CDLL
    log2n: int
    group: int
    blocks: int
    twiddle: int


@functools.lru_cache(maxsize=256)
def library_plan(library: str, N: int, F: int, chunk: int, index: int,
                 *args, entry: Optional[str] = None) -> LibraryPlan:
    """The :class:`LibraryPlan` of ``library``'s register kernel over F
    frames of N bins, ``chunk`` the two-stage sum's first stage, on card
    ``index``; ``args`` and ``entry`` pick the instantiation as
    :func:`library_attributes` does. Made once per key."""
    from . import _build
    group = k1_group(F, chunk, library_resident_blocks(
        library, N, *args, index=index, entry=entry))
    return LibraryPlan(
        _build.load(library), N.bit_length() - 1, group, -(-F // group),
        _device_pass_twiddles(N, torch.device("cuda", index)).data_ptr())


def frame_spectra(raw_u8: torch.Tensor,
                  window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DFT of every frame: (..., 2N) uint8 -> (..., N) complex64, the u8 -
    127 convention with the optional float32 window."""
    N = raw_u8.shape[-1] // 2
    v = raw_u8.reshape(*raw_u8.shape[:-1], N, 2).to(torch.int32)
    re = (v[..., 0] - 127).to(torch.float32)
    im = (v[..., 1] - 127).to(torch.float32)
    if window is not None:
        re = re * window
        im = im * window
    return torch.fft.fft(torch.complex(re, im), dim=-1)


def dft_power(z: torch.Tensor) -> torch.Tensor:
    """|DFT|^2 along the last axis: (..., N) complex64 -> (..., N)
    float32."""
    X = torch.fft.fft(z, dim=-1)
    return X.real * X.real + X.imag * X.imag


def _frame_power(raw_u8: torch.Tensor,
                 window: Optional[torch.Tensor]) -> torch.Tensor:
    """|DFT|^2 of every frame: (..., 2N) uint8 -> (..., N) float32."""
    X = frame_spectra(raw_u8, window)
    return X.real * X.real + X.imag * X.imag


def fused_psd_reference(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                        window: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The plain PyTorch version: (F, 2N) uint8 -> (N,) float32."""
    F, two_n = raw_u8.shape
    N = two_n // 2
    pwr = _frame_power(raw_u8, window)
    pwr[n_valid:] = 0.0
    return pwr.reshape(F // chunk, chunk, N).sum(dim=1).sum(dim=0)


def fused_psd_streams_reference(raw_u8: torch.Tensor, n_valid: torch.Tensor,
                                chunk: int,
                                window: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """The plain PyTorch version of K4: (S, F, 2N) uint8 frames, (S,)
    valid counts -> (S, N) float32, each stream's frames f >= n_valid[s]
    dropped (a count outside [0, F] acts as its nearest bound, as in the
    kernel)."""
    S, F, two_n = raw_u8.shape
    N = two_n // 2
    pwr = _frame_power(raw_u8, window)
    keep = (torch.arange(F, device=raw_u8.device)[None, :]
            < n_valid.to(raw_u8.device)[:, None])
    pwr = torch.where(keep[..., None], pwr, 0.0)
    return pwr.reshape(S, F // chunk, chunk, N).sum(dim=2).sum(dim=1)


def per_stream_reference(single, raw_u8: torch.Tensor, n_valid: torch.Tensor,
                         chunk: int, window: Optional[torch.Tensor]
                         ) -> torch.Tensor:
    """A streams entry's plain version from its one-stream plain version
    ``single``: (S, F, 2N) uint8 frames, (S,) valid counts -> (S, N)
    float32, row s ``single`` on stream s's frames and count (a count
    outside [0, F] acts as its nearest bound, as in the kernels)."""
    counts = n_valid.cpu().clamp(0, raw_u8.shape[1]).tolist()
    return torch.stack([single(raw_u8[s], c, chunk, window)
                        for s, c in enumerate(counts)])


def check_args(kernel: str, eligible, raw_u8: torch.Tensor, n_valid: int,
               chunk: int, window: Optional[torch.Tensor]) -> None:
    """Raise on arguments ``kernel``'s wrapper does not take: frames that
    are not a contiguous (F, 2N) uint8 tensor with ``eligible(N)``, a
    ``chunk`` that does not divide F, ``n_valid`` outside [0, F], or a
    window that is not None or an (N,) contiguous float32 tensor on the
    frames' device."""
    if not isinstance(raw_u8, torch.Tensor) or raw_u8.dtype != torch.uint8:
        raise TypeError(f"{kernel} takes a uint8 tensor of raw IQ frames")
    if raw_u8.dim() != 2 or raw_u8.shape[0] < 1 or raw_u8.shape[1] % 2:
        raise ValueError(f"raw frames must be (F, 2N), got "
                         f"{tuple(raw_u8.shape)}")
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    if not eligible(N):
        raise ValueError(f"{kernel} does not take N={N}")
    if not raw_u8.is_contiguous():
        raise ValueError("raw frames must be contiguous")
    if chunk < 1 or F % chunk:
        raise ValueError(f"chunk={chunk} must divide F={F}")
    if not 0 <= n_valid <= F:
        raise ValueError(f"n_valid={n_valid} outside [0, {F}]")
    if window is None:
        return
    if (not isinstance(window, torch.Tensor)
            or window.dtype != torch.float32 or window.shape != (N,)
            or not window.is_contiguous()):
        raise ValueError(f"window must be a contiguous ({N},) float32 "
                         "tensor")
    if window.device != raw_u8.device:
        raise ValueError(f"window on {window.device}, frames on "
                         f"{raw_u8.device}")


def check_streams_args(raw_u8: torch.Tensor, n_valid: torch.Tensor,
                       chunk: int, window: Optional[torch.Tensor],
                       kernel: str = "fused_psd_streams",
                       eligible=fused_psd_eligible) -> None:
    """Raise on arguments ``kernel`` (default :func:`fused_psd_streams`)
    does not take: frames that are not a contiguous (S, F, 2N) uint8
    tensor (each stream's (F, 2N) block as :func:`check_args` takes it,
    with ``eligible(N)``), or counts that are not an (S,) contiguous int32
    tensor on the frames' device."""
    if not isinstance(raw_u8, torch.Tensor) or raw_u8.dim() != 3:
        raise ValueError("raw frames must be an (S, F, 2N) tensor")
    S = raw_u8.shape[0]
    if S < 1 or not raw_u8.is_contiguous():
        raise ValueError(f"raw frames must be a contiguous (S, F, 2N) "
                         f"tensor with S >= 1, got {tuple(raw_u8.shape)}")
    check_args(kernel, eligible, raw_u8[0], 0, chunk, window)
    if (not isinstance(n_valid, torch.Tensor)
            or n_valid.dtype != torch.int32 or n_valid.shape != (S,)
            or not n_valid.is_contiguous()):
        raise ValueError(f"n_valid must be a contiguous ({S},) int32 tensor")
    if n_valid.device != raw_u8.device:
        raise ValueError(f"n_valid on {n_valid.device}, frames on "
                         f"{raw_u8.device}")


def check_alignment(kernel: str, raw_u8: torch.Tensor, raw_align: int,
                    window: Optional[torch.Tensor], window_align: int) -> None:
    """Raise unless the pointers meet ``kernel``'s vector loads: frames
    ``raw_align``-byte aligned, the window ``window_align``-byte aligned
    (a misaligned load is a sticky error that breaks the CUDA context)."""
    if raw_u8.data_ptr() % raw_align:
        raise ValueError(f"{kernel}: raw frames must be {raw_align}-byte "
                         "aligned on the device")
    if window is not None and window.data_ptr() % window_align:
        raise ValueError(f"{kernel}: window must be {window_align}-byte "
                         "aligned on the device")


def _on_cuda(kernel: str, raw_u8: torch.Tensor) -> bool:
    """True for frames on a CUDA device, False on the CPU; raise on any
    other device."""
    if raw_u8.device.type in ("cpu", "cuda"):
        return raw_u8.device.type == "cuda"
    raise ValueError(f"{kernel} runs on cuda or cpu tensors, not "
                     f"{raw_u8.device}")


def _launch(kernel: str, raw_u8: torch.Tensor,
            window: Optional[torch.Tensor], rows: int, out_shape,
            call, library: str = "fused_psd",
            raw_align: int = RAW_ALIGN) -> torch.Tensor:
    """The launch of the register kernels (:func:`fused_psd`,
    :func:`fused_psd_streams` and the estimators' of ``library``): check the
    loads' alignment (``raw_align``, :data:`WINDOW_ALIGN`), make the (rows,
    N) partial and the output, and run ``call(lib, raw, twiddle, window,
    partial, out, stream)`` with device pointers (the twiddles
    :func:`pass_twiddles`) and the current stream's handle, on which the
    kernel runs asynchronously. Returns the output."""
    check_alignment(kernel, raw_u8, raw_align, window, WINDOW_ALIGN)
    from . import _build
    lib = _build.load(library)
    N = raw_u8.shape[-1] // 2
    device = raw_u8.device
    partial = torch.empty((rows, N), dtype=torch.float32, device=device)
    out = torch.empty(out_shape, dtype=torch.float32, device=device)
    err = call(lib, raw_u8.data_ptr(),
               _device_pass_twiddles(N, device).data_ptr(),
               None if window is None else window.data_ptr(),
               partial.data_ptr(), out.data_ptr(),
               torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise launch_error(kernel, lib, err)
    return out


def fused_psd(raw_u8: torch.Tensor, n_valid: int, chunk: int,
              window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(F, 2N) uint8 frames, ``n_valid`` real frames -> (N,) float32 sum of
    |DFT|^2 over those frames, on the tensor's device. ``window``: an
    (N,) float32 tensor on the same device (K2), or None (K1).

    A CUDA tensor runs the kernel on the current stream (asynchronously);
    a CPU tensor runs the plain version."""
    n_valid = int(n_valid)
    check_args("fused_psd", fused_psd_eligible, raw_u8, n_valid, chunk,
               window)
    if not _on_cuda("fused_psd", raw_u8):
        COUNTS.plain += 1
        return fused_psd_reference(raw_u8, n_valid, chunk, window)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    index = raw_u8.device.index
    group = k1_group(F, chunk, resident_blocks(N, window is not None, index))
    out = _launch(
        "fused_psd", raw_u8, window, -(-F // group), (N,),
        lambda lib, raw, twiddle, win, partial, out, stream:
        lib.rpf_fused_psd(raw, twiddle, win, partial, out, index,
                          N.bit_length() - 1, F, group, n_valid, stream))
    if window is None:
        COUNTS.kernel += 1
    else:
        COUNTS.kernel_windowed += 1
    return out


def fused_psd_streams(raw_u8: torch.Tensor, n_valid: torch.Tensor,
                      chunk: int, window: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """K4: (S, F, 2N) uint8 frames of S streams, ``n_valid`` (S,) int32
    real frames per stream, on the frames' device -> (S, N) float32, row s
    the sum of |DFT|^2 over stream s's first n_valid[s] frames (a count
    outside [0, F] acts as its nearest bound). ``window``: an (N,) float32
    tensor on the same device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously:
    the kernel reads ``n_valid`` from device memory when it runs); a CPU
    tensor runs the plain version."""
    check_streams_args(raw_u8, n_valid, chunk, window)
    if not _on_cuda("fused_psd_streams", raw_u8):
        COUNTS.plain += 1
        return fused_psd_streams_reference(raw_u8, n_valid, chunk, window)
    S, F, N = raw_u8.shape[0], raw_u8.shape[1], raw_u8.shape[2] // 2
    # Blocks are counted over all S*F frames; a group divides chunk, which
    # divides F, so no block crosses a stream.
    index = raw_u8.device.index
    group = k1_group(S * F, chunk,
                     resident_blocks(N, window is not None, index))
    out = _launch(
        "fused_psd_streams", raw_u8, window, S * (F // group), (S, N),
        lambda lib, raw, twiddle, win, partial, out, stream:
        lib.rpf_fused_psd_streams(raw, twiddle, win, n_valid.data_ptr(),
                                  partial, out, index, N.bit_length() - 1,
                                  S, F, group, stream))
    if window is None:
        COUNTS.kernel_streams += 1
    else:
        COUNTS.kernel_streams_windowed += 1
    return out


def kernel_attributes(N: int, windowed: bool = False,
                      device: Optional[torch.device] = None) -> dict:
    """What the group kernel gets at N bins (windowed: K2's instantiation)
    on the card: registers and spill bytes a thread, static and dynamic
    shared bytes and threads a block, and the blocks that reside on one
    SM. Launches nothing."""
    return library_attributes("fused_psd", N, int(windowed), device=device)


def library_attributes(library: str, N: int, *args,
                       device: Optional[torch.device] = None,
                       entry: Optional[str] = None) -> dict:
    """``kernel_attributes`` of the register kernels of ``library``
    (``fused_psd`` and the estimators'): its ``entry`` (by default
    ``rpf_<library>_attributes``) at log2 N, ``args`` and the device.
    Launches nothing."""
    if not fused_psd_eligible(N):
        raise ValueError(f"{library} does not take N={N}")
    device = device or torch.device("cuda", torch.cuda.current_device())
    from . import _build
    lib = _build.load(library)
    attrs = (ctypes.c_int * 6)()
    err = getattr(lib, entry or f"rpf_{library}_attributes")(
        N.bit_length() - 1, *args, device.index or 0, attrs)
    if err != 0:
        raise launch_error(f"{library} attributes at N={N}", lib, err)
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "dynamic_smem", "threads", "blocks_per_sm"), attrs))
