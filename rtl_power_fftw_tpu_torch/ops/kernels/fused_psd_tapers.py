"""Multitaper step: raw u8 IQ frames -> the summed mean eigenspectrum.

Replaces the device step of ``rtl_power_fftw_tpu/models/multitaper.py``
(``_mt_core``, XLA there) with CUDA C++ kernels written for Hopper
(``csrc/fused_psd_tapers.cu``): each valid frame of an (F, 2N) batch is
tapered by each of the K rows of a (K, N) float32 table, transformed, and
|X|^2 summed over frames and tapers; the total is divided by K in
float32. Bins in natural order.

Both kernels run K1's register transform (``csrc/fused_psd_regs.cuh``,
``fft_regs.cuh``) on K2's block shape. The batch kernel runs every taper
of a block's frames (or of a range of the tapers, where the frames alone
do not fill one wave of blocks, :func:`batch_grid`): each lane stages its
frames C at a time in a shared-memory ring of 2 C raw slots by
``cp.async``, the next batch in flight, holds taper row k in registers
over a batch, and the block writes one partial row, so each frame is read
from device memory once a taper range. It is the route where the card
measured it ahead (:func:`batch_shape`, a rule on (N, K): 3 to 16 tapers,
1024 to 4096 bins, a table of at most 32768 values); elsewhere the route
is the kernel it was redesigned from, K2's kernel with a taper axis on
its grid: block (g, k) under taper k writes partial row k * G + g, so
each frame is read K times, on a grid of K2's resident blocks over K
(:func:`tapers_group`); :func:`fused_psd_tapers_control` runs it at
every size. Their f32 sums run in another order, so they agree to
rounding, not bit for bit.

:func:`fused_psd_tapers_streams` runs S streams of F frames at once (the
``--streams`` step), one output row a stream, each stream's count read
from an (S,) array on the device, the taper table shared: the route's
kernel (by the same :func:`batch_shape`) with S folded into its grid, each
stream's rows summed by ``est_streams_kernel``. The batch kernel's streams
grid is sized on F, not on the counts (:func:`streams_batch_grid`).

:func:`fused_psd_tapers` and :func:`fused_psd_tapers_streams` dispatch on
the tensor's device: a CPU tensor runs the plain PyTorch version
(:func:`fused_psd_tapers_reference`,
:func:`fused_psd_tapers_streams_reference`), a CUDA tensor the kernel, or
raises. ``COUNTS.kernel_tapers`` counts the batch kernel's launches,
``COUNTS.kernel_tapers_control`` the control's, and
``COUNTS.kernel_tapers_streams`` and
``COUNTS.kernel_tapers_streams_control`` their streams launches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import fused_psd as fp

#: Tapers a call takes (``--multitaper`` accepts 1..32).
MAX_TAPERS = 32
#: Frames a lane of the batch kernel stages a batch (C). Of 1, 2, 4 and 8
#: at 2048 bins, K = 7, 2 measured the fastest (probes/estimator_builds.py).
BATCH_FRAMES = 2
#: The route's bounds (batch_shape): tapers, bins and (K, N) table values.
BATCH_TAPERS = range(3, 17)
BATCH_BINS = range(1024, 4097)
BATCH_MAX_TABLE = 32768
#: A lane's ring: 2 C slots of 2N bytes and these 32 more, which put the
#: lanes of one warp (N <= 256) on other banks.
RING_PAD = 32


class BatchShape(NamedTuple):
    """The batch kernel's block at N bins: ``frames`` (C) a lane stages a
    batch, its shared memory (``smem`` bytes) and the blocks one SM holds
    by threads and shared memory (``blocks_per_sm``)."""
    frames: int
    smem: int
    blocks_per_sm: int


def batch_smem(N: int, C: int) -> int:
    """Bytes of shared memory a block of the batch kernel takes at C
    frames a lane a batch: the lanes' exchange buffers and their rings of
    2 C slots."""
    shape = fp.regs_shape(N)
    return shape.exchange + shape.lanes * (4 * C * N + RING_PAD)


def batch_shape(N: int, K: int) -> Optional[BatchShape]:
    """The route's rule at N bins and K tapers: the batch kernel's
    :class:`BatchShape` at :data:`BATCH_FRAMES` frames a batch where K is
    in :data:`BATCH_TAPERS`, N in :data:`BATCH_BINS` and the (K, N) table
    holds at most :data:`BATCH_MAX_TABLE` values; else None (the control).
    These are the (N, K) where the card measured the batch kernel ahead
    of the control at every step it timed (``probes/estimator_builds.py
    batch``, its route sweep: F = 400, 4096 and the CLI's step). With two
    tapers it shares too little; with 32 tapers, large tables or 8192
    bins it fell behind; below 1024 bins, where a block holds 8 to 32
    lanes, it gained or lost with F. Its ring fits every block the rule
    admits."""
    if (K not in BATCH_TAPERS or N not in BATCH_BINS
            or K * N > BATCH_MAX_TABLE):
        return None
    smem = batch_smem(N, BATCH_FRAMES)
    return BatchShape(BATCH_FRAMES, smem,
                      fp.smem_blocks_per_sm(smem, fp.regs_shape(N).threads))


def batch_grid(n_valid: int, K: int, N: int, resident: int
               ) -> Tuple[int, int]:
    """(group, per_block) of the batch kernel over ``n_valid`` frames:
    ``group`` frames a block, the same number for each of its lanes and
    the fewest that put the frames in one wave of the ``resident`` blocks
    the card holds; then the K tapers in ceil(K / per_block) ranges of
    ``per_block``, as many ranges as that wave still has room for (one,
    per_block = K, wherever the frames fill it)."""
    lanes = fp.regs_shape(N).lanes
    group = lanes * max(1, -(-n_valid // (resident * lanes)))
    ranges = min(K, max(1, resident // max(1, -(-n_valid // group))))
    return group, -(-K // ranges)


def streams_batch_grid(S: int, F: int, K: int, N: int, resident: int
                       ) -> Tuple[int, int]:
    """(group, per_block) of the batch kernel's streams form over S
    streams of F frames: :func:`batch_grid`'s rule sized on all S * F frames
    (the counts are on the device, and the grid takes no read of them), with
    G_s = ceil(F / group) blocks a stream, and the taper ranges from the S
    G_s blocks that leaves."""
    lanes = fp.regs_shape(N).lanes
    group = lanes * max(1, -(-S * F // (resident * lanes)))
    ranges = min(K, max(1, resident // (S * -(-F // group))))
    return group, -(-K // ranges)


def tapers_group(F: int, chunk: int, K: int, resident: int) -> int:
    """Frames a block of the control sums: :func:`.fused_psd.k1_group`
    over the blocks the card holds at once for each of the K tapers."""
    return fp.k1_group(F, chunk, max(1, resident // K))


def check_tapers(tapers: torch.Tensor, raw_u8: torch.Tensor) -> None:
    """Raise unless ``tapers`` is a contiguous (K, N) float32 tensor on the
    frames' device, 1 <= K <= :data:`MAX_TAPERS`."""
    N = raw_u8.shape[-1] // 2
    if (not isinstance(tapers, torch.Tensor) or tapers.dtype != torch.float32
            or tapers.dim() != 2 or tapers.shape[1] != N
            or not 1 <= tapers.shape[0] <= MAX_TAPERS
            or not tapers.is_contiguous()):
        raise ValueError(f"tapers must be a contiguous (K, {N}) float32 "
                         f"tensor with 1 <= K <= {MAX_TAPERS}")
    if tapers.device != raw_u8.device:
        raise ValueError(f"tapers on {tapers.device}, frames on "
                         f"{raw_u8.device}")


def fused_psd_tapers_reference(raw_u8: torch.Tensor, n_valid: int,
                               chunk: int, tapers: torch.Tensor,
                               dft_power=fp.dft_power) -> torch.Tensor:
    """The plain PyTorch version, in the JAX package's ``_mt_core`` order:
    the (F * K, N) tapered batch (frame-major), |FFT|^2 (``dft_power``;
    the chirp-Z form passes its own), frames f >= n_valid dropped, the
    chunked sum over its rows, divided by K."""
    F, two_n = raw_u8.shape
    N = two_n // 2
    K = tapers.shape[0]
    v = raw_u8.reshape(F, N, 2).to(torch.int32)
    re = (v[..., 0] - 127).to(torch.float32)
    im = (v[..., 1] - 127).to(torch.float32)
    re_t = (re[:, None, :] * tapers[None]).reshape(F * K, N)
    im_t = (im[:, None, :] * tapers[None]).reshape(F * K, N)
    p = dft_power(torch.complex(re_t, im_t))
    p[n_valid * K:] = 0.0
    total = p.reshape(F * K // chunk, chunk, N).sum(dim=1).sum(dim=0)
    return total / torch.tensor(K, dtype=torch.float32)


def fused_psd_tapers_streams_reference(raw_u8: torch.Tensor,
                                       n_valid: torch.Tensor, chunk: int,
                                       tapers: torch.Tensor,
                                       dft_power=fp.dft_power
                                       ) -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_psd_tapers_streams`: each
    stream as :func:`fused_psd_tapers_reference` takes it (``dft_power``
    too), with its count clamped to [0, F], -> (S, N)."""
    S, F, two_n = raw_u8.shape
    N = two_n // 2
    K = tapers.shape[0]
    counts = n_valid.to(raw_u8.device).clamp(0, F)
    v = raw_u8.reshape(S, F, N, 2).to(torch.int32)
    re = (v[..., 0] - 127).to(torch.float32)
    im = (v[..., 1] - 127).to(torch.float32)
    re_t = (re[:, :, None, :] * tapers[None, None]).reshape(S, F * K, N)
    im_t = (im[:, :, None, :] * tapers[None, None]).reshape(S, F * K, N)
    p = dft_power(torch.complex(re_t, im_t))
    keep = (torch.arange(F * K, device=raw_u8.device)[None, :]
            < counts[:, None] * K)
    p = torch.where(keep[..., None], p, 0.0)
    total = p.reshape(S, F * K // chunk, chunk, N).sum(dim=2).sum(dim=1)
    return total / torch.tensor(K, dtype=torch.float32)


def fused_psd_tapers(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                     tapers: torch.Tensor,
                     grid: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(F, 2N) uint8 frames, ``n_valid`` real frames, (K, N) float32
    ``tapers`` on the same device -> (N,) float32: the sum over those
    frames of the mean over the K tapers of |DFT(x * taper_k)|^2.

    A CUDA tensor runs the kernel :func:`batch_shape` picks on the current
    stream (asynchronously), the batch kernel on ``grid`` (group,
    per_block) where given (a streams call's, for a comparison on its
    grid), else on :func:`batch_grid`'s; a CPU tensor runs the plain
    version."""
    return _tapers("fused_psd_tapers", raw_u8, n_valid, chunk, tapers,
                   False, grid)


def fused_psd_tapers_control(raw_u8: torch.Tensor, n_valid: int,
                             chunk: int, tapers: torch.Tensor,
                             group: Optional[int] = None) -> torch.Tensor:
    """:func:`fused_psd_tapers` on the kernel the batch kernel was
    redesigned from (the taper axis on its grid) at every N, on ``group``
    frames a block where given (a streams call's, for a comparison on its
    grid), else on :func:`tapers_group`'s; a CPU tensor runs the plain
    version."""
    return _tapers("fused_psd_tapers_control", raw_u8, n_valid, chunk,
                   tapers, True, None if group is None else (group, 1))


def _tapers(kernel: str, raw_u8: torch.Tensor, n_valid: int, chunk: int,
            tapers: torch.Tensor, control: bool,
            grid: Optional[Tuple[int, int]]) -> torch.Tensor:
    """Check, then run the plain version (CPU), or on the card the control
    (``control``) or else the kernel :func:`batch_shape` picks."""
    n_valid = int(n_valid)
    fp.check_args(kernel, fp.fused_psd_eligible, raw_u8, n_valid, chunk,
                  None)
    check_tapers(tapers, raw_u8)
    if grid is not None:
        check_grid(*grid, tapers.shape[0], raw_u8.shape[0])
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return fused_psd_tapers_reference(raw_u8, n_valid, chunk, tapers)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    K = tapers.shape[0]
    index = raw_u8.device.index
    shape = None if control else batch_shape(N, K)
    if shape is None:
        group = grid[0] if grid else tapers_group(
            F, chunk, K, fp.resident_blocks(N, True, index))
        per_block, rows = 1, K * -(-F // group)
    else:
        group, per_block = grid or batch_grid(
            n_valid, K, N, batch_resident_blocks(N, index))
        rows = -(-K // per_block) * max(1, -(-n_valid // group))
    out = fp._launch(
        kernel, raw_u8, tapers, rows, (N,),
        lambda lib, raw, twiddle, tp, partial, out, stream:
        lib.rpf_fused_psd_tapers(raw, twiddle, tp, partial, out, index,
                                 N.bit_length() - 1, F, group, K, n_valid,
                                 0 if shape is None else shape.frames,
                                 per_block, stream),
        library="fused_psd_tapers")
    if shape is None:
        fp.COUNTS.kernel_tapers_control += 1
    else:
        fp.COUNTS.kernel_tapers += 1
    return out


def check_grid(group: int, per_block: int, K: int, F: int) -> None:
    """Raise unless ``group`` (frames a block) is in [1, F] and
    ``per_block`` (tapers a block) in [1, K]."""
    if not (1 <= group <= F and 1 <= per_block <= K):
        raise ValueError(f"grid ({group}, {per_block}) outside [1, {F}] x "
                         f"[1, {K}]")


def fused_psd_tapers_streams(raw_u8: torch.Tensor, n_valid: torch.Tensor,
                             chunk: int, tapers: torch.Tensor
                             ) -> torch.Tensor:
    """(S, F, 2N) uint8 frames of S streams, ``n_valid`` (S,) int32 real
    frames per stream, (K, N) float32 ``tapers``, all on one device -> (S,
    N) float32: row s the sum over stream s's first n_valid[s] frames of
    the mean over the K tapers of |DFT(x * taper_k)|^2 (a count outside
    [0, F] acts as its nearest bound).

    A CUDA tensor runs the kernel :func:`batch_shape` picks on the current
    stream (asynchronously: the kernels read ``n_valid`` from device memory
    when they run), the batch kernel on :func:`streams_batch_grid`'s grid;
    a CPU tensor runs the plain version."""
    return _tapers_streams("fused_psd_tapers_streams", raw_u8, n_valid,
                           chunk, tapers, False)


def fused_psd_tapers_streams_control(raw_u8: torch.Tensor,
                                     n_valid: torch.Tensor, chunk: int,
                                     tapers: torch.Tensor) -> torch.Tensor:
    """:func:`fused_psd_tapers_streams` on the control (the taper axis on
    the grid) at every N."""
    return _tapers_streams("fused_psd_tapers_streams_control", raw_u8,
                           n_valid, chunk, tapers, True)


def _tapers_streams(kernel: str, raw_u8: torch.Tensor,
                    n_valid: torch.Tensor, chunk: int, tapers: torch.Tensor,
                    control: bool) -> torch.Tensor:
    fp.check_streams_args(raw_u8, n_valid, chunk, None, kernel)
    check_tapers(tapers, raw_u8)
    if not fp._on_cuda(kernel, raw_u8):
        fp.COUNTS.plain += 1
        return fused_psd_tapers_streams_reference(raw_u8, n_valid, chunk,
                                                  tapers)
    S, F, N = raw_u8.shape[0], raw_u8.shape[1], raw_u8.shape[2] // 2
    K = tapers.shape[0]
    index = raw_u8.device.index
    shape = None if control else batch_shape(N, K)
    if shape is None:
        group = tapers_group(S * F, chunk, K,
                             fp.resident_blocks(N, True, index))
        per_block, planes = 1, K
    else:
        group, per_block = streams_batch_grid(
            S, F, K, N, batch_resident_blocks(N, index))
        planes = -(-K // per_block)
    out = fp._launch(
        kernel, raw_u8, tapers, planes * S * -(-F // group), (S, N),
        lambda lib, raw, twiddle, tp, partial, out, stream:
        lib.rpf_fused_psd_tapers_streams(
            raw, twiddle, tp, n_valid.data_ptr(), partial, out, index,
            N.bit_length() - 1, S, F, group, K,
            0 if shape is None else shape.frames, per_block, stream),
        library="fused_psd_tapers")
    if shape is None:
        fp.COUNTS.kernel_tapers_streams_control += 1
    else:
        fp.COUNTS.kernel_tapers_streams += 1
    return out


def kernel_attributes(N: int, batch: bool,
                      device: Optional[torch.device] = None) -> dict:
    """What a first pass gets at N bins on the card, as
    :func:`.fused_psd.kernel_attributes` gives K2's: the batch kernel's
    (``batch``) at :data:`BATCH_FRAMES` frames a batch, or the control's.
    Launches nothing."""
    return fp.library_attributes("fused_psd_tapers", N,
                                 BATCH_FRAMES if batch else 0, device=device)


@functools.lru_cache(maxsize=64)
def batch_resident_blocks(N: int, index: int) -> int:
    """Blocks of the batch kernel at N bins that card ``index`` holds
    resident: its SMs times :func:`kernel_attributes`' blocks per SM,
    asked of the card once per key."""
    device = torch.device("cuda", index)
    per_sm = kernel_attributes(N, True, device)["blocks_per_sm"]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * max(1, per_sm)
