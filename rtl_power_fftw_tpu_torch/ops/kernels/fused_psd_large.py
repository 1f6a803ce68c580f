"""Large-N fused PSD step: raw u8 IQ frames -> (N,) f32 partial power sum,
for powers of two from 32768 to 2^22.

Replaces ``rtl_power_fftw_tpu/ops/kernels/fused_psd.py:make_fused_psd_fn``
at default precision from 32768 to 65536, unwindowed (K1) and windowed
(K2), where the port's ``fused_psd`` stops (its whole frame lives in
shared memory), and ``probes/big_kernel.py``'s 1M-point kernel (P15,
BASELINE config 3), with a CUDA C++ kernel written for Hopper
(``csrc/fused_psd_large.cu``). It computes what :func:`fused_psd
<.fused_psd.fused_psd>` computes, as a four-step FFT over device memory:
N = N1·N2 (:func:`large_split`), sample n = n1·N2 + n2, bin k = k1 + N1·k2:

1. dequantize (u8 - 127) [× window in float32];
2. length-N1 DFTs over n1 of each column n2;
3. × the inter-stage twiddle W_N^(n2·k1), the float32 rounding of a
   product of two float64 table entries (:func:`inter_tables`);
4. length-N2 DFTs over n2 of each row k1;
5. |X|^2, frames f >= ``n_valid`` dropped, sum over frames in two stages.

What bounds the kernel on an H100, and what its design does about it, is
stated at the top of the CUDA source: the complex scratch between its two
passes crosses device memory twice per frame. Its passes run the column
and row DFTs in registers (``csrc/fft_regs.cuh``, the pass plan
:data:`.fused_psd.PASS_PLAN`, twiddles :func:`.fused_psd.pass_twiddles`),
several transforms a block (:func:`regs_layout`), with the next frame's
tile in flight, each on a grid of its own (:func:`large_group`, from the
blocks the card holds, :func:`resident_blocks`); one partial row is
written as the output, 2..8 are added by a few-rows sum. The radix-2
passes it replaced (:func:`large_tiles`, :func:`frames_per_block`,
:func:`stage_twiddles` tables) stay as the control
(``fused_psd_probe.large_radix2_psd``).

:func:`fused_psd_large` dispatches on the tensor's device: a CPU tensor
goes to the plain PyTorch version (:func:`fused_psd_large_reference`, the
same four steps in torch ops, so their index arithmetic runs on the CPU);
a CUDA tensor goes to the kernel, or raises. ``COUNTS.kernel_large`` and
``COUNTS.kernel_large_windowed`` (in :mod:`.fused_psd`) count its launches.
Its host path does the least it can a call: the grid, the tables and their
pointers are cached per (N, F, chunk, windowed, device), the scratch and
partial rows per (N, F, rows, device, stream), so a call allocates only
its output.

:func:`fused_psd_large_streams` ("L-S") does the same for S streams of F
frames, (S, F, 2N), with an (S,) int32 count array on the device, one
output row per stream: the register passes with S folded into their grids
(``large_streams_a``, ``large_streams_b``; :func:`streams_grid`), each
stream's partial rows added as a one-stream call adds its own, so that
row s is :func:`fused_psd_large`'s output on stream s's frames and count
with the same groups, bit for bit. Its plain version is
:func:`fused_psd_large_streams_reference`; ``COUNTS.kernel_large_streams``
and ``COUNTS.kernel_large_streams_windowed`` count its launches.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .fused_psd import (COUNTS, KernelLaunchError, _on_cuda, check_alignment,
                        check_args, check_streams_args, pass_twiddles,
                        per_stream_reference, stage_twiddles)

#: Eligible sizes: powers of two above fused_psd's 16384, up to the size
#: whose N1 and N2 (2048 each) keep pass A's and pass B's tiles within the
#: 227 KB of shared memory a Hopper block may use. Kept in step with
#: kMinLog2N/kMaxLog2N in the source.
MIN_N = 32768
MAX_N = 1 << 22

#: Blocks a pass of the radix-2 control aims for per launch: about one per
#: SM of the H100's 132 (its pass A holds 131 KB of shared memory at
#: N1 = 1024, one block per SM).
_TARGET_BLOCKS = 128

#: Pass A's layout by N1 (``col_shape`` in the source): B columns
#: transformed at once, C columns a tile, V columns side by side in a
#: half-warp, the exchange's padding (1: ``pad_index``), its float2 slots
#: a column XS and the column's XOR multiplier.
COL_SHAPE = {128: (16, 16, 16, 0, 128, 1), 256: (16, 16, 16, 0, 256, 1),
             512: (8, 16, 1, 1, 544, 2), 1024: (4, 8, 1, 1, 1088, 4),
             2048: (2, 8, 1, 1, 2176, 8)}

#: Pass B's float row stride for its bins in shared memory, by N2
#: (``row_sum_stride`` in the source).
ROW_SUM_STRIDE = {256: 273, 512: 546, 1024: 1092, 2048: 2176}

#: The pass :func:`kernel_attributes` and :func:`resident_blocks` ask of:
#: pass A unwindowed, pass A windowed, pass B.
PASS_A, PASS_A_WINDOWED, PASS_B = 0, 1, 2

#: Alignment of the loads: frames copied 16 bytes a thread, the window
#: read as floats.
RAW_ALIGN = 16
WINDOW_ALIGN = 4


def fused_psd_large_eligible(N: int) -> bool:
    """True iff the kernel takes N bins."""
    return MIN_N <= N <= MAX_N and (N & (N - 1)) == 0


def large_split(N: int) -> Tuple[int, int]:
    """(N1, N2): N1 = 2^floor(log2 N / 2) column length, N2 = N / N1 row
    length (128 x 256 at 32768, 1024 x 1024 at 2^20)."""
    n1 = 1 << ((N.bit_length() - 1) // 2)
    return n1, N // n1


def large_tiles(N: int) -> dict:
    """The radix-2 control's tiles at N (``Large<LOG2N>`` in the source): C columns
    per pass-A block, R rows per pass-B block, and the tile counts."""
    n1, n2 = large_split(N)
    c = 16 if n1 <= 1024 else 8
    r = 8 if n2 <= 1024 else 4
    return {"N1": n1, "N2": n2, "C": c, "R": r, "tiles_a": n2 // c,
            "tiles_b": n1 // r}


def frames_per_block(F: int, chunk: int, N: int) -> int:
    """Frames one block of either pass of the radix-2 control takes:
    ``chunk`` (the two-stage sum's first stage), halved while the pass
    with fewer tiles would get fewer than the target block count."""
    t = large_tiles(N)
    tiles = min(t["tiles_a"], t["tiles_b"])
    group = chunk
    while group > 1 and tiles * (F // group) < _TARGET_BLOCKS:
        group //= 2
    return group


def regs_layout(N: int) -> dict:
    """The register passes' shapes at N (``LargeRegs<LOG2N>`` in the
    source). Pass A: B columns a batch of C a tile, TF1 = N1 / 16 threads
    a column, V columns side by side in a half-warp, the exchange (XS
    float2 slots a column, ``pad``, ``xmul``) and the ring (two slots of N1
    rows of 2C bytes). Pass B: B2 rows of TF2 = N2 / 16 threads, 256
    threads, K1's exchange (XS2 = N2 + N2 / 16 a row) and a ring of the
    frame's N2 / B scratch runs of B2 * B values (:func:`scratch_index`),
    run g at g * GS (B values apart below B = 16), filled by bulk copies
    counted on an mbarrier. Shared memory in bytes."""
    n1, n2 = large_split(N)
    b, c, v, padded, xs, xmul = COL_SHAPE[n1]
    tf1, tf2 = n1 // 16, n2 // 16
    b2 = 256 // tf2
    return {"N1": n1, "N2": n2, "B": b, "C": c, "V": v, "pad": bool(padded),
            "XS": xs, "xmul": xmul, "TF1": tf1, "threads_a": b * tf1,
            "subs": c // b, "tiles_a": n2 // c,
            "smem_a": 8 * b * xs + 2 * n1 * 2 * c,
            "TF2": tf2, "B2": b2, "threads_b": 256, "tiles_b": n1 // b2,
            "XS2": n2 + n2 // 16, "XSR": ROW_SUM_STRIDE[n2],
            "run": b2 * b, "GS": b2 * b + (0 if b == 16 else b),
            "smem_b": 8 * b2 * (n2 + n2 // 16)
            + 8 * (n2 // b) * (b2 * b + (0 if b == 16 else b)) + 8}


def scratch_index(N: int, k1, n2):
    """Where the register passes keep value (k1, n2) of a frame in
    scratch: batch-major, ((n2 / B) * N1 + k1) * B + n2 % B."""
    t = regs_layout(N)
    b = t["B"]
    return ((n2 // b) * t["N1"] + k1) * b + n2 % b


def thread_map(N: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pass A's thread map at N (``col_of``/``row_of`` in the source):
    the batch column and the column-thread of each of its threads. A
    half-warp is V adjacent columns of 16 / V adjacent threads."""
    t = regs_layout(N)
    v, b = t["V"], t["B"]
    tid = np.arange(t["threads_a"])
    col = tid % v + v * ((tid >> 4) % (b // v))
    row = (tid // v) % (16 // v) + (16 // v) * ((tid >> 4) // (b // v))
    return col, row


def large_group(F: int, tiles: int, resident: int) -> int:
    """Frames a block of a register pass takes over F frames when the pass
    has ``tiles`` tiles a frame and the card holds ``resident`` of its
    blocks at once: the fewest for which tiles * ceil(F / group) blocks fit
    (one wave), or all F where even one frame a block does not fit. Pass
    A sums nothing, so any group will do; pass B's group sets its partial
    rows, ceil(F / group)."""
    return -(-F // max(1, resident // tiles))


def regs_grid(F: int, N: int, resident_a: int, resident_b: int
              ) -> Tuple[int, int, int]:
    """(frames a pass-A block, frames a pass-B block, partial rows) over F
    frames at N, from the blocks of each pass the card holds at once."""
    t = regs_layout(N)
    group_a = large_group(F, t["tiles_a"], resident_a)
    group_b = large_group(F, t["tiles_b"], resident_b)
    return group_a, group_b, -(-F // group_b)


def streams_grid(S: int, F: int, N: int, resident_a: int, resident_b: int
                 ) -> Tuple[int, int, int]:
    """(frames a pass-A block, frames a pass-B block, partial rows a
    stream) over S streams of F frames at N: :func:`large_group` with the
    S streams' tiles, so that the grid of either pass stays within the
    blocks the card holds at once; a block takes frames of one stream
    only, the last of a stream's groups the shorter."""
    t = regs_layout(N)
    group_a = large_group(F, S * t["tiles_a"], resident_a)
    group_b = large_group(F, S * t["tiles_b"], resident_b)
    return group_a, group_b, -(-F // group_b)


def kernel_attributes(N: int, which: int,
                      device: Optional[torch.device] = None) -> dict:
    """What a register pass gets at N bins on the card (``which``:
    :data:`PASS_A`, :data:`PASS_A_WINDOWED` or :data:`PASS_B`): registers
    and spill bytes a thread, static and dynamic shared bytes and threads
    a block, and the blocks that reside on one SM. Launches nothing."""
    if not fused_psd_large_eligible(N):
        raise ValueError(f"fused_psd_large does not take N={N}")
    device = device or torch.device("cuda", torch.cuda.current_device())
    from . import _build
    lib = _build.load("fused_psd_large")
    attrs = (ctypes.c_int * 6)()
    err = lib.rpf_fused_psd_large_attributes(N.bit_length() - 1, which,
                                             device.index or 0, attrs)
    if err != 0:
        raise KernelLaunchError(
            f"fused_psd_large attributes at N={N}: "
            f"{lib.rpf_cuda_error_string(err).decode()} (cudaError {err})")
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "dynamic_smem", "threads", "blocks_per_sm"), attrs))


@functools.lru_cache(maxsize=64)
def resident_blocks(N: int, which: int, index: int) -> int:
    """Blocks of a register pass at N bins that card ``index`` holds at
    once: its SMs times the blocks one SM holds, as
    cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them
    (:func:`kernel_attributes`). Asked of the card once per key."""
    device = torch.device("cuda", index)
    per_sm = kernel_attributes(N, which, device)["blocks_per_sm"]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * max(1, per_sm)


def inter_tables(N: int) -> np.ndarray:
    """The inter-stage twiddle tables, (N2 + N1, 2) float64 (re, im):
    W_N^l for l < N2, then W_N^(N2·h) for h < N1, so that W_N^m =
    row[m mod N2] · row[N2 + m // N2] for any m < N."""
    n1, n2 = large_split(N)
    ang = np.concatenate([np.arange(n2, dtype=np.float64),
                          n2 * np.arange(n1, dtype=np.float64)])
    ang *= -2.0 * np.pi / N
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1)


def inter_twiddle(N: int) -> np.ndarray:
    """(N1, N2) complex64: W_N^(k1·n2), the float64 product of the two
    table entries rounded once to float32: the table the register passes
    read, and the value the radix-2 control forms on the device."""
    n1, n2 = large_split(N)
    tab = inter_tables(N)
    tab = tab[:, 0] + 1j * tab[:, 1]
    m = np.arange(n1)[:, None] * np.arange(n2)[None, :]
    return (tab[m % n2] * tab[n2 + m // n2]).astype(np.complex64)


def regs_inter_twiddle(N: int) -> np.ndarray:
    """(N,) complex64: :func:`inter_twiddle` in the register passes'
    scratch order (:func:`scratch_index`), the table pass A reads."""
    n1, n2 = large_split(N)
    out = np.empty(N, np.complex64)
    out[scratch_index(N, np.arange(n1)[:, None],
                      np.arange(n2)[None, :])] = inter_twiddle(N)
    return out


@functools.lru_cache(maxsize=4)
def _plain_twiddle(N: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(inter_twiddle(N)).to(device)


@functools.lru_cache(maxsize=8)
def _device_tables(N: int, device: torch.device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The radix-2 control's tables on ``device``: the per-stage twiddles
    of N1 then N2 (float32) and the inter-stage tables (float64)."""
    n1, n2 = large_split(N)
    stages = np.concatenate([stage_twiddles(n1), stage_twiddles(n2)])
    return (torch.from_numpy(stages).to(device),
            torch.from_numpy(inter_tables(N)).to(device))


def large_dft_power(z: torch.Tensor) -> torch.Tensor:
    """|DFT|^2 along the last axis by the four steps in torch ops, with
    the kernel's inter-stage twiddle: (..., N) complex64 -> (..., N)
    float32 (column DFTs over n1, × W_N^(n2 k1), row DFTs over n2, |.|^2,
    bin k1 + N1·k2)."""
    lead, N = z.shape[:-1], z.shape[-1]
    n1, n2 = large_split(N)
    x = z.reshape(-1, n1, n2)                           # [f, n1, n2]
    y = torch.fft.fft(x, dim=1)                         # [f, k1, n2]
    y = y * _plain_twiddle(N, z.device)
    X = torch.fft.fft(y, dim=2)                         # [f, k1, k2]
    pwr = X.real * X.real + X.imag * X.imag
    # Bin k1 + N1·k2: read [f, k2, k1] flat.
    return pwr.transpose(1, 2).reshape(*lead, N)


def large_power(raw_u8: torch.Tensor,
                window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """|DFT|^2 of every frame by :func:`large_dft_power`: (..., 2N) uint8,
    dequantized [and windowed] -> (..., N) float32."""
    N = raw_u8.shape[-1] // 2
    v = raw_u8.reshape(*raw_u8.shape[:-1], N, 2).to(torch.int32)
    re = (v[..., 0] - 127).to(torch.float32)
    im = (v[..., 1] - 127).to(torch.float32)
    if window is not None:
        re = re * window
        im = im * window
    return large_dft_power(torch.complex(re, im))


def fused_psd_large_reference(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                              window: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The plain PyTorch version: (F, 2N) uint8 -> (N,) float32, the four
    steps written out in torch ops (:func:`large_power`), frames f >=
    n_valid dropped, a two-stage sum."""
    F, two_n = raw_u8.shape
    N = two_n // 2
    pwr = large_power(raw_u8, window)
    pwr[n_valid:] = 0.0
    return pwr.reshape(F // chunk, chunk, N).sum(dim=1).sum(dim=0)


def fused_psd_large_streams_reference(raw_u8: torch.Tensor,
                                      n_valid: torch.Tensor, chunk: int,
                                      window: Optional[torch.Tensor] = None
                                      ) -> torch.Tensor:
    """The plain PyTorch version of L-S: (S, F, 2N) uint8 frames, (S,)
    valid counts -> (S, N) float32, row s :func:`fused_psd_large_reference`
    of stream s's frames and count."""
    return per_stream_reference(fused_psd_large_reference, raw_u8, n_valid,
                                chunk, window)


class _Plan(NamedTuple):
    """What a call of :func:`fused_psd_large` needs beyond its arguments,
    cached per (N, F, chunk, windowed, device): the library, the grid
    (:func:`regs_grid`) and the tables (kept alive here) with their
    pointers."""
    lib: ctypes.CDLL
    log2n: int
    group_a: int
    group_b: int
    twiddle: int
    inter: int
    tables: Tuple[torch.Tensor, torch.Tensor]


_plans: dict = {}
#: Scratch and partial rows by (N, F, rows, device, stream), the newest
#: few: the kernel is stream-ordered, so a later call on the same stream
#: may reuse them, and a dropped buffer goes back to the allocator on the
#: stream it was made on.
_workspaces: collections.OrderedDict = collections.OrderedDict()
_WORKSPACES = 4
#: The bytes the cached buffers may hold together beyond the newest one
#: (a streams call's scratch is S times a frame batch's: 4 GiB at 16
#: streams of 8 frames of 2^22 bins).
WORKSPACE_BYTES = 1 << 30


def keep_newest(cache: collections.OrderedDict) -> None:
    """Drop a workspace cache's oldest buffers until it holds at most
    :data:`_WORKSPACES` of them and, beyond the newest, at most
    :data:`WORKSPACE_BYTES` in all."""
    def nbytes():
        return sum(b.numel() * b.element_size() for b in cache.values())
    while len(cache) > _WORKSPACES or (len(cache) > 1
                                       and nbytes() > WORKSPACE_BYTES):
        cache.popitem(last=False)


@functools.lru_cache(maxsize=16)
def device_tables(N: int, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The register passes' tables on ``device``: pass_twiddles(N1) then
    pass_twiddles(N2), and the inter-stage twiddle in scratch's order
    (:func:`regs_inter_twiddle`); the large kernel and the estimators'
    forms of its passes (:mod:`.fused_psd_large_est`) read the same."""
    n1, n2 = large_split(N)
    return (torch.from_numpy(np.concatenate(
        [pass_twiddles(n1), pass_twiddles(n2)])).to(device),
            torch.from_numpy(regs_inter_twiddle(N)).to(device))


def _plan(N: int, F: int, chunk: int, windowed: bool,
          device: torch.device) -> _Plan:
    key = (N, F, chunk, windowed, device.index)
    plan = _plans.get(key)
    if plan is None:
        from . import _build
        tables = device_tables(N, device)
        plan = _plans[key] = _Plan(
            _build.load("fused_psd_large"), N.bit_length() - 1,
            *regs_grid(F, N,
                       resident_blocks(N, PASS_A_WINDOWED if windowed
                                       else PASS_A, device.index),
                       resident_blocks(N, PASS_B, device.index))[:2],
            tables[0].data_ptr(), tables[1].data_ptr(), tables)
    return plan


def _raw_stream(index: int) -> int:
    """The current stream's handle on device ``index``, without building
    a ``torch.cuda.Stream``."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is not None:
        return get(index)
    return torch.cuda.current_stream(index).cuda_stream


def _workspace(N: int, F: int, rows: int, device: torch.device,
               stream: int) -> Tuple[int, int]:
    """Pointers to the (F, N, 2) scratch and, for rows > 1, the (rows, N)
    partial rows (else 0), both float32, in one buffer."""
    key = (N, F, rows, device.index, stream)
    buf = _workspaces.get(key)
    if buf is None:
        buf = torch.empty(F * N * 2 + (rows * N if rows > 1 else 0),
                          dtype=torch.float32, device=device)
        _workspaces[key] = buf
        keep_newest(_workspaces)
    else:
        _workspaces.move_to_end(key)
    ptr = buf.data_ptr()
    return ptr, (ptr + F * N * 8 if rows > 1 else 0)


def fused_psd_large(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                    window: Optional[torch.Tensor] = None,
                    group_b: Optional[int] = None) -> torch.Tensor:
    """(F, 2N) uint8 frames, 32768 <= N <= 2^22, ``n_valid`` real frames ->
    (N,) float32 sum of |DFT|^2 over those frames, on the tensor's device.
    ``window``: an (N,) float32 tensor on the same device (K2), or None.
    ``group_b``: frames a pass-B block, where not the grid's own (the
    streams entry's, to compare a stream's row with this call's bits).

    A CUDA tensor runs the kernel on the current stream (asynchronously);
    a CPU tensor runs the plain version."""
    n_valid = int(n_valid)
    check_args("fused_psd_large", fused_psd_large_eligible, raw_u8, n_valid,
               chunk, window)
    if not _on_cuda("fused_psd_large", raw_u8):
        COUNTS.plain += 1
        return fused_psd_large_reference(raw_u8, n_valid, chunk, window)
    check_alignment("fused_psd_large", raw_u8, RAW_ALIGN, window,
                    WINDOW_ALIGN)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    device = raw_u8.device
    plan = _plan(N, F, chunk, window is not None, device)
    group_b = plan.group_b if group_b is None else int(group_b)
    stream = _raw_stream(device.index)
    scratch, partial = _workspace(N, F, -(-F // group_b), device, stream)
    out = torch.empty((N,), dtype=torch.float32, device=device)
    err = plan.lib.rpf_fused_psd_large(
        raw_u8.data_ptr(), plan.twiddle, plan.inter,
        None if window is None else window.data_ptr(), scratch, partial,
        out.data_ptr(), device.index, plan.log2n, F, plan.group_a,
        group_b, n_valid, stream)
    if err != 0:
        raise KernelLaunchError(
            f"fused_psd_large launch failed: "
            f"{plan.lib.rpf_cuda_error_string(err).decode()} (cudaError "
            f"{err})")
    if window is None:
        COUNTS.kernel_large += 1
    else:
        COUNTS.kernel_large_windowed += 1
    return out


#: The streams entry's grid by (N, S, F, windowed, device): (group_a,
#: group_b, partial rows a stream).
_streams_grids: dict = {}


def fused_psd_large_streams(raw_u8: torch.Tensor, n_valid: torch.Tensor,
                            chunk: int, window: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """L-S: (S, F, 2N) uint8 frames of S streams, 32768 <= N <= 2^22,
    ``n_valid`` (S,) int32 real frames per stream on the frames' device ->
    (S, N) float32, row s the sum of |DFT|^2 over stream s's first
    n_valid[s] frames (a count outside [0, F] acts as its nearest bound).
    ``window``: an (N,) float32 tensor on the same device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously:
    the kernel reads ``n_valid`` from device memory when it runs); a CPU
    tensor runs the plain version."""
    check_streams_args(raw_u8, n_valid, chunk, window,
                       "fused_psd_large_streams", fused_psd_large_eligible)
    if not _on_cuda("fused_psd_large_streams", raw_u8):
        COUNTS.plain += 1
        return fused_psd_large_streams_reference(raw_u8, n_valid, chunk,
                                                 window)
    check_alignment("fused_psd_large_streams", raw_u8, RAW_ALIGN, window,
                    WINDOW_ALIGN)
    S, F, N = raw_u8.shape[0], raw_u8.shape[1], raw_u8.shape[2] // 2
    device = raw_u8.device
    windowed = window is not None
    plan = _plan(N, F, chunk, windowed, device)
    key = (N, S, F, windowed, device.index)
    grid = _streams_grids.get(key)
    if grid is None:
        grid = _streams_grids[key] = streams_grid(
            S, F, N, resident_blocks(N, PASS_A_WINDOWED if windowed
                                     else PASS_A, device.index),
            resident_blocks(N, PASS_B, device.index))
    group_a, group_b, rows = grid
    stream = _raw_stream(device.index)
    scratch, partial = _workspace(N, S * F, S * rows if rows > 1 else 1,
                                  device, stream)
    out = torch.empty((S, N), dtype=torch.float32, device=device)
    err = plan.lib.rpf_fused_psd_large_streams(
        raw_u8.data_ptr(), plan.twiddle, plan.inter,
        None if window is None else window.data_ptr(), n_valid.data_ptr(),
        scratch, partial, out.data_ptr(), device.index, plan.log2n, S, F,
        group_a, group_b, stream)
    if err != 0:
        raise KernelLaunchError(
            f"fused_psd_large_streams launch failed: "
            f"{plan.lib.rpf_cuda_error_string(err).decode()} (cudaError "
            f"{err})")
    if window is None:
        COUNTS.kernel_large_streams += 1
    else:
        COUNTS.kernel_large_streams_windowed += 1
    return out
