"""Large mixed-radix fused PSD step ("ML"): raw u8 IQ frames -> (N,) f32
partial power sum, at the even 7-smooth bin counts (every prime factor at
most 7) from 16386 to 2^22 that are not powers of two (20000, 49152,
100000, 10^6).

The JAX package computes these N with XLA's FFT through its transform
ladder (the fft4 rung of ``rtl_power_fftw_tpu/ops/spectral.py`` on the
CPU), not with a Pallas kernel; the port computes them with a CUDA C++
kernel written for Hopper (``csrc/fused_psd_mixed_large.cu``). It computes
what :func:`fused_psd_large <.fused_psd_large.fused_psd_large>` computes,
as a four-step FFT over device memory: N = N1·N2
(:func:`mixed_large_split`, both factors 7-smooth), sample n = n1·N2 + n2,
bin k = k1 + N1·k2:

1. dequantize (u8 - 127) [× window in float32];
2. length-N1 DFTs over n1 of each column n2 (pass A: a tile of
   :func:`tile_count` columns a block, the run-time mixed-radix passes of
   ``csrc/fft_mixed.cuh`` by :func:`.fused_psd_mixed.mixed_plan`);
3. × the inter-stage twiddle W_N^(n2·k1), the float32 rounding of a
   product of two float64 table entries (:func:`inter_twiddle`), to a
   complex float32 scratch, (F, N1, N2) row-major;
4. length-N2 DFTs over n2 of each row k1 (pass B, a tile of rows a
   block), |X|^2, frames f >= ``n_valid`` dropped, a sum over each
   block's frames, written to bin k1 + N1·k2 of one partial row a block
   (k2 from the transform's digit-reversed element,
   :func:`.fused_psd_mixed.element_of_bin`), the rows added in float64 by
   ``psd_sum.cuh``.

The kernel (``ml_cols_kernel``, ``ml_rows_kernel``) runs on its own split
(:func:`ml_split`: N2 even, so that a raw row is 4-byte aligned) by
run-time plans without division in its loops (the pass table and division
constants of :class:`.fused_psd_mixed.RingLaunch`), butterflies in
registers, the next frame in flight in both passes and pass B's sums in
registers (:func:`ml_layout`); its scratch is tile-major
(:func:`ml_scratch_index`). The first form, the run-time tile passes of
``csrc/fft_mixed_tile.cuh`` on :func:`mixed_large_split`
(:func:`mixed_large_layout`), stays as the control
(:func:`fused_psd_mixed_large_control`), which only ``chip_smoke.py``
launches. The helpers of the tile layout (:func:`tile_stride`,
:func:`tile_count`, :func:`tile_ints`, :func:`inter_twiddle`) serve the
control of :mod:`.fused_psd_chirp_large` too, whose library shares the
tile passes.

:func:`fused_psd_mixed_large` dispatches on the tensor's device: a CPU
tensor goes to the plain PyTorch version
(:func:`fused_psd_mixed_large_reference`, the same four steps in torch ops
with the same twiddle table); a CUDA tensor goes to the kernel, or raises.
``COUNTS.kernel_mixed_large`` and ``COUNTS.kernel_mixed_large_windowed``
(in :mod:`.fused_psd`) count its launches, the control's
``fused_psd_mixed.CONTROL_COUNTS``. The grid, the tables and their
pointers are cached per (N, F, windowed, device), the scratch and partial
rows per (N, F, rows, device, stream), so a call allocates only its
output.

:func:`fused_psd_mixed_large_streams` ("ML-S") does the same for S
streams of F frames, (S, F, 2N), with an (S,) int32 count array on the
device, one output row per stream: the two passes with S folded into
their grids (``ml_streams_cols``, ``ml_streams_rows``; a block's frames
never cross a stream), each stream's partial rows added as a one-stream
call adds its own, so that row s is :func:`fused_psd_mixed_large`'s
output on stream s's frames and count with the same groups, bit for bit.
Its plain version is :func:`fused_psd_mixed_large_streams_reference`;
``COUNTS.kernel_mixed_large_streams`` and
``COUNTS.kernel_mixed_large_streams_windowed`` count its launches.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .fused_psd import (COUNTS, _on_cuda, check_alignment, check_args,
                        check_streams_args, per_stream_reference, resident_of)
from .fused_psd_large import _raw_stream, keep_newest, large_group
from .fused_psd_mixed import (CONTROL_COUNTS, MAX_N as MIXED_MAX_N,
                              MAX_PASSES, RING_ACC, SUM_BINS, RingLaunch,
                              element_of_bin, launch_error, mixed_plan,
                              pad_index, plan_twiddles, smooth7)

#: Eligible sizes: above the mixed-radix kernel's 16384, up to 2^22.
MIN_N = MIXED_MAX_N + 2
MAX_N = 1 << 22
#: Longest column (pass A's tile) and row (pass B's) of the split.
MAX_N1 = 2048
MAX_N2 = 16384
#: Threads a block of every pass (kTileThreads in the source).
TILE_THREADS = 256
#: Shared bytes a tile aims at, so that two blocks reside on an SM (of the
#: 228 KB an H100 SM has, 1 KB a block reserved), and the most a block may
#: have (kTileMaxSmem).
TILE_SMEM = 113 * 1024
MAX_SMEM = 232448
#: Transforms a tile holds at most.
MAX_COUNT = 16
#: The passes kernel_attributes asks of.
PASS_A, PASS_A_WINDOWED, PASS_B = 0, 1, 2
#: Frames are read as u16 pairs, at 4-byte aligned rows (2N bytes, N even).
RAW_ALIGN = 4
WINDOW_ALIGN = 4


def fused_psd_mixed_large_eligible(N: int) -> bool:
    """True iff the kernel takes N bins: even, 7-smooth, 16386..2^22, not
    a power of two."""
    return (MIN_N <= N <= MAX_N and N % 2 == 0 and (N & (N - 1)) != 0
            and smooth7(N))


def eligible_sizes() -> list:
    """Every N the kernel takes, in order (1192 of them)."""
    out = set()
    for a in range(1, 23):
        for b in range(14):
            for c in range(10):
                for d in range(8):
                    n = (1 << a) * 3 ** b * 5 ** c * 7 ** d
                    if fused_psd_mixed_large_eligible(n):
                        out.add(n)
    return sorted(out)


@functools.lru_cache(maxsize=256)
def mixed_large_split(N: int) -> Tuple[int, int]:
    """(N1, N2): N1 the divisor of N nearest sqrt(N) (the smaller on a
    tie) with N1 <= MAX_N1 and N2 = N / N1 <= MAX_N2, both 7-smooth where
    N is: 125 x 160 at 20000, 192 x 256 at 49152, 250 x 400 at 100000,
    1000 x 1000 at 10^6 (the JAX package's fft4 splits there). Over every
    eligible N, N1 >= 98 and N2 <= 3125."""
    return _nearest_split(N, N)


def _nearest_split(N: int, of: int) -> Tuple[int, int]:
    """(N1, N / N1): N1 the divisor of ``of`` (N or a divisor of it)
    nearest sqrt(N), the smaller on a tie, with N1 <= MAX_N1 and N / N1 <=
    MAX_N2."""
    root = N ** 0.5
    best = None
    for d in range(max(2, -(-N // MAX_N2)), min(MAX_N1, N // 2) + 1):
        if of % d == 0 and (best is None or abs(d - root) < abs(best - root)):
            best = d
    if best is None:
        raise ValueError(f"no split of N={N} within {MAX_N1} x {MAX_N2}")
    return best, N // best


def tile_stride(n: int) -> int:
    """Float2 slots a transform of length n takes in a tile: pad_index(n -
    1) + 1, made odd so that reads by transform fall on different banks."""
    return (pad_index(n - 1) + 1) | 1


def tile_count(n: int, extra: int = 0, buffers: int = 1,
               total: Optional[int] = None) -> int:
    """Transforms of length n a tile holds: the largest power of two up to
    MAX_COUNT (and the next power of two of ``total``, the transforms
    there are) whose ``buffers`` tiles of stride :func:`tile_stride` and
    ``extra`` bytes a transform fit TILE_SMEM; 1 where none does."""
    per = buffers * tile_stride(n) * 8 + extra
    count = MAX_COUNT
    if total is not None:
        count = min(count, 1 << max(0, total - 1).bit_length())
    while count > 1 and count * per > TILE_SMEM:
        count //= 2
    if count * per > MAX_SMEM:
        raise ValueError(f"a transform of {n} points takes {per} bytes of "
                         "shared memory")
    return count


def tile_ints(plan) -> list:
    """The plan as the kernels read it (read_tile_plan): n, the passes,
    their radices (0 past the last)."""
    plan = tuple(plan)
    return ([int(np.prod(plan)), len(plan)] + list(plan)
            + [0] * (MAX_PASSES - len(plan)))


def inter_tables(N: int, n1: int, n2: int) -> np.ndarray:
    """The inter-stage twiddle's two float64 tables, (n2 + n1, 2) (re,
    im): W_N^l for l < n2, then W_N^(n2·h) for h < n1, so that W_N^m =
    row[m mod n2] · row[n2 + m // n2] for any m < N = n1·n2 (as
    :func:`.fused_psd_large.inter_tables`, for any split)."""
    ang = np.concatenate([np.arange(n2, dtype=np.float64),
                          n2 * np.arange(n1, dtype=np.float64)])
    ang *= -2.0 * np.pi / N
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1)


def inter_twiddle(N: int, n1: int, n2: int) -> np.ndarray:
    """(n1, n2) complex64: W_N^(k1·n2), k1 < n1, n2 < n2, the float64
    product of the two table entries rounded once to float32, natural
    order (the table pass A reads, and the chirp-Z kernel's pass B)."""
    tab = inter_tables(N, n1, n2)
    tab = tab[:, 0] + 1j * tab[:, 1]
    m = np.arange(n1)[:, None] * np.arange(n2)[None, :]
    return (tab[m % n2] * tab[n2 + m // n2]).astype(np.complex64)


class MixedLargeLayout(NamedTuple):
    """The kernel's layout at N."""
    N1: int
    N2: int
    plan1: tuple    # N1's mixed-radix plan
    plan2: tuple    # N2's
    cols: int       # columns a pass-A tile
    xs1: int        # a column's stride in the tile
    rows: int       # rows a pass-B tile
    xs2: int        # a row's stride

    @property
    def row(self) -> int:
        """A partial row: N rounded up to SUM_BINS."""
        return -(-self.N1 * self.N2 // SUM_BINS) * SUM_BINS

    @property
    def tiles_a(self) -> int:
        return -(-self.N2 // self.cols)

    @property
    def tiles_b(self) -> int:
        return -(-self.N1 // self.rows)

    @property
    def smem_a(self) -> int:
        return self.cols * self.xs1 * 8

    @property
    def smem_b(self) -> int:
        return self.rows * (self.xs2 * 8 + 4 * self.N2)


@functools.lru_cache(maxsize=64)
def mixed_large_layout(N: int) -> MixedLargeLayout:
    """The kernel's layout at N bins."""
    if not fused_psd_mixed_large_eligible(N):
        raise ValueError(f"fused_psd_mixed_large does not take N={N}")
    n1, n2 = mixed_large_split(N)
    return MixedLargeLayout(
        n1, n2, mixed_plan(n1), mixed_plan(n2),
        tile_count(n1, total=n2), tile_stride(n1),
        tile_count(n2, extra=4 * n2, total=n1), tile_stride(n2))


def fused_psd_mixed_large_reference(raw_u8: torch.Tensor, n_valid: int,
                                    chunk: int,
                                    window: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """The plain PyTorch version: (F, 2N) uint8 -> (N,) float32, the four
    steps written out in torch ops with the kernel's twiddle table."""
    F, two_n = raw_u8.shape
    N = two_n // 2
    pwr = mixed_large_power(raw_u8, window)
    pwr[n_valid:] = 0.0
    return pwr.reshape(F // chunk, chunk, N).sum(dim=1).sum(dim=0)


def mixed_large_dft_power(z: torch.Tensor) -> torch.Tensor:
    """|DFT|^2 along the last axis by the plain version's four steps in
    torch ops (:func:`mixed_large_split`, the kernel's twiddle table):
    (..., N) complex64 -> (..., N) float32 (column DFTs over n1, ×
    W_N^(n2 k1), row DFTs over n2, |.|^2, bin k1 + N1·k2)."""
    lead, N = z.shape[:-1], z.shape[-1]
    n1, n2 = mixed_large_split(N)
    x = z.reshape(-1, n1, n2)                           # [f, n1, n2]
    y = torch.fft.fft(x, dim=1)                         # [f, k1, n2]
    y = y * _plain_twiddle(N, z.device)
    X = torch.fft.fft(y, dim=2)                         # [f, k1, k2]
    pwr = X.real * X.real + X.imag * X.imag
    # Bin k1 + N1·k2: read [f, k2, k1] flat.
    return pwr.transpose(1, 2).reshape(*lead, N)


def mixed_large_power(raw_u8: torch.Tensor,
                      window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """|DFT|^2 of every frame by :func:`mixed_large_dft_power`: (..., 2N)
    uint8, dequantized [and windowed] -> (..., N) float32."""
    N = raw_u8.shape[-1] // 2
    v = raw_u8.reshape(*raw_u8.shape[:-1], N, 2).to(torch.int32)
    re = (v[..., 0] - 127).to(torch.float32)
    im = (v[..., 1] - 127).to(torch.float32)
    if window is not None:
        re = re * window
        im = im * window
    return mixed_large_dft_power(torch.complex(re, im))


@functools.lru_cache(maxsize=4)
def _plain_twiddle(N: int, device: torch.device) -> torch.Tensor:
    n1, n2 = mixed_large_split(N)
    return torch.from_numpy(inter_twiddle(N, n1, n2)).to(device)


def library_attributes(library: str, label: str, call) -> dict:
    """Runs ``call(lib, attrs)`` of one of ``library``'s attributes
    entries (attrs: int[6]) and names what it wrote: registers and spill
    bytes a thread, static and dynamic shared bytes and threads a block,
    and the blocks that reside on one SM. Launches nothing."""
    from . import _build
    lib = _build.load(library)
    attrs = (ctypes.c_int * 6)()
    err = call(lib, attrs)
    if err != 0:
        raise launch_error(f"{library} attributes of {label}", lib, err)
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "dynamic_smem", "threads", "blocks_per_sm"), attrs))


def tile_attributes(library: str, entry: str, which: int, smem: int,
                    device: Optional[torch.device] = None) -> dict:
    """What pass ``which`` of a control's tile passes gets with ``smem``
    dynamic bytes on the card (:func:`library_attributes`)."""
    index = (device or torch.device(
        "cuda", torch.cuda.current_device())).index or 0
    return library_attributes(
        library, f"pass {which}",
        lambda lib, attrs: getattr(lib, entry)(which, smem, index, attrs))


def control_attributes(N: int, which: int,
                       device: Optional[torch.device] = None) -> dict:
    """What a pass of the control at N bins gets on the card (``which``:
    :data:`PASS_A`, :data:`PASS_A_WINDOWED` or :data:`PASS_B`)."""
    t = mixed_large_layout(N)
    return tile_attributes("fused_psd_mixed_large",
                           "rpf_fused_psd_mixed_large_control_attributes",
                           which, t.smem_b if which == PASS_B else t.smem_a,
                           device)


@functools.lru_cache(maxsize=64)
def control_resident_blocks(N: int, which: int, index: int) -> int:
    """Blocks of a pass of the control at N bins that card ``index`` holds
    at once: its SMs times the blocks one SM holds. Asked of the card once
    per key."""
    return resident_of(control_attributes(N, which,
                                        torch.device("cuda", index)), index)


class _ControlPlan(NamedTuple):
    """A control call's launch beyond its arguments, cached per (N, F,
    chunk, windowed, device): the library, the grid, the plans' ints and
    the tables (kept alive here) with their pointers."""
    lib: ctypes.CDLL
    layout: MixedLargeLayout
    group_a: int
    group_b: int
    rows: int                   # partial rows
    ints: Tuple[ctypes.Array, ctypes.Array]
    tables: Tuple[int, ...]     # tw1, order1, inter, tw2, order2
    keep: tuple


_control_plans: dict = {}
#: Scratch and partial rows by (N, F, rows, device, stream), the newest
#: few: the kernel is stream-ordered, so a later call on the same stream
#: may reuse them.
_workspaces: collections.OrderedDict = collections.OrderedDict()


def device_plan_tables(plan, device: torch.device):
    """A plan's twiddles (plan_twiddles) and element_of_bin of each bin
    (int32), on the device."""
    n = int(np.prod(plan))
    return (torch.from_numpy(plan_twiddles(plan)).to(device),
            torch.from_numpy(element_of_bin(plan, np.arange(n))
                             .astype(np.int32)).to(device))


def plan_ints(plan) -> ctypes.Array:
    ints = tile_ints(plan)
    return (ctypes.c_int * len(ints))(*ints)


def _control_plan(N: int, F: int, chunk: int, windowed: bool,
          device: torch.device) -> _Plan:
    key = (N, F, chunk, windowed, device.index)
    plan = _control_plans.get(key)
    if plan is None:
        from . import _build
        t = mixed_large_layout(N)
        keep = (*device_plan_tables(t.plan1, device),
                torch.from_numpy(inter_twiddle(N, t.N1, t.N2)).to(device),
                *device_plan_tables(t.plan2, device))
        group_a = large_group(F, t.tiles_a, control_resident_blocks(
            N, PASS_A_WINDOWED if windowed else PASS_A, device.index))
        group_b = large_group(F, t.tiles_b, control_resident_blocks(
            N, PASS_B, device.index))
        plan = _control_plans[key] = _ControlPlan(
            _build.load("fused_psd_mixed_large"), t, group_a, group_b,
            -(-F // group_b), (plan_ints(t.plan1), plan_ints(t.plan2)),
            tuple(k.data_ptr() for k in keep), keep)
    return plan


def workspace(key: tuple, scratch_floats: int, partial_floats: int,
              device: torch.device) -> Tuple[int, int]:
    """Pointers to a float32 scratch and partial rows in one buffer,
    cached by ``key`` among the newest few (shared by both large awkward-N
    kernels)."""
    buf = _workspaces.get(key)
    if buf is None:
        buf = torch.empty(scratch_floats + partial_floats,
                          dtype=torch.float32, device=device)
        _workspaces[key] = buf
        keep_newest(_workspaces)
    else:
        _workspaces.move_to_end(key)
    ptr = buf.data_ptr()
    return ptr, ptr + 4 * scratch_floats


def fused_psd_mixed_large_control(raw_u8: torch.Tensor, n_valid: int,
                                  chunk: int,
                                  window: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """The first form (the control), as :func:`fused_psd_mixed_large`;
    its launches and plain calls count in ``CONTROL_COUNTS``."""
    n_valid = int(n_valid)
    check_args("fused_psd_mixed_large_control",
               fused_psd_mixed_large_eligible, raw_u8, n_valid, chunk, window)
    if not _on_cuda("fused_psd_mixed_large_control", raw_u8):
        CONTROL_COUNTS.plain += 1
        return fused_psd_mixed_large_reference(raw_u8, n_valid, chunk,
                                               window)
    check_alignment("fused_psd_mixed_large_control", raw_u8, RAW_ALIGN,
                    window, WINDOW_ALIGN)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    device = raw_u8.device
    plan = _control_plan(N, F, chunk, window is not None, device)
    t = plan.layout
    stream = _raw_stream(device.index)
    scratch, partial = workspace(("ML control", N, F, plan.rows, device.index,
                                  stream), 2 * F * N, plan.rows * t.row,
                                 device)
    out = torch.empty((t.row,), dtype=torch.float32, device=device)
    tw1, order1, inter, tw2, order2 = plan.tables
    err = plan.lib.rpf_fused_psd_mixed_large_control(
        raw_u8.data_ptr(), tw1, order1, inter,
        None if window is None else window.data_ptr(), tw2, order2, scratch,
        partial, out.data_ptr(), ctypes.addressof(plan.ints[0]),
        ctypes.addressof(plan.ints[1]), device.index, F, t.cols, t.xs1,
        plan.group_a, t.rows, t.xs2, plan.group_b, n_valid, stream)
    if err != 0:
        raise launch_error("fused_psd_mixed_large_control", plan.lib, err)
    if window is None:
        CONTROL_COUNTS.kernel_mixed_large += 1
    else:
        CONTROL_COUNTS.kernel_mixed_large_windowed += 1
    return out[:N]


# ---- The kernel: the division-free passes of fused_psd_mixed_large.cu. ----

#: Threads a block of pass A; the most of pass B (kColsThreads,
#: kRowsThreads).
COLS_THREADS = 256
ROWS_THREADS = 256
#: Pass A's columns a tile, largest first: the first whose exchange
#: (8 C N1 bytes) and two ring slots (4 C N1) fit TILE_SMEM.
COLS = (16, 8, 4)
#: The passes ml_attributes asks of: pass B with the small and the large
#: class of sums (PASS_A and PASS_A_WINDOWED as the control's).
PASS_B_SMALL, PASS_B_LARGE = 2, 3


@functools.lru_cache(maxsize=256)
def ml_split(N: int) -> Tuple[int, int]:
    """(N1, N2) of the kernel: N1 the divisor of N / 2 nearest sqrt(N) (the
    smaller on a tie) with N1 <= MAX_N1 and N2 = N / N1 <= MAX_N2, so that
    N2 is even and a raw row of N2 samples 4-byte aligned: 125 x 160 at
    20000, 192 x 256 at 49152, 250 x 400 at 100000, 1000 x 1000 at 10^6;
    where N's nearest divisor gives an odd N2 the two swap (147 x 112 at
    16464). Over every eligible N, 49 <= N1 <= 2025 and N2 <= 6250."""
    return _nearest_split(N, N // 2)


def cols_count(n1: int) -> int:
    """Pass A's columns a tile at N1: :data:`COLS`' first whose exchange
    and ring fit TILE_SMEM (two blocks an SM)."""
    for c in COLS:
        if 12 * c * n1 <= TILE_SMEM:
            return c
    raise ValueError(f"no column tile of length {n1}")


def rows_shape(n2: int, plan) -> Tuple[int, int]:
    """Pass B's (tf, lanes) at N2 = n2: lanes, the rows a block, 16 for
    rows of at most 256 points (whose passes have 7-40 butterflies, so that
    16 threads a row idle least) and 8 above, halved until the two slots
    of N2p float2 rows fit TILE_SMEM (N2p: N2 rounded up to pass A's C, at
    most 16 more); tf, the threads a row, ROWS_THREADS / lanes, so that a
    block is 256 threads, doubled (and lanes halved) while a thread would
    hold more than RING_ACC[-1] last-pass sums. On an H100
    (probes/large_awkward_builds.py) 16 rows ran 4-18% faster than 8 at
    N2 = 112 and 160 and slower at 400 (``rows16``)."""
    lanes = 16 if n2 <= 256 else 8
    while lanes > 1 and 16 * lanes * (n2 + 16) > TILE_SMEM:
        lanes //= 2
    tf = ROWS_THREADS // lanes
    while -(-(n2 // plan[-1]) // tf) * plan[-1] > RING_ACC[-1]:
        if lanes == 1:
            raise ValueError(f"no row shape for plan {tuple(plan)}")
        tf, lanes = 2 * tf, lanes // 2
    return tf, lanes


class MlLayout(NamedTuple):
    """The kernel's layout at N."""
    N: int
    N1: int
    N2: int
    plan1: tuple    # N1's mixed-radix plan
    plan2: tuple    # N2's
    cols: int       # pass A's columns a tile, C
    tf: int         # pass B's threads a row
    lanes: int      # pass B's rows a block, a power of two

    @property
    def log2c(self) -> int:
        return self.cols.bit_length() - 1

    @property
    def n2p(self) -> int:
        """N2 rounded up to C: a scratch row, and a row of pass B's slot."""
        return -(-self.N2 // self.cols) * self.cols

    @property
    def row(self) -> int:
        """A partial row: N rounded up to SUM_BINS."""
        return -(-self.N // SUM_BINS) * SUM_BINS

    @property
    def tiles(self) -> Tuple[int, int]:
        """Tiles a frame of pass A (C columns) and pass B (lanes rows)."""
        return self.n2p // self.cols, -(-self.N1 // self.lanes)

    @property
    def threads(self) -> Tuple[int, int]:
        return COLS_THREADS, self.tf * self.lanes

    @property
    def smem(self) -> Tuple[int, int]:
        """Dynamic shared bytes of a block of pass A (the exchange, N1 C
        float2, then two ring slots of N1 rows of 2C bytes) and of pass B
        (two slots of lanes rows of N2p float2)."""
        return (12 * self.cols * self.N1, 16 * self.lanes * self.n2p)

    def launches(self) -> Tuple[RingLaunch, RingLaunch]:
        """The plans as the kernel reads them: N1's with tf = 256 / C and
        lanes = C (column c is thread tid mod C), N2's with tf and lanes."""
        return (RingLaunch(self.N1, self.row, self.plan1,
                           COLS_THREADS // self.cols, self.cols),
                RingLaunch(self.N2, self.row, self.plan2, self.tf,
                           self.lanes))

    @property
    def acc(self) -> int:
        """Pass B's last-pass sums a thread holds."""
        return self.launches()[1].acc

    @property
    def which_b(self) -> int:
        """Pass B's kernel: :data:`PASS_B_SMALL` or :data:`PASS_B_LARGE`."""
        return PASS_B_SMALL if self.acc <= RING_ACC[0] else PASS_B_LARGE


@functools.lru_cache(maxsize=64)
def ml_layout(N: int) -> MlLayout:
    """The kernel's layout at N bins (:func:`ml_split`, :func:`cols_count`,
    :func:`rows_shape`)."""
    if not fused_psd_mixed_large_eligible(N):
        raise ValueError(f"fused_psd_mixed_large does not take N={N}")
    n1, n2 = ml_split(N)
    plan2 = mixed_plan(n2)
    t = MlLayout(N, n1, n2, mixed_plan(n1), plan2, cols_count(n1),
                 *rows_shape(n2, plan2))
    if max(t.smem) > MAX_SMEM:
        raise ValueError(f"N={N} takes {t.smem} bytes of shared memory")
    return t


def ml_scratch_index(N: int, k1, n2):
    """Where the kernel keeps value (k1, n2) of a frame in scratch:
    tile-major, ((n2 / C) N1 + k1) C + n2 mod C, so that pass A's tile is
    one run and pass B's rows of a tile are runs of lanes * C values."""
    t = ml_layout(N)
    c = t.cols
    return ((np.asarray(n2) // c) * t.N1 + np.asarray(k1)) * c + \
        np.asarray(n2) % c


def ml_inter_twiddle(N: int) -> np.ndarray:
    """(N1 N2p,) complex64: W_N^(k1 n2) (:func:`inter_twiddle` of the
    kernel's split) in scratch's tile-major order, 0 at n2 >= N2."""
    t = ml_layout(N)
    out = np.zeros(t.N1 * t.n2p, np.complex64)
    out[ml_scratch_index(N, np.arange(t.N1)[:, None],
                         np.arange(t.N2)[None, :])] = inter_twiddle(
        N, t.N1, t.N2)
    return out


def bin_of_element(plan) -> np.ndarray:
    """(n,) int32: the bin each element of the forward transform holds
    (the inverse of :func:`.fused_psd_mixed.element_of_bin`)."""
    n = int(np.prod(plan))
    out = np.empty(n, np.int32)
    out[element_of_bin(plan, np.arange(n))] = np.arange(n)
    return out


def ml_copy_width(N: int, ptr: int) -> int:
    """Pass A's copy width for frames at device address ``ptr``: 16, 8 or
    4 bytes, the largest that divides 2 N2 (so a raw row's tile, and 2N)
    and the pointer and is at most a tile row's 2C bytes."""
    t = ml_layout(N)
    for width in (16, 8, 4):
        if ((2 * t.N2) % width == 0 and ptr % width == 0
                and width <= 2 * t.cols):
            return width
    raise ValueError(f"frames at {ptr:#x} are not 4-byte aligned")


def kernel_attributes(N: int, which: int,
                      device: Optional[torch.device] = None) -> dict:
    """What a pass of the kernel at N bins gets on the card (``which``:
    :data:`PASS_A`, :data:`PASS_A_WINDOWED` or :data:`PASS_B`, which asks
    of the class of sums N's plan takes): :func:`library_attributes`."""
    t = ml_layout(N)
    index = (device or torch.device(
        "cuda", torch.cuda.current_device())).index or 0
    b = which == PASS_B
    return library_attributes(
        "fused_psd_mixed_large", f"pass {which}",
        lambda lib, attrs: lib.rpf_fused_psd_mixed_large_attributes(
            t.which_b if b else which, t.smem[b], t.threads[b], index,
            attrs))


@functools.lru_cache(maxsize=64)
def resident_blocks(N: int, which: int, index: int) -> int:
    """Blocks of a pass at N bins that card ``index`` holds at once: its
    SMs times the blocks one SM holds. Asked of the card once per key."""
    return resident_of(kernel_attributes(N, which, torch.device("cuda", index)),
                     index)


class _Plan(NamedTuple):
    """A call's launch beyond its arguments, cached per (N, F, windowed,
    device): the library, the grid, the plans' ints and the tables (kept
    alive here) with their pointers."""
    lib: ctypes.CDLL
    layout: MlLayout
    group_a: int
    group_b: int
    ints: Tuple[ctypes.Array, ctypes.Array]
    tables: Tuple[int, ...]     # tw1, bin1, inter, tw2, order2
    keep: tuple


_plans: dict = {}


@functools.lru_cache(maxsize=8)
def device_tables(N: int, index: int):
    """The kernel's tables at N on card ``index`` (plan_twiddles of N1's
    plan, the bin of each of its elements, the tile-major inter-stage
    twiddle, plan_twiddles of N2's plan, element_of_bin of its bins) and
    both plans' ints, shared by ML and the estimators' forms of its
    passes (:mod:`.fused_psd_mixed_large_est`)."""
    t = ml_layout(N)
    device = torch.device("cuda", index)
    keep = tuple(torch.from_numpy(x).to(device) for x in (
        plan_twiddles(t.plan1), bin_of_element(t.plan1),
        ml_inter_twiddle(N), plan_twiddles(t.plan2),
        element_of_bin(t.plan2, np.arange(t.N2)).astype(np.int32)))
    ints = tuple((ctypes.c_int * len(x))(*x)
                 for x in (la.ints() for la in t.launches()))
    return keep, ints


def _plan(N: int, F: int, windowed: bool, device: torch.device) -> _Plan:
    key = (N, F, windowed, device.index)
    plan = _plans.get(key)
    if plan is None:
        from . import _build
        t = ml_layout(N)
        keep, ints = device_tables(N, device.index)
        tiles_a, tiles_b = t.tiles
        group_a = large_group(F, tiles_a, resident_blocks(
            N, PASS_A_WINDOWED if windowed else PASS_A, device.index))
        group_b = large_group(F, tiles_b,
                              resident_blocks(N, PASS_B, device.index))
        plan = _plans[key] = _Plan(
            _build.load("fused_psd_mixed_large"), t, group_a, group_b, ints,
            tuple(k.data_ptr() for k in keep), keep)
    return plan


def fused_psd_mixed_large(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                          window: Optional[torch.Tensor] = None,
                          group_b: Optional[int] = None) -> torch.Tensor:
    """(F, 2N) uint8 frames, N even, 7-smooth and not a power of two in
    (16384, 2^22], ``n_valid`` real frames -> (N,) float32 sum of |DFT|^2
    over those frames, on the tensor's device. ``window``: an (N,)
    float32 tensor on the same device, or None. ``group_b``: frames a
    pass-B block, where not the grid's own (the streams entry's, to
    compare a stream's row with this call's bits).

    A CUDA tensor runs the kernel on the current stream (asynchronously);
    a CPU tensor runs the plain version."""
    n_valid = int(n_valid)
    check_args("fused_psd_mixed_large", fused_psd_mixed_large_eligible,
               raw_u8, n_valid, chunk, window)
    if not _on_cuda("fused_psd_mixed_large", raw_u8):
        COUNTS.plain += 1
        return fused_psd_mixed_large_reference(raw_u8, n_valid, chunk,
                                               window)
    check_alignment("fused_psd_mixed_large", raw_u8, RAW_ALIGN, window,
                    WINDOW_ALIGN)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    device = raw_u8.device
    plan = _plan(N, F, window is not None, device)
    t = plan.layout
    group_b = plan.group_b if group_b is None else int(group_b)
    rows = -(-F // group_b)
    stream = _raw_stream(device.index)
    scratch, partial = workspace(("ML", N, F, rows, device.index, stream),
                                 2 * F * t.N1 * t.n2p,
                                 rows * t.row if rows > 1 else 0, device)
    out = torch.empty((t.row,), dtype=torch.float32, device=device)
    tw1, bin1, inter, tw2, order2 = plan.tables
    err = plan.lib.rpf_fused_psd_mixed_large(
        raw_u8.data_ptr(), tw1, bin1, inter,
        None if window is None else window.data_ptr(), tw2, order2, scratch,
        partial, out.data_ptr(), ctypes.addressof(plan.ints[0]),
        ctypes.addressof(plan.ints[1]), device.index, t.log2c, t.n2p,
        ml_copy_width(N, raw_u8.data_ptr()), F, plan.group_a, group_b,
        n_valid, stream)
    if err != 0:
        raise launch_error("fused_psd_mixed_large", plan.lib, err)
    if window is None:
        COUNTS.kernel_mixed_large += 1
    else:
        COUNTS.kernel_mixed_large_windowed += 1
    return out[:N]


def fused_psd_mixed_large_streams_reference(
        raw_u8: torch.Tensor, n_valid: torch.Tensor, chunk: int,
        window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of ML-S: (S, F, 2N) uint8 frames, (S,)
    valid counts -> (S, N) float32, row s
    :func:`fused_psd_mixed_large_reference` of stream s's frames and
    count."""
    return per_stream_reference(fused_psd_mixed_large_reference, raw_u8,
                                n_valid, chunk, window)


def streams_grid(S: int, F: int, N: int, windowed: bool, index: int
                 ) -> Tuple[int, int, int]:
    """(frames a pass-A block, frames a pass-B block, partial rows a
    stream) over S streams of F frames at N on card ``index``:
    :func:`.fused_psd_large.large_group` with the S streams' tiles."""
    tiles_a, tiles_b = ml_layout(N).tiles
    group_a = large_group(F, S * tiles_a, resident_blocks(
        N, PASS_A_WINDOWED if windowed else PASS_A, index))
    group_b = large_group(F, S * tiles_b, resident_blocks(N, PASS_B, index))
    return group_a, group_b, -(-F // group_b)


#: The streams entry's grid by (N, S, F, windowed, device).
_streams_grids: dict = {}


def fused_psd_mixed_large_streams(raw_u8: torch.Tensor,
                                  n_valid: torch.Tensor, chunk: int,
                                  window: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """ML-S: (S, F, 2N) uint8 frames of S streams at an N
    :func:`fused_psd_mixed_large` takes, ``n_valid`` (S,) int32 real
    frames per stream on the frames' device -> (S, N) float32, row s the
    sum of |DFT|^2 over stream s's first n_valid[s] frames (a count
    outside [0, F] acts as its nearest bound). ``window``: an (N,) float32
    tensor on the same device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously:
    the kernel reads ``n_valid`` from device memory when it runs); a CPU
    tensor runs the plain version."""
    check_streams_args(raw_u8, n_valid, chunk, window,
                       "fused_psd_mixed_large_streams",
                       fused_psd_mixed_large_eligible)
    if not _on_cuda("fused_psd_mixed_large_streams", raw_u8):
        COUNTS.plain += 1
        return fused_psd_mixed_large_streams_reference(raw_u8, n_valid,
                                                       chunk, window)
    check_alignment("fused_psd_mixed_large_streams", raw_u8, RAW_ALIGN,
                    window, WINDOW_ALIGN)
    S, F, N = raw_u8.shape[0], raw_u8.shape[1], raw_u8.shape[2] // 2
    device = raw_u8.device
    windowed = window is not None
    plan = _plan(N, F, windowed, device)
    t = plan.layout
    key = (N, S, F, windowed, device.index)
    grid = _streams_grids.get(key)
    if grid is None:
        grid = _streams_grids[key] = streams_grid(S, F, N, windowed,
                                                  device.index)
    group_a, group_b, rows = grid
    stream = _raw_stream(device.index)
    scratch, partial = workspace(
        ("ML", N, S * F, S * rows, device.index, stream),
        2 * S * F * t.N1 * t.n2p, S * rows * t.row if rows > 1 else 0,
        device)
    out = torch.empty((S, t.row), dtype=torch.float32, device=device)
    tw1, bin1, inter, tw2, order2 = plan.tables
    err = plan.lib.rpf_fused_psd_mixed_large_streams(
        raw_u8.data_ptr(), tw1, bin1, inter,
        None if window is None else window.data_ptr(), tw2, order2,
        n_valid.data_ptr(), scratch, partial, out.data_ptr(),
        ctypes.addressof(plan.ints[0]), ctypes.addressof(plan.ints[1]),
        device.index, t.log2c, t.n2p, ml_copy_width(N, raw_u8.data_ptr()), S,
        F, group_a, group_b, stream)
    if err != 0:
        raise launch_error("fused_psd_mixed_large_streams", plan.lib, err)
    if window is None:
        COUNTS.kernel_mixed_large_streams += 1
    else:
        COUNTS.kernel_mixed_large_streams_windowed += 1
    return out[:, :N]
