"""Mixed-radix fused PSD step: raw u8 IQ frames -> (N,) f32 partial power
sum, at the even 7-smooth bin counts (every prime factor at most 7) up to
16384.

The JAX package computes these N with XLA's FFT through its transform
ladder (the fourstep, hybrid, xla and fft4 rungs of
``rtl_power_fftw_tpu/ops/spectral.py``), not with a Pallas kernel; the
port computes them with a CUDA C++ kernel written for Hopper
(``csrc/fused_psd_mixed.cu``), the function of :func:`fused_psd
<.fused_psd.fused_psd>` (K1/K2): dequantize (u8 - 127) [x window in
float32], length-N DFT in float32, |X|^2, frames f >= ``n_valid`` dropped,
a sum over frames, bins in natural (unshifted) order.
:func:`fused_psd_mixed_streams` does it for S streams at once, as K4 does.

The kernel (``csrc/fused_psd_mixed_ring.cuh``) runs the passes of
``csrc/fft_mixed.cuh``, decimation in frequency with the radices 16, 8, 7,
5, 4, 3 and 2, by the pass plan :func:`mixed_plan` (run-time, one kernel
for every N), twiddles from :func:`plan_twiddles`; after the last pass
element q holds the bin whose digits are q's in reverse
(:func:`element_of_bin`). Its layout is :func:`ring_shape`: ``lanes``
frame lanes of ``tf`` threads, tf a multiple of 32 with the fewest idle
thread slots over the passes; the plan ints carry each pass's stride,
division constant (:func:`magic`), twiddle offset and rounds, so no pass
divides. The next frame is copied into a ring in shared memory while one
is transformed, :func:`copy_width` bytes a copy; each thread keeps its
last-pass sums in registers across its lane's frames (at most
:data:`RING_ACC`). A block sums as many frames as put the grid within the
blocks the card holds resident, at least one a lane (:func:`mixed_group`,
:func:`ring_resident_blocks`). Each block writes a partial row of N
rounded up to 32 floats and ``psd_sum.cuh`` adds the rows in float64, so
a run gives the same bits every time.

:func:`fused_psd_mixed` and :func:`fused_psd_mixed_streams` dispatch on
the tensor's device: a CPU tensor goes to the plain PyTorch version (K1's
and K4's own, :func:`.fused_psd.fused_psd_reference`, whose
``torch.fft.fft`` takes any N on the CPU); a CUDA tensor goes to the
kernel, or raises. ``COUNTS.kernel_mixed`` and
``COUNTS.kernel_mixed_streams`` (in :mod:`.fused_psd`) count its
launches.

The library also holds the chirp-Z kernel (:mod:`.fused_psd_bluestein`)
and the kernel both replaced, the control (``csrc/fused_psd_mixed.cuh``:
the same passes with the plan by value, no frame in flight, the
accumulator in shared memory; :func:`launch_shape`, :func:`mixed_launch`),
which only :func:`fused_psd_mixed_control` and
``fused_psd_bluestein.fused_psd_bluestein_control`` launch, counted in
:data:`CONTROL_COUNTS`. The host path does the least it can a call: the
plan, twiddles and grid are cached per key and the partial rows per (row,
rows, device, stream), so a call allocates only its output.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .fused_psd import (COUNTS, LaunchCounts, _on_cuda, check_alignment,
                        check_args, check_streams_args, fused_psd_reference,
                        fused_psd_streams_reference, k1_group, launch_error,
                        resident_of)
from .fused_psd_large import _raw_stream

#: Radices a pass may have; kept in step with kMixedRadices in
#: csrc/fft_mixed.cuh.
RADICES = (16, 8, 7, 5, 4, 3, 2)
#: Largest N the kernel takes: a lane's padded complex frame and its two
#: ring slots (12.5 N bytes) within the 227 KB a Hopper block may use.
MAX_N = 16384
#: Limits of the plan, kept in step with the source: passes
#: (kMixedMaxPasses), threads a block of the control (kMixedMaxThreads)
#: and shared bytes a block (kMixedMaxSmem).
MAX_PASSES = 10
MAX_THREADS = 512
MAX_SMEM = 232448
#: Threads a block aims at, from frame lanes where a frame has fewer.
TARGET_THREADS = 256
#: Bins a block of psd_sum.cuh sums (kSumBins): a partial row's length is
#: N rounded up to it.
SUM_BINS = 32
#: Alignment of the control's loads: frames read as u16 pairs, the window
#: as floats.
RAW_ALIGN = 2
WINDOW_ALIGN = 4
#: The kernel's limits, kept in step with csrc/fused_psd_mixed_ring.cuh:
#: threads a block (kRingMaxThreads) and the two classes of last-pass sums
#: a thread holds in registers (kRingAccSmall, kRingAccLarge).
RING_MAX_THREADS = 512
RING_ACC = (16, 36)
#: Dynamic shared bytes a block of the kernel may have (kRingMaxSmem): the
#: 227 KB less 256 for its static pass table.
RING_MAX_SMEM = MAX_SMEM - 256
#: Frames are copied into the ring 4, 8 or 16 bytes at a time
#: (:func:`copy_width`), so they must be at least 4-byte aligned.
RING_RAW_ALIGN = 4

#: Launches of the controls (:func:`fused_psd_mixed_control`,
#: ``fused_psd_bluestein.fused_psd_bluestein_control``) and of their plain
#: versions, apart from :data:`COUNTS`.
CONTROL_COUNTS = LaunchCounts()


def smooth7(N: int) -> bool:
    """True iff every prime factor of N >= 1 is at most 7."""
    for p in (2, 3, 5, 7):
        while N % p == 0:
            N //= p
    return N == 1


def fused_psd_mixed_eligible(N: int) -> bool:
    """True iff the kernel takes N bins: even, 7-smooth, 2..16384."""
    return 2 <= N <= MAX_N and N % 2 == 0 and smooth7(N)


def mixed_plan(N: int) -> Tuple[int, ...]:
    """The radices of the passes at N (7-smooth), first to last, largest
    first: the power of two as 16s and one 8, 4 or 2 (2^(4q+1) as
    16^(q-1), 8, 4), then the 7s, 5s and 3s."""
    if N < 2 or not smooth7(N):
        raise ValueError(f"no mixed-radix plan for N={N}")
    a = (N & -N).bit_length() - 1
    q, r = divmod(a, 4)
    if r == 1 and q >= 1:
        pow2 = [16] * (q - 1) + [8, 4]
    else:
        pow2 = [16] * q + {0: [], 1: [2], 2: [4], 3: [8]}[r]
    odd = N >> a
    rest = []
    for p in (7, 5, 3):
        while odd % p == 0:
            rest.append(p)
            odd //= p
    return tuple(sorted(pow2 + rest, reverse=True))


def plan_spans(plan) -> list:
    """(L_j, S_j) of each pass: the span of its blocks and its stride."""
    out, L = [], int(np.prod(plan))
    for r in plan:
        out.append((L, L // r))
        L //= r
    return out


def plan_twiddles(plan) -> np.ndarray:
    """The twiddles between passes, (rows, 2) float32 (re, im): for each
    pass j but the last, of radix R_j over blocks of span L_j and stride
    S_j = L_j / R_j, the L_j values W_{L_j}^(k1 n2) at row offset_j +
    k1 S_j + n2 (k1 < R_j, n2 < S_j; offset_j the spans before it), each
    angle reduced exactly as (k1 n2) mod L_j in integers, computed in
    float64 and rounded once to float32."""
    parts = []
    for L, S in plan_spans(plan)[:-1]:
        kn = (np.arange(L // S, dtype=np.int64)[:, None]
              * np.arange(S, dtype=np.int64)[None, :]) % L
        ang = -2.0 * np.pi * kn.astype(np.float64) / L
        parts.append(np.stack([np.cos(ang), np.sin(ang)], -1).reshape(L, 2))
    if not parts:
        return np.zeros((1, 2), np.float32)
    return np.concatenate(parts).astype(np.float32)


def element_of_bin(plan, k):
    """The element of the forward transform's output that holds bin k:
    k's mixed-radix digits (radix R_0 least significant) in reverse (as
    element_of_bin in csrc/fused_psd_mixed.cuh)."""
    k = np.asarray(k, dtype=np.int64)
    q = np.zeros_like(k)
    for (_, S), r in zip(plan_spans(plan), plan):
        q = q + (k % r) * S
        k = k // r
    return q


def pad_index(e):
    """Element e's float2 slot in a lane's exchange buffer."""
    return e + (e >> 4)


class MixedLaunch(NamedTuple):
    """A block's layout (``MixedPlan`` in csrc/fused_psd_mixed.cuh)."""
    n: int          # transform length: N, or the chirp-Z kernel's M
    bins: int       # N
    row: int        # a partial row: N rounded up to SUM_BINS
    plan: tuple     # the radices
    tf: int         # threads a frame lane
    lanes: int      # frame lanes a block
    xstride: int    # float2 of a lane's exchange buffer

    @property
    def threads(self) -> int:
        return self.tf * self.lanes

    @property
    def smem(self) -> int:
        """Shared bytes a block: the exchange buffers, then the f32
        accumulators of N floats each."""
        return self.lanes * (self.xstride * 8 + self.bins * 4)

    def ints(self) -> list:
        """The plan as the kernel reads it (read_plan)."""
        radix = list(self.plan) + [0] * (MAX_PASSES - len(self.plan))
        return [self.n, self.bins, self.row, len(self.plan), self.tf,
                self.lanes, self.xstride] + radix


def launch_shape(plan, bins: int) -> MixedLaunch:
    """The layout of a transform by ``plan`` of which the first ``bins``
    outputs are summed: tf = n / (its largest radix) threads a frame (at
    most MAX_THREADS; a pass of more butterflies loops), as many frame
    lanes, a power of two, as bring a block to at most TARGET_THREADS,
    fewer where shared memory runs out."""
    plan = tuple(plan)
    n = int(np.prod(plan))
    if len(plan) > MAX_PASSES or any(r not in RADICES for r in plan):
        raise ValueError(f"plan {plan} outside the kernel's radices or "
                         "passes")
    tf = min(MAX_THREADS, n // max(plan))
    lanes = 1 << max(0, (TARGET_THREADS // tf).bit_length() - 1)
    xstride = pad_index(n - 1) + 1
    while lanes > 1 and lanes * (xstride * 8 + bins * 4) > MAX_SMEM:
        lanes //= 2
    shape = MixedLaunch(n, bins, -(-bins // SUM_BINS) * SUM_BINS, plan, tf,
                        lanes, xstride)
    if shape.smem > MAX_SMEM:
        raise ValueError(f"a frame of {n} points takes {shape.smem} bytes "
                         "of shared memory")
    return shape


@functools.lru_cache(maxsize=64)
def mixed_launch(N: int) -> MixedLaunch:
    """The mixed-radix kernel's block layout at N bins."""
    return launch_shape(mixed_plan(N), N)


def mixed_group(frames: int, chunk: int, resident: int, lanes: int) -> int:
    """Frames a block sums over ``frames`` frames: k1_group's (the least
    divisor of ``chunk`` that puts the grid within ``resident`` blocks),
    but at least the block's frame lanes (or ``chunk``), so that no lane
    idles for want of a frame. Both are powers of two, so the group
    divides ``chunk`` and a streams block never crosses a stream."""
    return max(k1_group(frames, chunk, resident), min(lanes, chunk))


class _Plan(NamedTuple):
    lib: ctypes.CDLL
    ints: ctypes.Array      # the plan ints the launch passes
    group: int              # frames a block
    rows: int               # partial rows (blocks)
    twiddle: int            # its device pointer
    keep: tuple             # the tensors behind the pointers
    order: int = 0          # the kernel's bin -> element table


@functools.lru_cache(maxsize=32)
def _device_twiddles(plan: tuple, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(plan_twiddles(plan)).to(device)


@functools.lru_cache(maxsize=32)
def _device_order(plan: tuple, device: torch.device) -> torch.Tensor:
    """element_of_bin of every bin, (N,) int32 on the device."""
    N = int(np.prod(plan))
    return torch.from_numpy(element_of_bin(plan, np.arange(N)).astype(
        np.int32)).to(device)


def _attributes(label: str, call) -> dict:
    """Runs ``call(lib, attrs)`` of the library's attributes entries and
    names what it wrote."""
    from . import _build
    lib = _build.load("fused_psd_mixed")
    attrs = (ctypes.c_int * 6)()
    err = call(lib, attrs)
    if err != 0:
        raise launch_error(f"fused_psd_mixed attributes of {label}", lib, err)
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "dynamic_smem", "threads", "blocks_per_sm"), attrs))


def control_attributes(shape: MixedLaunch, chirp: bool = False,
                       windowed: bool = False,
                       device: Optional[torch.device] = None) -> dict:
    """What the control (its chirp-Z instantiation where ``chirp``,
    windowed or not) gets with the layout ``shape`` on the card: registers
    and spill bytes a thread, static and dynamic shared bytes and threads a
    block, and the blocks that reside on one SM. Launches nothing."""
    device = device or torch.device("cuda", torch.cuda.current_device())
    ints = (ctypes.c_int * (7 + MAX_PASSES))(*shape.ints())
    return _attributes(str(shape), lambda lib, attrs:
                       lib.rpf_fused_psd_mixed_control_attributes(
                           ctypes.addressof(ints), int(chirp), int(windowed),
                           device.index or 0, attrs))


@functools.lru_cache(maxsize=64)
def control_resident_blocks(shape: MixedLaunch, chirp: bool, windowed: bool,
                            index: int) -> int:
    """Blocks of the control with the layout ``shape`` that card ``index``
    holds resident. Asked of the card once per key."""
    return resident_of(control_attributes(shape, chirp, windowed,
                                        torch.device("cuda", index)), index)


_plans: dict = {}


def _plan(shape: MixedLaunch, F: int, chunk: int, chirp: bool,
          windowed: bool, streams: int, device: torch.device) -> _Plan:
    """The control's launch of F frames a stream over ``streams`` streams
    (one for the single-stream entry), cached per key."""
    key = (shape, F, chunk, chirp, windowed, streams, device.index)
    plan = _plans.get(key)
    if plan is None:
        from . import _build
        group = mixed_group(
            streams * F, chunk,
            control_resident_blocks(shape, chirp, windowed, device.index),
            shape.lanes)
        twiddle = _device_twiddles(shape.plan, device)
        ints = (ctypes.c_int * (7 + MAX_PASSES))(*shape.ints())
        plan = _plans[key] = _Plan(
            _build.load("fused_psd_mixed"), ints, group,
            streams * -(-F // group), twiddle.data_ptr(), (twiddle,))
    return plan


#: Partial rows by (row, rows, device, stream), the newest few: the kernel
#: is stream-ordered, so a later call on the same stream may reuse them.
_workspaces: collections.OrderedDict = collections.OrderedDict()
_WORKSPACES = 4


def partial_rows(row: int, rows: int, device: torch.device,
                 stream: int) -> int:
    """A pointer to (rows, row) float32 partial rows for a launch on
    ``stream``, reused by later launches on it."""
    key = (row, rows, device.index, stream)
    buf = _workspaces.get(key)
    if buf is None:
        buf = _workspaces[key] = torch.empty(rows * row, dtype=torch.float32,
                                             device=device)
        while len(_workspaces) > _WORKSPACES:
            _workspaces.popitem(last=False)
    else:
        _workspaces.move_to_end(key)
    return buf.data_ptr()


def launch_control(kernel: str, shape: MixedLaunch, raw_u8: torch.Tensor,
                   n_valid, chunk: int, window: Optional[torch.Tensor],
                   chirp: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> torch.Tensor:
    """Runs the control with the layout ``shape`` on CUDA frames, on the
    current stream (asynchronously): (F, 2N) frames with an int
    ``n_valid`` -> (N,), or (S, F, 2N) frames with (S,) int32 counts on
    the device -> (S, N), a view of (S, N rounded up to 32) rows.
    ``chirp``: the chirp-Z control's (a, B / M) tables on the device, or
    None for the mixed-radix control. ``kernel`` names the entry in
    errors."""
    check_alignment(kernel, raw_u8, RAW_ALIGN, window, WINDOW_ALIGN)
    streams = raw_u8.dim() == 3
    S = raw_u8.shape[0] if streams else 1
    F = raw_u8.shape[-2]
    device = raw_u8.device
    plan = _plan(shape, F, chunk, chirp is not None, window is not None, S,
                 device)
    stream = _raw_stream(device.index)
    partial = partial_rows(shape.row, plan.rows, device, stream)
    out = torch.empty((S, shape.row), dtype=torch.float32, device=device)
    tables = (raw_u8.data_ptr(), plan.twiddle,
              None if window is None else window.data_ptr(),
              *((None, None) if chirp is None
                else (chirp[0].data_ptr(), chirp[1].data_ptr())))
    if streams:
        err = plan.lib.rpf_fused_psd_mixed_control_streams(
            *tables, n_valid.data_ptr(), partial, out.data_ptr(),
            ctypes.addressof(plan.ints), device.index, S, F, plan.group,
            stream)
    else:
        err = plan.lib.rpf_fused_psd_mixed_control(
            *tables, partial, out.data_ptr(), ctypes.addressof(plan.ints),
            device.index, F, plan.group, n_valid, stream)
    if err != 0:
        raise launch_error(kernel, plan.lib, err)
    return out[:, :shape.bins] if streams else out[0, :shape.bins]


# ---- The kernel: the ring kernel of csrc/fused_psd_mixed_ring.cuh. ----


def magic(S: int) -> int:
    """ceil(2^32 / S), the kernel's constant for b / S = umulhi(b, it)
    (exact for b < 2^15, S < 2^14); 0 for S = 1, which no middle pass
    has."""
    return 0 if S == 1 else -(-(1 << 32) // S)


def ring_rounds(plan, tf: int) -> Tuple[int, ...]:
    """Rounds of each pass on a lane of tf threads: ceil((N / R_j) / tf)."""
    n = int(np.prod(plan))
    return tuple(-(-(n // r) // tf) for r in plan)


def ring_tf(plan) -> int:
    """The lane width for ``plan``: the multiple of 32 up to
    RING_MAX_THREADS with the fewest thread slots over the passes (the sum
    of rounds_j * tf, idle threads included), among those whose last pass
    leaves a thread at most RING_ACC[-1] sums; on a tie the larger, whose
    frame takes fewer rounds (at 500: 128 threads, one round a pass)."""
    best = None
    for tf in range(32, RING_MAX_THREADS + 1, 32):
        rounds = ring_rounds(plan, tf)
        if rounds[-1] * plan[-1] > RING_ACC[-1]:
            continue
        if best is None or sum(rounds) * tf <= best[0]:
            best = (sum(rounds) * tf, tf)
    if best is None:
        raise ValueError(f"no lane width for plan {tuple(plan)}")
    return best[1]


def ring_slot(N: int) -> int:
    """A ring slot: the frame's 2N bytes rounded up to 16."""
    return -(-2 * N // 16) * 16


def round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


class RingLaunch(NamedTuple):
    """The kernel's layout (``RingPlan`` in
    csrc/fused_psd_mixed_ring.cuh)."""
    n: int          # N
    row: int        # a partial row: N rounded up to SUM_BINS
    plan: tuple     # the radices
    tf: int         # threads a frame lane, a multiple of 32
    lanes: int      # frame lanes a block, a power of two

    @property
    def threads(self) -> int:
        return self.tf * self.lanes

    @property
    def rounds(self) -> Tuple[int, ...]:
        return ring_rounds(self.plan, self.tf)

    @property
    def acc(self) -> int:
        """Last-pass sums a thread holds: rounds * R_last."""
        return self.rounds[-1] * self.plan[-1]

    @property
    def acc_class(self) -> int:
        """The kernel's register array for them: RING_ACC's first that
        holds them."""
        return next(a for a in RING_ACC if self.acc <= a)

    def smem(self) -> int:
        """Dynamic shared bytes a block: the exchange buffers (N float2
        each, element e at slot e), then the lanes' rings (two slots and 32
        bytes each)."""
        return (round16(self.lanes * self.n * 8)
                + self.lanes * (2 * ring_slot(self.n) + 32))

    def ints(self) -> list:
        """The plan as the kernel reads it (read_ring_plan): n, row,
        passes, tf, lanes, then per pass (MAX_PASSES each, 0 past the last)
        the radix, stride, division constant (as int32 bits), twiddle
        offset and rounds."""
        spans = plan_spans(self.plan)
        offsets = [0]
        for L, _ in spans[:-1]:
            offsets.append(offsets[-1] + L)
        magics = [magic(S) for _, S in spans]

        def pad(values):
            values = list(values)
            return values + [0] * (MAX_PASSES - len(values))

        return ([self.n, self.row, len(self.plan), self.tf, self.lanes]
                + pad(self.plan)
                + pad(S for _, S in spans)
                + pad(m - (1 << 32) if m >= 1 << 31 else m for m in magics)
                + pad(offsets) + pad(self.rounds))


def ring_shape(plan) -> RingLaunch:
    """The kernel's layout for ``plan``: tf = :func:`ring_tf`, as many
    frame lanes, a power of two, as bring a block to at most
    TARGET_THREADS threads, fewer where shared memory runs out."""
    plan = tuple(plan)
    n = int(np.prod(plan))
    if len(plan) > MAX_PASSES or any(r not in RADICES for r in plan):
        raise ValueError(f"plan {plan} outside the kernel's radices or "
                         "passes")
    tf = ring_tf(plan)
    lanes = 1 << max(0, (TARGET_THREADS // tf).bit_length() - 1)
    shape = RingLaunch(n, -(-n // SUM_BINS) * SUM_BINS, plan, tf, lanes)
    while shape.lanes > 1 and shape.smem() > RING_MAX_SMEM:
        shape = shape._replace(lanes=shape.lanes // 2)
    if shape.smem() > RING_MAX_SMEM:
        raise ValueError(f"a frame of {n} points takes {shape.smem()} "
                         "bytes of shared memory")
    return shape


@functools.lru_cache(maxsize=64)
def ring_launch(N: int) -> RingLaunch:
    """The kernel's block layout at N bins."""
    return ring_shape(mixed_plan(N))


def copy_width(N: int, ptr: int) -> int:
    """The ring's copy width for frames of N complex u8 samples at device
    address ``ptr``: 16 bytes where 2N and the pointer allow it, else 8,
    else 4 (a frame is only 4-byte aligned at N = 2 * odd)."""
    for width in (16, 8, 4):
        if (2 * N) % width == 0 and ptr % width == 0:
            return width
    raise ValueError(f"frames at {ptr:#x} are not 4-byte aligned")


def ring_attributes(shape: RingLaunch, windowed: bool = False,
                    device: Optional[torch.device] = None) -> dict:
    """What the kernel gets with the layout ``shape`` on the card:
    registers and spill bytes a thread, static and dynamic shared bytes and
    threads a block, and the blocks that reside on one SM. Launches
    nothing."""
    device = device or torch.device("cuda", torch.cuda.current_device())
    ints = (ctypes.c_int * len(shape.ints()))(*shape.ints())
    return _attributes(str(shape), lambda lib, attrs:
                       lib.rpf_fused_psd_mixed_attributes(
                           ctypes.addressof(ints), int(windowed),
                           device.index or 0, attrs))


@functools.lru_cache(maxsize=64)
def ring_resident_blocks(shape: RingLaunch, windowed: bool,
                         index: int) -> int:
    """Blocks of the kernel with the layout ``shape`` that card ``index``
    holds resident. Asked of the card once per key."""
    return resident_of(ring_attributes(shape, windowed,
                                     torch.device("cuda", index)), index)


_ring_plans: dict = {}


def _ring_plan(shape: RingLaunch, F: int, chunk: int, windowed: bool,
               streams: int, device: torch.device) -> _Plan:
    """The kernel's launch of F frames a stream over ``streams`` streams,
    cached per key."""
    key = (shape, F, chunk, windowed, streams, device.index)
    plan = _ring_plans.get(key)
    if plan is None:
        from . import _build
        group = mixed_group(
            streams * F, chunk,
            ring_resident_blocks(shape, windowed, device.index),
            shape.lanes)
        twiddle = _device_twiddles(shape.plan, device)
        order = _device_order(shape.plan, device)
        ints = (ctypes.c_int * len(shape.ints()))(*shape.ints())
        plan = _ring_plans[key] = _Plan(
            _build.load("fused_psd_mixed"), ints, group,
            streams * -(-F // group), twiddle.data_ptr(), (twiddle, order),
            order.data_ptr())
    return plan


def launch_ring(kernel: str, shape: RingLaunch, raw_u8: torch.Tensor,
                n_valid, chunk: int, window: Optional[torch.Tensor]
                ) -> torch.Tensor:
    """Runs the kernel with the layout ``shape`` on CUDA frames, on the
    current stream
    (asynchronously): (F, 2N) frames with an int ``n_valid`` -> (N,), or
    (S, F, 2N) frames with (S,) int32 counts on the device -> (S, N), a
    view of (S, N rounded up to 32) rows. ``kernel`` names the entry in
    errors."""
    check_alignment(kernel, raw_u8, RING_RAW_ALIGN, window, WINDOW_ALIGN)
    streams = raw_u8.dim() == 3
    S = raw_u8.shape[0] if streams else 1
    F = raw_u8.shape[-2]
    device = raw_u8.device
    width = copy_width(shape.n, raw_u8.data_ptr())
    plan = _ring_plan(shape, F, chunk, window is not None, S, device)
    stream = _raw_stream(device.index)
    partial = partial_rows(shape.row, plan.rows, device, stream)
    out = torch.empty((S, shape.row), dtype=torch.float32, device=device)
    win = None if window is None else window.data_ptr()
    if streams:
        err = plan.lib.rpf_fused_psd_mixed_streams(
            raw_u8.data_ptr(), plan.twiddle, plan.order, win,
            n_valid.data_ptr(), partial, out.data_ptr(),
            ctypes.addressof(plan.ints), device.index, S, F, plan.group,
            width, stream)
    else:
        err = plan.lib.rpf_fused_psd_mixed(
            raw_u8.data_ptr(), plan.twiddle, plan.order, win, partial,
            out.data_ptr(), ctypes.addressof(plan.ints), device.index, F,
            plan.group, n_valid, width, stream)
    if err != 0:
        raise launch_error(kernel, plan.lib, err)
    return out[:, :shape.n] if streams else out[0, :shape.n]


def fused_psd_mixed(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                    window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(F, 2N) uint8 frames, N even and 7-smooth up to 16384, ``n_valid``
    real frames -> (N,) float32 sum of |DFT|^2 over those frames, on the
    tensor's device. ``window``: an (N,) float32 tensor on the same
    device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously);
    a CPU tensor runs the plain version."""
    n_valid = int(n_valid)
    check_args("fused_psd_mixed", fused_psd_mixed_eligible, raw_u8, n_valid,
               chunk, window)
    if not _on_cuda("fused_psd_mixed", raw_u8):
        COUNTS.plain += 1
        return fused_psd_reference(raw_u8, n_valid, chunk, window)
    out = launch_ring("fused_psd_mixed", ring_launch(raw_u8.shape[1] // 2),
                      raw_u8, n_valid, chunk, window)
    COUNTS.kernel_mixed += 1
    return out


def fused_psd_mixed_streams(raw_u8: torch.Tensor, n_valid: torch.Tensor,
                            chunk: int,
                            window: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """(S, F, 2N) uint8 frames of S streams, ``n_valid`` (S,) int32 real
    frames per stream on the frames' device -> (S, N) float32, row s the
    sum of |DFT|^2 over stream s's first n_valid[s] frames (a count
    outside [0, F] acts as its nearest bound). ``window``: an (N,) float32
    tensor on the same device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously:
    the kernel reads ``n_valid`` from device memory when it runs); a CPU
    tensor runs the plain version. On the card the result is a view of
    (S, N rounded up to 32) rows. Blocks are counted over all S*F frames;
    a group divides chunk, which divides F, so no block crosses a
    stream."""
    check_streams_args(raw_u8, n_valid, chunk, window,
                       "fused_psd_mixed_streams", fused_psd_mixed_eligible)
    if not _on_cuda("fused_psd_mixed_streams", raw_u8):
        COUNTS.plain += 1
        return fused_psd_streams_reference(raw_u8, n_valid, chunk, window)
    out = launch_ring("fused_psd_mixed_streams",
                      ring_launch(raw_u8.shape[2] // 2), raw_u8, n_valid,
                      chunk, window)
    COUNTS.kernel_mixed_streams += 1
    return out


def check_either(kernel: str, eligible, raw_u8: torch.Tensor, n_valid,
                 chunk: int, window: Optional[torch.Tensor]):
    """The checks of the single-stream entry for (F, 2N) frames (then
    ``n_valid`` as an int), or of the streams entry for (S, F, 2N) frames;
    returns ``n_valid``."""
    if isinstance(raw_u8, torch.Tensor) and raw_u8.dim() == 3:
        check_streams_args(raw_u8, n_valid, chunk, window, kernel, eligible)
        return n_valid
    n_valid = int(n_valid)
    check_args(kernel, eligible, raw_u8, n_valid, chunk, window)
    return n_valid


def fused_psd_mixed_control(raw_u8: torch.Tensor, n_valid, chunk: int,
                            window: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The control, the kernel :func:`fused_psd_mixed` replaced: the
    function of :func:`fused_psd_mixed` on (F, 2N) frames with an int
    ``n_valid``, or of :func:`fused_psd_mixed_streams` on (S, F, 2N) frames
    with (S,) int32 counts. A CUDA tensor runs the control; a CPU tensor
    the plain version. Counted in :data:`CONTROL_COUNTS`."""
    n_valid = check_either("fused_psd_mixed_control",
                           fused_psd_mixed_eligible, raw_u8, n_valid, chunk,
                           window)
    if not _on_cuda("fused_psd_mixed_control", raw_u8):
        CONTROL_COUNTS.plain += 1
        plain = (fused_psd_streams_reference if raw_u8.dim() == 3
                 else fused_psd_reference)
        return plain(raw_u8, n_valid, chunk, window)
    out = launch_control("fused_psd_mixed_control",
                         mixed_launch(raw_u8.shape[-1] // 2), raw_u8,
                         n_valid, chunk, window)
    CONTROL_COUNTS.kernel_mixed += 1
    return out
