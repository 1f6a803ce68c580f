"""Large chirp-Z fused PSD step ("BL"): raw u8 IQ frames -> (N,) f32
partial power sum, at every even N from 8194 to 2^21.

Replaces ``rtl_power_fftw_tpu/ops/dft.py:bluestein_psd_partial`` (the JAX
package's chirp-Z rung, XLA's FFT, no Pallas kernel) above the awkward-N
library's chirp-Z kernel (:mod:`.fused_psd_bluestein`, N up to 8192), with
a CUDA C++ kernel written for Hopper (``csrc/fused_psd_chirp_large.cu``).
The route (``ops/spectral.transform_route``) sends it every even N in
(8192, 2^21] that the power-of-two and mixed-radix kernels do not take,
and every even N there under ``--fft-backend bluestein``. It computes the
function of :func:`fused_psd <.fused_psd.fused_psd>` with the N-point DFT
as a circular convolution of length M = :func:`.fused_psd_bluestein.
chirp_size` (a power of two, 32768 to 2^22):

    X[m] = a[m] * IFFT_M(FFT_M(x * a) * B)[m],

the tables of :func:`.fused_psd_bluestein.bluestein_constants` (float64,
exact angle reduction, rounded once to complex64). Its three passes over
device memory, M = M1·M2 (:func:`chirp_large_split`), sample n = n1·M2 +
n2, frequency k = k1 + M1·k2, output m = m2 + M2·m1:

* pass A: u = x a (0 for n >= N), length-M1 DFTs of each column n2, × the
  inter-stage twiddle W_M^(n2·k1) (:func:`.fused_psd_mixed_large.
  inter_twiddle` of M), to a complex float32 scratch, (F, M1, M2);
* pass B: per row k1, the length-M2 DFT over n2; × B[k1 + M1·k2] / M
  (:func:`spectrum_table`, natural (k1, k2) order); conjugated; the
  length-M2 DFT over k2; × W_M^(k1·m2); back to the row (the inverse as
  the forward transform of the conjugate: only |.|^2 is kept, so the last
  conjugation is dropped);
* pass C: per column m2, the length-M1 DFT over k1; |.|^2 of m = m2 +
  M2·m1 < N summed over frames into one partial row a block (the chirp
  a[m] has modulus 1 and is not applied); ``psd_sum.cuh`` adds the rows.

Each transform is the large kernel's radix-16 register passes
(``csrc/fused_psd_large_regs.cuh``), instantiated at compile time on
log2 M: pass A its column passes with a chirp (only the rows below M1 / 2
hold samples: :func:`chirp_regs_table`), pass B its row passes with both
transforms and the turn between them in one block (:func:`spectrum_regs_
table`), pass C its column passes with the |.|^2 sums in registers
(:func:`chirp_regs_layout`); the scratch between them is the large
kernel's batch-major order (:func:`.fused_psd_large.scratch_index` of M).
The first form, the run-time tile passes of ``csrc/fft_mixed_tile.cuh``
(:func:`chirp_large_layout`), stays as the control
(:func:`fused_psd_chirp_large_control`), which only ``chip_smoke.py``
launches.

:func:`fused_psd_chirp_large` dispatches on the tensor's device: a CPU
tensor goes to the plain PyTorch version (:func:`chirp_large_reference`,
the same three passes in torch ops with the same tables); a CUDA tensor
goes to the kernel, or raises. ``COUNTS.kernel_chirp_large`` and
``COUNTS.kernel_chirp_large_windowed`` (in :mod:`.fused_psd`) count its
launches; the control's count in ``fused_psd_mixed.CONTROL_COUNTS``.

:func:`fused_psd_chirp_large_streams` ("BL-S") does the same for S
streams of F frames, (S, F, 2N), with an (S,) int32 count array on the
device, one output row per stream: the three passes with S folded into
their grids (``chirp_streams_a``, ``chirp_streams_b`` and
``chirp_streams_c``, which sums |z|^2 per stream into per-stream partial
rows), each stream's rows added as a one-stream call adds its own, so
that row s is :func:`fused_psd_chirp_large`'s output on stream s's frames
and count with the same groups, bit for bit. Its plain version is
:func:`chirp_large_streams_reference`; ``COUNTS.kernel_chirp_large_streams``
and ``COUNTS.kernel_chirp_large_streams_windowed`` count its launches.
Those streams passes, pass A's batch and the shapes beyond the large
kernel's live in ``csrc/fused_psd_chirp_large_regs.cuh``, which the CLI
estimators' forms of these passes (:mod:`.fused_psd_chirp_large_est`)
share; :func:`device_tables` and :func:`pass_residency` are the tables and
residency both take.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .fused_psd import (COUNTS, _on_cuda, check_alignment, check_args,
                        check_streams_args, per_stream_reference)
from .fused_psd_bluestein import (MAX_N as SMALL_MAX_N, bluestein_constants,
                                  chirp_size)
from .fused_psd import PASS_PLAN, pass_twiddles, resident_of
from .fused_psd_large import (_raw_stream, large_group, large_split,
                              regs_inter_twiddle, regs_layout, thread_map)
from .fused_psd_mixed import (CONTROL_COUNTS, SUM_BINS, copy_width,
                              element_of_bin, launch_error, mixed_plan)
from .fused_psd_mixed_large import (RAW_ALIGN, WINDOW_ALIGN,
                                    device_plan_tables, inter_twiddle,
                                    library_attributes, plan_ints,
                                    tile_attributes, tile_count, tile_stride,
                                    workspace)

#: Eligible sizes: even N above the small chirp-Z kernel's 8192, up to the
#: largest N the 60-seed tone yard admitted (chip_smoke.py phase 15), 2^21
#: (M = 2^22).
MIN_N = SMALL_MAX_N + 2
MAX_N = 1 << 21
#: The passes kernel_attributes asks of.
PASS_A, PASS_A_WINDOWED, PASS_B, PASS_C = 0, 1, 2, 3


def fused_psd_chirp_large_eligible(N: int) -> bool:
    """True iff the kernel takes N bins: even, 8194..2^21."""
    return MIN_N <= N <= MAX_N and N % 2 == 0


def chirp_large_split(N: int) -> Tuple[int, int]:
    """(M1, M2) of M = chirp_size(N): the large kernel's split,
    M1 = 2^floor(log2 M / 2)."""
    return large_split(chirp_size(N))


def spectrum_table(N: int) -> np.ndarray:
    """(M1, M2) complex64: B[k1 + M1·k2] / M at (k1, k2), the table pass B
    reads (M a power of two, so / M rounds nothing)."""
    M, _, B = bluestein_constants(N, chirp_size(N))
    M1, M2 = chirp_large_split(N)
    return (B / np.float32(M)).astype(np.complex64).reshape(M2, M1).T.copy()


class ChirpLargeLayout(NamedTuple):
    """The kernel's layout at N."""
    N: int
    M1: int
    M2: int
    plan1: tuple    # M1's plan
    plan2: tuple    # M2's
    cols_a: int     # columns a pass-A tile
    rows_b: int     # rows a pass-B tile (two buffers of them)
    cols_c: int     # columns a pass-C tile
    xs1: int        # a column's stride (passes A and C)
    xs2: int        # a row's stride (pass B)

    @property
    def row(self) -> int:
        """A partial row: N rounded up to SUM_BINS."""
        return -(-self.N // SUM_BINS) * SUM_BINS

    @property
    def tiles(self) -> Tuple[int, int, int]:
        """Tiles a frame of passes A, B and C."""
        return (-(-self.M2 // self.cols_a), -(-self.M1 // self.rows_b),
                -(-self.M2 // self.cols_c))

    @property
    def smem(self) -> Tuple[int, int, int]:
        """Dynamic shared bytes a block of passes A, B and C."""
        return (self.cols_a * self.xs1 * 8, 2 * self.rows_b * self.xs2 * 8,
                self.cols_c * (self.xs1 * 8 + 4 * self.M1))


@functools.lru_cache(maxsize=64)
def chirp_large_layout(N: int) -> ChirpLargeLayout:
    """The kernel's layout at N bins."""
    if not fused_psd_chirp_large_eligible(N):
        raise ValueError(f"fused_psd_chirp_large does not take N={N}")
    m1, m2 = chirp_large_split(N)
    return ChirpLargeLayout(
        N, m1, m2, mixed_plan(m1), mixed_plan(m2),
        tile_count(m1, total=m2), tile_count(m2, buffers=2, total=m1),
        tile_count(m1, extra=4 * m1, total=m2), tile_stride(m1),
        tile_stride(m2))


@functools.lru_cache(maxsize=4)
def _plain_tables(N: int, device: torch.device):
    """The chirp a (N,), B / M in natural order (M,) and the inter-stage
    twiddle (M1, M2), complex64 on the device."""
    M, a, B = bluestein_constants(N, chirp_size(N))
    M1, M2 = chirp_large_split(N)
    return (torch.from_numpy(a).to(device),
            torch.from_numpy((B / np.float32(M)).astype(np.complex64))
            .to(device),
            torch.from_numpy(inter_twiddle(M, M1, M2)).to(device))


def chirp_large_dft_power(z: torch.Tensor) -> torch.Tensor:
    """|DFT|^2 along the last axis by the three passes in torch ops, with
    the kernel's tables: (..., N) complex64 -> (..., N) float32 (× a, zero
    to M; column DFTs, × W_M^(n2 k1); row DFTs, × B / M, conjugate, row
    DFTs, × W_M^(k1 m2); column DFTs; m < N, × a, |.|^2)."""
    lead, N = z.shape[:-1], z.shape[-1]
    F = z.reshape(-1, N).shape[0]
    M1, M2 = chirp_large_split(N)
    a, B, inter = _plain_tables(N, z.device)
    u = torch.zeros((F, M1 * M2), dtype=torch.complex64, device=z.device)
    u[:, :N] = z.reshape(F, N) * a
    y = torch.fft.fft(u.reshape(F, M1, M2), dim=1) * inter   # [f, k1, n2]
    Y = torch.fft.fft(y, dim=2)                              # [f, k1, k2]
    Z = torch.conj(Y * B.reshape(M2, M1).T)
    z = torch.fft.fft(Z, dim=2) * inter                      # [f, k1, m2]
    z = torch.fft.fft(z, dim=1)                              # [f, m1, m2]
    X = z.reshape(F, M1 * M2)[:, :N].conj() * a
    return (X.real * X.real + X.imag * X.imag).reshape(*lead, N)


def chirp_large_power(raw_u8: torch.Tensor,
                      window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """|DFT|^2 of every frame by :func:`chirp_large_dft_power`: (..., 2N)
    uint8, dequantized [and windowed] -> (..., N) float32."""
    N = raw_u8.shape[-1] // 2
    v = raw_u8.reshape(*raw_u8.shape[:-1], N, 2).to(torch.int32)
    re = (v[..., 0] - 127).to(torch.float32)
    im = (v[..., 1] - 127).to(torch.float32)
    if window is not None:
        re = re * window
        im = im * window
    return chirp_large_dft_power(torch.complex(re, im))


def chirp_large_reference(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                          window: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The plain PyTorch version: (F, 2N) uint8 -> (N,) float32, the three
    passes in torch ops with the kernel's tables (:func:`chirp_large_power`),
    frames f >= n_valid dropped, a two-stage sum."""
    F, two_n = raw_u8.shape
    pwr = chirp_large_power(raw_u8, window)
    pwr[n_valid:] = 0.0
    return pwr.reshape(F // chunk, chunk, two_n // 2).sum(dim=1).sum(dim=0)


def control_attributes(N: int, which: int,
                       device: Optional[torch.device] = None) -> dict:
    """What a pass of the control at N bins gets on the card (``which``:
    :data:`PASS_A`, :data:`PASS_A_WINDOWED`, :data:`PASS_B` or
    :data:`PASS_C`): registers and spill bytes a thread, static and
    dynamic shared bytes and threads a block, and the blocks that reside
    on one SM. Launches nothing."""
    t = chirp_large_layout(N)
    smem = t.smem[0 if which <= PASS_A_WINDOWED else which - 1]
    return tile_attributes("fused_psd_chirp_large",
                           "rpf_fused_psd_chirp_large_control_attributes",
                           which, smem, device)


@functools.lru_cache(maxsize=64)
def control_resident_blocks(N: int, which: int, index: int) -> int:
    """Blocks of a pass of the control at N bins that card ``index``
    holds at once. Asked of the card once per key."""
    return resident_of(control_attributes(N, which,
                                        torch.device("cuda", index)), index)


class _ControlPlan(NamedTuple):
    lib: ctypes.CDLL
    layout: ChirpLargeLayout
    groups: Tuple[int, int, int]   # frames a block of passes A, B, C
    rows: int                      # partial rows
    ints: Tuple[ctypes.Array, ctypes.Array]
    tables: Tuple[int, ...]        # tw1, order1, inter, chirp, tw2,
    keep: tuple                    # order2, spectrum; their tensors


_control_plans: dict = {}


def _control_plan(N: int, F: int, chunk: int, windowed: bool,
          device: torch.device) -> _Plan:
    key = (N, F, chunk, windowed, device.index)
    plan = _control_plans.get(key)
    if plan is None:
        from . import _build
        t = chirp_large_layout(N)
        M, a, _ = bluestein_constants(N, chirp_size(N))
        keep = (*device_plan_tables(t.plan1, device),
                torch.from_numpy(inter_twiddle(M, t.M1, t.M2)).to(device),
                torch.from_numpy(a).to(device),
                *device_plan_tables(t.plan2, device),
                torch.from_numpy(spectrum_table(N)).to(device))
        groups = tuple(
            large_group(F, tiles,
                        control_resident_blocks(N, which, device.index))
            for tiles, which in zip(t.tiles, (
                PASS_A_WINDOWED if windowed else PASS_A, PASS_B, PASS_C)))
        plan = _control_plans[key] = _ControlPlan(
            _build.load("fused_psd_chirp_large"), t, groups,
            -(-F // groups[2]), (plan_ints(t.plan1), plan_ints(t.plan2)),
            tuple(k.data_ptr() for k in keep), keep)
    return plan


def fused_psd_chirp_large_control(raw_u8: torch.Tensor, n_valid: int,
                                  chunk: int,
                                  window: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """The first form (the control), as :func:`fused_psd_chirp_large`;
    its launches and plain calls count in ``CONTROL_COUNTS``."""
    n_valid = int(n_valid)
    check_args("fused_psd_chirp_large_control",
               fused_psd_chirp_large_eligible, raw_u8, n_valid, chunk, window)
    if not _on_cuda("fused_psd_chirp_large_control", raw_u8):
        CONTROL_COUNTS.plain += 1
        return chirp_large_reference(raw_u8, n_valid, chunk, window)
    check_alignment("fused_psd_chirp_large_control", raw_u8, RAW_ALIGN,
                    window, WINDOW_ALIGN)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    device = raw_u8.device
    plan = _control_plan(N, F, chunk, window is not None, device)
    t = plan.layout
    stream = _raw_stream(device.index)
    scratch, partial = workspace(("BL control", N, F, plan.rows, device.index,
                                  stream), 2 * F * t.M1 * t.M2,
                                 plan.rows * t.row, device)
    out = torch.empty((t.row,), dtype=torch.float32, device=device)
    tw1, order1, inter, chirp, tw2, order2, spectrum = plan.tables
    err = plan.lib.rpf_fused_psd_chirp_large_control(
        raw_u8.data_ptr(), tw1, order1, inter, chirp,
        None if window is None else window.data_ptr(), tw2, order2,
        spectrum, scratch, partial, out.data_ptr(),
        ctypes.addressof(plan.ints[0]), ctypes.addressof(plan.ints[1]),
        device.index, N, F, t.cols_a, t.xs1, plan.groups[0], t.rows_b,
        t.xs2, plan.groups[1], t.cols_c, plan.groups[2], n_valid, stream)
    if err != 0:
        raise launch_error("fused_psd_chirp_large_control", plan.lib, err)
    if window is None:
        CONTROL_COUNTS.kernel_chirp_large += 1
    else:
        CONTROL_COUNTS.kernel_chirp_large_windowed += 1
    return out[:N]


# ---- The kernel: the register passes of fused_psd_large_regs.cuh. ----


class ChirpRegsLayout(NamedTuple):
    """The register passes' layout at N (``ChirpRegs<LOG2M>`` in the
    source, over the large kernel's :func:`.fused_psd_large.regs_layout`
    of M, ``regs``)."""
    N: int
    M: int
    regs: dict

    @property
    def log2m(self) -> int:
        return self.M.bit_length() - 1

    @property
    def rows_a(self) -> int:
        """Rows of pass A's ring slot: n1 < M1 / 2 (N <= M / 2)."""
        return self.regs["N1"] // 2

    @property
    def row(self) -> int:
        """A partial row: N rounded up to SUM_BINS."""
        return -(-self.N // SUM_BINS) * SUM_BINS

    @property
    def threads(self) -> Tuple[int, int, int]:
        """Threads a block of passes A, B and C."""
        r = self.regs
        return r["threads_a"], r["threads_b"], r["threads_a"]

    @property
    def tiles(self) -> Tuple[int, int, int]:
        """Tiles a frame of passes A, B and C (C: one batch a block)."""
        r = self.regs
        return r["tiles_a"], r["tiles_b"], r["N2"] // r["B"]

    @property
    def smem(self) -> Tuple[int, int, int]:
        """Dynamic shared bytes a block of passes A, B and C: A's exchange
        and a ring of two half slots; B's exchange rows (or, in the same
        bytes, a frame's runs, whichever is larger), its ring and an
        mbarrier; C's two exchanges."""
        r = self.regs
        xa = 8 * r["B"] * r["XS"]
        xb = 8 * r["B2"] * r["XS2"]
        slot_b = 8 * (r["N2"] // r["B"]) * r["GS"]
        return (xa + 2 * self.rows_a * 2 * r["C"],
                max(xb, slot_b) + slot_b + 8, 2 * xa)


@functools.lru_cache(maxsize=64)
def chirp_regs_layout(N: int) -> ChirpRegsLayout:
    """The register passes' layout at N bins."""
    if not fused_psd_chirp_large_eligible(N):
        raise ValueError(f"fused_psd_chirp_large does not take N={N}")
    M = chirp_size(N)
    return ChirpRegsLayout(N, M, regs_layout(M))


def chirp_regs_table(N: int) -> np.ndarray:
    """(M / 2,) complex64: the chirp a[n] as pass A reads it, value k < 8
    of thread tid of batch s of tile j at ((j SUBS + s) 8 + k) THREADS_A +
    tid, n = (row_of(tid) + k TF1) M2 + j C + s B + col_of(tid); 0 where
    n >= N."""
    t = chirp_regs_layout(N)
    r = t.regs
    _, a, _ = bluestein_constants(N, t.M)
    col, row = thread_map(t.M)
    j = np.arange(r["tiles_a"])[:, None, None, None]
    s = np.arange(r["subs"])[None, :, None, None]
    k = np.arange(8)[None, None, :, None]
    n = ((row[None, None, None, :] + k * r["TF1"]) * r["N2"] + j * r["C"]
         + s * r["B"] + col[None, None, None, :])
    padded = np.zeros(t.M, np.complex64)
    padded[:N] = a
    return padded[n].reshape(-1)


def spectrum_regs_table(N: int) -> np.ndarray:
    """(M1, M2) complex64: B[k1 + M1 k2] / M of row k1 at the element of
    k2 after the forward row passes (``element_of_bin`` of M2's pass plan),
    the order pass B's turn reads it in."""
    t = chirp_regs_layout(N)
    m2 = t.regs["N2"]
    natural = spectrum_table(N)
    out = np.empty_like(natural)
    out[:, element_of_bin(PASS_PLAN[m2], np.arange(m2))] = natural
    return out


def kernel_attributes(N: int, which: int,
                      device: Optional[torch.device] = None) -> dict:
    """What a register pass at N bins gets on the card (``which``:
    :data:`PASS_A`, :data:`PASS_A_WINDOWED`, :data:`PASS_B` or
    :data:`PASS_C`): :func:`.fused_psd_mixed_large.library_attributes`."""
    index = (device or torch.device(
        "cuda", torch.cuda.current_device())).index or 0
    log2m = chirp_regs_layout(N).log2m
    return library_attributes(
        "fused_psd_chirp_large", f"pass {which}",
        lambda lib, attrs: lib.rpf_fused_psd_chirp_large_attributes(
            log2m, which, index, attrs))


@functools.lru_cache(maxsize=64)
def resident_blocks(N: int, which: int, index: int) -> int:
    """Blocks of a register pass at N bins that card ``index`` holds at
    once. Asked of the card once per key."""
    return resident_of(kernel_attributes(N, which, torch.device("cuda", index)),
                     index)


def regs_grid(F: int, N: int, resident: Tuple[int, int, int]
              ) -> Tuple[int, int, int]:
    """Frames a block of passes A, B and C over F frames at N, from the
    blocks of each pass the card holds at once (:func:`.fused_psd_large.
    large_group`); pass C's sets the partial rows, ceil(F / group)."""
    return tuple(large_group(F, tiles, res) for tiles, res in
                 zip(chirp_regs_layout(N).tiles, resident))


class _Plan(NamedTuple):
    lib: ctypes.CDLL
    layout: ChirpRegsLayout
    groups: Tuple[int, int, int]   # frames a block of passes A, B, C
    tables: Tuple[int, ...]        # twiddle, inter, chirp, spectrum
    keep: tuple                    # their tensors


_plans: dict = {}


@functools.lru_cache(maxsize=8)
def device_tables(N: int, device: torch.device) -> tuple:
    """The register passes' tables at N on the device, as the entries take
    them: pass_twiddles(M1) then pass_twiddles(M2), W_M^(k1 n2) in
    scratch's order (:func:`.fused_psd_large.regs_inter_twiddle` of M), the
    chirp in the threads' order (:func:`chirp_regs_table`) and B / M by
    element (:func:`spectrum_regs_table`)."""
    t = chirp_regs_layout(N)
    m1, m2 = t.regs["N1"], t.regs["N2"]
    return tuple(torch.from_numpy(x).to(device) for x in (
        np.concatenate([pass_twiddles(m1), pass_twiddles(m2)]),
        regs_inter_twiddle(t.M), chirp_regs_table(N),
        spectrum_regs_table(N)))


def pass_residency(N: int, windowed: bool, index: int
                   ) -> Tuple[int, int, int]:
    """Blocks of passes A (windowed or not), B and C at N bins that card
    ``index`` holds at once: the grids' inputs (:func:`regs_grid`,
    :func:`streams_grid`)."""
    return tuple(resident_blocks(N, which, index) for which in (
        PASS_A_WINDOWED if windowed else PASS_A, PASS_B, PASS_C))


def _plan(N: int, F: int, windowed: bool, device: torch.device) -> _Plan:
    key = (N, F, windowed, device.index)
    plan = _plans.get(key)
    if plan is None:
        from . import _build
        t = chirp_regs_layout(N)
        keep = device_tables(N, device)
        groups = regs_grid(F, N, pass_residency(N, windowed, device.index))
        plan = _plans[key] = _Plan(
            _build.load("fused_psd_chirp_large"), t, groups,
            tuple(k.data_ptr() for k in keep), keep)
    return plan


def fused_psd_chirp_large(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                          window: Optional[torch.Tensor] = None,
                          group_c: Optional[int] = None) -> torch.Tensor:
    """(F, 2N) uint8 frames, N even in (8192, 2^21], ``n_valid`` real
    frames -> (N,) float32 sum of |DFT|^2 over those frames, on the
    tensor's device. ``window``: an (N,) float32 tensor on the same
    device, or None. ``group_c``: frames a pass-C block, where not the
    grid's own (the streams entry's, to compare a stream's row with this
    call's bits).

    A CUDA tensor runs the kernel on the current stream (asynchronously);
    a CPU tensor runs the plain version."""
    n_valid = int(n_valid)
    check_args("fused_psd_chirp_large", fused_psd_chirp_large_eligible,
               raw_u8, n_valid, chunk, window)
    if not _on_cuda("fused_psd_chirp_large", raw_u8):
        COUNTS.plain += 1
        return chirp_large_reference(raw_u8, n_valid, chunk, window)
    check_alignment("fused_psd_chirp_large", raw_u8, RAW_ALIGN, window,
                    WINDOW_ALIGN)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    device = raw_u8.device
    plan = _plan(N, F, window is not None, device)
    t = plan.layout
    groups = plan.groups if group_c is None else (*plan.groups[:2],
                                                  int(group_c))
    rows = -(-F // groups[2])
    stream = _raw_stream(device.index)
    scratch, partial = workspace(("BL", N, F, rows, device.index, stream),
                                 2 * F * t.M, rows * t.row if rows > 1 else 0,
                                 device)
    out = torch.empty((t.row,), dtype=torch.float32, device=device)
    twiddle, inter, chirp, spectrum = plan.tables
    err = plan.lib.rpf_fused_psd_chirp_large(
        raw_u8.data_ptr(), twiddle, inter,
        None if window is None else window.data_ptr(), chirp, spectrum,
        scratch, partial, out.data_ptr(), device.index, t.log2m, N,
        copy_width(N, raw_u8.data_ptr()), F, *groups, n_valid, stream)
    if err != 0:
        raise launch_error("fused_psd_chirp_large", plan.lib, err)
    if window is None:
        COUNTS.kernel_chirp_large += 1
    else:
        COUNTS.kernel_chirp_large_windowed += 1
    return out[:N]


def chirp_large_streams_reference(raw_u8: torch.Tensor,
                                  n_valid: torch.Tensor, chunk: int,
                                  window: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """The plain PyTorch version of BL-S: (S, F, 2N) uint8 frames, (S,)
    valid counts -> (S, N) float32, row s :func:`chirp_large_reference` of
    stream s's frames and count."""
    return per_stream_reference(chirp_large_reference, raw_u8, n_valid,
                                chunk, window)


def streams_grid(S: int, F: int, N: int, resident: Tuple[int, int, int]
                 ) -> Tuple[int, int, int]:
    """Frames a block of passes A, B and C over S streams of F frames at
    N: :func:`.fused_psd_large.large_group` with the S streams' tiles;
    pass C's sets each stream's partial rows, ceil(F / group)."""
    return tuple(large_group(F, S * tiles, res) for tiles, res in
                 zip(chirp_regs_layout(N).tiles, resident))


#: The streams entry's grid by (N, S, F, windowed, device).
_streams_grids: dict = {}


def fused_psd_chirp_large_streams(raw_u8: torch.Tensor,
                                  n_valid: torch.Tensor, chunk: int,
                                  window: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """BL-S: (S, F, 2N) uint8 frames of S streams, N even in (8192, 2^21],
    ``n_valid`` (S,) int32 real frames per stream on the frames' device
    -> (S, N) float32, row s the sum of |DFT|^2 over stream s's first
    n_valid[s] frames (a count outside [0, F] acts as its nearest bound).
    ``window``: an (N,) float32 tensor on the same device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously:
    the kernel reads ``n_valid`` from device memory when it runs); a CPU
    tensor runs the plain version."""
    check_streams_args(raw_u8, n_valid, chunk, window,
                       "fused_psd_chirp_large_streams",
                       fused_psd_chirp_large_eligible)
    if not _on_cuda("fused_psd_chirp_large_streams", raw_u8):
        COUNTS.plain += 1
        return chirp_large_streams_reference(raw_u8, n_valid, chunk, window)
    check_alignment("fused_psd_chirp_large_streams", raw_u8, RAW_ALIGN,
                    window, WINDOW_ALIGN)
    S, F, N = raw_u8.shape[0], raw_u8.shape[1], raw_u8.shape[2] // 2
    device = raw_u8.device
    windowed = window is not None
    plan = _plan(N, F, windowed, device)
    t = plan.layout
    key = (N, S, F, windowed, device.index)
    groups = _streams_grids.get(key)
    if groups is None:
        groups = _streams_grids[key] = streams_grid(
            S, F, N, pass_residency(N, windowed, device.index))
    rows = -(-F // groups[2])
    stream = _raw_stream(device.index)
    scratch, partial = workspace(
        ("BL", N, S * F, S * rows, device.index, stream), 2 * S * F * t.M,
        S * rows * t.row if rows > 1 else 0, device)
    out = torch.empty((S, t.row), dtype=torch.float32, device=device)
    twiddle, inter, chirp, spectrum = plan.tables
    err = plan.lib.rpf_fused_psd_chirp_large_streams(
        raw_u8.data_ptr(), twiddle, inter,
        None if window is None else window.data_ptr(), chirp, spectrum,
        n_valid.data_ptr(), scratch, partial, out.data_ptr(), device.index,
        t.log2m, N, copy_width(N, raw_u8.data_ptr()), S, F, *groups, stream)
    if err != 0:
        raise launch_error("fused_psd_chirp_large_streams", plan.lib, err)
    if window is None:
        COUNTS.kernel_chirp_large_streams += 1
    else:
        COUNTS.kernel_chirp_large_streams_windowed += 1
    return out[:, :N]
