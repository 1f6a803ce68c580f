"""Fused averaged-PSD step at relaxed precision (``--precision high``).

Replaces ``rtl_power_fftw_tpu/ops/kernels/fused_psd.py:make_fused_psd_fn``
with ``fast=True`` (K3), windowed or not, with a CUDA C++ kernel for
Hopper tensor cores (``csrc/fused_psd_fast.cu``, its group kernel
``csrc/fused_psd_fast_smem.cuh``). It computes the JAX
package's fast scheme, a four-step DFT N = N1·N2 (input index
n = N2·n1 + n2, bin k = k1 + N1·k2) as bf16 products with f32 sums:

1. stage 1, a length-N1 DFT: the dequantized integers (exact in bf16)
   times a 3-term bf16 split of the weights; with a window, a runtime
   3-term split of the windowed f32 input times the 3-term weights with
   the i + j >= 3 cross terms dropped;
2. the twiddle W_N^(n2·k1) in f32;
3. stage 2, a length-N2 DFT as a Karatsuba of 3 real products, each a
   2-term split of its f32 input times a 2-term split of the weights
   with z1·c1 dropped (z0c0 + z0c1 + z1c0);
4. |X|^2, the frame mask and the sum over frames.

The split is re-derived for the card (:func:`fast_split`), and the
constants are built without ``ml_dtypes``: float64 values are rounded to
bf16 by bit arithmetic in numpy (:func:`bf16_bits`), through float32 as
``ml_dtypes`` rounds them, so they equal the JAX package's
``_constants`` bit for bit. The constants and the split
of the input are what the two implementations share; the plain PyTorch
version :func:`fused_psd_fast_reference` widens each bf16 term to f32
before ``torch.matmul``, which reproduces bf16 x bf16 -> f32 products
exactly, so it differs from the kernel only in the order of f32 sums.

:func:`fused_psd_fast` dispatches on the tensor's device like
:func:`~.fused_psd.fused_psd`: CPU tensor -> plain version, CUDA tensor
-> the kernel or an exception. :data:`COUNTS` counts both.

The kernel keeps the stage weights resident in shared memory where they
fit from 1024 bins (:data:`SMEM_PLAN`, :func:`smem_layout`), copied once
a block in the register-major B-fragment order of
:func:`pack_b_ldmatrix` (stage 1 as the six distinct blocks of
:func:`smem_constants`, from which every K-stack block of WR and WI
follows), stages Z once as six bf16 split planes (their rows swizzled,
not padded), copies the next frame while the current one is computed,
and gives each block as many frames as put the grid within one resident
wave (:func:`~.fused_psd.k1_group` with :func:`resident_blocks`). Its
host path does the least it can a call: the grid and the operands'
pointers are cached per (N, F, chunk, windowed, device), the partial
rows per (N, rows, device, stream), so a call allocates only its output.
The kernel it replaced stays as the control,
:func:`fused_psd_fast_control` (counted in :data:`CONTROL_COUNTS`), and
its cuts, :func:`fused_psd_fast_cut`, give its stage split;
``chip_smoke.py`` alone calls either.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .fused_psd import (KernelLaunchError, LaunchCounts, _on_cuda,
                        check_alignment, check_args, frames_per_block,
                        k1_group)
from .fused_psd_large import _raw_stream

#: Eligible sizes: powers of two whose split N1 x N2 has both factors
#: multiples of 16 (the bf16 mma tile depth) and whose frame's state
#: fits the shared memory of one block (:func:`smem_layout`: 224 KB at
#: 16384 windowed, its Z in four passes). Kept in step with
#: kMinLog2N/kMaxLog2N in the source.
MIN_N = 256
MAX_N = 16384

#: Launches of the kernel and calls of the plain version, counted by
#: :func:`fused_psd_fast` only.
COUNTS = LaunchCounts()
#: The same for the control, :func:`fused_psd_fast_control`, and the
#: kernel's cuts, :func:`fused_psd_fast_cut`.
CONTROL_COUNTS = LaunchCounts()
CUT_COUNTS = LaunchCounts()


def fused_psd_fast_eligible(N: int) -> bool:
    """True iff the tensor-core kernel takes N bins."""
    return MIN_N <= N <= MAX_N and (N & (N - 1)) == 0


def fast_split(N: int) -> Tuple[int, int]:
    """N = N1·N2 with N1 = 2^floor(log2(N) / 2) and N2 = N / N1 >= N1:
    16x16 at 256, 32x64 at 2048, 64x128 at 8192, 128x128 at 16384. Both
    factors are multiples of 16, the depth of one bf16 ``mma.sync``."""
    n1 = 1 << ((int(N).bit_length() - 1) // 2)
    return n1, N // n1


# --- constants (a port of fused_psd.py:_bf16_terms and _constants) ---

def bf16_bits(x: np.ndarray) -> np.ndarray:
    """Bit patterns (uint16) of float64 ``x`` rounded to bfloat16 as
    ``ml_dtypes`` rounds it: to float32, then to bfloat16, each to
    nearest, ties to even. The two roundings differ from one only near a
    bf16 tie (pinned by a test), and they make the split terms equal the
    JAX package's bit for bit. Finite values only."""
    f = np.ascontiguousarray(x, np.float64).astype(np.float32).view(np.uint32)
    lsb = (f >> np.uint32(16)) & np.uint32(1)
    return ((f + np.uint32(0x7FFF) + lsb) >> np.uint32(16)).astype(np.uint16)


def bf16_value(bits: np.ndarray) -> np.ndarray:
    """float32 values of bf16 bit patterns (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32)
            << np.uint32(16)).view(np.float32)


def bf16_terms(w: np.ndarray, k: int) -> np.ndarray:
    """Split float64 ``w`` into ``k`` bf16 terms by successive rounding;
    (k, *w.shape) uint16 bit patterns."""
    terms = []
    r = np.asarray(w, np.float64)
    for _ in range(k):
        t = bf16_bits(r)
        terms.append(t)
        r = r - bf16_value(t).astype(np.float64)
    return np.stack(terms)


@functools.lru_cache(maxsize=16)
def constants(N: int, N1: int, N2: int, windowed: bool):
    """(WR, WI, twr, twi, w2r, w2i, w2s), as ``_constants`` builds them:
    WR/WI the (6·N1 or 12·N1, N1) K-stacked stage-1 weights and w2* the
    (3, N2, N2) stage-2 terms, as bf16 bit patterns (uint16); twr/twi
    the (N2, N1) float32 twiddle W_N^(n2·k1)."""
    def dft(n):
        a = np.arange(n, dtype=np.float64)
        ang = -2.0 * np.pi * (np.outer(a, a) % n) / n
        return np.cos(ang), np.sin(ang)

    w1r, w1i = dft(N1)
    w2r, w2i = dft(N2)
    n2 = np.arange(N2, dtype=np.float64)[:, None]
    k1 = np.arange(N1, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * ((n2 * k1) % N) / N
    twr = np.cos(ang).astype(np.float32)
    twi = np.sin(ang).astype(np.float32)
    r = bf16_terms(w1r, 3)
    i = bf16_terms(w1i, 3)
    neg = np.uint16(0x8000)  # bf16 negation flips the sign bit
    # Input blocks [a0 a0 a0 a1 a1 a2] (windowed) meet weight terms:
    order = (0, 1, 2, 0, 1, 0) if windowed else (0, 1, 2)
    WR = np.vstack([m for j in order for m in (r[j], i[j] ^ neg)])
    WI = np.vstack([m for j in order for m in (i[j], r[j])])
    return (WR, WI, twr, twi, bf16_terms(w2r, 3), bf16_terms(w2i, 3),
            bf16_terms(w2r + w2i, 3))


def input_planes(windowed: bool) -> Tuple[int, ...]:
    """Which input plane each K-stack block of stage 1 multiplies:
    unwindowed planes (ar, ai), windowed (a0r, a0i, a1r, a1i, a2r, a2i);
    block b meets rows b·N1 .. (b+1)·N1 of WR/WI."""
    if not windowed:
        return (0, 1) * 3
    return (0, 1) * 3 + (2, 3) * 2 + (4, 5)


# --- the plain version ---

def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 (nearest even) -> f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _split3(x: torch.Tensor):
    z0 = _bf16_round(x)
    r1 = x - z0
    z1 = _bf16_round(r1)
    return z0, z1, _bf16_round(r1 - z1)


@functools.lru_cache(maxsize=16)
def _plain_constants(N: int, N1: int, N2: int, windowed: bool,
                     device: torch.device):
    WR, WI, twr, twi, w2r, w2i, w2s = constants(N, N1, N2, windowed)
    return tuple(torch.from_numpy(bf16_value(c) if c.dtype == np.uint16
                                  else c).to(device)
                 for c in (WR, WI, twr, twi, w2r, w2i, w2s))


def fused_psd_fast_reference(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                             window: Optional[torch.Tensor] = None,
                             n1: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version: (F, 2N) uint8 -> (N,) float32, a
    transcription of ``_kernel(fast=True)`` (fused_psd.py:217-350)."""
    F, two_n = raw_u8.shape
    N = two_n // 2
    N1, N2 = fast_split(N) if n1 is None else (n1, N // n1)
    windowed = window is not None
    WR, WI, twr, twi, w2r, w2i, w2s = _plain_constants(
        N, N1, N2, windowed, raw_u8.device)
    # (F, N1, N2) [n = N2·n1 + n2] -> (F, N2, N1): rows n2, columns n1.
    v = raw_u8.reshape(F, N1, N2, 2).transpose(1, 2).to(torch.int32)
    re = (v[..., 0] - 127).to(torch.float32)
    im = (v[..., 1] - 127).to(torch.float32)
    if not windowed:
        planes = (re, im)           # integers, exact in bf16
    else:
        w = window.to(torch.float32).reshape(N1, N2).t()
        planes = tuple(p for pair in zip(_split3(re * w), _split3(im * w))
                       for p in pair)
    lhs = torch.cat([planes[p] for p in input_planes(windowed)],
                    dim=-1).reshape(F * N2, -1)
    yr = (lhs @ WR).reshape(F, N2, N1)
    yi = (lhs @ WI).reshape(F, N2, N1)
    zr = yr * twr - yi * twi
    zi = yr * twi + yi * twr
    zr = zr.transpose(1, 2).reshape(F * N1, N2)
    zi = zi.transpose(1, 2).reshape(F * N1, N2)
    zs = zr + zi

    def stage2(z, w2):
        z0 = _bf16_round(z)
        z1 = _bf16_round(z - z0)
        return z0 @ w2[0] + z0 @ w2[1] + z1 @ w2[0]

    u1, u2, u3 = stage2(zr, w2r), stage2(zi, w2i), stage2(zs, w2s)
    xr = u1 - u2
    xi = u3 - u1 - u2
    pwr = (xr * xr + xi * xi).reshape(F, N1, N2)
    pwr[n_valid:] = 0.0
    s = pwr.reshape(F // chunk, chunk, N1, N2).sum(dim=1).sum(dim=0)
    return s.t().reshape(N)        # (k2, k1) row-major = bin order


# --- the kernel's operands ---

def pack_b_fragments(bits: np.ndarray) -> np.ndarray:
    """A (K, C) bf16 matrix as ``mma.m16n8k16`` B fragments:
    (K/16, C/8, 32, 4) uint16, where lane l of tile (kc, nt) holds rows
    16kc + (2t, 2t+1, 2t+8, 2t+9) of column 8nt + g (g = l >> 2,
    t = l & 3), i.e. its two 32-bit B registers, low half first."""
    K, C = bits.shape
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    rows = np.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], axis=-1)
    kc = np.arange(K // 16)[:, None, None, None]
    nt = np.arange(C // 8)[None, :, None, None]
    return np.ascontiguousarray(
        bits[16 * kc + rows[None, None], 8 * nt + g[None, None, :, None]])


def kernel_constants(N: int, windowed: bool):
    """The kernel's constant operands as numpy arrays: (w1r, w1i,
    twiddle, w2) = the stage-1 WR/WI as B fragments, the (N2, N1, 2)
    twiddle as interleaved (re, im) float32, and the six stage-2 B
    fragment planes (w2r0, w2r1, w2i0, w2i1, w2s0, w2s1) stacked."""
    N1, N2 = fast_split(N)
    WR, WI, twr, twi, w2r, w2i, w2s = constants(N, N1, N2, windowed)
    w2 = np.stack([pack_b_fragments(m[j]) for m in (w2r, w2i, w2s)
                   for j in (0, 1)])
    return (pack_b_fragments(WR), pack_b_fragments(WI),
            np.stack([twr, twi], axis=-1), w2)


#: Shared-memory plan of the kernel by N (``kSmemPlan`` in
#: ``csrc/fused_psd_fast_smem.cuh``): for the unwindowed and then the
#: windowed instantiation, (warps a block, stage-1 weights resident,
#: stage-2 weights resident, Z passes).
SMEM_PLAN = {256: ((1, 0, 0, 1), (1, 0, 0, 1)),
             512: ((2, 0, 0, 1), (2, 0, 0, 1)),
             1024: ((4, 1, 1, 1), (4, 1, 1, 1)),
             2048: ((8, 1, 1, 1), (8, 1, 1, 1)),
             4096: ((16, 1, 1, 1), (16, 1, 1, 1)),
             8192: ((16, 1, 0, 1), (16, 1, 0, 1)),
             16384: ((16, 0, 0, 2), (16, 0, 0, 4))}

#: Alignment of the kernel's copies: the frames by 16-byte cp.async, the
#: window read as floats, the resident weights by bulk copies (16 bytes;
#: the wrapper's own tensors, checked when a plan is made).
RAW_ALIGN = 16
WINDOW_ALIGN = 4
BULK_ALIGN = 16


def pack_b_ldmatrix(bits: np.ndarray) -> np.ndarray:
    """:func:`pack_b_fragments` in the kernel's register-major order:
    (K/16, C/8, 2, 32, 2) uint16, tile (kc, nt) the 32 lanes' first B
    register (rows 2t, 2t + 1 of column g) and then their second (rows
    2t + 8, 2t + 9), each 128 contiguous bytes, so that one ldmatrix.x4
    reads the B fragments of two adjacent tiles."""
    K, C = bits.shape
    frag = pack_b_fragments(bits).reshape(K // 16, C // 8, 32, 2, 2)
    return np.ascontiguousarray(frag.transpose(0, 1, 3, 2, 4))


def smem_constants(N: int, windowed: bool):
    """The kernel's constant operands as numpy arrays: (w1, twiddle, w2)
    in :func:`pack_b_ldmatrix`'s order: w1 the six distinct stage-1
    blocks [r0; -i0; r1; -i1; r2; -i2] (the unwindowed WR, from which the
    kernel takes every block of WR and WI, windowed or not: WR's block
    2m + s is w1 block 2j + s and WI's is w1 block 2j + 1 - s, its sign
    flipped where s = 0, for the term j of pair m), the twiddle as
    :func:`kernel_constants`, and the six stage-2 planes."""
    N1, N2 = fast_split(N)
    _, _, twr, twi, w2r, w2i, w2s = constants(N, N1, N2, windowed)
    w2 = np.stack([pack_b_ldmatrix(m[j]) for m in (w2r, w2i, w2s)
                   for j in (0, 1)])
    return (pack_b_ldmatrix(constants(N, N1, N2, False)[0]),
            np.stack([twr, twi], axis=-1), w2)


def smem_layout(N: int, windowed: bool) -> dict:
    """The kernel's shapes at N (``SmemK3`` in the source): warps and
    threads a block, which stage weights are resident, the Z passes (ZP),
    the k1 columns of a pass (N1Z), items a warp a pass (IPW), and the
    shared-memory offsets and bytes of each part: [w1 | six stage-2
    planes | six Z planes | two raw slots | window | mbarrier]; a raw
    slot keeps the frame's N1 rows of N2 u16 samples RING_ROW bytes
    apart, the window its rows WIN_ROW floats apart."""
    N1, N2 = fast_split(N)
    warps, s1, s2, zp = SMEM_PLAN[N][int(windowed)]
    w1 = 6 * N1 * N1 * 2
    w2 = N2 * N2 * 2
    n1z = N1 // zp
    off_w2 = w1 if s1 else 0
    off_z = off_w2 + (6 * w2 if s2 else 0)
    off_ring = off_z + 6 * N2 * n1z * 2
    ring_row = 2 * N2 + 16
    win_row = N2 + 4
    off_win = off_ring + 2 * N1 * ring_row
    off_bar = off_win + (4 * N1 * win_row if windowed else 0)
    items = N // 256
    return {"N1": N1, "N2": N2, "warps": warps, "threads": 32 * warps,
            "min_blocks": 512 // (32 * warps), "s1": bool(s1),
            "s2": bool(s2), "ZP": zp, "N1Z": n1z, "items": items,
            "IPP": items // zp, "IPW": items // zp // warps,
            "row_chunks": n1z // 8, "W1_BYTES": w1, "W2_BYTES": w2,
            "ZPLANE": N2 * n1z, "RING_ROW": ring_row, "WIN_ROW": win_row,
            "SLOT": N1 * ring_row, "OFF_W2": off_w2, "OFF_Z": off_z,
            "OFF_RING": off_ring, "OFF_WIN": off_win, "OFF_BAR": off_bar,
            "bytes": off_bar + 16, "resident": off_z,
            "copies": 2 * N // 16 // (32 * warps)}


@functools.lru_cache(maxsize=16)
def _device_operands(N: int, windowed: bool, device: torch.device,
                     smem: bool = False):
    make = smem_constants if smem else kernel_constants
    return tuple(torch.from_numpy(np.ascontiguousarray(
        a.view(np.int16) if a.dtype == np.uint16 else a)).to(device)
        for a in make(N, windowed))


def kernel_attributes(N: int, windowed: bool = False,
                      device: Optional[torch.device] = None) -> dict:
    """What the kernel gets at N bins (windowed: its windowed
    instantiation) on the card: registers and spill bytes a thread,
    static and dynamic shared bytes and threads a block, and the blocks
    that reside on one SM. Launches nothing."""
    if not fused_psd_fast_eligible(N):
        raise ValueError(f"fused_psd_fast does not take N={N}")
    device = device or torch.device("cuda", torch.cuda.current_device())
    from . import _build
    lib = _build.load("fused_psd_fast")
    attrs = (ctypes.c_int * 6)()
    err = lib.rpf_fused_psd_fast_attributes(N.bit_length() - 1,
                                            int(windowed), device.index or 0,
                                            attrs)
    if err != 0:
        raise KernelLaunchError(
            f"fused_psd_fast attributes at N={N}: "
            f"{lib.rpf_cuda_error_string(err).decode()} (cudaError {err})")
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "dynamic_smem", "threads", "blocks_per_sm"), attrs))


@functools.lru_cache(maxsize=64)
def resident_blocks(N: int, windowed: bool, index: int) -> int:
    """Blocks of the kernel at N bins that card ``index`` holds at once:
    its SMs times the blocks one SM holds, as
    cudaOccupancyMaxActiveBlocksPerMultiprocessor gives them
    (:func:`kernel_attributes`). Asked of the card once per key."""
    device = torch.device("cuda", index)
    per_sm = kernel_attributes(N, windowed, device)["blocks_per_sm"]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * max(1, per_sm)


class _Plan(NamedTuple):
    """What a call of :func:`fused_psd_fast` needs beyond its arguments,
    cached per (N, F, chunk, windowed, device): the library, the grid
    (:func:`~.fused_psd.k1_group` with this kernel's occupancy) and the
    constant operands (kept alive here) with
    their pointers."""
    lib: ctypes.CDLL
    log2n: int
    group: int
    rows: int
    w1: int
    twiddle: int
    w2: int
    operands: tuple


_plans: dict = {}
#: Partial rows by (N, rows, device, stream), the newest few: the kernel
#: is stream-ordered, so a later call on the same stream may reuse them,
#: and a dropped buffer goes back to the allocator on its stream.
_workspaces: collections.OrderedDict = collections.OrderedDict()
_WORKSPACES = 4


def _plan(N: int, F: int, chunk: int, windowed: bool,
          device: torch.device) -> _Plan:
    key = (N, F, chunk, windowed, device.index)
    plan = _plans.get(key)
    if plan is None:
        from . import _build
        ops = _device_operands(N, windowed, device, smem=True)
        for t in (ops[0], ops[2]):
            if t.data_ptr() % BULK_ALIGN:
                raise ValueError("fused_psd_fast: weights must be "
                                 f"{BULK_ALIGN}-byte aligned for the bulk "
                                 "copies")
        group = k1_group(F, chunk, resident_blocks(N, windowed,
                                                   device.index))
        plan = _plans[key] = _Plan(
            _build.load("fused_psd_fast"), N.bit_length() - 1, group,
            -(-F // group), ops[0].data_ptr(), ops[1].data_ptr(),
            ops[2].data_ptr(), ops)
    return plan


def _workspace(N: int, rows: int, device: torch.device, stream: int) -> int:
    """A pointer to (rows, N) float32 partial rows."""
    key = (N, rows, device.index, stream)
    buf = _workspaces.get(key)
    if buf is None:
        buf = torch.empty(rows * N, dtype=torch.float32, device=device)
        _workspaces[key] = buf
        while len(_workspaces) > _WORKSPACES:
            _workspaces.popitem(last=False)
    else:
        _workspaces.move_to_end(key)
    return buf.data_ptr()


def _raise(lib, kernel: str, err: int) -> None:
    raise KernelLaunchError(
        f"{kernel} launch failed: "
        f"{lib.rpf_cuda_error_string(err).decode()} (cudaError {err})")


def fused_psd_fast(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                   window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(F, 2N) uint8 frames -> (N,) float32 sum of |DFT|^2 over the first
    ``n_valid`` frames, at relaxed precision, on the tensor's device.
    ``window``: an (N,) float32 tensor on the same device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously);
    a CPU tensor runs the plain version."""
    n_valid = int(n_valid)
    check_args("fused_psd_fast", fused_psd_fast_eligible, raw_u8, n_valid,
               chunk, window)
    if not _on_cuda("fused_psd_fast", raw_u8):
        COUNTS.plain += 1
        return fused_psd_fast_reference(raw_u8, n_valid, chunk, window)
    check_alignment("fused_psd_fast", raw_u8, RAW_ALIGN, window,
                    WINDOW_ALIGN)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    device = raw_u8.device
    plan = _plan(N, F, chunk, window is not None, device)
    stream = _raw_stream(device.index)
    partial = _workspace(N, plan.rows, device, stream)
    out = torch.empty(N, dtype=torch.float32, device=device)
    err = plan.lib.rpf_fused_psd_fast(
        raw_u8.data_ptr(), None if window is None else window.data_ptr(),
        plan.w1, plan.twiddle, plan.w2, partial, out.data_ptr(),
        device.index, plan.log2n, F, plan.group, n_valid, stream)
    if err != 0:
        _raise(plan.lib, "fused_psd_fast", err)
    COUNTS.kernel += 1
    return out


#: Cuts of the kernel at N = 2048 (``kK3Cut*`` in the source), its stage
#: split: the frame's copies and the stage-1 gather; also stage 1, the
#: twiddle and Z's planes.
CUT_GATHER, CUT_STAGE1 = 1, 2


def fused_psd_fast_cut(cut: int, raw_u8: torch.Tensor, n_valid: int,
                       chunk: int, window: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """A cut of the kernel (:data:`CUT_GATHER`, :data:`CUT_STAGE1`) on a
    CUDA tensor at N = 2048, on :func:`fused_psd_fast`'s grid: the work up
    to the cut, whose sums it writes (not a spectrum). Timed by
    ``chip_smoke.py`` for the stage split; counted in
    :data:`CUT_COUNTS`."""
    n_valid = int(n_valid)
    check_args("fused_psd_fast_cut", lambda n: n == 2048, raw_u8, n_valid,
               chunk, window)
    if cut not in (CUT_GATHER, CUT_STAGE1) or not _on_cuda(
            "fused_psd_fast_cut", raw_u8):
        raise ValueError("fused_psd_fast_cut takes cut 1 or 2 of a CUDA "
                         "tensor")
    check_alignment("fused_psd_fast_cut", raw_u8, RAW_ALIGN, window,
                    WINDOW_ALIGN)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    device = raw_u8.device
    plan = _plan(N, F, chunk, window is not None, device)
    stream = _raw_stream(device.index)
    partial = _workspace(N, plan.rows, device, stream)
    out = torch.empty(N, dtype=torch.float32, device=device)
    err = plan.lib.rpf_fused_psd_fast_cut(
        cut, raw_u8.data_ptr(),
        None if window is None else window.data_ptr(), plan.w1,
        plan.twiddle, plan.w2, partial, out.data_ptr(), device.index,
        plan.log2n, F, plan.group, n_valid, stream)
    if err != 0:
        _raise(plan.lib, "fused_psd_fast_cut", err)
    CUT_COUNTS.kernel += 1
    return out


def fused_psd_fast_control(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                           window: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The control: the kernel :func:`fused_psd_fast` replaced
    (``rpf_fused_psd_fast_control``, the template of
    ``csrc/fused_psd_fast.cuh``), with the wrapper it had, on
    :func:`~.fused_psd.frames_per_block`'s grid. Timed beside the kernel
    by ``chip_smoke.py``; the main path never calls it. A CPU tensor runs
    the plain version. Counted in :data:`CONTROL_COUNTS`."""
    n_valid = int(n_valid)
    check_args("fused_psd_fast_control", fused_psd_fast_eligible, raw_u8,
               n_valid, chunk, window)
    if not _on_cuda("fused_psd_fast_control", raw_u8):
        CONTROL_COUNTS.plain += 1
        return fused_psd_fast_reference(raw_u8, n_valid, chunk, window)
    # 16-byte (uint4) frame copies; the window as single floats.
    check_alignment("fused_psd_fast_control", raw_u8, 16, window, 4)
    from . import _build
    lib = _build.load("fused_psd_fast")
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    group = frames_per_block(F, chunk)
    device = raw_u8.device
    w1r, w1i, tw, w2 = _device_operands(N, window is not None, device)
    partial = torch.empty((-(-F // group), N), dtype=torch.float32,
                          device=device)
    out = torch.empty(N, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device)
    err = lib.rpf_fused_psd_fast_control(
        raw_u8.data_ptr(), None if window is None else window.data_ptr(),
        w1r.data_ptr(), w1i.data_ptr(), tw.data_ptr(), w2.data_ptr(),
        partial.data_ptr(), out.data_ptr(), device.index,
        N.bit_length() - 1, F, group, n_valid, stream.cuda_stream)
    if err != 0:
        _raise(lib, "fused_psd_fast_control", err)
    CONTROL_COUNTS.kernel += 1
    return out
