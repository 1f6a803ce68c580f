"""Stage-attribution and stage-2 probes of K3 and K1 on Hopper, and P12's
relayouts.

Replaces the TPU probes that asked where the fused kernel's time goes:
P1 (``probes/profile_pallas.py:build``, ``pallas_call`` at 115), P18
(``probes/s1_lanes.py:build``, 151), P13 (``probes/s1_lanes2.py:build``,
156) and P12 (``probes/cast_test.py:try_cast``, 16), and those that
restructured its stage 2: P14 (``probes/s2_fourmult.py:build``, 132), P16
(``probes/s2_left.py:build``, 171), P19 (``probes/s2_ilv.py:build``, 117)
and P11 (``probes/s2_pipe.py:build``, 150), with hand-written CUDA C++ for
sm_90a (``csrc/fused_psd_probe.cu``). On this card the TPU probes' bf16
four-step scheme is K3, so each TPU variant becomes one compile-time
variant of K3's template (``csrc/fused_psd_fast.cuh``); K1's cuts
(``csrc/fused_psd.cuh``) ask P1's question of the FP32 radix-2 kernel.
All run at the probes' N = 2048 on raw interleaved u8 IQ, at K3's own
split N1 x N2 = 32 x 64 (the TPU probes ran 16 x 128). The stage-2 probes
start from the TPU's shipping 6-product scheme, ``tpu6`` here; their
``base``/``v6`` is it, and each other TPU variant is a variant of it:
``tpu6_4mult`` (P14 v7), ``tpu6_e2``, ``tpu6_left``, ``tpu6_e2left``
(P16), ``tpu6_ilv2``, ``tpu6_ilv4`` (P19) and ``tpu6_pipe`` (P11). The
schedules (ilv, pipe) compute tpu6's arithmetic in another order of
frames and phases, so their plain version is tpu6's and their output
must equal tpu6's bit for bit.

:data:`VARIANTS` is the registry: each Hopper variant, the TPU probe
variants it stands for (two TPU names that became one Hopper variant are
listed against it), its parity class, and the work its bound counts.
:data:`PROBES` maps each TPU probe's variant names to them. Beside every
variant is its plain PyTorch version (:func:`fused_psd_probe_reference`),
which defines the variant's output; ``fused_psd_fast_reference`` is its
base. The outputs, all (N,) float32 summed over the frames < n_valid:

- whole-step variants: |X|^2 in bin order, as K3 (``k3`` is K3 itself;
  ``tpu6_e2``/``tpu6_e2left`` multiply the raw bytes in stage 1 and
  subtract :func:`e2_offsets` after it, ``tpu6_4mult`` multiplies by
  :func:`fourmult_weights`, the ``left`` forms contract n2 from the left);
  ``nomm`` and the cuts after stage 1, the twiddle and the Z store: the
  sums of |Y|^2 or |Z|^2 in (n2, k1) order, index n2*N1 + k1;
- the gather and dequantization cuts: the sum of every value the kernel
  gathers (each element N1/16 times, once for each column block of
  stage 1), raw u16 values or dequantized re + im, in every bin (the TPU
  probes' ``consume``, ``probes/s1_lanes2.py:52-60``);
- K1's cuts: ``k1_full`` is K1; ``k1_nofft`` the sum of |x[n]|^2 and
  ``k1_dqonly`` of re + im of each sample n, in natural order.

:func:`fused_psd_probe` and :func:`relayout` dispatch on the tensor's
device: a CPU tensor runs the plain version, a CUDA tensor the kernel or
an exception. :data:`COUNTS` counts launches (and plain calls) by
variant. A cut does less than the kernel it is subtracted from and so
may fit more blocks on an SM: ``blocks_per_sm`` pins a launch to the
whole kernel's occupancy, and :func:`probe_attributes` reports what a
variant gets (registers, spill, shared memory, resident blocks). A
variant of ``chains`` > 1 takes a block's frames that many at a time, so
its frames per block must be a multiple of them (:func:`block_frames`).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import fused_psd_fast as ff
from .fused_psd import (KernelLaunchError, _device_twiddles, check_alignment,
                        check_args, frames_per_block, fused_psd_reference)

#: The probes' transform size and K3's split of it.
N = 2048
N1, N2 = ff.fast_split(N)

# Cut points and input layouts of K3's template (fused_psd_fast.cuh).
CUT_FULL, CUT_GATHER, CUT_DEQUANT, CUT_STAGE1, CUT_TWIDDLE, CUT_ZSTORE = \
    range(6)
IN_RAW, IN_BF16, IN_WIDE32, IN_PAIR32, IN_LINEAR = range(5)
# Stage-2 forms (kS2Karatsuba, kS2FourMult, kS2Left).
KARATSUBA, FOURMULT, LEFT = "karatsuba", "fourmult", "left"

# Tolerances against the plain version, per bin, relative. K3-scheme
# outputs: the same bf16 terms and products, only the order of f32 sums
# differs (tensor-core accumulation against cuBLAS f32), as K3's own
# bound in chip_smoke.py. Sums of gathered values and K1's cuts: exact
# integer sums in f32 and float64, rounded once per block partial (raw u16
# sums exceed 2^24 in a block).
RTOL_SCHEME = 2e-5
RTOL_SUMS = 1e-6
# K1 against its plain version (cuFFT): chip_smoke.py's UNIFORM_RTOL.
RTOL_K1 = 1e-5


@dataclasses.dataclass(frozen=True)
class Variant:
    """One Hopper variant: of K3's template (``kernel`` "k3") or a cut of
    K1 ("k1"). ``parity``: the kernel's output must equal the named
    shipping kernel's or variant's bit for bit ("K3", "K1", "tpu6"), or
    only its plain version's within ``rtol`` ("plain"). ``psd``: the
    output is a power spectrum, held to the float64 golden by the probe
    entry points."""
    name: str
    code: int
    kernel: str
    tpu: Tuple[str, ...]
    parity: str
    rtol: float
    psd: bool = False
    s1_terms: int = 3
    s2_products: int = 3
    twiddle: bool = True
    cut: int = CUT_FULL
    layout: int = IN_RAW
    s2_planes: bool = False
    k1_cut: str = "full"
    s2_form: str = KARATSUBA
    raw_bytes: bool = False
    chains: int = 1
    pipeline: bool = False

    def work(self, F: int) -> Tuple[float, float, float]:
        """(bytes, bf16 tensor-core flops, FP32 ops) of one step over F
        frames: the work its bound counts (:func:`k3_work`,
        :func:`k1_work`). A schedule (chains, pipeline) does its scheme's
        work."""
        if self.kernel == "k1":
            return k1_work(F, N, self.k1_cut)
        return k3_work(F, N, self.s1_terms, self.s2_products, self.twiddle,
                       self.cut, s2_form=self.s2_form,
                       raw_bytes=self.raw_bytes)


def k3_work(F: int, n: int, s1_terms: int = 3, s2_products: int = 3,
            twiddle: bool = True, cut: int = CUT_FULL,
            windowed: bool = False, s2_form: str = KARATSUBA,
            raw_bytes: bool = False) -> Tuple[float, float, float]:
    """(bytes, bf16 tensor-core flops, FP32 ops) of K3's step, or of a cut
    of it, over F frames of n bins. Bytes: each input read once (the
    frames, the window, the stage-1 weights, twiddle and stage-2 weights
    the variant reads, e2's (2, N1) offsets) and the (n,) output written
    once. Flops a frame: 8·terms·n·N1 for the stage-1 products
    (``s1_terms`` K-stacked weight terms, 6 with a window) and, for stage
    2, 6·products·n·N2 as a Karatsuba (3 parts, either operand order) or
    48·n·N2 as the 4-mult product (24 real products of the 6-term splits,
    2 weight matrices); FP32: 2n to dequantize (4n with a window), 2n
    more to subtract e2's offsets after stage 1 (``raw_bytes``), 6n for
    the twiddle, 2n for |.|^2 and the sum. With the defaults this is the
    shipping K3's work."""
    n1, n2 = ff.fast_split(n)
    full = cut == CUT_FULL
    nbytes = F * 2 * n + 4 * n + (4 * n if windowed else 0)
    mma = fp32 = 0
    if cut != CUT_GATHER:
        fp32 += 4 * n if windowed else 2 * n
    if raw_bytes:
        nbytes += 2 * n1 * 4
        fp32 += 2 * n
    if full or cut >= CUT_STAGE1:
        mma += 8 * s1_terms * n * n1
        nbytes += 2 * (2 * s1_terms * n1) * n1 * 2
        fp32 += 2 * n
    if twiddle and (full or cut >= CUT_TWIDDLE):
        nbytes += 8 * n
        fp32 += 6 * n
    if full:
        terms = {1: 1, 3: 2, 6: 3}[s2_products]
        if s2_form == FOURMULT:
            mma += 48 * n * n2
            nbytes += 2 * terms * n2 * n2 * 2
        else:
            mma += 6 * s2_products * n * n2
            nbytes += 3 * terms * n2 * n2 * 2
    return float(nbytes), float(F * mma), float(F * fp32)


def k1_work(F: int, n: int, cut: str = "full", windowed: bool = False,
            out_rows: int = 1,
            twiddle_table: bool = True) -> Tuple[float, float, float]:
    """(bytes, 0, FP32 ops) of K1's step (or K2's, windowed; K4's, with
    ``out_rows`` output rows), or of a cut of it, over F frames of n bins.
    Bytes: the frames, the window and K1's twiddle table (n - 1 float2;
    ``twiddle_table=False`` for a kernel with tables of its own) read once,
    the output written once. FP32 a frame: 5 n log2 n for the radix-2
    transform, 2n to dequantize, 2n for |X|^2 and the sum, 2n more for a
    window."""
    log2n = n.bit_length() - 1
    nbytes = F * 2 * n + 4 * n * out_rows + (4 * n if windowed else 0)
    if cut == "full" and twiddle_table:
        nbytes += 8 * (n - 1)
    fp32 = {"full": 5 * n * log2n + 4 * n, "nofft": 4 * n,
            "dequant": 2 * n}[cut] + (2 * n if windowed else 0)
    return float(nbytes), 0.0, float(F * fp32)


def _k3(name, code, tpu, parity="plain", rtol=RTOL_SCHEME, **kw) -> Variant:
    psd = kw.get("cut", CUT_FULL) == CUT_FULL and kw.get("twiddle", True)
    return Variant(name, code, "k3", tpu, parity, rtol, psd, **kw)


P1_SRC = "probes/profile_pallas.py:42-107"
P18_SRC = "probes/s1_lanes.py:50-142"
P13_SRC = "probes/s1_lanes2.py:62-147"
P14_SRC = "probes/s2_fourmult.py:65-123"
P16_SRC = "probes/s2_left.py:71-159"
P19_SRC = "probes/s2_ilv.py:42-108"
P11_SRC = "probes/s2_pipe.py:46-137"

#: Every Hopper variant, by name; codes as in fused_psd_probe.cu.
VARIANTS: Dict[str, Variant] = {v.name: v for v in (
    _k3("k3", 0, (f"P1 full ({P1_SRC})",), parity="K3"),
    _k3("s2x1", 1, (f"P1 s2x1 ({P1_SRC})",), s2_products=1),
    _k3("s1x1", 2, (f"P1 s1x1 ({P1_SRC})",), s1_terms=1, s2_products=1),
    _k3("nomm", 3, (f"P1 nomm ({P1_SRC})",), s1_terms=0, cut=CUT_ZSTORE),
    _k3("notw", 4, (f"P1 notw ({P1_SRC})",), twiddle=False),
    _k3("zplanes", 5, (f"P1 dg3d ({P1_SRC})",), parity="K3",
        s2_planes=True),
    # Also P14 v6, P16 base, P19 base and P11 base (PROBES).
    _k3("tpu6", 6, (f"P18 full ({P18_SRC})", f"P13 full ({P13_SRC})"),
        s2_products=6),
    _k3("tpu6_bf16in", 7, (f"P18 widedq ({P18_SRC})",
                           f"P13 f32tr ({P13_SRC})"),
        parity="tpu6", s2_products=6, layout=IN_BF16),
    _k3("tpu6_wide32", 8, (f"P13 i32tr ({P13_SRC})",), parity="tpu6",
        s2_products=6, layout=IN_WIDE32),
    _k3("s1only", 9, (f"P18 s1only ({P18_SRC})",), twiddle=False,
        cut=CUT_STAGE1),
    _k3("s1tw", 10, (f"P18 s1tw ({P18_SRC})",), cut=CUT_TWIDDLE),
    _k3("s1tw_z", 11, (f"P18 s1tw2 ({P18_SRC})",), cut=CUT_ZSTORE),
    _k3("dq_gather", 12, (f"P18 dqonly ({P18_SRC})",), rtol=RTOL_SUMS,
        twiddle=False, cut=CUT_DEQUANT),
    _k3("dq_load", 13, (f"P18 dqwide ({P18_SRC})",), rtol=RTOL_SUMS,
        twiddle=False, cut=CUT_DEQUANT, layout=IN_BF16),
    _k3("gather", 14, (f"P13 traw ({P13_SRC})",), rtol=RTOL_SUMS,
        twiddle=False, cut=CUT_GATHER),
    _k3("dq_linear", 15, (f"P13 dqnotr ({P13_SRC})",), rtol=RTOL_SUMS,
        twiddle=False, cut=CUT_DEQUANT, layout=IN_LINEAR),
    _k3("dq_pair32", 16, (f"P13 u32tr ({P13_SRC})",), rtol=RTOL_SUMS,
        twiddle=False, cut=CUT_DEQUANT, layout=IN_PAIR32),
    # After tpu6: the parity check reads tpu6's output from the same loop.
    _k3("tpu6_pipe", 30, (f"P11 pipe ({P11_SRC})",), parity="tpu6",
        s2_products=6, pipeline=True),
    _k3("tpu6_ilv2", 31, (f"P19 ilv ({P19_SRC})",), parity="tpu6",
        s2_products=6, chains=2),
    _k3("tpu6_ilv4", 32, (f"P19 ilv4 ({P19_SRC})",), parity="tpu6",
        s2_products=6, chains=4),
    _k3("tpu6_4mult", 33, (f"P14 v7 ({P14_SRC})",), s2_products=6,
        s2_form=FOURMULT),
    _k3("tpu6_e2", 34, (f"P16 e2 ({P16_SRC})",), s2_products=6,
        raw_bytes=True),
    _k3("tpu6_left", 35, (f"P16 left ({P16_SRC})",), s2_products=6,
        s2_form=LEFT),
    _k3("tpu6_e2left", 36, (f"P16 e2left ({P16_SRC})",), s2_products=6,
        s2_form=LEFT, raw_bytes=True),
    Variant("k1_full", 20, "k1", ("K1 whole (P1's question of K1)",), "K1",
            RTOL_K1, psd=True),
    Variant("k1_dqonly", 21, "k1",
            ("K1 load + dequantize + store (P1's question of K1)",),
            "plain", RTOL_SUMS, k1_cut="dequant"),
    Variant("k1_nofft", 22, "k1", ("K1 without the transform: P1 nomm",),
            "plain", RTOL_SUMS, k1_cut="nofft"),
)}


@dataclasses.dataclass(frozen=True)
class Probe:
    """A TPU probe's entry point: its variant names -> Hopper variants."""
    tpu: str            # "P1"
    source: str         # "probes/profile_pallas.py:115", the pallas_call
    module: str         # the port's entry point, probes/<module>.py
    variants: Dict[str, str]
    default: Tuple[str, ...]
    tone: bool = False  # takes "tone": the TPU probe's 35 dB tone input


PROBES: Dict[str, Probe] = {p.tpu: p for p in (
    Probe("P1", "probes/profile_pallas.py:115", "profile_kernel",
          {"full": "k3", "s2x1": "s2x1", "s1x1": "s1x1", "nomm": "nomm",
           "notw": "notw", "dg3d": "zplanes", "k1_full": "k1_full",
           "k1_nofft": "k1_nofft", "k1_dqonly": "k1_dqonly"},
          ("full", "s2x1", "s1x1", "nomm", "notw", "dg3d", "k1_full",
           "k1_nofft", "k1_dqonly")),
    Probe("P18", "probes/s1_lanes.py:151", "s1_lanes",
          {"full": "tpu6", "widedq": "tpu6_bf16in", "s1only": "s1only",
           "s1tw": "s1tw", "s1tw2": "s1tw_z", "dqonly": "dq_gather",
           "dqwide": "dq_load"},
          ("full", "widedq", "s1only", "s1tw", "s1tw2", "dqonly",
           "dqwide")),
    Probe("P13", "probes/s1_lanes2.py:156", "s1_lanes2",
          {"full": "tpu6", "traw": "gather", "dqnotr": "dq_linear",
           "u32tr": "dq_pair32", "i32tr": "tpu6_wide32",
           "f32tr": "tpu6_bf16in"},
          ("full", "traw", "dqnotr", "u32tr", "i32tr", "f32tr")),
    Probe("P14", "probes/s2_fourmult.py:132", "s2_fourmult",
          {"v6": "tpu6", "v7": "tpu6_4mult"}, ("v6", "v7"), tone=True),
    Probe("P16", "probes/s2_left.py:171", "s2_left",
          {"base": "tpu6", "e2": "tpu6_e2", "left": "tpu6_left",
           "e2left": "tpu6_e2left"}, ("base", "e2", "left", "e2left"),
          tone=True),
    Probe("P19", "probes/s2_ilv.py:117", "s2_ilv",
          {"base": "tpu6", "ilv": "tpu6_ilv2", "ilv4": "tpu6_ilv4"},
          ("base", "ilv", "ilv4")),
    Probe("P11", "probes/s2_pipe.py:150", "s2_pipe",
          {"base": "tpu6", "pipe": "tpu6_pipe"}, ("base", "pipe")),
)}


class ProbeCounts:
    """Launches of each variant's kernel (``kernel[name]``, one per launch,
    so a call with ``iters`` adds ``iters``) and calls of its plain
    version (``plain[name]``), counted by the wrappers only."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.kernel: collections.Counter = collections.Counter()
        self.plain: collections.Counter = collections.Counter()


COUNTS = ProbeCounts()


# --- the plain versions ---

def _frame_sum(pwr: torch.Tensor, n_valid: int, chunk: int) -> torch.Tensor:
    """(F, ...) per-frame values -> (N,) sum over the frames < n_valid, in
    the two stages of the shipping plain versions."""
    F = pwr.shape[0]
    pwr = pwr.reshape(F, -1).clone()
    pwr[n_valid:] = 0.0
    return pwr.reshape(F // chunk, chunk, -1).sum(dim=1).sum(dim=0)


def _everywhere(total: torch.Tensor) -> torch.Tensor:
    """A float64 scalar in every bin, rounded once to float32."""
    return torch.full((N,), float(total), dtype=torch.float64,
                      device=total.device).to(torch.float32)


def _stage2(z: torch.Tensor, w2: torch.Tensor, products: int):
    """One Karatsuba part of stage 2: z (rows, N2) f32 times the bf16
    terms of w2, with ``products`` products."""
    def bf(x):
        return ff._bf16_round(x)
    z0 = bf(z)
    if products == 1:
        return z0 @ w2[0]
    r1 = z - z0
    z1 = bf(r1)
    if products == 3:
        return z0 @ w2[0] + z0 @ w2[1] + z1 @ w2[0]
    z2 = bf(r1 - z1)
    return (z0 @ w2[0] + z0 @ w2[1] + z0 @ w2[2] + z1 @ w2[0] + z1 @ w2[1]
            + z2 @ w2[0])


def _k3_reference(v: Variant, raw_u8: torch.Tensor, n_valid: int,
                  chunk: int) -> torch.Tensor:
    """K3's scheme (``fused_psd_fast_reference``) with the variant's
    stages."""
    F = raw_u8.shape[0]
    WR, WI, twr, twi, w2r, w2i, w2s = ff._plain_constants(
        N, N1, N2, False, raw_u8.device)
    # (F, N1, N2) [n = N2·n1 + n2] -> (F, N2, N1): rows n2, columns n1.
    v8 = raw_u8.reshape(F, N1, N2, 2).transpose(1, 2).to(torch.int32)
    reps = N1 // 16   # each element is gathered once per column block
    if v.cut == CUT_GATHER:
        u16 = (v8[..., 0] + 256 * v8[..., 1])[:n_valid].to(torch.float64)
        return _everywhere(reps * u16.sum())
    offset = 0 if v.raw_bytes else 127
    re = (v8[..., 0] - offset).to(torch.float32)
    im = (v8[..., 1] - offset).to(torch.float32)
    if v.cut == CUT_DEQUANT:
        return _everywhere(reps * (re[:n_valid].to(torch.float64).sum()
                                   + im[:n_valid].to(torch.float64).sum()))
    if v.s1_terms == 0:
        yr, yi = re, im        # Y[n2][k1] = x[N2·k1 + n2]
    else:
        lhs = torch.cat([re, im] * v.s1_terms, dim=-1).reshape(F * N2, -1)
        rows = 2 * v.s1_terms * N1
        yr = (lhs @ WR[:rows]).reshape(F, N2, N1)
        yi = (lhs @ WI[:rows]).reshape(F, N2, N1)
    if v.raw_bytes:
        c = torch.from_numpy(e2_offsets()).to(raw_u8.device)
        yr = yr - c[0]
        yi = yi - c[1]
    if v.cut == CUT_STAGE1:
        return _frame_sum(yr * yr + yi * yi, n_valid, chunk)
    if v.twiddle:
        zr = yr * twr - yi * twi
        zi = yr * twi + yi * twr
    else:
        zr, zi = yr, yi
    if v.cut in (CUT_TWIDDLE, CUT_ZSTORE):
        return _frame_sum(zr * zr + zi * zi, n_valid, chunk)
    if v.s2_form == LEFT:
        # X[k2][k1] = sum_n2 W2ᵀ[k2][n2] Z[n2][k1] (s2_left.py:109-130),
        # (F, k2, k1): bin order with no final swap.
        def left(z, w2):
            z0, z1, z2 = ff._split3(z)
            wt = w2.transpose(1, 2)
            return (wt[0] @ z0 + wt[1] @ z0 + wt[2] @ z0 + wt[0] @ z1
                    + wt[1] @ z1 + wt[0] @ z2)
        u1, u2, u3 = left(zr, w2r), left(zi, w2i), left(zr + zi, w2s)
        xr = u1 - u2
        xi = u3 - u1 - u2
        return _frame_sum(xr * xr + xi * xi, n_valid, chunk)
    zr = zr.transpose(1, 2).reshape(F * N1, N2)
    zi = zi.transpose(1, 2).reshape(F * N1, N2)
    if v.s2_form == FOURMULT:
        # One K-stacked lhs for both outputs (s2_fourmult.py:92-97), its
        # 12 blocks of depth N2 summed in stack order, as the kernel's mma
        # (one f32 product of depth 12·N2 here is 2x further from the
        # golden under a 35 dB tone).
        z0r, z1r, z2r = ff._split3(zr)
        z0i, z1i, z2i = ff._split3(zi)
        lhs2 = (z0r, z0r, z0r, z1r, z1r, z2r, z0i, z0i, z0i, z1i, z1i, z2i)
        XR, XI = (torch.from_numpy(ff.bf16_value(m)).to(raw_u8.device)
                  .reshape(12, N2, N2) for m in fourmult_weights())
        xr, xi = lhs2[0] @ XR[0], lhs2[0] @ XI[0]
        for b in range(1, 12):
            xr = xr + lhs2[b] @ XR[b]
            xi = xi + lhs2[b] @ XI[b]
    else:
        zs = zr + zi
        u1 = _stage2(zr, w2r, v.s2_products)
        u2 = _stage2(zi, w2i, v.s2_products)
        u3 = _stage2(zs, w2s, v.s2_products)
        xr = u1 - u2
        xi = u3 - u1 - u2
    pwr = (xr * xr + xi * xi).reshape(F, N1, N2)
    pwr[n_valid:] = 0.0
    s = pwr.reshape(F // chunk, chunk, N1, N2).sum(dim=1).sum(dim=0)
    return s.t().reshape(N)        # (k2, k1) row-major = bin order


def _k1_reference(v: Variant, raw_u8: torch.Tensor, n_valid: int,
                  chunk: int) -> torch.Tensor:
    if v.k1_cut == "full":
        return fused_psd_reference(raw_u8, n_valid, chunk)
    x = raw_u8[:n_valid].reshape(n_valid, N, 2).to(torch.float64) - 127.0
    if v.k1_cut == "nofft":
        per = x[..., 0] ** 2 + x[..., 1] ** 2
    else:
        per = x[..., 0] + x[..., 1]
    return per.sum(dim=0).to(torch.float32)


def fused_psd_probe_reference(variant: str, raw_u8: torch.Tensor,
                              n_valid: int, chunk: int) -> torch.Tensor:
    """The plain PyTorch version of ``variant``: (F, 2N) uint8 -> (N,)
    float32; see the module docstring for what each variant outputs."""
    v = VARIANTS[variant]
    if v.kernel == "k1":
        return _k1_reference(v, raw_u8, n_valid, chunk)
    return _k3_reference(v, raw_u8, n_valid, chunk)


# --- the stage-2 probes' constants ---

@functools.lru_cache(maxsize=1)
def e2_offsets() -> np.ndarray:
    """(2, N1) float32 (cR, cI): the image of the -127 dequantization
    offset after stage 1, 127 times the column sums of the bf16 stage-1
    weights WR and WI, summed in float64 and rounded once, as
    ``probes/s2_left.py:56-58`` builds them."""
    WR, WI, _, _, _, _, _ = ff.constants(N, N1, N2, False)
    ones = np.full((6 * N1,), 127.0)
    return np.stack([ones @ ff.bf16_value(W).astype(np.float64)
                     for W in (WR, WI)]).astype(np.float32)


@functools.lru_cache(maxsize=1)
def fourmult_weights() -> Tuple[np.ndarray, np.ndarray]:
    """(XR, XI), (12·N2, N2) bf16 bit patterns: the 4-mult stage 2's
    stacks against the lhs [z0r z0r z0r z1r z1r z2r z0i z0i z0i z1i z1i
    z2i], vstack(r0 r1 r2 r0 r1 r0, -i0 -i1 -i2 -i0 -i1 -i0) and
    vstack(i0 i1 i2 i0 i1 i0, r0 r1 r2 r0 r1 r0) of the 3-term splits of
    the length-N2 DFT (``probes/s2_fourmult.py:55-60``)."""
    _, _, _, _, r, i, _ = ff.constants(N, N1, N2, False)
    order = (0, 1, 2, 0, 1, 0)
    neg = np.uint16(0x8000)
    XR = np.vstack([r[j] for j in order] + [i[j] ^ neg for j in order])
    XI = np.vstack([i[j] for j in order] + [r[j] for j in order])
    return XR, XI


def pack_a_fragments(bits: np.ndarray) -> np.ndarray:
    """An (M, K) bf16 matrix as ``mma.m16n8k16`` A fragments: (M/16,
    K/16, 32, 8) uint16, where lane l of tile (mt, kc) holds its four A
    registers a[q], low half first: A[16mt + g + 8(q & 1)][16kc + 2t +
    8(q >> 1) + {0, 1}] (g = l >> 2, t = l & 3), one 16-byte load."""
    M, K = bits.shape
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    q = np.arange(4).repeat(2)
    h = np.tile(np.arange(2), 4)
    rows = g[:, None] + 8 * (q & 1)[None, :]             # (32, 8)
    cols = 2 * t[:, None] + 8 * (q >> 1)[None, :] + h[None, :]
    mt = np.arange(M // 16)[:, None, None, None]
    kc = np.arange(K // 16)[None, :, None, None]
    return np.ascontiguousarray(bits[16 * mt + rows[None, None],
                                     16 * kc + cols[None, None]])


# --- the kernel ---

@functools.lru_cache(maxsize=4)
def _tpu6_w2(device: torch.device) -> torch.Tensor:
    """The 6-product scheme's stage-2 weights: 9 B-fragment planes (w2r0,
    w2r1, w2r2, w2i0, ..., w2s2; the 4-mult form reads the first 6)."""
    _, _, _, _, w2r, w2i, w2s = ff.constants(N, N1, N2, False)
    w2 = np.stack([ff.pack_b_fragments(m[j]) for m in (w2r, w2i, w2s)
                   for j in range(3)])
    return torch.from_numpy(w2.view(np.int16)).to(device)


@functools.lru_cache(maxsize=4)
def _left_w2(device: torch.device) -> torch.Tensor:
    """The left form's stage-2 weights: the 9 terms transposed (rows k2,
    columns n2) as A-fragment planes, in tpu6's order."""
    _, _, _, _, w2r, w2i, w2s = ff.constants(N, N1, N2, False)
    w2 = np.stack([pack_a_fragments(np.ascontiguousarray(m[j].T))
                   for m in (w2r, w2i, w2s) for j in range(3)])
    return torch.from_numpy(w2.view(np.int16)).to(device)


@functools.lru_cache(maxsize=4)
def _e2_offsets(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(e2_offsets()).to(device)


def _eligible(n: int) -> bool:
    return n == N


def block_frames(variant: str, F: int, chunk: int,
                 group: Optional[int] = None) -> int:
    """Frames one block of ``variant`` sums (the TPU probes' tile):
    ``group``, or the shipping kernels' ``frames_per_block`` rounded up to
    a multiple of the variant's chains. Raises ValueError for a group that
    is not a positive multiple of its chains (the TPU's tile split into
    chains, ``probes/s2_ilv.py:38-39``)."""
    chains = VARIANTS[variant].chains
    if group is None:
        return -(-frames_per_block(F, chunk) // chains) * chains
    group = int(group)
    if group < 1 or group % chains:
        raise ValueError(f"{variant}: frames per block {group} is not a "
                         f"positive multiple of its {chains} chains")
    return group


def fused_psd_probe(variant: str, raw_u8: torch.Tensor, n_valid: int,
                    chunk: int, group: Optional[int] = None,
                    iters: int = 1, blocks_per_sm: int = 0) -> torch.Tensor:
    """Variant ``variant`` of :data:`VARIANTS` on (F, 2N) uint8 frames,
    N = 2048 -> (N,) float32, on the tensor's device. ``group``: frames
    per block (default: :func:`block_frames`; a chained variant's must be
    a multiple of its chains); ``iters``: launches, back to back on the
    current stream, each rewriting the same output (for the slope timing
    of the probes); ``blocks_per_sm``: 0 to launch as the shipping
    kernels do, b > 0 to pad the block's shared memory so that at most b
    blocks reside on an SM (one occupancy for every variant of a chain;
    the output is the same)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}")
    v = VARIANTS[variant]
    n_valid = int(n_valid)
    check_args("fused_psd_probe", _eligible, raw_u8, n_valid, chunk, None)
    F = raw_u8.shape[0]
    group = block_frames(variant, F, chunk, group)
    if iters < 1 or blocks_per_sm < 0:
        raise ValueError(f"iters={iters} must be >= 1 and "
                         f"blocks_per_sm={blocks_per_sm} >= 0")
    if raw_u8.device.type == "cpu":
        COUNTS.plain[variant] += 1
        return fused_psd_probe_reference(variant, raw_u8, n_valid, chunk)
    if raw_u8.device.type != "cuda":
        raise ValueError(f"fused_psd_probe runs on cuda or cpu tensors, not "
                         f"{raw_u8.device}")
    check_alignment("fused_psd_probe", raw_u8, 16, None, 4)
    from . import _build
    lib = _build.load("fused_psd_probe")
    device = raw_u8.device
    offsets = None
    if v.kernel == "k1":
        w1r = w1i = w2 = None
        tw = _device_twiddles(N, device).data_ptr()
    else:
        ops = ff._device_operands(N, False, device)
        w1r, w1i, tw = (t.data_ptr() for t in ops[:3])
        w2 = (_left_w2(device) if v.s2_form == LEFT
              else _tpu6_w2(device) if v.s2_products == 6
              else ops[3]).data_ptr()
        if v.raw_bytes:
            offsets = _e2_offsets(device).data_ptr()
    partial = torch.empty((-(-F // group), N), dtype=torch.float32,
                          device=device)
    out = torch.empty(N, dtype=torch.float32, device=device)
    err = lib.rpf_fused_psd_probe(
        v.code, raw_u8.data_ptr(), w1r, w1i, tw, w2, offsets,
        partial.data_ptr(),
        out.data_ptr(), device.index, F, group, n_valid, int(blocks_per_sm),
        int(iters), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(
            f"fused_psd_probe {variant} launch failed: "
            f"{lib.rpf_cuda_error_string(err).decode()} (cudaError {err})")
    COUNTS.kernel[variant] += int(iters)
    return out


def probe_attributes(variant: str, blocks_per_sm: int = 0,
                     device: Optional[torch.device] = None) -> Dict[str, int]:
    """What ``variant``'s group kernel gets on the card at
    ``blocks_per_sm`` (as :func:`fused_psd_probe`): registers and spill
    bytes per thread, static and dynamic shared bytes per block, and the
    blocks that reside on one SM. Launches nothing."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}")
    device = device or torch.device("cuda", torch.cuda.current_device())
    from . import _build
    lib = _build.load("fused_psd_probe")
    attrs = (ctypes.c_int * 5)()
    err = lib.rpf_probe_attributes(VARIANTS[variant].code, int(blocks_per_sm),
                                   device.index or 0, attrs)
    if err != 0:
        raise KernelLaunchError(
            f"probe_attributes {variant}: "
            f"{lib.rpf_cuda_error_string(err).decode()} (cudaError {err})")
    return dict(zip(("registers", "spill_bytes", "static_smem",
                     "dynamic_smem", "blocks_per_sm"), attrs))


# --- P12: nine relayouts (probes/cast_test.py:30-62) ---

#: cast_test.py's shapes; both of its case groups use the same values.
T, P, Q = 8, 8, 16
_N1, _N2 = 16, 128


@dataclasses.dataclass(frozen=True)
class Relayout:
    name: str          # cast_test.py's own label
    code: int          # case index in fused_psd_probe.cu
    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    fn: Callable[[torch.Tensor], torch.Tensor]   # the plain version


RELAYOUTS: Dict[str, Relayout] = {r.name[0]: r for r in (
    Relayout("A merge16to128", 0, (T * _N2, _N1), (T * Q, P * _N1),
             lambda x: x.reshape(T * Q, P * _N1)),
    Relayout("B split+perm", 1, (T * Q, P * _N1), (T * _N1, _N2),
             lambda x: x.reshape(T, Q, P, _N1).permute(0, 3, 1, 2)
             .reshape(T * _N1, _N2)),
    Relayout("C control", 2, (T, _N1, _N2), (T * _N2, _N1),
             lambda x: x.transpose(1, 2).reshape(T * _N2, _N1)),
    Relayout("D 4dperm", 3, (T, Q, P, _N1), (T, _N1, Q, P),
             lambda x: x.permute(0, 3, 1, 2)),
    Relayout("E idx+concat", 4, (T, Q, P, _N1), (T, Q, P * _N1),
             lambda x: torch.cat([x[:, :, p, :] for p in range(P)], dim=-1)),
    Relayout("F slice+swap+cat", 5, (T, Q, P * _N1), (T * _N1, _N2),
             lambda x: torch.cat(
                 [x[:, :, p * _N1:(p + 1) * _N1].transpose(1, 2)
                  for p in range(P)], dim=-1).reshape(T * _N1, _N2)),
    Relayout("G sublane split", 6, (T, _N2, _N1), (T, Q, P, _N1),
             lambda x: x.reshape(T, Q, P, _N1)),
    Relayout("H strided+cat", 7, (T, _N2, _N1), (T, Q, P * _N1),
             lambda x: torch.cat([x[:, p::P, :] for p in range(P)], dim=-1)),
    Relayout("I perm+idx+cat", 8, (T, Q, P, _N1), (T, Q, P * _N1),
             lambda x: torch.cat([x.permute(0, 2, 1, 3)[:, p]
                                  for p in range(P)], dim=-1)),
)}


def relayout_reference(case: str, x: torch.Tensor) -> torch.Tensor:
    """The plain version of P12 case ``case`` ("A".."I"): torch's own
    reshape/permute/cat of x (the case's input shape), contiguous."""
    return RELAYOUTS[case].fn(x).contiguous()


def relayout(case: str, x: torch.Tensor, iters: int = 1) -> torch.Tensor:
    """P12 case ``case`` on a contiguous float32 tensor of the case's
    input shape, on the tensor's device; ``iters`` launches on CUDA."""
    if case not in RELAYOUTS:
        raise ValueError(f"unknown relayout case {case!r}")
    r = RELAYOUTS[case]
    if (not isinstance(x, torch.Tensor) or x.dtype != torch.float32
            or tuple(x.shape) != r.in_shape or not x.is_contiguous()):
        raise ValueError(f"relayout {case} takes a contiguous float32 "
                         f"tensor of shape {r.in_shape}")
    if x.device.type == "cpu":
        COUNTS.plain[case] += 1
        return relayout_reference(case, x)
    if x.device.type != "cuda":
        raise ValueError(f"relayout runs on cuda or cpu tensors, not "
                         f"{x.device}")
    if x.data_ptr() % 16:
        raise ValueError("relayout: input must be 16-byte aligned")
    from . import _build
    lib = _build.load("fused_psd_probe")
    out = torch.empty(r.out_shape, dtype=torch.float32, device=x.device)
    err = lib.rpf_relayout_probe(
        r.code, x.data_ptr(), out.data_ptr(), x.device.index, int(iters),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(
            f"relayout {case} launch failed: "
            f"{lib.rpf_cuda_error_string(err).decode()} (cudaError {err})")
    COUNTS.kernel[case] += int(iters)
    return out
