"""Stage-attribution, stage-2, stage-1 packing, Karatsuba and K-stacking
probes of K3 and K1 on Hopper, and P12's relayouts.

Replaces the TPU probes that asked where the fused kernel's time goes:
P1 (``probes/profile_pallas.py:build``, ``pallas_call`` at 115), P18
(``probes/s1_lanes.py:build``, 151), P13 (``probes/s1_lanes2.py:build``,
156) and P12 (``probes/cast_test.py:try_cast``, 16); those that
restructured its stage 2: P14 (``probes/s2_fourmult.py:build``, 132), P16
(``probes/s2_left.py:build``, 171), P19 (``probes/s2_ilv.py:build``, 117)
and P11 (``probes/s2_pipe.py:build``, 150); and those that relaid and
packed stage 1's operands: P17 (``probes/s2_u32t.py:build``, 154), P2
(``probes/profile_pallas.py:build_pack8``, 227), P6 (``build_pack8c``,
588) and P5 (``build_s1wide``, 492); and those that asked what Karatsuba
and K-stacking are worth: P3 (``build_dg3dall``, 309), P4
(``build_s1cat``, 390), P7 (``build_s1k``, 680) and P8 (``build_best``,
766); and the module's last two builds, P9 (``build_v5``, 880) and P10
(``build_v6``, 1005), with hand-written CUDA C++ for sm_90a
(``csrc/fused_psd_probe.cu``). On this card the TPU probes' bf16
four-step scheme is K3, so each TPU variant becomes one compile-time
variant of K3's template (``csrc/fused_psd_fast.cuh``); K1's cuts ask
P1's question of the FP32 radix-2 kernel K1 was (``csrc/fused_psd.cuh``,
``k1_*``) and of K1 as it ships (``csrc/fused_psd_regs.cuh``, ``k1r_*``),
and :func:`radix2_psd` runs that radix-2 kernel whole at the sizes the
redesign is timed at, as its control; :func:`large_radix2_psd` runs the
large-N kernel's radix-2 passes likewise, as the control of its register
passes.
All run at the probes' N = 2048 on raw interleaved u8 IQ, at K3's own
split N1 x N2 = 32 x 64 (the TPU probes ran 16 x 128). The stage-2 probes
start from the TPU's shipping 6-product scheme, ``tpu6`` here; their
``base``/``v6`` is it, and each other TPU variant is a variant of it:
``tpu6_4mult`` (P14 v7), ``tpu6_e2``, ``tpu6_left``, ``tpu6_e2left``
(P16), ``tpu6_ilv2``, ``tpu6_ilv4`` (P19), ``tpu6_pipe`` (P11) and
``tpu6_u32t`` (P17: e2's raw bytes from u32 pair words). The
schedules (ilv, pipe) compute tpu6's arithmetic in another order of
frames and phases, so their plain version is tpu6's and their output
must equal tpu6's bit for bit. P2, P6 and P5 change K3's stage 1:
``k3_pack`` (rows packed :data:`PACK` to a 128-column lane group against
block-diagonal weights, zero blocks multiplied), ``k3_pack_pq`` (the
same with Z in (p, q) order and stage-2 weight rows permuted to match)
and ``k3_s1wide`` (two products against N-stacked weights). P3, P4 and
P7 change it again: ``k3_dg3dall`` (the Karatsuba of 3 products against
:func:`karatsuba_weights`, with P1 dg3d's stage 2, ``zplanes``),
``k3_s1cat`` (the same as one product against the block-diagonal
:func:`s1cat_weights`, zero blocks multiplied: P3's output bit for bit)
and ``k3_s1k32`` (K3's K-stack in three chains, P7's reps 1; its reps 3,
``s1k96``, is ``k3``); P8's ``k3_best`` keeps K3's stage 1 and multiplies
stage 2 as the 2-term 4-mult product (:func:`best_weights`). P9's ``kar``
(argv ``v5``) is ``k3`` and its ``left`` (``v5left``) ``k3_left``, K3's
Karatsuba stage 2 at 3 products with the 2-term weights as the left
operand (:func:`left_w2`; K3 bit for bit on the card); P10's narrow form
(``v6``) is ``tpu6`` and its K-stacked one (``v6k``) ``tpu6_kstack``:
tpu6's 18 products from Z's 3-term split planes in the order of one
product of [z0 z0 z0 z1 z1 z2] with :func:`kstack_weights` (the six
blocks outer, the chunks inner); ``tpu6_zplanes``, tpu6's own order from
the same planes, is the control that separates the staging from the
order (tpu6 bit for bit).

:data:`VARIANTS` is the registry: each Hopper variant, the TPU probe
variants it stands for (two TPU names that became one Hopper variant are
listed against it), its parity class, and the work its bound counts.
:data:`PROBES` maps each TPU probe's variant names to them. Beside every
variant is its plain PyTorch version (:func:`fused_psd_probe_reference`),
which defines the variant's output; ``fused_psd_fast_reference`` is its
base. The outputs, all (N,) float32 summed over the frames < n_valid:

- whole-step variants: |X|^2 in bin order, as K3 (``k3`` is K3 itself;
  ``tpu6_e2``/``tpu6_e2left``/``tpu6_u32t`` multiply the raw bytes in
  stage 1 and subtract :func:`e2_offsets` after it, ``tpu6_u32t`` from
  the pair words of :func:`_pair_word_planes`, ``k3_pack``/``k3_pack_pq``
  multiply :func:`packed_weights`, ``k3_s1wide`` :func:`wide_weights`,
  ``k3_dg3dall``/``k3_s1cat`` :func:`karatsuba_weights`/
  :func:`s1cat_weights`, ``tpu6_4mult`` and ``k3_best`` multiply by
  :func:`fourmult_weights`/:func:`best_weights`, the ``left`` forms
  contract n2 from the left, ``tpu6_kstack`` sums the blocks of
  :func:`kstack_weights` in stack order);
  ``nomm`` and the cuts after stage 1, the twiddle and the Z store: the
  sums of |Y|^2 or |Z|^2 in (n2, k1) order, index n2*N1 + k1;
- the gather and dequantization cuts: the sum of every value the kernel
  gathers (each element N1/16 times, once for each column block of
  stage 1), raw u16 values or dequantized re + im, in every bin (the TPU
  probes' ``consume``, ``probes/s1_lanes2.py:52-60``);
- K1's cuts: ``k1_full`` (the radix-2 kernel) and ``k1r_full`` (K1) the
  spectrum; ``k1_nofft``/``k1r_nofft`` the sum of |x[n]|^2 and
  ``k1_dqonly``/``k1r_dqonly`` of re + im of each sample n, in natural
  order.

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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import fused_psd_fast as ff
from .fused_psd import (KernelLaunchError, _device_pass_twiddles,
                        _device_twiddles, check_alignment, check_args,
                        frames_per_block, fused_psd_reference, k1_group,
                        resident_blocks)

#: The probes' transform size and K3's split of it.
N = 2048
N1, N2 = ff.fast_split(N)

# Cut points and input layouts of K3's template (fused_psd_fast.cuh).
CUT_FULL, CUT_GATHER, CUT_DEQUANT, CUT_STAGE1, CUT_TWIDDLE, CUT_ZSTORE = \
    range(6)
IN_RAW, IN_BF16, IN_WIDE32, IN_PAIR32, IN_LINEAR = range(5)
# Stage-2 forms (kS2Karatsuba, kS2FourMult, kS2Left, kS2KStacked).
KARATSUBA, FOURMULT, LEFT, KSTACKED = ("karatsuba", "fourmult", "left",
                                       "kstacked")
# Stage-1 forms (kS1KStack, kS1Packed, kS1PackedPQ, kS1Wide, kS1Karatsuba,
# kS1KaratsubaCat, kS1SplitK).
KSTACK, PACKED, PACKED_PQ, WIDE = "kstack", "packed", "packed_pq", "wide"
KARATSUBA3, CAT, SPLIT_K = "karatsuba3", "cat", "split_k"
#: The forms that multiply zero blocks of their weights.
ZERO_BLOCK_FORMS = (PACKED, PACKED_PQ, CAT)
#: The packed forms' rows a lane group (profile_pallas.py:163), and the
#: packed frame's rows q: n2 = PACK·q + p.
PACK = max(1, 128 // N1)
PACK_ROWS = N2 // PACK

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
    """One Hopper variant: of K3's template (``kernel`` "k3"), a cut of
    the radix-2 kernel K1 was ("k1") or of K1 as it ships, the register
    transform ("k1r"). ``parity``: the kernel's output must equal the named
    shipping kernel's ("K3", "K1") or earlier variant's ("tpu6",
    "tpu6_e2") bit for bit, or only its plain version's within ``rtol``
    ("plain"). ``psd``: the
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
    s1_form: str = KSTACK

    def work(self, F: int,
             zero_blocks: bool = False) -> Tuple[float, float, float]:
        """(bytes, bf16 tensor-core flops, FP32 ops) of one step over F
        frames: the work its bound counts (:func:`k3_work`,
        :func:`k1_work`). A schedule (chains, pipeline) does its scheme's
        work; ``zero_blocks``: a form of :data:`ZERO_BLOCK_FORMS`, its work
        done, its zero blocks included."""
        if self.kernel in ("k1", "k1r"):
            return k1_work(F, N, self.k1_cut)
        return k3_work(F, N, self.s1_terms, self.s2_products, self.twiddle,
                       self.cut, s2_form=self.s2_form,
                       raw_bytes=self.raw_bytes, s1_form=self.s1_form,
                       zero_blocks=zero_blocks)


def k3_work(F: int, n: int, s1_terms: int = 3, s2_products: int = 3,
            twiddle: bool = True, cut: int = CUT_FULL,
            windowed: bool = False, s2_form: str = KARATSUBA,
            raw_bytes: bool = False, s1_form: str = KSTACK,
            zero_blocks: bool = False) -> Tuple[float, float, float]:
    """(bytes, bf16 tensor-core flops, FP32 ops) of K3's step, or of a cut
    of it, over F frames of n bins. Bytes: each input read once (the
    frames, the window, the stage-1 weights, twiddle and stage-2 weights
    the variant reads, e2's (2, N1) offsets) and the (n,) output written
    once. Flops a frame: 8·terms·n·N1 for the stage-1 products
    (``s1_terms`` K-stacked weight terms, 6 with a window; the wide form
    and the three chains K3's products, the wide form against half its
    weight bytes; the packed forms compute K3's spectrum and count K3's
    work, or with ``zero_blocks`` the work they do: P = max(1, 128 / N1)
    times the products against P² times the weight bytes; the Karatsuba
    forms 18·n·N1 against 9 (N1, N1) weight planes, or with
    ``zero_blocks`` the block-diagonal product's 54·n·N1 against its 27
    blocks) and, for stage 2, 6·products·n·N2 as a Karatsuba (3 parts,
    either operand order) or 4·products·2·n·N2 as the 4-mult product
    (48·n·N2 for the 24 real products of the 3-term splits, 24·n·N2 for
    the 12 of the 2-term; 2 weight matrices); FP32: 2n to dequantize (4n
    with a window), 2n more to subtract e2's offsets after stage 1
    (``raw_bytes``), 2n for stage 1 (8n more to combine the wide form's
    six accumulators a plane, 4n the three chains', 4n for the Karatsuba
    forms' as = ar + ai and their combination), 6n for the twiddle, 2n
    for |.|^2 and the sum. With the defaults this is the shipping K3's
    work."""
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
        if s1_form in (KARATSUBA3, CAT):
            blocks = 27 if zero_blocks and s1_form == CAT else 9
            mma += 2 * blocks * n * n1
            nbytes += blocks * n1 * n1 * 2
            fp32 += 4 * n
        else:
            pack = (max(1, 128 // n1) if zero_blocks
                    and s1_form in ZERO_BLOCK_FORMS else 1)
            mma += 8 * s1_terms * n * n1 * pack
            if s1_form == WIDE:
                nbytes += n1 * (2 * s1_terms * n1) * 2
                fp32 += 8 * n
            else:
                nbytes += 2 * (2 * s1_terms * n1 * pack) * (n1 * pack) * 2
            if s1_form == SPLIT_K:
                fp32 += 4 * n
        fp32 += 2 * n
    if twiddle and (full or cut >= CUT_TWIDDLE):
        nbytes += 8 * n
        fp32 += 6 * n
    if full:
        terms = {1: 1, 3: 2, 6: 3}[s2_products]
        if s2_form == FOURMULT:
            mma += 4 * s2_products * 2 * n * n2
            nbytes += 2 * terms * n2 * n2 * 2
        else:
            mma += 6 * s2_products * n * n2
            nbytes += 3 * terms * n2 * n2 * 2
    return float(nbytes), float(F * mma), float(F * fp32)


def k1_work(F: int, n: int, cut: str = "full", windowed: bool = False,
            out_rows: int = 1) -> Tuple[float, float, float]:
    """(bytes, 0, FP32 ops) of K1's step (or K2's, windowed; K4's, with
    ``out_rows`` output rows), or of a cut of it, over F frames of n bins:
    the least the function needs, whatever kernel computes it. Bytes: the
    frames and the window read once, the output written once (twiddles
    are the implementation's). FP32 a frame: 4 n log2 n - 6n + 8 for the
    transform (split radix, the fewest of the usual algorithms), 2n to
    dequantize, 2n for |X|^2 and the sum, 2n more for a window."""
    log2n = n.bit_length() - 1
    nbytes = F * 2 * n + 4 * n * out_rows + (4 * n if windowed else 0)
    fp32 = {"full": 4 * n * log2n - 2 * n + 8, "nofft": 4 * n,
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
P17_SRC = "probes/s2_u32t.py:43-143"
P2_SRC = "probes/profile_pallas.py:161-219"
P6_SRC = "probes/profile_pallas.py:516-580"
P5_SRC = "probes/profile_pallas.py:431-483"
P3_SRC = "probes/profile_pallas.py:255-323"
P4_SRC = "probes/profile_pallas.py:326-404"
P7_SRC = "probes/profile_pallas.py:611-694"
P8_SRC = "probes/profile_pallas.py:708-780"
P9_SRC = "probes/profile_pallas.py:790-894"
P10_SRC = "probes/profile_pallas.py:909-1019"

#: Every Hopper variant, by name; codes as in fused_psd_probe.cu.
VARIANTS: Dict[str, Variant] = {v.name: v for v in (
    # P7's reps 3 is K3's own K-stack (fused_psd.py:166-169); P9's kar is
    # it with integer dequantization, the same bf16 values.
    _k3("k3", 0, (f"P1 full ({P1_SRC})", f"P7 s1k96 ({P7_SRC})",
                  f"P9 v5 ({P9_SRC})"), parity="K3"),
    _k3("s2x1", 1, (f"P1 s2x1 ({P1_SRC})",), s2_products=1),
    _k3("s1x1", 2, (f"P1 s1x1 ({P1_SRC})",), s1_terms=1, s2_products=1),
    _k3("nomm", 3, (f"P1 nomm ({P1_SRC})",), s1_terms=0, cut=CUT_ZSTORE),
    _k3("notw", 4, (f"P1 notw ({P1_SRC})",), twiddle=False),
    _k3("zplanes", 5, (f"P1 dg3d ({P1_SRC})",), parity="K3",
        s2_planes=True),
    # Also P14 v6, P16 base, P19 base and P11 base (PROBES).
    _k3("tpu6", 6, (f"P18 full ({P18_SRC})", f"P13 full ({P13_SRC})",
                    f"P10 v6 ({P10_SRC})"), s2_products=6),
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
    # After tpu6_e2: e2's A registers from pair words, its products in
    # its order.
    _k3("tpu6_u32t", 37, (f"P17 u32t ({P17_SRC})",), parity="tpu6_e2",
        s2_products=6, layout=IN_PAIR32, raw_bytes=True),
    # The zero blocks add exact zeros to each accumulator between K3's
    # own products, in K3's order.
    _k3("k3_pack", 38, (f"P2 pack8 ({P2_SRC})",), parity="K3",
        s1_form=PACKED),
    _k3("k3_pack_pq", 39, (f"P6 pack8c ({P6_SRC})",), s1_form=PACKED_PQ),
    _k3("k3_s1wide", 40, (f"P5 s1wide ({P5_SRC})",), s1_form=WIDE),
    _k3("k3_dg3dall", 41, (f"P3 dg3dall ({P3_SRC})",), s2_planes=True,
        s1_form=KARATSUBA3),
    # After k3_dg3dall: its zero blocks add exact zeros between P3's
    # products in P3's order, and zplanes is K3 bit for bit.
    _k3("k3_s1cat", 42, (f"P4 s1cat ({P4_SRC})",), parity="k3_dg3dall",
        s1_form=CAT),
    _k3("k3_s1k32", 43, (f"P7 s1k32 ({P7_SRC})",), s1_form=SPLIT_K),
    _k3("k3_best", 44, (f"P8 best ({P8_SRC})",), s2_form=FOURMULT),
    # K3's products transposed, in K3's order per accumulator: on the
    # H100 the mma gives the same f32 sums either way round (measured).
    _k3("k3_left", 45, (f"P9 v5left ({P9_SRC})",), parity="K3",
        s2_form=LEFT),
    # After tpu6: the same f32 Z split once into 9 planes by stage 1, the
    # same bf16 terms and products in tpu6's order per accumulator.
    _k3("tpu6_zplanes", 46, (f"control of P10: v6 from Z's split planes "
                             f"({P10_SRC})",), parity="tpu6",
        s2_products=6, s2_planes=True),
    _k3("tpu6_kstack", 47, (f"P10 v6k ({P10_SRC})",), s2_products=6,
        s2_planes=True, s2_form=KSTACKED),
    # The radix-2 kernel K1 was until the register transform: the control
    # the redesign is timed against, held to the plain version (and its
    # difference from K1 printed).
    Variant("k1_full", 20, "k1", ("K1 whole (P1's question of K1)",), "plain",
            RTOL_K1, psd=True),
    Variant("k1_dqonly", 21, "k1",
            ("K1 load + dequantize + store (P1's question of K1)",),
            "plain", RTOL_SUMS, k1_cut="dequant"),
    Variant("k1_nofft", 22, "k1", ("K1 without the transform: P1 nomm",),
            "plain", RTOL_SUMS, k1_cut="nofft"),
    # The same three cuts of K1 as it ships (csrc/fused_psd_regs.cuh), on
    # its own grid (k1_group): the whole one is K1 bit for bit.
    Variant("k1r_full", 23, "k1r",
            ("K1 whole, register transform (P1's question of K1)",), "K1",
            RTOL_K1, psd=True),
    Variant("k1r_dqonly", 24, "k1r",
            ("K1 load (cp.async ring) + dequantize, register transform",),
            "plain", RTOL_SUMS, k1_cut="dequant"),
    Variant("k1r_nofft", 25, "k1r",
            ("K1 without the transform, register transform",), "plain",
            RTOL_SUMS, k1_cut="nofft"),
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
    # Probes whose defaults its entry point runs after its own when given
    # no variant names.
    then: Tuple[str, ...] = ()


PROBES: Dict[str, Probe] = {p.tpu: p for p in (
    # With no argv profile_pallas.py runs P1's variants, then pack8 (148,
    # 243); here P1's six and the radix-2 kernel's three cuts, then P2's
    # pack8. The register kernel's cuts run by name.
    Probe("P1", "probes/profile_pallas.py:115", "profile_kernel",
          {"full": "k3", "s2x1": "s2x1", "s1x1": "s1x1", "nomm": "nomm",
           "notw": "notw", "dg3d": "zplanes", "k1_full": "k1_full",
           "k1_nofft": "k1_nofft", "k1_dqonly": "k1_dqonly",
           "k1r_full": "k1r_full", "k1r_dqonly": "k1r_dqonly",
           "k1r_nofft": "k1r_nofft"},
          ("full", "s2x1", "s1x1", "nomm", "notw", "dg3d", "k1_full",
           "k1_nofft", "k1_dqonly"), then=("P2",)),
    # The other builds of profile_pallas.py, which its argv names (243,
    # 419, 424, 508, 604, 696-705, 782, 896-906, 1021-1027):
    # profile_kernel takes them beside P1's.
    Probe("P2", "probes/profile_pallas.py:227", "profile_kernel",
          {"pack8": "k3_pack"}, ("pack8",)),
    Probe("P6", "probes/profile_pallas.py:588", "profile_kernel",
          {"pack8c": "k3_pack_pq"}, ("pack8c",)),
    Probe("P5", "probes/profile_pallas.py:492", "profile_kernel",
          {"s1wide": "k3_s1wide"}, ("s1wide",)),
    Probe("P3", "probes/profile_pallas.py:309", "profile_kernel",
          {"dg3dall": "k3_dg3dall"}, ("dg3dall",)),
    Probe("P4", "probes/profile_pallas.py:390", "profile_kernel",
          {"s1cat": "k3_s1cat"}, ("s1cat",)),
    Probe("P7", "probes/profile_pallas.py:680", "profile_kernel",
          {"s1k32": "k3_s1k32", "s1k96": "k3"}, ("s1k32", "s1k96")),
    Probe("P8", "probes/profile_pallas.py:766", "profile_kernel",
          {"best": "k3_best"}, ("best",)),
    # The argv names of build_v5 and build_v6 (896-906, 1021-1027).
    Probe("P9", "probes/profile_pallas.py:880", "profile_kernel",
          {"v5": "k3", "v5left": "k3_left"}, ("v5", "v5left")),
    Probe("P10", "probes/profile_pallas.py:1005", "profile_kernel",
          {"v6": "tpu6", "v6k": "tpu6_kstack"}, ("v6", "v6k")),
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
    Probe("P17", "probes/s2_u32t.py:154", "s2_u32t",
          {"base": "tpu6", "u32t": "tpu6_u32t"}, ("base", "u32t")),
)}


def entry_probes(tpu: str) -> List[Probe]:
    """The probes whose variant names probe ``tpu``'s entry point takes:
    its own, then the others of its module (``profile_kernel``: P1's,
    P2's, P6's, P5's, P3's, P4's, P7's, P8's, P9's and P10's)."""
    own = PROBES[tpu]
    return [own] + [p for p in PROBES.values()
                    if p.module == own.module and p is not own]


def entry_variants(tpu: str,
                   names: Sequence[str] = ()) -> List[Tuple[Probe, str]]:
    """What probe ``tpu``'s entry point runs for the variant names
    ``names``, as (the probe that has the name, the name), each looked up
    in :func:`entry_probes` in order; with no names, its default and then
    the defaults of the probes in its ``then``. KeyError for a name none
    of them has."""
    if not names:
        own = PROBES[tpu]
        return [(p, name) for p in [own] + [PROBES[t] for t in own.then]
                for name in p.default]
    probes = entry_probes(tpu)
    out = []
    for name in names:
        hit = [p for p in probes if name in p.variants]
        if not hit:
            raise KeyError(name)
        out.append((hit[0], name))
    return out


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
    if v.layout == IN_PAIR32 and v.raw_bytes:
        re, im = _pair_word_planes(raw_u8)
    else:
        offset = 0 if v.raw_bytes else 127
        re = (v8[..., 0] - offset).to(torch.float32)
        im = (v8[..., 1] - offset).to(torch.float32)
    if v.cut == CUT_DEQUANT:
        return _everywhere(reps * (re[:n_valid].to(torch.float64).sum()
                                   + im[:n_valid].to(torch.float64).sum()))
    if v.s1_form in (PACKED, PACKED_PQ):
        zr, zi = _packed_stage1(v.s1_form == PACKED_PQ, re, im, twr, twi)
        if v.s1_form == PACKED_PQ:
            perm = torch.from_numpy(pq_permutation()).to(raw_u8.device)
            w2r, w2i, w2s = (w[:, perm] for w in (w2r, w2i, w2s))
        return _stage2_sum(v, zr, zi, w2r, w2i, w2s, n_valid, chunk)
    if v.s1_terms == 0:
        yr, yi = re, im        # Y[n2][k1] = x[N2·k1 + n2]
    elif v.s1_form == WIDE:
        yr, yi = _wide_stage1(re, im)
    elif v.s1_form in (KARATSUBA3, CAT):
        yr, yi = _karatsuba_stage1(v.s1_form == CAT, re, im)
    elif v.s1_form == SPLIT_K:
        # P7 reps 1 (profile_pallas.py:638-645): [ar ai] times each term's
        # (2·N1, N1) block of WR and WI, summed in term order
        lhs = torch.cat([re, im], dim=-1).reshape(F * N2, 2 * N1)

        def chains(W):
            y = lhs @ W[:2 * N1]
            for j in (1, 2):
                y = y + lhs @ W[2 * j * N1:2 * (j + 1) * N1]
            return y.reshape(F, N2, N1)
        yr, yi = chains(WR), chains(WI)
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
        # X[k2][k1] = sum_n2 W2ᵀ[k2][n2] Z[n2][k1] (s2_left.py:109-130;
        # at 3 products profile_pallas.py:831-838), (F, k2, k1): bin order
        # with no final swap.
        def left(z, w2):
            z0, z1, z2 = ff._split3(z)
            wt = w2.transpose(1, 2)
            if v.s2_products == 3:
                return wt[0] @ z0 + wt[1] @ z0 + wt[0] @ z1
            return (wt[0] @ z0 + wt[1] @ z0 + wt[2] @ z0 + wt[0] @ z1
                    + wt[1] @ z1 + wt[0] @ z2)
        u1, u2, u3 = left(zr, w2r), left(zi, w2i), left(zr + zi, w2s)
        xr = u1 - u2
        xi = u3 - u1 - u2
        return _frame_sum(xr * xr + xi * xi, n_valid, chunk)
    zr = zr.transpose(1, 2).reshape(F * N1, N2)
    zi = zi.transpose(1, 2).reshape(F * N1, N2)
    return _stage2_sum(v, zr, zi, w2r, w2i, w2s, n_valid, chunk)


def _stage2_sum(v: Variant, zr: torch.Tensor, zi: torch.Tensor, w2r, w2i,
                w2s, n_valid: int, chunk: int) -> torch.Tensor:
    """Stage 2 of Z, (F·N1, N2) rows (f, k1) in the order of w2's rows,
    |X|^2, the frame mask and the sum, in bin order."""
    F = zr.shape[0] // N1
    if v.s2_form == FOURMULT:
        # One K-stacked lhs for both outputs (s2_fourmult.py:92-97; P8's
        # 2-term form, profile_pallas.py:743-749), its blocks of depth N2
        # summed in stack order, as the kernel's mma (one f32 product of
        # depth 12·N2 here is 2x further from the golden under a 35 dB
        # tone).
        z0r, z1r, z2r = ff._split3(zr)
        z0i, z1i, z2i = ff._split3(zi)
        if v.s2_products == 3:
            lhs2 = (z0r, z0r, z1r, z0i, z0i, z1i)
            mats = best_weights()
        else:
            lhs2 = (z0r, z0r, z0r, z1r, z1r, z2r, z0i, z0i, z0i, z1i, z1i,
                    z2i)
            mats = fourmult_weights()
        XR, XI = (torch.from_numpy(ff.bf16_value(m)).to(zr.device)
                  .reshape(len(lhs2), N2, N2) for m in mats)
        xr, xi = (_block_sum(lhs2, M) for M in (XR, XI))
    else:
        zs = zr + zi
        if v.s2_form == KSTACKED:
            # P10 v6k (profile_pallas.py:973-977): per part one lhs [z0 z0
            # z0 z1 z1 z2] against the text's stack, blocks in stack order
            def part(z, stack):
                z0, z1, z2 = ff._split3(z)
                W = torch.from_numpy(ff.bf16_value(stack)).to(z.device)
                return _block_sum([z0, z0, z0, z1, z1, z2],
                                  W.reshape(6, N2, N2))
            u1, u2, u3 = (part(z, m)
                          for z, m in zip((zr, zi, zs), kstack_weights()))
        else:
            u1 = _stage2(zr, w2r, v.s2_products)
            u2 = _stage2(zi, w2i, v.s2_products)
            u3 = _stage2(zs, w2s, v.s2_products)
        xr = u1 - u2
        xi = u3 - u1 - u2
    pwr = (xr * xr + xi * xi).reshape(F, N1, N2)
    pwr[n_valid:] = 0.0
    s = pwr.reshape(F // chunk, chunk, N1, N2).sum(dim=1).sum(dim=0)
    return s.t().reshape(N)        # (k2, k1) row-major = bin order


def _block_sum(lhs2, W: torch.Tensor) -> torch.Tensor:
    """A K-stacked product lhs2 · vstack(W) as its blocks of depth N2,
    each an f32 product, summed in stack order (the kernels' mma add each
    block's products to the running sum in that order; one f32 product
    of the whole depth sums otherwise)."""
    out = lhs2[0] @ W[0]
    for b in range(1, len(lhs2)):
        out = out + lhs2[b] @ W[b]
    return out


def _pair_word_planes(raw_u8: torch.Tensor):
    """P17's relayout as the kernel reads it: the u32 word of each pair
    (n1, n1 + 1), n1 even, of column n2 (bytes re(n1), im(n1), re(n1 + 1),
    im(n1 + 1): the bitcast of ``probes/s2_u32t.py:74-75``), transposed to
    rows n2 (76-77); the re plane is bytes 0 and 2 of each word, the im
    plane bytes 1 and 3, raw 0..255 in columns n1 in order (78-87 take
    them as even and odd halves). (F, N2, N1) float32 each."""
    F = raw_u8.shape[0]
    words = (raw_u8.reshape(F, N1 // 2, 2, N2, 2).permute(0, 1, 3, 2, 4)
             .reshape(F, N1 // 2, N2, 4))          # word (p, n2), bytes 0..3
    wt = words.transpose(1, 2).to(torch.float32)   # (F, N2, N1/2, 4)
    return (wt[..., 0::2].reshape(F, N2, N1), wt[..., 1::2].reshape(F, N2, N1))


def _packed_stage1(pq: bool, re: torch.Tensor, im: torch.Tensor, twr, twi):
    """Stage 1 and twiddle of P2 (``profile_pallas.py:182-203``) and, with
    ``pq``, P6 (541-563) on K3's K-stacked terms: the dequantized (F, N2,
    N1) planes read flat as (F·Q, PACK·N1) (Q = :data:`PACK_ROWS`), row q
    and column (p, n1) of n2 = PACK·q + p, times the block-diagonal
    :func:`packed_weights`, the twiddle read as (Q, PACK·N1); Z in stage
    2's layout (F·N1, N2), rows (f, k1), columns n2 (P2) or p·Q + q (P6)."""
    F, W = re.shape[0], PACK * N1
    lhs = torch.cat([re.reshape(F * PACK_ROWS, W),
                     im.reshape(F * PACK_ROWS, W)] * 3, dim=-1)
    PWR, PWI = (torch.from_numpy(ff.bf16_value(m)).to(re.device)
                for m in packed_weights())
    yr = (lhs @ PWR).reshape(F, PACK_ROWS, W)
    yi = (lhs @ PWI).reshape(F, PACK_ROWS, W)
    tr, ti = twr.reshape(PACK_ROWS, W), twi.reshape(PACK_ROWS, W)
    zr = yr * tr - yi * ti
    zi = yr * ti + yi * tr

    def to2(x):
        if pq:   # concat over p of (F, N1, Q) slices: columns p·Q + q
            return torch.cat([x[:, :, p * N1:(p + 1) * N1].transpose(1, 2)
                              for p in range(PACK)], dim=-1).reshape(F * N1, N2)
        # (F, q, p, k1) -> (F, k1, q, p): columns PACK·q + p = n2
        return x.reshape(F, PACK_ROWS, PACK, N1).permute(0, 3, 1, 2) \
            .reshape(F * N1, N2)
    return to2(zr), to2(zi)


def _wide_stage1(re: torch.Tensor, im: torch.Tensor):
    """P5's stage 1 (``profile_pallas.py:444-459``): ar and ai each times
    the N-stacked :func:`wide_weights`, the six column groups summed in
    order and combined; (yr, yi) (F, N2, N1)."""
    F = re.shape[0]
    Wc = torch.from_numpy(ff.bf16_value(wide_weights())).to(re.device)
    A = re.reshape(F * N2, N1) @ Wc
    B = im.reshape(F * N2, N1) @ Wc

    def g(t, j):
        return t[:, j * N1:(j + 1) * N1]
    yr = (g(A, 0) + g(A, 1) + g(A, 2)) - (g(B, 3) + g(B, 4) + g(B, 5))
    yi = (g(A, 3) + g(A, 4) + g(A, 5)) + (g(B, 0) + g(B, 1) + g(B, 2))
    return yr.reshape(F, N2, N1), yi.reshape(F, N2, N1)


def _karatsuba_stage1(cat: bool, re: torch.Tensor, im: torch.Tensor):
    """P3's stage 1 (``profile_pallas.py:267-283``): t1 = ar·w1r, t2 =
    ai·w1i, t3 = as·w1s (as = ar + ai) against :func:`karatsuba_weights`,
    each the sum of its 3 terms' products in term order; with ``cat``,
    P4's (352-358): one product of [ar ar ar ai ai ai as as as] with the
    block-diagonal :func:`s1cat_weights`, sliced into t1, t2, t3. yr = t1 -
    t2, yi = t3 - t1 - t2; (F, N2, N1) each."""
    F = re.shape[0]
    planes = [p.reshape(F * N2, N1) for p in (re, im, re + im)]
    if cat:
        B = torch.from_numpy(ff.bf16_value(s1cat_weights())).to(re.device)
        t = torch.cat([p for p in planes for _ in range(3)], dim=-1) @ B
        t1, t2, t3 = (t[:, g * N1:(g + 1) * N1] for g in range(3))
    else:
        W = torch.from_numpy(ff.bf16_value(karatsuba_weights())).to(
            re.device).reshape(3, 3, N1, N1)
        t1, t2, t3 = (p @ W[g, 0] + p @ W[g, 1] + p @ W[g, 2]
                      for g, p in enumerate(planes))
    yr = t1 - t2
    yi = t3 - t1 - t2
    return yr.reshape(F, N2, N1), yi.reshape(F, N2, N1)


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
    if v.kernel in ("k1", "k1r"):
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


# --- the stage-1 probes' constants ---

@functools.lru_cache(maxsize=1)
def packed_weights() -> Tuple[np.ndarray, np.ndarray]:
    """(PWR, PWI), (6·PACK·N1, PACK·N1) bf16 bit patterns: each of the six
    N1-row K-stack blocks of K3's WR and WI as kron(I_PACK, block), rows
    (block, p, n1) and columns (p, k1), zero bits elsewhere (the TPU's
    ``packw``, ``probes/profile_pallas.py:167-170``, of its own terms)."""
    WR, WI, *_ = ff.constants(N, N1, N2, False)

    def pack(W):
        out = np.zeros((6, PACK, N1, PACK, N1), np.uint16)
        for p in range(PACK):
            out[:, p, :, p, :] = W.reshape(6, N1, N1)
        return out.reshape(6 * PACK * N1, PACK * N1)
    return pack(WR), pack(WI)


def pq_permutation() -> np.ndarray:
    """P6's stage-2 weight rows (``profile_pallas.py:530``): row p·Q + q
    is w2's row PACK·q + p."""
    return np.array([PACK * q + p for p in range(PACK)
                     for q in range(PACK_ROWS)])


@functools.lru_cache(maxsize=1)
def wide_weights() -> np.ndarray:
    """(N1, 6·N1) bf16 bit patterns [w1r0 w1r1 w1r2 w1i0 w1i1 w1i2]
    (``probes/profile_pallas.py:434-436``): the three bf16 terms of the
    length-N1 DFT's real and imaginary parts, blocks 2j of K3's WR and
    WI."""
    WR, WI, *_ = ff.constants(N, N1, N2, False)
    return np.hstack([W[2 * j * N1:(2 * j + 1) * N1]
                      for W in (WR, WI) for j in range(3)])


@functools.lru_cache(maxsize=1)
def karatsuba_weights() -> np.ndarray:
    """(9·N1, N1) bf16 bit patterns [w1r0 w1r1 w1r2 w1i0 w1i1 w1i2 w1s0
    w1s1 w1s2]: the 3 bf16 terms of the length-N1 DFT's real part, its
    imaginary part and their sum w1s = w1r + w1i, each split from float64
    by successive rounding through float32 (as ``ml_dtypes`` rounds): the
    Karatsuba stage 1's weights (``probes/profile_pallas.py:262, 281``,
    from the ``_constants`` of its time; today's builds no w1s). w1r's and
    w1i's terms are blocks 2j of K3's WR and WI."""
    a = np.arange(N1, dtype=np.float64)
    ang = -2.0 * np.pi * (np.outer(a, a) % N1) / N1
    w1r, w1i = np.cos(ang), np.sin(ang)
    return np.concatenate([ff.bf16_terms(w, 3) for w in (w1r, w1i, w1r + w1i)
                           ]).reshape(9 * N1, N1)


@functools.lru_cache(maxsize=1)
def s1cat_weights() -> np.ndarray:
    """(9·N1, 3·N1) bf16 bit patterns: P4's block-diagonal B
    (``probes/profile_pallas.py:331-335``), rows (3g + j, n1), columns
    (g, k1): term j of weight g (w1r, w1i, w1s of
    :func:`karatsuba_weights`) where the column block is g, zero bits
    elsewhere (18 of the 27 blocks)."""
    K = karatsuba_weights().reshape(3, 3, N1, N1)
    B = np.zeros((9, N1, 3, N1), np.uint16)
    for g in range(3):
        for j in range(3):
            B[3 * g + j, :, g, :] = K[g, j]
    return B.reshape(9 * N1, 3 * N1)


@functools.lru_cache(maxsize=1)
def best_weights() -> Tuple[np.ndarray, np.ndarray]:
    """(XR, XI), (6·N2, N2) bf16 bit patterns: P8's stage-2 stacks
    against the lhs [z0r z0r z1r z0i z0i z1i], vstack(r0 r1 r0 -i0 -i1
    -i0) and vstack(i0 i1 i0 r0 r1 r0) of the 2-term splits of the
    length-N2 DFT (``probes/profile_pallas.py:718-721``): K3's own
    stage-2 terms r0, r1, i0, i1."""
    _, _, _, _, r, i, _ = ff.constants(N, N1, N2, False)
    order = (0, 1, 0)
    neg = np.uint16(0x8000)
    XR = np.vstack([r[j] for j in order] + [i[j] ^ neg for j in order])
    XI = np.vstack([i[j] for j in order] + [r[j] for j in order])
    return XR, XI


@functools.lru_cache(maxsize=1)
def kstack_weights() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """P10 v6k's stage-2 stacks (``probes/profile_pallas.py:938-943``),
    (6·N2, N2) bf16 bit patterns each: vstack(c0 c1 c2 c0 c1 c0) of the
    3-term splits of the length-N2 DFT's real part, imaginary part and
    their sum, against the lhs [z0 z0 z0 z1 z1 z2] of each part; tpu6's
    own terms (the kernel reads them as tpu6's 9 B-fragment planes)."""
    *_, w2r, w2i, w2s = ff.constants(N, N1, N2, False)
    order = (0, 1, 2, 0, 1, 0)
    return tuple(np.vstack([m[j] for j in order]) for m in (w2r, w2i, w2s))


@functools.lru_cache(maxsize=2)
def left_w2(products: int) -> np.ndarray:
    """The left form's stage-2 weights: the terms of w2r, w2i and w2s
    transposed (rows k2, columns n2) as A-fragment planes, 3 terms each at
    6 products (tpu6's, P16 left) or 2 at 3 (K3's, P9 v5left,
    ``probes/profile_pallas.py:799-805``): (3·terms, N2/16, N2/16, 32, 8)
    uint16 in the order w2r0.., w2i0.., w2s0.."""
    terms = {6: 3, 3: 2}[products]
    *_, w2r, w2i, w2s = ff.constants(N, N1, N2, False)
    return np.stack([pack_a_fragments(np.ascontiguousarray(m[j].T))
                     for m in (w2r, w2i, w2s) for j in range(terms)])


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


@functools.lru_cache(maxsize=8)
def _left_w2(device: torch.device, products: int) -> torch.Tensor:
    return torch.from_numpy(left_w2(products).view(np.int16)).to(device)


@functools.lru_cache(maxsize=4)
def _e2_offsets(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(e2_offsets()).to(device)


def _b_fragments(bits: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(ff.pack_b_fragments(bits).view(np.int16)).to(
        device)


@functools.lru_cache(maxsize=4)
def _packed_w1(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed forms' stage-1 weights: the block-diagonal stacks of
    :func:`packed_weights` as B fragments."""
    return tuple(_b_fragments(m, device) for m in packed_weights())


@functools.lru_cache(maxsize=4)
def _wide_w1(device: torch.device) -> torch.Tensor:
    return _b_fragments(wide_weights(), device)


@functools.lru_cache(maxsize=4)
def _karatsuba_w1(device: torch.device, cat: bool) -> torch.Tensor:
    """The Karatsuba forms' stage-1 weights as B fragments: the 9 planes
    stacked, or P4's block-diagonal matrix."""
    return _b_fragments(s1cat_weights() if cat else karatsuba_weights(),
                        device)


@functools.lru_cache(maxsize=4)
def _pq_w2(device: torch.device) -> torch.Tensor:
    """K3's 6 stage-2 B-fragment planes with rows in P6's (p, q) order."""
    _, _, _, _, w2r, w2i, w2s = ff.constants(N, N1, N2, False)
    perm = pq_permutation()
    w2 = np.stack([ff.pack_b_fragments(m[j][perm]) for m in (w2r, w2i, w2s)
                   for j in (0, 1)])
    return torch.from_numpy(w2.view(np.int16)).to(device)


def _eligible(n: int) -> bool:
    return n == N


def block_frames(variant: str, F: int, chunk: int,
                 group: Optional[int] = None,
                 device: Optional[torch.device] = None) -> int:
    """Frames one block of ``variant`` sums (the TPU probes' tile):
    ``group``, or K3's and the radix-2 kernel's ``frames_per_block``
    rounded up to a multiple of the variant's chains (the register
    kernel's cuts: K1's own ``k1_group`` on the CUDA ``device``; on the
    CPU, whose plain version has no grid, ``chunk``). Raises ValueError
    for a group that is not a positive multiple of its chains (the TPU's
    tile split into chains, ``probes/s2_ilv.py:38-39``)."""
    chains = VARIANTS[variant].chains
    if group is None and VARIANTS[variant].kernel == "k1r":
        if device is None or device.type != "cuda":
            return chunk
        return k1_group(F, chunk, resident_blocks(N, False, device.index))
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
    group = block_frames(variant, F, chunk, group, raw_u8.device)
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
    if v.kernel in ("k1", "k1r"):
        w1r = w1i = w2 = None
        tw = (_device_twiddles if v.kernel == "k1"
              else _device_pass_twiddles)(N, device).data_ptr()
    else:
        ops = ff._device_operands(N, False, device)
        w1r, w1i, tw = (t.data_ptr() for t in ops[:3])
        if v.s1_form in (PACKED, PACKED_PQ):
            w1r, w1i = (t.data_ptr() for t in _packed_w1(device))
        elif v.s1_form == WIDE:
            w1r = w1i = _wide_w1(device).data_ptr()
        elif v.s1_form in (KARATSUBA3, CAT):
            w1r = w1i = _karatsuba_w1(device, v.s1_form == CAT).data_ptr()
        w2 = (_left_w2(device, v.s2_products) if v.s2_form == LEFT
              else _tpu6_w2(device) if v.s2_products == 6
              else _pq_w2(device) if v.s1_form == PACKED_PQ
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


# --- the radix-2 control ---

#: The sizes the radix-2 control takes: the K1/K2 shapes chip_smoke.py
#: times.
RADIX2_N = (256, 2048, 8192, 16384)


def radix2_psd(raw_u8: torch.Tensor, n_valid: int, chunk: int,
               window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The radix-2 kernel whole (``csrc/fused_psd.cuh`` at its default cut,
    on :func:`frames_per_block`'s grid, with :func:`stage_twiddles`), as
    K1 and K2 were until the register transform: (F, 2N) uint8 frames, N
    in :data:`RADIX2_N` -> (N,) float32, the redesign's control. A CPU
    tensor runs the plain version (``fused_psd_reference``). Counted as
    ``COUNTS.kernel["radix2"]``."""
    n_valid = int(n_valid)
    check_args("radix2_psd", lambda n: n in RADIX2_N, raw_u8, n_valid, chunk,
               window)
    if raw_u8.device.type == "cpu":
        COUNTS.plain["radix2"] += 1
        return fused_psd_reference(raw_u8, n_valid, chunk, window)
    if raw_u8.device.type != "cuda":
        raise ValueError(f"radix2_psd runs on cuda or cpu tensors, not "
                         f"{raw_u8.device}")
    check_alignment("radix2_psd", raw_u8, 4, window, 8)
    from . import _build
    lib = _build.load("fused_psd_probe")
    F, n = raw_u8.shape[0], raw_u8.shape[1] // 2
    group = frames_per_block(F, chunk)
    device = raw_u8.device
    partial = torch.empty((-(-F // group), n), dtype=torch.float32,
                          device=device)
    out = torch.empty(n, dtype=torch.float32, device=device)
    err = lib.rpf_radix2_psd(
        raw_u8.data_ptr(), _device_twiddles(n, device).data_ptr(),
        None if window is None else window.data_ptr(), partial.data_ptr(),
        out.data_ptr(), device.index, n.bit_length() - 1, F, group, n_valid,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(
            f"radix2_psd launch failed: "
            f"{lib.rpf_cuda_error_string(err).decode()} (cudaError {err})")
    COUNTS.kernel["radix2"] += 1
    return out


def large_radix2_psd(raw_u8: torch.Tensor, n_valid: int, chunk: int,
                     window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The large-N kernel as it was before its register passes: the
    radix-2 passes ``large_pass_a``/``large_pass_b`` and the row sum
    (``rpf_fused_psd_large_radix2``) on ``fused_psd_large.frames_per_block``'s
    grid, with the wrapper's host path of that time (three allocations, a
    Stream object, the C entry's ``cudaSetDevice``): (F, 2N) uint8 frames,
    32768 <= N <= 2^22 -> (N,) float32, the redesign's control. A CPU
    tensor runs the plain version (``fused_psd_large_reference``). Counted
    as ``COUNTS.kernel["large_radix2"]``."""
    from . import fused_psd_large as fl
    n_valid = int(n_valid)
    check_args("large_radix2_psd", fl.fused_psd_large_eligible, raw_u8,
               n_valid, chunk, window)
    if raw_u8.device.type == "cpu":
        COUNTS.plain["large_radix2"] += 1
        return fl.fused_psd_large_reference(raw_u8, n_valid, chunk, window)
    if raw_u8.device.type != "cuda":
        raise ValueError(f"large_radix2_psd runs on cuda or cpu tensors, "
                         f"not {raw_u8.device}")
    # 32-bit IQ words; the window as float2, two samples per word.
    check_alignment("large_radix2_psd", raw_u8, 4, window, 8)
    from . import _build
    lib = _build.load("fused_psd_large")
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    group = fl.frames_per_block(F, chunk, N)
    device = raw_u8.device
    twiddle, inter = fl._device_tables(N, device)
    scratch = torch.empty((F, N, 2), dtype=torch.float32, device=device)
    partial = torch.empty((-(-F // group), N), dtype=torch.float32,
                          device=device)
    out = torch.empty((N,), dtype=torch.float32, device=device)
    err = lib.rpf_fused_psd_large_radix2(
        raw_u8.data_ptr(), twiddle.data_ptr(), inter.data_ptr(),
        None if window is None else window.data_ptr(), scratch.data_ptr(),
        partial.data_ptr(), out.data_ptr(), device.index,
        N.bit_length() - 1, F, group, n_valid,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(
            f"large_radix2_psd launch failed: "
            f"{lib.rpf_cuda_error_string(err).decode()} (cudaError {err})")
    COUNTS.kernel["large_radix2"] += 1
    return out


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
