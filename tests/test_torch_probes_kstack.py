"""The port's Karatsuba and K-stacking probes (P3, P4, P7, P8) on the CPU.

Each Hopper variant's plain PyTorch version
(``ops/kernels/fused_psd_probe.py``) is held against its TPU probe at
N = 2048, the port's split N1 x N2 = 32 x 64, F = 16 and the TPU's tile 8.
``probes/profile_pallas.py`` cannot be imported (it runs P1's variants at
import, 148, and its ``consts_np``, 23, unpacks today's seven
``_constants`` arrays into eight names), so ``build_dg3dall``,
``build_s1cat``, ``build_s1k``, ``build_best`` and the ``_np_bf16`` three
of them call are parsed out of the file with ``ast`` and executed in a
namespace of their own, with the eight Karatsuba arrays the text expects
as ``consts_np`` (``tests/test_torch_probes_pack.py:karatsuba_consts``),
and run in interpret mode. The port's stage 1 and stage 2 run the same
bf16 terms and products as the TPU text and differ only in the order of
f32 sums: rtol 2e-5, P1's (tests/test_torch_probes.py). P7's ``s1k96`` is
K3's own stage 1 and runs against ``k3``'s plain version.

The CUDA kernels run only on a card (chip_smoke.py, and the test marked
``cuda``); the Karatsuba stage 1's gather (with as = ar + ai) and its
9-plane and block-diagonal B-fragment indices, the three chains, and the
2-term 4-mult stage 2's pairing of A and B planes are transcribed here
from ``csrc/fused_psd_fast.cuh`` and run on one frame in float64.
"""

import ast
import importlib

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_fast as ff
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
from rtl_power_fftw_tpu_torch.probes._timing import tone_frames
from test_torch_probes_pack import (BF, REPO, _b_regs, _mma, _reference_z,
                                    frames, golden, interpret,
                                    karatsuba_consts, max_rel, plain, u16)

N, N1, N2 = fpp.N, fpp.N1, fpp.N2
F = 16
TILE = 8
P1_RTOL = 2e-5
TONE_FACTOR = 2.0
# Float64 transcriptions against float64 products of the same bf16 terms:
# only the order of float64 sums differs.
EXACT_RTOL = 1e-12

NEW = ("k3_dg3dall", "k3_s1cat", "k3_s1k32", "k3_best")
# TPU name -> (build, its leading arguments, the Hopper variant)
BUILDS = {"dg3dall": ("build_dg3dall", (), "k3_dg3dall"),
          "s1cat": ("build_s1cat", (), "k3_s1cat"),
          "s1k32": ("build_s1k", (1,), "k3_s1k32"),
          "s1k96": ("build_s1k", (3,), "k3"),
          "best": ("build_best", (), "k3_best")}
TEXT_NODES = ("build_dg3dall", "build_s1cat", "build_s1k", "build_best",
              "_np_bf16")


@pytest.fixture
def kstack_builds(interpret):
    """The four builds and ``_np_bf16`` from the text of
    probes/profile_pallas.py, in a namespace of their own."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    path = REPO / "probes" / "profile_pallas.py"
    tree = ast.parse(path.read_text())
    nodes = [n for n in tree.body if isinstance(n, ast.FunctionDef)
             and n.name in TEXT_NODES]
    assert sorted(n.name for n in nodes) == sorted(TEXT_NODES)
    ns = {"N": N, "F": F, "N1": N1, "N2": N2, "TILE_F": TILE, "np": np,
          "jnp": jnp, "jax": jax, "pl": pl, "pltpu": pltpu,
          "consts_np": karatsuba_consts()}
    exec(compile(ast.Module(body=nodes, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


def run_text(ns, tpu_name, raw8, n_valid, tile=TILE):
    import jax.numpy as jnp
    build, args, _ = BUILDS[tpu_name]
    fn = ns[build](*args, tile)
    return np.asarray(fn(jnp.asarray(u16(raw8)), n_valid))


# --- against profile_pallas.py's text ---

@pytest.mark.parametrize("tpu_name", sorted(BUILDS))
@pytest.mark.parametrize("n_valid", [F, 11])
def test_plain_against_the_tpu_text(kstack_builds, tpu_name, n_valid):
    raw8 = frames(F, 51)
    want = run_text(kstack_builds, tpu_name, raw8, n_valid)
    probe = next(p for p in fpp.PROBES.values() if tpu_name in p.variants
                 and p.module == "profile_kernel"
                 and p.tpu in ("P3", "P4", "P7", "P8"))
    variant = probe.variants[tpu_name]
    assert variant == BUILDS[tpu_name][2]
    assert max_rel(plain(variant, raw8, n_valid), want) <= P1_RTOL


def test_best_text_at_twice_the_tile(kstack_builds):
    # profile_pallas.py:782-787 runs best at tiles 128 and 256
    raw8 = frames(F, 52)
    got = plain("k3_best", raw8)
    for tile in (TILE, 2 * TILE):
        assert max_rel(got, run_text(kstack_builds, "best", raw8, F,
                                     tile)) <= P1_RTOL
    assert max_rel(got, golden(raw8)) <= 1e-5


@pytest.mark.parametrize("n_valid", [F, 9, 0])
@pytest.mark.parametrize("variant", NEW)
def test_new_plain_is_k3s_spectrum(variant, n_valid):
    raw8 = frames(F, 53)
    got = plain(variant, raw8, n_valid, 8)
    if n_valid == 0:
        np.testing.assert_array_equal(got, np.zeros(N, np.float32))
    else:
        assert max_rel(got, plain("k3", raw8, n_valid, 8)) <= fpp.RTOL_SCHEME


@pytest.mark.parametrize("n_valid", [F, 11])
def test_s1cat_plain_is_dg3dalls_spectrum(n_valid):
    # the same Karatsuba stage 1 as one product: only its f32 sum order
    raw8 = frames(F, 54)
    assert max_rel(plain("k3_s1cat", raw8, n_valid, 8),
                   plain("k3_dg3dall", raw8, n_valid, 8)) <= fpp.RTOL_SCHEME


def test_best_under_the_tone_is_within_twice_k3s():
    """P8 has no zs = zr + zi plane to cancel in: on P14's 35 dB tone its
    plain version stays within 2x of K3's error against the float64
    golden, realization by realization (the rule K3 is held to against
    the JAX fast scheme)."""
    raw = tone_frames(4 * F, N)
    ratios = []
    for k in range(4):
        raw8 = np.ascontiguousarray(raw[k * F:(k + 1) * F])
        gold = golden(raw8)
        best = max_rel(plain("k3_best", raw8), gold)
        k3 = max_rel(plain("k3", raw8), gold)
        ratios.append(best / k3)
        assert best <= TONE_FACTOR * k3, (k, best, k3)
    assert max(ratios) <= TONE_FACTOR


# --- the weights against the TPU text ---

def test_karatsuba_weights_are_the_texts_terms():
    w1r, w1i, w1s, *_ = karatsuba_consts()
    K = fpp.karatsuba_weights().reshape(3, 3, N1, N1)
    for g, w in enumerate((w1r, w1i, w1s)):
        np.testing.assert_array_equal(K[g], w.view(np.uint16))
    # w1r's and w1i's terms are K3's K-stack blocks 2j
    WR, WI, *_ = ff.constants(N, N1, N2, False)
    for j in range(3):
        np.testing.assert_array_equal(K[0, j], WR[2 * j * N1:(2 * j + 1) * N1])
        np.testing.assert_array_equal(K[1, j], WI[2 * j * N1:(2 * j + 1) * N1])


def test_s1cat_weights_are_the_texts_b():
    # profile_pallas.py:331-335
    w1r, w1i, w1s, *_ = karatsuba_consts()
    B = np.zeros((9 * N1, 3 * N1), np.float32)
    for g, wk in enumerate((w1r, w1i, w1s)):
        for j in range(3):
            B[(3 * g + j) * N1:(3 * g + j + 1) * N1, g * N1:(g + 1) * N1] = \
                wk[j].astype(np.float32)
    np.testing.assert_array_equal(fpp.s1cat_weights(),
                                  B.astype(BF).view(np.uint16))
    # 18 of its 27 blocks are zero: 3x the Karatsuba planes' bytes
    assert fpp.s1cat_weights().nbytes == 3 * fpp.karatsuba_weights().nbytes


def test_best_weights_are_the_texts_xr_xi():
    # profile_pallas.py:718-721
    *_, w2r, w2i, _ = karatsuba_consts()
    f = lambda a: a.astype(np.float32)
    c2r0, c2r1, c2i0, c2i1 = f(w2r[0]), f(w2r[1]), f(w2i[0]), f(w2i[1])
    XR = np.vstack([c2r0, c2r1, c2r0, -c2i0, -c2i1, -c2i0])
    XI = np.vstack([c2i0, c2i1, c2i0, c2r0, c2r1, c2r0])
    got = fpp.best_weights()
    for m, want in zip(got, (XR, XI)):
        np.testing.assert_array_equal(m, want.astype(BF).view(np.uint16))
    # K3's own stage-2 planes r0, r1, i0, i1 (kernel_constants' w2 0..3)
    _, _, _, w2 = ff.kernel_constants(N, False)
    np.testing.assert_array_equal(
        w2[:4], np.stack([ff.pack_b_fragments(got[1][N2 * 3:N2 * 4]),
                          ff.pack_b_fragments(got[1][N2 * 4:N2 * 5]),
                          ff.pack_b_fragments(got[1][:N2]),
                          ff.pack_b_fragments(got[1][N2:2 * N2])]))


# --- index transcriptions ---

def _k3_gather(iq, c, mt, planes):
    """fused_psd_fast.cuh:gather_k3, per lane (32, 8) in register order:
    ar, ai and (planes = 3) as = ar + ai."""
    a = np.zeros((planes, 32, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for q in range(4):
            n = N2 * (16 * c + 2 * t + 8 * (q >> 1)) + 16 * mt + g \
                + 8 * (q & 1)
            for h, v in enumerate((iq[n], iq[n + N2])):
                r, i = float(v & 0xFF) - 127.0, float(v >> 8) - 127.0
                a[0, lane, 2 * q + h] = r
                a[1, lane, 2 * q + h] = i
                if planes == 3:
                    a[2, lane, 2 * q + h] = r + i
    return a


def _y_of_items(raw8, item_y):
    """Y[n2][k1] of one frame, item by item: item_y(iq, mt, ng) -> (yr,
    yi), each (2, 16, 8) D tiles of n-tiles j, written where the frame
    loop's epilogue writes them."""
    iq = u16(raw8[None])[0].astype(np.uint32)
    y = np.full((N2, N1), np.nan, complex)
    for item in range(N // 256):
        mt, ng = item // (N1 // 16), item % (N1 // 16)
        yr, yi = item_y(iq, mt, ng)
        for j in range(2):
            rows = slice(16 * mt, 16 * mt + 16)
            cols = slice(16 * ng + 8 * j, 16 * ng + 8 * j + 8)
            assert np.isnan(y[rows, cols]).all()
            y[rows, cols] = yr[j] + 1j * yi[j]
    return y


def _y_reference(raw8, W):
    """Float64 Y = x·W of one frame, (N2, N1), x[n2][n1] = x[N2 n1 + n2]
    dequantized; W complex (N1, N1) float64 of bf16 values."""
    x = ((raw8[0::2].astype(np.float64) - 127.0)
         + 1j * (raw8[1::2].astype(np.float64) - 127.0)).reshape(N1, N2)
    return x.T @ W


@pytest.mark.parametrize("cat", [False, True])
def test_karatsuba_stage1_indices_transcribed(cat):
    """stage1_karatsuba on one frame, products in float64: the gather of
    ar, ai, as, the 9-plane (or block-diagonal) B fragment indices and
    the combination, against x times the same bf16 terms, and the DFT."""
    raw8 = frames(1, 55)[0]
    if cat:
        frags = ff.pack_b_fragments(fpp.s1cat_weights())
    else:
        frags = ff.pack_b_fragments(fpp.karatsuba_weights())

    def item_y(iq, mt, ng):
        tk = np.zeros((3, 2, 16, 8))
        for c in range(N1 // 16):
            a = _k3_gather(iq, c, mt, 3)
            if cat:
                for b in range(9):
                    for gw in range(3):
                        for j in range(2):
                            tk[gw, j] += _mma(a[b // 3], _b_regs(
                                frags, b * (N1 // 16) + c,
                                gw * (N1 // 8) + 2 * ng + j))
            else:
                for term in range(3):
                    for gw in range(3):
                        for j in range(2):
                            tk[gw, j] += _mma(a[gw], _b_regs(
                                frags, (3 * gw + term) * (N1 // 16) + c,
                                2 * ng + j))
        return tk[0] - tk[1], tk[2] - tk[0] - tk[1]

    y = _y_of_items(raw8, item_y)
    K = ff.bf16_value(fpp.karatsuba_weights()).astype(np.float64) \
        .reshape(3, 3, N1, N1).sum(axis=1)        # w1r, w1i, w1s: 3 terms
    x = ((raw8[0::2].astype(np.float64) - 127.0),
         (raw8[1::2].astype(np.float64) - 127.0))
    ar, ai = (p.reshape(N1, N2).T for p in x)
    t1, t2, t3 = ar @ K[0], ai @ K[1], (ar + ai) @ K[2]
    want = (t1 - t2) + 1j * (t3 - t1 - t2)
    assert np.abs(y - want).max() <= EXACT_RTOL * np.abs(want).max()
    # and the DFT, to the bf16 terms' error
    dft = _reference_z(raw8) / np.exp(
        -2j * np.pi * np.arange(N2)[:, None] * np.arange(N1)[None, :] / N)
    assert np.abs(y - dft).max() <= 1e-4 * np.abs(dft).max()


def test_split_k_stage1_indices_transcribed():
    """stage1_split_k on one frame, products in float64: K3's gather and B
    indices, block b into chain b // 2, the chains summed in order."""
    raw8 = frames(1, 56)[0]
    WR, WI, *_ = ff.constants(N, N1, N2, False)
    fr, fi = ff.pack_b_fragments(WR), ff.pack_b_fragments(WI)

    def item_y(iq, mt, ng):
        cr, ci = np.zeros((3, 2, 16, 8)), np.zeros((3, 2, 16, 8))
        for c in range(N1 // 16):
            a = _k3_gather(iq, c, mt, 2)
            for b in range(6):
                for j in range(2):
                    kc, nt = b * (N1 // 16) + c, 2 * ng + j
                    cr[b // 2, j] += _mma(a[b & 1], _b_regs(fr, kc, nt))
                    ci[b // 2, j] += _mma(a[b & 1], _b_regs(fi, kc, nt))
        return cr[0] + cr[1] + cr[2], ci[0] + ci[1] + ci[2]

    y = _y_of_items(raw8, item_y)
    r = ff.bf16_value(WR).astype(np.float64)
    i = ff.bf16_value(WI).astype(np.float64)
    # [ar ai] against the K-stack: W = sum_j (r_j + i·i_j) in complex form
    W = sum(r[2 * j * N1:(2 * j + 1) * N1] + 1j * i[2 * j * N1:(2 * j + 1)
                                                   * N1] for j in range(3))
    want = _y_reference(raw8, W)
    assert np.abs(y - want).max() <= EXACT_RTOL * np.abs(want).max()


def test_best_stage2_pairing_transcribed():
    """The 2-term 4-mult stage 2 (kS2FourMult, S2_PRODUCTS = 3) on one
    frame's Z, products in float64: Z's 2-term splits as A planes z0r,
    z1r, z0i, z1i, K3's B planes r0, r1, i0, i1 (kernel_constants' w2),
    -i as the sign of z0i, z1i, 12 products into u1 (xr) and u2 (xi);
    against P8's K-stacked lhs times best_weights in float64, and the
    DFT."""
    raw8 = frames(1, 57)[0]
    z = _reference_z(raw8).astype(np.complex64)        # [n2][k1]
    def split2(x):
        x = np.asarray(x, np.float32)
        z0 = x.astype(BF).astype(np.float32)
        return z0, (x - z0).astype(BF).astype(np.float32)
    (z0r, z1r), (z0i, z1i) = split2(z.real), split2(z.imag)
    _, _, _, w2 = ff.kernel_constants(N, False)
    r0, r1, i0, i1 = w2[:4]
    X = np.full((N1, N2), np.nan, complex)             # [k1][k2]
    for item in range(N // 256):
        mt, ng = item // (N2 // 16), item % (N2 // 16)
        u1, u2 = np.zeros((2, 16, 8)), np.zeros((2, 16, 8))
        for c in range(N2 // 16):
            a = np.zeros((4, 32, 8))
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for q in range(4):
                    k1 = 16 * mt + g + 8 * (q & 1)
                    n2 = 16 * c + 2 * t + 8 * (q >> 1)
                    for h in range(2):
                        for p, plane in enumerate((z0r, z1r, z0i, z1i)):
                            a[p, lane, 2 * q + h] = plane[n2 + h, k1]
            for j in range(2):
                B = [_b_regs(m, c, 2 * ng + j) for m in (r0, r1, i0, i1)]
                u1[j] += (_mma(a[0], B[0]) + _mma(a[0], B[1])
                          + _mma(a[1], B[0]) + _mma(-a[2], B[2])
                          + _mma(-a[2], B[3]) + _mma(-a[3], B[2]))
                u2[j] += (_mma(a[0], B[2]) + _mma(a[0], B[3])
                          + _mma(a[1], B[2]) + _mma(a[2], B[0])
                          + _mma(a[2], B[1]) + _mma(a[3], B[0]))
        for j in range(2):
            rows = slice(16 * mt, 16 * mt + 16)
            cols = slice(16 * ng + 8 * j, 16 * ng + 8 * j + 8)
            assert np.isnan(X[rows, cols]).all()
            X[rows, cols] = u1[j] + 1j * u2[j]
    XR, XI = (ff.bf16_value(m).astype(np.float64).reshape(6, N2, N2)
              for m in fpp.best_weights())
    lhs2 = [p.T.astype(np.float64) for p in (z0r, z0r, z1r, z0i, z0i, z1i)]
    want = sum(l @ w for l, w in zip(lhs2, XR)) \
        + 1j * sum(l @ w for l, w in zip(lhs2, XI))
    assert np.abs(X - want).max() <= EXACT_RTOL * np.abs(want).max()
    dft = np.fft.fft(z.astype(np.complex128), axis=0).T   # [k1][k2]
    assert np.abs(X - dft).max() <= 1e-4 * np.abs(dft).max()


# --- the registry, the work and the wrappers ---

def test_registry_holds_the_kstack_probes():
    src = (REPO / "rtl_power_fftw_tpu_torch/ops/kernels/csrc/"
           "fused_psd_probe.cu").read_text()
    names = list(fpp.VARIANTS)
    for name, code in zip(NEW, (41, 42, 43, 44)):
        v = fpp.VARIANTS[name]
        assert v.code == code and f" = {code}," in src and v.psd
        assert v.kernel == "k3" and v.cut == fpp.CUT_FULL
        assert v.s1_terms == 3 and v.s2_products == 3 and v.twiddle
    assert [fpp.VARIANTS[n].s1_form for n in NEW] == [
        fpp.KARATSUBA3, fpp.CAT, fpp.SPLIT_K, fpp.KSTACK]
    assert fpp.VARIANTS["k3_dg3dall"].s2_planes
    assert not any(fpp.VARIANTS[n].s2_planes for n in NEW[1:])
    assert [fpp.VARIANTS[n].s2_form for n in NEW] == [fpp.KARATSUBA] * 3 + [
        fpp.FOURMULT]
    # a parity variant is run before the one it is held to
    assert fpp.VARIANTS["k3_s1cat"].parity == "k3_dg3dall"
    assert names.index("k3_dg3dall") < names.index("k3_s1cat")
    assert all(fpp.VARIANTS[n].parity == "plain"
               for n in ("k3_dg3dall", "k3_s1k32", "k3_best"))
    # s1k96 is K3 itself: one Hopper variant, both TPU names
    assert any(t.startswith("P7 s1k96 ") for t in fpp.VARIANTS["k3"].tpu)
    assert fpp.ZERO_BLOCK_FORMS == (fpp.PACKED, fpp.PACKED_PQ, fpp.CAT)


def test_probes_rows():
    for tpu, line, names in (("P3", 309, {"dg3dall": "k3_dg3dall"}),
                             ("P4", 390, {"s1cat": "k3_s1cat"}),
                             ("P7", 680, {"s1k32": "k3_s1k32",
                                          "s1k96": "k3"}),
                             ("P8", 766, {"best": "k3_best"})):
        probe = fpp.PROBES[tpu]
        assert probe.source == f"probes/profile_pallas.py:{line}"
        assert probe.module == "profile_kernel" and probe.variants == names
        assert probe.default == tuple(names) and not probe.then
        assert probe in fpp.entry_probes("P1")
        for name in names:
            assert name not in fpp.PROBES["P1"].variants
            assert fpp.entry_variants("P1", [name]) == [(probe, name)]
    # with no argv the TPU module runs P1's variants, then pack8; the new
    # builds run only when named (profile_pallas.py:419-428, 696-705, 782)
    assert fpp.PROBES["P1"].then == ("P2",)
    assert [p.tpu for p, _ in fpp.entry_variants("P1")] == ["P1"] * 9 + ["P2"]


def test_work_counts():
    F_ = 4096
    k3 = fpp.k3_work(F_, N)
    s1_mma = 8 * 3 * N * N1
    s1_bytes = 2 * 6 * N1 * N1 * 2
    # the Karatsuba stage 1: 9 products of depth N1 against 9 planes, 4n
    # FP32 more (as and the combination)
    kar = fpp.VARIANTS["k3_dg3dall"].work(F_)
    assert kar[1] == k3[1] - F_ * s1_mma + F_ * 18 * N * N1
    assert kar[0] == k3[0] - s1_bytes + 9 * N1 * N1 * 2
    assert kar[2] == k3[2] + F_ * 4 * N
    # the block-diagonal form: the same spectrum, 3x the work done
    assert fpp.VARIANTS["k3_s1cat"].work(F_) == kar
    done = fpp.VARIANTS["k3_s1cat"].work(F_, zero_blocks=True)
    assert done == (kar[0] + 18 * N1 * N1 * 2, F_ * 54 * N * N1
                    + kar[1] - F_ * 18 * N * N1, kar[2])
    assert fpp.VARIANTS["k3_dg3dall"].work(F_, zero_blocks=True) == kar
    # three chains: K3's products and bytes, 4n FP32 to sum them
    assert fpp.VARIANTS["k3_s1k32"].work(F_) == (k3[0], k3[1],
                                                 k3[2] + F_ * 4 * N)
    # the 2-term 4-mult: 12 products of depth N2 (24·n·N2) against 4 planes
    best = fpp.VARIANTS["k3_best"].work(F_)
    assert best == (k3[0] - 2 * N2 * N2 * 2, k3[1] - F_ * 18 * N * N2
                    + F_ * 24 * N * N2, k3[2])
    # P14's 3-term 4-mult still counts 48·n·N2
    assert fpp.VARIANTS["tpu6_4mult"].work(F_)[1] - \
        fpp.VARIANTS["tpu6"].work(F_)[1] == F_ * (48 - 36) * N * N2
    # by hand, in µs at 989 TFLOP/s bf16 and 67 TFLOP/s FP32 (ops-bound)
    us = {n: 1e6 * (w[1] / 989e12 + w[2] / 67e12)
          for n, w in (("k3", k3), ("kar", kar), ("best", best))}
    assert round(us["k3"], 1) == 17.5
    assert round(us["kar"], 1) == 16.4
    assert round(us["best"], 1) == 20.8


def test_wrappers_dispatch_to_plain_on_cpu_and_count():
    raw = torch.from_numpy(frames(8, 58))
    fpp.COUNTS.reset()
    for name in NEW:
        got = fpp.fused_psd_probe(name, raw, 8, 8, blocks_per_sm=3)
        assert torch.equal(got, fpp.fused_psd_probe_reference(name, raw, 8, 8))
    assert fpp.COUNTS.plain == {name: 1 for name in NEW}
    assert not fpp.COUNTS.kernel


@pytest.mark.cuda
def test_new_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    raw = torch.from_numpy(frames(64, 59)).to(dev)
    ship = {}
    for name in NEW:
        v = fpp.VARIANTS[name]
        got = fpp.fused_psd_probe(name, raw, 40, 16)
        want = fpp.fused_psd_probe_reference(name, raw, 40, 16)
        assert max_rel(got.cpu(), want.cpu()) <= v.rtol, name
        if v.parity != "plain":
            assert torch.equal(got, ship[v.parity]), name
        ship[name] = got
        assert torch.equal(fpp.fused_psd_probe(name, raw, 40, 16,
                                               blocks_per_sm=1), got), name


# --- the entry point ---

@pytest.mark.parametrize("argv,names,tiles", [
    (["dg3dall", "s1cat", "s1k32", "s1k96", "best", "best:2"],
     ["dg3dall", "s1cat", "s1k32", "s1k96", "best", "best"],
     [1, 1, 1, 1, 1, 2]),
    (["best:4", "s1k96:2"], ["best", "s1k96"], [4, 2])])
def test_profile_kernel_takes_the_new_names(argv, names, tiles, capsys):
    from rtl_power_fftw_tpu_torch.probes import profile_kernel
    fpp.COUNTS.reset()
    assert profile_kernel.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    lines = [ln for ln in out if not ln.startswith("#")]
    assert [ln.split()[0] for ln in lines] == names
    tpu = {"dg3dall": "P3", "s1cat": "P4", "s1k32": "P7", "s1k96": "P7",
           "best": "P8"}
    want = [tpu[n] for i, n in enumerate(names)
            if i == 0 or tpu[names[i - 1]] != tpu[n]]
    assert [ln.split()[1] for ln in out if ln.startswith("#")] == want
    assert [int(ln.split("tile=")[1].split()[0]) for ln in lines] == tiles
    assert all("per-step not measured (cpu)" in ln and "max_rel=" in ln
               for ln in lines)
    hopper = [BUILDS[n][2] for n in names]
    assert [ln.split("[")[1].rstrip("]") for ln in lines] == hopper
    assert fpp.COUNTS.plain == {h: hopper.count(h) for h in hopper}


def test_entry_point_refuses_a_tpu_name_it_does_not_have(capsys):
    profile_kernel = importlib.import_module(
        "rtl_power_fftw_tpu_torch.probes.profile_kernel")
    assert profile_kernel.main(["s1k64", "--device", "cpu"]) == 2
    assert "unknown" in capsys.readouterr().err
