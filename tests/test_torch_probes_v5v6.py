"""The port's last two TPU probes, P9 (``build_v5``) and P10 (``build_v6``),
on the CPU.

Each Hopper variant's plain PyTorch version
(``ops/kernels/fused_psd_probe.py``) is held against its TPU build at
N = 2048, the port's split N1 x N2 = 32 x 64, F = 16 and the TPU's tile 8.
``probes/profile_pallas.py`` cannot be imported (it runs P1's variants at
import, 148), so ``build_v5``, ``build_v6`` and ``_np_bf16`` are parsed
out of the file with ``ast`` and executed in a namespace of their own, as
``tests/test_torch_probes_kstack.py`` runs slice 3's builds: with the
eight Karatsuba arrays ``build_v5`` unpacks as ``consts_np``
(``tests/test_torch_probes_pack.py:karatsuba_consts``), and the JAX
package's own ``_constants`` and ``_split``, which ``build_v6`` calls
(922) and names (913-914); then in interpret mode. The port runs the same
bf16 terms and products as the text and differs only in the order of f32
sums: rtol 2e-5, P1's (tests/test_torch_probes.py). ``v5`` is K3 and
``v6`` the 6-product scheme ``tpu6``.

The CUDA kernels run only on a card (chip_smoke.py, and the test marked
``cuda``, which also holds ``k3_left`` to K3 and ``tpu6_zplanes`` to
``tpu6`` bit for bit); the 3-product left form's B fragments and 6 A
planes, the 9-plane stage-1 store and its ``ldmatrix`` addresses, and the
narrow and block-major walks over those planes are transcribed here from
``csrc/fused_psd_fast.cuh`` and run on one frame in float64.
"""

import ast

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
# The split planes' row (fused_psd_fast.cuh: FastSmem::ROW) and plane.
ROW = N2 + 8
ZP_PLANE = N1 * ROW

NEW = ("k3_left", "tpu6_zplanes", "tpu6_kstack")
# TPU name -> (build, its keyword arguments, the Hopper variant)
BUILDS = {"v5": ("build_v5", {}, "k3"),
          "v5left": ("build_v5", {"s2_mode": "left"}, "k3_left"),
          "v6": ("build_v6", {}, "tpu6"),
          "v6k": ("build_v6", {"kstack": True}, "tpu6_kstack")}
TEXT_NODES = ("build_v5", "build_v6", "_np_bf16")


class Recording:
    """jax.numpy, recording the arrays a build hands to ``asarray``: the
    constants the TPU text builds, in its order."""

    def __init__(self, jnp):
        self._jnp = jnp
        self.arrays = []

    def asarray(self, a, *args, **kwargs):
        self.arrays.append(a)
        return self._jnp.asarray(a, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._jnp, name)


@pytest.fixture
def v5v6_builds(interpret):
    """build_v5, build_v6 and _np_bf16 from the text of
    probes/profile_pallas.py, in a namespace of their own; its ``jnp``
    records what the builds hand to ``asarray``."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from rtl_power_fftw_tpu.ops.kernels.fused_psd import _constants, _split
    path = REPO / "probes" / "profile_pallas.py"
    tree = ast.parse(path.read_text())
    nodes = [n for n in tree.body if isinstance(n, ast.FunctionDef)
             and n.name in TEXT_NODES]
    assert sorted(n.name for n in nodes) == sorted(TEXT_NODES)
    ns = {"N": N, "F": F, "N1": N1, "N2": N2, "TILE_F": TILE, "np": np,
          "jnp": Recording(jnp), "jax": jax, "pl": pl, "pltpu": pltpu,
          "consts_np": karatsuba_consts(), "_constants": _constants,
          "_split": _split}
    exec(compile(ast.Module(body=nodes, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


def run_text(ns, tpu_name, raw8, n_valid, tile=TILE):
    import jax.numpy as jnp
    build, kwargs, _ = BUILDS[tpu_name]
    fn = ns[build](tile, **kwargs)
    return np.asarray(fn(jnp.asarray(u16(raw8)), n_valid))


def text_constants(ns, tpu_name):
    """The constants build ``tpu_name`` hands to its pallas_call: (WR, WI,
    twr, twi, w2r, w2i, w2s) as the text builds them."""
    build, kwargs, _ = BUILDS[tpu_name]
    ns["jnp"].arrays.clear()
    ns[build](TILE, **kwargs)
    arrays = list(ns["jnp"].arrays)
    assert len(arrays) == 7
    return arrays


# --- against profile_pallas.py's text ---

@pytest.mark.parametrize("tpu_name", sorted(BUILDS))
@pytest.mark.parametrize("n_valid", [F, 11])
def test_plain_against_the_tpu_text(v5v6_builds, tpu_name, n_valid):
    raw8 = frames(F, 61)
    want = run_text(v5v6_builds, tpu_name, raw8, n_valid)
    probe = fpp.PROBES["P9" if tpu_name.startswith("v5") else "P10"]
    variant = probe.variants[tpu_name]
    assert variant == BUILDS[tpu_name][2]
    assert max_rel(plain(variant, raw8, n_valid), want) <= P1_RTOL


@pytest.mark.parametrize("tpu_name", ["v5left", "v6k"])
def test_new_forms_text_at_twice_the_tile(v5v6_builds, tpu_name):
    raw8 = frames(F, 62)
    got = plain(BUILDS[tpu_name][2], raw8)
    for tile in (TILE, 2 * TILE):
        assert max_rel(got, run_text(v5v6_builds, tpu_name, raw8, F,
                                     tile)) <= P1_RTOL
    assert max_rel(got, golden(raw8)) <= 1e-5


@pytest.mark.parametrize("n_valid", [F, 9, 0])
@pytest.mark.parametrize("variant", NEW)
def test_new_plain_is_k3s_or_tpu6s_spectrum(variant, n_valid):
    raw8 = frames(F, 63)
    got = plain(variant, raw8, n_valid, 8)
    if n_valid == 0:
        np.testing.assert_array_equal(got, np.zeros(N, np.float32))
        return
    scheme = "k3" if variant == "k3_left" else "tpu6"
    want = plain(scheme, raw8, n_valid, 8)
    if variant == "tpu6_zplanes":
        # the same plain version: the kernel differs from tpu6's only in
        # where Z's splits are taken
        np.testing.assert_array_equal(got, want)
    else:
        assert max_rel(got, want) <= fpp.RTOL_SCHEME


@pytest.mark.parametrize("variant,scheme", [("k3_left", "k3"),
                                            ("tpu6_kstack", "tpu6")])
def test_under_the_tone_within_twice_the_schemes(variant, scheme):
    """On P14's 35 dB tone the new forms' plain versions stay within 2x
    of their scheme's error against the float64 golden, realization by
    realization (the rule K3 is held to against the JAX fast scheme)."""
    raw = tone_frames(4 * F, N)
    for k in range(4):
        raw8 = np.ascontiguousarray(raw[k * F:(k + 1) * F])
        gold = golden(raw8)
        ours = max_rel(plain(variant, raw8), gold)
        base = max_rel(plain(scheme, raw8), gold)
        assert ours <= TONE_FACTOR * base, (k, ours, base)


# --- the weights against the TPU text ---

def test_kstack_weights_are_the_texts_stackw(v5v6_builds):
    # profile_pallas.py:926-943: stackw of terms3 of r, i and r + i
    *_, r, i, s = text_constants(v5v6_builds, "v6k")
    got = fpp.kstack_weights()
    for m, want in zip(got, (r, i, s)):
        assert want.shape == (6 * N2, N2)
        np.testing.assert_array_equal(m, np.asarray(want).view(np.uint16))
    # tpu6's own terms: the kernel reads them as tpu6's 9 B planes
    *_, w2r, w2i, w2s = ff.constants(N, N1, N2, False)
    for m, terms in zip(got, (w2r, w2i, w2s)):
        np.testing.assert_array_equal(m.reshape(6, N2, N2),
                                      terms[[0, 1, 2, 0, 1, 0]])
    # and v6's narrow stacks are the same terms (945)
    *_, r3, i3, s3 = text_constants(v5v6_builds, "v6")
    for m, want in zip((w2r, w2i, w2s), (r3, i3, s3)):
        np.testing.assert_array_equal(m, np.asarray(want).view(np.uint16))


def unpack_a_fragments(packed):
    """The inverse of fpp.pack_a_fragments: (M/16, K/16, 32, 8) -> (M,
    K), each element written once."""
    mt_n, kc_n = packed.shape[:2]
    out = np.full((16 * mt_n, 16 * kc_n), -1, np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for q in range(4):
            for h in range(2):
                r = g + 8 * (q & 1)
                c = 2 * t + 8 * (q >> 1) + h
                out[r::16, c::16] = packed[:, :, lane, 2 * q + h]
    assert (out >= 0).all()
    return out.astype(np.uint16)


def test_left_w2_unpacks_to_the_texts_w2t(v5v6_builds):
    # profile_pallas.py:799-805: 2 terms of each, transposed (k2, n2)
    *_, w2rT, w2iT, w2sT = text_constants(v5v6_builds, "v5left")
    planes = fpp.left_w2(3)
    assert planes.shape == (6, N2 // 16, N2 // 16, 32, 8)
    want = [np.asarray(m[j]).view(np.uint16) for m in (w2rT, w2iT, w2sT)
            for j in range(2)]
    for p, w in zip(planes, want):
        np.testing.assert_array_equal(unpack_a_fragments(p), w)
    # K3's own 2-term stage-2 weights, transposed
    *_, w2r, w2i, w2s = ff.constants(N, N1, N2, False)
    for p, (m, j) in zip(planes, [(m, j) for m in (w2r, w2i, w2s)
                                  for j in range(2)]):
        np.testing.assert_array_equal(unpack_a_fragments(p), m[j].T)
    # at 6 products the 9 planes tpu6_left always took
    six = fpp.left_w2(6)
    assert six.shape[0] == 9
    for p, (m, j) in zip(six, [(m, j) for m in (w2r, w2i, w2s)
                               for j in range(3)]):
        np.testing.assert_array_equal(unpack_a_fragments(p), m[j].T)


# --- index transcriptions ---

def _split(x, terms):
    """Successive bf16 terms of float32 x, as float64."""
    r = np.asarray(x, np.float32)
    out = []
    for _ in range(terms):
        t = r.astype(BF).astype(np.float32)
        out.append(t.astype(np.float64))
        r = r - t
    return out


def test_left_stage2_at_three_products_transcribed():
    """stage2_left<LOG2N, 3> on one Z, in float64 products: the warps'
    items, the B gather of Z's 2-term splits, the 6 A planes of
    left_w2(3), c0.z0 + c1.z0 + c0.z1 a part, and the D fragments' bins,
    against the same bf16 terms in float64 and the DFT of Z."""
    rng = np.random.default_rng(64)
    Z = (rng.standard_normal((N2, N1)) + 1j * rng.standard_normal((N2, N1))
         ).astype(np.complex64)
    planes = ff.bf16_value(fpp.left_w2(3)).astype(np.float64)
    zparts = [_split(Z.real, 2), _split(Z.imag, 2),
              _split(Z.real.astype(np.float32) + Z.imag.astype(np.float32),
                     2)]
    X = np.full((N2, N1), np.nan, complex)           # [k2][k1]
    for item in range((N2 // 32) * (N1 // 8)):
        kh, nt = item // (N1 // 8), item % (N1 // 8)
        u = np.zeros((3, 2, 16, 8))
        for c in range(N2 // 16):
            b = np.zeros((3, 2, 32, 4))              # b[part][term]
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                k1, n2 = 8 * nt + g, 16 * c + 2 * t
                for y, dn in enumerate((0, 8)):
                    for h in range(2):
                        for part in range(3):
                            for term in range(2):
                                b[part, term, lane, 2 * y + h] = \
                                    zparts[part][term][n2 + dn + h, k1]
            for m in range(2):
                for part in range(3):
                    w = [planes[2 * part + j][2 * kh + m, c] for j in (0, 1)]
                    u[part, m] += (_mma(w[0], b[part, 0])
                                   + _mma(w[1], b[part, 0])
                                   + _mma(w[0], b[part, 1]))
        x = (u[0] - u[1]) + 1j * (u[2] - u[0] - u[1])
        for m in range(2):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for e in range(4):
                    k2 = 32 * kh + 16 * m + g + 8 * (e >> 1)
                    k1 = 8 * nt + 2 * t + (e & 1)
                    assert np.isnan(X[k2, k1])
                    X[k2, k1] = x[m, g + 8 * (e >> 1), 2 * t + (e & 1)]
    assert not np.isnan(X).any()
    *_, w2r, w2i, w2s = ff.constants(N, N1, N2, False)
    wt = [[ff.bf16_value(m[j]).astype(np.float64).T for j in (0, 1)]
          for m in (w2r, w2i, w2s)]
    u = [w[0] @ z[0] + w[1] @ z[0] + w[0] @ z[1] for w, z in zip(wt, zparts)]
    want = (u[0] - u[1]) + 1j * (u[2] - u[0] - u[1])
    assert np.abs(X - want).max() <= EXACT_RTOL * np.abs(want).max()
    dft = np.fft.fft(Z.astype(np.complex128), axis=0)    # [k2][k1]
    assert np.abs(X - dft).max() <= 1e-4 * np.abs(dft).max()


def _store_planes(z):
    """The frame loop's 9-plane store (TERMS2 = 3) of Z (N2, N1) complex64:
    each stage-1 item's D fragments, 3-term splits of zr, zi and zr + zi
    at [k1][n2] of rows ROW, planes zr0..2, zi0..2, zs0..2; float64 values,
    NaN where nothing is written (the rows' padding)."""
    zp = np.full(9 * ZP_PLANE, np.nan)
    for item in range(N // 256):
        mt, ng = item // (N1 // 16), item % (N1 // 16)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for j in range(2):
                for h in range(2):
                    n2 = 16 * mt + g + 8 * h
                    k1 = 16 * ng + 8 * j + 2 * t
                    for u in range(2):
                        v = z[n2, k1 + u]
                        zr, zi = np.float32(v.real), np.float32(v.imag)
                        at = (k1 + u) * ROW + n2
                        parts = (_split(zr, 3), _split(zi, 3),
                                 _split(zr + zi, 3))
                        for p, terms in enumerate(parts):
                            for e in range(3):
                                i = (3 * p + e) * ZP_PLANE + at
                                assert np.isnan(zp[i])
                                zp[i] = terms[e]
    return zp


def _ldmatrix_x4(zp, addr):
    """ldmatrix.x4 (no .trans) of bf16 elements zp: lane l gives the
    element address addr[l] of row l & 7 of matrix l >> 3; register q of
    lane l holds row l >> 2 of matrix q, columns 2(l & 3), + 1. (32, 8) in
    register order."""
    a = np.zeros((32, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for q in range(4):
            for h in range(2):
                a[lane, 2 * q + h] = zp[addr[8 * q + g] + 2 * t + h]
    return a


@pytest.mark.parametrize("order", ["narrow", "kstacked"])
def test_split_plane_stage2_transcribed(order):
    """The 9-plane store and stage 2 from it on one frame's Z, products in
    float64: narrow (tpu6_zplanes: per chunk the 9 planes by ldmatrix at
    at + 2 e ZP_PLANE bytes, z_i c_j with i + j < 3) or block-major
    (stage2_kstacked: the six blocks [z0 z0 z0 z1 z1 z2] x [c0 c1 c2 c0 c1
    c0] outer, the chunk inner, plane 3p + zt at at + 2 ((3p + zt)
    ZP_PLANE + 16c) bytes against weight plane 3p + ct); against the
    K-stacked product of the same terms with kstack_weights and the DFT."""
    raw8 = frames(1, 65)[0]
    z = _reference_z(raw8).astype(np.complex64)        # [n2][k1]
    zp = _store_planes(z)
    # every [k1][n2 < N2] element of every plane, and no padding
    grid = zp.reshape(9, N1, ROW)
    assert not np.isnan(grid[:, :, :N2]).any()
    assert np.isnan(grid[:, :, N2:]).all()
    *_, w2r, w2i, w2s = ff.constants(N, N1, N2, False)
    wplanes = [ff.pack_b_fragments(m[j]) for m in (w2r, w2i, w2s)
               for j in range(3)]
    blocks = [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (2, 0)]
    X = np.full((N1, N2), np.nan, complex)           # [k1][k2]
    for item in range(N // 256):
        mt, ng = item // (N2 // 16), item % (N2 // 16)
        base = []
        for lane in range(32):
            m = lane >> 3
            base.append((16 * mt + 8 * (m & 1) + (lane & 7)) * ROW
                        + 8 * (m >> 1))
        base = np.array(base)
        u = np.zeros((3, 2, 16, 8))

        def mma(p, zt, ct, c):
            a = _ldmatrix_x4(zp, base + (3 * p + zt) * ZP_PLANE + 16 * c)
            for j in range(2):
                u[p, j] += _mma(a, _b_regs(wplanes[3 * p + ct], c,
                                           2 * ng + j))
        if order == "narrow":
            for c in range(N2 // 16):
                for p in range(3):
                    for zt, ct in blocks:
                        mma(p, zt, ct, c)
        else:
            for zt, ct in blocks:
                for c in range(N2 // 16):
                    for p in range(3):
                        mma(p, zt, ct, c)
        x = (u[0] - u[1]) + 1j * (u[2] - u[0] - u[1])
        for j in range(2):
            rows = slice(16 * mt, 16 * mt + 16)
            cols = slice(16 * ng + 8 * j, 16 * ng + 8 * j + 8)
            assert np.isnan(X[rows, cols]).all()
            X[rows, cols] = x[j]
    zr, zi = z.real.astype(np.float32), z.imag.astype(np.float32)
    parts = (_split(zr, 3), _split(zi, 3), _split(zr + zi, 3))
    stacks = [ff.bf16_value(m).astype(np.float64).reshape(6, N2, N2)
              for m in fpp.kstack_weights()]
    u = [sum(terms[zt].T @ W[b] for b, (zt, _) in enumerate(blocks))
         for terms, W in zip(parts, stacks)]
    want = (u[0] - u[1]) + 1j * (u[2] - u[0] - u[1])
    assert np.abs(X - want).max() <= EXACT_RTOL * np.abs(want).max()
    dft = np.fft.fft(z.astype(np.complex128), axis=0).T   # [k1][k2]
    assert np.abs(X - dft).max() <= 1e-5 * np.abs(dft).max()


# --- the registry, the work and the wrappers ---

def test_registry_holds_p9_and_p10():
    src = (REPO / "rtl_power_fftw_tpu_torch/ops/kernels/csrc/"
           "fused_psd_probe.cu").read_text()
    names = list(fpp.VARIANTS)
    for name, code in zip(NEW, (45, 46, 47)):
        v = fpp.VARIANTS[name]
        assert v.code == code and f" = {code}," in src and v.psd
        assert v.kernel == "k3" and v.cut == fpp.CUT_FULL and v.twiddle
        assert v.s1_terms == 3 and v.s1_form == fpp.KSTACK
    left, zplanes, kstack = (fpp.VARIANTS[n] for n in NEW)
    assert (left.s2_form, left.s2_products, left.s2_planes) == (
        fpp.LEFT, 3, False)
    assert (zplanes.s2_form, zplanes.s2_products, zplanes.s2_planes) == (
        fpp.KARATSUBA, 6, True)
    assert (kstack.s2_form, kstack.s2_products, kstack.s2_planes) == (
        fpp.KSTACKED, 6, True)
    # parity: zplanes is tpu6 bit for bit, run after it, and the left
    # form K3 (K3's products transposed, in its order); kstack sums in
    # another order
    assert zplanes.parity == "tpu6" and left.parity == "K3"
    assert names.index("tpu6") < names.index("tpu6_zplanes")
    assert kstack.parity == "plain"
    # v5 is K3 and v6 tpu6: one Hopper variant, more TPU names
    assert any(t.startswith("P9 v5 (") for t in fpp.VARIANTS["k3"].tpu)
    assert any(t.startswith("P10 v6 (") for t in fpp.VARIANTS["tpu6"].tpu)
    assert left.tpu[0].startswith("P9 v5left (probes/profile_pallas.py:")
    assert kstack.tpu[0].startswith("P10 v6k (probes/profile_pallas.py:")
    assert "RPF_FAST(kTpu6KStack" in src and "kS2KStacked" in src


def test_probes_rows():
    for tpu, line, names in (("P9", 880, {"v5": "k3", "v5left": "k3_left"}),
                             ("P10", 1005, {"v6": "tpu6",
                                            "v6k": "tpu6_kstack"})):
        probe = fpp.PROBES[tpu]
        assert probe.source == f"probes/profile_pallas.py:{line}"
        assert probe.module == "profile_kernel" and probe.variants == names
        assert probe.default == tuple(names) and not probe.then
        assert not probe.tone
        assert probe in fpp.entry_probes("P1")
        for name in names:
            assert name not in fpp.PROBES["P1"].variants
            assert fpp.entry_variants("P1", [name]) == [(probe, name)]
    # the TPU module runs v5 and v6 only when named (896-906, 1021-1027)
    assert fpp.PROBES["P1"].then == ("P2",)
    assert [p.tpu for p, _ in fpp.entry_variants("P1")] == ["P1"] * 9 + ["P2"]


def test_work_counts():
    F_ = 4096
    k3 = fpp.k3_work(F_, N)
    tpu6 = fpp.VARIANTS["tpu6"].work(F_)
    # the left form at 3 products is K3's stage 2 ("3 parts, either
    # operand order"); both 6-product forms are tpu6's
    assert fpp.VARIANTS["k3_left"].work(F_) == k3
    assert fpp.VARIANTS["tpu6_zplanes"].work(F_) == tpu6
    assert fpp.VARIANTS["tpu6_kstack"].work(F_) == tpu6
    assert tpu6 == fpp.k3_work(F_, N, s2_products=6)
    # by hand: 2N (12 N1 + 9 N2) and 2N (12 N1 + 18 N2) bf16 flops a frame
    assert k3[1] == F_ * 2 * N * (12 * N1 + 9 * N2)
    assert tpu6[1] == F_ * 2 * N * (12 * N1 + 18 * N2)
    assert tpu6[0] - k3[0] == 3 * N2 * N2 * 2    # 9 weight planes, not 6
    # in µs at 989 TFLOP/s bf16 and 67 TFLOP/s FP32 (ops-bound)
    us = {n: 1e6 * (w[1] / 989e12 + w[2] / 67e12)
          for n, w in (("k3_left", k3), ("tpu6_kstack", tpu6))}
    assert round(us["k3_left"], 1) == 17.5
    assert round(us["tpu6_kstack"], 1) == 27.3


def test_wrappers_dispatch_to_plain_on_cpu_and_count():
    raw = torch.from_numpy(frames(8, 66))
    fpp.COUNTS.reset()
    for name in NEW:
        got = fpp.fused_psd_probe(name, raw, 8, 8, blocks_per_sm=1)
        assert torch.equal(got, fpp.fused_psd_probe_reference(name, raw, 8, 8))
    assert fpp.COUNTS.plain == {name: 1 for name in NEW}
    assert not fpp.COUNTS.kernel


@pytest.mark.cuda
def test_new_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    raw = torch.from_numpy(frames(64, 67)).to(dev)
    ship = {"tpu6": fpp.fused_psd_probe("tpu6", raw, 40, 16),
            "K3": fpp.fused_psd_probe("k3", raw, 40, 16)}
    for name in NEW:
        v = fpp.VARIANTS[name]
        got = fpp.fused_psd_probe(name, raw, 40, 16)
        want = fpp.fused_psd_probe_reference(name, raw, 40, 16)
        assert max_rel(got.cpu(), want.cpu()) <= v.rtol, name
        if v.parity != "plain":
            assert torch.equal(got, ship[v.parity]), name
        assert torch.equal(fpp.fused_psd_probe(name, raw, 40, 16,
                                               blocks_per_sm=1), got), name


# --- the entry point ---

@pytest.mark.parametrize("argv,names,tiles", [
    (["v5", "v5left", "v6", "v6k:2"], ["v5", "v5left", "v6", "v6k"],
     [1, 1, 1, 2]),
    (["v6k:4", "v5left:2"], ["v6k", "v5left"], [4, 2])])
def test_profile_kernel_takes_v5_and_v6(argv, names, tiles, capsys):
    from rtl_power_fftw_tpu_torch.probes import profile_kernel
    fpp.COUNTS.reset()
    assert profile_kernel.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    lines = [ln for ln in out if not ln.startswith("#")]
    assert [ln.split()[0] for ln in lines] == names
    tpu = {n: "P9" if n.startswith("v5") else "P10" for n in names}
    want = [tpu[n] for i, n in enumerate(names)
            if i == 0 or tpu[names[i - 1]] != tpu[n]]
    assert [ln.split()[1] for ln in out if ln.startswith("#")] == want
    assert [int(ln.split("tile=")[1].split()[0]) for ln in lines] == tiles
    assert all("per-step not measured (cpu)" in ln and "max_rel=" in ln
               for ln in lines)
    hopper = [BUILDS[n][2] for n in names]
    assert [ln.split("[")[1].rstrip("]") for ln in lines] == hopper
    assert fpp.COUNTS.plain == {h: hopper.count(h) for h in hopper}
