"""The port's stage-attribution probes (P1, P18, P13, P12) on the CPU.

Each Hopper variant's plain PyTorch version
(``ops/kernels/fused_psd_probe.py``) is held against its TPU probe:

- ``probes/s1_lanes.py`` (P18) and ``probes/s1_lanes2.py`` (P13) run
  themselves, loaded by path with ``pl.pallas_call`` forced into interpret
  mode, at N = 2048, the port's split N1 x N2 = 32 x 64 and F = 16, for
  every variant that traces there. Their full-spectrum variants and the
  port's 6-product scheme run the same bf16 terms and products and differ
  only in the order of f32 sums: rtol 5e-6, as the K3 plain version
  against the JAX fast kernel (tests/test_torch_fused_psd_fast.py). Their
  timing-only variants write each probe's own ``consume`` of what it
  built; those are sums of integers, exact in f32 at this size, and are
  held to the port's sums of the same elements by the factor each lhs
  stacks them with (rtol 1e-6).
- ``s1_lanes.py``'s s1only, s1tw and s1tw2 do not trace at N1 != N2 (the
  sum is swapped at line 142), and P1 (``profile_pallas.py``) runs its
  variants when imported and no longer matches ``_constants``; those, and
  P12's nine lambdas (``cast_test.py:30-62``), are numpy transcriptions
  with their line numbers.

The CUDA kernels run only on a card (chip_smoke.py, and the test marked
``cuda``); their relayout index arithmetic is transcribed here.
"""

import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_fast as ff
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
from rtl_power_fftw_tpu_torch.ops.kernels.fused_psd import fused_psd_reference

REPO = Path(__file__).resolve().parents[1]
N, N1, N2 = fpp.N, fpp.N1, fpp.N2
F = 16
# The port's scheme against the TPU probes' on the same terms: only the
# order of f32 sums differs.
VS_JAX_RTOL = 5e-6
# Sums of integers (exact in f32 at F = 16) against each other.
SUMS_RTOL = 1e-6


def frames(F, seed):
    return np.random.default_rng(seed).integers(0, 256, (F, 2 * N),
                                                dtype=np.uint8)


def max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(got - want)
                  / np.maximum(np.abs(want), 1e-30)).max())


def plain(variant, raw8, n_valid=None, chunk=F):
    t = torch.from_numpy(raw8)
    return fpp.fused_psd_probe(variant, t, raw8.shape[0] if n_valid is None
                               else n_valid, chunk).numpy()


# --- the TPU probes themselves, in interpret mode ---

@pytest.fixture
def tpu_probe(monkeypatch):
    """Load probes/<name>.py by path, its pallas_call forced into interpret
    mode and its N, F, N1, N2 set to 2048, 16 and the port's split; the
    environment and sys.path it touches are restored afterwards."""
    original = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return original(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    monkeypatch.delenv("TPU_ACCELERATOR_TYPE", raising=False)
    monkeypatch.setattr(sys, "path", list(sys.path))

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"tpu_probe_{name}", REPO / "probes" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for attr, value in (("N", N), ("F", F), ("N1", N1), ("N2", N2)):
            monkeypatch.setattr(mod, attr, value)
        return mod

    return load


def run_tpu(mod, variant, raw8):
    import jax.numpy as jnp
    raw16 = raw8.reshape(F, N, 2).view(np.uint16).reshape(F, N)
    return np.asarray(mod.build(variant, 8)(jnp.asarray(raw16), F))


@pytest.mark.parametrize("module,variant", [
    ("s1_lanes", "full"), ("s1_lanes", "widedq"), ("s1_lanes2", "full"),
    ("s1_lanes2", "i32tr"), ("s1_lanes2", "f32tr")])
def test_six_product_scheme_against_the_tpu_probe(tpu_probe, module,
                                                  variant):
    raw8 = frames(F, 1)
    probe = fpp.PROBES["P18" if module == "s1_lanes" else "P13"]
    hopper = probe.variants[variant]
    want = run_tpu(tpu_probe(module), variant, raw8)
    got = plain(hopper, raw8)
    assert max_rel(got, want) <= VS_JAX_RTOL
    # and the layout variants are the 6-product scheme itself
    np.testing.assert_array_equal(got, plain("tpu6", raw8))


def _dequant(raw8):
    """(re, im) of every sample, (F, N) float64."""
    return (raw8[:, 0::2].astype(np.float64) - 127.0,
            raw8[:, 1::2].astype(np.float64) - 127.0)


def test_p18_dequant_consumes_against_the_tpu_probe(tpu_probe):
    raw8 = frames(F, 2)
    mod = tpu_probe("s1_lanes")
    re, im = _dequant(raw8)
    reps = N1 // 16
    # dqonly (s1_lanes.py:74-81): row n2 holds 3x the sum over n1 of
    # re + im (the lhs stacks each plane 3 times), in every column.
    rows = run_tpu(mod, "dqonly", raw8).reshape(N2, N1)
    per_n2 = (re + im).reshape(F, N1, N2).sum(axis=(0, 1))
    assert max_rel(rows[:, 0], 3 * per_n2) <= SUMS_RTOL
    assert np.all(rows == rows[:, :1])
    np.testing.assert_allclose(plain("dq_gather", raw8),
                               reps * rows[:, 0].sum() / 3, rtol=SUMS_RTOL)
    # dqwide (s1_lanes.py:55-63): out[n2][n1] = sum of re + im at n1, n2.
    wide = run_tpu(mod, "dqwide", raw8).reshape(N2, N1)
    assert max_rel(wide, (re + im).reshape(F, N1, N2).sum(0).T) <= SUMS_RTOL
    np.testing.assert_allclose(plain("dq_load", raw8), reps * wide.sum(),
                               rtol=SUMS_RTOL)


def test_p13_consumes_against_the_tpu_probe(tpu_probe):
    raw8 = frames(F, 3)
    mod = tpu_probe("s1_lanes2")
    re, im = _dequant(raw8)
    reps = N1 // 16
    u16 = raw8.reshape(F, N, 2).view(np.uint16).astype(np.float64)
    # traw: the sum of the transposed u16 values, in every bin (the probe
    # sums ~1e9 in f32: 24 bits).
    traw = run_tpu(mod, "traw", raw8)
    assert np.all(traw == traw[0]) and max_rel(traw[0], u16.sum()) <= 1e-6
    np.testing.assert_allclose(plain("gather", raw8), reps * u16.sum(),
                               rtol=SUMS_RTOL)
    # dqnotr: 3 copies of each plane in its lhs.
    dqnotr = run_tpu(mod, "dqnotr", raw8)
    assert max_rel(dqnotr[0], 3 * (re + im).sum()) <= SUMS_RTOL
    np.testing.assert_allclose(plain("dq_linear", raw8),
                               reps * dqnotr[0] / 3, rtol=SUMS_RTOL)
    # u32tr (s1_lanes2.py:73-86): pltpu.bitcast packs the second-minor
    # axis, so a word holds samples n2 = 4r + c (low half, in the lhs
    # twice) and 4r + 2 + c (high half, once), c < 2.
    per = (re + im).reshape(F, N1, N2)
    low = per[:, :, np.arange(N2) % 4 < 2].sum()
    high = per[:, :, np.arange(N2) % 4 >= 2].sum()
    assert max_rel(run_tpu(mod, "u32tr", raw8)[0], 2 * low + high) \
        <= SUMS_RTOL
    np.testing.assert_allclose(plain("dq_pair32", raw8),
                               reps * (low + high), rtol=SUMS_RTOL)


@pytest.mark.parametrize("variant", ["s1only", "s1tw", "s1tw2"])
def test_s1_lanes_cuts_do_not_trace_at_the_port_split(tpu_probe, variant):
    # s1_lanes.py:142 swaps an (N2, N1) sum into an (N2, N1) output.
    with pytest.raises((TypeError, ValueError)):
        run_tpu(tpu_probe("s1_lanes"), variant, frames(F, 4))


# --- numpy transcriptions ---

def bf(x):
    """float32 -> bf16 (nearest even) -> float32."""
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16) \
        .astype(np.float32)


def _dft(n):
    a = np.arange(n, dtype=np.float64)
    ang = -2.0 * np.pi * (np.outer(a, a) % n) / n
    return np.cos(ang), np.sin(ang)


def _terms(w, k):
    return ff.bf16_value(ff.bf16_terms(w, k)).astype(np.float32)


def _twiddle():
    _, _, twr, twi, _, _, _ = ff.constants(N, N1, N2, False)
    return twr, twi


def s1_lanes_cut_numpy(variant, raw8):
    """s1_lanes.py:67-100 (the shipping layout) for s1only, s1tw and s1tw2,
    summed over frames in the (n2, k1) order, without line 142's swap."""
    F_ = raw8.shape[0]
    WR, WI, _, _, _, _, _ = ff.constants(N, N1, N2, False)
    WR, WI = ff.bf16_value(WR), ff.bf16_value(WI)
    u16 = raw8.reshape(F_, N, 2).view(np.uint16).reshape(F_, N)
    v = u16.reshape(F_, N1, N2).swapaxes(1, 2).reshape(F_ * N2, N1) \
        .astype(np.int32)
    ar = ((v & 0xFF) - 127).astype(np.float32)
    ai = ((v >> 8) - 127).astype(np.float32)
    lhs = np.concatenate([ar, ai, ar, ai, ar, ai], axis=1)
    yr = (lhs @ WR).reshape(F_, N2, N1)
    yi = (lhs @ WI).reshape(F_, N2, N1)
    if variant == "s1only":
        pwr = yr * yr + yi * yi
    else:
        twr, twi = _twiddle()
        zr = yr * twr - yi * twi
        zi = yr * twi + yi * twr
        if variant == "s1tw":
            pwr = zr * zr + zi * zi
        else:  # s1tw2: through the to2 relayout and back
            zrm = zr.swapaxes(1, 2).reshape(F_ * N1, N2)
            zim = zi.swapaxes(1, 2).reshape(F_ * N1, N2)
            pwr = (zrm * zrm + zim * zim).reshape(F_, N1, N2).swapaxes(1, 2)
    return pwr.sum(axis=0).reshape(N)


@pytest.mark.parametrize("variant,hopper", [
    ("s1only", "s1only"), ("s1tw", "s1tw"), ("s1tw2", "s1tw_z")])
def test_s1_lanes_cuts_against_a_transcription(variant, hopper):
    raw8 = frames(F, 5)
    # The same products in f32; numpy's and torch's sum orders differ.
    assert max_rel(plain(hopper, raw8), s1_lanes_cut_numpy(variant, raw8)) \
        <= 1e-5


def p1_numpy(variant, raw8, n_valid):
    """profile_pallas.py:33-107 for one grid step over all frames: a
    Karatsuba stage 1 of 1 or 3 bf16 weight terms (49-57), the twiddle
    (59-64), stage 2 as 3 Karatsuba parts of 1 or 3 products (81-97; dg3d
    at 66-79 is the same sums contracted in place), |X|^2 and the mask
    (97-101), swapped to bin order (103)."""
    F_ = raw8.shape[0]
    u16 = raw8.reshape(F_, N, 2).view(np.uint16).reshape(F_, N)
    v = u16.reshape(F_, N1, N2).swapaxes(1, 2).reshape(F_ * N2, N1) \
        .astype(np.int32)
    ar = ((v & 0xFF).astype(np.float32) - 127.0)
    ai = ((v >> 8).astype(np.float32) - 127.0)
    asum = ar + ai
    s1 = 0 if variant == "nomm" else (1 if variant == "s1x1" else 3)
    s2 = 0 if variant == "nomm" else (1 if variant in ("s2x1", "s1x1")
                                      else 3)
    w1r, w1i = _dft(N1)
    if s1 == 0:
        yr, yi = ar.reshape(F_, N2, N1), ai.reshape(F_, N2, N1)
    else:
        def s1p(a, w):
            w3 = _terms(w, 3)
            return sum(bf(a) @ w3[j] for j in range(s1))
        t1, t2, t3 = s1p(ar, w1r), s1p(ai, w1i), s1p(asum, w1r + w1i)
        yr = (t1 - t2).reshape(F_, N2, N1)
        yi = (t3 - t1 - t2).reshape(F_, N2, N1)
    if variant != "notw":
        twr, twi = _twiddle()
        zr, zi = yr * twr - yi * twi, yr * twi + yi * twr
    else:
        zr, zi = yr, yi
    zrm = zr.swapaxes(1, 2).reshape(F_ * N1, N2)
    zim = zi.swapaxes(1, 2).reshape(F_ * N1, N2)
    if s2 == 0:
        xr, xi = zrm, zim
    else:
        w2r, w2i = _dft(N2)

        def s2p(z, w):
            w2 = _terms(w, 2)
            z0 = bf(z)
            z1 = bf(z - z0)
            acc = z0 @ w2[0]
            if s2 >= 3:
                acc = acc + z0 @ w2[1] + z1 @ w2[0]
            return acc
        u1, u2, u3 = s2p(zrm, w2r), s2p(zim, w2i), s2p(zrm + zim, w2r + w2i)
        xr, xi = u1 - u2, u3 - u1 - u2
    pwr = (xr * xr + xi * xi).reshape(F_, N1, N2)
    pwr[n_valid:] = 0.0
    return pwr.sum(axis=0).swapaxes(0, 1).reshape(N)


# Per variant: the port's plain version against the P1 transcription.
# Stage 1 differs in scheme (the probe's Karatsuba of 3 products, K3's
# K-stacked complex product) and agrees to f32 rounding with 3 weight
# terms (2e-5, K3's bound against its plain version). With one bf16 term
# of z in stage 2 (s2x1), a last-bit difference in z can flip its bf16
# rounding: 2e-4. With one bf16 weight term in stage 1 (s1x1) each scheme
# is ~2^-9 from the exact DFT in its own way: 3e-2. nomm has no products:
# the same f32 operations.
P1_RTOL = {"full": 2e-5, "s2x1": 2e-4, "s1x1": 3e-2, "nomm": 1e-6,
           "notw": 2e-5, "dg3d": 2e-5}


@pytest.mark.parametrize("variant", sorted(P1_RTOL))
@pytest.mark.parametrize("n_valid", [F, 11])
def test_p1_against_a_transcription(variant, n_valid):
    raw8 = frames(F, 6)
    hopper = fpp.PROBES["P1"].variants[variant]
    got = plain(hopper, raw8, n_valid)
    assert max_rel(got, p1_numpy(variant, raw8, n_valid)) \
        <= P1_RTOL[variant]


@pytest.mark.parametrize("n_valid", [F, 9, 0])
def test_p1_full_and_dg3d_plain_are_k3_plain(n_valid):
    raw8 = torch.from_numpy(frames(F, 7))
    k3 = ff.fused_psd_fast_reference(raw8, n_valid, 8)
    for variant in ("k3", "zplanes"):
        assert torch.equal(
            fpp.fused_psd_probe_reference(variant, raw8, n_valid, 8), k3)


def test_k1_cuts_plain():
    raw8 = frames(F, 8)
    t = torch.from_numpy(raw8)
    assert torch.equal(fpp.fused_psd_probe_reference("k1_full", t, 10, 8),
                       fused_psd_reference(t, 10, 8))
    re, im = _dequant(raw8[:10])
    np.testing.assert_array_equal(plain("k1_nofft", raw8, 10),
                                  (re * re + im * im).sum(0)
                                  .astype(np.float32))
    np.testing.assert_array_equal(plain("k1_dqonly", raw8, 10),
                                  (re + im).sum(0).astype(np.float32))


@pytest.mark.parametrize("variant", ["s1only", "s1tw", "s1tw_z", "nomm"])
def test_stage_sums_in_n2_k1_order(variant):
    """A cut's |Y|^2 or |Z|^2 at index n2*N1 + k1 is the power of the
    length-N1 DFT of column n2 (times the twiddle's unit modulus)."""
    raw8 = frames(4, 9)
    re, im = _dequant(raw8)
    x = (re + 1j * im).reshape(4, N1, N2)          # [f, n1, n2]
    y = np.fft.fft(x, axis=1) if variant != "nomm" else x
    want = (np.abs(y) ** 2).sum(0).T.reshape(N)    # [n2, k1]
    assert max_rel(plain(variant, raw8, chunk=4), want) <= 1e-5


def test_registry_is_consistent():
    codes = [v.code for v in fpp.VARIANTS.values()]
    assert len(set(codes)) == len(codes)
    for probe in fpp.PROBES.values():
        assert set(probe.default) <= set(probe.variants)
        assert set(probe.variants.values()) <= set(fpp.VARIANTS)
    # the codes in the source's enum
    src = (REPO / "rtl_power_fftw_tpu_torch/ops/kernels/csrc/"
           "fused_psd_probe.cu").read_text()
    for v in fpp.VARIANTS.values():
        assert f" = {v.code}," in src
    # two TPU names against one Hopper variant
    assert len(fpp.VARIANTS["tpu6"].tpu) == 2
    assert len(fpp.VARIANTS["tpu6_bf16in"].tpu) == 2
    # every TPU variant of the four probes is in the registry
    assert set(fpp.PROBES["P1"].variants) >= {
        "full", "s2x1", "s1x1", "nomm", "notw", "dg3d"}
    assert set(fpp.PROBES["P18"].variants) == {
        "full", "widedq", "s1only", "s1tw", "s1tw2", "dqonly", "dqwide"}
    assert set(fpp.PROBES["P13"].variants) == {
        "full", "traw", "dqnotr", "u32tr", "i32tr", "f32tr"}


@pytest.mark.parametrize("variant", sorted(fpp.VARIANTS))
def test_work_is_positive_and_counts_the_frames(variant):
    nbytes, mma, fp32 = fpp.VARIANTS[variant].work(4096)
    assert nbytes >= 4096 * 2 * N + 4 * N
    assert mma >= 0 and fp32 >= 0
    if variant in ("k3", "zplanes"):
        # K3's own count: 2N (12 N1 + 9 N2) bf16 flops a frame.
        assert mma == 4096 * 2 * N * (12 * N1 + 9 * N2)


@pytest.mark.parametrize("variant,whole", [("k3", "K3"), ("zplanes", "K3"),
                                           ("k1_full", "K1")])
def test_whole_kernel_variants_share_the_shipping_kernels_work(variant,
                                                                 whole):
    """One count of the work for a bound: P1 full and dg3d do K3's work,
    k1_full K1's, as chip_smoke.py's bounds of the shipping kernels count
    it."""
    want = (fpp.k3_work(4096, N) if whole == "K3" else fpp.k1_work(4096, N))
    assert fpp.VARIANTS[variant].work(4096) == want


def test_cuts_do_less_work_than_their_whole_kernel():
    whole = fpp.k3_work(4096, N)
    for name, v in fpp.VARIANTS.items():
        if v.kernel == "k3" and v.cut != fpp.CUT_FULL:
            assert all(a <= b for a, b in zip(v.work(4096), whole)), name
    assert fpp.k3_work(4096, N, 6, windowed=True)[1] \
        == 4096 * 2 * N * (24 * N1 + 9 * N2)


# --- P12 ---

T, P, Q, PN1, PN2 = fpp.T, fpp.P, fpp.Q, fpp._N1, fpp._N2
CAST_LAMBDAS = {   # cast_test.py:32-62, in numpy
    "A": lambda x: x.reshape(T * Q, P * PN1),
    "B": lambda x: np.transpose(x.reshape(T, Q, P, PN1), (0, 3, 1, 2))
    .reshape(T * PN1, PN2),
    "C": lambda x: np.swapaxes(x, 1, 2).reshape(T * PN2, PN1),
    "D": lambda x: np.transpose(x, (0, 3, 1, 2)),
    "E": lambda x: np.concatenate([x[:, :, p, :] for p in range(P)],
                                  axis=-1),
    "F": lambda x: np.concatenate(
        [np.swapaxes(x[:, :, p * PN1:(p + 1) * PN1], 1, 2)
         for p in range(P)], axis=-1).reshape(T * PN1, PN2),
    "G": lambda x: x.reshape(T, Q, P, PN1),
    "H": lambda x: np.concatenate([x[:, p::P, :] for p in range(P)],
                                  axis=-1),
    "I": lambda x: np.concatenate(
        [np.transpose(x, (0, 2, 1, 3))[:, p] for p in range(P)], axis=-1),
}


def relayout_source(case, i):
    """fused_psd_probe.cu:relayout_source, transcribed."""
    if case in "AG":
        return i
    if case in "BD":
        p, q, n1 = i % P, (i // P) % Q, (i // (P * Q)) % PN1
        t = i // (P * Q * PN1)
        return ((t * Q + q) * P + p) * PN1 + n1
    if case == "C":
        n1, n2, t = i % PN1, (i // PN1) % PN2, i // (PN1 * PN2)
        return (t * PN1 + n1) * PN2 + n2
    col = i % (P * PN1)
    if case in "EI":
        p, n1 = col // PN1, col % PN1
        q, t = (i // (P * PN1)) % Q, i // (P * PN1 * Q)
        return ((t * Q + q) * P + p) * PN1 + n1
    if case == "F":
        col = i % PN2
        p, q = col // Q, col % Q
        n1, t = (i // PN2) % PN1, i // (PN2 * PN1)
        return (t * Q + q) * (P * PN1) + p * PN1 + n1
    p, n1 = col // PN1, col % PN1        # H
    q, t = (i // (P * PN1)) % Q, i // (P * PN1 * Q)
    return (t * PN2 + q * P + p) * PN1 + n1


@pytest.mark.parametrize("case", sorted(fpp.RELAYOUTS))
def test_p12_relayouts(case):
    r = fpp.RELAYOUTS[case]
    n = T * PN1 * PN2
    x = np.arange(n, dtype=np.float32).reshape(r.in_shape)
    want = CAST_LAMBDAS[case](x)
    got = fpp.relayout(case, torch.from_numpy(x))
    assert tuple(got.shape) == r.out_shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    src = np.array([relayout_source(case, i) for i in range(n)])
    np.testing.assert_array_equal(x.reshape(-1)[src], want.reshape(-1))


# --- the wrappers ---

def test_wrappers_dispatch_to_plain_on_cpu_and_count():
    fpp.COUNTS.reset()
    raw = torch.from_numpy(frames(8, 10))
    fpp.fused_psd_probe("tpu6", raw, 8, 8)
    # a pinned occupancy changes no output
    assert torch.equal(fpp.fused_psd_probe("k3", raw, 8, 8, blocks_per_sm=3),
                       fpp.fused_psd_probe("k3", raw, 8, 8))
    fpp.COUNTS.reset()
    fpp.fused_psd_probe("tpu6", raw, 8, 8)
    fpp.relayout("C", torch.zeros(fpp.RELAYOUTS["C"].in_shape))
    assert fpp.COUNTS.plain == {"tpu6": 1, "C": 1} and not fpp.COUNTS.kernel


def test_wrappers_refuse_what_the_kernels_do_not_take():
    raw = torch.from_numpy(frames(8, 11))
    with pytest.raises(ValueError):
        fpp.fused_psd_probe("bogus", raw, 8, 8)
    with pytest.raises(ValueError):
        fpp.fused_psd_probe("k3", torch.zeros((8, 1024), dtype=torch.uint8),
                            8, 8)
    with pytest.raises(ValueError):
        fpp.fused_psd_probe("k3", raw, 8, 8, iters=0)
    with pytest.raises(ValueError):
        fpp.fused_psd_probe("k3", raw, 8, 8, blocks_per_sm=-1)
    with pytest.raises(ValueError):
        fpp.probe_attributes("bogus")
    with pytest.raises(ValueError):
        fpp.fused_psd_probe("k3", raw.to("meta"), 8, 8)
    with pytest.raises(ValueError):
        fpp.relayout("Z", torch.zeros(10))
    with pytest.raises(ValueError):
        fpp.relayout("C", torch.zeros(T * PN1 * PN2))


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    raw = torch.from_numpy(frames(64, 12)).to(dev)
    for name, v in fpp.VARIANTS.items():
        got = fpp.fused_psd_probe(name, raw, 40, 16)
        want = fpp.fused_psd_probe_reference(name, raw, 40, 16)
        assert max_rel(got.cpu(), want.cpu()) <= v.rtol, name
        assert torch.equal(fpp.fused_psd_probe(name, raw, 40, 16,
                                               blocks_per_sm=2), got), name
        assert fpp.probe_attributes(name, 2)["blocks_per_sm"] <= 2, name


# --- the entry points ---

ENTRY = {"profile_kernel": "P1", "s1_lanes": "P18", "s1_lanes2": "P13"}


@pytest.mark.parametrize("module", sorted(ENTRY) + ["cast_test"])
def test_entry_point_on_cpu(module, capsys):
    entry = importlib.import_module(
        f"rtl_power_fftw_tpu_torch.probes.{module}")
    assert entry.main(["--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if not ln.startswith("#")]
    names = (list(fpp.PROBES[ENTRY[module]].default) if module in ENTRY
             else [r.name for r in fpp.RELAYOUTS.values()])
    assert [ln.split()[0] for ln in lines] == [n.split()[0] for n in names]
    assert all("per-step not measured (cpu)" in ln for ln in lines)


@pytest.mark.parametrize("module", sorted(ENTRY) + ["cast_test"])
def test_entry_point_refuses_an_unknown_variant(module, capsys):
    entry = importlib.import_module(
        f"rtl_power_fftw_tpu_torch.probes.{module}")
    assert entry.main(["bogus", "--device", "cpu"]) == 2
    assert "unknown" in capsys.readouterr().err


@pytest.mark.parametrize("module", sorted(ENTRY) + ["cast_test"])
def test_entry_point_needs_a_card_unless_told_cpu(module, monkeypatch,
                                                  capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    entry = importlib.import_module(
        f"rtl_power_fftw_tpu_torch.probes.{module}")
    assert entry.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_entry_point_runs_as_a_module():
    r = subprocess.run(
        [sys.executable, "-m", "rtl_power_fftw_tpu_torch.probes.s1_lanes",
         "full:2", "dqonly", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = [ln for ln in r.stdout.splitlines() if not ln.startswith("#")]
    assert [ln.split()[0] for ln in lines] == ["full", "dqonly"]
    assert "tile=  2" in lines[0] and "[tpu6]" in lines[0]
