"""The redesigned awkward-N kernels, transcribed in numpy from their index
arithmetic: the chirp-Z kernel on the register FFT
(csrc/fused_psd_chirp.cuh with fft_regs.cuh's transposed pass) and the
mixed-radix ring kernel (csrc/fused_psd_mixed_ring.cuh), with the frame
ring of csrc/frame_ring.cuh.

The CUDA kernels run only on a card (chip_smoke.py); here:
- the transposed register passes run on a digit-reversed vector are the
  DFT in float64 at every M from 64 to 16384, and the half-zero first
  stage is dif_regs' first stage on a vector whose upper half is zero;
- the chirp-Z kernel thread by thread (pass 0 from the samples, the
  forward passes, the turn, the transposed passes, the sums of pass 0's
  outputs) in float64 against numpy.fft, in float32 against
  tests/golden.py (rtol 1e-5), against the plain version and the JAX
  package's bluestein_psd_partial (rtol 2e-5, two float32 budgets);
- spectrum_table by plan (the kernel's and the control's), the chirp-Z
  sizes and layouts of every even N to 8192;
- the ring's copy width by N and alignment;
- the mixed kernel's thread shape for all 317 even 7-smooth N: every
  pass's butterflies covered once by (t, i), the division constants
  exact, the last-pass sums within their register class and owning each
  bin once; its transcription (the division constants, rounds and
  register sums as the kernel has them) against the golden and plain;
- the source edits of probes/ring_layouts.py apply to the shipped ring
  header.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu.ops.dft import bluestein_psd_partial
from rtl_power_fftw_tpu_torch.auxdata import make_window
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_bluestein as fb
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed as fm
from rtl_power_fftw_tpu_torch.ops.spectral import adapt_batch
from rtl_power_fftw_tpu_torch.probes import ring_layouts

from golden import golden_accumulate
from test_torch_fused_psd_mixed import (RESIDENT, SMOOTH_EVEN, dequantize,
                                        dft_natural, frames,
                                        kernel_transcription, psd_sum,
                                        twiddle_table)
from test_torch_fused_psd_regs import (dif_regs, exact_pass_twiddles,
                                       header_w16, pad, pass_bin, rev_bits,
                                       spans)

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "rtl_power_fftw_tpu_torch/ops/kernels/csrc"
SIZES = sorted(fp.PASS_PLAN)
CROSS_RTOL = 2e-5


def header_int(name, file):
    text = (CSRC / file).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


# --- the register FFT's transposed passes ---


def dif_regs_from(v, w16, M0):
    """dif_regs with its stages of half-span M0, M0/2, .., 1 only."""
    v = v.copy()
    R = v.shape[-1]
    M = M0
    while M >= 1:
        for J in range(R // 2):
            k = J % M
            i0 = (J // M) * 2 * M + k
            a, c = v[..., i0].copy(), v[..., i0 + M].copy()
            d = a - c
            v[..., i0] = a + c
            q = k * (8 // M)
            if q == 4:
                d = (d.imag - 1j * d.real).astype(v.dtype)
            elif q:
                d = d * w16[q]
            v[..., i0 + M] = d
        M //= 2
    return v


def half_zero_stage(v, w16):
    """dif_stage_half_zero: v[J + R/2] = v[J] W_16^(J*16/R), J < R/2."""
    v = v.copy()
    R = v.shape[-1]
    for J in range(R // 2):
        q = J * (16 // R)
        if q == 0:
            v[..., J + R // 2] = v[..., J]
        elif q == 4:
            v[..., J + R // 2] = (v[..., J].imag
                                  - 1j * v[..., J].real).astype(v.dtype)
        else:
            v[..., J + R // 2] = v[..., J] * w16[q]
    return v


def forward_passes(xbuf, M, tw, w16, t, start=1):
    """regs_pass<J> for J = start .. P-2 on the padded buffers xbuf (F,
    slots), thread by thread (t: the frame's threads)."""
    plan = fp.PASS_PLAN[M]
    R, TF = plan[0], M // plan[0]
    offset = sum(L for L, _ in spans(M)[:start])
    for j in range(start, len(plan) - 1):
        L, S = spans(M)[j]
        RJ, bits = plan[j], plan[j].bit_length() - 1
        for i in range(R // RJ):
            b = t + i * TF
            n2, base = b % S, (b // S) * L + b % S
            idx = base[:, None] + np.arange(RJ)[None, :] * S
            vv = dif_regs(xbuf[:, pad(idx)], w16)
            for r in range(RJ):
                k1 = rev_bits(r, bits)
                y = vv[..., r] * tw[offset + k1 * S + n2] if k1 else vv[..., r]
                xbuf[:, pad(base + k1 * S)] = y
        offset += L


def transposed_passes(xbuf, M, tw, w16, t):
    """regs_pass_t<J> for J = P-2 .. 0 on xbuf (F, slots): the twiddle on
    each input (row offset_J + k*S + n2), the butterfly, output r back to
    element base + rev_bits(r)*S; pass 0's outputs are returned as (F, TF,
    R): [.., t, r] is element t + rev_bits(r)*TF."""
    plan = fp.PASS_PLAN[M]
    R, TF = plan[0], M // plan[0]
    offsets = np.cumsum([0] + [L for L, _ in spans(M)])
    for j in range(len(plan) - 2, -1, -1):
        L, S = spans(M)[j]
        RJ, bits = plan[j], plan[j].bit_length() - 1
        for i in range(R // RJ):
            b = t + i * TF
            n2, base = b % S, (b // S) * L + b % S
            k = np.arange(RJ)[None, :]
            v = xbuf[:, pad(base[:, None] + k * S)]
            w = np.where(k == 0, 1, tw[offsets[j] + k * S + n2[:, None]])
            vv = dif_regs(v * w.astype(v.dtype), w16)
            if j == 0:
                return vv
            for r in range(RJ):
                xbuf[:, pad(base + rev_bits(r, bits) * S)] = vv[..., r]


def last_pass_turn(xbuf, M, tw, w16, t, spectrum):
    """The last forward pass (regs_pass<P-1>, outputs left in registers),
    the turn (times spectrum at element b*RL + k, conjugated) and the same
    butterfly again, written back at b*RL + rev_bits(r). spectrum None:
    no forward pass, xbuf holds the turn's input (the transposed passes
    alone)."""
    plan = fp.PASS_PLAN[M]
    R, TF = plan[0], M // plan[0]
    RL, bits = plan[-1], plan[-1].bit_length() - 1
    for i in range(R // RL):
        base = (t + i * TF) * RL
        idx = base[:, None] + np.arange(RL)[None, :]
        if spectrum is None:
            u = xbuf[:, pad(idx)]
        else:
            vv = dif_regs(xbuf[:, pad(idx)], w16)
            u = np.stack([vv[..., rev_bits(k, bits)] for k in range(RL)], -1)
            u = np.conj(u * spectrum[idx])
        uu = dif_regs(u, w16)
        for r in range(RL):
            xbuf[:, pad(base + rev_bits(r, bits))] = uu[..., r]


def exact_w16():
    return header_w16()


@pytest.mark.parametrize("M", SIZES)
def test_transposed_passes_are_the_dft(M):
    """The last pass's butterfly and regs_pass_t down to pass 0, run on x
    in the forward passes' element order (element q holds x[pass_bin(q)]),
    give the DFT of x in natural order (the DFT matrix is symmetric), in
    float64 at every M of the register FFT."""
    rng = np.random.default_rng(M)
    x = rng.standard_normal((2, M)) + 1j * rng.standard_normal((2, M))
    plan = fp.PASS_PLAN[M]
    R, TF = plan[0], M // plan[0]
    t = np.arange(TF)
    xbuf = np.full((2, pad(M - 1) + 1), np.nan, complex)
    q = np.arange(M)
    xbuf[:, pad(q)] = x[:, pass_bin(M, q)]
    tw, w16 = exact_pass_twiddles(M), exact_w16()
    last_pass_turn(xbuf, M, tw, w16, t, None)
    out = transposed_passes(xbuf, M, tw, w16, t)
    got = np.empty((2, M), complex)
    for r in range(R):
        got[:, t + rev_bits(r, R.bit_length() - 1) * TF] = out[..., r]
    np.testing.assert_allclose(got, np.fft.fft(x, axis=1), rtol=1e-9,
                               atol=1e-9 * np.sqrt(M))


@pytest.mark.parametrize("R", [8, 16])
def test_half_zero_stage_is_the_first_stage(R):
    """On values whose upper half is zero, the half-zero stage and the
    later stages give dif_regs' outputs bit for bit in float32."""
    rng = np.random.default_rng(R)
    v = np.zeros((64, R), np.complex64)
    v[:, :R // 2] = (rng.standard_normal((64, R // 2))
                     + 1j * rng.standard_normal((64, R // 2)))
    w16 = header_w16().astype(np.complex64)
    want = dif_regs(v, w16)
    got = dif_regs_from(half_zero_stage(v, w16), w16, R // 4)
    np.testing.assert_array_equal(got, want)


# --- the chirp-Z kernel ---


def chirp_tables(N, dtype):
    """(twiddles, chirp, spectrum, W_16) as the kernel reads them, or in
    float64 exactly (for the algebra)."""
    plan = fb.chirp_plan(N)
    M = int(np.prod(plan))
    if dtype == np.complex128:
        n = np.arange(N)
        a = np.exp(-1j * np.pi * (n * n % (2 * N)) / N)
        v = np.zeros(M, complex)
        v[:N] = np.conj(a)
        v[M - N + 1:] = v[1:N][::-1]
        B = np.fft.fft(v) / M
        q = np.arange(M)
        return (exact_pass_twiddles(M), a, B[pass_bin(M, q)], exact_w16())
    tw = fp.pass_twiddles(M)
    c = fb.chirp_table(N)
    s = fb.spectrum_table(N, plan)
    return ((tw[:, 0] + 1j * tw[:, 1]).astype(dtype),
            (c[:, 0] + 1j * c[:, 1]).astype(dtype),
            (s[:, 0] + 1j * s[:, 1]).astype(dtype),
            header_w16().astype(dtype))


def chirp_power(raw, window=None, dtype=np.complex64):
    """|DFT|^2 of each frame as psd_chirp_kernel computes it, thread by
    thread, (F, N) in natural order."""
    return chirp_power_of(dequantize(raw, window, dtype), dtype)


def chirp_power_of(z, dtype=np.complex64):
    """|DFT|^2 of each row of the (F, N) samples ``z`` (the frame's,
    dequantized and windowed) as psd_chirp_kernel computes it from pass
    0's samples on, thread by thread, (F, N) in natural order."""
    F, N = z.shape
    M = fb.chirp_size(N)
    plan = fp.PASS_PLAN[M]
    R, TF = plan[0], M // plan[0]
    HALF = R // 2
    tw, a, spectrum, w16 = chirp_tables(N, dtype)
    t = np.arange(TF)
    s = t[:, None] + np.arange(HALF)[None, :] * TF          # (TF, HALF)
    x = np.zeros((F, M), dtype)
    x[:, :N] = z * a
    v = np.zeros((F, TF, R), dtype)
    v[..., :HALF] = x[:, s]
    v = dif_regs_from(half_zero_stage(v, w16), w16, R // 4)
    xbuf = np.full((F, pad(M - 1) + 1), np.nan, dtype)
    bits = R.bit_length() - 1
    for r in range(R):
        k1 = rev_bits(r, bits)
        xbuf[:, pad(t + k1 * TF)] = v[..., r] * tw[k1 * TF + t] if k1 \
            else v[..., r]
    forward_passes(xbuf, M, tw, w16, t)
    last_pass_turn(xbuf, M, tw, w16, t, spectrum)
    out = transposed_passes(xbuf, M, tw, w16, t)
    power = np.zeros((F, TF * HALF), out.real.dtype)
    for r in range(0, R, 2):   # rev_bits(r) < HALF
        k1 = rev_bits(r, bits)
        power[:, t + k1 * TF] = (out[..., r].real ** 2
                                 + out[..., r].imag ** 2)
    return power[:, :N]


def chirp_transcription(raw, n_valid, chunk, window=None):
    """psd_chirp_kernel and psd_sum.cuh in float32 over a step: k1_group's
    frames a block; lane p of a block sums its frames f0 + p + LANES*i in
    f32; the lanes added in order into a padded partial row; the float64
    row sum."""
    F, N = raw.shape[0], raw.shape[1] // 2
    shape = fb.chirp_launch(N)
    group = fp.k1_group(F, chunk, RESIDENT)
    pwr = chirp_power(raw, window).astype(np.float32)
    rows = []
    for f0 in range(0, F, group):
        acc = np.zeros((shape.lanes, N), np.float32)
        for f in range(f0, min(f0 + group, F, n_valid)):
            acc[(f - f0) % shape.lanes] += pwr[f]
        row = np.zeros(shape.row, np.float32)
        row[:N] = acc[0]
        for lane in acc[1:]:
            row[:N] += lane
        rows.append(row)
    return psd_sum(np.stack(rows))[:N]


@pytest.mark.parametrize("N", [2, 4, 10, 32, 34, 64, 66, 500, 998, 1000])
def test_chirp_transcription_float64_is_the_dft(N):
    raw = frames(2, N, 3 * N + 1)
    got = chirp_power(raw, dtype=np.complex128)
    X = np.fft.fft(dequantize(raw, None, np.complex128), axis=1)
    np.testing.assert_allclose(got, (X * X.conj()).real, rtol=1e-9,
                               atol=1e-9 * got.max())


@pytest.mark.parametrize("N", [10, 22, 500, 998, 2002])
@pytest.mark.parametrize("window", [None, "hann"])
def test_chirp_transcription_float32_against_golden(N, window):
    """The kernel in float32 over a step with masked frames, against the
    float64 golden within 1e-5."""
    F, chunk = adapt_batch(40 if N < 2000 else 16)
    n_valid = F - 3
    raw = frames(F, N, 13 * N)
    w = None if window is None else make_window(window, N)
    got = chirp_transcription(raw, n_valid, chunk, w)
    if w is None:
        gold, _ = golden_accumulate(raw[:n_valid].ravel(), N, n_valid)
        gold = np.fft.ifftshift(gold)
    else:
        X = np.fft.fft(dequantize(raw[:n_valid], None, np.complex128) * w,
                       axis=1)
        gold = (X.real ** 2 + X.imag ** 2).sum(0)
    np.testing.assert_allclose(got, gold, rtol=1e-5)


@pytest.mark.parametrize("N,window", [(998, None), (500, "hann"), (30, None),
                                      (8, "hann")])
def test_chirp_transcription_against_plain_and_jax(N, window):
    """The transcription, the wrapper's plain version (on the CPU) and the
    JAX package's bluestein_psd_partial on the same bytes, within 2e-5
    (two float32 budgets)."""
    F, chunk = adapt_batch(48)
    n_valid = F - 5
    raw = frames(F, N, 17 + N)
    w = None if window is None else make_window(window, N)
    got = chirp_transcription(raw, n_valid, chunk, w)
    plain = fb.fused_psd_bluestein(torch.from_numpy(raw), n_valid, chunk,
                                   None if w is None
                                   else torch.from_numpy(w))
    np.testing.assert_allclose(got, plain.numpy(), rtol=CROSS_RTOL)
    re = raw[:, 0::2].astype(np.float32) - 127
    im = raw[:, 1::2].astype(np.float32) - 127
    if w is not None:
        re, im = re * w, im * w
    fmask = (np.arange(F) < n_valid).astype(np.float32)
    want = np.asarray(bluestein_psd_partial(jnp.asarray(re), jnp.asarray(im),
                                            jnp.asarray(fmask), chunk=chunk))
    np.testing.assert_allclose(got, want, rtol=CROSS_RTOL)


@pytest.mark.parametrize("N", [10, 200, 998, 3000, 8182])
@pytest.mark.parametrize("kernel", [True, False])
def test_spectrum_table_follows_its_plan(N, kernel):
    """Row q of the table of a plan holds B / M at the bin the plan's
    forward passes leave at element q, for the kernel's plan (M =
    chirp_size) and the control's (M = next_pow2(2N - 1))."""
    plan = fb.chirp_plan(N) if kernel else fb.bluestein_plan(N)
    M = int(np.prod(plan))
    _, _, B = fb.bluestein_constants(N, M)
    s = fb.spectrum_table(N, plan)
    q = fm.element_of_bin(plan, np.arange(M))
    np.testing.assert_array_equal(s[q, 0], (B / np.float32(M)).real)
    np.testing.assert_array_equal(s[q, 1], (B / np.float32(M)).imag)
    if kernel:
        k = np.arange(M)
        assert (fm.element_of_bin(plan, pass_bin(M, k)) == k).all()


@pytest.mark.parametrize("N,differs", [(200, True), (3000, True),
                                       (998, False), (8182, False)])
def test_the_two_tables_differ_where_the_plans_do(N, differs):
    """The register plan and mixed_plan split M = 512 and 8192
    differently (16.16.2 against 16.8.4, 16.16.16.2 against 16.16.8.4), so
    the kernel's and the control's tables differ there."""
    assert (fb.chirp_plan(N) != fb.bluestein_plan(N)) is differs
    same = np.array_equal(fb.spectrum_table(N, fb.chirp_plan(N)),
                          fb.spectrum_table(N))
    assert same is not differs


def test_chirp_sizes_of_every_even_n():
    """M = chirp_size(N) is the least power of two >= 2N - 1 (64 at
    least), as the source's chirp_size_ok takes it; its register plan is
    K1's; N <= M / 2, so the upper half of pass 0's values is zero; the
    block fits shared memory; the bins are t + k*TF, k < R / 2."""
    for N in range(2, fb.MAX_N + 1, 2):
        shape = fb.chirp_launch(N)
        M = shape.M
        assert M >= 2 * N - 1 and (M == 64 or 2 * N - 1 > M // 2), N
        assert M & (M - 1) == 0 and fb.MIN_M <= M <= 16384
        assert shape.R == fp.PASS_PLAN[M][0] and 2 * N <= M
        assert shape.threads == max(256, M // shape.R)
        assert shape.threads % shape.tf == 0 and shape.threads <= 1024
        assert shape.smem <= fm.MAX_SMEM, N
        assert shape.row % 32 == 0 and N <= shape.row < N + 32
        assert shape.lanes * shape.row * 4 <= shape.lanes * (M + M // 16) * 8


@pytest.mark.parametrize("N", [2, 32, 34, 500, 998, 4098, 8182, 8192])
def test_chirp_accumulators_own_each_bin_once(N):
    """Thread t's sums k < R / 2 are bins t + k*TF: every bin below N
    exactly once, none of them at M / 2 or above."""
    shape = fb.chirp_launch(N)
    t = np.arange(shape.tf)[:, None]
    bins = (t + np.arange(shape.R // 2)[None, :] * shape.tf).ravel()
    assert sorted(bins) == list(range(shape.M // 2))
    assert sorted(bins[bins < N]) == list(range(N))


def test_chirp_constants_are_the_headers():
    assert header_int("kRegsMinThreads", "fused_psd_regs.cuh") == \
        fb.MIN_THREADS
    assert header_int("kRegsMinLog2N", "fft_regs.cuh") == \
        fb.MIN_M.bit_length() - 1


def test_bluestein_constants_take_any_large_enough_m():
    M, a, B = fb.bluestein_constants(10, 64)
    M0, a0, _ = fb.bluestein_constants(10)
    assert (M, M0) == (64, 32) and np.array_equal(a, a0) and B.shape == (64,)
    with pytest.raises(ValueError):
        fb.bluestein_constants(10, 16)


# --- the ring ---


@pytest.mark.parametrize("N,ptr,width", [
    (2400, 0x7f0000000000, 16), (2400, 0x7f0000000008, 8),
    (2400, 0x7f0000000004, 4), (500, 0x7f0000000000, 8),
    (500, 0x7f0000000004, 4), (998, 0x7f0000000000, 4),
    (8182, 0x7f0000000010, 4), (16384, 0x7f0000000100, 16),
    (2, 0x7f0000000000, 4)])
def test_copy_width_follows_n_and_the_pointer(N, ptr, width):
    """16-byte copies where 2N and the pointer allow them, else 8, else 4;
    every frame start (ptr + f * 2N) is then aligned to the width."""
    assert fm.copy_width(N, ptr) == width
    assert all((ptr + f * 2 * N) % width == 0 for f in range(5))


@pytest.mark.parametrize("ptr", [0x7f0000000002, 0x7f0000000001])
def test_copy_width_refuses_frames_below_4_bytes(ptr):
    with pytest.raises(ValueError, match="not 4-byte aligned"):
        fm.copy_width(500, ptr)


@pytest.mark.parametrize("N", [2, 10, 500, 998, 2400, 8182, 16384])
def test_ring_slots_hold_a_frame_and_stay_aligned(N):
    """A slot holds the frame's 2N bytes and is a multiple of 16, so both
    slots and every lane's ring (two slots and 32 bytes) stay 16-byte
    aligned for the 16-byte copies."""
    slot = fm.ring_slot(N)
    assert slot >= 2 * N and slot % 16 == 0 and slot - 2 * N < 16
    assert (2 * slot + 32) % 16 == 0


# --- the mixed-radix ring kernel ---


def test_ring_constants_are_the_headers():
    f = "fused_psd_mixed_ring.cuh"
    assert header_int("kRingMaxThreads", f) == fm.RING_MAX_THREADS
    text = (CSRC / f).read_text()
    assert re.search(r"kRingMaxSmem = kMixedMaxSmem - (\d+);", text).group(1) \
        == str(fm.MAX_SMEM - fm.RING_MAX_SMEM)
    assert (header_int("kRingAccSmall", f),
            header_int("kRingAccLarge", f)) == fm.RING_ACC
    m = re.search(r"kRingPlanInts = (\d+) \+ (\d+) \* kMixedMaxPasses", text)
    assert int(m.group(1)) + int(m.group(2)) * fm.MAX_PASSES == \
        len(fm.ring_launch(500).ints())


def test_ring_shape_of_every_even_7_smooth_n():
    """Whole warps: tf a multiple of 32 up to 512, a power of two of
    lanes, at most 512 threads a block; the block within 227 KB; the last
    pass's sums within the larger register class."""
    assert len(SMOOTH_EVEN) == 317
    for N in SMOOTH_EVEN:
        shape = fm.ring_launch(N)
        assert shape.plan == fm.mixed_plan(N) and shape.n == N
        assert shape.tf % 32 == 0 and 32 <= shape.tf <= fm.RING_MAX_THREADS
        assert shape.lanes & (shape.lanes - 1) == 0, N
        assert shape.threads <= fm.RING_MAX_THREADS
        assert shape.threads <= max(fm.TARGET_THREADS, shape.tf)
        assert shape.smem() <= fm.RING_MAX_SMEM, N
        assert shape.acc <= shape.acc_class <= fm.RING_ACC[-1]
        assert shape.acc_class // shape.plan[-1] >= shape.rounds[-1]
        assert shape.row % 32 == 0 and N <= shape.row < N + 32
        assert len(shape.ints()) == 5 + 5 * fm.MAX_PASSES


@pytest.mark.parametrize("N,tf,lanes", [(500, 128, 2), (2400, 160, 1),
                                        (6000, 416, 1), (12000, 512, 1),
                                        (2, 32, 8), (30, 32, 8)])
def test_ring_shape_table(N, tf, lanes):
    shape = fm.ring_launch(N)
    assert (shape.tf, shape.lanes) == (tf, lanes)


def test_ring_tf_has_the_fewest_thread_slots():
    """At 2400 (8.5.5.4.3) a lane of 160 threads leaves 60 idle thread
    slots over the passes; every other width whose last pass fits the
    larger register class (96 threads and more) leaves more."""
    plan = fm.mixed_plan(2400)
    slots = {tf: sum(fm.ring_rounds(plan, tf)) * tf
             for tf in range(32, 513, 32)
             if fm.ring_rounds(plan, tf)[-1] * 3 <= fm.RING_ACC[-1]}
    assert min(slots) == 96
    assert slots[160] - sum(2400 // r for r in plan) == 60
    assert min(slots, key=lambda tf: (slots[tf], tf)) == 160


def ring_ints(N):
    """The plan ints by name, as read_ring_plan reads them."""
    ints = fm.ring_launch(N).ints()
    P = fm.MAX_PASSES
    head = dict(zip(("n", "row", "passes", "tf", "lanes"), ints[:5]))
    names = ("radix", "stride", "magic", "twoff", "rounds")
    return head, {name: ints[5 + i * P:5 + (i + 1) * P]
                  for i, name in enumerate(names)}


@pytest.mark.parametrize("N", [500, 2400, 13122])
def test_ring_ints_layout(N):
    head, per = ring_ints(N)
    shape = fm.ring_launch(N)
    P = len(shape.plan)
    assert head["passes"] == P and head["tf"] == shape.tf
    assert (head["n"], head["row"], head["lanes"]) == (N, shape.row,
                                                       shape.lanes)
    spans_ = fm.plan_spans(shape.plan)
    assert per["radix"][:P] == list(shape.plan)
    assert per["stride"][:P] == [S for _, S in spans_]
    assert per["twoff"][:P] == list(np.cumsum([0] + [L for L, _ in
                                                     spans_[:-1]]))
    assert per["rounds"][:P] == list(shape.rounds)
    assert all(v == 0 for name in per for v in per[name][P:])
    assert per["magic"][P - 1] == 0
    assert all(-2 ** 31 <= m < 2 ** 31 for m in per["magic"])


def test_division_constants_are_exact():
    """umulhi(b, ceil(2^32 / S)) = b / S for every butterfly b of every
    middle pass of every plan, and for every b < 2^15 at every S < 2^14
    a plan has."""
    strides = set()
    for N in SMOOTH_EVEN:
        plan = fm.mixed_plan(N)
        for (L, S), r in list(zip(fm.plan_spans(plan), plan))[1:-1]:
            strides.add(S)
            b = np.arange(N // r, dtype=np.uint64)
            got = (b * np.uint64(fm.magic(S))) >> np.uint64(32)
            assert (got == b // np.uint64(S)).all(), (N, S)
    b = np.arange(1 << 15, dtype=np.uint64)
    for S in strides:
        assert S < 1 << 14
        got = (b * np.uint64(fm.magic(S))) >> np.uint64(32)
        assert (got == b // np.uint64(S)).all(), S


def test_ring_passes_cover_each_butterfly_once():
    """For every plan, each pass's butterflies b = t + i*tf (t < tf, i <
    rounds_j, b < N / R_j) are each taken once, and their elements cover
    the frame once: no barrier is needed inside a pass."""
    for N in SMOOTH_EVEN:
        shape = fm.ring_launch(N)
        t = np.arange(shape.tf)[:, None]
        for (L, S), r, rounds in zip(fm.plan_spans(shape.plan), shape.plan,
                                     shape.rounds):
            b = (t + np.arange(rounds)[None, :] * shape.tf).ravel()
            b = b[b < N // r]
            assert sorted(b) == list(range(N // r)), (N, r)
            block, n2 = b // S, b % S
            idx = (block * L + n2)[:, None] + np.arange(r)[None, :] * S
            assert np.array_equal(np.sort(idx.ravel()), np.arange(N))


def test_ring_accumulators_own_each_bin_once():
    """Thread t's register sum i*R + k1 is the last pass's element
    (t + i*tf)*R + k1: the elements of a lane's threads are the frame's
    once each, and element_of_bin gives each bin one of them."""
    for N in SMOOTH_EVEN:
        shape = fm.ring_launch(N)
        R = shape.plan[-1]
        t = np.arange(shape.tf)[:, None, None]
        i = np.arange(shape.acc_class // R)[None, :, None]
        k1 = np.arange(R)[None, None, :]
        b = t + i * shape.tf
        elements = np.broadcast_to(b * R + k1, (shape.tf, i.shape[1], R))
        owned = elements[np.broadcast_to(b < N // R, elements.shape)]
        assert np.array_equal(np.sort(owned), np.arange(N)), N
        q = fm.element_of_bin(shape.plan, np.arange(N))
        assert np.array_equal(np.sort(q), np.arange(N))


def ring_power(raw, window=None, dtype=np.complex64):
    """|DFT|^2 of each frame as psd_ring_kernel computes it, thread by
    thread: pass 0's butterflies b = t + i*tf over the samples, the middle
    passes' (block, n2) by the division constants, the last pass into the
    threads' register sums, gathered at their elements and read by
    element_of_bin. (F, N), bins in natural order."""
    F, N = raw.shape[0], raw.shape[1] // 2
    shape = fm.ring_launch(N)
    head, per = ring_ints(N)
    P, tf = head["passes"], head["tf"]
    tw = twiddle_table(shape.plan, dtype)
    x = dequantize(raw, window, dtype)
    t = np.arange(tf)
    xbuf = np.full((F, N), np.nan, dtype)
    if P == 1:
        xbuf[:, np.arange(N)] = x
    else:
        R, S = per["radix"][0], per["stride"][0]
        for i in range(per["rounds"][0]):
            b = t + i * tf
            b = b[b < S]
            v = dft_natural(x[:, b[:, None] + np.arange(R)[None, :] * S])
            k1 = np.arange(R)[None, :]
            w = np.where(k1 == 0, 1, tw[k1 * S + b[:, None]])
            xbuf[:, b[:, None] + k1 * S] = v * w.astype(dtype)
    for j in range(1, P - 1):
        R, S, m, off = (per[k][j] for k in ("radix", "stride", "magic",
                                            "twoff"))
        for i in range(per["rounds"][j]):
            b = (t + i * tf).astype(np.uint64)
            b = b[b < N // R]
            block = ((b * np.uint64(m % (1 << 32))) >> np.uint64(32)
                     ).astype(np.int64)
            n2 = b.astype(np.int64) - block * S
            base = block * R * S + n2
            idx = base[:, None] + np.arange(R)[None, :] * S
            v = dft_natural(xbuf[:, idx])
            k1 = np.arange(R)[None, :]
            w = np.where(k1 == 0, 1, tw[off + k1 * S + n2[:, None]])
            xbuf[:, idx] = v * w.astype(dtype)
    R = per["radix"][P - 1]
    acc = np.zeros((F, tf, shape.acc_class), x.real.dtype)
    for i in range(shape.acc_class // R):
        b = t + i * tf
        live = b < N // R
        idx = (b[live] * R)[:, None] + np.arange(R)[None, :]
        v = dft_natural(xbuf[:, idx])
        acc[:, live, i * R:(i + 1) * R] = v.real ** 2 + v.imag ** 2
    by_elem = np.zeros((F, N), x.real.dtype)
    for i in range(shape.acc_class // R):
        b = t + i * tf
        live = b < N // R
        for k1 in range(R):
            by_elem[:, b[live] * R + k1] = acc[:, live, i * R + k1]
    return by_elem[:, fm.element_of_bin(shape.plan, np.arange(N))]


@pytest.mark.parametrize("N", [2, 6, 16, 30, 500, 768, 2400, 4800, 12000])
def test_ring_transcription_float64_is_the_dft(N):
    raw = frames(2, N, 5 * N + 2)
    got = ring_power(raw, dtype=np.complex128)
    X = np.fft.fft(dequantize(raw, None, np.complex128), axis=1)
    np.testing.assert_allclose(got, (X * X.conj()).real, rtol=1e-9,
                               atol=1e-9 * got.max())


@pytest.mark.parametrize("N", [6, 30, 500, 2400])
@pytest.mark.parametrize("window", [None, "hann"])
def test_ring_transcription_float32_against_golden(N, window):
    """The kernel in float32 over a step with masked frames (the ring's
    lanes and grid), against the float64 golden within 1e-5."""
    F, chunk = adapt_batch(40)
    n_valid = F - 3
    raw = frames(F, N, 19 * N)
    w = None if window is None else make_window(window, N)
    got = kernel_transcription(raw, n_valid, chunk, w, power=ring_power,
                               shape=fm.ring_launch(N))
    X = np.fft.fft(dequantize(raw[:n_valid], None, np.complex128)
                   * (1 if w is None else w), axis=1)
    np.testing.assert_allclose(got, (X.real ** 2 + X.imag ** 2).sum(0),
                               rtol=1e-5)


@pytest.mark.parametrize("N,window", [(500, None), (2400, "hann"),
                                      (30, None)])
def test_ring_transcription_against_plain(N, window):
    F, chunk = adapt_batch(64)
    raw = frames(F, N, 23 + N)
    w = None if window is None else make_window(window, N)
    got = kernel_transcription(raw, F - 5, chunk, w, power=ring_power,
                               shape=fm.ring_launch(N))
    plain = fm.fused_psd_mixed(torch.from_numpy(raw), F - 5, chunk,
                               None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got, plain.numpy(), rtol=CROSS_RTOL)


# --- the wrappers on the CPU ---


@pytest.mark.parametrize("name", ["mixed", "bluestein"])
def test_controls_on_the_cpu_take_the_plain_version(name):
    """The controls run their plain versions on CPU tensors, single-stream
    and streams, counted apart from COUNTS."""
    N = 500 if name == "mixed" else 998
    control = getattr(fb if name == "bluestein" else fm,
                      f"fused_psd_{name}_control")
    main = getattr(fb if name == "bluestein" else fm, f"fused_psd_{name}")
    fp.COUNTS.reset()
    fm.CONTROL_COUNTS.reset()
    raw = torch.from_numpy(frames(16, N, 4))
    one = control(raw, 13, 8)
    streams = control(raw.reshape(2, 8, 2 * N),
                      torch.tensor([8, 5], dtype=torch.int32), 8)
    assert fm.CONTROL_COUNTS.plain == 2 and fp.COUNTS.plain == 0
    np.testing.assert_array_equal(one.numpy(), main(raw, 13, 8).numpy())
    np.testing.assert_allclose(streams[1].numpy(),
                               main(raw[8:], 5, 8).numpy(), rtol=1e-6)
    with pytest.raises(ValueError):
        control(torch.zeros((8, 2 * N + 2), dtype=torch.uint8), 8, 8)


@pytest.mark.cuda
def test_kernels_match_their_controls_on_card():
    """Runs only where a CUDA device is present (chip_smoke.py covers it
    in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    for N, kernel, control in ((2400, fm.fused_psd_mixed,
                                fm.fused_psd_mixed_control),
                               (998, fb.fused_psd_bluestein,
                                fb.fused_psd_bluestein_control)):
        raw = torch.from_numpy(frames(256, N, 2)).cuda()
        np.testing.assert_allclose(kernel(raw, 200, 64).cpu().numpy(),
                                   control(raw, 200, 64).cpu().numpy(),
                                   rtol=2e-6)


# --- the layout probe's source edits ---


@pytest.mark.parametrize("layout", ring_layouts.LAYOUTS)
def test_ring_layout_edits_apply_to_the_header(layout):
    """Each layout of probes/ring_layouts.py edits the shipped header as it
    says: the exchange accesses through xpad and the buffers sized for it
    (pad16), the small class's launch bounds (small64); plain is the
    header itself."""
    text = (CSRC / ring_layouts.HEADER).read_text()
    got = ring_layouts.layout_sources(text, layout)
    assert (got == text) == (layout == "plain")
    pad = "pad16" in layout
    assert (len(re.findall(r"\bx\[xpad\(", got)) == 5) == pad
    assert ("e + (e >> 4)" in got) == pad
    assert ("lane * (n + n / 16 + 1);" in got) == pad
    assert ("ACC <= kRingAccSmall ? 2 : 1" in got) == ("small64" in layout)
    assert (ring_layouts.BOUNDS in got) != ("small64" in layout)


def test_ring_layouts_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert ring_layouts.main([]) == 1
