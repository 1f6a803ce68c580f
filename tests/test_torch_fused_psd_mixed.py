"""The mixed-radix fused PSD kernel (csrc/fused_psd_mixed.cu with
csrc/fused_psd_mixed.cuh and csrc/fft_mixed.cuh), transcribed in numpy.

The CUDA kernel runs only on a card (chip_smoke.py); its plan and index
arithmetic are pinned here: the radices (read out of the header) and the
pass plan of every even 7-smooth N up to 16384, the block layout, the
twiddle table's layout and exact angles, the radix-3/5/7 constants (read
out of the header), the butterflies' partition of each pass's elements,
the element -> bin map, and the whole kernel (first pass from the bytes,
passes through the exchange, f32 accumulators by lane, padded partial
rows, the float64 row sum) in float64 against numpy.fft (rtol 1e-9) and
in float32 against tests/golden.py (rtol 1e-5). The plain version on the
CPU is K1's own, held to the JAX package's step in
tests/test_torch_awkward_n.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu_torch.auxdata import make_window
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed as fm
from rtl_power_fftw_tpu_torch.ops.spectral import adapt_batch

from golden import golden_accumulate

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "rtl_power_fftw_tpu_torch/ops/kernels/csrc"
SMOOTH_EVEN = [N for N in range(2, fm.MAX_N + 1, 2) if fm.smooth7(N)]
TRANSCRIBED = [6, 10, 14, 30, 96, 500, 2400, 12000]
#: resident_blocks stand-in for the grid rule: 132 SMs (an H100) times
#: four blocks.
RESIDENT = 132 * 4


def header_radices():
    text = (CSRC / "fft_mixed.cuh").read_text()
    m = re.search(r"kMixedRadices\[\] = \{([\d, ]+)\}", text)
    return tuple(int(v) for v in m.group(1).split(","))


def header_odd(fn):
    """{R: [values, j = 1 .. (R-1)/2]} of odd_cos or odd_sin's literals."""
    text = (CSRC / "fft_mixed.cuh").read_text()
    body = text[text.index(f"constexpr float {fn}"):]
    body = body[:body.index("return")]
    return {int(r): [float(v) for v in vals.split(",")]
            for r, vals in re.findall(r"[cs](\d)\[\] = \{([^}]*)\}", body)}


def odd_constant(R, j, fn, dtype):
    """cos or sin of 2 pi j / R as the kernel takes it, 0 < j < R."""
    H = (R - 1) // 2
    table = header_odd(fn)[R]
    if j <= H:
        return dtype(table[j - 1])
    sign = 1.0 if fn == "odd_cos" else -1.0
    return dtype(sign * table[R - j - 1])


def rev_bits(i, bits):
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def w16(dtype):
    """W_16^q, q < 8, as fft_regs.cuh's w16 (its float64 literals)."""
    text = (CSRC / "fft_regs.cuh").read_text()
    body = text[text.index("constexpr float w16"):]
    body = body[:body.index("};")]
    pairs = re.findall(r"\{(-?[\d.]+), (-?[\d.]+)\}", body)
    real = np.float32 if dtype == np.complex64 else np.float64
    return np.array([real(a) + 1j * real(b) for a, b in pairs], dtype)


def dif_regs(v, W):
    """fft_regs.cuh's dif_regs on each row of v (.., R): radix-2 DIF
    stages of half-span M = R/2 .. 1 with W_16 constants; column r then
    holds output rev_bits(r)."""
    v = v.copy()
    R = v.shape[-1]
    M = R // 2
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
                d = d * W[q]
            v[..., i0 + M] = d
        M //= 2
    return v


def dft_natural(v):
    """fft_mixed.cuh's dft_natural on each row of v (.., R): the radix-R
    DFT, outputs in natural order, in v's precision."""
    R = v.shape[-1]
    if R == 2:
        return np.stack([v[..., 0] + v[..., 1], v[..., 0] - v[..., 1]], -1)
    if R % 2:
        real = v.real.dtype.type
        H = (R - 1) // 2
        s = [v[..., m] + v[..., R - m] for m in range(1, H + 1)]
        d = [v[..., m] - v[..., R - m] for m in range(1, H + 1)]
        out = np.empty_like(v)
        y0 = v[..., 0].copy()
        for m in range(H):
            y0 = y0 + s[m]
        out[..., 0] = y0
        for k in range(1, H + 1):
            ar, ai = v[..., 0].real.copy(), v[..., 0].imag.copy()
            br, bi = np.zeros_like(ar), np.zeros_like(ai)
            for m in range(1, H + 1):
                j = (m * k) % R
                c = odd_constant(R, j, "odd_cos", real)
                sn = odd_constant(R, j, "odd_sin", real)
                ar = ar + s[m - 1].real * c
                ai = ai + s[m - 1].imag * c
                br = br + d[m - 1].imag * sn
                bi = bi - d[m - 1].real * sn
            out[..., k] = (ar + br) + 1j * (ai + bi)
            out[..., R - k] = (ar - br) + 1j * (ai - bi)
        return out
    y = dif_regs(v, w16(v.dtype.type))
    out = np.empty_like(y)
    for r in range(R):
        out[..., rev_bits(r, R.bit_length() - 1)] = y[..., r]
    return out


def butterflies(n, L, S):
    """(n2, base, elements) of a pass's n / R butterflies in thread order
    (butterfly b = t + i*tf is thread t's i-th): butterfly b takes the
    elements base + n1*S, n1 < R."""
    R = L // S
    b = np.arange(n // R)
    n2 = b % S
    base = (b // S) * L + n2
    return n2, base, base[:, None] + np.arange(R)[None, :] * S


def twiddle_table(plan, dtype):
    """plan_twiddles as complex64, or in float64 from its layout (for the
    float64 transcription, which checks the algebra)."""
    if dtype == np.complex128:
        parts = []
        for L, S in fm.plan_spans(plan)[:-1]:
            k1, n2 = np.meshgrid(np.arange(L // S), np.arange(S),
                                 indexing="ij")
            parts.append(np.exp(-2j * np.pi * (k1 * n2 % L) / L).ravel())
        return np.concatenate(parts) if parts else np.ones(1, dtype)
    t = fm.plan_twiddles(plan)
    return (t[:, 0] + 1j * t[:, 1]).astype(dtype)


def dif(x, plan, tw):
    """The forward passes of fft_mixed.cuh on each row of x (F, n): DIF,
    element q of the result holds bin element_of_bin^-1(q)."""
    n = x.shape[1]
    x = x.copy()
    offset = 0
    for j, (L, S) in enumerate(fm.plan_spans(plan)):
        n2, _, idx = butterflies(n, L, S)
        v = dft_natural(x[:, idx])
        if j < len(plan) - 1:
            k1 = np.arange(L // S)[None, :]
            w = tw[offset + k1 * S + n2[:, None]]
            v = np.where(k1 == 0, v, v * w)
        x[:, idx] = v
        offset += L
    return x


def dit(x, plan, tw):
    """The transposed passes P - 1 .. 0 (dit_pass, and the turn's second
    butterfly): the twiddle on each input, then the butterfly, in place;
    the inverse of dif's order, natural order out."""
    n = x.shape[1]
    x = x.copy()
    spans = fm.plan_spans(plan)
    offsets = np.concatenate([[0], np.cumsum([L for L, _ in spans])])
    for j in range(len(plan) - 1, -1, -1):
        L, S = spans[j]
        n2, _, idx = butterflies(n, L, S)
        v = x[:, idx]
        if j < len(plan) - 1:
            k = np.arange(L // S)[None, :]
            v = np.where(k == 0, v, v * tw[offsets[j] + k * S + n2[:, None]])
        x[:, idx] = dft_natural(v)
    return x


def dequantize(raw, window, dtype):
    real = np.float32 if dtype == np.complex64 else np.float64
    re = raw[:, 0::2].astype(real) - real(127)
    im = raw[:, 1::2].astype(real) - real(127)
    if window is not None:
        w = np.asarray(window, np.float32).astype(real)
        re, im = re * w, im * w
    return (re + 1j * im).astype(dtype)


def mixed_power(raw, window=None, dtype=np.complex64):
    """|DFT|^2 of each frame as the kernel computes it, bins in natural
    order."""
    N = raw.shape[1] // 2
    plan = fm.mixed_plan(N)
    y = dif(dequantize(raw, window, dtype), plan, twiddle_table(plan, dtype))
    y = y[:, fm.element_of_bin(plan, np.arange(N))]
    return y.real * y.real + y.imag * y.imag


def psd_sum(partial):
    """psd_sum.cuh in float64: lane l of 8 sums rows l, l + 8, ...; the
    lanes are added in order."""
    lanes = [partial[l::8].astype(np.float64).sum(0) for l in range(8)]
    total = np.zeros(partial.shape[1])
    for lane in lanes:
        total = total + lane
    return total.astype(np.float32)


def kernel_transcription(raw, n_valid, chunk, window=None,
                         power=mixed_power, shape=None):
    """The kernel in float32 as one step runs it: mixed_group's frames a
    block, lane p summing frames f0 + p + lanes*i into its f32
    accumulator, the lanes added in order into a padded partial row, the
    float64 row sum; the first N floats of the output."""
    F, N = raw.shape[0], raw.shape[1] // 2
    shape = shape or fm.launch_shape(fm.mixed_plan(N), N)
    group = fm.mixed_group(F, chunk, RESIDENT, shape.lanes)
    pwr = power(raw, window).astype(np.float32)
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


@pytest.mark.parametrize("F,chunk,resident,lanes,group", [
    (32, 32, 264, 2, 2), (32, 32, 264, 1, 1), (4096, 64, 264, 2, 16),
    (8, 8, 264, 64, 8), (4096, 64, 132, 1, 32)])
def test_group(F, chunk, resident, lanes, group):
    """k1_group's rule, but never fewer frames than lanes a block (the
    man-page drive's 32 frames at 500 bins: 16 blocks of 2 lanes)."""
    assert fm.mixed_group(F, chunk, resident, lanes) == group
    assert chunk % group == 0


def frames(F, N, seed):
    return np.random.default_rng(seed).integers(0, 256, (F, 2 * N),
                                                dtype=np.uint8)


def test_radices_are_the_headers():
    assert header_radices() == fm.RADICES


@pytest.mark.parametrize("fn,f", [("odd_cos", np.cos), ("odd_sin", np.sin)])
def test_odd_constants_are_the_float64_values(fn, f):
    for R, values in header_odd(fn).items():
        assert len(values) == (R - 1) // 2
        for j, v in enumerate(values, start=1):
            assert abs(v - f(2 * np.pi * j / R)) < 1e-15
            assert np.float32(v) == np.float32(f(2 * np.pi * j / R))


def test_plan_of_every_even_7_smooth_n():
    """The radices multiply to N, are the kernel's, at most MAX_PASSES;
    the block's threads are within 1024 (MAX_THREADS) and its shared
    memory within 227 KB."""
    assert len(SMOOTH_EVEN) > 300
    for N in SMOOTH_EVEN:
        plan = fm.mixed_plan(N)
        assert int(np.prod(plan)) == N, N
        assert set(plan) <= set(fm.RADICES) and len(plan) <= fm.MAX_PASSES
        assert list(plan) == sorted(plan, reverse=True)
        shape = fm.launch_shape(plan, N)
        assert 1 <= shape.threads <= fm.MAX_THREADS <= 1024, N
        assert shape.lanes & (shape.lanes - 1) == 0
        assert shape.smem <= fm.MAX_SMEM, N
        assert shape.row % 32 == 0 and N <= shape.row < N + 32
        assert shape.xstride == fm.pad_index(N - 1) + 1
        assert len(shape.ints()) == 7 + fm.MAX_PASSES


@pytest.mark.parametrize("N,plan", [(2, (2,)), (6, (3, 2)), (16, (16,)),
                                    (32, (8, 4)), (500, (5, 5, 5, 4)),
                                    (2400, (8, 5, 5, 4, 3)),
                                    (12000, (8, 5, 5, 5, 4, 3)),
                                    (13122, (3,) * 8 + (2,)),
                                    (16200, (8, 5, 5, 3, 3, 3, 3))])
def test_plan_table(N, plan):
    assert fm.mixed_plan(N) == plan


@pytest.mark.parametrize("N", [0, 1, 22, 26, 34, 16383 * 2])
def test_no_plan_without_7_smooth(N):
    if N >= 2 and fm.smooth7(N):
        pytest.fail("the case is 7-smooth")
    with pytest.raises(ValueError):
        fm.mixed_plan(N)


@pytest.mark.parametrize("N,ok", [(2, True), (4, True), (500, True),
                                  (2400, True), (16200, True),
                                  (16384, True), (3, False), (22, False),
                                  (998, False), (16464, False),
                                  (32768, False)])
def test_eligible(N, ok):
    assert fm.fused_psd_mixed_eligible(N) is ok


@pytest.mark.parametrize("N", [6, 96, 500, 2400, 12000])
def test_twiddle_layout(N):
    """Row offset_j + k1 S_j + n2 holds W_{L_j}^(k1 n2), rounded once
    from float64."""
    plan = fm.mixed_plan(N)
    tw = fm.plan_twiddles(plan)
    offset = 0
    for L, S in fm.plan_spans(plan)[:-1]:
        k1, n2 = np.meshgrid(np.arange(L // S), np.arange(S), indexing="ij")
        want = np.exp(-2j * np.pi * (k1 * n2 % L) / L).ravel()
        got = tw[offset:offset + L]
        np.testing.assert_array_equal(got[:, 0], want.real.astype(np.float32))
        np.testing.assert_array_equal(got[:, 1], want.imag.astype(np.float32))
        offset += L
    assert len(tw) == offset


@pytest.mark.parametrize("N", [2, 30, 500, 2400, 12000, 13122])
def test_butterflies_partition_each_pass(N):
    """Each pass's butterflies, over the lane's threads t < tf (b = t +
    i*tf), touch every element exactly once: a pass is in place, and no
    barrier is needed inside it."""
    plan = fm.mixed_plan(N)
    tf = fm.launch_shape(plan, N).tf
    for L, S in fm.plan_spans(plan):
        _, _, idx = butterflies(N, L, S)
        by_thread = np.concatenate([idx[t::tf] for t in range(tf)])
        assert sorted(by_thread.ravel()) == list(range(N))


@pytest.mark.parametrize("N", [6, 30, 500, 2400, 12000, 16200])
def test_element_of_bin_is_the_digit_reversal(N):
    """element_of_bin is a permutation, and the forward passes leave bin
    k at it (float64 against numpy.fft)."""
    plan = fm.mixed_plan(N)
    q = fm.element_of_bin(plan, np.arange(N))
    assert sorted(q) == list(range(N))
    x = np.random.default_rng(N).standard_normal((1, N)) + 0j
    y = dif(x, plan, twiddle_table(plan, np.complex128))
    np.testing.assert_allclose(y[0, q], np.fft.fft(x[0]), rtol=1e-9,
                               atol=1e-9 * np.sqrt(N))


@pytest.mark.parametrize("N", TRANSCRIBED)
def test_transcription_float64_is_the_dft(N):
    raw = frames(3, N, N)
    got = mixed_power(raw, dtype=np.complex128)
    z = dequantize(raw, None, np.complex128)
    X = np.fft.fft(z, axis=1)
    np.testing.assert_allclose(got, (X * X.conj()).real, rtol=1e-9)


@pytest.mark.parametrize("N", TRANSCRIBED)
@pytest.mark.parametrize("window", [None, "hann"])
def test_transcription_float32_against_golden(N, window):
    """The kernel in float32 over a step with masked frames, against the
    float64 golden within 1e-5 (the FFTW-class budget)."""
    F, chunk = adapt_batch(40 if N < 4000 else 8)
    n_valid = F - 3
    raw = frames(F, N, 7 * N)
    w = None if window is None else make_window(window, N)
    got = kernel_transcription(raw, n_valid, chunk, w)
    if w is None:
        gold, _ = golden_accumulate(raw[:n_valid].ravel(), N, n_valid)
        gold = np.fft.ifftshift(gold)
    else:
        z = dequantize(raw[:n_valid], None, np.complex128) * w
        X = np.fft.fft(z, axis=1)
        gold = (X.real ** 2 + X.imag ** 2).sum(0)
    np.testing.assert_allclose(got, gold, rtol=1e-5)


@pytest.mark.parametrize("N,window", [(500, None), (2400, "hann"),
                                      (30, None)])
def test_transcription_against_plain(N, window):
    """The transcription and the wrapper's plain version (on the CPU) on
    the same bytes, within 2e-5 (two float32 budgets)."""
    F, chunk = adapt_batch(64)
    raw = frames(F, N, 3 + N)
    w = None if window is None else make_window(window, N)
    got = kernel_transcription(raw, F - 5, chunk, w)
    plain = fm.fused_psd_mixed(torch.from_numpy(raw), F - 5, chunk,
                               None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got, plain.numpy(), rtol=2e-5)


def test_cpu_tensors_take_the_plain_version():
    fp.COUNTS.reset()
    raw = torch.from_numpy(frames(16, 500, 1))
    out = fm.fused_psd_mixed(raw, 16, 16)
    streams = fm.fused_psd_mixed_streams(
        raw.reshape(2, 8, 1000), torch.tensor([8, 3], dtype=torch.int32), 8)
    assert out.shape == (500,) and streams.shape == (2, 500)
    assert fp.COUNTS.plain == 2 and fp.COUNTS.kernel_mixed == 0
    want = fp.fused_psd_reference(raw[8:11], 3, 1)
    np.testing.assert_allclose(streams[1].numpy(), want.numpy(), rtol=1e-6)


@pytest.mark.parametrize("make,n_valid,chunk,exc", [
    (lambda: torch.zeros((8, 44), dtype=torch.uint8), 8, 8, ValueError),
    (lambda: torch.zeros((8, 1000), dtype=torch.int16), 8, 8, TypeError),
    (lambda: torch.zeros((8, 1000), dtype=torch.uint8), 9, 8, ValueError),
    (lambda: torch.zeros((8, 1000), dtype=torch.uint8), 8, 3, ValueError),
])
def test_rejects_what_the_kernel_does_not_take(make, n_valid, chunk, exc):
    with pytest.raises(exc):
        fm.fused_psd_mixed(make(), n_valid, chunk)


def test_streams_rejects_ineligible_n():
    with pytest.raises(ValueError, match="fused_psd_mixed_streams does not "
                       "take N=22"):
        fm.fused_psd_mixed_streams(torch.zeros((2, 8, 44), dtype=torch.uint8),
                                   torch.tensor([8, 8], dtype=torch.int32), 8)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Runs only where a CUDA device is present (chip_smoke.py covers it
    in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    raw = torch.from_numpy(frames(256, 500, 2)).cuda()
    got = fm.fused_psd_mixed(raw, 200, 64)
    want = fp.fused_psd_reference(raw, 200, 64)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5)
