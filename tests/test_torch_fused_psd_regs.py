"""K1/K2/K4's group kernel as it ships, the register transform of
csrc/fused_psd_regs.cuh and csrc/fft_regs.cuh, transcribed in numpy.

The CUDA kernel runs only on a card (chip_smoke.py); its index arithmetic
is pinned here: the pass plan (read out of the header), the thread ->
sample map, the radix-R butterflies in registers with their W_16
constants (read out of the header), the padded exchange between passes,
``pass_twiddles``' layout, the slot -> bin map, the grid rule
``k1_group`` with the lanes of a block and its f32 sums, and the float64
row sum. The transcription is held in float64 against numpy.fft, in
float32 against tests/golden.py (rtol 1e-5) and against the JAX kernel in
interpret mode on the same bytes (rtol 2e-5: the two float32 budgets
add). A bank model of the exchange and of the ring's u16 reads holds the
padding's claim.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu.auxdata import make_window
from rtl_power_fftw_tpu.ops.kernels import make_fused_psd_fn
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.spectral import adapt_batch

from golden import golden_accumulate

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "rtl_power_fftw_tpu_torch/ops/kernels/csrc"
SIZES = sorted(fp.PASS_PLAN)
MIN_THREADS = 256          # kRegsMinThreads
SMEM_PER_BLOCK = 232448    # the 227 KB a Hopper block may use
#: resident_blocks on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's
#: occupancy lines: 132 SMs times K1's and K2's blocks per SM by N), the
#: grid rule's input at the shapes the card runs.
H100_BLOCKS = {64: (5, 5), 128: (2, 2), 256: (2, 2), 512: (3, 2),
               1024: (3, 2), 2048: (3, 2), 4096: (3, 2), 8192: (1, 1),
               16384: (1, 1)}


def h100_resident(N, windowed=False):
    return 132 * H100_BLOCKS[N][int(windowed)]


def header_plan():
    """{N: radices} of pass_radix's table in fft_regs.cuh."""
    text = (CSRC / "fft_regs.cuh").read_text()
    rows = re.findall(r"\{(\d+), (\d+), (\d+), (\d+)\},\s*// (\d+)", text)
    return {int(r[4]): tuple(int(v) for v in r[:4] if int(v)) for r in rows}


def header_w16():
    """W_16^q, q < 8, as w16's float64 literals in fft_regs.cuh."""
    text = (CSRC / "fft_regs.cuh").read_text()
    body = text[text.index("constexpr float w16"):]
    body = body[:body.index("};")]
    pairs = re.findall(r"\{(-?[\d.]+), (-?[\d.]+)\}", body)
    return np.array([float(a) + 1j * float(b) for a, b in pairs])


def frames(F, N, seed):
    return np.random.default_rng(seed).integers(0, 256, (F, 2 * N),
                                                dtype=np.uint8)


def unshift(x):
    return np.fft.ifftshift(np.asarray(x))


def pad(e):
    return e + (e >> 4)


def rev_bits(i, bits):
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def spans(N):
    """(L_j, S_j) of each pass: block span and stride."""
    out, L = [], N
    for r in fp.PASS_PLAN[N]:
        out.append((L, L // r))
        L //= r
    return out


def pass_bin(N, q):
    """The bin of element q after the last pass: its digits reversed."""
    bin_, scale = np.zeros_like(q), 1
    for L, S in spans(N):
        r = L // S
        bin_ = bin_ + ((q // S) % r) * scale
        scale *= r
    return bin_


def exact_pass_twiddles(N):
    """pass_twiddles' layout in float64, from its docstring."""
    parts = []
    for L, S in spans(N)[:-1]:
        k1 = np.arange(L // S)[:, None]
        n2 = np.arange(S)[None, :]
        parts.append(np.exp(-2j * np.pi * (k1 * n2 % L) / L).ravel())
    return np.concatenate(parts)


def dif_regs(v, w16):
    """A radix-R DFT of each row of v (.., R) as the kernel does it in
    registers: radix-2 DIF stages of half-span M = R/2 .. 1, butterfly J
    pairing (J // M) * 2M + J % M with that + M, the difference times
    W_16^((J % M) * 8 / M) (W^0 and W^4 = -i without a multiply). Column
    r then holds output rev_bits(r)."""
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
                d = d.imag - 1j * d.real
            elif q:
                d = d * w16[q]
            v[..., i0 + M] = d
        M //= 2
    return v


def transform(x, twiddle, w16):
    """One frame through the register transform. x (N,) complex; returns
    (values, bins), each (TF, R): thread t's slot k after the last pass
    and the bin it holds. Vectorized over the frame's threads."""
    N = len(x)
    plan = fp.PASS_PLAN[N]
    R, TF = plan[0], N // plan[0]
    t = np.arange(TF)
    xbuf = np.full(pad(N - 1) + 1, np.nan, dtype=x.dtype)
    # Pass 0: thread t holds samples t + k*TF; outputs to t + k1*TF.
    v = dif_regs(x[t[:, None] + np.arange(R)[None, :] * TF], w16)
    bits = plan[0].bit_length() - 1
    for r in range(R):
        k1 = rev_bits(r, bits)
        y = v[:, r] * twiddle[k1 * TF + t] if k1 else v[:, r]
        xbuf[pad(t + k1 * TF)] = y
    offset = N
    values = np.empty((TF, R), dtype=x.dtype)
    bins = np.empty((TF, R), dtype=np.int64)
    for j, (L, S) in enumerate(spans(N)[1:], start=1):
        RJ = L // S
        bits = RJ.bit_length() - 1
        last = j == len(plan) - 1
        for i in range(R // RJ):
            b = t + i * TF
            n2 = b % S
            base = (b // S) * L + n2
            idx = base[:, None] + np.arange(RJ)[None, :] * S
            vv = dif_regs(xbuf[pad(idx)], w16)
            for r in range(RJ):
                k1 = rev_bits(r, bits)
                if last:
                    values[:, i * RJ + r] = vv[:, r]
                    bins[:, i * RJ + r] = pass_bin(N, base + k1 * S)
                else:
                    y = (vv[:, r] * twiddle[offset + k1 * S + n2] if k1
                         else vv[:, r])
                    xbuf[pad(base + k1 * S)] = y
        offset += L
    return values, bins


def regs_transcription(raw, n_valid, chunk, window=None):
    """numpy transcription of K1/K2's group kernel and psd_sum.cuh in
    float32: k1_group's frames a block; lane p of a block sums its frames
    f0 + p + LANES*i in f32 per slot; the lanes' sums, by bin, added lane
    by lane in order; the float64 sum of the partial rows, lane l of 8
    taking rows l, l + 8, ...; dequantization exact, the window in
    float32."""
    F, N = raw.shape[0], raw.shape[1] // 2
    TF = N // fp.PASS_PLAN[N][0]
    lanes = max(MIN_THREADS, TF) // TF
    tw = fp.pass_twiddles(N)
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    w16 = header_w16().astype(np.complex64)
    group = fp.k1_group(F, chunk, h100_resident(N, window is not None))
    rows = []
    for f0 in range(0, F, group):
        acc = np.zeros((lanes, N), np.float32)
        for f in range(f0, min(f0 + group, F, n_valid)):
            re = raw[f, 0::2].astype(np.float32) - np.float32(127)
            im = raw[f, 1::2].astype(np.float32) - np.float32(127)
            if window is not None:
                w = np.asarray(window, np.float32)
                re, im = re * w, im * w
            vals, bins = transform((re + 1j * im).astype(np.complex64), tw,
                                   w16)
            power = vals.real * vals.real + vals.imag * vals.imag
            acc[(f - f0) % lanes, bins] += power
        row = acc[0].copy()
        for lane in range(1, lanes):
            row += acc[lane]
        rows.append(row)
    rows = np.asarray(rows, np.float64)
    total = np.zeros(N)
    for lane in range(8):
        total += rows[lane::8].sum(0)
    return total.astype(np.float32)


# --- the tables ---

def test_pass_plan_is_the_headers():
    assert header_plan() == fp.PASS_PLAN
    for N, plan in fp.PASS_PLAN.items():
        assert np.prod(plan) == N and all(r <= plan[0] for r in plan)
        assert plan[0] in (8, 16) and len(plan) >= 2
        # R = 16 wherever N allows; a frame's threads fill a warp or part
        # of one only at the smallest sizes.
        assert plan[0] == 16 or N == 64


def test_w16_constants_are_float64_rounded_once():
    w = header_w16()
    q = np.arange(8)
    exact = np.exp(-2j * np.pi * q / 16)
    exact = np.where(np.abs(exact.real) < 1e-15, 0, exact.real) + 1j * \
        np.where(np.abs(exact.imag) < 1e-15, 0, exact.imag)
    assert w.shape == (8,)
    np.testing.assert_array_equal(w.real.astype(np.float32),
                                  exact.real.astype(np.float32))
    np.testing.assert_array_equal(w.imag.astype(np.float32),
                                  exact.imag.astype(np.float32))
    np.testing.assert_allclose(w, exact, rtol=0, atol=2e-16)


@pytest.mark.parametrize("N", SIZES)
def test_pass_twiddles_layout(N):
    tw = fp.pass_twiddles(N)
    want = exact_pass_twiddles(N)
    assert tw.dtype == np.float32 and tw.shape == (len(want), 2)
    # the spans of every pass but the last
    assert len(want) == sum(L for L, _ in spans(N)[:-1])
    np.testing.assert_array_equal(tw[:, 0], want.real.astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], want.imag.astype(np.float32))


@pytest.mark.parametrize("N", SIZES)
def test_shared_memory_fits_a_block(N):
    TF = N // fp.PASS_PLAN[N][0]
    threads = max(MIN_THREADS, TF)
    lanes = threads // TF
    smem = lanes * (8 * (N + N // 16) + 4 * N + 32)
    assert threads <= 1024 and smem <= SMEM_PER_BLOCK
    # the exchange buffer holds every padded element; the lanes' sums by
    # bin fit in it at the end
    assert pad(N - 1) < N + N // 16 and lanes * N * 4 <= lanes * 8 * N


# --- the transform in float64 ---

@pytest.mark.parametrize("N", SIZES)
def test_transform_in_float64_is_the_dft(N):
    rng = np.random.default_rng(N)
    x = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    vals, bins = transform(x, exact_pass_twiddles(N), header_w16())
    assert sorted(bins.ravel().tolist()) == list(range(N))
    X = np.fft.fft(x)
    np.testing.assert_allclose(vals, X[bins], rtol=0,
                               atol=1e-12 * np.abs(X).max())


@pytest.mark.parametrize("N", SIZES)
def test_the_exchange_stays_in_its_frame(N):
    """Each pass reads and writes every padded element of the frame once,
    and no two elements share a padded slot."""
    slots = pad(np.arange(N))
    assert len(set(slots.tolist())) == N and slots.max() < N + N // 16
    plan = fp.PASS_PLAN[N]
    TF = N // plan[0]
    t = np.arange(TF)
    for j, (L, S) in enumerate(spans(N)):
        RJ = L // S
        seen = []
        for i in range(plan[0] // RJ):
            b = t + i * TF
            base = (b // S) * L + b % S
            seen.append(base[:, None] + np.arange(RJ)[None, :] * S)
        assert sorted(np.concatenate(seen).ravel().tolist()) == \
            list(range(N)), j


# --- the kernel in float32 ---

@pytest.mark.parametrize("N,F,n_valid,window", [
    (64, 40, 40, None), (128, 24, 24, "hann"), (256, 24, 13, None),
    (512, 16, 16, "blackman"), (1024, 8, 8, None), (2048, 8, 5, "hann"),
    (4096, 4, 4, None), (8192, 3, 3, "hann"), (16384, 2, 2, None),
    (16384, 4, 3, "blackman")])
def test_transcription_matches_golden(N, F, n_valid, window):
    raw = frames(F, N, 5 * N + n_valid)
    w = None if window is None else make_window(window, N)
    chunk = int(np.gcd(8, F))
    got = regs_transcription(raw, n_valid, chunk, w)
    gold, _ = golden_accumulate(raw[:n_valid].ravel(), N, n_valid, window=w)
    np.testing.assert_allclose(got, unshift(gold), rtol=1e-5)
    want = fp.fused_psd(torch.from_numpy(raw), n_valid, chunk,
                        None if w is None else torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5)


@pytest.mark.parametrize("N,F,n_valid,windowed", [
    (256, 64, 64, False), (1024, 32, 32, False), (2048, 16, 16, False),
    (256, 32, 20, True), (1024, 16, 9, True), (2048, 16, 9, True)])
def test_transcription_matches_the_jax_kernel(N, F, n_valid, windowed):
    """The JAX kernel takes N from 256 (fused_psd.py:371)."""
    raw = frames(F, N, 7 * N + n_valid)
    w = make_window("hann", N) if windowed else None
    jax_fn = make_fused_psd_fn(N, F, windowed=windowed, interpret=True)
    args = (raw.view(np.uint16), n_valid) + ((w,) if windowed else ())
    want = np.asarray(jax_fn(*args), np.float64)
    got = regs_transcription(raw, n_valid, 16, w)
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_lanes_split_a_block_and_add_in_order():
    """At N = 256 a block is 16 lanes of 16 threads; at F = 4096 a block
    sums 16 frames, one a lane, and the masked count leaves the last
    block's later lanes without a frame."""
    N, F, n_valid = 256, 4096, 4090
    assert max(MIN_THREADS, N // 16) // (N // 16) == 16
    assert fp.k1_group(F, 64, h100_resident(N)) == 16
    raw = frames(F, N, 3)
    got = regs_transcription(raw, n_valid, 64)
    gold, _ = golden_accumulate(raw[:n_valid].ravel(), N, n_valid)
    np.testing.assert_allclose(got, unshift(gold), rtol=1e-5)


# --- the grid rule ---

@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("F,chunk", [(8, 8), (400, 16), (1024, 64),
                                     (4096, 64), (3200, 64), (65536, 64)])
def test_k1_group_fits_one_wave(N, F, chunk):
    for windowed in (False, True):
        resident = h100_resident(N, windowed)
        group = fp.k1_group(F, chunk, resident)
        assert 1 <= group <= chunk and chunk % group == 0
        assert -(-F // group) <= resident or group == chunk
        # the least such group: no smaller divisor of chunk fits
        assert all(-(-F // g) > resident for g in range(1, group)
                   if chunk % g == 0)


@pytest.mark.parametrize("F,chunk,resident,group", [
    (4000, 100, 264, 20),    # needs 16 frames a block: 20 divides 100
    (400, 100, 10, 50),
    (400, 100, 3, 100),      # nothing fits: chunk itself
    (4096, 96, 396, 12),     # 11 would fit; 12 is the least divisor
    (72, 12, 10, 12),        # K4, S = 3 streams of F = 24
    (72, 12, 20, 4)])
def test_k1_group_divides_a_chunk_that_is_not_a_power_of_two(F, chunk,
                                                            resident, group):
    """The group is the least divisor of chunk that fits, never above it:
    a chunk of 100 gives 20, not the 32 a power of two would."""
    assert fp.k1_group(F, chunk, resident) == group
    assert group <= chunk and chunk % group == 0


@pytest.mark.parametrize("S,N,fps", [(16, 2048, 256), (4, 8192, 64),
                                     (3, 256, 64), (4, 256, 2048),
                                     (2, 64, 8192)])
def test_k1_group_divides_each_streams_frames(S, N, fps):
    F, chunk = adapt_batch(fps)
    for windowed in (False, True):
        group = fp.k1_group(S * F, chunk, h100_resident(N, windowed))
        assert F % group == 0 and group <= chunk


@pytest.mark.parametrize("N,F,rows", [(2048, 4096, 256), (8192, 1024, None),
                                      (2048, 400, None), (8192, 104, None)])
def test_rows_at_the_timed_shapes(N, F, rows):
    """A quarter of the radix-2 grid's 1024 partial rows, or fewer, at
    N = 2048, F = 4096; one wave at the others."""
    F, chunk = adapt_batch(F)
    windowed = N == 8192
    resident = h100_resident(N, windowed)
    G = -(-F // fp.k1_group(F, chunk, resident))
    assert G <= resident
    if rows is not None:
        assert G <= rows < F // fp.frames_per_block(F, chunk)


def test_radix2_grid_is_unchanged():
    """K3's and the probes' grid rule stays as it was."""
    assert fp.frames_per_block(4096, 64) == 4
    assert fp.frames_per_block(65536, 64) == 64


@pytest.mark.parametrize("N,F,windowed,out_rows", [
    (2048, 4096, False, 1), (8192, 1024, True, 1), (256, 3200, False, 1),
    (2048, 4096, False, 16)])
def test_k1_work_is_the_functions_least(N, F, windowed, out_rows):
    """The bound's work: the frames (and window) read once and the output
    written once, no twiddle table; the split-radix transform, 4 N log2 N
    - 6 N + 8 FP32 flops a frame, and 4N (6N windowed) for the rest."""
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    log2n = N.bit_length() - 1
    nbytes, mma, fp32 = fpp.k1_work(F, N, windowed=windowed,
                                    out_rows=out_rows)
    assert nbytes == F * 2 * N + 4 * N * (out_rows + windowed)
    assert mma == 0
    assert fp32 == F * (4 * N * log2n - 6 * N + 8 + (6 if windowed else 4)
                        * N)
    if (N, F, windowed, out_rows) == (2048, 4096, False, 1):
        # the FP32 work sets the bound: ~5.26 us at 67 TFLOP/s, above the
        # ~5.01 us of 16.8 MB at 3.35 TB/s
        assert 5.2 < fp32 / 67e12 * 1e6 < 5.3
        assert 5.0 < nbytes / 3.35e12 * 1e6 < fp32 / 67e12 * 1e6


# --- shared-memory banks ---

def wavefronts(word_addrs):
    """Wavefronts of one warp's access to 32-bit words (32 banks): the
    most distinct words any bank serves."""
    banks = {}
    for a in word_addrs:
        banks.setdefault(a % 32, set()).add(a)
    return max(len(v) for v in banks.values())


def exchange_accesses(N):
    """Every warp instruction of the exchange, as the float2 elements its
    32 threads touch (the kernel's lanes of one block side by side)."""
    plan = fp.PASS_PLAN[N]
    R, TF = plan[0], N // plan[0]
    threads = max(MIN_THREADS, TF)
    xstride = N + N // 16
    for L, S in spans(N):
        RJ = L // S
        for i in range(R // RJ):
            for n1 in range(RJ):
                for w0 in range(0, threads, 32):
                    tid = np.arange(w0, w0 + 32)
                    lane, t = tid // TF, tid % TF
                    b = t + i * TF
                    e = (b // S) * L + n1 * S + b % S
                    yield lane * xstride + pad(e)


@pytest.mark.parametrize("N", [n for n in SIZES if n >= 256])
def test_exchange_is_free_of_bank_conflicts(N):
    """A warp's 64-bit access takes 2 wavefronts at best (256 bytes); the
    padding keeps every pass's reads and writes there from N = 256 on."""
    for elems in exchange_accesses(N):
        words = np.concatenate([2 * elems, 2 * elems + 1])
        assert wavefronts(words) == 2
        for half in (elems[:16], elems[16:]):
            assert wavefronts(np.concatenate([2 * half, 2 * half + 1])) == 1


@pytest.mark.parametrize("N", SIZES)
def test_ring_reads_are_free_of_bank_conflicts(N):
    """Thread t of lane p reads the u16 at sample t + k*TF of its slot:
    a warp's 32 reads fall in distinct banks or share words."""
    plan = fp.PASS_PLAN[N]
    R, TF = plan[0], N // plan[0]
    threads = max(MIN_THREADS, TF)
    ring_lane = 4 * N + 32
    for k in range(R):
        for w0 in range(0, threads, 32):
            tid = np.arange(w0, w0 + 32)
            lane, t = tid // TF, tid % TF
            byte = lane * ring_lane + 2 * (t + k * TF)
            assert wavefronts(np.unique(byte // 4)) == 1


# --- the probe cuts and the radix-2 control ---

def test_probe_cuts_of_the_register_kernel(monkeypatch):
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    monkeypatch.setattr(fpp, "resident_blocks",
                        lambda N, windowed, index: h100_resident(N, windowed))
    src = (CSRC / "fused_psd_probe.cu").read_text()
    cuts = {"k1r_full": ("full", "K1"), "k1r_dqonly": ("dequant", "plain"),
            "k1r_nofft": ("nofft", "plain")}
    for name, (cut, parity) in cuts.items():
        v = fpp.VARIANTS[name]
        assert v.kernel == "k1r" and v.k1_cut == cut and v.parity == parity
        assert f" = {v.code}," in src
        assert fpp.PROBES["P1"].variants[name] == name
        # on K1's own grid on the card, not the radix-2 kernel's; on the
        # CPU, whose plain version has no grid, the chunk
        card = torch.device("cuda", 0)
        assert fpp.block_frames(name, 4096, 64, None, card) == 16 == \
            fp.k1_group(4096, 64, h100_resident(fpp.N))
        assert fpp.block_frames(name, 4096, 64) == 64
        # the radix-2 cut's work: one count of the function for both
        assert v.work(4096) == fpp.VARIANTS["k1_" + name[4:]].work(4096)
    # the radix-2 control is no longer K1 bit for bit
    assert fpp.VARIANTS["k1_full"].parity == "plain"
    assert set(fpp.PROBES["P1"].default) == {
        "full", "s2x1", "s1x1", "nomm", "notw", "dg3d", "k1_full",
        "k1_nofft", "k1_dqonly"}


@pytest.mark.parametrize("name", ["k1r_full", "k1r_dqonly", "k1r_nofft"])
def test_probe_cuts_plain_on_the_cpu(name):
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    raw = torch.from_numpy(frames(16, fpp.N, 31))
    fpp.COUNTS.reset()
    got = fpp.fused_psd_probe(name, raw, 11, 16)
    twin = fpp.fused_psd_probe_reference("k1_" + name[4:], raw, 11, 16)
    assert torch.equal(got, twin)
    assert fpp.COUNTS.plain[name] == 1 and not fpp.COUNTS.kernel


@pytest.mark.parametrize("N,window", [(256, None), (2048, "hann"),
                                      (8192, None), (16384, "blackman")])
def test_radix2_control_on_the_cpu(N, window):
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    assert N in fpp.RADIX2_N
    raw = torch.from_numpy(frames(8, N, N))
    w = None if window is None else torch.from_numpy(make_window(window, N))
    fpp.COUNTS.reset()
    got = fpp.radix2_psd(raw, 6, 8, w)
    assert torch.equal(got, fp.fused_psd_reference(raw, 6, 8, w))
    assert fpp.COUNTS.plain["radix2"] == 1 and not fpp.COUNTS.kernel


def test_radix2_control_takes_only_its_sizes():
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    with pytest.raises(ValueError):
        fpp.radix2_psd(torch.zeros((8, 2 * 1024), dtype=torch.uint8), 8, 8)
    src = (CSRC / "fused_psd_probe.cu").read_text()
    body = src[src.index("int rpf_radix2_psd"):]
    body = body[:body.index("#undef RPF_CASE")]
    assert sorted(1 << int(n) for n in re.findall(r"RPF_CASE\((\d+)\)",
                                                  body)) \
        == list(fpp.RADIX2_N)


@pytest.mark.cuda
def test_register_kernel_on_card():
    """Runs only where a CUDA device is present (chip_smoke.py covers it
    in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    raw = torch.from_numpy(frames(256, 2048, 13)).cuda()
    w = torch.from_numpy(make_window("hann", 2048)).cuda()
    for window in (None, w):
        got = fp.fused_psd(raw, 200, 64, window)
        want = fp.fused_psd_reference(raw, 200, 64, window)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5)
    assert torch.equal(fpp.fused_psd_probe("k1r_full", raw, 200, 64),
                       fp.fused_psd(raw, 200, 64))
