"""The PyTorch package's relaxed-precision step (K3) against the JAX
package's fast Pallas kernel.

The split constants must equal the JAX package's ``_constants`` bit for
bit. The plain PyTorch version runs the same scheme on the same terms as
``make_fused_psd_fn(fast=True, interpret=True)`` at the port's split, so
the two differ only in the order of f32 sums: rtol 5e-6 (measured
<= 1.5e-6). Both are held to the float64 golden at 1e-4, the fast
kernel's tier in tests/test_kernels.py:144. The CUDA kernel's tile and
fragment index arithmetic is pinned by a numpy transcription that
emulates ``mma.sync.m16n8k16`` lane by lane; the kernel itself runs only
on a card (chip_smoke.py, and the test marked ``cuda``).
"""

import importlib.util
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu.auxdata import make_window
from rtl_power_fftw_tpu.ops.kernels import fused_psd as jax_fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_fast as ff
from rtl_power_fftw_tpu_torch.ops.kernels.fused_psd import (check_alignment,
                                                            frames_per_block)

from golden import golden_accumulate

PLAIN_VS_JAX_RTOL = 5e-6
RELAXED_RTOL = 1e-4


def frames(F, N, seed):
    return np.random.default_rng(seed).integers(0, 256, (F, 2 * N),
                                                dtype=np.uint8)


def unshift(x):
    return np.fft.ifftshift(np.asarray(x))


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("N", [256, 512, 1024, 2048, 4096, 8192, 16384])
def test_constants_equal_jax_bit_for_bit(N, windowed):
    N1, N2 = ff.fast_split(N)
    theirs = jax_fp._constants(N, N1, N2, windowed)
    ours = ff.constants(N, N1, N2, windowed)
    assert len(ours) == len(theirs) == 7
    for a, b in zip(theirs, ours):
        a = np.asarray(a)
        if a.dtype == np.float32:
            np.testing.assert_array_equal(a, b)
        else:
            assert b.dtype == np.uint16 and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint16), b)


def test_bf16_bits_round_as_ml_dtypes():
    """ml_dtypes rounds float64 -> float32 -> bfloat16: just above a bf16
    tie (1 + 2^-8 + 2^-40) the float32 step lands on the tie and the
    bf16 step rounds it down to even, where one rounding would go up."""
    rng = np.random.default_rng(4)
    ties = ((rng.integers(128, 256, 5000) * 2 + 1) / 256.0
            * 2.0 ** rng.integers(-20, 3, 5000))
    x = np.concatenate([
        rng.standard_normal(20000) * 10.0 ** rng.integers(-30, 3, 20000),
        ties, ties * (1 + 2.0 ** -40), ties * (1 - 2.0 ** -40),
        [0.0, -0.0, 1.0, -1.0, 1.0 + 2.0 ** -8 + 2.0 ** -40]])
    np.testing.assert_array_equal(ff.bf16_bits(x),
                                  x.astype(ml_dtypes.bfloat16).view(np.uint16))
    assert ff.bf16_bits(np.array([1.0 + 2.0 ** -8 + 2.0 ** -40]))[0] == 0x3F80
    np.testing.assert_array_equal(
        ff.bf16_value(ff.bf16_bits(x)),
        x.astype(ml_dtypes.bfloat16).astype(np.float32))


@pytest.mark.parametrize("N,split", [(256, (16, 16)), (512, (16, 32)),
                                     (1024, (32, 32)), (2048, (32, 64)),
                                     (4096, (64, 64)), (8192, (64, 128)),
                                     (16384, (128, 128))])
def test_fast_split(N, split):
    assert ff.fast_split(N) == split
    assert all(n % 16 == 0 for n in split)


@pytest.mark.parametrize("N,ok", [(256, True), (2048, True), (16384, True),
                                  (128, False), (32768, False), (768, False)])
def test_eligibility(N, ok):
    assert ff.fused_psd_fast_eligible(N) is ok


@pytest.mark.parametrize("N,F,n_valid,window", [
    (256, 64, 64, None), (512, 64, 50, "hann"), (1024, 32, 32, "blackman"),
    (2048, 64, 40, None)])
def test_plain_matches_jax_fast_kernel_and_golden(N, F, n_valid, window):
    raw = frames(F, N, N + n_valid)
    w = None if window is None else make_window(window, N)
    N1, _ = ff.fast_split(N)
    fn = jax_fp.make_fused_psd_fn(N, F, windowed=w is not None, fast=True,
                                  n1=N1, interpret=True)
    args = (raw.view(np.uint16), n_valid) + (() if w is None else (w,))
    want_jax = np.asarray(fn(*args), np.float64)
    got = ff.fused_psd_fast(torch.from_numpy(raw), n_valid, 8,
                            None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (N,)
    got = got.numpy()
    gold, _ = golden_accumulate(raw[:n_valid].ravel(), N, n_valid, window=w)
    np.testing.assert_allclose(got, want_jax, rtol=PLAIN_VS_JAX_RTOL)
    np.testing.assert_allclose(got, unshift(gold), rtol=RELAXED_RTOL)


def load_chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP_SMOKE = load_chip_smoke()


@pytest.mark.parametrize("N", [256, 512, 1024, 2048, 4096, 8192, 16384])
def test_chip_smoke_split_is_the_jax_kernels(N):
    assert CHIP_SMOKE.jax_fast_n1(N) == jax_fp._split(N)[0]


@pytest.mark.parametrize("window", [None, "hann"])
@pytest.mark.parametrize("N", [256, 1024, 2048])
def test_plain_at_jax_split_matches_jax_fast_kernel_under_tone(N, window):
    """chip_smoke.py bounds K3's 35 dB tone error by the JAX fast scheme's
    own error, computed by the plain version at the JAX kernel's split:
    at that split it must be the JAX kernel, on the same tone input.

    Under a tone the two differ by their f32 sum order, an absolute error
    of a few ulps of the tone's bin (measured <= 1.2e-7 of the peak), so
    the per-bin bound is 5e-7 of the peak; and the yardstick itself, the
    max relative error against the float64 golden, agrees within 10%
    (measured <= 4.8%)."""
    F = 16
    raw = CHIP_SMOKE.tone_frames(N, F, 900 + N)
    w = None if window is None else make_window(window, N)
    fn = jax_fp.make_fused_psd_fn(N, F, windowed=w is not None, fast=True,
                                  interpret=True)
    args = (raw.view(np.uint16), F) + (() if w is None else (w,))
    want = np.asarray(fn(*args), np.float64)
    got = ff.fused_psd_fast_reference(
        torch.from_numpy(raw), F, 8,
        None if w is None else torch.from_numpy(w),
        n1=jax_fp._split(N)[0]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7 * want.max())
    gold = unshift(golden_accumulate(raw.ravel(), N, F, window=w)[0])
    ours = CHIP_SMOKE.max_rel(got, gold)
    theirs = CHIP_SMOKE.max_rel(want, gold)
    assert abs(ours - theirs) <= 0.1 * theirs


# --- numpy transcription of csrc/fused_psd_fast.cu ---

G_, T_ = np.arange(32) >> 2, np.arange(32) & 3     # per lane: g, t


def bf16r(x):
    """f32 -> bf16 (nearest even) -> f32, by the package's bit rounding."""
    return ff.bf16_value(ff.bf16_bits(np.asarray(x, np.float32)
                                      .astype(np.float64)))


def a_position(q, h):
    """(row, col) of A-register q, half h, for every lane."""
    return G_ + 8 * (q & 1), 2 * T_ + h + 8 * (q >> 1)


def mma(d, a, b):
    """Emulates mma.m16n8k16 (bf16 in, f32 sums) from per-lane registers:
    a (32, 4, 2) and b (32, 2, 2) bf16 values as f32, d (32, 4) f32."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for q in range(4):
        for h in range(2):
            A[a_position(q, h)] = a[:, q, h]
    for r in range(2):
        for h in range(2):
            B[2 * T_ + h + 8 * r, G_] = b[:, r, h]
    D = A @ B
    for e in range(4):
        d[:, e] = (d[:, e] + D[G_ + 8 * (e >> 1), 2 * T_ + (e & 1)]
                   ).astype(np.float32)


def split(x, k):
    terms, r = [], np.asarray(x, np.float32)
    for _ in range(k):
        terms.append(bf16r(r))
        r = (r - terms[-1]).astype(np.float32)
    return terms


def kernel_transcription(raw, n_valid, chunk, window):
    """The kernel's per-block loops, items and fragment index arithmetic."""
    F, N = raw.shape[0], raw.shape[1] // 2
    N1, N2 = ff.fast_split(N)
    items = N // 256
    warps = min(8, items)
    windowed = window is not None
    planes_of = ff.input_planes(windowed)
    w1r, w1i, tw, w2 = (ff.bf16_value(c) if c.dtype == np.uint16 else c
                        for c in ff.kernel_constants(N, windowed))
    group = frames_per_block(F, chunk)
    out = np.zeros(N, np.float64)
    for blk in range(-(-F // group)):
        acc = {}
        for f in range(blk * group, min(blk * group + group, F, n_valid)):
            iq = raw[f].view(np.uint16).astype(np.int64)
            z = np.zeros((N2 * N1, 2), np.float32)
            for item in range(items):                      # stage 1
                mt, ng = divmod(item, N1 // 16)
                yr = np.zeros((2, 32, 4), np.float32)
                yi = np.zeros((2, 32, 4), np.float32)
                for c in range(N1 // 16):
                    a = np.zeros((6, 32, 4, 2), np.float32)
                    for q in range(4):
                        n = (N2 * (16 * c + 2 * T_ + 8 * (q >> 1))
                             + 16 * mt + G_ + 8 * (q & 1))
                        for h, m in enumerate((n, n + N2)):
                            re = ((iq[m] & 0xFF) - 127).astype(np.float32)
                            im = ((iq[m] >> 8) - 127).astype(np.float32)
                            if not windowed:
                                a[0, :, q, h], a[1, :, q, h] = re, im
                                continue
                            sr = split(re * window[m], 3)
                            si = split(im * window[m], 3)
                            for p in range(3):
                                a[2 * p, :, q, h] = sr[p]
                                a[2 * p + 1, :, q, h] = si[p]
                    for b, plane in enumerate(planes_of):
                        for j in range(2):
                            kc, nt = b * (N1 // 16) + c, 2 * ng + j
                            mma(yr[j], a[plane], w1r[kc, nt].reshape(32, 2, 2))
                            mma(yi[j], a[plane], w1i[kc, nt].reshape(32, 2, 2))
                for j in range(2):
                    for h in range(2):
                        n2 = 16 * mt + G_ + 8 * h
                        for e in range(2):
                            k1 = 16 * ng + 8 * j + 2 * T_ + e
                            ar, ai = yr[j][:, 2 * h + e], yi[j][:, 2 * h + e]
                            c_, s_ = tw[n2, k1, 0], tw[n2, k1, 1]
                            z[n2 * N1 + k1, 0] = ar * c_ - ai * s_
                            z[n2 * N1 + k1, 1] = ar * s_ + ai * c_
            for warp in range(warps):                      # stage 2
                for i in range(items // warps):
                    mt, ng = divmod(warp + i * warps, N2 // 16)
                    u = np.zeros((3, 2, 32, 4), np.float32)
                    for c in range(N2 // 16):
                        a = np.zeros((6, 32, 4, 2), np.float32)
                        for q in range(4):
                            k1 = 16 * mt + G_ + 8 * (q & 1)
                            for h in range(2):
                                n2 = 16 * c + 2 * T_ + 8 * (q >> 1) + h
                                zr, zi = z[n2 * N1 + k1].T
                                for s, v in enumerate((zr, zi, zr + zi)):
                                    v0, v1 = split(v, 2)
                                    a[2 * s, :, q, h] = v0
                                    a[2 * s + 1, :, q, h] = v1
                        for j in range(2):
                            bm = w2[:, c, 2 * ng + j].reshape(6, 32, 2, 2)
                            for s in range(3):
                                mma(u[s, j], a[2 * s], bm[2 * s])
                                mma(u[s, j], a[2 * s], bm[2 * s + 1])
                                mma(u[s, j], a[2 * s + 1], bm[2 * s])
                    xr = u[0] - u[1]
                    xi = u[2] - u[0] - u[1]
                    key = (warp, i)
                    acc[key] = acc.get(key, 0) + (xr * xr + xi * xi)
        row = np.zeros(N, np.float32)
        for (warp, i), v in acc.items():
            mt, ng = divmod(warp + i * warps, N2 // 16)
            for j in range(2):
                for e in range(4):
                    k1 = 16 * mt + G_ + 8 * (e >> 1)
                    k2 = 16 * ng + 8 * j + 2 * T_ + (e & 1)
                    row[k1 + N1 * k2] = v[j][:, e]
        out += row
    return out


def test_mma_fragment_layout_is_a_bijection():
    hits = np.zeros((16, 16), int)
    for q in range(4):
        for h in range(2):
            np.add.at(hits, a_position(q, h), 1)
    assert (hits == 1).all()
    packed = ff.pack_b_fragments(np.arange(32 * 16, dtype=np.uint16)
                                 .reshape(32, 16))
    assert packed.shape == (2, 2, 32, 4)
    assert sorted(packed.ravel()) == list(range(32 * 16))
    # Lane 5 (g = 1, t = 1) of tile (kc=1, nt=1): rows 16+(2,3,10,11), col 9.
    assert list(packed[1, 1, 5]) == [18 * 16 + 9, 19 * 16 + 9, 26 * 16 + 9,
                                     27 * 16 + 9]


@pytest.mark.parametrize("N,F,n_valid,window", [
    (256, 8, 8, None), (256, 16, 11, "hann"), (512, 8, 6, None),
    (512, 8, 8, "blackman")])
def test_kernel_transcription_matches_plain(N, F, n_valid, window):
    raw = frames(F, N, 7 * N + n_valid)
    w = None if window is None else make_window(window, N)
    got = kernel_transcription(raw, n_valid, 8, w)
    want = ff.fused_psd_fast_reference(
        torch.from_numpy(raw), n_valid, 8,
        None if w is None else torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=PLAIN_VS_JAX_RTOL)
    gold, _ = golden_accumulate(raw[:n_valid].ravel(), N, n_valid, window=w)
    np.testing.assert_allclose(got, unshift(gold), rtol=RELAXED_RTOL)


@pytest.mark.parametrize("make,window,exc", [
    (lambda: torch.zeros((8, 512), dtype=torch.int16), None, TypeError),
    (lambda: torch.zeros((8, 256), dtype=torch.uint8), None, ValueError),
    (lambda: torch.zeros((8, 1536), dtype=torch.uint8), None, ValueError),
    (lambda: torch.zeros((8, 512), dtype=torch.uint8),
     torch.ones(128), ValueError),
    (lambda: torch.zeros((8, 512), dtype=torch.uint8),
     torch.ones(256, dtype=torch.float64), ValueError),
    (lambda: torch.zeros((8, 512), dtype=torch.uint8, device="meta"), None,
     ValueError),
])
def test_rejects_what_the_kernel_does_not_take(make, window, exc):
    with pytest.raises(exc):
        ff.fused_psd_fast(make(), 8, 8, window)


@pytest.mark.parametrize("raw_offset,ok", [(0, True), (16, True), (4, False),
                                           (8, False)])
def test_alignment_check_matches_the_kernels_loads(raw_offset, ok):
    """K3 copies frames in 16-byte words and reads the window as floats."""
    raw = torch.zeros(8 * 512 + 16, dtype=torch.uint8)
    raw = raw[raw_offset:raw_offset + 8 * 512].view(8, 512)
    window = torch.ones(257)[1:]
    if ok:
        check_alignment("fused_psd_fast", raw, 16, window, 4)
    else:
        with pytest.raises(ValueError, match="aligned"):
            check_alignment("fused_psd_fast", raw, 16, window, 4)


def test_cpu_calls_count_as_plain():
    ff.COUNTS.reset()
    ff.fused_psd_fast(torch.zeros((8, 512), dtype=torch.uint8), 8, 8)
    assert (ff.COUNTS.kernel, ff.COUNTS.plain) == (0, 1)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    N, F = 2048, 64
    raw = torch.from_numpy(frames(F, N, 12)).cuda()
    w = torch.from_numpy(make_window("hann", N)).cuda()
    for window in (None, w):
        before = ff.COUNTS.kernel
        got = ff.fused_psd_fast(raw, 50, 64, window)
        want = ff.fused_psd_fast_reference(raw, 50, 64, window)
        torch.cuda.synchronize()
        assert ff.COUNTS.kernel == before + 1
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5)
