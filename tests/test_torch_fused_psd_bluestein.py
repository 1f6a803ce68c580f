"""The chirp-Z (Bluestein) fused PSD kernel (the chirp-Z instantiation of
csrc/fused_psd_mixed.cuh in csrc/fused_psd_mixed.cu, with
csrc/fft_mixed.cuh): its tables against
the JAX package's bit for bit, its plain version against the JAX
``bluestein_psd_partial`` (rtol 2e-5: two float32 budgets), and the
kernel transcribed in numpy (forward passes, the turn, the transposed
passes) in float64 against numpy.fft (rtol 1e-9) and in float32 against
the float64 golden (rtol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu.ops.dft import _bluestein_constants
from rtl_power_fftw_tpu.ops.dft import bluestein_psd_partial
from rtl_power_fftw_tpu_torch.auxdata import make_window
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_bluestein as fb
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed as fm
from rtl_power_fftw_tpu_torch.ops.spectral import adapt_batch

from test_torch_fused_psd_mixed import (dequantize, dif, dit, frames,
                                        kernel_transcription, twiddle_table)

CROSS_RTOL = 2e-5


def chirp_power(raw, window=None, dtype=np.complex64):
    """|DFT|^2 of each frame as the chirp-Z kernel computes it: x times the
    window (in float32), then times a (the kernel's chirp table),
    zero-padded to M, the forward passes, times
    B / M in element order and conjugated, the transposed passes, |.|^2 of
    the first N. In float64 the tables are exact."""
    N = raw.shape[1] // 2
    plan = fb.bluestein_plan(N)
    M = int(np.prod(plan))
    if dtype == np.complex128:
        n = np.arange(N)
        a = np.exp(-1j * np.pi * (n * n % (2 * N)) / N)
        v = np.zeros(M, complex)
        v[:N] = np.conj(np.exp(-1j * np.pi * (n * n % (2 * N)) / N))
        v[M - N + 1:] = v[1:N][::-1]
        B = np.fft.fft(v) / M
        order = np.empty(M, np.int64)
        order[fm.element_of_bin(plan, np.arange(M))] = np.arange(M)
        spectrum = B[order]
    else:
        c = fb.chirp_table(N)
        a = (c[:, 0] + 1j * c[:, 1]).astype(dtype)
        s = fb.spectrum_table(N)
        spectrum = (s[:, 0] + 1j * s[:, 1]).astype(dtype)
    u = np.zeros((raw.shape[0], M), dtype)
    u[:, :N] = dequantize(raw, window, dtype) * a
    tw = twiddle_table(plan, dtype)
    y = dit(np.conj(dif(u, plan, tw) * spectrum), plan, tw)[:, :N]
    return y.real * y.real + y.imag * y.imag


@pytest.mark.parametrize("N", [2, 4, 10, 500, 998, 1000, 4098, 8182])
def test_tables_are_the_jax_tables_bit_for_bit(N):
    M, M1, M2, a, Bp, _ = _bluestein_constants(N)
    M_, a_, B_ = fb.bluestein_constants(N)
    assert M_ == M == fb.next_pow2(2 * N - 1)
    assert a_.dtype == B_.dtype == np.complex64
    np.testing.assert_array_equal(a_, a)
    np.testing.assert_array_equal(B_, Bp.T.reshape(M))


def test_plan_of_every_even_n():
    """M's plan multiplies to M >= 2N - 1 in at least two passes (the turn
    is the last pass's butterfly), within the kernel's limits."""
    for N in range(2, fb.MAX_N + 1, 2):
        plan = fb.bluestein_plan(N)
        M = int(np.prod(plan))
        assert M == fb.next_pow2(2 * N - 1) and len(plan) >= 2, N
        shape = fb.bluestein_launch(N)
        assert shape.n == M and shape.bins == N
        assert shape.threads <= fm.MAX_THREADS and shape.smem <= fm.MAX_SMEM
    assert fb.next_pow2(2 * fb.MAX_N - 1) == 16384


@pytest.mark.parametrize("N,ok", [(2, True), (998, True), (8182, True),
                                  (8192, True), (7, False), (8194, False),
                                  (16382, False)])
def test_eligible(N, ok):
    assert fb.fused_psd_bluestein_eligible(N) is ok


@pytest.mark.parametrize("N", [10, 998])
def test_spectrum_table_is_b_over_m_in_element_order(N):
    M, _, B = fb.bluestein_constants(N)
    s = fb.spectrum_table(N)
    q = fm.element_of_bin(fb.bluestein_plan(N), np.arange(M))
    np.testing.assert_array_equal(s[q, 0], (B / np.float32(M)).real)
    np.testing.assert_array_equal(s[q, 1], (B / np.float32(M)).imag)


@pytest.mark.parametrize("N", [2, 998, 8182])
def test_chirp_table_is_the_chirp(N):
    """The kernel's chirp is the JAX package's a, split into (re, im)."""
    a = _bluestein_constants(N)[3]
    c = fb.chirp_table(N)
    assert c.shape == (N, 2) and c.dtype == np.float32
    np.testing.assert_array_equal(c[:, 0], a.real)
    np.testing.assert_array_equal(c[:, 1], a.imag)


@pytest.mark.parametrize("N", [10, 500, 998])
@pytest.mark.parametrize("window", [None, "hann"])
def test_plain_version_matches_jax_bluestein(N, window):
    """bluestein_psd_reference against the JAX package's
    bluestein_psd_partial on the same frames, masked, within 2e-5."""
    F, chunk = adapt_batch(48)
    n_valid = F - 7
    raw = frames(F, N, 11 * N)
    w = None if window is None else make_window(window, N)
    got = fb.bluestein_psd_reference(torch.from_numpy(raw), n_valid, chunk,
                                     None if w is None
                                     else torch.from_numpy(w))
    re = raw[:, 0::2].astype(np.float32) - 127
    im = raw[:, 1::2].astype(np.float32) - 127
    if w is not None:
        re, im = re * w, im * w
    fmask = (np.arange(F) < n_valid).astype(np.float32)
    want = np.asarray(bluestein_psd_partial(jnp.asarray(re), jnp.asarray(im),
                                            jnp.asarray(fmask), chunk=chunk))
    np.testing.assert_allclose(got.numpy(), want, rtol=CROSS_RTOL)


@pytest.mark.parametrize("N", [2, 4, 6, 10, 22, 500, 998])
def test_transcription_float64_is_the_dft(N):
    raw = frames(3, N, N + 1)
    got = chirp_power(raw, dtype=np.complex128)
    X = np.fft.fft(dequantize(raw, None, np.complex128), axis=1)
    np.testing.assert_allclose(got, (X * X.conj()).real, rtol=1e-9,
                               atol=1e-9 * got.max())


@pytest.mark.parametrize("N", [10, 22, 500, 998, 2002])
@pytest.mark.parametrize("window", [None, "hann"])
def test_transcription_float32_against_golden(N, window):
    """The kernel in float32 over a step with masked frames, against the
    float64 golden within 1e-5."""
    F, chunk = adapt_batch(40 if N < 2000 else 16)
    n_valid = F - 3
    raw = frames(F, N, 5 * N)
    w = None if window is None else make_window(window, N)
    got = kernel_transcription(raw, n_valid, chunk, w, power=chirp_power,
                               shape=fb.bluestein_launch(N))
    z = dequantize(raw[:n_valid], None, np.complex128)
    if w is not None:
        z = z * w
    X = np.fft.fft(z, axis=1)
    np.testing.assert_allclose(got, (X.real ** 2 + X.imag ** 2).sum(0),
                               rtol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    fp.COUNTS.reset()
    raw = torch.from_numpy(frames(16, 998, 1))
    out = fb.fused_psd_bluestein(raw, 16, 16)
    streams = fb.fused_psd_bluestein_streams(
        raw.reshape(2, 8, 1996), torch.tensor([8, 0], dtype=torch.int32), 8)
    assert out.shape == (998,) and streams.shape == (2, 998)
    assert fp.COUNTS.plain == 2 and fp.COUNTS.kernel_bluestein == 0
    assert not streams[1].any()
    want = fb.bluestein_psd_reference(raw[:8], 8, 8)
    np.testing.assert_allclose(streams[0].numpy(), want.numpy(), rtol=1e-6)


def test_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="does not take N=8194"):
        fb.fused_psd_bluestein(torch.zeros((8, 16388), dtype=torch.uint8),
                               8, 8)
    with pytest.raises(ValueError, match="window must be"):
        fb.fused_psd_bluestein(torch.zeros((8, 20), dtype=torch.uint8), 8, 8,
                               torch.ones(9))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Runs only where a CUDA device is present (chip_smoke.py covers it
    in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    raw = torch.from_numpy(frames(256, 998, 2)).cuda()
    got = fb.fused_psd_bluestein(raw, 200, 64)
    want = fb.bluestein_psd_reference(raw, 200, 64)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5)
