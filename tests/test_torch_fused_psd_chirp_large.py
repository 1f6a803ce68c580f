"""The large chirp-Z step ("BL": ``fused_psd_chirp_large``, every even N
from 8194 to 2^21 that the other kernels do not take, and any even N there
under ``--fft-backend bluestein``) against the JAX package and the float64
golden, its index arithmetic in numpy, and its sessions against the JAX
package's.

On the CPU the wrapper runs the kernel's plain PyTorch version (its three
passes in torch ops with the kernel's tables); the JAX side runs its CPU
ladder (XLA's FFT at these N, or its chirp-Z rung under ``--fft-backend
bluestein``). Tolerances as tests/test_torch_fused_psd_mixed_large.py's.
The CUDA kernel's pass A zero rule, its B table in natural (k1, k2) order
read by the row transform's digit-reversed element, and pass C's m < N
selection are pinned by a numpy transcription of its three passes in
float64 against numpy.fft (rtol 1e-9) and in float32 against
tests/golden.py (rtol 1e-5); the kernel itself runs only on a card
(chip_smoke.py phase 15, and the test marked ``cuda``).
"""

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu.ops.spectral import PsdStep as JaxPsdStep
from rtl_power_fftw_tpu_torch.auxdata import make_window
from rtl_power_fftw_tpu_torch.ops import spectral
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_bluestein as fb
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_chirp_large as bl
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed as fm
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed_large as ml
from rtl_power_fftw_tpu_torch.ops.kernels.fused_psd_large import large_group

from test_torch_fused_psd_mixed import dequantize, dif, psd_sum, twiddle_table
from test_torch_fused_psd_mixed_large import (CROSS_RTOL, GOLDEN_RTOL,
                                              RESIDENT, frames, golden,
                                              partial_bins,
                                              session_matches_jax_session)

CPU = torch.device("cpu")


def plain(raw, n_valid, chunk, window=None):
    w = None if window is None else torch.from_numpy(window)
    return bl.fused_psd_chirp_large(torch.from_numpy(raw), n_valid, chunk,
                                    w).numpy()


def tables(N, dtype):
    """The chirp a, B / M at (k1, k2) and W_M^(k1 n2): the kernel's
    complex64 tables, or their float64 values."""
    M = fb.chirp_size(N)
    m1, m2 = bl.chirp_large_split(N)
    if dtype == np.complex64:
        return (fb.bluestein_constants(N, M)[1], bl.spectrum_table(N),
                ml.inter_twiddle(M, m1, m2))
    n = np.arange(N, dtype=np.int64)
    a = np.exp(-1j * np.pi * ((n * n) % (2 * N)) / N)
    v = np.zeros(M, np.complex128)
    v[:N] = np.conj(a)
    v[M - N + 1:] = np.conj(a[1:][::-1])
    B = np.fft.fft(v) / M
    inter = np.exp(-2j * np.pi * (np.arange(m1)[:, None]
                                  * np.arange(m2)[None, :] % M) / M)
    return a, B.reshape(m2, m1).T, inter


def first_zero_row(N, n2):
    """Pass A's rule for column n2 (tile_cols_kernel's ``s < bins``): rows
    n1 from ceil((N - n2) / M2) on hold samples n = n1 M2 + n2 >= N, which
    are 0 and are not read."""
    return -(-(N - np.asarray(n2)) // bl.chirp_large_split(N)[1])


def kernel_transcription(raw, n_valid, chunk, window=None,
                         dtype=np.complex64):
    """The kernel as one step runs it: pass A (columns n2 of u = x a, rows
    from first_zero_row on 0, the column transform read back by
    element_of_bin, times W_M^(n2 k1)); pass B (per row k1 the transform
    over n2, times the B table gathered by k2's element, conjugated, to
    natural k2, the transform over k2 read back by m2's element, times
    W_M^(k1 m2)); pass C (per column m2 the transform over k1, |.|^2 by
    element summed in float32 over each block's frames, bins m2 + M2 m1 <
    N by partial_bins into padded partial rows); the float64 row sum."""
    F, N = raw.shape[0], raw.shape[1] // 2
    t = bl.chirp_large_layout(N)
    m1, m2 = t.M1, t.M2
    a, spectrum, inter = tables(N, dtype)
    tw1, tw2 = twiddle_table(t.plan1, dtype), twiddle_table(t.plan2, dtype)
    order1 = fm.element_of_bin(t.plan1, np.arange(m1))
    order2 = fm.element_of_bin(t.plan2, np.arange(m2))
    x = dequantize(raw, window, dtype) * a.astype(dtype)
    zero = first_zero_row(N, np.arange(m2))
    scratch = np.zeros((F, m1, m2), dtype)
    for f in range(min(F, n_valid)):
        u = np.zeros((m2, m1), dtype)          # column n2, row n1
        for n2 in range(m2):
            rows = np.arange(zero[n2])
            u[n2, rows] = x[f, rows * m2 + n2]
        y = dif(u, t.plan1, tw1)
        scratch[f] = y[:, order1].T * inter     # [k1, n2]
        Y = dif(scratch[f], t.plan2, tw2)       # [k1, element of k2]
        Z = np.conj(Y[:, order2] * spectrum)    # [k1, k2]
        z = dif(Z, t.plan2, tw2)
        scratch[f] = z[:, order2] * inter       # [k1, m2]
    bins, elem = partial_bins(m2, m1, t.plan1, N)
    keep = bins >= 0
    real = np.float32 if dtype == np.complex64 else np.float64
    group = large_group(F, t.tiles[2], RESIDENT)
    rows = []
    for f0 in range(0, F, group):
        acc = np.zeros((m2, m1), real)
        for f in range(f0, min(f0 + group, F, n_valid)):
            Y = dif(scratch[f].T.copy(), t.plan1, tw1)
            acc += (Y.real * Y.real + Y.imag * Y.imag).astype(real)
        row = np.zeros(t.row, real)
        row[bins[keep]] = acc[:, elem][keep]
        rows.append(row)
    if dtype != np.complex64:
        return np.stack(rows).sum(0)[:N]
    return psd_sum(np.stack(rows))[:N]


@pytest.mark.parametrize("N,ok", [
    (8192, False), (8194, True), (16382, True), (16384, True),
    (20000, True), (99998, True), (1 << 21, True), ((1 << 21) + 2, False),
    (4194302, False), (9001, False)])
def test_eligibility(N, ok):
    """Every even N in (8192, 2^21]; the route sends it only those the
    power-of-two and mixed-radix kernels do not take."""
    assert bl.fused_psd_chirp_large_eligible(N) == ok


@pytest.mark.parametrize("N,M,split", [
    (8194, 32768, (128, 256)), (16382, 32768, (128, 256)),
    (20002, 65536, (256, 256)), (99998, 262144, (512, 512)),
    (999998, 2097152, (1024, 2048)), (1 << 21, 1 << 22, (2048, 2048))])
def test_chirp_sizes_and_splits(N, M, split):
    assert fb.chirp_size(N) == M and bl.chirp_large_split(N) == split


def test_layout_of_every_m():
    """At every M the three tiles fit two blocks an SM."""
    for N in (8194, 16386, 32770, 65538, 131074, 262146, 524290, 1048578):
        t = bl.chirp_large_layout(N)
        assert t.M1 * t.M2 == fb.chirp_size(N) and 2 * N - 1 <= t.M1 * t.M2
        assert max(t.smem) <= ml.TILE_SMEM
        assert t.row % fm.SUM_BINS == 0 and N <= t.row < N + fm.SUM_BINS


@pytest.mark.parametrize("N", [8194, 16382, 99998])
def test_zero_rows_are_the_samples_past_n(N):
    """Pass A reads sample n1 M2 + n2 only below first_zero_row(n2), which
    is exactly where n < N."""
    m1, m2 = bl.chirp_large_split(N)
    n2 = np.arange(m2)
    zero = first_zero_row(N, n2)
    n = np.arange(m1)[:, None] * m2 + n2[None, :]
    assert np.array_equal(np.arange(m1)[:, None] < zero[None, :], n < N)
    assert zero.min() >= 1 and zero.max() <= m1 // 2 + 1


@pytest.mark.parametrize("N", [8194, 20002])
def test_spectrum_table_is_b_over_m_at_k1_k2(N):
    M, _, B = fb.bluestein_constants(N, fb.chirp_size(N))
    m1, m2 = bl.chirp_large_split(N)
    S = bl.spectrum_table(N)
    k1, k2 = np.meshgrid(np.arange(m1), np.arange(m2), indexing="ij")
    assert S.shape == (m1, m2) and S.dtype == np.complex64
    assert np.array_equal(S, (B[k1 + m1 * k2] / np.float32(M))
                          .astype(np.complex64))


@pytest.mark.parametrize("N", [8194, 16382])
def test_pass_c_keeps_each_bin_below_n_once(N):
    t = bl.chirp_large_layout(N)
    bins, elem = partial_bins(t.M2, t.M1, t.plan1, N)
    kept = bins[bins >= 0]
    assert sorted(kept) == list(range(N))
    assert (bins < 0).sum() == t.M1 * t.M2 - N
    assert sorted(elem) == list(range(t.M1))


@pytest.mark.parametrize("N", [8194, 9002])
def test_transcription_float64_is_the_dft(N):
    raw = frames(2, N, N)
    got = kernel_transcription(raw, 2, 1, dtype=np.complex128)
    z = dequantize(raw, None, np.complex128)
    want = (np.abs(np.fft.fft(z, axis=1)) ** 2).sum(0)
    np.testing.assert_allclose(got, want, rtol=1e-9)


@pytest.mark.parametrize("N,F,n_valid,window", [
    (8194, 8, 8, None), (16382, 8, 5, "hann"), (20002, 4, 4, None)])
def test_transcription_float32_against_golden(N, F, n_valid, window):
    raw = frames(F, N, N + F)
    w = None if window is None else make_window(window, N)
    got = kernel_transcription(raw, n_valid, F, w)
    np.testing.assert_allclose(got, golden(raw, n_valid, w),
                               rtol=GOLDEN_RTOL)
    np.testing.assert_allclose(got, plain(raw, n_valid, F, w),
                               rtol=GOLDEN_RTOL)


@pytest.mark.parametrize("N,F,n_valid,window", [
    (16382, 8, 8, None), (16382, 8, 8, "hann"), (20002, 8, 8, None),
    (20002, 8, 6, "hann"), (99998, 8, 8, None), (99998, 8, 3, "hann"),
    (8194, 16, 11, None)])
def test_step_matches_jax_step_and_golden(N, F, n_valid, window):
    raw = frames(F, N, N + n_valid)
    w = None if window is None else make_window(window, N)
    step = spectral.PsdStep(N, F, CPU, window=w)
    assert step.path == "plain_chirp_large"
    got = step(raw, n_valid).numpy()
    want = np.asarray(JaxPsdStep(N, F, window=w)(raw, n_valid), np.float64)
    gold = golden(raw, n_valid, w)
    np.testing.assert_allclose(got, want, rtol=CROSS_RTOL)
    np.testing.assert_allclose(got, gold, rtol=GOLDEN_RTOL)
    np.testing.assert_allclose(want, gold, rtol=GOLDEN_RTOL)


@pytest.mark.parametrize("N", [16384, 20000])
def test_bluestein_backend_runs_the_chirp_z_kernel(N):
    """--fft-backend bluestein takes BL at any even N in (8192, 2^21],
    powers of two and 7-smooth N too, as the JAX package's chirp-Z rung."""
    F = 8
    raw = frames(F, N, 3)
    step = spectral.PsdStep(N, F, CPU, backend="bluestein")
    assert step.path == "plain_chirp_large"
    got = step(raw, 7).numpy()
    want = np.asarray(JaxPsdStep(N, F, backend="bluestein")(raw, 7),
                      np.float64)
    np.testing.assert_allclose(got, want, rtol=CROSS_RTOL)
    np.testing.assert_allclose(got, golden(raw, 7), rtol=GOLDEN_RTOL)


def test_cpu_calls_count_as_plain():
    fp.COUNTS.reset()
    raw = torch.from_numpy(frames(8, 16382, 1))
    bl.fused_psd_chirp_large(raw, 8, 8)
    assert fp.COUNTS.plain == 1
    assert fp.COUNTS.kernel_chirp_large == 0
    assert fp.COUNTS.kernel_chirp_large_windowed == 0


@pytest.mark.parametrize("N", [8192, 4194302, 1 << 22])
def test_rejects_n_the_kernel_does_not_take(N):
    raw = torch.zeros((8, 2 * N), dtype=torch.uint8)
    with pytest.raises(ValueError, match="does not take"):
        bl.fused_psd_chirp_large(raw, 8, 8)


SESSIONS = {
    "99998": ["-f", "100M", "-b", "99998", "-n", "16", "--source",
              "synthetic:tone=100.2M/35,noise=6,seed=1"],
    "16382 bluestein": ["-f", "100M", "-b", "16382", "-n", "50",
                        "--fft-backend", "bluestein", "--source",
                        "synthetic:tone=100.3M/35,noise=5,seed=3"],
}


@pytest.mark.parametrize("matrix", [False, True])
@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_session_matches_jax_session(name, matrix, tmp_path):
    session_matches_jax_session(SESSIONS[name], "plain_chirp_large",
                                lambda N: N, None, tmp_path, matrix)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Runs only where a CUDA device is present (chip_smoke.py phase 15
    covers it in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    N, F = 16382, 16
    raw = torch.from_numpy(frames(F, N, 11)).cuda()
    got = bl.fused_psd_chirp_large(raw, F, F).cpu().numpy()
    want = bl.chirp_large_reference(raw.cpu(), F, F).numpy()
    np.testing.assert_allclose(got, want, rtol=GOLDEN_RTOL)
