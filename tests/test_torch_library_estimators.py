"""The PyTorch package's spectrogram, pfb_channelize, coherence and
spectral_correlation against the JAX package's, on the same bytes, and
their kernels' index arithmetic transcribed in numpy.

The port runs on the CPU, where each kernel's wrapper runs its plain
PyTorch version (the frames kernel FR, the channelizer PFB-C, the
cross-spectral kernel CSD and the spectral-correlation kernel SCF); the
JAX estimators run their own CPU step. Tolerances:

* spectrogram rows (linear power): within 1e-5 of the row's RMS power,
  bin by bin (RTOL_RMS), or within 3x the scipy float32 FFT's own largest
  distance from the float64 golden on the same frames where that is
  larger (the class-relative budget of CLAUDE.md: at N = 2048, one
  Blackman periodogram a row, the class is 8.5e-6 of the row's RMS and
  two runs of the JAX function on the CPU differ by 1.2e-5). A row of
  one periodogram has bins near zero, where a relative error means
  nothing (f32 FFTs differ there by ~1e-4 relative on either side), and
  a 30 dB tone's bin, whose f32 error is ~1e-5 of the row's mean;
  averaged rows are held per bin to 1e-5 relative besides;
* the channelizer's X: the largest error over the mean magnitude, within
  1e-5; the SCF rows over the α = 0 row's RMS, and the CSD over the
  geometric mean of the two streams' RMS power (its own values are near
  0 for independent streams), each within 1e-5: as for the spectrogram,
  f32 errors follow a tone's bin, ~N ε of a mean that the noise sets;
* γ² and the spectral coherence (both in [0, 1]): within 1e-5
  absolute (GAMMA_ATOL).
"""

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu import models as jax_models
from rtl_power_fftw_tpu.auxdata import make_window
from rtl_power_fftw_tpu_torch import models
from rtl_power_fftw_tpu_torch.exceptions import RPFexception
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_csd as fcsd
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_frames as ffr
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_scf as fscf
from rtl_power_fftw_tpu_torch.ops.spectral import FrameSlicer

from golden import golden_accumulate

CPU = torch.device("cpu")
RTOL_RMS = 1e-5
RTOL = 1e-5
GAMMA_ATOL = 1e-5
RATE = 2_000_000


def stream(n_bytes, seed, amp=30.0, f0=0.173, noise=5.0):
    """IQ bytes of a tone over noise (a recorded capture)."""
    rng = np.random.default_rng(seed)
    n = n_bytes // 2
    x = amp * np.exp(2j * np.pi * f0 * np.arange(n)) + noise * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    iq = np.stack([np.clip(np.round(x.real + 127), 0, 255),
                   np.clip(np.round(x.imag + 127), 0, 255)], axis=-1)
    return iq.astype(np.uint8).ravel()


def err_over_mean(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).mean())


def linear(psd, is_linear):
    return psd if is_linear else 10.0 ** (psd / 10.0)


def f32_class_rms(iq, N, hop, window, average):
    """The scipy float32 FFT's largest distance from the float64 golden
    over the spectrogram's rows of ``iq``, bin by bin, over the row's RMS
    power."""
    import scipy.fft
    frames = FrameSlicer(N, hop=hop).push(iq)
    frames = frames[:len(frames) // average * average]
    z = (frames[:, 0::2].astype(np.float64) - 127.0) + 1j * (
        frames[:, 1::2].astype(np.float64) - 127.0)
    if window is not None:
        z = z * np.asarray(window, np.float64)

    def rows(X):
        return (np.abs(X) ** 2).reshape(-1, average, N).sum(axis=1)

    gold = rows(np.fft.fft(z, axis=1))
    cls = rows(scipy.fft.fft(z.astype(np.complex64), axis=1)
               .astype(np.complex128))
    rms = np.sqrt((gold ** 2).mean(axis=1, keepdims=True))
    return float((np.abs(cls - gold) / rms).max())


# --- spectrogram ----------------------------------------------------------

@pytest.mark.parametrize("N,window,average,hop,dc_interp,is_linear,fps", [
    (64, None, 1, None, True, False, 1024),
    (256, "hann", 4, None, True, True, 1024),
    (512, None, 4, 256, False, True, 1024),
    (2048, "blackman", 1, 1024, True, False, 1024),
    (128, "hann", 1, 64, False, False, 1024),
    (64, None, 4, None, True, True, 12),
    (256, None, 1, None, False, True, 7),
])
def test_spectrogram_matches_jax(N, window, average, hop, dc_interp,
                                 is_linear, fps):
    iq = stream(2 * N * 37 + 11, N)
    w = None if window is None else make_window(window, N)
    kw = dict(center_freq=100_000_000, hop=hop, average=average, window=w,
              linear=is_linear, dc_interp=dc_interp, frames_per_step=fps)
    t_o, f_o, s_o = models.spectrogram(iq, N, RATE, device=CPU, **kw)
    t_t, f_t, s_t = jax_models.spectrogram(iq, N, RATE, **kw)
    np.testing.assert_array_equal(t_o, t_t)
    np.testing.assert_array_equal(f_o, f_t)
    assert s_o.shape == s_t.shape
    p_o, p_t = linear(s_o, is_linear), linear(s_t, is_linear)
    scale = np.sqrt((p_t ** 2).mean(axis=1, keepdims=True))
    budget = max(RTOL_RMS, 3.0 * f32_class_rms(iq, N, hop, w, average))
    assert np.all(np.abs(p_o - p_t) <= budget * scale)
    if average > 1:
        np.testing.assert_allclose(p_o, p_t, rtol=RTOL)


def test_spectrogram_shape_and_values():
    """tests/test_models.py's row 0 against the single-frame golden, at
    N = 64."""
    N, rate, n_rows = 64, 1_000_000, 12
    iq = stream(2 * N * n_rows, seed=25)
    times, freqs, S = models.spectrogram(iq, N, rate, linear=True,
                                         dc_interp=False, device=CPU)
    assert S.shape == (n_rows, N)
    assert len(times) == n_rows and times[0] == 0.0
    assert times[1] == N / rate
    pwr, _ = golden_accumulate(iq[:2 * N], N, 1)
    np.testing.assert_allclose(S[0], pwr / N / rate, rtol=2e-5)


def test_spectrogram_group_averaging():
    N, rate = 64, 500_000
    iq = stream(2 * N * 8, seed=26)
    _, _, S1 = models.spectrogram(iq, N, rate, average=4, linear=True,
                                  device=CPU)
    assert S1.shape == (2, N)
    _, _, S2 = models.spectrogram(iq, N, rate, average=1, linear=True,
                                  device=CPU)
    np.testing.assert_allclose(S1[0], S2[:4].mean(axis=0), rtol=1e-6)


# --- pfb_channelize --------------------------------------------------------

@pytest.mark.parametrize("M,P,blocks", [
    (64, 2, 40), (64, 4, 40), (256, 2, 30), (256, 4, 30), (64, 4, 1100),
    (64, 1, 9)])
def test_pfb_channelize_matches_jax(M, P, blocks):
    iq = stream(2 * M * blocks + 5, M + P)
    ours = models.pfb_channelize(iq, M, taps=P, device=CPU)
    theirs = jax_models.pfb_channelize(iq, M, taps=P)
    assert ours.shape == theirs.shape == (blocks - P + 1, M)
    assert ours.dtype == np.complex64
    assert err_over_mean(ours, theirs) <= RTOL


def test_pfb_channelize_custom_prototype():
    M, P = 128, 3
    iq = stream(2 * M * 20, 7)
    h = np.random.default_rng(3).standard_normal(P * M).astype(np.float32)
    ours = models.pfb_channelize(iq, M, taps=P, prototype=h, device=CPU)
    theirs = jax_models.pfb_channelize(iq, M, taps=P, prototype=h)
    assert err_over_mean(ours, theirs) <= RTOL


def test_channelize_shape_and_psd_consistency():
    """tests/test_pfb.py's channelizer against the port's pfb_psd."""
    M, P = 64, 4
    iq = stream(2 * 20 * M, seed=4)
    y = models.pfb_channelize(iq, M, taps=P, device=CPU)
    assert y.shape == (20 - P + 1, M) and y.dtype == np.complex64
    _, psd = models.pfb_psd(iq, M, RATE, taps=P, linear=True, device=CPU)
    pwr = np.fft.fftshift((np.abs(y.astype(np.complex128)) ** 2).sum(0))
    pwr[M // 2] = (pwr[M // 2 - 1] + pwr[M // 2 + 1]) / 2.0
    np.testing.assert_allclose(psd, pwr / y.shape[0] / M / RATE, rtol=2e-5)


# --- coherence -------------------------------------------------------------

def two_receivers(N, M, seed, amp=25.0, bin_=32):
    """Two streams sharing a tone at ``bin_`` bins, independent noise."""
    t = np.arange(N * M)
    common = amp * np.exp(2j * np.pi * bin_ / N * t)

    def quantize(seed):
        r = np.random.default_rng(seed)
        buf = np.empty(2 * N * M)
        buf[0::2] = common.real + r.normal(0, 6.0, N * M) + 127.0
        buf[1::2] = common.imag + r.normal(0, 6.0, N * M) + 127.0
        return np.clip(np.rint(buf), 0, 255).astype(np.uint8)

    return quantize(seed), quantize(seed + 1)


@pytest.mark.parametrize("N,M,window,repeats,fps,shared", [
    (256, 300, None, None, 512, True), (256, 300, "hann", None, 64, True),
    (128, 200, None, 150, 512, False), (2048, 20, "hann", None, 512, True),
    (64, 700, None, None, 512, False)])
def test_coherence_matches_jax(N, M, window, repeats, fps, shared):
    if shared:
        iq_x, iq_y = two_receivers(N, M, N + M)
    else:
        iq_x, iq_y = (stream(2 * N * M, N), stream(2 * N * M, N + 1))
    w = None if window is None else make_window(window, N)
    kw = dict(center_freq=1_000_000, repeats=repeats, window=w,
              frames_per_step=fps)
    f_o, g_o, c_o = models.coherence(iq_x, iq_y, N, RATE, device=CPU, **kw)
    f_t, g_t, c_t = jax_models.coherence(iq_x, iq_y, N, RATE, **kw)
    np.testing.assert_array_equal(f_o, f_t)
    np.testing.assert_allclose(g_o, g_t, rtol=0, atol=GAMMA_ATOL)
    M_used = min(M, repeats or M)
    scale = np.sqrt(rms_power(iq_x, N, M_used, w)
                    * rms_power(iq_y, N, M_used, w)) / N / RATE
    assert np.abs(c_o - c_t).max() <= RTOL * scale


def rms_power(iq, N, M, window):
    """The RMS over bins of the mean |X|^2 of the first M frames,
    float64."""
    z = ((iq[:2 * N * M:2].astype(np.float64) - 127.0)
         + 1j * (iq[1:2 * N * M:2].astype(np.float64) - 127.0))
    z = z.reshape(M, N) * (1.0 if window is None else window)
    P = (np.abs(np.fft.fft(z, axis=1)) ** 2).mean(axis=0)
    return float(np.sqrt((P ** 2).mean()))


def test_coherence_common_tone():
    rate, N, M = 2_048_000, 256, 512
    iq_x, iq_y = two_receivers(N, M, 61)
    _, g2, csd = models.coherence(iq_x, iq_y, N, rate,
                                  center_freq=1_000_000, device=CPU)
    tone_bin = N // 2 + 32
    assert g2[tone_bin] > 0.95
    others = np.delete(g2, [tone_bin - 1, tone_bin, tone_bin + 1])
    assert np.median(others) < 0.05
    assert abs(np.angle(csd[tone_bin])) < 0.05
    assert 0.0 <= g2.min() and g2.max() <= 1.0 + 1e-9


def test_coherence_independent_streams_low():
    rng = np.random.default_rng(63)
    N, M = 128, 256
    iq_x = rng.integers(0, 256, 2 * N * M, dtype=np.uint8)
    iq_y = rng.integers(0, 256, 2 * N * M, dtype=np.uint8)
    _, g2, _ = models.coherence(iq_x, iq_y, N, 1_000_000, device=CPU)
    assert np.median(g2) < 0.05


def test_coherence_dc_bin_not_spurious():
    N, M = 256, 2000

    def white(seed):
        r = np.random.default_rng(seed)
        return np.clip(np.rint(127.5 + r.normal(0, 5.0, 2 * N * M)),
                       0, 255).astype(np.uint8)

    _, g2, _ = models.coherence(white(65), white(66), N, 1_000_000,
                                device=CPU)
    assert g2[N // 2] < 0.05, g2[N // 2]
    assert np.median(g2) < 0.05


# --- spectral_correlation -------------------------------------------------

@pytest.mark.parametrize("N,frames,K,window", [
    (64, 24, 1, None), (64, 600, 5, None), (256, 40, 8, "hann"),
    (128, 100, 128, None), (2048, 10, 5, None)])
def test_spectral_correlation_matches_jax(N, frames, K, window):
    iq = stream(2 * N * frames + 3, N + K)
    w = None if window is None else make_window(window, N)
    a_o, s_o, c_o = models.spectral_correlation(iq, N, RATE,
                                                max_alpha_bins=K, window=w,
                                                device=CPU)
    a_t, s_t, c_t = jax_models.spectral_correlation(iq, N, RATE,
                                                    max_alpha_bins=K,
                                                    window=w)
    np.testing.assert_array_equal(a_o, a_t)
    scale = np.sqrt((np.abs(s_t[0]) ** 2).mean())
    assert np.abs(s_o - s_t).max() <= RTOL * scale
    np.testing.assert_allclose(c_o, c_t, rtol=0, atol=GAMMA_ATOL)


def test_spectral_correlation_numpy_parity():
    N, M = 64, 24
    iq = np.random.default_rng(5).integers(0, 256, M * 2 * N,
                                           dtype=np.uint8)
    alphas, scf, coh = models.spectral_correlation(
        iq, N, 1_000_000, max_alpha_bins=5, device=CPU)
    assert alphas.shape == (5,) and scf.shape == (5, N)
    x = (iq[0::2].astype(np.float64) - 127.0) \
        + 1j * (iq[1::2].astype(np.float64) - 127.0)
    X = np.fft.fft(x.reshape(M, N), axis=1)
    want = np.stack([(np.roll(X, -k, axis=1) * np.conj(X)).mean(axis=0)
                     for k in range(5)])
    np.testing.assert_allclose(scf, want, rtol=2e-5, atol=1e-3)
    assert np.all(coh <= 1.0 + 1e-9)
    np.testing.assert_allclose(scf[0].real, (np.abs(X) ** 2).mean(axis=0),
                               rtol=2e-5)


def test_spectral_correlation_detects_am_cyclostationarity():
    N, M = 128, 200
    t = np.arange(M * N)
    fm_bins = 4
    carrier = np.exp(2j * np.pi * (17 / N) * t)
    am = (1.0 + 0.9 * np.cos(2 * np.pi * fm_bins / N * t)) * 40.0 * carrier
    rng = np.random.default_rng(6)
    x = am + 3.0 * (rng.standard_normal(M * N)
                    + 1j * rng.standard_normal(M * N))
    re = np.clip(np.round(x.real + 127), 0, 255).astype(np.uint8)
    im = np.clip(np.round(x.imag + 127), 0, 255).astype(np.uint8)
    iq = np.stack([re, im], axis=-1).reshape(-1)
    _, _, coh = models.spectral_correlation(iq, N, 1_000_000,
                                            max_alpha_bins=8, device=CPU)
    scores = coh[1:].max(axis=1)
    assert int(np.argmax(scores)) + 1 == fm_bins
    assert scores[fm_bins - 1] > 3 * np.median(np.delete(scores,
                                                         fm_bins - 1))


# --- errors: the JAX package's ValueErrors and the port's "Not yet ported"

def call_both(name, *args, **kw):
    """Run the port's function ``name`` and the JAX package's on the same
    arguments; return the two exceptions raised."""
    errs = []
    for fn in (lambda: getattr(models, name)(*args, device=CPU, **kw),
               lambda: getattr(jax_models, name)(*args, **kw)):
        with pytest.raises(ValueError) as e:
            fn()
        errs.append(str(e.value))
    return errs


@pytest.mark.parametrize("name,args,kw,text", [
    ("spectrogram", (np.zeros(100, np.uint8), 64, RATE), {},
     "not enough samples"),
    ("spectrogram", (np.zeros(2 * 64 * 3, np.uint8), 64, RATE),
     {"average": 4}, "not enough samples"),
    ("pfb_channelize", (np.zeros(2 * 64 * 3, np.uint8), 64), {"taps": 4},
     "not enough samples"),
    ("pfb_channelize", (np.zeros(2 * 64 * 9, np.uint8), 64),
     {"taps": 4, "prototype": np.ones(100, np.float32)},
     "prototype must have"),
    ("coherence", (np.zeros(2 * 64, np.uint8), np.zeros(2 * 64 * 4,
                                                        np.uint8), 64, RATE),
     {}, "coherence needs at least 2 frames"),
    ("spectral_correlation", (np.zeros(2 * 64 * 4, np.uint8), 64, RATE),
     {"max_alpha_bins": 0}, "max_alpha_bins must be in [1, N]"),
    ("spectral_correlation", (np.zeros(2 * 64 * 4, np.uint8), 64, RATE),
     {"max_alpha_bins": 65}, "max_alpha_bins must be in [1, N]"),
    ("spectral_correlation", (np.zeros(100, np.uint8), 64, RATE), {},
     "stream shorter than one FFT frame"),
])
def test_jax_value_errors_keep_their_text(name, args, kw, text):
    ours, theirs = call_both(name, *args, **kw)
    assert ours == theirs and text in ours


@pytest.mark.parametrize("N", [500, 32768, 32])
@pytest.mark.parametrize("name", ["spectrogram", "pfb_channelize",
                                  "coherence", "spectral_correlation"])
def test_not_yet_ported_outside_powers_of_two(name, N):
    iq = np.zeros(2 * N * 4, np.uint8)
    args = {"spectrogram": (iq, N, RATE), "pfb_channelize": (iq, N),
            "coherence": (iq, iq, N, RATE),
            "spectral_correlation": (iq, N, RATE)}[name]
    with pytest.raises(RPFexception, match="Not yet ported") as e:
        getattr(models, name)(*args, device=CPU)
    assert f"at {N} bins" in str(e.value)


@pytest.mark.parametrize("backend", ["matmul", "xla", "fourstep",
                                     "bluestein"])
def test_spectrogram_other_backends_not_yet_ported(backend):
    with pytest.raises(RPFexception, match="Not yet ported"):
        models.spectrogram(np.zeros(2 * 64 * 4, np.uint8), 64, RATE,
                           backend=backend, device=CPU)


def test_pfb_channelize_taps_past_the_kernels_not_yet_ported():
    with pytest.raises(RPFexception, match="Not yet ported"):
        models.pfb_channelize(np.zeros(2 * 64 * 40, np.uint8), 64, taps=33,
                              device=CPU)


# --- the wrappers on the CPU: the plain versions, counted -----------------

def raw_frames(F, N, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (F, 2 * N), dtype=np.uint8))


@pytest.mark.parametrize("out", ffr.MODES)
def test_frames_wrapper_runs_plain_on_cpu(out):
    raw = raw_frames(16, 64, 1)
    fp.COUNTS.reset()
    got = ffr.fused_psd_frames(raw, 9, None, out)
    assert fp.COUNTS.plain == fp.COUNTS.plain_frames == 1
    assert fp.COUNTS.kernel_frames == 0
    X = np.fft.fft((raw[:, 0::2].numpy() - 127.0)
                   + 1j * (raw[:, 1::2].numpy() - 127.0), axis=1)
    want = X if out == "complex" else np.fft.fftshift(np.abs(X) ** 2, axes=1)
    assert err_over_mean(got[:9].numpy(), want[:9]) <= RTOL
    assert not got[9:].abs().any()


def test_frames_wrapper_rejects_other_stores():
    with pytest.raises(ValueError, match="out must be"):
        ffr.fused_psd_frames(raw_frames(8, 64, 1), 8, None, "power")


def test_csd_wrapper_runs_plain_on_cpu():
    x, y = raw_frames(32, 128, 2), raw_frames(32, 128, 3)
    fp.COUNTS.reset()
    got = fcsd.fused_psd_csd(x, y, 20, 16).numpy()
    assert fp.COUNTS.plain_csd == 1 and fp.COUNTS.kernel_csd == 0
    X = np.fft.fft((x[:20, 0::2].numpy() - 127.0)
                   + 1j * (x[:20, 1::2].numpy() - 127.0), axis=1)
    Y = np.fft.fft((y[:20, 0::2].numpy() - 127.0)
                   + 1j * (y[:20, 1::2].numpy() - 127.0), axis=1)
    cross = (X * np.conj(Y)).sum(0)
    want = [(np.abs(X) ** 2).sum(0), (np.abs(Y) ** 2).sum(0), cross.real,
            cross.imag]
    for p in range(4):
        assert np.abs(got[p] - want[p]).max() <= RTOL * np.abs(
            want[0]).mean()


def test_csd_wrapper_rejects_unequal_streams():
    with pytest.raises(ValueError, match="differ"):
        fcsd.fused_psd_csd(raw_frames(8, 64, 1), raw_frames(16, 64, 1), 8, 8)


def test_scf_wrapper_runs_plain_on_cpu():
    X = ffr.fused_psd_frames(raw_frames(16, 64, 4), 16, None, "complex")
    fp.COUNTS.reset()
    got = fscf.fused_psd_scf(X, 11, 8, 3, 6).numpy()
    assert fp.COUNTS.plain_scf == 1 and fp.COUNTS.kernel_scf == 0
    Xn = X[:11].numpy().astype(np.complex128)
    want = np.stack([(np.roll(Xn, -k, axis=1) * np.conj(Xn)).sum(0)
                     for k in range(3, 9)])
    scale = (np.abs(Xn) ** 2).sum(0).mean()
    assert np.abs(got[0] - want.real).max() <= RTOL * scale
    assert np.abs(got[1] - want.imag).max() <= RTOL * scale


@pytest.mark.parametrize("k0,K", [(60, 5), (0, 0), (-1, 3)])
def test_scf_wrapper_rejects_lags_outside(k0, K):
    X = torch.zeros((8, 64), dtype=torch.complex64)
    with pytest.raises(ValueError, match="lags"):
        fscf.fused_psd_scf(X, 8, 8, k0, K)


def test_pfb_channelize_wrapper_runs_plain_on_cpu():
    rows = raw_frames(12, 64, 5)
    h = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 64)).astype(np.float32))
    fp.COUNTS.reset()
    got = fpf.pfb_channelize(rows, h).numpy()
    assert fp.COUNTS.plain_pfb_channelize == 1
    assert fp.COUNTS.kernel_pfb_channelize == 0
    z = (rows[:, 0::2].numpy() - 127.0) + 1j * (rows[:, 1::2].numpy()
                                                - 127.0)
    s = sum(z[p:p + 10] * h[p].numpy() for p in range(3))
    assert err_over_mean(got, np.fft.fft(s, axis=1)) <= RTOL


def test_pfb_channelize_wrapper_needs_an_output_frame():
    with pytest.raises(ValueError, match="no output frame"):
        fpf.pfb_channelize(raw_frames(2, 64, 5), torch.ones((3, 64)))


# --- the kernels' index arithmetic, transcribed in numpy ------------------

def regs_shape(N):
    shape = fp.regs_shape(N)
    return shape.R, shape.TF, shape.lanes


def slot_bin(N, t, k):
    """regs_slot_bin of csrc/fused_psd_regs.cuh: the bin of thread t's
    output slot k after the register transform."""
    plan = fp.PASS_PLAN[N]
    R, TF, _ = regs_shape(N)
    spans, L = [], N
    for r in plan:
        spans.append((L, L // r))
        L //= r
    L_last, S_last = spans[-1]
    RL = plan[-1]
    SL = L_last // RL
    bits = RL.bit_length() - 1
    rev = int(format(k % RL, f"0{bits}b")[::-1], 2) if bits else 0
    b = t + (k // RL) * TF
    q = (b // SL) * L_last + (b % SL) + rev * SL
    bin_, scale = 0, 1
    for L_j, S_j in spans:
        r = L_j // S_j
        bin_ += ((q // S_j) % r) * scale
        scale *= r
    return bin_


@pytest.mark.parametrize("N", sorted(fp.PASS_PLAN))
def test_frame_store_stages_every_bin_once(N):
    """FR's store (regs_frame_store): the lane's TF threads write their R
    slots at their bins, every bin once, and the shifted store index
    (bin + N/2) & (N - 1) is fftshift's."""
    R, TF, _ = regs_shape(N)
    bins = np.array([slot_bin(N, t, k) for t in range(TF) for k in range(R)])
    assert np.array_equal(np.sort(bins), np.arange(N))
    shifted = (np.arange(N) + N // 2) & (N - 1)
    x = np.random.default_rng(N).standard_normal(N)
    row = np.empty(N)
    row[shifted] = x
    assert np.array_equal(row, np.fft.fftshift(x))


@pytest.mark.parametrize("N,F,group,n_valid", [
    (64, 100, 8, 100), (64, 100, 8, 37), (2048, 64, 1, 64),
    (16384, 9, 2, 7), (256, 10, 64, 0)])
def test_frames_lanes_cover_each_valid_frame_once(N, F, group, n_valid):
    """FR's (and CSD's) lane -> frame mapping: block g, lane l, iteration
    i take frame g * group + l + LANES * i below min((g + 1) * group, F,
    n_valid); every valid frame once, no other."""
    _, _, lanes = regs_shape(N)
    seen = []
    for g in range(-(-F // group)):
        f0, f1 = g * group, min(g * group + group, F, n_valid)
        iters = -(-max(f1 - f0, 0) // lanes)
        for i in range(iters):
            for lane in range(lanes):
                f = f0 + lane + lanes * i
                if f < f1:
                    seen.append(f)
    assert sorted(seen) == list(range(n_valid))


@pytest.mark.parametrize("N,P,T,group", [
    (64, 4, 50, 8), (256, 2, 33, 64), (2048, 16, 20, 3), (128, 1, 9, 4)])
def test_channelize_ring_rows(N, P, T, group):
    """PFB-C's ring: block g stages its local rows q (virtual row g group +
    q) into slot q mod (2 LANES + P - 1), rows LANES (i + 1) + P - 1 ..
    LANES (i + 2) + P - 2 at iteration i; lane l's tap p at iteration i
    reads slot (LANES i + l + p) mod slots, which then holds virtual row
    f + p of frame f, and no slot is overwritten while a later read of the
    same iteration needs it."""
    _, _, lanes = regs_shape(N)
    slots = 2 * lanes + P - 1
    for g in range(-(-T // group)):
        f0, f1 = g * group, min(g * group + group, T)
        frames = f1 - f0
        rows = frames + P - 1
        ring = [None] * slots

        def stage(lo, hi):
            for q in range(lo, min(hi, rows)):
                ring[q % slots] = f0 + q

        stage(0, lanes + P - 1)
        for i in range(-(-frames // lanes)):
            stage(lanes * (i + 1) + P - 1, lanes * (i + 2) + P - 1)
            # The copies of iteration i land in slots iteration i - 1 read;
            # iteration i's rows are still there.
            for lane in range(lanes):
                f = f0 + lane + lanes * i
                if f >= f1:
                    continue
                for p in range(P):
                    assert ring[(lanes * i + lane + p) % slots] == f + p


def test_csd_planes_row_sum_order():
    """CSD's four planes: block g writes plane p's partial row at (p G +
    g) N, and psd_sum.cuh's row sum over S = 4 planes of G rows gives
    plane p's output row, the sum over the groups of the group sums."""
    G, N, chunk = 5, 64, 8
    rng = np.random.default_rng(9)
    frames = rng.standard_normal((4, G * chunk, N)).astype(np.float32)
    partial = np.empty(4 * G * N, np.float32)
    for p in range(4):
        for g in range(G):
            partial[(p * G + g) * N:(p * G + g + 1) * N] = \
                frames[p, g * chunk:(g + 1) * chunk].sum(0)
    out = partial.reshape(4, G, N).astype(np.float64).sum(1)
    want = frames.astype(np.float64).sum(1)
    assert np.all(np.abs(out - want)
                  <= 1e-5 * np.abs(frames).astype(np.float64).sum(1))


@pytest.mark.parametrize("N,K,k0", [(64, 5, 0), (64, 64, 0), (256, 40, 3),
                                    (128, 7, 121)])
def test_scf_blocks_lags_and_wrap(N, K, k0):
    """SCF's grid: block (bx, by) and thread (b, row) own bin bx TILE_BINS
    + b and local lags by TILE_LAGS + row + LAG_ROWS j, each (k < K, f)
    once; C holds X[(c0 + q) mod N] with c0 = (bin0 + (k0 + lag0) mod N)
    mod N, so C[b + row + LAG_ROWS j] is X[(f + k0 + k) mod N], jnp.roll's
    (f + k) wrap."""
    tb, tl, rows = fscf.TILE_BINS, fscf.TILE_LAGS, fscf.LAG_ROWS
    X = np.arange(N)
    seen = np.zeros((K, N), int)
    for bx in range(N // tb):
        for by in range(-(-K // tl)):
            bin0, lag0 = bx * tb, by * tl
            c0 = (bin0 + (k0 + lag0) % N) % N
            C = X[(c0 + np.arange(tb + tl)) % N]
            for b in range(tb):
                for row in range(rows):
                    for j in range(tl // rows):
                        k = lag0 + row + rows * j
                        if k >= K:
                            continue
                        f = bin0 + b
                        seen[k, f] += 1
                        assert C[b + row + rows * j] == np.roll(
                            X, -(k0 + k))[f]
    assert np.all(seen == 1)


@pytest.mark.parametrize("F,chunk,n_valid", [(512, 64, 512), (512, 64, 300),
                                             (40, 8, 0), (24, 8, 17)])
def test_scf_group_order(F, chunk, n_valid):
    """SCF's groups: block z = g sums frames g chunk .. min((g + 1) chunk,
    n_valid) - 1 in order; the groups cover the valid frames once, as the
    JAX step's (g, chunk) tree does with its mask."""
    covered = []
    for g in range(F // chunk):
        covered += list(range(g * chunk, min(g * chunk + chunk, n_valid)))
    assert covered == list(range(n_valid))


@pytest.mark.parametrize("N,K", [(64, 64), (16384, 16384), (2048, 16),
                                 (16384, 100)])
def test_scf_lag_slabs_tile_every_lag(N, K):
    slabs = fscf.lag_slabs(N, K)
    assert [k for k0, n in slabs for k in range(k0, k0 + n)] == list(range(K))
    assert all(n * N <= max(fscf.SLAB, N) for _, n in slabs)


@pytest.mark.parametrize("steps", [0, 1, 4, 5, 13])
def test_read_back_in_order_keeps_steps_in_flight(steps):
    """The models' queue: every step is read back once, in launch order,
    and step i only after step i + IN_FLIGHT is launched (or after the
    last launch)."""
    from rtl_power_fftw_tpu_torch.models import _steps
    events = []

    def launches():
        for i in range(steps):
            events.append(("launch", i))
            yield i

    _steps.read_back_in_order(launches(), lambda i: events.append(
        ("read", i)))
    reads = [i for kind, i in events if kind == "read"]
    assert reads == list(range(steps))
    for i in range(steps):
        launched = events.index(("launch", min(i + _steps.IN_FLIGHT,
                                               steps - 1)))
        assert events.index(("read", i)) > launched


# --- on the card ----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 2048, 16384])
def test_kernels_match_plain_on_the_card(N):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    dev = torch.device("cuda", 0)
    F = 64
    raw = raw_frames(F, N, 7).to(dev)
    rawy = raw_frames(F, N, 8).to(dev)
    for out in ffr.MODES:
        got = ffr.fused_psd_frames(raw, F - 1, None, out)[:F - 1]
        want = ffr.fused_psd_frames_reference(raw, F - 1, None, out)[:F - 1]
        assert err_over_mean(torch.view_as_real(got).cpu().numpy()
                             if out == "complex" else got.cpu().numpy(),
                             torch.view_as_real(want).cpu().numpy()
                             if out == "complex" else want.cpu().numpy()
                             ) <= RTOL
    got = fcsd.fused_psd_csd(raw, rawy, F - 1, 64).cpu().numpy()
    want = fcsd.fused_psd_csd_reference(raw, rawy, F - 1, 64).cpu().numpy()
    assert np.abs(got - want).max() <= RTOL * np.abs(want[0]).mean()
    X = ffr.fused_psd_frames(raw, F, None, "complex")
    got = fscf.fused_psd_scf(X, F, 64, 0, 5).cpu().numpy()
    want = fscf.fused_psd_scf_reference(X, F, 64, 0, 5).cpu().numpy()
    assert np.abs(got - want).max() <= RTOL * np.abs(want[0, 0]).mean()
    h = torch.ones((4, N), device=dev)
    got = fpf.pfb_channelize(raw, h).cpu().numpy()
    want = fpf.pfb_channelize_reference(raw, h).cpu().numpy()
    assert err_over_mean(got, want) <= RTOL
