"""The PyTorch package's library estimators (Bartlett, Welch, scan)
against the JAX package's, on the same recorded bytes.

The port runs on the CPU, where its device step is the kernel's plain
PyTorch version; the JAX estimators run their own CPU step. Frequencies
must be equal; spectra agree within 1e-5 relative in linear power (each
side is within ~1e-6 of the float64 golden), and the port's within 1e-5
of the golden itself.
"""

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu import models as jax_models
from rtl_power_fftw_tpu.auxdata import make_window
from rtl_power_fftw_tpu_torch import models

from golden import golden_accumulate, golden_finalize

CPU = torch.device("cpu")
RTOL = 1e-5


def stream(n_bytes, seed):
    """IQ bytes of a 30 dB tone over noise (a recorded capture)."""
    rng = np.random.default_rng(seed)
    n = n_bytes // 2
    x = 30.0 * np.exp(2j * np.pi * 0.173 * np.arange(n)) + 5.0 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    iq = np.stack([np.clip(np.round(x.real + 127), 0, 255),
                   np.clip(np.round(x.imag + 127), 0, 255)], axis=-1)
    return iq.astype(np.uint8).ravel()


def assert_same_spectrum(ours, theirs, linear):
    (f_o, p_o), (f_t, p_t) = ours, theirs
    np.testing.assert_array_equal(f_o, f_t)
    if not linear:
        p_o, p_t = 10.0 ** (p_o / 10.0), 10.0 ** (p_t / 10.0)
    np.testing.assert_allclose(p_o, p_t, rtol=RTOL)


@pytest.mark.parametrize("N,repeats,window,linear", [
    (256, None, None, False), (512, 40, "hann", True),
    (1024, 9, "blackman", False), (256, 100, None, True)])
def test_bartlett_matches_jax_and_golden(N, repeats, window, linear):
    iq = stream(2 * N * 50 + 77, N)
    rate = 2_048_000
    w = None if window is None else make_window(window, N)
    kw = dict(center_freq=100_000_000, repeats=repeats, window=w,
              linear=linear)
    ours = models.bartlett_psd(iq, N, rate, device=CPU, **kw)
    theirs = jax_models.bartlett_psd(iq, N, rate, **kw)
    assert_same_spectrum(ours, theirs, linear)
    pwr, done = golden_accumulate(iq, N, repeats or 10 ** 9, window=w)
    gold = golden_finalize(pwr, done, rate, linear=linear)
    if not linear:
        gold, got = 10.0 ** (gold / 10.0), 10.0 ** (ours[1] / 10.0)
    else:
        got = ours[1]
    np.testing.assert_allclose(got, gold, rtol=RTOL)


@pytest.mark.parametrize("N,overlap,window,baseline", [
    (512, 50.0, "hann", False), (1024, 75.0, "blackman", True),
    (256, 0.0, "hann", False), (512, 50.0, None, True)])
def test_welch_matches_jax(N, overlap, window, baseline):
    iq = stream(2 * N * 30, 3 * N)
    rate = 2_000_000
    base = (np.random.default_rng(N).normal(-50.0, 1.0, N) if baseline
            else None)
    if window is None:
        window = np.ones(N, np.float32)
    kw = dict(overlap_percent=overlap, window=window, baseline=base)
    ours = models.welch_psd(iq, N, rate, device=CPU, **kw)
    theirs = jax_models.welch_psd(iq, N, rate, **kw)
    f_o, p_o = ours
    f_t, p_t = theirs
    np.testing.assert_array_equal(f_o, f_t)
    if baseline:   # dB minus baseline: compare what was subtracted from
        p_o, p_t = p_o + base, p_t + base
    np.testing.assert_allclose(10.0 ** (p_o / 10.0), 10.0 ** (p_t / 10.0),
                               rtol=RTOL)


def test_welch_rejects_bad_overlap():
    with pytest.raises(ValueError):
        models.welch_psd(np.zeros(1024, np.uint8), 64, 1_000_000,
                         overlap_percent=100.0, device=CPU)


def test_too_short_inputs_raise():
    with pytest.raises(ValueError):
        models.bartlett_psd(np.zeros(100, np.uint8), 64, 1_000_000,
                            device=CPU)


def _hop_captures(H, N, frames, seed):
    return np.stack([stream(2 * N * frames, seed + h) for h in range(H)])


@pytest.mark.parametrize("stitch", ["per-hop", "concat", "merge"])
def test_scan_matches_jax(stitch):
    N, rate = 256, 2_048_000
    hops = models.plan_hop_freqs(100_000_000, 106_000_000, rate)
    assert hops == jax_models.plan_hop_freqs(100_000_000, 106_000_000, rate)
    caps = _hop_captures(len(hops), N, 20, 40)[:, :-3]   # ragged tail
    w = make_window("hann", N)
    kw = dict(window=w, stitch=stitch)
    ours = models.scan_psd(caps, hops, N, rate, device=CPU, **kw)
    theirs = jax_models.scan_psd(caps, hops, N, rate, **kw)
    if stitch == "per-hop":
        assert len(ours) == len(theirs) == len(hops) == 3
        for o, t in zip(ours, theirs):
            assert_same_spectrum(o, t, linear=False)
    else:
        assert_same_spectrum(ours, theirs, linear=False)


def test_scan_rejects_bad_inputs():
    with pytest.raises(ValueError):
        models.scan_psd(np.zeros(512, np.uint8), [1], 64, 1, device=CPU)
    with pytest.raises(ValueError):
        models.scan_psd(np.zeros((2, 512), np.uint8), [1], 64, 1, device=CPU)
    with pytest.raises(ValueError):
        models.scan_psd(np.zeros((1, 64), np.uint8), [1], 64, 1, device=CPU)
    with pytest.raises(ValueError):
        models.scan_psd(np.zeros((1, 512), np.uint8), [1], 64, 1,
                        stitch="nope", device=CPU)


def test_step_cache_is_keyed_on_the_device():
    from rtl_power_fftw_tpu_torch.models import bartlett
    bartlett._cached_step.cache_clear()
    iq = stream(2 * 256 * 8, 1)
    models.bartlett_psd(iq, 256, 1_000_000, device=CPU)
    models.bartlett_psd(iq, 256, 1_000_000, device="cpu")
    info = bartlett._cached_step.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    step = bartlett._cached_step(256, 8, None, "auto", torch.device("cpu"))
    assert step.device == CPU and step.path == "plain"
