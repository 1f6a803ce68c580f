"""The PyTorch package's copied host helpers, PsdStep and Datastore,
each against the JAX package's original on the same inputs."""

import io

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu.ops import spectral as jax_spectral
from rtl_power_fftw_tpu.pipeline import datastore as jax_datastore
from rtl_power_fftw_tpu_torch.auxdata import make_window
from rtl_power_fftw_tpu_torch.config import parse_args
from rtl_power_fftw_tpu_torch.exceptions import ReturnValue, RPFexception
from rtl_power_fftw_tpu_torch.ops import spectral
from rtl_power_fftw_tpu_torch.pipeline import datastore

from golden import golden_accumulate

CPU = torch.device("cpu")


@pytest.mark.parametrize("fps", [0, 1, 7, 8, 16, 24, 100, 400, 1600, 3200,
                                 4096, 4100])
def test_adapt_batch(fps):
    assert spectral.adapt_batch(fps) == jax_spectral.adapt_batch(fps)


@pytest.mark.parametrize("n", [0, 3, 8, 11])
def test_pad_frames(n):
    batch = np.random.default_rng(n).integers(0, 256, (n, 16), dtype=np.uint8)
    np.testing.assert_array_equal(spectral.pad_frames(batch, 8),
                                  jax_spectral.pad_frames(batch, 8))


@pytest.mark.parametrize("hop", [None, 6, 16])
def test_frame_slicer(hop):
    N = 16
    rng = np.random.default_rng(5)
    ours, theirs = spectral.FrameSlicer(N, hop), jax_spectral.FrameSlicer(N, hop)
    for size, cap in [(10, None), (70, None), (33, 2), (200, None),
                      (64, 0), (90, 5)]:
        data = rng.integers(0, 256, size, dtype=np.uint8)
        np.testing.assert_array_equal(ours.push(data, cap),
                                      theirs.push(data, cap))
        np.testing.assert_array_equal(ours._carry, theirs._carry)
    ours.reset()
    assert len(ours._carry) == 0


def test_bin_frequencies():
    np.testing.assert_array_equal(
        spectral.bin_frequencies(100_000_000, 512, 2_048_000),
        jax_spectral.bin_frequencies(100_000_000, 512, 2_048_000))


@pytest.mark.parametrize("linear,baseline,shifted", [
    (False, False, False), (True, False, False), (False, True, False),
    (False, False, True)])
def test_finalize_psd(linear, baseline, shifted):
    rng = np.random.default_rng(9)
    pwr = rng.uniform(1.0, 1e6, 64)
    base = rng.normal(0, 3, 64) if baseline else None
    args = (pwr, 37, 2_048_000)
    kw = dict(linear=linear, baseline=base, already_shifted=shifted)
    np.testing.assert_array_equal(spectral.finalize_psd(*args, **kw),
                                  jax_spectral.finalize_psd(*args, **kw))


@pytest.mark.parametrize("N,overlap,repeats", [(512, 0.0, 50), (512, 50.0, 50),
                                               (256, 12.5, 1), (256, 75.0, 0)])
def test_datastore_helpers(N, overlap, repeats):
    hop = datastore.welch_hop(N, overlap)
    assert hop == jax_datastore.welch_hop(N, overlap)
    assert (datastore.stream_bytes_needed(N, hop, repeats)
            == jax_datastore.stream_bytes_needed(N, hop, repeats))
    assert (datastore.unique_complex_samples(N, hop, repeats)
            == jax_datastore.unique_complex_samples(N, hop, repeats))


def test_print_queue_histogram():
    ours, theirs = io.StringIO(), io.StringIO()
    datastore.print_queue_histogram([0, 1, 12, 3], ours)
    jax_datastore.print_queue_histogram([0, 1, 12, 3], theirs)
    assert ours.getvalue() == theirs.getvalue()


@pytest.mark.parametrize("N,F,n_valid", [(512, 40, 40), (512, 40, 33),
                                         (256, 16, 0)])
def test_psd_step_matches_jax_step_and_golden(N, F, n_valid):
    raw = np.random.default_rng(N + n_valid).integers(0, 256, (F, 2 * N),
                                                      dtype=np.uint8)
    step = spectral.PsdStep(N, F, CPU)
    assert (step.F, step.path, step.takes_u16) == (F, "plain", False)
    got = step(raw, n_valid)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    want = np.asarray(jax_spectral.PsdStep(N, F, backend="pallas")(raw, n_valid),
                      np.float64)
    gold, _ = golden_accumulate(raw[:n_valid].ravel(), N, n_valid)
    gold = np.fft.ifftshift(gold)
    if n_valid == 0:
        assert not got.any() and not want.any()
        return
    np.testing.assert_allclose(got.numpy(), gold, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)


@pytest.mark.parametrize("kwargs,what", [
    (dict(window=np.ones(512, np.float32), backend="fourstep"),
     "--fft-backend fourstep"),
    (dict(N=128, precision="high"), "--precision high at 128 bins"),
    (dict(backend="matmul"), "--fft-backend matmul"),
    (dict(N=4194302), "4194302 bins"),
    (dict(N=1 << 23), "8388608 bins"),
])
def test_psd_step_rejects_unported(kwargs, what):
    args = dict(N=512, frames_per_step=16, device=CPU)
    args.update(kwargs)
    with pytest.raises(RPFexception) as e:
        spectral.PsdStep(**args)
    assert e.value.return_value == ReturnValue.InvalidArgument
    assert "Not yet ported" in str(e.value) and what in str(e.value)


@pytest.mark.parametrize("N,F,n_valid,window,precision", [
    (512, 40, 33, "hann", "highest"), (256, 16, 16, "blackman", "highest"),
    (512, 40, 40, None, "high"), (1024, 16, 9, "hann", "high")])
def test_psd_step_routes_window_and_precision(N, F, n_valid, window,
                                              precision):
    """The port's step at a window and precision against the JAX
    package's Pallas step at the same options, and the golden."""
    raw = np.random.default_rng(N + F).integers(0, 256, (F, 2 * N),
                                                dtype=np.uint8)
    w = None if window is None else make_window(window, N)
    step = spectral.PsdStep(N, F, CPU, window=w, precision=precision)
    fast = precision == "high"
    assert step.path == ("plain_fast" if fast else "plain")
    assert step.window is None or (step.window.dtype == torch.float32
                                   and step.window.device == CPU)
    got = step(raw, n_valid).numpy()
    want = np.asarray(jax_spectral.PsdStep(N, F, window=w, backend="pallas",
                                           precision=precision)(raw, n_valid),
                      np.float64)
    gold, _ = golden_accumulate(raw[:n_valid].ravel(), N, n_valid, window=w)
    # --precision high: both run the fast scheme at different splits.
    rtol = 1e-4 if fast else 1e-5
    np.testing.assert_allclose(got, np.fft.ifftshift(gold), rtol=rtol)
    np.testing.assert_allclose(got, want, rtol=2 * rtol)


def test_psd_step_rejects_a_window_of_the_wrong_length():
    with pytest.raises(ValueError):
        spectral.PsdStep(512, 16, CPU, window=np.ones(256, np.float32))


def test_datastore_passes_the_window_to_its_step():
    N, repeats = 256, 20
    params = parse_args(["-b", str(N), "-n", str(repeats),
                         "--frames-per-step", "8", "--welch-overlap", "50"],
                        stderr=io.StringIO())
    w = make_window("hann", N)
    ds = datastore.Datastore(params, CPU, window=w, max_in_flight=2)
    stream = np.random.default_rng(6).integers(0, 256, 2 * N * repeats,
                                               dtype=np.uint8)
    ds.begin_acquisition()
    ds.acquire_slot()
    ds.push_buffer(stream)
    result = ds.finish_acquisition()
    assert result.repeats_done == repeats
    hop = N // 2
    want = np.zeros(N)
    for f in range(repeats):
        seg = stream[2 * hop * f:2 * hop * f + 2 * N]
        p, _ = golden_accumulate(seg, N, 1, window=w)
        want += p
    np.testing.assert_allclose(result.pwr, np.fft.ifftshift(want), rtol=1e-5)


def test_datastore_carries_frames_and_caps_repeats():
    """Odd-sized buffers, a partial last batch and the repeats cap: the
    accumulated spectrum is the golden's over exactly ``repeats`` frames."""
    N, repeats = 256, 37
    params = parse_args(["-b", str(N), "-n", str(repeats),
                         "--frames-per-step", "8"], stderr=io.StringIO())
    ds = datastore.Datastore(params, CPU, max_in_flight=2)
    stream = np.random.default_rng(3).integers(0, 256, 2 * N * (repeats + 5),
                                               dtype=np.uint8)
    ds.begin_acquisition()
    pos = 0
    for size in (100, 2 * N * 3 + 7, 5000, 9000, len(stream)):
        ds.acquire_slot()
        ds.push_buffer(stream[pos:pos + size])
        pos += size
    result = ds.finish_acquisition()
    assert result.repeats_done == repeats == ds.repeats_done
    gold, _ = golden_accumulate(stream, N, repeats)
    np.testing.assert_allclose(result.pwr, np.fft.ifftshift(gold), rtol=1e-5)
    assert sum(ds.queue_histogram) == 5


def test_datastore_surfaces_consumer_errors():
    params = parse_args(["-b", "256", "-n", "8"], stderr=io.StringIO())
    ds = datastore.Datastore(params, CPU)

    class Broken:
        F = ds.step.F

        def __call__(self, raw, n_valid):
            raise RuntimeError("device step failed")

    ds.step = Broken()
    ds.begin_acquisition()
    ds.push_buffer(np.zeros(2 * 256 * 8, np.uint8))
    with pytest.raises(RuntimeError, match="device step failed"):
        ds.finish_acquisition()
