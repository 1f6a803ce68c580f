"""The PyTorch package's multi-stream path (``--streams``) against the JAX
package's.

The port runs on the CPU, so its multi-stream step is K4's plain PyTorch
version; the JAX side runs on the conftest's 8-device CPU mesh, with its
Pallas kernel (the streams variant K4) in interpret mode where it is
reached. Per-stream and combined partial sums are held to each other and
to a float64 transcription at 1e-5 relative, with every stream's valid
count either 0 or at least 8 frames: near-empty accumulations have deep
spectral nulls where a relative error means nothing. The CUDA kernel's
block -> (stream, frame range) arithmetic is pinned by a numpy
transcription; the kernel itself runs only on a card (chip_smoke.py, and
the test marked ``cuda``). The multi-stream engine and session tests are
ports of tests/test_sharding.py and tests/test_session_e2e.py, the
sessions compared with the JAX package's through test_torch_session's
helpers.
"""

import io
import json
import threading
import time

import numpy as np
import pytest
import torch

import rtl_power_fftw_tpu.interrupts as jax_interrupts
import rtl_power_fftw_tpu_torch.interrupts as interrupts
from rtl_power_fftw_tpu.ops.kernels import make_fused_psd_fn
from rtl_power_fftw_tpu.parallel import ShardedPsdStep as JaxShardedPsdStep
from rtl_power_fftw_tpu.parallel import make_mesh as jax_make_mesh
from rtl_power_fftw_tpu_torch.auxdata import make_window
from rtl_power_fftw_tpu_torch.config import parse_args
from rtl_power_fftw_tpu_torch.exceptions import RPFexception, TuneError
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.spectral import _SUM_CHUNK, adapt_batch
from rtl_power_fftw_tpu_torch.parallel import (MultiStreamAcquisition,
                                               ShardedPsdStep, make_mesh)
from rtl_power_fftw_tpu_torch.sources import FileSource, SyntheticSource
from rtl_power_fftw_tpu_torch.sources.registry import make_sources

from golden import golden_accumulate
from test_torch_session import (LINEAR_RTOL, TIMESTAMP,
                                assert_text_outputs_match, mask_stderr,
                                outcome, run)

CPU = torch.device("cpu")
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _reset_interrupts():
    for module in (interrupts, jax_interrupts):
        module.reset()
    yield
    for module in (interrupts, jax_interrupts):
        module.reset()


def make_streams(S, F, N, seed):
    return np.random.default_rng(seed).integers(0, 256, (S, F, 2 * N),
                                                dtype=np.uint8)


def golden_streams(raw, n_valid, window=None):
    """float64 per-stream sums of |DFT|^2 over each stream's first
    n_valid[s] frames, unshifted bins."""
    S, _, two_n = raw.shape
    out = np.zeros((S, two_n // 2))
    for s in range(S):
        part = raw[s, :max(0, min(int(n_valid[s]), raw.shape[1]))]
        z = (part[:, 0::2].astype(np.float64) - 127.0) \
            + 1j * (part[:, 1::2].astype(np.float64) - 127.0)
        if window is not None:
            z = z * np.asarray(window, np.float64)
        X = np.fft.fft(z, axis=1)
        out[s] = (X.real ** 2 + X.imag ** 2).sum(0)
    return out


def cpu_step(N, F, S, window=None):
    return ShardedPsdStep(make_mesh(CPU), N, F, streams=S, window=window)


# --- the step: K4's plain version against the JAX package ---------------


@pytest.mark.parametrize("window", [None, "hann"])
@pytest.mark.parametrize("S", [8, 16])
def test_sharded_step_matches_jax_sharded_step(S, window):
    N, F = 2048, 16
    w = None if window is None else make_window(window, N)
    raw = make_streams(S, F, N, seed=S + (window is not None))
    n_valid = np.resize(np.array([F, 8, 0, F, 12, F, 10, F], np.int32), S)
    jax_step = JaxShardedPsdStep(jax_make_mesh(8), N, F, streams=S, window=w,
                                 backend="pallas")
    assert jax_step.path == "pallas" and jax_step.takes_u16
    want_ps, want_comb = jax_step(raw.view(np.uint16), n_valid)
    want_ps = np.asarray(want_ps, np.float64)
    step = cpu_step(N, F, S, w)
    assert step.path == "plain" and step.F == F
    ps, comb = step(raw, n_valid)
    assert ps.shape == (S, N) and ps.dtype == torch.float32
    assert comb.shape == (N,) and comb.dtype == torch.float32
    ps, comb = ps.numpy(), comb.numpy()
    gold = golden_streams(raw, n_valid, w)
    live = n_valid > 0
    np.testing.assert_allclose(ps[live], want_ps[live], rtol=RTOL)
    np.testing.assert_allclose(ps[live], gold[live], rtol=RTOL)
    np.testing.assert_allclose(comb, np.asarray(want_comb), rtol=RTOL)
    np.testing.assert_allclose(comb, gold.sum(0), rtol=RTOL)
    # Streams with no valid frame ship exactly zero rows on both sides.
    assert not ps[~live].any() and not want_ps[~live].any()


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("S", [8, 16])
def test_streams_reference_matches_jax_streams_kernel(S, windowed):
    """fused_psd_streams_reference against the Pallas streams variant in
    interpret mode on tests/test_sharding.py:355-389's inputs, to its
    tolerance: streams of 1, 3 and 7 frames have deep nulls where the two
    float32 error budgets add (the float64 golden is held to the same)."""
    N, F = 2048, 16
    raw = make_streams(S, F, N, seed=5)
    nv = np.resize(np.array([F, 3, 0, F, 7, F, 1, F], np.int32), S)
    w = make_window("hann", N) if windowed else None
    fn = make_fused_psd_fn(N, F, windowed=windowed, streams=S, interpret=True)
    args = (raw.reshape(S * F, 2 * N).view(np.uint16), nv)
    want = np.asarray(fn(*args, *((w,) if windowed else ())))
    got = fp.fused_psd_streams(
        torch.from_numpy(raw), torch.from_numpy(nv), 16,
        None if w is None else torch.from_numpy(w)).numpy()
    assert got.shape == want.shape == (S, N)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(got, golden_streams(raw, nv, w), rtol=1e-4,
                               atol=1e-2)


def k4_transcription(raw, n_valid, chunk, window=None):
    """numpy transcription of K4 in csrc/fused_psd.cu and psd_sum.cuh:
    frames_per_block over all S*F frames; block g serves stream
    s = g // G_s and frames [j*group, min((j+1)*group, F, n_valid[s])) of
    it, j = g % G_s, accumulating |X|^2 in f32 into partial row g; the sum
    pass adds stream s's G_s rows per bin in float64, lane l taking rows
    l, l + 8, ..., lanes added in order. The transform itself is numpy's
    (the radix-2 form is pinned in test_torch_fused_psd.py)."""
    S, F, two_n = raw.shape
    N = two_n // 2
    group = fp.frames_per_block(S * F, chunk)
    assert F % group == 0
    G_s = F // group
    flat = raw.reshape(S * F, two_n)
    z = ((flat[:, 0::2].astype(np.float64) - 127.0)
         + 1j * (flat[:, 1::2].astype(np.float64) - 127.0))
    if window is not None:
        z = z * np.asarray(window, np.float32).astype(np.float64)
    X = np.fft.fft(z, axis=1)
    pwr = (X.real ** 2 + X.imag ** 2).astype(np.float32)
    partial = np.zeros((S * G_s, N), np.float32)
    for g in range(S * G_s):
        s, j = divmod(g, G_s)
        f0 = j * group
        f1 = min(f0 + group, min(F, int(n_valid[s])))
        for f in range(f0, f1):
            partial[g] += pwr[s * F + f]
    out = np.zeros((S, N), np.float32)
    for s in range(S):
        rows = partial[s * G_s:(s + 1) * G_s].astype(np.float64)
        lanes = [rows[lane::8].sum(0) for lane in range(8)]
        t = np.zeros(N)
        for lane_sum in lanes:
            t += lane_sum
        out[s] = t
    return out, group


@pytest.mark.parametrize("S,N,fps,n_valid,window,group", [
    (16, 64, 256, None, None, 4),            # config 5's F and block count
    (3, 256, 64, [64, 0, 5], None, 1),       # chip_smoke's uneven case
    (4, 128, 24, [24, 9, 0, 17], "hann", 1),
    (2, 64, 8192, [8192, 3000], None, 16),   # 16 frames a block
    (3, 64, 64, [-3, 70, 64], None, 1),      # counts act as their bounds
])
def test_k4_block_arithmetic_matches_plain(S, N, fps, n_valid, window,
                                           group):
    F, chunk = adapt_batch(fps)
    nv = np.full(S, F, np.int32) if n_valid is None \
        else np.asarray(n_valid, np.int32)
    raw = make_streams(S, F, N, seed=S * N + F)
    w = None if window is None else make_window(window, N)
    got, g = k4_transcription(raw, nv, chunk, w)
    assert g == group
    want = fp.fused_psd_streams_reference(
        torch.from_numpy(raw), torch.from_numpy(nv), chunk,
        None if w is None else torch.from_numpy(w)).numpy()
    gold = golden_streams(raw, nv, w)
    np.testing.assert_allclose(got, gold, rtol=RTOL)
    np.testing.assert_allclose(want, gold, rtol=RTOL)
    empty = np.clip(nv, 0, F) == 0
    assert not got[empty].any() and not want[empty].any()


def test_streams_calls_on_cpu_count_as_plain():
    counts = fp.COUNTS
    counts.reset()
    raw = torch.zeros((2, 8, 128), dtype=torch.uint8)
    nv = torch.tensor([8, 3], dtype=torch.int32)
    fp.fused_psd_streams(raw, nv, 8)
    fp.fused_psd_streams(raw, nv, 8, torch.ones(64))
    assert (counts.kernel, counts.kernel_windowed, counts.kernel_streams,
            counts.kernel_streams_windowed, counts.plain) == (0, 0, 0, 0, 2)


@pytest.mark.parametrize("make,n_valid,chunk,exc", [
    (lambda: torch.zeros((2, 8, 512), dtype=torch.int16), [8, 8], 8,
     TypeError),
    (lambda: torch.zeros((8, 512), dtype=torch.uint8), [8], 8, ValueError),
    (lambda: torch.zeros((0, 8, 512), dtype=torch.uint8), [], 8, ValueError),
    (lambda: torch.zeros((2, 8, 1000), dtype=torch.uint8), [8, 8], 8,
     ValueError),
    (lambda: torch.zeros((2, 512, 8), dtype=torch.uint8).transpose(1, 2),
     [8, 8], 8, ValueError),
    (lambda: torch.zeros((2, 8, 512), dtype=torch.uint8), [8, 8], 3,
     ValueError),
    (lambda: torch.zeros((2, 8, 512), dtype=torch.uint8), [8, 8, 8], 8,
     ValueError),
    (lambda: torch.zeros((2, 8, 512), dtype=torch.uint8), None, 8,
     ValueError),
])
def test_streams_rejects_what_the_kernel_does_not_take(make, n_valid, chunk,
                                                       exc):
    nv = torch.tensor(n_valid if n_valid is not None else [8, 8],
                      dtype=torch.int32 if n_valid is not None
                      else torch.int64)
    with pytest.raises(exc):
        fp.fused_psd_streams(make(), nv, chunk)


def test_streams_rejects_counts_off_the_frames_device():
    raw = torch.zeros((2, 8, 512), dtype=torch.uint8)
    nv = torch.tensor([8, 8], dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="n_valid on meta"):
        fp.fused_psd_streams(raw, nv, 8)


def test_sharded_step_validation():
    with pytest.raises(ValueError, match="N must be even"):
        cpu_step(63, 8, 2)
    with pytest.raises(ValueError, match="window must have shape"):
        cpu_step(1024, 8, 8, make_window("hann", 512))
    for kwargs in ({"backend": "xla"}, {"N": 500}):
        args = {"N": 1024, "backend": "auto", **kwargs}
        with pytest.raises(RPFexception, match="Not yet ported") as e:
            ShardedPsdStep(make_mesh(CPU), args["N"], 8, streams=2,
                           backend=args["backend"])
        assert int(e.value.return_value) == 3
    with pytest.raises(RPFexception, match="2 devices") as e:
        ShardedPsdStep([CPU, CPU], 256, 8, streams=2)
    assert int(e.value.return_value) == 3
    step = cpu_step(64, 8, 2)
    with pytest.raises(ValueError, match="counts in"):
        step(np.zeros((2, 8, 128), np.uint8), [9, 0])
    with pytest.raises(ValueError, match="uint8"):
        step(np.zeros((2, 16, 128), np.uint8), [8, 0])


def test_make_mesh_is_the_given_device():
    assert make_mesh("cpu") == [CPU]
    assert make_mesh(CPU) == [CPU]


@pytest.mark.cuda
def test_k4_matches_plain_on_card():
    """Runs only where a CUDA device is present (chip_smoke.py covers it
    in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    S, N, F = 4, 2048, 64
    raw = torch.from_numpy(make_streams(S, F, N, seed=11)).cuda()
    nv = torch.tensor([F, 0, 9, 40], dtype=torch.int32).cuda()
    w = torch.from_numpy(make_window("hann", N)).cuda()
    before = (fp.COUNTS.kernel_streams, fp.COUNTS.kernel_streams_windowed)
    for window in (None, w):
        got = fp.fused_psd_streams(raw, nv, 64, window)
        want = fp.fused_psd_streams_reference(raw, nv, 64, window)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5)
        assert not got[1].any()
    assert (fp.COUNTS.kernel_streams,
            fp.COUNTS.kernel_streams_windowed) == (before[0] + 1,
                                                   before[1] + 1)


# --- the engine: ports of tests/test_sharding.py's multistream tests -------


def _params(argv):
    return parse_args(argv, stderr=io.StringIO())


def _synthetic(rate, seed, tones=()):
    s = SyntheticSource(tones=list(tones), noise=5.0, seed=seed)
    s.set_sample_rate(rate)
    return s


def _golden_sum(seeds, N, repeats, rate, tones=()):
    want = np.zeros(N)
    for seed in seeds:
        src = _synthetic(rate, seed, tones)
        src.set_frequency(100_000_000)
        stream, _ = src.read(2 * N * repeats)
        pwr, _ = golden_accumulate(stream, N, repeats)
        want += np.fft.ifftshift(pwr)  # golden is pre-shifted; ours isn't
    return want


def test_multistream_acquisition_matches_sum_of_streams():
    S, N, repeats, rate = 16, 64, 12, 2_048_000
    params = _params(["-b", str(N), "-n", str(repeats), "-r", str(rate)])
    tones = [(100_200_000, 30.0)]
    sources = [_synthetic(rate, seed, tones) for seed in range(S)]
    acq = MultiStreamAcquisition(params, sources, make_mesh(CPU))
    # The default step: one buffer's frames, at least _SUM_CHUNK.
    assert acq.step.F == max(_SUM_CHUNK, min(params.buf_length // (2 * N),
                                             2048))
    res = acq.run(freq=100_000_000)
    assert res.repeats_done.tolist() == [repeats] * S
    want = _golden_sum(range(S), N, repeats, rate, tones)
    np.testing.assert_allclose(res.pwr, want, rtol=RTOL)
    np.testing.assert_allclose(res.per_stream_pwr.sum(0), want, rtol=RTOL)


def test_multistream_distinct_seeds_and_flaky_tune():
    extras = make_sources("synthetic:noise=5,seed=0", 2)
    a, b = extras
    a.set_frequency(1_000_000)
    b.set_frequency(1_000_000)
    da, _ = a.read(1000)
    db, _ = b.read(1000)
    assert not np.array_equal(da, db)

    params = _params(["-b", "64", "-n", "8"])
    # Transient failure on an extra stream: retried, acquisition succeeds.
    flaky = SyntheticSource(noise=5.0, seed=1, flaky_freqs={2_000_000: 2})
    ok = SyntheticSource(noise=5.0, seed=2)
    acq = MultiStreamAcquisition(params, [ok, flaky], make_mesh(CPU))
    assert acq.run(freq=2_000_000).repeats_done.tolist() == [8, 8]
    # Persistent failure: TuneError so the session drops the hop.
    dead = SyntheticSource(noise=5.0, seed=3, dead_freqs=[3_000_000])
    acq2 = MultiStreamAcquisition(params, [ok, dead], make_mesh(CPU))
    with pytest.raises(TuneError):
        acq2.run(freq=3_000_000)


def test_multistream_honors_welch_overlap():
    N, repeats, rate = 64, 16, 1_000_000
    params = _params(["-b", str(N), "-n", str(repeats), "-r", str(rate),
                      "--welch-overlap", "50"])
    srcs = [_synthetic(rate, s) for s in range(2)]
    acq = MultiStreamAcquisition(params, srcs, make_mesh(CPU))
    res = acq.run(freq=1_000_000)
    assert res.repeats_done.tolist() == [repeats, repeats]
    assert acq._hop == N // 2


def test_multistream_streams_incrementally():
    """At least one device step runs before the producers finish reading:
    the whole measurement is never buffered."""
    S, N, repeats, rate = 2, 64, 1024, 2_048_000
    params = _params(["-b", str(N), "-n", str(repeats), "-r", str(rate),
                      "-s", "16384"])
    srcs = [_synthetic(rate, s) for s in range(S)]
    log = []
    lock = threading.Lock()

    def wrap_read(src):
        orig = src.read

        def read(nbytes):
            out = orig(nbytes)
            with lock:
                log.append("read")
            return out
        src.read = read

    for s in srcs:
        wrap_read(s)
    acq = MultiStreamAcquisition(params, srcs, make_mesh(CPU),
                                 frames_per_step=64)

    class StepSpy:
        def __init__(self, inner):
            self._inner = inner
            self.F = inner.F

        def __call__(self, *a, **k):
            with lock:
                log.append("step")
            return self._inner(*a, **k)

    acq.step = StepSpy(acq.step)
    res = acq.run(freq=100_000_000)
    assert res.repeats_done.tolist() == [repeats] * S
    first_step = log.index("step")
    last_read = len(log) - 1 - log[::-1].index("read")
    assert first_step < last_read, (first_step, last_read)
    assert sum(acq.queue_histogram) > 0
    # One read per 16384-byte buffer.
    assert res.device_readouts == S * (2 * N * repeats) // 16384
    assert res.successful_readouts == res.device_readouts


def test_multistream_honors_strict_time():
    S, N, rate = 2, 64, 2_048_000
    params = _params(["-b", str(N), "-r", str(rate), "-s", "16384",
                      "-t", "10", "--strict-time"])
    params.repeats = 10 ** 6           # would take forever without it
    params.integration_time = 0.25     # the strict deadline under test

    class SlowSource(SyntheticSource):
        def read(self, nbytes):
            time.sleep(0.02)
            return super().read(nbytes)

    srcs = [SlowSource(noise=5.0, seed=s) for s in range(S)]
    for s in srcs:
        s.set_sample_rate(rate)
    acq = MultiStreamAcquisition(params, srcs, make_mesh(CPU),
                                 frames_per_step=64)
    t0 = time.monotonic()
    res = acq.run(freq=100_000_000)
    assert time.monotonic() - t0 < 5.0
    assert 0 < res.repeats_done.sum() < 10 ** 6


def test_multistream_stream_eof_partial(tmp_path):
    N, repeats = 64, 32
    rng = np.random.default_rng(0)
    paths = []
    for s, frames in enumerate((repeats, 10)):  # second stream is short
        p = tmp_path / f"s{s}.iq"
        p.write_bytes(rng.integers(0, 256, frames * 2 * N,
                                   dtype=np.uint8).tobytes())
        paths.append(str(p))
    params = _params(["-b", str(N), "-n", str(repeats), "-s", "16384"])
    srcs = [FileSource(p, use_native=False) for p in paths]
    acq = MultiStreamAcquisition(params, srcs, make_mesh(CPU),
                                 frames_per_step=16)
    res = acq.run(freq=1_000_000)
    assert res.stream_eof
    assert res.repeats_done.tolist() == [repeats, 10]
    want = np.zeros(N)
    for p, frames in zip(paths, (repeats, 10)):
        pwr, _ = golden_accumulate(np.fromfile(p, np.uint8), N, frames)
        want += np.fft.ifftshift(pwr)
    np.testing.assert_allclose(res.pwr, want, rtol=RTOL)


def test_multistream_slow_stream_isolation():
    """One stalled stream must not throttle the fast producers. The gate
    is event causality, not wall-clock: the slow stream's reads block
    until every fast stream has completed all of its reads, which happens
    only if the consumer ships fast-only partial rounds (a lockstep
    regression wedges the fast producers on their bounded queues, depth
    4 < 8 batches, and the watchdog records the violation)."""
    S, N, rate = 4, 64, 2_048_000
    repeats = 1024                      # 8 reads (= 8 batches) per stream
    params = _params(["-b", str(N), "-n", str(repeats), "-r", str(rate),
                      "-s", "16384"])
    fast_all_done = threading.Event()
    reads_left = [8] * 3
    reads_lock = threading.Lock()
    violation = []

    class Fast(SyntheticSource):
        def __init__(self, idx, **kw):
            super().__init__(**kw)
            self._idx = idx

        def read(self, nbytes):
            out = super().read(nbytes)
            with reads_lock:
                reads_left[self._idx] -= 1
                if not any(reads_left):
                    fast_all_done.set()
            return out

    class Stalled(SyntheticSource):
        def read(self, nbytes):
            # A watchdog, not a pacing constant: it fires only if the
            # isolation contract is broken.
            if not fast_all_done.wait(timeout=120.0):
                violation.append("slow stream unblocked by watchdog, not "
                                 "by fast-stream completion")
            return super().read(nbytes)

    srcs = [Fast(i, noise=5.0, seed=i) for i in range(3)]
    srcs.append(Stalled(noise=5.0, seed=3))
    for s in srcs:
        s.set_sample_rate(rate)
    acq = MultiStreamAcquisition(params, srcs, make_mesh(CPU),
                                 frames_per_step=128)
    acq.step(np.zeros((S, acq.step.F, 2 * N), np.uint8), np.zeros(S, np.int32))
    res = acq.run(freq=100_000_000)

    assert not violation, violation
    assert fast_all_done.is_set()
    assert res.repeats_done.tolist() == [repeats] * S
    # Numerical identity is independent of round composition.
    np.testing.assert_allclose(res.pwr, _golden_sum(range(S), N, repeats,
                                                    rate), rtol=RTOL)


def test_multistream_phase_offset_streams_coalesce():
    """Same-rate streams whose batches arrive phase-offset by more than
    the jitter floor still coalesce into (mostly) full rounds: the
    straggler window adapts to the measured batch cadence."""
    S, N, rate = 4, 64, 2_048_000
    repeats = 1024                      # 8 batches per stream, 32 total
    params = _params(["-b", str(N), "-n", str(repeats), "-r", str(rate),
                      "-s", "16384"])

    class Phased(SyntheticSource):
        def __init__(self, phase, cadence, **kw):
            super().__init__(**kw)
            self._phase, self._cadence = phase, cadence
            self._first = True

        def read(self, nbytes):
            if self._first:
                self._first = False
                time.sleep(self._phase)
            time.sleep(self._cadence)
            return super().read(nbytes)

    srcs = [Phased(i * 0.015, 0.06, noise=5.0, seed=i) for i in range(S)]
    for s in srcs:
        s.set_sample_rate(rate)
    acq = MultiStreamAcquisition(params, srcs, make_mesh(CPU),
                                 frames_per_step=128)
    calls = []

    class CountingStep:
        def __init__(self, inner):
            self._inner = inner

        def __call__(self, *a, **kw):
            calls.append(1)
            return self._inner(*a, **kw)

        def __getattr__(self, name):
            return getattr(self._inner, name)

    acq.step = CountingStep(acq.step)
    res = acq.run(freq=100_000_000)
    assert res.repeats_done.tolist() == [repeats] * S
    # 32 batches: ideally 8 coalesced rounds, fully fragmented 32.
    assert len(calls) <= 20, len(calls)


# --- sessions: ports of tests/test_session_e2e.py's --streams tests -----


def _file_source(tmp, n_bytes):
    p = tmp / "stream.iq"
    np.random.default_rng(8).integers(0, 256, n_bytes, dtype=np.uint8) \
        .tofile(p)
    return f"file:{p}"


STREAM_SCENARIOS = {
    "8 streams": lambda tmp: [
        "-f", "100M", "-n", "16", "-b", "64", "--streams", "8",
        "--source", "synthetic:tone=100.1M/30,noise=5,seed=0"],
    "welch overlap": lambda tmp: [
        "-f", "1M", "-n", "12", "-b", "64", "--streams", "4",
        "--welch-overlap", "50", "--source", "synthetic:noise=5,seed=71"],
    "hann hops": lambda tmp: [
        "-f", "100M:103M", "-n", "8", "-b", "256", "--streams", "3",
        "--window-function", "hann",
        "--source", "synthetic:tone=101.5M/30,noise=5,seed=6"],
    "dead hop, quiet": lambda tmp: [
        "-f", "100M:106M", "-n", "16", "-b", "256", "-q", "--streams", "2",
        "--source", "synthetic:tone=104.9M/40,noise=5,seed=2,dead=103M"],
    "dropped samples": lambda tmp: [
        "-f", "100M", "-n", "40", "-b", "256", "-s", "16384",
        "--streams", "2",
        "--source", "synthetic:tone=100.1M/30,noise=5,seed=4,drop_every=2"],
    "stream ends mid-spectrum": lambda tmp: [
        "-f", "100M", "-n", "100", "-b", "256", "--streams", "2",
        "--source", _file_source(tmp, 2 * 256 * 30 + 100)],
    "stream too short": lambda tmp: [
        "-f", "100M", "-n", "10", "-b", "256", "--streams", "2",
        "--source", _file_source(tmp, 300)],
    "precision high warns": lambda tmp: [
        "-f", "100M", "-n", "16", "-b", "512", "--streams", "2",
        "--precision", "high",
        "--source", "synthetic:tone=100.3M/35,noise=5,seed=14"],
}


@pytest.mark.parametrize("name", sorted(STREAM_SCENARIOS))
def test_streams_scenario_matches_jax_session(name, tmp_path):
    argv = STREAM_SCENARIOS[name](tmp_path) + ["--frames-per-step", "16"]
    res_j, out_j, err_j = outcome(argv, port=False)
    res_p, out_p, err_p = outcome(argv, port=True)
    assert res_p == res_j
    n_values = assert_text_outputs_match(out_j, out_p, rtol=LINEAR_RTOL)
    assert n_values > 0 or isinstance(res_j, tuple)
    assert err_p == err_j
    if not isinstance(res_j, tuple):
        streams = argv[argv.index("--streams") + 1]
        assert f"Parallel streams: {streams} (mesh size M)" in err_p


def test_streams_session_prints_mesh_size_one():
    rv, _, err = run(STREAM_SCENARIOS["8 streams"](None), port=True)
    assert rv == 0
    assert "Parallel streams: 8 (mesh size 1)" in err
    assert "Transform path: plain (backend=auto, N=64)" in err
    assert "Actual number of averaged spectra: 128" in err  # 8 x 16


def test_streams_matrix_mode_matches_jax_session(tmp_path):
    outs = {}
    for port in (False, True):
        stem = str(tmp_path / ("port" if port else "jax"))
        rv, out, err = run(STREAM_SCENARIOS["dead hop, quiet"](tmp_path)
                           + ["-m", stem, "--frames-per-step", "16"],
                           port=port)
        assert rv == 0
        assert "Unable to tune to 103000000. Dropping from frequency list." \
            in err
        with open(stem + ".met") as f:
            met = f.read().split("\n")
        outs[port] = (out, mask_stderr(err), met,
                      np.fromfile(stem + ".bin", dtype=np.float32))
    (out_j, err_j, met_j, bin_j), (out_p, err_p, met_p, bin_p) = \
        outs[False], outs[True]
    assert out_j == out_p
    assert err_j == err_p
    # avgScanDur (line 7) is derived from the second-resolution timestamps.
    assert [TIMESTAMP.sub("<t>", m) for i, m in enumerate(met_j) if i != 6] \
        == [TIMESTAMP.sub("<t>", m) for i, m in enumerate(met_p) if i != 6]
    assert met_p[0] == "512 # frequency bins (columns)"
    assert bin_j.shape == bin_p.shape == (512,)
    np.testing.assert_allclose(10.0 ** (bin_p / 10.0), 10.0 ** (bin_j / 10.0),
                               rtol=LINEAR_RTOL)


def test_streams_record_files_match_jax_session(tmp_path):
    argv = ["-f", "1M", "-n", "8", "-b", "64", "--streams", "2",
            "--source", "synthetic:noise=5,seed=91"]
    files = {}
    for port in (False, True):
        rec = tmp_path / ("port" if port else "jax") / "cap.iq"
        rec.parent.mkdir()
        rv, _, err = run(argv + ["--record", str(rec)], port=port)
        assert rv == 0
        assert f"Recording raw IQ to {rec}.s0..s1" in err
        files[port] = [(rec.parent / f"cap.iq.s{i}").read_bytes()
                       for i in range(2)]
    assert files[True] == files[False]
    assert all(len(b) >= 2 * 64 * 8 for b in files[True])
    assert files[True][0] != files[True][1]


def test_streams_stats_json_matches_jax_session(tmp_path):
    argv = STREAM_SCENARIOS["dead hop, quiet"](tmp_path) \
        + ["--frames-per-step", "16"]
    records = {}
    for port in (False, True):
        stats = tmp_path / f"{'port' if port else 'jax'}.jsonl"
        rv, _, _ = run(argv + ["--stats-json", str(stats)], port=port)
        assert rv == 0
        records[port] = [json.loads(line)
                         for line in stats.read_text().splitlines()]

    def masked(rec):
        rec = dict(rec)
        # Which bucket a hand-off lands in depends on thread timing; the
        # bucket count and the number of hand-offs do not.
        hist = rec.pop("queue_histogram")
        return ({k: TIMESTAMP.sub("<t>", v) if isinstance(v, str) else v
                 for k, v in rec.items() if k != "transform_path"},
                len(hist), sum(hist))

    assert [masked(r) for r in records[True]] \
        == [masked(r) for r in records[False]]
    assert [r["tuned_freq"] for r in records[True]] \
        == [101_000_000, 105_000_000]
    assert all(r["transform_path"] == "plain" and r["repeats_done"] == 32
               and r["device_readouts"] > 0 for r in records[True])
