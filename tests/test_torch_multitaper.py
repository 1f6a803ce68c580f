"""The multitaper estimator of the PyTorch package against the JAX
package's (``--multitaper``, ``--time-bandwidth``, ``multitaper_psd``), on
the CPU, where the port's step is the kernel's plain PyTorch version.

Twins of tests/test_multitaper_session.py:29, 62, 92 and 153 and of
tests/test_models.py's multitaper case, at N = 64 and 256: the step
against float64 and the JAX step, the CLI's checks, whole sessions
against the JAX session, the library function. The kernel
(csrc/fused_psd_tapers.cu) runs only on a card; its grid's (g, k) ->
partial-row map is transcribed in numpy here.
"""

import io

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu.models import multitaper as jax_mt
from rtl_power_fftw_tpu_torch.config import parse_args
from rtl_power_fftw_tpu_torch.exceptions import RPFexception
from rtl_power_fftw_tpu_torch.models import bartlett_psd, multitaper
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_tapers as fmt
from rtl_power_fftw_tpu_torch.ops.spectral import adapt_batch

from test_torch_fused_psd_regs import h100_resident
from test_torch_session import assert_text_outputs_match, mask_stderr, run

CPU = torch.device("cpu")


def direct_mt(raw, N, K, NW=4.0):
    """float64 session-semantics multitaper: per frame, the mean of the K
    eigenspectra under the session's tapers (unit energy × √N)."""
    t = multitaper._session_tapers(N, NW, K).astype(np.float64)
    z = ((raw[:, 0::2].astype(np.float64) - 127.0)
         + 1j * (raw[:, 1::2].astype(np.float64) - 127.0))
    p = np.abs(np.fft.fft(z[:, None, :] * t[None], axis=-1)) ** 2
    return p.mean(axis=1).sum(axis=0)


def frames(F, N, seed):
    return np.random.default_rng(seed).integers(0, 256, (F, 2 * N),
                                                dtype=np.uint8)


def test_dpss_and_session_tapers_are_the_jax_packages():
    for N, NW, K in ((64, 4.0, 7), (256, 2.5, 3), (2048, 4.0, 7)):
        np.testing.assert_array_equal(multitaper.dpss_tapers(N, NW, K),
                                      jax_mt.dpss_tapers(N, NW, K))
        np.testing.assert_array_equal(multitaper._session_tapers(N, NW, K),
                                      jax_mt._session_tapers(N, NW, K))


@pytest.mark.parametrize("N,K", [(64, 4), (256, 1), (256, 7)])
def test_multitaper_step_matches_direct_and_jax(N, K):
    F = 8
    step = multitaper.MultitaperSessionStep(N, F, K=K, device=CPU)
    jstep = jax_mt.MultitaperSessionStep(N, F, K=K)
    assert step.path == "plain_multitaper" and not step.takes_u16
    raw = frames(2 * F + 3, N, 3)
    got = np.zeros(N)
    jax_got = np.zeros(N)
    for lo in range(0, len(raw), F):
        batch = raw[lo:lo + F]
        padded = np.zeros((F, 2 * N), np.uint8)
        padded[:len(batch)] = batch
        got += step(padded, len(batch)).numpy()
        jax_got += np.asarray(jstep(padded, len(batch)), np.float64)
    np.testing.assert_allclose(got, direct_mt(raw, N, K), rtol=1e-5)
    np.testing.assert_allclose(got, jax_got, rtol=2e-5)


def test_multitaper_cli_validation():
    """tests/test_multitaper_session.py:62 on the port's parser."""
    with pytest.raises(RPFexception):
        parse_args(["-f", "100M", "--multitaper", "33"])
    with pytest.raises(RPFexception):
        parse_args(["-f", "100M", "-b", "16", "--multitaper", "17"])
    with pytest.raises(RPFexception):
        parse_args(["-f", "100M", "--multitaper", "4",
                    "--time-bandwidth", "0.5"])
    for bad in (["--welch-overlap", "50"], ["--pfb-taps", "4"],
                ["--window-function", "hann"], ["-w", "win.txt"],
                ["--shard-transform"]):
        argv = ["-f", "100M", "-n", "8", "--multitaper", "4"] + bad
        if "--shard-transform" in bad:
            argv += ["-b", "1024"]
        with pytest.raises(RPFexception):
            parse_args(argv, stderr=io.StringIO())
    err = io.StringIO()
    p = parse_args(["-f", "100M", "--multitaper", "8",
                    "--fft-backend", "pallas"], stderr=err)
    assert p.multitaper == 8
    assert "well concentrated" in err.getvalue()
    assert "--fft-backend" in err.getvalue()
    err2 = io.StringIO()
    parse_args(["-f", "100M", "--time-bandwidth", "3"], stderr=err2)
    assert "no effect" in err2.getvalue()


def test_multitaper_nw_bound_is_typed_error():
    for argv in (["-f", "100M", "-b", "16", "--multitaper", "2",
                  "--time-bandwidth", "10"],
                 ["-f", "100M", "-b", "4", "--multitaper", "2"]):
        with pytest.raises(RPFexception):
            parse_args(argv, stderr=io.StringIO())
    with pytest.raises(RPFexception, match="Exiting"):
        multitaper._session_tapers(64, 40.0, 2)


@pytest.mark.parametrize("N", [32, 500, 32768])
def test_multitaper_step_refuses_sizes_its_kernel_does_not_take(N):
    with pytest.raises(RPFexception,
                       match=f"Not yet ported.*--multitaper at {N} bins"):
        multitaper.MultitaperSessionStep(N, 8, K=2, NW=2.0, device=CPU)


@pytest.mark.parametrize("extra", [["--multitaper", "4"],
                                   ["--multitaper", "7", "-l"],
                                   ["--multitaper", "2",
                                    "--time-bandwidth", "2", "--precision",
                                    "high"]])
def test_multitaper_session_matches_jax_session(extra):
    argv = ["-f", "100M", "-n", "32", "-b", "128", "--frames-per-step", "16",
            "--source", "synthetic:tone=100.2M/35,noise=6,seed=1"] + extra
    rv_j, out_j, err_j = run(argv, port=False)
    rv_p, out_p, err_p = run(argv, port=True)
    assert int(rv_j) == int(rv_p) == 0
    assert assert_text_outputs_match(out_j, out_p, linear="-l" in extra)
    assert mask_stderr(err_j) == mask_stderr(err_p)
    line = [x for x in err_p.split("\n") if x.startswith("Transform path:")]
    assert line == ["Transform path: plain_multitaper (N=128)"]
    if extra != ["--multitaper", "4"]:
        return
    # tests/test_multitaper_session.py:92's peak check (K = 4).
    vals = np.array([float(x.split()[1]) for x in out_p.split("\n")
                     if x and not x.startswith("#")])
    freqs = np.array([float(x.split()[0]) for x in out_p.split("\n")
                      if x and not x.startswith("#")])
    assert abs(freqs[vals.argmax()] - 100_200_000) < 2_048_000 / 128


def test_multitaper_matrix_scan_matches_jax(tmp_path):
    argv = ["-f", "100M:104M", "-n", "16", "-b", "256", "-q",
            "--multitaper", "3", "--time-bandwidth", "2",
            "--source", "synthetic:tone=101.1M/35,noise=6,seed=2"]
    mets, bins = [], []
    for port in (False, True):
        stem = tmp_path / ("port" if port else "jax")
        rv, out, _ = run(argv + ["-m", str(stem)], port=port)
        assert int(rv) == 0
        mets.append([m for i, m in enumerate(
            (tmp_path / (stem.name + ".met")).read_text().split("\n"))
            if i not in (6, 7, 8)])
        bins.append(np.fromfile(str(stem) + ".bin", dtype=np.float32))
    assert mets[0] == mets[1]
    np.testing.assert_allclose(10.0 ** (bins[1] / 10.0),
                               10.0 ** (bins[0] / 10.0), rtol=1e-5)


def test_multitaper_psd_matches_jax_and_bartlett_level():
    """tests/test_models.py:139: on white noise the multitaper PSD agrees
    with the Bartlett PSD in level, with lower variance; and with the JAX
    package's multitaper_psd."""
    rate, N, M = 1_000_000, 128, 64
    iq = np.random.default_rng(34).integers(0, 256, 2 * N * M,
                                            dtype=np.uint8)
    f_mt, mt = multitaper.multitaper_psd(iq, N, rate, NW=3.0, linear=True,
                                         device=CPU)
    jf, jmt = jax_mt.multitaper_psd(iq, N, rate, NW=3.0, linear=True)
    np.testing.assert_array_equal(f_mt, jf)
    np.testing.assert_allclose(mt, jmt, rtol=2e-5)
    _, b = bartlett_psd(iq, N, rate, linear=True, device=CPU)
    assert abs(np.mean(mt) / np.mean(b) - 1.0) < 0.05
    assert np.var(mt / np.mean(mt)) < np.var(b / np.mean(b))
    _, db = multitaper.multitaper_psd(iq, N, rate, NW=3.0, K=2, device=CPU)
    _, jdb = jax_mt.multitaper_psd(iq, N, rate, NW=3.0, K=2)
    np.testing.assert_allclose(db, jdb, atol=1e-4)
    with pytest.raises(ValueError, match="single FFT frame"):
        multitaper.multitaper_psd(iq[:2 * N - 2], N, rate, device=CPU)


# --- the kernel's index arithmetic, transcribed ---

def tapers_transcription(raw, n_valid, chunk, tapers):
    """The kernel's grid in float64: block (g, k) takes frames [g * group,
    min((g + 1) * group, F, n_valid)) under taper k (tapers_group over
    K2's resident blocks on an H100) and writes partial row k * G + g
    (csrc/fused_psd_regs.cuh, kRegsTapers); the sum over all K * G rows,
    lane l of 8 taking
    rows l, l + 8, ..., is divided by K. Returns it and the rows each
    block wrote."""
    F, N = raw.shape[0], raw.shape[1] // 2
    K = tapers.shape[0]
    group = fmt.tapers_group(F, chunk, K, h100_resident(N, True))
    G = -(-F // group)
    z = ((raw[:, 0::2].astype(np.float64) - 127.0)
         + 1j * (raw[:, 1::2].astype(np.float64) - 127.0))
    partial = np.full((K * G, N), np.nan)
    for k in range(K):
        for g in range(G):
            f = np.arange(g * group, min((g + 1) * group, F, n_valid))
            x = z[f] * tapers[k].astype(np.float64)
            row = k * G + g
            assert np.isnan(partial[row]).all()
            partial[row] = (np.abs(np.fft.fft(x, axis=-1)) ** 2).sum(0)
    total = sum(partial[lane::8].sum(0) for lane in range(8))
    return total / K, partial


@pytest.mark.parametrize("N,F,n_valid,K", [(64, 64, 64, 1), (256, 512, 300, 7),
                                           (256, 4096, 4096, 4),
                                           (64, 8, 5, 32)])
def test_tapers_grid_covers_every_frame_and_taper_once(N, F, n_valid, K):
    chunk = adapt_batch(F)[1]
    tp = multitaper._session_tapers(N, 2.0, K) if K <= 3 else \
        multitaper._session_tapers(N, 4.0 if N > 64 else 2.0, min(K, 7))
    tp = np.resize(tp, (K, N)).astype(np.float32)
    raw = frames(F, N, 5)
    got, partial = tapers_transcription(raw, n_valid, chunk, tp)
    assert not np.isnan(partial).any()
    G = partial.shape[0] // K
    # The grid is about one wave of K2's resident blocks.
    assert K * G <= max(h100_resident(N, True), K * -(-F // chunk))
    plain = fmt.fused_psd_tapers_reference(
        torch.from_numpy(raw), n_valid, chunk, torch.from_numpy(tp)).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5)


def test_tapers_wrapper_checks_and_counts_on_the_cpu():
    fp.COUNTS.reset()
    raw = torch.from_numpy(frames(8, 64, 1))
    tp = torch.ones((2, 64))
    out = fmt.fused_psd_tapers(raw, 8, 8, tp)
    np.testing.assert_allclose(out.numpy(), fp.fused_psd_reference(
        raw, 8, 8).numpy(), rtol=1e-6)
    assert (fp.COUNTS.kernel_tapers, fp.COUNTS.plain) == (0, 1)
    for bad in (torch.ones((0, 64)), torch.ones((33, 64)),
                torch.ones((2, 32)), torch.ones((2, 64), dtype=torch.float64)):
        with pytest.raises(ValueError, match="tapers"):
            fmt.fused_psd_tapers(raw, 8, 8, bad)
    fp.COUNTS.reset()


@pytest.mark.cuda
def test_tapers_kernel_on_card():
    """Runs only where a CUDA device is present (chip_smoke.py phase 14
    covers it in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    N, F, K = 2048, 64, 7
    raw = torch.from_numpy(frames(F, N, 11)).cuda()
    tp = torch.from_numpy(multitaper._session_tapers(N, 4.0, K)).cuda()
    got = fmt.fused_psd_tapers(raw, 50, 64, tp)
    want = fmt.fused_psd_tapers_reference(raw, 50, 64, tp)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5)
