"""The spectral-kurtosis estimator of the PyTorch package against the JAX
package's (``--sk-file``, ``--sk-excise``, ``spectral_kurtosis``), on the
CPU, where the port's step is the kernel's plain PyTorch version.

Twins of tests/test_sk_session.py (its single-stream cases) and of
tests/test_models.py's spectral-kurtosis case, at N = 64 and 256: steps
against float64 and against the JAX step, s1 bit for bit the plain PSD
step's, the excision gate's decisions, whole sessions (text, SK file,
stderr, ``--stats-json``) against the JAX session. The kernel
(csrc/fused_psd_sk.cu) runs only on a card; its index arithmetic (the two
planes of partial rows on K1's grid, the float64 row sum, the gate
epilogue) is transcribed in numpy here.
"""

import io
import json
import re

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu.auxdata import make_window
from rtl_power_fftw_tpu.models import kurtosis as jax_kurtosis
from rtl_power_fftw_tpu_torch.config import parse_args
from rtl_power_fftw_tpu_torch.exceptions import RPFexception
from rtl_power_fftw_tpu_torch.models import kurtosis
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_sk as fsk
from rtl_power_fftw_tpu_torch.ops.spectral import PsdStep, adapt_batch

from test_torch_fused_psd_regs import (MIN_THREADS, h100_resident,
                                       header_w16, transform)
from test_torch_session import (assert_text_outputs_match, mask_stderr, run,
                                TIMESTAMP)

CPU = torch.device("cpu")
RATE = 2_048_000


def direct_moments(raw, window=None):
    """float64 moments over every frame: Σ|X|², Σ|X|⁴."""
    z = ((raw[:, 0::2].astype(np.float64) - 127.0)
         + 1j * (raw[:, 1::2].astype(np.float64) - 127.0))
    if window is not None:
        z = z * np.asarray(window, np.float64)
    p = np.abs(np.fft.fft(z, axis=-1)) ** 2
    return p.sum(0), (p * p).sum(0)


def frames(F, N, seed):
    return np.random.default_rng(seed).integers(0, 256, (F, 2 * N),
                                                dtype=np.uint8)


def padded_batches(raw, F):
    for lo in range(0, len(raw), F):
        batch = raw[lo:lo + F]
        out = np.zeros((F, raw.shape[1]), np.uint8)
        out[:len(batch)] = batch
        yield out, len(batch)


# --- the step ---

@pytest.mark.parametrize("N,wname", [(64, None), (256, None), (64, "hann"),
                                     (256, "blackman")])
def test_sk_step_matches_direct_and_jax(N, wname):
    F = 8
    w = None if wname is None else make_window(wname, N)
    step = kurtosis.SkSessionStep(N, F, CPU, window=w)
    jstep = jax_kurtosis.SkSessionStep(N, F, window=w)
    assert step.fields == jstep.fields == ("s1", "s2")
    assert step.path == "plain_sk" and not step.takes_u16
    raw = frames(2 * F + 5, N, 11)
    got = np.zeros((2, N))
    jax_got = np.zeros((2, N))
    for batch, nv in padded_batches(raw, F):
        got += np.stack([t.numpy() for t in step(batch, nv)])
        jax_got += np.stack([np.asarray(a, np.float64)
                             for a in jstep(batch, nv)])
    want = direct_moments(raw, w)
    for i in range(2):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5)
        np.testing.assert_allclose(got[i], jax_got[i], rtol=2e-5)


@pytest.mark.parametrize("N,n_valid,window", [(64, 5, None), (256, 8, None),
                                              (256, 3, "hann")])
def test_sk_s1_bit_identical_to_plain_psd_step(N, n_valid, window):
    """The sidecar leaves the averaged spectrum as it is: s1 is the plain
    PsdStep's partial bit for bit (on the card, K1's output: chip_smoke.py
    phase 14)."""
    F = 8
    w = None if window is None else make_window(window, N)
    raw = frames(F, N, 13)
    s1, _ = kurtosis.SkSessionStep(N, F, CPU, window=w)(raw, n_valid)
    ref = PsdStep(N, F, CPU, window=w)(raw, n_valid)
    assert torch.equal(s1, ref)


@pytest.mark.parametrize("N", [64, 256])
def test_sk_excise_step_matches_direct_and_jax(N):
    F, sigma = 8, 3.0
    step = kurtosis.SkSessionStep(N, F, CPU, excise_sigma=sigma)
    jstep = jax_kurtosis.SkSessionStep(N, F, excise_sigma=sigma)
    assert step.fields == jstep.fields == ("s1", "s2", "s1_clean", "kept")
    raw = frames(F, N, 31)
    s1, s2, s1c, kept = (t.numpy().astype(np.float64) for t in step(raw, F))
    j = [np.asarray(a, np.float64) for a in jstep(raw, F)]
    w1, w2 = direct_moments(raw)
    np.testing.assert_allclose(s1, w1, rtol=1e-5)
    sk = kurtosis.compute_sk(w1, w2, F)
    keep = np.abs(sk - 1.0) <= sigma * 2.0 / np.sqrt(F)
    np.testing.assert_array_equal(kept, np.where(keep, float(F), 0.0))
    np.testing.assert_array_equal(kept, j[3])
    np.testing.assert_allclose(s1c, np.where(keep, w1, 0.0), rtol=1e-5)
    # M < 2 carries no SK information: everything is kept.
    s1b, _, s1cb, keptb = (t.numpy() for t in step(raw, 1))
    np.testing.assert_array_equal(keptb, np.ones(N))
    np.testing.assert_array_equal(s1cb, s1b)


def test_sk_keep_matches_jax_gate():
    """The gate in float32, op for op the JAX package's _sk_keep, over
    moments near and far from the Gaussian null and every M class."""
    rng = np.random.default_rng(7)
    s1 = rng.uniform(1e2, 1e6, 4096).astype(np.float32)
    ratio = rng.uniform(0.2, 3.0, 4096).astype(np.float32)
    for M in (0.0, 1.0, 2.0, 7.0, 64.0, 1000.0):
        s2 = (s1 * s1 * ratio / max(M, 1.0)).astype(np.float32)
        for sigma in (0.5, 3.0, 4.0):
            got = kurtosis._sk_keep(torch.from_numpy(s1),
                                    torch.from_numpy(s2), M, sigma).numpy()
            want = np.asarray(jax_kurtosis._sk_keep(
                s1, s2, np.float32(M), sigma))
            np.testing.assert_array_equal(got, want)


def test_compute_sk_is_the_jax_formula():
    rng = np.random.default_rng(15)
    M, N = 4096, 8
    p = rng.chisquare(2, size=(M, N)) / 2.0
    p[:, 3] = 5.0
    p[:, 5] = np.where(rng.random(M) < 0.05, 40.0, 1e-3)
    s1, s2 = p.sum(0), (p * p).sum(0)
    sk = kurtosis.compute_sk(s1, s2, M)
    np.testing.assert_array_equal(sk, jax_kurtosis.compute_sk(s1, s2, M))
    gauss = [i for i in range(N) if i not in (3, 5)]
    assert np.all(np.abs(sk[gauss] - 1.0) < 0.2)
    assert sk[3] < 0.05 and sk[5] > 5.0


@pytest.mark.parametrize("argv,what", [
    (["-b", "8388608", "--sk-file", "x"], "--sk-file at 8388608 bins"),
    (["-b", "4194306", "--sk-excise", "3"], "--sk-excise at 4194306 bins"),
    (["-b", "2097154", "--sk-file", "x", "--fft-backend", "bluestein"],
     "--sk-file with --fft-backend bluestein at 2097154 bins"),
    (["-b", "4194302", "--sk-file", "x"], "--sk-file at 4194302 bins"),
    (["-b", "256", "--sk-file", "x", "--fft-backend", "xla"],
     "--sk-file with --fft-backend xla"),
])
def test_sk_step_refuses_what_its_kernel_does_not_take(argv, what):
    params = parse_args(["-f", "100M"] + argv, stderr=io.StringIO())
    with pytest.raises(RPFexception, match="Not yet ported.*" + what):
        kurtosis.SkSessionStep(params.N, 8, CPU, backend=params.fft_backend,
                               excise_sigma=params.sk_excise)


@pytest.mark.parametrize("backend", ["pallas", "hybrid", "fft4"])
def test_sk_step_runs_its_kernel_under_the_jax_auto_names(backend):
    step = kurtosis.SkSessionStep(64, 8, CPU, backend=backend)
    assert step.path == "plain_sk"


# --- the library function (tests/test_models.py:121) ---

def test_spectral_kurtosis_matches_jax_and_flags_tone():
    from rtl_power_fftw_tpu_torch.sources.synthetic import SyntheticSource
    N, M = 256, 256
    src = SyntheticSource(tones=[(1_000_000 + 64 * RATE // N, 40.0)],
                          noise=8.0, seed=33)
    src.set_sample_rate(RATE)
    src.set_frequency(1_000_000)
    iq, _ = src.read(2 * N * M)
    freqs, sk, psd = kurtosis.spectral_kurtosis(iq, N, RATE,
                                                center_freq=1_000_000,
                                                device=CPU)
    jf, jsk, jpsd = jax_kurtosis.spectral_kurtosis(iq, N, RATE,
                                                   center_freq=1_000_000)
    np.testing.assert_array_equal(freqs, jf)
    np.testing.assert_allclose(sk, jsk, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(psd, jpsd, rtol=2e-5)
    tone_bin = N // 2 + 64
    clean = np.delete(sk, [tone_bin - 1, tone_bin, tone_bin + 1, N // 2])
    assert np.abs(np.median(clean) - 1.0) < 0.2
    assert sk[tone_bin] < 0.5 and psd[tone_bin] == psd.max()
    with pytest.raises(ValueError, match="at least 2"):
        kurtosis.spectral_kurtosis(iq[:2 * N], N, RATE, device=CPU)


# --- sessions against the JAX session ---

def sk_blocks(text):
    """[(header lines with timestamps masked, freqs, values)] of an SK
    file."""
    out = []
    for block in text.split("# rtl-power-fftw spectral kurtosis\n")[1:]:
        lines = [line for line in block.split("\n") if line]
        head = [TIMESTAMP.sub("<t>", line) for line in lines
                if line.startswith("#")]
        rows = [line.split() for line in lines if not line.startswith("#")]
        out.append((head, [r[0] for r in rows],
                    np.array([float(r[1]) for r in rows])))
    return out


def run_both(argv, tmp_path, sk_name=None):
    """The JAX and the port session of ``argv`` (with ``--sk-file`` of
    ``sk_name`` in a directory of each): [(rv, out, err, sk text)]."""
    out = []
    for port in (False, True):
        d = tmp_path / ("port" if port else "jax")
        d.mkdir(exist_ok=True)
        extra = [] if sk_name is None else ["--sk-file", str(d / sk_name)]
        rv, o, e = run(argv + extra, port=port)
        sk = None if sk_name is None else (d / sk_name).read_text()
        out.append((int(rv), o, e.replace(str(d), "<dir>"), sk))
    return out


def assert_sk_files_match(jax_sk, port_sk):
    a, b = sk_blocks(jax_sk), sk_blocks(port_sk)
    assert len(a) == len(b) >= 1
    for (ha, fa, va), (hb, fb, vb) in zip(a, b):
        assert ha == hb and fa == fb
        np.testing.assert_allclose(vb, va, rtol=1e-4, atol=1e-5)
    # The same blank-line separators.
    assert re.sub(r"[^\n]", "", jax_sk[-3:]) == re.sub(r"[^\n]", "",
                                                        port_sk[-3:])


@pytest.mark.parametrize("extra", [[], ["--window-function", "hann"],
                                   ["-l"]])
def test_sk_session_matches_jax_session(extra, tmp_path):
    argv = ["-f", "100M", "-b", "64", "-n", "256", "--frames-per-step", "64",
            "--source", "synthetic:tone=100.2M/35,noise=6,seed=1"] + extra
    (rv_j, out_j, err_j, sk_j), (rv_p, out_p, err_p, sk_p) = run_both(
        argv, tmp_path, "sk.txt")
    assert rv_j == rv_p == 0
    assert assert_text_outputs_match(out_j, out_p, linear="-l" in extra)
    assert mask_stderr(err_j) == mask_stderr(err_p)
    assert "Writing spectral kurtosis to <dir>/sk.txt" in err_p
    assert "Transform path: plain_sk (backend=auto, N=64)" in err_p
    assert_sk_files_match(sk_j, sk_p)
    assert "# Spectra accumulated: 256\n" in sk_p
    # SK ≈ 1 off the tone, ≪ 1 on it.
    _, _, skv = sk_blocks(sk_p)[0]
    vals = np.array([float(line.split()[1]) for line in out_p.split("\n")
                     if line and not line.startswith("#")])
    tone = int(np.argmax(vals))
    assert skv[tone] < 0.5
    assert abs(np.median(np.delete(skv, tone)) - 1.0) < 0.25


def test_sk_sidecar_leaves_the_spectrum_as_it_is(tmp_path):
    argv = ["-f", "100M", "-b", "256", "-n", "40", "--frames-per-step", "16",
            "--source", "synthetic:tone=100.2M/35,noise=6,seed=1"]
    rv, out_sk, _ = run(argv + ["--sk-file", str(tmp_path / "a.txt")],
                        port=True)
    rv2, out, _ = run(argv, port=True)
    assert int(rv) == int(rv2) == 0
    assert [TIMESTAMP.sub("<t>", x) for x in out_sk.split("\n")] == \
        [TIMESTAMP.sub("<t>", x) for x in out.split("\n")]


def test_sk_session_single_spectrum_writes_no_block(tmp_path):
    argv = ["-f", "100M", "-b", "64", "-n", "1",
            "--source", "synthetic:noise=5,seed=2"]
    (rv_j, _, _, sk_j), (rv_p, _, _, sk_p) = run_both(argv, tmp_path,
                                                      "sk1.txt")
    assert rv_j == rv_p == 0
    assert "spectral kurtosis" not in sk_p and sk_p == sk_j


def test_sk_session_multi_hop_matches_jax(tmp_path):
    argv = ["-f", "100M:104M", "-b", "64", "-n", "16",
            "--source", "synthetic:noise=5,seed=3"]
    (rv_j, out_j, _, sk_j), (rv_p, out_p, _, sk_p) = run_both(
        argv, tmp_path, "skhop.txt")
    assert rv_j == rv_p == 0
    assert_sk_files_match(sk_j, sk_p)
    assert sk_p.count("# rtl-power-fftw spectral kurtosis") \
        == out_p.count("# rtl-power-fftw output") >= 2


def test_sk_matrix_session_met_matches_jax(tmp_path):
    argv = ["-f", "100M:104M", "-b", "64", "-n", "32", "-q",
            "--source", "synthetic:tone=100.2M/35,noise=6,seed=1"]
    mets, bins = [], []
    for port in (False, True):
        stem = tmp_path / ("port" if port else "jax")
        rv, _, _ = run(argv + ["-m", str(stem), "--sk-file",
                               str(tmp_path / f"sk{int(port)}.txt")],
                       port=port)
        assert int(rv) == 0
        mets.append([TIMESTAMP.sub("<t>", m) for i, m in enumerate(
            (stem.parent / (stem.name + ".met")).read_text().split("\n"))
            if i != 6])
        bins.append(np.fromfile(str(stem) + ".bin", dtype=np.float32))
    assert mets[0] == mets[1]
    np.testing.assert_allclose(10.0 ** (bins[1] / 10.0),
                               10.0 ** (bins[0] / 10.0), rtol=1e-5)
    assert_sk_files_match((tmp_path / "sk0.txt").read_text(),
                          (tmp_path / "sk1.txt").read_text())


def rfi_stream(tmp_path, N=64, F=64, blocks=4):
    """tests/test_sk_session.py:222-246's stream: noise, and a 40-count
    tone at bin 9 in the second of four F-frame blocks only."""
    repeats = F * blocks
    rng = np.random.default_rng(41)
    iq = rng.normal(127.0, 6.0, size=2 * N * repeats)
    t = np.arange(N * F)
    burst = 40.0 * np.exp(2j * np.pi * 9 * t / N)
    lo = 2 * N * F
    iq[lo:lo + 2 * N * F:2] += burst.real
    iq[lo + 1:lo + 2 * N * F:2] += burst.imag
    path = tmp_path / "rfi.iq"
    path.write_bytes(np.clip(np.round(iq), 0, 255).astype(np.uint8)
                     .tobytes())
    return path, repeats


def test_sk_excise_intermittent_rfi_matches_jax(tmp_path):
    """The headline case: the burst in one of four blocks is excised.
    The port makes the JAX session's excision decisions (its summary line
    and --stats-json record are the same), and its excised spectrum
    recovers the noise floor at the burst's bin."""
    N, F = 64, 64
    path, repeats = rfi_stream(tmp_path, N, F)
    base = ["-f", "100M", "-b", str(N), "-n", str(repeats),
            "--frames-per-step", str(F), "--source", f"file:{path}"]
    res = {}
    for port in (False, True):
        stats = tmp_path / f"stats{int(port)}.jsonl"
        rv, out, err = run(base + ["--sk-excise", "3", "--stats-json",
                                   str(stats)], port=port)
        assert int(rv) == 0
        rec = json.loads(stats.read_text().splitlines()[0])
        res[port] = (out, mask_stderr(err), rec)
    (out_j, err_j, rec_j), (out_p, err_p, rec_p) = res[False], res[True]
    assert err_j == err_p
    assert any(line.startswith("SK excision (3 sigma): kept")
               for line in err_p)
    assert rec_p["sk_kept_fraction"] == rec_j["sk_kept_fraction"]
    assert rec_p["sk_bins_fully_flagged"] == rec_j[
        "sk_bins_fully_flagged"] == 0
    assert 0.0 < rec_p["sk_kept_fraction"] < 1.0
    assert rec_p["transform_path"] == "plain_sk"
    assert_text_outputs_match(out_j, out_p)
    rv, out_raw, _ = run(base, port=True)

    def vals(text):
        return np.array([float(line.split()[1]) for line in text.split("\n")
                         if line and not line.startswith("#")])
    v_ex, v_raw = vals(out_p), vals(out_raw)
    tone = int(np.argmax(v_raw))
    floor = np.median(v_raw)
    assert v_raw[tone] > floor + 10.0
    assert v_ex[tone] < floor + 1.0
    quiet = np.abs(v_raw - floor) < 1.0
    np.testing.assert_allclose(v_ex[quiet], v_raw[quiet], atol=0.2)


def test_sk_excise_persistent_tone_falls_back_as_jax(tmp_path):
    argv = ["-f", "100M", "-b", "64", "-n", "256", "--frames-per-step", "64",
            "--sk-excise", "3",
            "--source", "synthetic:tone=100.2M/35,noise=6,seed=5"]
    (rv_j, out_j, err_j, _), (rv_p, out_p, err_p, _) = run_both(argv,
                                                                tmp_path)
    assert rv_j == rv_p == 0
    assert mask_stderr(err_j) == mask_stderr(err_p)
    m = re.search(r"(\d+) of 64 bins fully flagged", err_p)
    assert m and int(m.group(1)) >= 1
    assert_text_outputs_match(out_j, out_p)


def test_sk_excise_with_sidecar_matches_jax(tmp_path):
    argv = ["-f", "100M", "-b", "64", "-n", "64", "--sk-excise", "4",
            "--source", "synthetic:noise=5,seed=6"]
    (rv_j, out_j, err_j, sk_j), (rv_p, out_p, err_p, sk_p) = run_both(
        argv, tmp_path, "both.txt")
    assert rv_j == rv_p == 0
    assert mask_stderr(err_j) == mask_stderr(err_p)
    assert "# Spectra accumulated: 64\n" in sk_p
    assert_sk_files_match(sk_j, sk_p)
    assert_text_outputs_match(out_j, out_p)


# --- the kernel's index arithmetic, transcribed ---

def sk_transcription(raw, n_valid, chunk, window=None, sigma=0.0):
    """numpy transcription of csrc/fused_psd_sk.cu in float32: K1's grid
    (k1_group from K1's occupancy), lane p of a block summing p = |X|^2
    and p * p of its frames in f32 registers, the lanes added in order
    into plane 0 (row g) and plane 1 (row G + g), est_sum_kernel's float64
    sum of each plane (lane l of 8 taking rows l, l + 8, ...) rounded once,
    and the gate epilogue op by op in float32."""
    F, N = raw.shape[0], raw.shape[1] // 2
    TF = N // fp.PASS_PLAN[N][0]
    lanes = max(MIN_THREADS, TF) // TF
    tw = fp.pass_twiddles(N)
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    w16 = header_w16().astype(np.complex64)
    group = fp.k1_group(F, chunk, h100_resident(N, window is not None))
    G = -(-F // group)
    partial = np.zeros((2, G, N), np.float32)
    for g in range(G):
        acc = np.zeros((2, lanes, N), np.float32)
        f0 = g * group
        for f in range(f0, min(f0 + group, F, n_valid)):
            re = raw[f, 0::2].astype(np.float32) - np.float32(127)
            im = raw[f, 1::2].astype(np.float32) - np.float32(127)
            if window is not None:
                w = np.asarray(window, np.float32)
                re, im = re * w, im * w
            vals, bins = transform((re + 1j * im).astype(np.complex64), tw,
                                   w16)
            p = vals.real * vals.real + vals.imag * vals.imag
            acc[0, (f - f0) % lanes, bins] += p
            acc[1, (f - f0) % lanes, bins] += p * p
        for plane in range(2):
            row = acc[plane, 0].copy()
            for lane in range(1, lanes):
                row += acc[plane, lane]
            partial[plane, g] = row
    s1, s2 = (sum(partial[plane][lane::8].astype(np.float64).sum(0)
                  for lane in range(8)).astype(np.float32)
              for plane in range(2))
    if sigma <= 0.0:
        return np.stack([s1, s2]), partial
    f32 = np.float32
    M = f32(n_valid)
    a = (M + f32(1)) / np.maximum(M - f32(1), f32(1))
    q = (M * s2) / np.maximum(s1 * s1, f32(1e-30))
    sk = a * (q - f32(1))
    limit = f32(2.0 * sigma) / np.sqrt(np.maximum(M, f32(1)))
    keep = ((np.abs(sk - f32(1)) <= limit) | (M < f32(2))).astype(f32)
    return np.stack([s1, s2, s1 * keep, M * keep]), partial


@pytest.mark.parametrize("N,F,n_valid,window,sigma", [
    (64, 64, 64, None, 0.0), (256, 128, 100, "hann", 0.0),
    (256, 64, 64, None, 3.0), (64, 64, 1, None, 3.0)])
def test_sk_kernel_transcription(N, F, n_valid, window, sigma):
    """The transcription's s1 plane is K1's (the register kernel's
    transcription) bit for bit; s1 and s2 are within 1e-5 of float64; the
    gate's decisions are the plain version's."""
    from test_torch_fused_psd_regs import regs_transcription
    w = None if window is None else make_window(window, N)
    chunk = adapt_batch(F)[1]
    raw = frames(F, N, 17)
    got, partial = sk_transcription(raw, n_valid, chunk, w, sigma)
    assert partial.shape[1] == -(-F // fp.k1_group(
        F, chunk, h100_resident(N, w is not None)))
    np.testing.assert_array_equal(got[0], regs_transcription(raw, n_valid,
                                                             chunk, w))
    want = direct_moments(raw[:n_valid], w)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    plain = fsk.fused_psd_sk_reference(
        torch.from_numpy(raw), n_valid, chunk,
        None if w is None else torch.from_numpy(w), sigma).numpy()
    assert got.shape == plain.shape
    if sigma > 0.0:
        np.testing.assert_array_equal(got[3], plain[3])


def test_sk_wrapper_counts_plain_calls_on_the_cpu():
    fp.COUNTS.reset()
    raw = torch.from_numpy(frames(8, 64, 1))
    out = fsk.fused_psd_sk(raw, 8, 8, None, 2.0)
    assert out.shape == (4, 64)
    assert (fp.COUNTS.kernel_sk, fp.COUNTS.plain) == (0, 1)
    with pytest.raises(ValueError, match="sigma"):
        fsk.fused_psd_sk(raw, 8, 8, None, -1.0)
    with pytest.raises(ValueError, match="does not take"):
        fsk.fused_psd_sk(torch.zeros((8, 96), dtype=torch.uint8), 8, 8)
    fp.COUNTS.reset()


@pytest.mark.cuda
def test_sk_kernel_on_card():
    """Runs only where a CUDA device is present (chip_smoke.py phase 14
    covers it in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    N, F = 2048, 64
    raw = torch.from_numpy(frames(F, N, 11)).cuda()
    got = fsk.fused_psd_sk(raw, 50, 64, None, 3.0)
    k1 = fp.fused_psd(raw, 50, 64)
    want = fsk.fused_psd_sk_reference(raw, 50, 64, None, 3.0)
    torch.cuda.synchronize()
    assert torch.equal(got[0], k1)
    np.testing.assert_allclose(got[:2].cpu().numpy(), want[:2].cpu().numpy(),
                               rtol=1e-5)


# --- the plane kernel (kRegsSkPlane), transcribed ---

def sk_plane_s2(raw, n_valid, chunk, window=None):
    """numpy transcription of kRegsSkPlane's |X|^4 sums: thread (lane, t)
    of a block keeps slot k's sum at plane[lane * stride + k * TF + t]
    (LANES rows of plane_stride(N) float32 in shared memory), p * p added
    in place a frame; at the end each goes to the lanes' by-bin buffer at
    bin regs_slot_bin(t, k), the lanes are added in order, and the partial
    rows are summed in float64 (est_sum_kernel's order). Returns s2."""
    F, N = raw.shape[0], raw.shape[1] // 2
    shape = fp.regs_shape(N)
    TF, R, lanes = shape.TF, shape.R, shape.lanes
    tw = fp.pass_twiddles(N)
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    w16 = header_w16().astype(np.complex64)
    group = fp.k1_group(F, chunk, h100_resident(N, window is not None))
    stride = fsk.plane_stride(N)
    # Thread (lane, t)'s slot k: its address in the plane, each once.
    lane_, k_, t_ = np.meshgrid(np.arange(lanes), np.arange(R),
                                np.arange(TF), indexing="ij")
    where = (lane_ * stride + k_ * TF + t_).reshape(lanes, R * TF)
    assert len(np.unique(where)) == where.size
    assert where.max() < lanes * stride
    rows = []
    for f0 in range(0, F, group):
        plane = np.zeros(lanes * stride, np.float32)
        for f in range(f0, min(f0 + group, F, n_valid)):
            re = raw[f, 0::2].astype(np.float32) - np.float32(127)
            im = raw[f, 1::2].astype(np.float32) - np.float32(127)
            if window is not None:
                w = np.asarray(window, np.float32)
                re, im = re * w, im * w
            vals, _ = transform((re + 1j * im).astype(np.complex64), tw, w16)
            p = vals.real * vals.real + vals.imag * vals.imag   # (TF, R)
            plane[where[(f - f0) % lanes]] += (p * p).T.reshape(-1)
        _, bins = transform(np.zeros(N, np.complex64), tw, w16)
        by_bin = np.full((lanes, N), np.nan, np.float32)
        for lane in range(lanes):
            by_bin[lane, bins.T.reshape(-1)] = plane[where[lane]]
        assert not np.isnan(by_bin).any()   # every bin written once
        row = by_bin[0].copy()
        for lane in range(1, lanes):
            row += by_bin[lane]
        rows.append(row)
    rows = np.asarray(rows, np.float64)
    return sum(rows[lane::8].sum(0) for lane in range(8)).astype(np.float32)


@pytest.mark.parametrize("N,F,n_valid,window", [
    (64, 64, 64, None), (256, 128, 100, "hann"), (256, 64, 64, None),
    (64, 64, 1, None), (512, 32, 30, "hann")])
def test_sk_plane_transcription(N, F, n_valid, window):
    """The plane's layout (slot k of thread t at k * TF + t, copied out by
    bin at the end) gives sk_transcription's s2 (the control's: the sums
    in registers, by bin) bit for bit."""
    w = None if window is None else make_window(window, N)
    chunk = adapt_batch(F)[1]
    raw = frames(F, N, 23)
    want, _ = sk_transcription(raw, n_valid, chunk, w)
    np.testing.assert_array_equal(sk_plane_s2(raw, n_valid, chunk, w),
                                  want[1])


@pytest.mark.parametrize("N", sorted(fp.PASS_PLAN))
def test_sk_plane_route_rule_and_banks(N):
    """plane_fits, a rule on N alone: K1's shared memory and the plane
    (LANES rows of N float32, padded by TF where a warp holds several
    lanes) within the 227 KB of a block (every N up to 8192; at 16384 the
    139,264 B exchange buffer, the 65,568 B ring and the 65,536 B plane do
    not fit), and the blocks that shared memory leaves an SM; a warp's
    plane accesses (lane * stride + k * TF + t) on 32 banks."""
    shape = fp.regs_shape(N)
    smem = fsk.plane_smem(N)
    stride = fsk.plane_stride(N)
    assert stride == N + (shape.TF if shape.TF < 32 else 0)
    assert smem == shape.smem + shape.lanes * stride * 4
    assert fsk.plane_fits(N) == (smem <= fp.SMEM_PER_BLOCK) == (N <= 8192)
    if fsk.plane_fits(N):
        # Up to 4096 bins the plane leaves K1's 3 blocks an SM by shared
        # memory (its registers decide on the card).
        want = {8192: 1}.get(N, 3 if N >= 128 else 6)
        assert fp.smem_blocks_per_sm(smem, shape.threads) == want
    for warp in range(shape.threads // 32):
        tid = np.arange(32) + 32 * warp
        lane, t = tid // shape.TF, tid % shape.TF
        for k in range(shape.R):
            banks = (lane * stride + k * shape.TF + t) % 32
            assert len(set(banks.tolist())) == 32


def test_sk_plane_smem_as_the_card_reports_it():
    """The plane kernel's shared memory at the sizes chip_smoke.py prints
    (dynamic bytes a block on the card): 69,120 at 256 (rows padded),
    67,648 at 2048, 67,616 at 4096, 135,200 at 8192; K1's (the
    control's) 51,264 at 2048."""
    assert [fsk.plane_smem(N) for N in (256, 2048, 4096, 8192)] == [
        69120, 67648, 67616, 135200]
    assert fp.regs_shape(2048).smem == 51264


def test_sk_control_wrapper_counts_plain_calls_on_the_cpu():
    fp.COUNTS.reset()
    raw = torch.from_numpy(frames(16, 64, 3))
    a = fsk.fused_psd_sk(raw, 12, 16, None, 2.0)
    b = fsk.fused_psd_sk_control(raw, 12, 16, None, 2.0)
    assert torch.equal(a, b)
    assert (fp.COUNTS.kernel_sk, fp.COUNTS.kernel_sk_plane,
            fp.COUNTS.plain) == (0, 0, 2)
    fp.COUNTS.reset()
