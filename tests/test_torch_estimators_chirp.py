"""The CLI estimators at the chirp-Z bin counts (SK-B, MT-B, PFB-B:
csrc/fused_psd_chirp_est.cu, the chirp-Z kernel's forms) against the JAX
package's, on the CPU, where the port's steps are the kernels' plain
PyTorch versions (the chirp-Z algorithm in torch ops).

The session steps (``--sk-file``, ``--sk-excise``, ``--multitaper``,
``--pfb-taps``) at N = 22, 998, 4094 and 8188 against the JAX steps and a
direct float64 form; whole CLI sessions at ``-b 998`` (text, SK file,
``.bin`` and ``.met``) and ``-b 2048 --fft-backend bluestein`` against the
JAX CLI's; ``spectral_kurtosis`` (also under ``bluestein``),
``multitaper_psd`` and ``pfb_psd`` at 998 against JAX; the routes and the
exit-3 cases that stay. The kernels run only on a card (chip_smoke.py
phase 20, and the cases marked ``cuda`` here); their new index arithmetic
is transcribed in numpy on the chirp-Z kernel's thread-by-thread
transcription (test_torch_awkward_regs.py): PFB-B's pass 0 (the frame's
own row from the ring slot, the P - 1 older rows from history or frames,
p in order, the chirp product after the sum), MT-B's taper row on the
grid's y axis and its K G partial rows, and SK-B's |X|^4 sums by pass-0
slot, written out by bin in a second plane.
"""

import re

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu.models import kurtosis as jax_kurtosis
from rtl_power_fftw_tpu.models import multitaper as jax_mt
from rtl_power_fftw_tpu.models import pfb as jax_pfb
from rtl_power_fftw_tpu_torch import cli
from rtl_power_fftw_tpu_torch.auxdata import make_window
from rtl_power_fftw_tpu_torch.exceptions import RPFexception
from rtl_power_fftw_tpu_torch.models import kurtosis, multitaper, pfb
from rtl_power_fftw_tpu_torch.ops import spectral
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_bluestein as fb
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_chirp_est as fc
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
from rtl_power_fftw_tpu_torch.ops.spectral import PsdStep, adapt_batch

from test_torch_awkward_regs import (CSRC, chirp_power, chirp_power_of,
                                     chirp_transcription, rev_bits)
from test_torch_estimators_mixed import (DIRECT_RTOL, JAX_RTOL, RATE, TONE,
                                         direct_pfb, frames, pass0_rows,
                                         run_steps, tone_capture, z64)
from test_torch_fused_psd_mixed import RESIDENT, psd_sum
from test_torch_kurtosis import assert_sk_files_match, run_both
from test_torch_session import (TIMESTAMP, assert_text_outputs_match,
                                mask_stderr, run)

CPU = torch.device("cpu")
SIZES = [22, 998, 4094, 8188]


# --- the routes ---

@pytest.mark.parametrize("N,flag,backend,sharded,route", [
    (998, "--sk-file", "auto", False, "bluestein"),
    (22, "--sk-excise", "auto", False, "bluestein"),
    (4094, "--multitaper", "auto", False, "bluestein"),
    (8188, "--pfb-taps", "auto", False, "bluestein"),
    (2048, "--sk-file", "bluestein", False, "bluestein"),
    (500, "--sk-excise", "bluestein", False, "bluestein"),
    (2048, "--pfb-taps", "bluestein", False, "regs"),
    (2048, "--sk-file", "auto", False, "regs"),
    (998, "--pfb-taps", "auto", True, "bluestein"),
    (4194306, "--multitaper", "auto", False, None),
    (998, "spectrogram", "auto", False, None),
    (2048, "--sk-file", "bluestein", True, "bluestein"),
    (22, "--sk-excise", "auto", True, "bluestein"),
    (4194302, "--pfb-taps", "auto", True, None),
])
def test_estimator_route(N, flag, backend, sharded, route):
    """The session's estimators take the chirp-Z kernel's N on one stream
    and over streams, and the SK step any even N up to 8192 under
    ``bluestein`` (the other estimators ignore the option); above 16384
    (the N in (8192, 16384]: test_torch_estimators_chirp_large.py) and for
    the library-only estimators the exit-3 message names the case."""
    if route is not None:
        assert spectral.estimator_route(N, flag, backend, sharded) == route
        return
    with pytest.raises(RPFexception, match="Not yet ported") as e:
        spectral.estimator_route(N, flag, backend, sharded)
    assert int(e.value.return_value) == 3
    assert f"{flag}{' over --streams' * sharded} at {N} bins" \
        in str(e.value)


@pytest.mark.parametrize("N,sharded,what", [
    (2097154, False, "--sk-file with --fft-backend bluestein at 2097154 "
     "bins"),
    (2097154, True, "--sk-file over --streams with --fft-backend bluestein "
     "at 2097154 bins"),
])
def test_sk_under_bluestein_still_exits_3(N, sharded, what):
    with pytest.raises(RPFexception, match="Not yet ported") as e:
        spectral.estimator_route(N, "--sk-file", "bluestein", sharded)
    assert what in str(e.value)


# --- the session steps against the JAX steps ---

@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("wname", [None, "hann"])
def test_sk_step_matches_direct_and_jax(N, wname):
    F = 8
    w = None if wname is None else make_window(wname, N)
    step = kurtosis.SkSessionStep(N, F, CPU, window=w)
    jstep = jax_kurtosis.SkSessionStep(N, F, window=w)
    assert step._kernel is fc.fused_psd_sk_chirp and step.path == "plain_sk"
    raw = frames(2 * F + 3, N, N + 1)
    got, want = run_steps(step, jstep, raw, F)
    z = z64(raw) * (1.0 if w is None else w.astype(np.float64))
    p = np.abs(np.fft.fft(z, axis=1)) ** 2
    for i, direct in enumerate((p.sum(0), (p * p).sum(0))):
        np.testing.assert_allclose(got[i], direct, rtol=DIRECT_RTOL)
        np.testing.assert_allclose(got[i], want[i], rtol=JAX_RTOL)


@pytest.mark.parametrize("N", [22, 998])
def test_sk_excise_step_matches_jax(N):
    F, sigma = 8, 3.0
    step = kurtosis.SkSessionStep(N, F, CPU, excise_sigma=sigma)
    jstep = jax_kurtosis.SkSessionStep(N, F, excise_sigma=sigma)
    raw = frames(F, N, 31)
    s1, s2, s1c, kept = (t.numpy().astype(np.float64) for t in step(raw, F))
    j = [np.asarray(a, np.float64) for a in jstep(raw, F)]
    np.testing.assert_allclose(s1, j[0], rtol=JAX_RTOL)
    np.testing.assert_array_equal(kept, j[3])
    np.testing.assert_allclose(s1c, j[2], rtol=JAX_RTOL)


@pytest.mark.parametrize("N,n_valid,wname,backend", [
    (998, 5, None, "auto"), (22, 8, None, "auto"),
    (4094, 3, "hann", "auto"), (2048, 6, None, "bluestein"),
    (500, 8, "hann", "bluestein")])
def test_sk_s1_bit_identical_to_plain_psd_step(N, n_valid, wname, backend):
    """The sidecar leaves the averaged spectrum as it is: s1 is the
    chirp-Z PsdStep's partial bit for bit, under ``bluestein`` at any even
    N too (on the card, B's output: chip_smoke.py phase 20)."""
    F = 8
    w = None if wname is None else make_window(wname, N)
    raw = frames(F, N, 13)
    s1, _ = kurtosis.SkSessionStep(N, F, CPU, window=w, backend=backend)(
        raw, n_valid)
    ref = PsdStep(N, F, CPU, window=w, backend=backend)
    assert ref.path == "plain_bluestein"
    assert torch.equal(s1, ref(raw, n_valid))


@pytest.mark.parametrize("N", [2048, 500])
def test_sk_step_under_bluestein_matches_jax(N):
    """An explicit ``--fft-backend bluestein`` runs SK-B at a power of two
    and at a 7-smooth N, as the JAX step runs its chirp-Z transform."""
    F = 8
    step = kurtosis.SkSessionStep(N, F, CPU, backend="bluestein")
    jstep = jax_kurtosis.SkSessionStep(N, F, backend="bluestein")
    assert step._kernel is fc.fused_psd_sk_chirp
    raw = frames(2 * F + 1, N, N + 5)
    got, want = run_steps(step, jstep, raw, F)
    p = np.abs(np.fft.fft(z64(raw), axis=1)) ** 2
    for i, direct in enumerate((p.sum(0), (p * p).sum(0))):
        np.testing.assert_allclose(got[i], direct, rtol=DIRECT_RTOL)
        np.testing.assert_allclose(got[i], want[i], rtol=JAX_RTOL)


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("K", [2, 7])
def test_multitaper_step_matches_direct_and_jax(N, K):
    F, NW = 8, 4.0
    step = multitaper.MultitaperSessionStep(N, F, K=K, NW=NW, device=CPU)
    jstep = jax_mt.MultitaperSessionStep(N, F, K=K, NW=NW)
    assert step._kernel is fc.fused_psd_tapers_chirp
    assert step.path == "plain_multitaper"
    raw = frames(2 * F + 3, N, N + K)
    got, want = run_steps(step, jstep, raw, F)
    t = multitaper._session_tapers(N, NW, K).astype(np.float64)
    direct = (np.abs(np.fft.fft(z64(raw)[:, None, :] * t[None], axis=-1))
              ** 2).mean(axis=1).sum(axis=0)
    np.testing.assert_allclose(got[0], direct, rtol=DIRECT_RTOL)
    np.testing.assert_allclose(got[0], want[0], rtol=JAX_RTOL)


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("window", ["hann", "blackman"])
def test_pfb_step_matches_direct_and_jax(N, window):
    F, P = 8, 4
    step = pfb.PfbSessionStep(N, F, taps=P, window=window, device=CPU)
    jstep = jax_pfb.PfbSessionStep(N, F, taps=P, window=window)
    assert step._run._kernel is fc.fused_psd_pfb_chirp
    assert step.path == "plain_pfb"
    raw = frames(3 * F + 5, N, N + 7)
    got, want = run_steps(step, jstep, raw, F)
    np.testing.assert_allclose(got[0], direct_pfb(raw, N, P, window),
                               rtol=DIRECT_RTOL)
    np.testing.assert_allclose(got[0], want[0], rtol=JAX_RTOL)


# --- whole sessions against the JAX CLI ---

@pytest.mark.parametrize("extra,path", [
    (["--sk-excise", "3"], "plain_sk (backend=auto, N=998)"),
    (["--multitaper", "7"], "plain_multitaper (N=998)"),
    (["--pfb-taps", "4"], "plain_pfb (N=998)"),
])
def test_session_at_998_bins_matches_jax(extra, path):
    argv = ["-f", "100M", "-n", "40", "-b", "998", "--frames-per-step", "16",
            "--source", TONE] + extra
    rv_j, out_j, err_j = run(argv, port=False)
    rv_p, out_p, err_p = run(argv, port=True)
    assert int(rv_j) == int(rv_p) == 0
    assert assert_text_outputs_match(out_j, out_p) == 998
    assert mask_stderr(err_j) == mask_stderr(err_p)
    assert f"Transform path: {path}\n" in err_p


@pytest.mark.parametrize("bins,extra,path", [
    ("998", [], "plain_sk (backend=auto, N=998)"),
    ("2048", ["--fft-backend", "bluestein"],
     "plain_sk (backend=bluestein, N=2048)"),
])
def test_sk_file_session_matches_jax(bins, extra, path, tmp_path):
    """``-b 998 --sk-file`` and ``-b 2048 --sk-file --fft-backend
    bluestein``: the text and the SK file are the JAX CLI's, and the
    sidecar leaves the spectrum as the PSD session prints it."""
    argv = ["-f", "100M", "-n", "64", "-b", bins, "--frames-per-step", "16",
            "--source", TONE] + extra
    (rv_j, out_j, err_j, sk_j), (rv_p, out_p, err_p, sk_p) = run_both(
        argv, tmp_path, "sk.txt")
    assert rv_j == rv_p == 0
    assert assert_text_outputs_match(out_j, out_p) == int(bins)
    assert mask_stderr(err_j) == mask_stderr(err_p)
    assert f"Transform path: {path}" in err_p
    assert_sk_files_match(sk_j, sk_p)
    assert "# Spectra accumulated: 64\n" in sk_p
    rv, out, _ = run(argv, port=True)
    assert int(rv) == 0
    assert [TIMESTAMP.sub("<t>", x) for x in out.split("\n")] == \
        [TIMESTAMP.sub("<t>", x) for x in out_p.split("\n")]


@pytest.mark.parametrize("scan", [
    ["-f", "100M", "-b", "998", "-n", "40", "--frames-per-step", "16",
     "--source", TONE],
    ["-f", "100M:103M", "-b", "998", "-n", "24", "--frames-per-step", "8",
     "--source", "synthetic:tone=101.1M/35,noise=6,seed=2"]])
@pytest.mark.parametrize("extra", [["--sk-file", "SK"], ["--pfb-taps", "4"],
                                   ["--multitaper", "7"]])
def test_matrix_scan_matches_jax(scan, extra, tmp_path):
    """One hop and a two-hop scan of 998 bins in matrix mode: the .met
    (but its timing lines) and the .bin rows are the JAX CLI's; each PFB
    hop starts from a reset history."""
    mets, bins = [], []
    for port in (False, True):
        d = tmp_path / ("port" if port else "jax")
        d.mkdir()
        stem = d / "scan"
        argv = scan + ["-q", "-m", str(stem)] + [
            str(d / "sk.txt") if a == "SK" else a for a in extra]
        rv, _, _ = run(argv, port=port)
        assert int(rv) == 0
        mets.append([m for i, m in enumerate(
            (d / "scan.met").read_text().split("\n")) if i not in (6, 7, 8)])
        bins.append(np.fromfile(str(stem) + ".bin", dtype=np.float32))
    cols = int(mets[1][0].split()[0])
    assert mets[0] == mets[1] and cols % 998 == 0
    assert cols == (998 if scan[1] == "100M" else 2 * 998)
    assert bins[1].size == cols
    np.testing.assert_allclose(10.0 ** (bins[1] / 10.0),
                               10.0 ** (bins[0] / 10.0), rtol=1e-5)


@pytest.mark.parametrize("extra,path", [
    (["-b", "998", "--sk-file", "sk.dat"], "plain_sk (backend=auto, N=998)"),
    (["-b", "998", "--sk-excise", "3"], "plain_sk (backend=auto, N=998)"),
    (["-b", "998", "--multitaper", "7"], "plain_multitaper (N=998)"),
    (["-b", "998", "--pfb-taps", "4"], "plain_pfb (N=998)"),
    (["-b", "2048", "--sk-file", "sk.dat", "--fft-backend", "bluestein"],
     "plain_sk (backend=bluestein, N=2048)"),
    (["-b", "8188", "-n", "2", "--sk-file", "sk.dat", "--window-function",
      "hann"], "plain_sk (backend=auto, N=8188)"),
    (["-b", "22", "--pfb-taps", "4"], "plain_pfb (N=22)"),
    (["--streams", "2", "--sk-file", "sk.dat", "-b", "998"],
     "plain_sk (backend=auto, N=998)"),
    (["--streams", "2", "--sk-file", "sk.dat", "-b", "2048",
      "--fft-backend", "bluestein"], "plain_sk (backend=bluestein, N=2048)"),
])
def test_cli_exits_0(extra, path, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["-f", "100M", "-n", "8", "--source", "synthetic:"] + extra
    assert cli.main(argv, device=CPU) == 0
    assert f"Transform path: {path}\n" in capsys.readouterr().err


@pytest.mark.parametrize("extra,what", [
    (["-b", "4194302", "--sk-file", "sk.dat"], "--sk-file at 4194302 bins"),
    (["--streams", "2", "--sk-file", "sk.dat", "-b", "2097154",
      "--fft-backend", "bluestein"],
     "--sk-file over --streams with --fft-backend bluestein at 2097154 "
     "bins"),
    (["--sk-file", "sk.dat", "--fft-backend", "bluestein", "-b", "2097154"],
     "--sk-file with --fft-backend bluestein at 2097154 bins"),
    (["--streams", "2", "--sk-file", "sk.dat", "--fft-backend", "xla",
      "-b", "500"], "--sk-file over --streams with --fft-backend xla"),
    (["-b", "4194306", "--multitaper", "7"],
     "--multitaper at 4194306 bins"),
    (["-b", "8388608", "--sk-file", "sk.dat"], "--sk-file at 8388608 bins"),
])
def test_cli_still_exits_3(extra, what, capsys):
    argv = ["-f", "100M", "-n", "8", "--source", "synthetic:"] + extra
    assert cli.main(argv, device=CPU) == 3
    err = capsys.readouterr().err
    assert "Not yet ported" in err and what in err


# --- the library functions against the JAX package's ---

@pytest.mark.parametrize("N,backend", [(998, "auto"), (998, "bluestein"),
                                       (2048, "bluestein")])
def test_spectral_kurtosis_matches_jax(N, backend):
    iq = tone_capture(N, 64, 33)
    freqs, sk, psd = kurtosis.spectral_kurtosis(iq, N, RATE,
                                                center_freq=1_000_000,
                                                backend=backend, device=CPU)
    jf, jsk, jpsd = jax_kurtosis.spectral_kurtosis(iq, N, RATE,
                                                   center_freq=1_000_000,
                                                   backend=backend)
    np.testing.assert_array_equal(freqs, jf)
    np.testing.assert_allclose(sk, jsk, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(psd, jpsd, rtol=JAX_RTOL)
    assert psd[N // 2 + 64] == psd.max() and sk[N // 2 + 64] < 0.5


def test_multitaper_psd_at_998_matches_jax():
    N = 998
    iq = frames(40, N, 34).ravel()
    f, mt = multitaper.multitaper_psd(iq, N, RATE, NW=3.0, linear=True,
                                      device=CPU)
    jf, jmt = jax_mt.multitaper_psd(iq, N, RATE, NW=3.0, linear=True)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(mt, jmt, rtol=JAX_RTOL)


@pytest.mark.parametrize("taps", [1, 4])
def test_pfb_psd_at_998_matches_jax(taps):
    N = 998
    iq = tone_capture(N, 40, 35)
    f, psd = pfb.pfb_psd(iq, N, RATE, taps=taps, linear=True,
                         frames_per_step=16, device=CPU)
    jf, jpsd = jax_pfb.pfb_psd(iq, N, RATE, taps=taps, linear=True)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(psd, jpsd, rtol=JAX_RTOL)


# --- the wrappers on the CPU ---

@pytest.mark.parametrize("N", [22, 998])
def test_wrappers_take_the_plain_versions_on_the_cpu(N):
    F = 16
    raw = torch.from_numpy(frames(F, N, 3))
    tp = torch.from_numpy(multitaper._session_tapers(N, 4.0, 7))
    h = torch.from_numpy(pfb.pfb_prototype(N, 4).reshape(4, N))
    hist = [torch.full((3, 2 * N), 127, dtype=torch.uint8) for _ in range(4)]
    fp.COUNTS.reset()
    got = [fc.fused_psd_sk_chirp(raw, 13, 8, sigma=3.0),
           fc.fused_psd_tapers_chirp(raw, 13, 8, tp),
           fc.fused_psd_pfb_chirp(raw, hist[0], 13, 8, h, hist[1])]
    want = [fc.sk_chirp_reference(raw, 13, 8, sigma=3.0),
            fc.tapers_chirp_reference(raw, 13, 8, tp),
            fc.pfb_chirp_reference(raw, hist[2], 13, 8, h, hist[3])]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(hist[1], hist[3])
    assert torch.equal(got[0][0], fb.fused_psd_bluestein(raw, 13, 8))
    assert fp.COUNTS.plain == 4
    assert fp.COUNTS.kernel_sk_chirp == fp.COUNTS.kernel_tapers_chirp \
        == fp.COUNTS.kernel_pfb_chirp == 0


def test_references_are_the_power_of_two_forms_on_the_chirp_transform():
    """Each plain version is its power-of-two counterpart's with the
    chirp-Z transform in place of torch.fft.fft: within float32 of it."""
    N, F = 998, 16
    raw = torch.from_numpy(frames(F, N, 5))
    tp = torch.from_numpy(multitaper._session_tapers(N, 4.0, 3))
    h = torch.from_numpy(pfb.pfb_prototype(N, 4).reshape(4, N))
    hist = [torch.full((3, 2 * N), 127, dtype=torch.uint8) for _ in range(4)]
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_sk as fsk
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_tapers as fmt
    pairs = [(fc.sk_chirp_reference(raw, 11, 8),
              fsk.fused_psd_sk_reference(raw, 11, 8)),
             (fc.tapers_chirp_reference(raw, 11, 8, tp),
              fmt.fused_psd_tapers_reference(raw, 11, 8, tp)),
             (fc.pfb_chirp_reference(raw, hist[0], 11, 8, h, hist[1]),
              fpf.fused_psd_pfb_reference(raw, hist[2], 11, 8, h, hist[3]))]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)
    assert torch.equal(hist[1], hist[3])


@pytest.mark.parametrize("N", [9998, 16384, 11])
def test_wrappers_refuse_n_the_kernel_does_not_take(N):
    raw = torch.zeros((8, 2 * N), dtype=torch.uint8)
    with pytest.raises(ValueError, match="does not take"):
        fc.fused_psd_sk_chirp(raw, 8, 8)
    with pytest.raises(ValueError, match="does not take"):
        fc.fused_psd_tapers_chirp(raw, 8, 8, torch.ones((2, N)))
    with pytest.raises(ValueError, match="does not take"):
        fc.fused_psd_pfb_chirp(raw, torch.zeros((1, 2 * N), dtype=torch.uint8),
                               8, 8, torch.ones((2, N)),
                               torch.zeros((1, 2 * N), dtype=torch.uint8))


def test_negative_sigma_is_refused():
    raw = torch.zeros((8, 1996), dtype=torch.uint8)
    with pytest.raises(ValueError, match="sigma"):
        fc.fused_psd_sk_chirp(raw, 8, 8, sigma=-1.0)


# --- the kernels' new index arithmetic, transcribed ---

def test_cut_constants_are_the_source():
    text = (CSRC / "fused_psd_chirp_est.cu").read_text()
    m = re.search(r"enum : int \{ kChirpSk = (\d+), kChirpTapers = (\d+), "
                  r"kChirpPfb = (\d+) \};", text)
    assert tuple(int(v) for v in m.groups()) == (fc.SK, fc.TAPERS, fc.PFB)


@pytest.mark.parametrize("P,F,nv", [(4, 8, 8), (8, 8, 3), (1, 4, 4),
                                    (32, 4, 4)])
def test_pfb_pass0_rows_transcription(P, F, nv):
    """PFB-B's pass 0 builds frame j's samples from virtual rows j .. j +
    P - 1 in tap order, the last from the ring slot, and only then takes
    the chirp product: in float32 the plain version's polyphase sums bit
    for bit; through the chirp-Z kernel's thread-by-thread transcription in
    float64 |DFT|^2 of the float64 sums, and in float32 the plain chirp-Z
    version within 1e-5."""
    N = 22
    rng = np.random.default_rng(P)
    slot = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
    history = rng.integers(0, 256, (P - 1, 2 * N), dtype=np.uint8)
    h = pfb.pfb_prototype(N, P, "hann").reshape(P, N)
    where = {"ring": slot, "slot": slot, "history": history}
    sums = np.zeros((nv, N), np.complex64)
    for j in range(nv):
        taps = pass0_rows(slot, history, j, P)
        assert taps[-1] == ("ring", j)
        re_ = np.zeros(N, np.float32)
        im_ = np.zeros(N, np.float32)
        for p, (src, i) in enumerate(taps):
            u = where[src][i]
            re_ = re_ + (u[0::2].astype(np.float32) - np.float32(127)) * h[p]
            im_ = im_ + (u[1::2].astype(np.float32) - np.float32(127)) * h[p]
        sums[j] = re_ + 1j * im_
    virtual = torch.from_numpy(np.concatenate([history, slot]))
    plain = fpf.pfb_sums_reference(virtual, torch.from_numpy(h), F).numpy()
    np.testing.assert_array_equal(sums, plain[:nv])
    v64 = np.concatenate([history, slot])
    s64 = sum(z64(v64)[p:p + nv] * h[p].astype(np.float64)
              for p in range(P))
    got64 = chirp_power_of(s64, np.complex128)
    np.testing.assert_allclose(got64, np.abs(np.fft.fft(s64, axis=1)) ** 2,
                               rtol=1e-9, atol=1e-9 * got64.max())
    got32 = chirp_power_of(sums).astype(np.float64).sum(0)
    hist = [torch.from_numpy(history.copy()), torch.empty_like(
        torch.from_numpy(history))]
    ref = fc.pfb_chirp_reference(torch.from_numpy(slot), hist[0], nv, F,
                                 torch.from_numpy(h), hist[1]).numpy()
    np.testing.assert_allclose(got32, ref, rtol=1e-5)


@pytest.mark.parametrize("N,K,F,nv", [(22, 3, 16, 13), (998, 7, 8, 8),
                                      (10, 2, 32, 30)])
def test_taper_rows_on_y_transcription(N, K, F, nv):
    """MT-B's grid: block (g, k) windows its frames by taper row k (the
    table's row blockIdx.y) before the chirp product, each lane sums its
    frames' |X|^2 of the chirp-Z transcription, the block writes partial
    row k G + g; est_sum_kernel sums the K G rows in psd_sum's order and
    divides by K: within 1e-5 of the float64 form and of the plain
    version."""
    chunk = adapt_batch(F)[1]
    shape = fb.chirp_launch(N)
    group = fp.k1_group(F, chunk, max(1, RESIDENT // K))
    G = -(-F // group)
    raw = frames(F, N, N + K)
    tapers = multitaper._session_tapers(N, 3.0 if N > 10 else 2.0, K)
    rows = np.zeros((K * G, shape.row), np.float32)
    for k in range(K):
        pw = chirp_power(raw, tapers[k]).astype(np.float32)
        for g in range(G):
            acc = np.zeros((shape.lanes, N), np.float32)
            for f in range(g * group, min((g + 1) * group, F, nv)):
                acc[(f - g * group) % shape.lanes] += pw[f]
            row = acc[0].copy()
            for lane in acc[1:]:
                row += lane
            rows[k * G + g, :N] = row
    got = psd_sum(rows)[:N] / np.float32(K)
    direct = (np.abs(np.fft.fft(z64(raw[:nv])[:, None, :]
                                * tapers.astype(np.float64)[None], axis=-1))
              ** 2).mean(axis=1).sum(axis=0)
    np.testing.assert_allclose(got, direct, rtol=1e-5)
    plain = fc.fused_psd_tapers_chirp(torch.from_numpy(raw), nv, chunk,
                                      torch.from_numpy(tapers)).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5)


def sk_transcription(raw, n_valid, chunk, window=None):
    """SK-B in float32 over a step on B's grid: thread t's sum K < R / 2
    adds |X|^2 and its square of pass 0's output in slot rev_bits(K) (bin
    t + K TF); the lanes' sums by bin, s1 in plane 0 and s2 in plane 1 of
    shared memory, added lane by lane; rows g and G + g; each plane's
    float64 row sum. Returns (s1, s2)."""
    F, N = raw.shape[0], raw.shape[1] // 2
    shape = fb.chirp_launch(N)
    R, TF, HALF = shape.R, shape.tf, shape.R // 2
    bits = R.bit_length() - 1
    group = fp.k1_group(F, chunk, RESIDENT)
    G = -(-F // group)
    pw = chirp_power(raw, window).astype(np.float32)   # (F, N) by bin
    t = np.arange(TF)
    rows = np.zeros((2 * G, shape.row), np.float32)
    for g in range(G):
        by_bin = np.zeros((2, shape.lanes, shape.row), np.float32)
        for f in range(g * group, min((g + 1) * group, F, n_valid)):
            lane = (f - g * group) % shape.lanes
            for K in range(HALF):
                slot = rev_bits(K, bits)
                assert slot % 2 == 0 and rev_bits(slot, bits) == K
                b = t + K * TF
                keep = b < N
                p = pw[f, b[keep]]
                by_bin[0, lane, b[keep]] += p
                by_bin[1, lane, b[keep]] += p * p
        for plane in (0, 1):
            row = by_bin[plane, 0].copy()
            for lane in by_bin[plane, 1:]:
                row += lane
            rows[plane * G + g] = row
    return psd_sum(rows[:G])[:N], psd_sum(rows[G:])[:N]


@pytest.mark.parametrize("N,nv,wname", [(22, 30, None), (998, 8, None),
                                        (500, 13, "hann"), (2048, 16, None)])
def test_fourth_power_slots_transcription(N, nv, wname):
    """SK-B's |X|^4 sums: each thread's pass-0 slots K < R / 2 hold bins t
    + K TF, and the second plane reads them out by bin as the first does:
    s1 is the chirp-Z kernel's transcription (B's output) bit for bit, s2
    within 2e-5 of the float64 sum of |X|^4 (the square doubles the
    relative error of |X|^2) and within 1e-5 of the plain version."""
    F = 32
    chunk = adapt_batch(F)[1]
    w = None if wname is None else make_window(wname, N)
    raw = frames(F, N, N + 2)
    s1, s2 = sk_transcription(raw, nv, chunk, w)
    assert np.array_equal(s1, chirp_transcription(raw, nv, chunk, w))
    z = z64(raw[:nv]) * (1.0 if w is None else w.astype(np.float64))
    p = np.abs(np.fft.fft(z, axis=1)) ** 2
    np.testing.assert_allclose(s1, p.sum(0), rtol=1e-5)
    np.testing.assert_allclose(s2, (p * p).sum(0), rtol=2e-5)
    wt = None if w is None else torch.from_numpy(w)
    plain = fc.fused_psd_sk_chirp(torch.from_numpy(raw), nv, chunk, wt)
    np.testing.assert_allclose(s2, plain[1].numpy(), rtol=1e-5)


def test_second_plane_fits_in_the_exchange_buffers():
    """The (LANES, row) s2 plane after the s1 plane lies within the
    lanes' exchange buffers (8.5 M bytes a lane), before the rings, at
    every N the kernel takes."""
    for N in range(2, fb.MAX_N + 1, 2):
        shape = fb.chirp_launch(N)
        planes = 2 * shape.lanes * shape.row * 4
        assert planes <= shape.lanes * (shape.M + shape.M // 16) * 8, N


# --- on the card ---

@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Runs only where a CUDA device is present (chip_smoke.py phase 20
    covers them in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    N, F = 998, 128
    raw = torch.from_numpy(frames(F, N, 2)).cuda()
    got = fc.fused_psd_sk_chirp(raw, 100, 64)
    want = fc.sk_chirp_reference(raw, 100, 64)
    assert torch.equal(got[0], fb.fused_psd_bluestein(raw, 100, 64))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5)
    tp = torch.from_numpy(multitaper._session_tapers(N, 4.0, 7)).cuda()
    np.testing.assert_allclose(
        fc.fused_psd_tapers_chirp(raw, 100, 64, tp).cpu().numpy(),
        fc.tapers_chirp_reference(raw, 100, 64, tp).cpu().numpy(),
        rtol=1e-5)
    h = torch.from_numpy(pfb.pfb_prototype(N, 4).reshape(4, N)).cuda()
    hist = [torch.full((3, 2 * N), 127, dtype=torch.uint8, device="cuda")
            for _ in range(4)]
    a = fc.fused_psd_pfb_chirp(raw, hist[0], 100, 64, h, hist[1])
    b = fc.pfb_chirp_reference(raw, hist[2], 100, 64, h, hist[3])
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5)
    assert torch.equal(hist[1], hist[3])


@pytest.mark.cuda
def test_session_steps_run_the_kernels_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    fp.COUNTS.reset()
    raw = frames(16, 998, 4)
    kurtosis.SkSessionStep(998, 16, "cuda")(raw, 16)
    kurtosis.SkSessionStep(2048, 16, "cuda", backend="bluestein")(
        frames(16, 2048, 5), 16)
    multitaper.MultitaperSessionStep(998, 16, K=3, device="cuda")(raw, 16)
    pfb.PfbSessionStep(998, 16, taps=4, device="cuda")(raw, 16)
    torch.cuda.synchronize()
    assert fp.COUNTS.kernel_sk_chirp == 2
    assert fp.COUNTS.kernel_tapers_chirp == fp.COUNTS.kernel_pfb_chirp == 1
    assert fp.COUNTS.plain == 0
