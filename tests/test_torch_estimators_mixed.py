"""The CLI estimators at the even 7-smooth bin counts (SK-M, MT-M, PFB-M:
csrc/fused_psd_mixed_est.cu, the mixed-radix ring kernel's forms) against
the JAX package's, on the CPU, where the port's steps are the kernels'
plain PyTorch versions.

The session steps (``--sk-file``, ``--sk-excise``, ``--multitaper``,
``--pfb-taps``) at N = 12, 500, 2400 and 12000 against the JAX steps and a
direct float64 form; whole CLI sessions at ``-b 500`` (text, SK file,
``.bin`` and ``.met``) against the JAX CLI's; ``spectral_kurtosis``,
``multitaper_psd`` and ``pfb_psd`` at 500 against JAX; the routes and the
exit-3 cases that stay. The kernels run only on a card (chip_smoke.py
phase 19, and the cases marked ``cuda`` here); their new index arithmetic
is transcribed in numpy: PFB-M's pass 0 (the frame's own row from the
ring slot, the P - 1 older rows from history or slot, p in order), MT-M's
taper row on the grid's y axis and its K G partial rows, and SK-M's |X|^4
sums by last-pass element, read out through element_of_bin.
"""

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
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed as fm
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed_est as fe
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_sk as fsk
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_tapers as fmt
from rtl_power_fftw_tpu_torch.ops.spectral import PsdStep, adapt_batch

from test_torch_fused_psd_mixed import (RESIDENT, dequantize, dif,
                                        psd_sum, twiddle_table)
from test_torch_kurtosis import assert_sk_files_match, run_both
from test_torch_session import (TIMESTAMP, assert_text_outputs_match,
                                mask_stderr, run)

CPU = torch.device("cpu")
RATE = 2_048_000
SIZES = [12, 500, 2400, 12000]
#: The step against the direct float64 form and against the JAX step
#: (test_torch_kurtosis.py's tolerances).
DIRECT_RTOL = 1e-5
JAX_RTOL = 2e-5
TONE = "synthetic:tone=100.2M/35,noise=6,seed=1"


def frames(F, N, seed):
    return np.random.default_rng(seed).integers(0, 256, (F, 2 * N),
                                                dtype=np.uint8)


def z64(raw):
    return ((raw[:, 0::2].astype(np.float64) - 127.0)
            + 1j * (raw[:, 1::2].astype(np.float64) - 127.0))


def batches(raw, F):
    """(F, 2N) padded batches of ``raw`` and their valid counts."""
    for lo in range(0, len(raw), F):
        batch = raw[lo:lo + F]
        out = np.zeros((F, raw.shape[1]), np.uint8)
        out[:len(batch)] = batch
        yield out, len(batch)


def run_steps(step, jstep, raw, F):
    """Both steps over ``raw`` in padded batches: (port, JAX) float64
    sums, one row per field."""
    got, want = 0.0, 0.0
    for batch, nv in batches(raw, F):
        out = step(batch, nv)
        jout = jstep(batch, nv)
        if isinstance(out, torch.Tensor):
            out, jout = (out,), (jout,)
        got = got + np.stack([t.numpy().astype(np.float64) for t in out])
        want = want + np.stack([np.asarray(a, np.float64) for a in jout])
    return got, want


# --- the routes ---

@pytest.mark.parametrize("N,flag,sharded,route", [
    (256, "--sk-file", False, "regs"), (500, "--sk-file", False, "mixed"),
    (12, "--sk-excise", False, "mixed"), (2, "--multitaper", False, "mixed"),
    (32, "--pfb-taps", False, "mixed"), (16000, "--pfb-taps", False, "mixed"),
    (256, "--pfb-taps", True, "regs"), (500, "--pfb-taps", True, "mixed"),
    (998, "--sk-file", False, "bluestein"),
    (4194302, "--sk-file", False, None),
    (998, "--sk-file", True, "bluestein"), (4194306, "--multitaper", False, None),
    (500, "spectrogram", False, None), (500, "pfb_channelize", False, None),
    (8388608, "--multitaper", True, None), (4194302, "--sk-file", True, None),
])
def test_estimator_route(N, flag, sharded, route):
    """The session's estimators take the mixed-radix kernel's N (and the
    chirp-Z kernel's, test_torch_estimators_chirp.py) on one stream and
    over streams (those of BL's forms in (8192, 16384],
    test_torch_estimators_chirp_large.py); above 16384 and for the
    library-only estimators the exit-3 message names the case."""
    if route is not None:
        assert spectral.estimator_route(N, flag, sharded=sharded) == route
        return
    with pytest.raises(RPFexception, match="Not yet ported") as e:
        spectral.estimator_route(N, flag, sharded=sharded)
    assert int(e.value.return_value) == 3
    assert f"{flag}{' over --streams' * sharded} at {N} bins" \
        in str(e.value)


# --- the session steps against the JAX steps ---

@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("wname", [None, "hann"])
def test_sk_step_matches_direct_and_jax(N, wname):
    F = 8
    w = None if wname is None else make_window(wname, N)
    step = kurtosis.SkSessionStep(N, F, CPU, window=w)
    jstep = jax_kurtosis.SkSessionStep(N, F, window=w)
    assert step._kernel is fe.fused_psd_sk_mixed and step.path == "plain_sk"
    raw = frames(2 * F + 3, N, N + 1)
    got, want = run_steps(step, jstep, raw, F)
    z = z64(raw) * (1.0 if w is None else w.astype(np.float64))
    p = np.abs(np.fft.fft(z, axis=1)) ** 2
    for i, direct in enumerate((p.sum(0), (p * p).sum(0))):
        np.testing.assert_allclose(got[i], direct, rtol=DIRECT_RTOL)
        np.testing.assert_allclose(got[i], want[i], rtol=JAX_RTOL)


@pytest.mark.parametrize("N", [12, 500])
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


@pytest.mark.parametrize("N,n_valid,wname", [(500, 5, None), (12, 8, None),
                                             (2400, 3, "hann")])
def test_sk_s1_bit_identical_to_plain_psd_step(N, n_valid, wname):
    """The sidecar leaves the averaged spectrum as it is: s1 is the
    mixed-radix PsdStep's partial bit for bit (on the card, M's output:
    chip_smoke.py phase 19)."""
    F = 8
    w = None if wname is None else make_window(wname, N)
    raw = frames(F, N, 13)
    s1, _ = kurtosis.SkSessionStep(N, F, CPU, window=w)(raw, n_valid)
    ref = PsdStep(N, F, CPU, window=w)
    assert ref.path == "plain_mixed"
    assert torch.equal(s1, ref(raw, n_valid))


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("K", [2, 7])
def test_multitaper_step_matches_direct_and_jax(N, K):
    F, NW = 8, 4.0 if N > 12 else 3.0
    step = multitaper.MultitaperSessionStep(N, F, K=K, NW=NW, device=CPU)
    jstep = jax_mt.MultitaperSessionStep(N, F, K=K, NW=NW)
    assert step._kernel is fe.fused_psd_tapers_mixed
    assert step.path == "plain_multitaper"
    raw = frames(2 * F + 3, N, N + K)
    got, want = run_steps(step, jstep, raw, F)
    t = multitaper._session_tapers(N, NW, K).astype(np.float64)
    direct = (np.abs(np.fft.fft(z64(raw)[:, None, :] * t[None], axis=-1))
              ** 2).mean(axis=1).sum(axis=0)
    np.testing.assert_allclose(got[0], direct, rtol=DIRECT_RTOL)
    np.testing.assert_allclose(got[0], want[0], rtol=JAX_RTOL)


def direct_pfb(raw, N, P, window):
    """float64 session-semantics PFB: zero prehistory, one output a
    frame."""
    h = pfb.pfb_prototype(N, P, window).astype(np.float64).reshape(P, N)
    z = np.vstack([np.zeros((P - 1, N), np.complex128), z64(raw)])
    s = sum(z[p:p + len(raw)] * h[p] for p in range(P))
    return (np.abs(np.fft.fft(s, axis=1)) ** 2).sum(0)


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("window", ["hann", "blackman"])
def test_pfb_step_matches_direct_and_jax(N, window):
    F, P = 8, 4
    step = pfb.PfbSessionStep(N, F, taps=P, window=window, device=CPU)
    jstep = jax_pfb.PfbSessionStep(N, F, taps=P, window=window)
    assert step._run._kernel is fe.fused_psd_pfb_mixed
    assert step.path == "plain_pfb"
    raw = frames(3 * F + 5, N, N + 7)
    got, want = run_steps(step, jstep, raw, F)
    np.testing.assert_allclose(got[0], direct_pfb(raw, N, P, window),
                               rtol=DIRECT_RTOL)
    np.testing.assert_allclose(got[0], want[0], rtol=JAX_RTOL)


# --- whole sessions against the JAX CLI ---

MAN_PAGE = ["-f", "144.1M:146.1M", "-b", "500", "-n", "100", "--source",
            "synthetic:tone=145.3M/35,noise=6,seed=1"]


@pytest.mark.parametrize("extra,path", [
    (["--sk-excise", "3"], "plain_sk (backend=auto, N=500)"),
    (["--multitaper", "7"], "plain_multitaper (N=500)"),
    (["--pfb-taps", "4"], "plain_pfb (N=500)"),
])
def test_session_at_500_bins_matches_jax(extra, path):
    argv = ["-f", "100M", "-n", "40", "-b", "500", "--frames-per-step", "16",
            "--source", TONE] + extra
    rv_j, out_j, err_j = run(argv, port=False)
    rv_p, out_p, err_p = run(argv, port=True)
    assert int(rv_j) == int(rv_p) == 0
    assert assert_text_outputs_match(out_j, out_p) == 500
    assert mask_stderr(err_j) == mask_stderr(err_p)
    assert f"Transform path: {path}\n" in err_p


def test_sk_file_session_at_500_bins_matches_jax(tmp_path):
    """``-b 500 --sk-file``: the text and the SK file are the JAX CLI's,
    and the sidecar leaves the spectrum as the PSD session prints it."""
    argv = ["-f", "100M", "-n", "64", "-b", "500", "--frames-per-step", "16",
            "--source", TONE]
    (rv_j, out_j, err_j, sk_j), (rv_p, out_p, err_p, sk_p) = run_both(
        argv, tmp_path, "sk.txt")
    assert rv_j == rv_p == 0
    assert assert_text_outputs_match(out_j, out_p) == 500
    assert mask_stderr(err_j) == mask_stderr(err_p)
    assert "Transform path: plain_sk (backend=auto, N=500)" in err_p
    assert_sk_files_match(sk_j, sk_p)
    assert "# Spectra accumulated: 64\n" in sk_p
    rv, out, _ = run(argv, port=True)
    assert int(rv) == 0
    assert [TIMESTAMP.sub("<t>", x) for x in out.split("\n")] == \
        [TIMESTAMP.sub("<t>", x) for x in out_p.split("\n")]


@pytest.mark.parametrize("scan,cols", [
    (MAN_PAGE, 500),
    (["-f", "100M:103M", "-b", "500", "-n", "24", "--frames-per-step", "8",
      "--source", "synthetic:tone=101.1M/35,noise=6,seed=2"], 1000)])
@pytest.mark.parametrize("extra", [["--sk-file", "SK"], ["--pfb-taps", "4"],
                                   ["--multitaper", "7"]])
def test_matrix_scan_matches_jax(scan, cols, extra, tmp_path):
    """The man-page scan (one hop of 500 bins) and a two-hop scan in
    matrix mode: the .met (but its timing lines) and the .bin rows are
    the JAX CLI's; each PFB hop starts from a reset history."""
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
    assert mets[0] == mets[1] and mets[1][0].startswith(f"{cols} ")
    assert bins[1].size == cols
    np.testing.assert_allclose(10.0 ** (bins[1] / 10.0),
                               10.0 ** (bins[0] / 10.0), rtol=1e-5)


@pytest.mark.parametrize("extra,path", [
    (["-b", "500", "--sk-file", "sk.dat"], "plain_sk (backend=auto, N=500)"),
    (["-b", "500", "--sk-excise", "3"], "plain_sk (backend=auto, N=500)"),
    (["-b", "500", "--multitaper", "7"], "plain_multitaper (N=500)"),
    (["-b", "500", "--pfb-taps", "4"], "plain_pfb (N=500)"),
    (["-b", "32", "--pfb-taps", "4"], "plain_pfb (N=32)"),
    (["-b", "16000", "-n", "2", "--pfb-taps", "4"], "plain_pfb (N=16000)"),
    (["-b", "998", "--sk-file", "sk.dat"], "plain_sk (backend=auto, N=998)"),
    (["--streams", "2", "--pfb-taps", "4", "-b", "500"], "plain_pfb (N=500)"),
    (["--streams", "2", "--sk-file", "sk.dat", "-b", "500"],
     "plain_sk (backend=auto, N=500)"),
])
def test_cli_exits_0(extra, path, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["-f", "100M", "-n", "8", "--source", "synthetic:"] + extra
    assert cli.main(argv, device=CPU) == 0
    assert f"Transform path: {path}\n" in capsys.readouterr().err


@pytest.mark.parametrize("extra,what", [
    (["--streams", "2", "--sk-file", "sk.dat", "-b", "4194302"],
     "--sk-file over --streams at 4194302 bins"),
    (["--streams", "2", "--multitaper", "7", "-b", "4194306"],
     "--multitaper over --streams at 4194306 bins"),
    (["-b", "8388608", "--sk-file", "sk.dat"], "--sk-file at 8388608 bins"),
    (["-b", "4194302", "--multitaper", "7"], "--multitaper at 4194302 bins"),
    (["-b", "500", "--sk-file", "sk.dat", "--fft-backend", "xla"],
     "--sk-file with --fft-backend xla"),
])
def test_cli_still_exits_3(extra, what, capsys):
    argv = ["-f", "100M", "-n", "8", "--source", "synthetic:"] + extra
    assert cli.main(argv, device=CPU) == 3
    err = capsys.readouterr().err
    assert "Not yet ported" in err and what in err


# --- the library functions against the JAX package's ---

def tone_capture(N, M, seed):
    from rtl_power_fftw_tpu_torch.sources.synthetic import SyntheticSource
    src = SyntheticSource(tones=[(1_000_000 + 64 * RATE // N, 40.0)],
                          noise=8.0, seed=seed)
    src.set_sample_rate(RATE)
    src.set_frequency(1_000_000)
    iq, _ = src.read(2 * N * M)
    return iq


def test_spectral_kurtosis_at_500_matches_jax():
    N = 500
    iq = tone_capture(N, 64, 33)
    freqs, sk, psd = kurtosis.spectral_kurtosis(iq, N, RATE,
                                                center_freq=1_000_000,
                                                device=CPU)
    jf, jsk, jpsd = jax_kurtosis.spectral_kurtosis(iq, N, RATE,
                                                   center_freq=1_000_000)
    np.testing.assert_array_equal(freqs, jf)
    np.testing.assert_allclose(sk, jsk, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(psd, jpsd, rtol=JAX_RTOL)
    assert psd[N // 2 + 64] == psd.max() and sk[N // 2 + 64] < 0.5


def test_multitaper_psd_at_500_matches_jax():
    N = 500
    iq = frames(40, N, 34).ravel()
    f, mt = multitaper.multitaper_psd(iq, N, RATE, NW=3.0, linear=True,
                                      device=CPU)
    jf, jmt = jax_mt.multitaper_psd(iq, N, RATE, NW=3.0, linear=True)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(mt, jmt, rtol=JAX_RTOL)


@pytest.mark.parametrize("taps", [1, 4])
def test_pfb_psd_at_500_matches_jax(taps):
    N = 500
    iq = tone_capture(N, 40, 35)
    f, psd = pfb.pfb_psd(iq, N, RATE, taps=taps, linear=True,
                         frames_per_step=16, device=CPU)
    jf, jpsd = jax_pfb.pfb_psd(iq, N, RATE, taps=taps, linear=True)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(psd, jpsd, rtol=JAX_RTOL)


# --- the wrappers on the CPU ---

def test_wrappers_take_the_plain_versions_on_the_cpu():
    N, F = 500, 16
    raw = torch.from_numpy(frames(F, N, 3))
    tp = torch.from_numpy(multitaper._session_tapers(N, 4.0, 7))
    h = torch.from_numpy(pfb.pfb_prototype(N, 4).reshape(4, N))
    hist = [torch.full((3, 2 * N), 127, dtype=torch.uint8) for _ in range(4)]
    fp.COUNTS.reset()
    got = [fe.fused_psd_sk_mixed(raw, 13, 8, sigma=3.0),
           fe.fused_psd_tapers_mixed(raw, 13, 8, tp),
           fe.fused_psd_pfb_mixed(raw, hist[0], 13, 8, h, hist[1])]
    want = [fsk.fused_psd_sk_reference(raw, 13, 8, sigma=3.0),
            fmt.fused_psd_tapers_reference(raw, 13, 8, tp),
            fpf.fused_psd_pfb_reference(raw, hist[2], 13, 8, h, hist[3])]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(hist[1], hist[3])
    assert fp.COUNTS.plain == 3
    assert fp.COUNTS.kernel_sk_mixed == fp.COUNTS.kernel_tapers_mixed \
        == fp.COUNTS.kernel_pfb_mixed == 0


@pytest.mark.parametrize("N", [998, 16386, 11])
def test_wrappers_refuse_n_the_kernel_does_not_take(N):
    raw = torch.zeros((8, 2 * N), dtype=torch.uint8)
    with pytest.raises(ValueError, match="does not take"):
        fe.fused_psd_sk_mixed(raw, 8, 8)
    with pytest.raises(ValueError, match="does not take"):
        fe.fused_psd_tapers_mixed(raw, 8, 8, torch.ones((2, N)))
    with pytest.raises(ValueError, match="does not take"):
        fe.fused_psd_pfb_mixed(raw, torch.zeros((1, 2 * N), dtype=torch.uint8),
                               8, 8, torch.ones((2, N)),
                               torch.zeros((1, 2 * N), dtype=torch.uint8))


def test_negative_sigma_is_refused():
    raw = torch.zeros((8, 1000), dtype=torch.uint8)
    with pytest.raises(ValueError, match="sigma"):
        fe.fused_psd_sk_mixed(raw, 8, 8, sigma=-1.0)


# --- the kernels' new index arithmetic, transcribed ---

def est_plan(N):
    plan = fm.mixed_plan(N)
    return plan, twiddle_table(plan, np.complex128), \
        fm.element_of_bin(plan, np.arange(N))


def pass0_rows(slot, history, j, P):
    """The rows pfb_sample reads for output frame j, tap by tap: tap P - 1
    (virtual row j + P - 1, frame j's own) from the ring slot, which
    holds slot row j; the others from the history (virtual rows < P - 1)
    or the slot."""
    rows = []
    for p in range(P):
        r = j + p
        if p == P - 1:
            rows.append(("ring", j))
        elif r < P - 1:
            rows.append(("history", r))
        else:
            rows.append(("slot", r - (P - 1)))
    return rows


@pytest.mark.parametrize("P,F,nv", [(4, 8, 8), (8, 8, 3), (1, 4, 4),
                                    (32, 4, 4)])
def test_pfb_pass0_rows_transcription(P, F, nv):
    """PFB-M's pass 0 builds frame j's samples from virtual rows j .. j +
    P - 1 in tap order, the last from the ring slot (slot row j, the
    frame the ring copies): in float32 with each product and sum rounded
    on its own, the plain version's polyphase sums bit for bit; through
    the mixed-radix passes in float64 the DFT of the float64 sums."""
    N = 30
    rng = np.random.default_rng(P)
    slot = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
    history = rng.integers(0, 256, (P - 1, 2 * N), dtype=np.uint8)
    h = pfb.pfb_prototype(N, P, "hann").reshape(P, N)
    where = {"ring": slot, "slot": slot, "history": history}
    sums = np.zeros((nv, N), np.complex64)
    for j in range(nv):
        taps = pass0_rows(slot, history, j, P)
        assert [t[0] for t in taps].count("ring") == 1
        assert taps[-1] == ("ring", j)
        re = np.zeros(N, np.float32)
        im = np.zeros(N, np.float32)
        for p, (src, i) in enumerate(taps):
            u = where[src][i]
            re = re + (u[0::2].astype(np.float32) - np.float32(127)) * h[p]
            im = im + (u[1::2].astype(np.float32) - np.float32(127)) * h[p]
        sums[j] = re + 1j * im
    virtual = torch.from_numpy(np.concatenate([history, slot]))
    plain = fpf.pfb_sums_reference(virtual, torch.from_numpy(h), F).numpy()
    np.testing.assert_array_equal(sums, plain[:nv])
    plan, tw, order = est_plan(N)
    v64 = np.concatenate([history, slot])
    s64 = sum(z64(v64)[p:p + nv] * h[p].astype(np.float64)
              for p in range(P))
    X = dif(s64, plan, tw)[:, order]
    np.testing.assert_allclose(X, np.fft.fft(s64, axis=1), rtol=1e-9,
                               atol=1e-9 * np.abs(X).max())


@pytest.mark.parametrize("N,K,F,nv", [(30, 3, 16, 13), (500, 7, 8, 8),
                                      (12, 2, 32, 30)])
def test_taper_rows_on_y_transcription(N, K, F, nv):
    """MT-M's grid: block (g, k) windows its frames by taper row k (the
    table's row blockIdx.y), writes partial row k G + g; est_sum_kernel
    sums the K G rows in psd_sum's order and divides by K: within 1e-5 of
    the float64 form and of the plain version."""
    chunk = adapt_batch(F)[1]
    shape = fm.ring_launch(N)
    group = fm.mixed_group(F, chunk, max(1, RESIDENT // K), shape.lanes)
    G = -(-F // group)
    raw = frames(F, N, N + K)
    tapers = multitaper._session_tapers(N, 3.0 if N > 12 else 2.0, K)
    plan, _, order = est_plan(N)
    tw = twiddle_table(plan, np.complex64)
    rows = np.zeros((K * G, shape.row), np.float32)
    for k in range(K):
        y = dif(dequantize(raw, tapers[k], np.complex64), plan, tw)[:, order]
        pw = (y.real * y.real + y.imag * y.imag).astype(np.float32)
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
    plain = fe.fused_psd_tapers_mixed(torch.from_numpy(raw), nv, chunk,
                                      torch.from_numpy(tapers)).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5)


@pytest.mark.parametrize("N", [6, 30, 500, 2400])
def test_fourth_power_order_transcription(N):
    """SK-M's |X|^4 sums: each thread's last-pass output at its element
    (p and p * p beside each other), gathered by element and read out at
    element_of_bin(k), as the |X|^2 sums are: in float64 the direct sums
    of |X|^2 and |X|^4 by bin; and the |X|^2 row is the element order M
    reads out, so s1 and s2 share every index."""
    raw = frames(6, N, N)
    plan, tw, order = est_plan(N)
    y = dif(dequantize(raw, None, np.complex128), plan, tw)
    pw = y.real ** 2 + y.imag ** 2          # by element
    s1_elem, s2_elem = pw.sum(0), (pw * pw).sum(0)
    p = np.abs(np.fft.fft(z64(raw), axis=1)) ** 2
    np.testing.assert_allclose(s1_elem[order], p.sum(0), rtol=1e-9)
    np.testing.assert_allclose(s2_elem[order], (p * p).sum(0), rtol=1e-9)
    assert np.array_equal(np.sort(order), np.arange(N))


# --- on the card ---

@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Runs only where a CUDA device is present (chip_smoke.py phase 19
    covers them in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    N, F = 500, 128
    raw = torch.from_numpy(frames(F, N, 2)).cuda()
    got = fe.fused_psd_sk_mixed(raw, 100, 64)
    want = fsk.fused_psd_sk_reference(raw, 100, 64)
    assert torch.equal(got[0], fm.fused_psd_mixed(raw, 100, 64))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5)
    tp = torch.from_numpy(multitaper._session_tapers(N, 4.0, 7)).cuda()
    np.testing.assert_allclose(
        fe.fused_psd_tapers_mixed(raw, 100, 64, tp).cpu().numpy(),
        fmt.fused_psd_tapers_reference(raw, 100, 64, tp).cpu().numpy(),
        rtol=1e-5)
    h = torch.from_numpy(pfb.pfb_prototype(N, 4).reshape(4, N)).cuda()
    hist = [torch.full((3, 2 * N), 127, dtype=torch.uint8, device="cuda")
            for _ in range(4)]
    a = fe.fused_psd_pfb_mixed(raw, hist[0], 100, 64, h, hist[1])
    b = fpf.fused_psd_pfb_reference(raw, hist[2], 100, 64, h, hist[3])
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5)
    assert torch.equal(hist[1], hist[3])


@pytest.mark.cuda
def test_session_steps_run_the_kernels_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    fp.COUNTS.reset()
    raw = frames(16, 500, 4)
    kurtosis.SkSessionStep(500, 16, "cuda")(raw, 16)
    multitaper.MultitaperSessionStep(500, 16, K=3, device="cuda")(raw, 16)
    pfb.PfbSessionStep(500, 16, taps=4, device="cuda")(raw, 16)
    torch.cuda.synchronize()
    assert fp.COUNTS.kernel_sk_mixed == fp.COUNTS.kernel_tapers_mixed \
        == fp.COUNTS.kernel_pfb_mixed == 1 and fp.COUNTS.plain == 0
