"""The CLI estimators over ``--streams`` at the awkward bin counts on the
PyTorch package against the JAX package's (``ShardedSkStep``,
``ShardedMultitaperStep``, ``ShardedPfbStep``), on the CPU, where each
streams form (SK-M-S, MT-M-S, PFB-M-S of csrc/fused_psd_mixed_est.cu at the
even 7-smooth N; SK-B-S, MT-B-S, PFB-B-S of csrc/fused_psd_chirp_est.cu at
the other even N up to 8192, and SK under ``--fft-backend bluestein``) runs
its plain PyTorch version.

Both sides take the same seeded numpy bytes and uneven counts, 0 and F
among them, on the JAX side on a mesh of S CPU devices (8 where S is 8).
Tolerances are test_torch_estimator_streams.py's: per-stream rows and the
combined sums at rtol 2e-5; a stream of fewer than 8 frames by its largest
error over its mean power; a stream with no valid frame exact zeros; the
``kept`` row exact. At these N the JAX CPU steps run XLA's FFT (or the
chirp-Z algorithm under ``bluestein``), whose rows agree with the port's
within those tolerances here (ROADMAP Queue 3's "Watch" rule would apply
where they did not, and no case needs it). Whole CLI sessions over
``--streams`` (text, ``.bin``/``.met``, the SK file) are held against the
JAX CLI's.

The kernels run only on a card (chip_smoke.py phase 21, and the cases
marked ``cuda`` here). Their new index arithmetic, the stream folded into
the grid's x axis, is transcribed in numpy: block g -> stream g / G_s and
its frames, the partial rows each form writes (SK's two planes, the taper
row y S G_s + s G_s + j) as est_streams_kernel reads them, each stream's
PFB pass-0 rows from its own history, and each stream's first row against
the ring's copy width.
"""

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu import interrupts as jax_interrupts
from rtl_power_fftw_tpu.models import kurtosis as jax_kurtosis
from rtl_power_fftw_tpu.models import multitaper as jax_multitaper
from rtl_power_fftw_tpu.models import pfb as jax_pfb
from rtl_power_fftw_tpu_torch import interrupts
from rtl_power_fftw_tpu_torch.auxdata import make_window
from rtl_power_fftw_tpu_torch.exceptions import RPFexception
from rtl_power_fftw_tpu_torch.models import kurtosis, multitaper, pfb
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_bluestein as fb
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_chirp_est as fc
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed as fm
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed_est as fe
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_sk as fsk
from rtl_power_fftw_tpu_torch.ops.spectral import adapt_batch, estimator_route

from test_torch_estimator_streams import (MESH, assert_combined_close,
                                          assert_rows_close, clamp,
                                          jax_mesh, stream_rows_sum,
                                          streams_bytes, uneven)
from test_torch_fused_psd_mixed import RESIDENT
from test_torch_kurtosis import assert_sk_files_match, run_both
from test_torch_session import assert_text_outputs_match, mask_stderr, run

CPU = torch.device("cpu")
TONE = "synthetic:tone=100.2M/35,noise=6,seed=1"


@pytest.fixture(autouse=True)
def _reset_interrupts():
    for module in (interrupts, jax_interrupts):
        module.reset()
    yield
    for module in (interrupts, jax_interrupts):
        module.reset()


def streams_kernel(kind, N, backend="auto"):
    """The streams form the route over streams gives ``kind`` at N."""
    table, flag = {"sk": (kurtosis.SK_STREAMS_KERNELS, "--sk-file"),
                   "mt": (multitaper.TAPERS_STREAMS_KERNELS, "--multitaper"),
                   "pfb": (pfb.PFB_STREAMS_KERNELS, "--pfb-taps")}[kind]
    return table[estimator_route(N, flag, backend, sharded=True)]


# --- the routes' streams forms ---------------------------------------------


@pytest.mark.parametrize("kind,N,backend,want", [
    ("sk", 500, "auto", fe.fused_psd_sk_mixed_streams),
    ("sk", 998, "auto", fc.fused_psd_sk_chirp_streams),
    ("sk", 2048, "bluestein", fc.fused_psd_sk_chirp_streams),
    ("sk", 2048, "auto", fsk.fused_psd_sk_streams),
    ("mt", 2400, "auto", fe.fused_psd_tapers_mixed_streams),
    ("mt", 22, "auto", fc.fused_psd_tapers_chirp_streams),
    ("pfb", 30, "auto", fe.fused_psd_pfb_mixed_streams),
    ("pfb", 4094, "auto", fc.fused_psd_pfb_chirp_streams),
])
def test_each_route_has_its_streams_form(kind, N, backend, want):
    assert streams_kernel(kind, N, backend) is want


# --- the steps against the JAX package's ----------------------------------


@pytest.mark.parametrize("S,N,F,wname,sigma", [
    (8, 30, 16, None, 0.0),
    (2, 500, 16, "hann", 0.0),
    (8, 500, 16, None, 3.0),
    (2, 2400, 16, None, 3.0),
    (8, 22, 16, "hann", 3.0),
    (2, 998, 32, None, 0.0),
    (8, 998, 16, "hann", 3.0),
])
def test_sharded_sk_step_matches_jax(S, N, F, wname, sigma):
    w = None if wname is None else make_window(wname, N)
    raw = streams_bytes(S, F, N, seed=N + S)
    counts = uneven(S, F)
    jstep = jax_kurtosis.ShardedSkStep(jax_mesh(S), N, F, streams=S,
                                       window=w, excise_sigma=sigma)
    step = kurtosis.ShardedSkStep(MESH, N, F, S, window=w,
                                  excise_sigma=sigma)
    assert step._kernel is streams_kernel("sk", N)
    assert step.fields == jstep.fields
    assert step.path == "plain_sk" and step.F == F
    want_ps, want_comb = (np.asarray(a, np.float64)
                          for a in jstep(raw, counts))
    ps, comb = step(raw, counts)
    assert ps.shape == (S, N) and comb.shape == (len(step.fields), N)
    assert_rows_close(ps.numpy(), want_ps, counts)
    for i, name in enumerate(step.fields):
        if name == "kept":
            np.testing.assert_array_equal(comb[i].numpy(), want_comb[i])
        else:
            assert_combined_close(comb[i].numpy(), want_comb[i])


@pytest.mark.parametrize("N,sigma", [(500, 0.0), (2048, 3.0)])
def test_sharded_sk_step_under_bluestein_matches_jax(N, sigma):
    """``--fft-backend bluestein`` over streams: SK-B-S at 500 bins (a
    7-smooth N) and 2048 (a power of two), against the JAX step's chirp-Z
    mode."""
    S, F = 2, 16
    raw = streams_bytes(S, F, N, seed=N + 5)
    counts = np.array([F, 5], np.int32)
    jstep = jax_kurtosis.ShardedSkStep(jax_mesh(S), N, F, streams=S,
                                       excise_sigma=sigma,
                                       backend="bluestein")
    step = kurtosis.ShardedSkStep(MESH, N, F, S, excise_sigma=sigma,
                                  backend="bluestein")
    assert jstep.path == "bluestein"
    assert step._kernel is fc.fused_psd_sk_chirp_streams
    want_ps, want_comb = (np.asarray(a, np.float64)
                          for a in jstep(raw, counts))
    ps, comb = step(raw, counts)
    assert_rows_close(ps.numpy(), want_ps, counts)
    for i, name in enumerate(step.fields):
        if name == "kept":
            np.testing.assert_array_equal(comb[i].numpy(), want_comb[i])
        else:
            assert_combined_close(comb[i].numpy(), want_comb[i])


@pytest.mark.parametrize("S,N,F,K", [(8, 30, 16, 2), (2, 500, 16, 7),
                                     (2, 2400, 16, 7), (8, 22, 16, 7),
                                     (2, 998, 16, 2)])
def test_sharded_multitaper_step_matches_jax(S, N, F, K):
    NW = 4.0 if N > 30 else 2.0
    raw = streams_bytes(S, F, N, seed=7 * K + N)
    counts = uneven(S, F)
    jstep = jax_multitaper.ShardedMultitaperStep(jax_mesh(S), N, F,
                                                 streams=S, K=K, NW=NW)
    step = multitaper.ShardedMultitaperStep(MESH, N, F, S, K=K, NW=NW)
    assert step._kernel is streams_kernel("mt", N)
    assert step.path == "plain_multitaper"
    want_ps, want_comb = (np.asarray(a, np.float64)
                          for a in jstep(raw, counts))
    ps, comb = step(raw, counts)
    assert ps.shape == (S, N) and comb.shape == (N,)
    assert_rows_close(ps.numpy(), want_ps, counts)
    assert_combined_close(comb.numpy(), want_comb)


@pytest.mark.parametrize("S,N,F,P", [(8, 30, 16, 4), (2, 500, 16, 4),
                                     (2, 2400, 16, 2), (8, 22, 16, 4),
                                     (2, 998, 16, 4)])
def test_sharded_pfb_step_matches_jax_over_calls_and_reset(S, N, F, P):
    """Three calls, each stream's counts running through 0, fewer than P -
    1, F and others, the histories carried from call to call, then reset()
    and a fourth call from byte-127 histories."""
    jstep = jax_pfb.ShardedPfbStep(jax_mesh(S), N, F, streams=S, taps=P)
    step = pfb.ShardedPfbStep(MESH, N, F, S, taps=P)
    assert step._kernel is streams_kernel("pfb", N)
    assert step.path == "plain_pfb"
    schedule = [np.resize(np.array(c, np.int32), S) for c in (
        [F, 0, 1, F, 5, F, 0, F - 3],
        [0, F, F, 1, 0, 9, F, 2],
        [F, 1, 0, F, F, 0, 3, F])]
    for call, counts in enumerate(schedule + ["reset"]):
        if isinstance(counts, str):
            step.reset()
            jstep.reset()
            counts = schedule[0]
        raw = streams_bytes(S, F, N, seed=100 * call + N)
        want_ps, want_comb = (np.asarray(a, np.float64)
                              for a in jstep(raw, counts))
        ps, comb = step(raw, counts)
        assert_rows_close(ps.numpy(), want_ps, counts)
        assert_combined_close(comb.numpy(), want_comb)
        np.testing.assert_array_equal(step._history[0].numpy(), jstep._tails)


# --- the combined rows against the port's own single-stream steps --------


def single_step(kind, N, F):
    if kind == "sk":
        return kurtosis.SkSessionStep(N, F, CPU)
    if kind == "sk excise":
        return kurtosis.SkSessionStep(N, F, CPU, excise_sigma=3.0)
    if kind == "multitaper":
        return multitaper.MultitaperSessionStep(N, F, 4, device=CPU)
    return pfb.PfbSessionStep(N, F, taps=4, device=CPU)


def streams_step(kind, N, F, S):
    if kind.startswith("sk"):
        return kurtosis.ShardedSkStep(
            MESH, N, F, S, excise_sigma=3.0 if "excise" in kind else 0.0)
    if kind == "multitaper":
        return multitaper.ShardedMultitaperStep(MESH, N, F, S, K=4)
    return pfb.ShardedPfbStep(MESH, N, F, S, taps=4)


@pytest.mark.parametrize("N", [500, 998])
@pytest.mark.parametrize("kind", ["sk", "sk excise", "multitaper", "pfb"])
def test_combined_is_the_single_stream_steps_summed(kind, N):
    S, F = 3, 16
    step = streams_step(kind, N, F, S)
    singles = [single_step(kind, N, F) for _ in range(S)]
    for call, counts in enumerate(([F, 0, 9], [4, F, 0])):
        counts = np.array(counts, np.int32)
        raw = streams_bytes(S, F, N, seed=60 + call + N)
        ps, comb = step(raw, counts)
        parts = []
        for s in range(S):
            out = singles[s](raw[s], int(counts[s]))
            parts.append(np.stack([t.numpy() for t in out])
                         if isinstance(out, tuple) else out.numpy())
        np.testing.assert_allclose(comb.numpy(), np.sum(parts, axis=0),
                                   rtol=1e-6)
        first = [p[0] if p.ndim == 2 else p for p in parts]
        np.testing.assert_allclose(ps.numpy(), np.stack(first), rtol=1e-6)


# --- whole sessions against the JAX CLI ------------------------------------


@pytest.mark.parametrize("extra,bins", [
    (["--streams", "2"], "500"),
    (["--streams", "2"], "998"),
])
def test_streams_sk_file_session_matches_jax(extra, bins, tmp_path):
    """``--streams 2 --sk-file`` at 500 and 998 bins: the text and the SK
    file (M = S repeats) are the JAX CLI's."""
    argv = ["-f", "100M", "-n", "32", "-b", bins, "--frames-per-step", "16",
            "--source", TONE] + extra
    (rv_j, out_j, err_j, sk_j), (rv_p, out_p, err_p, sk_p) = run_both(
        argv, tmp_path, "sk.txt")
    assert rv_j == rv_p == 0
    assert assert_text_outputs_match(out_j, out_p) == int(bins)
    assert mask_stderr(err_j) == mask_stderr(err_p)
    assert f"Transform path: plain_sk (backend=auto, N={bins})" in err_p
    assert "Parallel streams: 2 (mesh size" in err_p
    assert_sk_files_match(sk_j, sk_p)
    assert "# Spectra accumulated: 64\n" in sk_p


@pytest.mark.parametrize("extra,bins,path", [
    (["--streams", "2", "--pfb-taps", "4"], "500", "plain_pfb (N=500)"),
    (["--streams", "4", "--multitaper", "7"], "2400",
     "plain_multitaper (N=2400)"),
    (["--streams", "2", "--sk-excise", "3"], "998",
     "plain_sk (backend=auto, N=998)"),
])
def test_streams_session_matches_jax(extra, bins, path):
    argv = ["-f", "100M", "-n", "24", "-b", bins, "--frames-per-step", "8",
            "--source", TONE] + extra
    rv_j, out_j, err_j = run(argv, port=False)
    rv_p, out_p, err_p = run(argv, port=True)
    assert int(rv_j) == int(rv_p) == 0
    assert assert_text_outputs_match(out_j, out_p) == int(bins)
    assert mask_stderr(err_j) == mask_stderr(err_p)
    assert f"Transform path: {path}\n" in err_p


@pytest.mark.parametrize("extra", [["--sk-file", "SK"], ["--pfb-taps", "4"],
                                   ["--multitaper", "7"]])
@pytest.mark.parametrize("bins", ["500", "998"])
def test_streams_matrix_scan_matches_jax(extra, bins, tmp_path):
    """A two-hop scan over ``--streams 2`` in matrix mode: the .met (but
    its timing lines), the .bin rows and the SK file are the JAX CLI's;
    each PFB hop starts from reset histories."""
    mets, rows, sks = [], [], []
    for port in (False, True):
        d = tmp_path / ("port" if port else "jax")
        d.mkdir()
        stem = d / "scan"
        argv = ["-f", "100M:103M", "-b", bins, "-n", "24",
                "--frames-per-step", "8", "--streams", "2", "-q", "-m",
                str(stem), "--source",
                "synthetic:tone=101.1M/35,noise=6,seed=2"] + [
            str(d / "sk.txt") if a == "SK" else a for a in extra]
        rv, _, _ = run(argv, port=port)
        assert int(rv) == 0
        mets.append([m for i, m in enumerate(
            (d / "scan.met").read_text().split("\n")) if i not in (6, 7, 8)])
        rows.append(np.fromfile(str(stem) + ".bin", dtype=np.float32))
        if "SK" in extra:
            sks.append((d / "sk.txt").read_text())
    assert mets[0] == mets[1]
    assert int(mets[1][0].split()[0]) == 2 * int(bins) == rows[1].size
    np.testing.assert_allclose(10.0 ** (rows[1] / 10.0),
                               10.0 ** (rows[0] / 10.0), rtol=1e-5)
    if sks:
        assert_sk_files_match(sks[0], sks[1])


# --- the CUDA entries' index arithmetic, transcribed ----------------------


def frame_power32(raw, window=None):
    """|DFT|^2 in float32 of (..., 2N) u8 frames (numpy's transform)."""
    z = ((raw[..., 0::2].astype(np.float64) - 127.0)
         + 1j * (raw[..., 1::2].astype(np.float64) - 127.0))
    if window is not None:
        z = z * np.asarray(window, np.float32).astype(np.float64)
    X = np.fft.fft(z, axis=-1)
    return (X.real ** 2 + X.imag ** 2).astype(np.float32)


def block_frames(g, G_s, group, F, counts):
    """Block g of a streams form's grid: its stream g // G_s and that
    stream's frames [j group, min((j + 1) group, F, counts[s])), j = g mod
    G_s (a count outside [0, F] acting as its nearest bound)."""
    s, j = divmod(g, G_s)
    return s, range(j * group, min(j * group + group, F, clamp(counts[s], F)))


def streams_form_rows(raw, counts, group, planes):
    """The first pass of a streams form over (S, F, 2N) frames in groups
    of ``group``: ``planes`` (K, S, F, N) float32 per-frame values (a
    taper's |X|^2, or |X|^2 and |X|^4 for SK), block (g, y) writing the
    sum of plane y over its frames to partial row y S G_s + g."""
    S, F, two_n = raw.shape
    G_s = F // group
    Q = planes.shape[0]
    partial = np.zeros((Q * S * G_s, two_n // 2), np.float32)
    for y in range(Q):
        for g in range(S * G_s):
            s, fr = block_frames(g, G_s, group, F, counts)
            for f in fr:
                partial[y * S * G_s + g] += planes[y, s, f]
    return partial, G_s


@pytest.mark.parametrize("S,N,fps,counts,sigma,chirp", [
    (3, 500, 64, [64, 0, 5], 3.0, False),
    (4, 30, 24, [24, 9, 0, 17], 0.0, False),
    (3, 22, 64, [-3, 70, 64], 3.0, True),    # counts act as their bounds
    (2, 998, 32, [31, 1], 0.0, True),
])
def test_sk_streams_form_rows_transcription(S, N, fps, counts, sigma,
                                            chirp):
    """SK-M-S / SK-B-S: the grid of M-S / B-S over S F frames (mixed_group
    or k1_group over the residency), block g = s G_s + j summing stream
    s's frames into s1 row g and s2 row S G_s + g; est_streams_kernel
    sums each stream's G_s rows of each plane in one stream's order and
    gates the stream on its own count. Each stream's rows are the
    one-stream form's on the same group (S = 1 on that stream), the s1
    rows the PSD streams entry's, within 1e-5 of the plain version (s2
    within 2e-5)."""
    F, chunk = adapt_batch(fps)
    nv = np.asarray(counts, np.int32)
    raw = streams_bytes(S, F, N, seed=S * N + F)
    group = (fp.k1_group(S * F, chunk, RESIDENT) if chirp else
             fm.mixed_group(S * F, chunk, RESIDENT,
                            fm.ring_launch(N).lanes))
    assert chunk % group == 0 and F % group == 0
    p = frame_power32(raw)
    partial, G_s = streams_form_rows(raw, nv, group, np.stack([p, p * p]))
    out = np.zeros((S, 4, N), np.float32)
    for s in range(S):
        for q in range(2):
            out[s, q] = stream_rows_sum(partial[q * S * G_s:], S, G_s, 1, s)
        one, G1 = streams_form_rows(raw[s:s + 1], nv[s:s + 1], group,
                                    np.stack([p[s:s + 1], p[s:s + 1] ** 2]))
        assert G1 == G_s
        for q in range(2):
            np.testing.assert_array_equal(
                out[s, q], stream_rows_sum(one[q * G1:], 1, G1, 1, 0))
        M = np.float32(clamp(nv[s], F))
        keep = fsk.sk_keep(torch.from_numpy(out[s, 0]),
                           torch.from_numpy(out[s, 1]), float(M),
                           sigma).numpy()
        out[s, 2], out[s, 3] = out[s, 0] * keep, M * keep
    kernel = fc.fused_psd_sk_chirp_streams if chirp \
        else fe.fused_psd_sk_mixed_streams
    want = kernel(torch.from_numpy(raw), torch.from_numpy(nv), chunk, None,
                  sigma).numpy()
    for s in range(S):
        if clamp(nv[s], F) == 0:
            assert not out[s].any() and not want[s, :2].any()
            continue
        # |X|^4 doubles |X|^2's relative rounding (the plain chirp-Z
        # transform's against numpy's): s2 within twice s1's 1e-5.
        for q in range(2):
            np.testing.assert_allclose(out[s, q], want[s, q],
                                       rtol=(q + 1) * 1e-5)
    psd = (fb.bluestein_psd_streams_reference if chirp
           else fp.fused_psd_streams_reference)(
        torch.from_numpy(raw), torch.from_numpy(nv), chunk).numpy()
    np.testing.assert_allclose(out[:, 0], psd, rtol=1e-5,
                               atol=1e-5 * np.abs(psd).max())


@pytest.mark.parametrize("S,N,F,K,counts,chirp", [
    (2, 500, 16, 7, [16, 5], False),
    (3, 30, 16, 3, [16, 0, 7], False),
    (2, 998, 8, 2, [3, 8], True),
    (4, 22, 16, 7, [16, 1, 0, 12], True),
])
def test_taper_rows_of_streams_transcription(S, N, F, K, counts, chirp):
    """MT-M-S / MT-B-S: the taper on the grid's y axis, block (s G_s + j,
    y) writing partial row y S G_s + s G_s + j = (y S + s) G_s + j, the row
    est_streams_kernel<kEstTapers> reads for stream s's r = y G_s + j;
    each stream's K G_s rows summed in the one-stream form's order and
    divided by K, within 1e-5 of the plain version."""
    F, chunk = adapt_batch(F)
    nv = np.asarray(counts, np.int32)
    raw = streams_bytes(S, F, N, seed=K * N + S)
    tapers = multitaper._session_tapers(N, 4.0 if N > 30 else 2.0, K)
    resident = max(1, RESIDENT // K)
    group = (fp.k1_group(S * F, chunk, resident) if chirp else
             fm.mixed_group(S * F, chunk, resident,
                            fm.ring_launch(N).lanes))
    planes = np.stack([_tapered_power(raw, tapers[k]) for k in range(K)])
    partial, G_s = streams_form_rows(raw, nv, group, planes)
    written = {}
    for y in range(K):
        for g in range(S * G_s):
            s, j = divmod(g, G_s)
            assert y * S * G_s + s * G_s + j == (y * S + s) * G_s + j
            written.setdefault(s, set()).add(y * S * G_s + g)
    for s in range(S):
        read = {(r // G_s * S + s) * G_s + r % G_s for r in range(K * G_s)}
        assert read == written[s]
    got = np.stack([stream_rows_sum(partial, S, G_s, K, s) / np.float32(K)
                    for s in range(S)])
    kernel = fc.fused_psd_tapers_chirp_streams if chirp \
        else fe.fused_psd_tapers_mixed_streams
    want = kernel(torch.from_numpy(raw), torch.from_numpy(nv), chunk,
                  torch.from_numpy(tapers)).numpy()
    assert_rows_close(got, want, np.clip(nv, 0, F))


def _tapered_power(raw, taper):
    """|DFT(x * taper)|^2 in float32 of (S, F, 2N) frames."""
    z = ((raw[..., 0::2].astype(np.float64) - 127.0)
         + 1j * (raw[..., 1::2].astype(np.float64) - 127.0))
    X = np.fft.fft(z * taper.astype(np.float64), axis=-1)
    return (X.real ** 2 + X.imag ** 2).astype(np.float32)


@pytest.mark.parametrize("P,counts", [(4, [8, 0, 2]), (2, [1, 8, 5]),
                                      (8, [3, 8, 0])])
def test_pfb_streams_pass0_rows_transcription(P, counts):
    """PFB-M-S / PFB-B-S pass 0 for block g of stream s = g / G_s: frame
    j's tap P - 1 from the ring slot (stream s's slot row j, at s F 2N
    bytes past the frames' base), the older taps from stream s's own
    history (s (P - 1) 2N bytes past the histories' base) or its slot
    rows; in float32, p in order, each product and sum rounded on its own:
    the plain version's polyphase sums of that stream bit for bit."""
    S, N, F = 3, 22, 8
    rng = np.random.default_rng(P)
    raw = rng.integers(0, 256, (S * F, 2 * N), dtype=np.uint8)
    history = rng.integers(0, 256, (S * (P - 1), 2 * N), dtype=np.uint8)
    h = pfb.pfb_prototype(N, P, "hann").reshape(P, N)
    for s in range(S):
        frames = raw[s * F:(s + 1) * F]             # raw + s F 2N
        rows = history[s * (P - 1):(s + 1) * (P - 1)]   # + s (P - 1) 2N
        nv = clamp(counts[s], F)
        sums = np.zeros((nv, N), np.complex64)
        for j in range(nv):
            re = np.zeros(N, np.float32)
            im = np.zeros(N, np.float32)
            for p in range(P):
                r = j + p
                u = (frames[j] if p == P - 1 else rows[r] if r < P - 1
                     else frames[r - (P - 1)])
                re = re + (u[0::2].astype(np.float32) - np.float32(127)) \
                    * h[p]
                im = im + (u[1::2].astype(np.float32) - np.float32(127)) \
                    * h[p]
            sums[j] = re + 1j * im
        virtual = torch.from_numpy(np.concatenate([rows, frames]))
        plain = fpf.pfb_sums_reference(virtual, torch.from_numpy(h),
                                       F).numpy()
        np.testing.assert_array_equal(sums, plain[:nv])


@pytest.mark.parametrize("N", [2, 6, 22, 30, 500, 998, 2400, 4094, 8188,
                               12000, 16000])
@pytest.mark.parametrize("offset", [0, 4, 8, 16])
def test_every_streams_first_row_meets_the_copy_width(N, offset):
    """The ring copies each frame in pieces of copy_width(N, base) bytes:
    stream s's frame f lies s F 2N + f 2N bytes past the base, and the
    width divides 2N, so every stream's rows (S F rows in all) take the
    base's width; at N = 2 * odd (998, 22, 30) it is 4 bytes."""
    base = 0x7F0000000000 + offset
    width = fm.copy_width(N, base)
    assert (2 * N) % width == 0 and base % width == 0
    for S, F in ((2, 8), (16, 256), (3, 37)):
        for s in range(S):
            for f in (0, 1, F - 1):
                assert (base + s * F * 2 * N + f * 2 * N) % width == 0
    if N % 2 == 0 and (N // 2) % 2 == 1:
        assert width == 4


# --- the wrappers' checks and counts --------------------------------------


def _sk(mod, raw, nv):
    return (mod.fused_psd_sk_mixed_streams if mod is fe
            else mod.fused_psd_sk_chirp_streams)(raw, nv, 8)


def _mt(mod, raw, nv):
    N = raw.shape[-1] // 2
    return (mod.fused_psd_tapers_mixed_streams if mod is fe
            else mod.fused_psd_tapers_chirp_streams)(
        raw, nv, 8, torch.ones((3, N)))


def _pfb(mod, raw, nv):
    S, N = raw.shape[0], raw.shape[-1] // 2
    return (mod.fused_psd_pfb_mixed_streams if mod is fe
            else mod.fused_psd_pfb_chirp_streams)(
        raw, torch.zeros((S, 3, 2 * N), dtype=torch.uint8), nv, 8,
        torch.ones((4, N)), torch.zeros((S, 3, 2 * N), dtype=torch.uint8))


ENTRIES = {"sk": _sk, "mt": _mt, "pfb": _pfb}
#: A width each family takes, and one it does not: the mixed-radix forms
#: take 500 bins and not 998; the chirp-Z forms 998 and not 9998.
FAMILIES = {"mixed": (fe, 500, 998), "chirp": (fc, 998, 9998)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("bad", ["dtype", "2-d", "N", "strided", "counts",
                                 "count dtype"])
def test_streams_forms_reject_what_the_kernels_do_not_take(family, entry,
                                                           bad):
    mod, N, other = FAMILIES[family]
    S, F = 2, 8
    raw = torch.zeros((S, F, 2 * N), dtype=torch.uint8)
    nv = torch.tensor([F, 3], dtype=torch.int32)
    exc = ValueError
    if bad == "dtype":
        raw, exc = raw.to(torch.int16), TypeError
    elif bad == "2-d":
        raw = raw[0]
    elif bad == "N":
        raw = torch.zeros((S, F, 2 * other), dtype=torch.uint8)
    elif bad == "strided":
        raw = torch.zeros((S, 2 * N, F), dtype=torch.uint8).transpose(1, 2)
    elif bad == "counts":
        nv = torch.tensor([F, 3, 1], dtype=torch.int32)
    else:
        nv = nv.to(torch.int64)
    with pytest.raises(exc):
        ENTRIES[entry](mod, raw, nv)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_streams_forms_reject_counts_off_the_frames_device(family, entry):
    mod, N, _ = FAMILIES[family]
    raw = torch.zeros((2, 8, 2 * N), dtype=torch.uint8)
    nv = torch.tensor([8, 8], dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="n_valid on meta"):
        ENTRIES[entry](mod, raw, nv)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("bad", ["tapers", "history", "history_out", "h",
                                 "same", "sigma"])
def test_streams_forms_reject_bad_side_arguments(family, bad):
    mod, N, _ = FAMILIES[family]
    S, F = 2, 8
    raw = torch.zeros((S, F, 2 * N), dtype=torch.uint8)
    nv = torch.tensor([F, 0], dtype=torch.int32)
    hist = torch.zeros((S, 3, 2 * N), dtype=torch.uint8)
    sk, mt, pf = ((fe.fused_psd_sk_mixed_streams,
                   fe.fused_psd_tapers_mixed_streams,
                   fe.fused_psd_pfb_mixed_streams) if mod is fe else
                  (fc.fused_psd_sk_chirp_streams,
                   fc.fused_psd_tapers_chirp_streams,
                   fc.fused_psd_pfb_chirp_streams))
    with pytest.raises(ValueError):
        if bad == "tapers":
            mt(raw, nv, 8, torch.ones((3, N + 1)))
        elif bad == "sigma":
            sk(raw, nv, 8, None, -1.0)
        else:
            h = torch.ones((4, N))
            out = torch.zeros_like(hist)
            if bad == "history":
                hist = torch.zeros((S + 1, 3, 2 * N), dtype=torch.uint8)
            elif bad == "history_out":
                out = torch.zeros((S, 2, 2 * N), dtype=torch.uint8)
            elif bad == "h":
                h = torch.ones((4, N), dtype=torch.float64)
            else:
                out = hist
            pf(raw, hist, nv, 8, h, out)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_one_stream_forms_reject_a_group_outside_the_frames(family):
    mod, N, _ = FAMILIES[family]
    raw = torch.zeros((8, 2 * N), dtype=torch.uint8)
    sk = fe.fused_psd_sk_mixed if mod is fe else fc.fused_psd_sk_chirp
    with pytest.raises(ValueError, match="group"):
        sk(raw, 8, 8, group=9)
    with pytest.raises(ValueError, match="group"):
        sk(raw, 8, 8, group=0)


def test_streams_forms_on_cpu_count_as_plain():
    counts = fp.COUNTS
    counts.reset()
    for mod, N, _ in FAMILIES.values():
        raw = torch.zeros((2, 8, 2 * N), dtype=torch.uint8)
        nv = torch.tensor([8, 3], dtype=torch.int32)
        for entry in ENTRIES.values():
            entry(mod, raw, nv)
    assert counts.plain == 6
    assert not any(v for k, v in vars(counts).items() if k != "plain")


def test_streams_references_take_the_one_stream_transforms():
    """The chirp-Z streams forms' plain versions are the power-of-two
    streams references with the chirp-Z transform (B's plain |DFT|^2,
    chirp_power), each stream's rows the one-stream chirp-Z reference's
    bit for bit; SK-B-S's s1 is B-S's plain row bit for bit."""
    S, N, F = 2, 22, 8
    raw = torch.from_numpy(streams_bytes(S, F, N, seed=9))
    nv = torch.tensor([F, 3], dtype=torch.int32)
    tp = torch.from_numpy(multitaper._session_tapers(N, 2.0, 3))
    h = torch.from_numpy(pfb.pfb_prototype(N, 4).reshape(4, N))
    sk = fc.sk_chirp_streams_reference(raw, nv, 8, None, 3.0)
    mt = fc.tapers_chirp_streams_reference(raw, nv, 8, tp)
    hist = torch.full((S, 3, 2 * N), 127, dtype=torch.uint8)
    out = torch.empty_like(hist)
    pf = fc.pfb_chirp_streams_reference(raw, hist, nv, 8, h, out)
    assert torch.equal(sk[:, 0], fb.bluestein_psd_streams_reference(
        raw, nv, 8))
    for s in range(S):
        c = int(nv[s])
        assert torch.equal(sk[s], fc.sk_chirp_reference(raw[s], c, 8, None,
                                                        3.0))
        assert torch.equal(mt[s], fc.tapers_chirp_reference(raw[s], c, 8,
                                                            tp))
        one = torch.empty((3, 2 * N), dtype=torch.uint8)
        assert torch.equal(pf[s], fc.pfb_chirp_reference(
            raw[s], torch.full((3, 2 * N), 127, dtype=torch.uint8), c, 8, h,
            one))
        assert torch.equal(out[s], one)
    # The mixed-radix forms keep the default transform (torch.fft.fft).
    raw5 = torch.from_numpy(streams_bytes(S, F, 30, seed=10))
    assert torch.equal(fe.fused_psd_sk_mixed_streams(raw5, nv, 8)[:, 0],
                       fp.fused_psd_streams_reference(raw5, nv, 8))


def test_sharded_steps_still_refuse_what_is_not_ported():
    for make in (lambda: kurtosis.ShardedSkStep(MESH, 4194306, 8, 2),
                 lambda: kurtosis.ShardedSkStep(MESH, 2097154, 8, 2,
                                                backend="bluestein"),
                 lambda: kurtosis.ShardedSkStep(MESH, 500, 8, 2,
                                                backend="xla"),
                 lambda: multitaper.ShardedMultitaperStep(MESH, 4194302, 8, 2,
                                                          K=7),
                 lambda: pfb.ShardedPfbStep(MESH, 8388608, 8, 2)):
        with pytest.raises(RPFexception, match="Not yet ported") as e:
            make()
        assert int(e.value.return_value) == 3


# --- on the card ---


@pytest.mark.cuda
def test_streams_forms_match_plain_on_card():
    """Runs only where a CUDA device is present (chip_smoke.py phase 21
    covers them in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    for mod, N in ((fe, 500), (fc, 998)):
        S, F = 2, 64
        raw = torch.from_numpy(streams_bytes(S, F, N, seed=N)).cuda()
        nv = torch.tensor([F, 5], dtype=torch.int32, device="cuda")
        sk = _sk(mod, raw, nv)
        want = (fe.fused_psd_sk_streams_reference if mod is fe
                else fc.sk_chirp_streams_reference)(raw.cpu(), nv.cpu(), 8)
        np.testing.assert_allclose(sk[0].cpu().numpy(), want[0].numpy(),
                                   rtol=1e-5)
        psd = (fm.fused_psd_mixed_streams if mod is fe
               else fb.fused_psd_bluestein_streams)(raw, nv, 8)
        assert torch.equal(sk[:, 0], psd)


@pytest.mark.cuda
def test_sharded_steps_run_the_streams_forms_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    fp.COUNTS.reset()
    dev = [torch.device("cuda", 0)]
    for N in (500, 998):
        raw = streams_bytes(2, 16, N, seed=4)
        counts = np.array([16, 3], np.int32)
        kurtosis.ShardedSkStep(dev, N, 16, 2)(raw, counts)
        multitaper.ShardedMultitaperStep(dev, N, 16, 2, K=3)(raw, counts)
        pfb.ShardedPfbStep(dev, N, 16, 2)(raw, counts)
    torch.cuda.synchronize()
    for name in ("sk", "tapers", "pfb"):
        for fam in ("mixed", "chirp"):
            assert getattr(fp.COUNTS, f"kernel_{name}_{fam}_streams") == 1
    assert fp.COUNTS.plain == 0
