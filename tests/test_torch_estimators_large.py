"""The CLI estimators above 16384 bins against the JAX package's, on the
CPU, where the port's steps are the forms' plain PyTorch versions: SK-L,
MT-L, PFB-L and their calls over streams (csrc/fused_psd_large_est.cu,
forms of the large kernel's two register passes, every power of two from
32768 to 2^22), and SK-BL, MT-BL, PFB-BL (csrc/fused_psd_chirp_large_est.cu)
at BL's M = 2^16 .. 2^22 (the even N up to 2^21 with a prime factor above
7, and SK there under ``--fft-backend bluestein``).

The session steps (``--sk-file``, ``--sk-excise``, ``--multitaper``,
``--pfb-taps``) at N = 32768 and 65536 and at 20002 (M = 2^16) and 32770
(M = 2^17) with n_valid F, F - 1, 1 and 0 (Hann for SK at 65536 and 32770,
the PFB's Blackman prototype, K = 2 and 7 tapers), and SK under
``--fft-backend bluestein`` at 32768, against the JAX steps on the same
seeded numpy bytes and against a direct float64 form; the streams steps at
S = 2 with uneven counts against the JAX sharded steps; whole CLI sessions
against the JAX CLI's (text, SK file, ``.bin`` and ``.met``); the routes,
and the exit-3 cases that stay (the even 7-smooth N above 16384 that are
not powers of two, N above 2^21 under ``bluestein``, odd N). Tolerances
are test_torch_estimators_chirp_large.py's: rtol 2e-5 where a row sums at
least 8 frames; under 8 frames the largest error over the row's mean
power, against the float64 direct form within that or 3x the JAX step's
own error there (close_to_both); no frame, exact zeros; the ``kept`` row
exact; s1 the plain PSD step's bit for bit.

The kernels run only on a card (chip_smoke.py phase 23). Their new index
arithmetic is transcribed in numpy on the large kernel's thread-by-thread
transcription (tests/test_torch_fused_psd_large_regs.py): SK-L's second
plane of |X|^4 sums by pass-B slot, PFB-L's pass-A row reads (the frame's
own row from the ring, the P - 1 older rows from history or frames, p in
order, the sum before the column transform), and MT-L's taper loop and its
partial rows (k S + s) G_s + j as est_streams_kernel reads them.
"""

import re

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu import interrupts as jax_interrupts
from rtl_power_fftw_tpu.models import kurtosis as jax_kurtosis
from rtl_power_fftw_tpu.models import multitaper as jax_mt
from rtl_power_fftw_tpu.models import pfb as jax_pfb
from rtl_power_fftw_tpu_torch import cli, interrupts
from rtl_power_fftw_tpu_torch.auxdata import make_window
from rtl_power_fftw_tpu_torch.exceptions import RPFexception
from rtl_power_fftw_tpu_torch.models import kurtosis, multitaper, pfb
from rtl_power_fftw_tpu_torch.ops import spectral
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import \
    fused_psd_chirp_large_est as be
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_large as fl
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_large_est as le
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
from rtl_power_fftw_tpu_torch.ops.spectral import PsdStep
from rtl_power_fftw_tpu_torch.probes import large_estimator_builds

from test_torch_awkward_n import CHIP_SMOKE
from test_torch_estimator_streams import (MESH, assert_combined_close,
                                          assert_rows_close, jax_mesh,
                                          stream_rows_sum, streams_bytes)
from test_torch_estimators_chirp_large import (close, direct_pfb_steps,
                                               hold_prepass, polyphase_load,
                                               power64, prepass_sums,
                                               sums_load)
from test_torch_estimators_mixed import TONE, frames, z64
from test_torch_fused_psd_large_regs import (SOURCE, batch_transform,
                                             col_index, col_of,
                                             h100_resident,
                                             last_element, pass_a, pass_b,
                                             pass_b_bins, pass_twiddles_c64,
                                             regs_transcription, ring_offset,
                                             row_of)
from test_torch_fused_psd_regs import header_w16, pass_bin
from test_torch_kurtosis import assert_sk_files_match, run_both
from test_torch_session import assert_text_outputs_match, mask_stderr, run

CPU = torch.device("cpu")
CSRC = SOURCE.parent
#: The bin counts of the six acceptance sessions, one stream and two.
SESSIONS = [("32768", ["--sk-file"]), ("65536", ["--multitaper", "2"]),
            ("32768", ["--pfb-taps", "4"]), ("20002", ["--sk-file"]),
            ("32770", ["--pfb-taps", "4"])]


@pytest.fixture(autouse=True)
def _reset_interrupts():
    for module in (interrupts, jax_interrupts):
        module.reset()
    yield
    for module in (interrupts, jax_interrupts):
        module.reset()


def close_to_both(got, want, direct, n_valid, rtol=2e-5):
    """``close``'s rule against the JAX step's row and the float64 direct
    form from 8 frames and at none; under 8 frames, where a row is a few
    periodograms (their |X|^4 peaks far above the mean) and the JAX step
    is itself up to 7e-5 of the mean from the direct form at these N, the
    port within ``rtol`` of the direct form or 3x the JAX step's own error
    there, whichever is larger (chip_smoke.py phase 21's rule)."""
    got, want, direct = (np.asarray(a, np.float64)
                         for a in (got, want, direct))
    if n_valid >= 8 or n_valid == 0:
        close(got, want, n_valid, rtol)
        close(got, direct, n_valid, rtol)
        return
    own = np.abs(want - direct).max() / np.abs(direct).mean()
    close(got, direct, n_valid, max(rtol, 3.0 * own))


# --- the routes ---


@pytest.mark.parametrize("N,flag,backend,sharded,route", [
    (32768, "--sk-file", "auto", False, "large"),
    (65536, "--sk-excise", "auto", True, "large"),
    (1 << 20, "--multitaper", "auto", False, "large"),
    (1 << 22, "--pfb-taps", "auto", True, "large"),
    (20002, "--sk-file", "auto", False, "chirp_large"),
    (32770, "--pfb-taps", "auto", True, "chirp_large"),
    (99998, "--multitaper", "auto", True, "chirp_large"),
    (2097150, "--sk-excise", "auto", False, "chirp_large"),
    (32768, "--sk-file", "bluestein", False, "chirp_large"),
    (20000, "--sk-excise", "bluestein", True, "chirp_large"),
    (1 << 21, "--sk-file", "bluestein", False, "chirp_large"),
    (32768, "--multitaper", "bluestein", False, "large"),
    (4194302, "--multitaper", "auto", False, None),
    (4194306, "--sk-file", "auto", True, None),
    (8388608, "--pfb-taps", "auto", False, None),
    (4194302, "--sk-file", "auto", False, None),
    (20001, "--multitaper", "auto", False, None),
    (32768, "spectrogram", "auto", False, None),
])
def test_estimator_route(N, flag, backend, sharded, route):
    """The powers of two from 32768 to 2^22 run the large kernel's forms,
    the even N up to 2^21 with a prime factor above 7 BL's, on one stream
    and over streams; SK under ``bluestein`` BL's at any even N up to
    2^21; the exit-3 message names what still exits 3."""
    if route is not None:
        assert spectral.estimator_route(N, flag, backend, sharded) == route
        return
    with pytest.raises(RPFexception, match="Not yet ported") as e:
        spectral.estimator_route(N, flag, backend, sharded)
    assert int(e.value.return_value) == 3
    assert f"{flag}{' over --streams' * sharded} at {N} bins" \
        in str(e.value)
    if flag.startswith("--"):
        assert "not the other even N above 2097152, nor odd N" \
            in str(e.value)


def test_every_estimator_n_above_16384_has_its_route():
    """Every power of two from 32768 to 2^22 is "large", every even N
    from 16386 to 2^21 with a prime factor above 7 "chirp_large" and
    every other (7-smooth) one "mixed_large" (a sample of 200), on one
    stream and over streams; under ``bluestein`` SK takes every even N in
    (8192, 2^21] on BL's forms."""
    for log2n in range(15, 23):
        for sharded in (False, True):
            assert spectral.estimator_route(1 << log2n, "--sk-file",
                                            sharded=sharded) == "large"
    rng = np.random.default_rng(27)
    for N in 2 * rng.integers(8193, 1 << 20, 200):
        N = int(N)
        smooth = N
        for p in (2, 3, 5, 7):
            while smooth % p == 0:
                smooth //= p
        if smooth > 1:
            assert spectral.estimator_route(N, "--multitaper",
                                            sharded=True) == "chirp_large"
        elif N & (N - 1):
            assert spectral.estimator_route(N, "--multitaper") \
                == "mixed_large"
        assert spectral.estimator_route(N, "--sk-file",
                                        "bluestein") == "chirp_large"


@pytest.mark.parametrize("table,one,streams", [
    ((kurtosis.SK_KERNELS, kurtosis.SK_STREAMS_KERNELS),
     le.fused_psd_sk_large, le.fused_psd_sk_large_streams),
    ((multitaper.TAPERS_KERNELS, multitaper.TAPERS_STREAMS_KERNELS),
     le.fused_psd_tapers_large, le.fused_psd_tapers_large_streams),
    ((pfb.PFB_KERNELS, pfb.PFB_STREAMS_KERNELS),
     le.fused_psd_pfb_large, le.fused_psd_pfb_large_streams),
])
def test_each_step_maps_the_route_to_its_form(table, one, streams):
    assert table[0]["large"] is one
    assert table[1]["large"] is streams


@pytest.mark.parametrize("N,ok", [(16384, False), (32768, True),
                                  (65536, True), (1 << 22, True),
                                  (1 << 23, False), (32770, False),
                                  (20002, False)])
def test_eligible(N, ok):
    assert le.fused_psd_large_est_eligible(N) is ok


# --- the session steps against the JAX steps ---


@pytest.mark.parametrize("N,wname", [(32768, None), (65536, "hann"),
                                     (20002, None), (32770, "hann")])
def test_sk_step_matches_direct_and_jax(N, wname):
    F = 8
    w = None if wname is None else make_window(wname, N)
    step = kurtosis.SkSessionStep(N, F, CPU, window=w)
    jstep = jax_kurtosis.SkSessionStep(N, F, window=w)
    assert step._kernel is (le.fused_psd_sk_large if N & (N - 1) == 0
                            else be.fused_psd_sk_chirp_large)
    assert step.path == "plain_sk"
    raw = frames(F, N, N + 1)
    for nv in (F, F - 1, 1, 0):
        got = [t.numpy().astype(np.float64) for t in step(raw, nv)]
        want = [np.asarray(a, np.float64) for a in jstep(raw, nv)]
        p = power64(raw[:nv], w)
        for i, direct in enumerate((p.sum(0), (p * p).sum(0))):
            close_to_both(got[i], want[i], direct, nv, (i + 1) * 2e-5)


@pytest.mark.parametrize("N", [32768, 20002])
def test_sk_excise_step_matches_jax(N):
    F, sigma = 8, 3.0
    step = kurtosis.SkSessionStep(N, F, CPU, excise_sigma=sigma)
    jstep = jax_kurtosis.SkSessionStep(N, F, excise_sigma=sigma)
    raw = frames(F, N, 31)
    s1, s2, s1c, kept = (t.numpy().astype(np.float64) for t in step(raw, F))
    j = [np.asarray(a, np.float64) for a in jstep(raw, F)]
    np.testing.assert_allclose(s1, j[0], rtol=2e-5)
    np.testing.assert_array_equal(kept, j[3])
    np.testing.assert_allclose(s1c, j[2], rtol=2e-5)


def test_sk_step_under_bluestein_matches_jax():
    """``--fft-backend bluestein`` runs SK-BL at a power of two above
    16384 (M = 2^16), as the JAX step runs its chirp-Z transform."""
    N, F = 32768, 8
    step = kurtosis.SkSessionStep(N, F, CPU, backend="bluestein")
    jstep = jax_kurtosis.SkSessionStep(N, F, backend="bluestein")
    assert step._kernel is be.fused_psd_sk_chirp_large
    raw = frames(F, N, N + 5)
    for nv in (F, 3):
        got = [t.numpy().astype(np.float64) for t in step(raw, nv)]
        want = [np.asarray(a, np.float64) for a in jstep(raw, nv)]
        p = power64(raw[:nv])
        for i, direct in enumerate((p.sum(0), (p * p).sum(0))):
            close_to_both(got[i], want[i], direct, nv, (i + 1) * 2e-5)


@pytest.mark.parametrize("N,n_valid,wname,backend,path", [
    (32768, 5, None, "auto", "plain_large"),
    (65536, 8, "hann", "auto", "plain_large"),
    (20002, 8, None, "auto", "plain_chirp_large"),
    (32768, 6, None, "bluestein", "plain_chirp_large")])
def test_sk_s1_bit_identical_to_plain_psd_step(N, n_valid, wname, backend,
                                               path):
    """The sidecar leaves the averaged spectrum as it is: s1 is the PsdStep
    partial of the same route bit for bit (on the card the large kernel's
    or BL's output: chip_smoke.py phase 23)."""
    F = 8
    w = None if wname is None else make_window(wname, N)
    raw = frames(F, N, 13)
    s1, _ = kurtosis.SkSessionStep(N, F, CPU, window=w, backend=backend)(
        raw, n_valid)
    ref = PsdStep(N, F, CPU, window=w, backend=backend)
    assert ref.path == path
    assert torch.equal(s1, ref(raw, n_valid))


@pytest.mark.parametrize("N,K", [(32768, 7), (65536, 2), (20002, 2),
                                 (32770, 7)])
def test_multitaper_step_matches_direct_and_jax(N, K):
    F, NW = 8, 4.0
    step = multitaper.MultitaperSessionStep(N, F, K=K, NW=NW, device=CPU)
    jstep = jax_mt.MultitaperSessionStep(N, F, K=K, NW=NW)
    assert step._kernel is (le.fused_psd_tapers_large if N & (N - 1) == 0
                            else be.fused_psd_tapers_chirp_large)
    assert step.path == "plain_multitaper"
    raw = frames(F, N, N + K)
    t = multitaper._session_tapers(N, NW, K).astype(np.float64)
    for nv in (F, F - 1, 1, 0):
        got = step(raw, nv).numpy().astype(np.float64)
        want = np.asarray(jstep(raw, nv), np.float64)
        direct = (np.abs(np.fft.fft(z64(raw[:nv])[:, None, :] * t[None],
                                    axis=-1)) ** 2).mean(axis=1).sum(axis=0)
        close_to_both(got, want, direct, nv)


@pytest.mark.parametrize("N", [32768, 65536, 20002, 32770])
def test_pfb_step_matches_direct_and_jax(N):
    """Four steps of one stream (n_valid F, 1, F - 1, 0) on new frames,
    the Blackman prototype, the history carried on the port's step as on
    the JAX step's."""
    F, P, window = 8, 4, "blackman"
    step = pfb.PfbSessionStep(N, F, taps=P, window=window, device=CPU)
    jstep = jax_pfb.PfbSessionStep(N, F, taps=P, window=window)
    assert step._run._kernel is (le.fused_psd_pfb_large if N & (N - 1) == 0
                                 else be.fused_psd_pfb_chirp_large)
    assert step.path == "plain_pfb"
    counts = (F, 1, F - 1, 0)
    slots = [frames(F, N, N + 7 + k) for k in range(4)]
    h = pfb.pfb_prototype(N, P, window).reshape(P, N)
    for slot, nv, direct in zip(slots, counts,
                                direct_pfb_steps(slots, counts, P, h)):
        got = step(slot, nv).numpy().astype(np.float64)
        want = np.asarray(jstep(slot, nv), np.float64)
        close_to_both(got, want, direct, nv)


def test_tapers_and_prototype_match_jax_at_65536():
    """The host copies the forms read: the DPSS tapers (K = 7, NW = 4) and
    the PFB prototype (P = 4, Hann and Blackman) at 65536 bins are the JAX
    package's, value for value."""
    N = 65536
    np.testing.assert_array_equal(multitaper._session_tapers(N, 4.0, 7),
                                  np.asarray(jax_mt._session_tapers(N, 4.0,
                                                                    7)))
    for window in ("hann", "blackman"):
        np.testing.assert_array_equal(pfb.pfb_prototype(N, 4, window),
                                      np.asarray(jax_pfb.pfb_prototype(
                                          N, 4, window)))


# --- the streams steps against the JAX sharded steps ---


@pytest.mark.parametrize("N,wname,sigma,backend", [
    (32768, None, 0.0, "auto"), (65536, "hann", 3.0, "auto"),
    (20002, None, 3.0, "auto"), (32768, None, 3.0, "bluestein")])
def test_sharded_sk_step_matches_jax(N, wname, sigma, backend):
    S, F = 2, 8
    w = None if wname is None else make_window(wname, N)
    raw = streams_bytes(S, F, N, seed=N + S)
    counts = np.array([F, 5], np.int32)
    jstep = jax_kurtosis.ShardedSkStep(jax_mesh(S), N, F, streams=S,
                                       window=w, excise_sigma=sigma,
                                       backend=backend)
    step = kurtosis.ShardedSkStep(MESH, N, F, S, window=w,
                                  excise_sigma=sigma, backend=backend)
    assert step._kernel is (le.fused_psd_sk_large_streams
                            if backend == "auto" and N & (N - 1) == 0
                            else be.fused_psd_sk_chirp_large_streams)
    assert step.fields == jstep.fields and step.path == "plain_sk"
    want_ps, want_comb = (np.asarray(a, np.float64)
                          for a in jstep(raw, counts))
    ps, comb = step(raw, counts)
    assert_rows_close(ps.numpy(), want_ps, counts)
    for i, name in enumerate(step.fields):
        if name == "kept":
            np.testing.assert_array_equal(comb[i].numpy(), want_comb[i])
        else:
            assert_combined_close(comb[i].numpy(), want_comb[i])


@pytest.mark.parametrize("N,K", [(32768, 2), (20002, 7)])
def test_sharded_multitaper_step_matches_jax(N, K):
    S, F = 2, 8
    raw = streams_bytes(S, F, N, seed=7 * K + N)
    counts = np.array([F - 1, 2], np.int32)
    jstep = jax_mt.ShardedMultitaperStep(jax_mesh(S), N, F, streams=S, K=K,
                                         NW=4.0)
    step = multitaper.ShardedMultitaperStep(MESH, N, F, S, K=K, NW=4.0)
    assert step._kernel is (le.fused_psd_tapers_large_streams
                            if N & (N - 1) == 0
                            else be.fused_psd_tapers_chirp_large_streams)
    want_ps, want_comb = (np.asarray(a, np.float64)
                          for a in jstep(raw, counts))
    ps, comb = step(raw, counts)
    assert_rows_close(ps.numpy(), want_ps, counts)
    assert_combined_close(comb.numpy(), want_comb)


@pytest.mark.parametrize("N", [32768, 32770])
def test_sharded_pfb_step_matches_jax_over_calls_and_reset(N):
    """Three calls, each stream's counts running through 0, 1, F and
    others, the histories carried from call to call, then reset() and a
    fourth call from byte-127 histories."""
    S, F, P = 2, 8, 4
    jstep = jax_pfb.ShardedPfbStep(jax_mesh(S), N, F, streams=S, taps=P)
    step = pfb.ShardedPfbStep(MESH, N, F, S, taps=P)
    assert step._kernel is (le.fused_psd_pfb_large_streams
                            if N & (N - 1) == 0
                            else be.fused_psd_pfb_chirp_large_streams)
    schedule = [np.array(c, np.int32) for c in ([F, 0], [1, F], [F, 3])]
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


# --- whole sessions against the JAX CLI ---


def session_argv(bins, extra, streams):
    argv = ["-f", "100M", "-n", "16", "-b", bins, "--frames-per-step", "8",
            "--source", TONE] + streams
    if extra == ["--sk-file"]:
        return argv
    return argv + extra


@pytest.mark.parametrize("bins,extra", SESSIONS)
@pytest.mark.parametrize("streams", [[], ["--streams", "2"]])
def test_session_matches_jax(bins, extra, streams, tmp_path):
    """The acceptance sessions, one stream and two: exit 0, the JAX CLI's
    text (and SK file where there is one) and the route's path."""
    argv = session_argv(bins, extra, streams)
    kind = {"--sk-file": "sk", "--multitaper": "multitaper",
            "--pfb-taps": "pfb"}[extra[0]]
    path = (f"plain_sk (backend=auto, N={bins})" if kind == "sk"
            else f"plain_{kind} (N={bins})")
    if kind == "sk":
        (rv_j, out_j, err_j, sk_j), (rv_p, out_p, err_p, sk_p) = run_both(
            argv, tmp_path, "sk.txt")
        assert_sk_files_match(sk_j, sk_p)
        assert (f"# Spectra accumulated: {16 * (2 if streams else 1)}\n"
                in sk_p)
    else:
        rv_j, out_j, err_j = run(argv, port=False)
        rv_p, out_p, err_p = run(argv, port=True)
    assert int(rv_j) == int(rv_p) == 0
    assert assert_text_outputs_match(out_j, out_p) == int(bins)
    assert mask_stderr(err_j) == mask_stderr(err_p)
    assert f"Transform path: {path}\n" in err_p


@pytest.mark.parametrize("bins,extra", [("32768", ["--sk-excise", "3"]),
                                        ("65536", ["--multitaper", "7"]),
                                        ("32770", ["--multitaper", "2"])])
def test_matrix_session_matches_jax(bins, extra, tmp_path):
    """``-m``: the .met (but its timing lines) and the .bin row are the
    JAX CLI's, the row within rtol 2e-5 (each step's 8 frames a block of
    the excision gate, the rule of a row of at least 8 frames)."""
    mets, rows = [], []
    for port in (False, True):
        d = tmp_path / ("port" if port else "jax")
        d.mkdir()
        stem = d / "est"
        argv = ["-f", "100M", "-b", bins, "-n", "16", "--frames-per-step",
                "8", "-q", "-m", str(stem), "--source", TONE] + extra
        rv, _, _ = run(argv, port=port)
        assert int(rv) == 0
        mets.append([m for i, m in enumerate(
            (d / "est.met").read_text().split("\n")) if i not in (6, 7, 8)])
        rows.append(np.fromfile(str(stem) + ".bin", dtype=np.float32))
    assert mets[0] == mets[1] and int(mets[1][0].split()[0]) == int(bins)
    assert rows[1].size == int(bins)
    np.testing.assert_allclose(10.0 ** (rows[1] / 10.0),
                               10.0 ** (rows[0] / 10.0), rtol=2e-5)


@pytest.mark.parametrize("extra,what", [
    (["-b", "4194302", "--multitaper", "7"], "--multitaper at 4194302 bins"),
    (["-b", "4194306", "--sk-file", "sk.dat"], "--sk-file at 4194306 bins"),
    (["--streams", "2", "-b", "4194302", "--pfb-taps", "4"],
     "--pfb-taps over --streams at 4194302 bins"),
    (["-b", "2097154", "--sk-file", "sk.dat", "--fft-backend", "bluestein"],
     "--sk-file with --fft-backend bluestein at 2097154 bins"),
])
def test_cli_still_exits_3(extra, what, capsys):
    argv = ["-f", "100M", "-n", "8", "--source", "synthetic:"] + extra
    assert cli.main(argv, device=CPU) == 3
    err = capsys.readouterr().err
    assert "Not yet ported" in err and what in err


@pytest.mark.parametrize("drive,kind,N,streams", [
    ("SK-L", "sk", 32768, 1), ("SK-BL", "sk", 20002, 1),
    ("MT-BL", "mt", 99998, 1), ("SK-BL bluestein", "sk", 32768, 1),
    ("SK-L-S", "sk", 65536, 2), ("MT-L-S", "mt", 65536, 2),
    ("PFB-L-S", "pfb", 32768, 2), ("PFB-BL-S", "pfb", 99998, 2)])
def test_chip_smoke_drive_steps_are_the_sessions(drive, kind, N, streams,
                                                 monkeypatch, tmp_path):
    """chip_smoke.py phase 23 holds each form at the step its drive runs,
    sized by its drive_frames_per_step: the session on the same argv hands
    the form those frames and chunk, and nothing else (each call after the
    first returns the first's rows, as only the shapes are held here)."""
    argv = list((CHIP_SMOKE.EST23_STREAMS_ARGV if streams > 1
                 else CHIP_SMOKE.EST23_ONE_ARGV)[drive])
    if kind == "sk":
        argv += ["--sk-file", str(tmp_path / "sk.txt")]
    table = {"sk": (kurtosis.SK_KERNELS, kurtosis.SK_STREAMS_KERNELS),
             "mt": (multitaper.TAPERS_KERNELS,
                    multitaper.TAPERS_STREAMS_KERNELS),
             "pfb": (pfb.PFB_KERNELS, pfb.PFB_STREAMS_KERNELS)}[kind][
                 streams > 1]
    route = "large" if "-L" in drive else "chirp_large"
    form = table[route]
    at = 3 if kind == "pfb" else 2   # the chunk's argument
    seen, first = [], []

    def recorded(*args, **kwargs):
        seen.append((tuple(args[0].shape), args[at]))
        if not first:
            first.append(form(*args, **kwargs))
        return first[0]

    monkeypatch.setitem(table, route, recorded)
    rv, _, _ = run(argv, port=True)
    F, chunk = spectral.adapt_batch(
        CHIP_SMOKE.drive_frames_per_step(argv, streams))
    shape = (F, 2 * N) if streams == 1 else (streams, F, 2 * N)
    assert int(rv) == 0 and seen and set(seen) == {(shape, chunk)}


# --- the wrappers ---


@pytest.mark.parametrize("N", [16384, 32770, 1 << 23])
def test_wrappers_refuse_n_the_forms_do_not_take(N):
    raw = torch.zeros((8, 2 * N), dtype=torch.uint8)
    hist = torch.zeros((1, 2 * N), dtype=torch.uint8)
    with pytest.raises(ValueError, match="does not take"):
        le.fused_psd_sk_large(raw, 8, 8)
    with pytest.raises(ValueError, match="does not take"):
        le.fused_psd_tapers_large(raw, 8, 8, torch.ones((2, N)))
    with pytest.raises(ValueError, match="does not take"):
        le.fused_psd_pfb_large(raw, hist, 8, 8, torch.ones((2, N)),
                               hist.clone())
    with pytest.raises(ValueError, match="does not take"):
        le.fused_psd_sk_large_streams(
            raw[None], torch.tensor([8], dtype=torch.int32), 8)


def test_wrappers_refuse_bad_arguments():
    N = 32768
    raw = torch.zeros((8, 2 * N), dtype=torch.uint8)
    with pytest.raises(ValueError, match="sigma"):
        le.fused_psd_sk_large(raw, 8, 8, sigma=-1.0)
    with pytest.raises(ValueError, match="group"):
        le.fused_psd_sk_large(raw, 8, 8, group_b=9)
    with pytest.raises(ValueError, match="n_valid"):
        le.fused_psd_sk_large_streams(
            raw[None], torch.tensor([8], dtype=torch.int64), 8)
    with pytest.raises(ValueError, match="tapers"):
        le.fused_psd_tapers_large(raw, 8, 8, torch.ones((2, N - 2)))
    hist = torch.zeros((3, 2 * N), dtype=torch.uint8)
    with pytest.raises(ValueError, match="distinct"):
        le.fused_psd_pfb_large(raw, hist, 8, 8, torch.ones((4, N)), hist)


def test_wrappers_on_cpu_count_as_plain():
    N, F = 32768, 8
    fp.COUNTS.reset()
    raw = torch.from_numpy(frames(F, N, 3))
    nv = torch.tensor([F], dtype=torch.int32)
    h = torch.ones((2, N))
    hist = [torch.zeros((1, 2 * N), dtype=torch.uint8) for _ in range(2)]
    le.fused_psd_sk_large(raw, F, F)
    le.fused_psd_tapers_large(raw, F, F, torch.ones((2, N)))
    le.fused_psd_pfb_large(raw, hist[0], F, F, h, hist[1])
    le.fused_psd_sk_large_streams(raw[None], nv, F)
    le.fused_psd_tapers_large_streams(raw[None], nv, F, torch.ones((2, N)))
    le.fused_psd_pfb_large_streams(raw[None], hist[0][None], nv, F, h,
                                   hist[1][None])
    counts = vars(fp.COUNTS)
    assert counts["plain"] == 6
    assert not any(v for k, v in counts.items() if k != "plain")


def test_streams_references_are_the_one_stream_forms_per_stream():
    """Each stream of the streams forms' plain versions is the one-stream
    plain version on its frames and count (its history for the PFB),
    within 1e-5."""
    S, F, N = 2, 8, 32768
    raw = torch.from_numpy(streams_bytes(S, F, N, seed=5))
    counts = [F, 3]
    nv = torch.tensor(counts, dtype=torch.int32)
    tp = torch.from_numpy(multitaper._session_tapers(N, 4.0, 3))
    h = torch.from_numpy(pfb.pfb_prototype(N, 4).reshape(4, N))
    sk = le.sk_large_streams_reference(raw, nv, 8, None, 3.0)
    mt = le.tapers_large_streams_reference(raw, nv, 8, tp)
    hist = [torch.full((S, 3, 2 * N), 127, dtype=torch.uint8)
            for _ in range(2)]
    pf = le.pfb_large_streams_reference(raw, hist[0], nv, 8, h, hist[1])
    for s, c in enumerate(counts):
        one_hist = [torch.full((3, 2 * N), 127, dtype=torch.uint8),
                    torch.empty((3, 2 * N), dtype=torch.uint8)]
        np.testing.assert_allclose(
            sk[s].numpy(), le.sk_large_reference(
                raw[s], c, 8, None, 3.0).numpy(), rtol=1e-5)
        np.testing.assert_allclose(
            mt[s].numpy(), le.tapers_large_reference(
                raw[s], c, 8, tp).numpy(), rtol=1e-5)
        np.testing.assert_allclose(
            pf[s].numpy(), le.pfb_large_reference(
                raw[s], one_hist[0], c, 8, h, one_hist[1]).numpy(),
            rtol=1e-5)
        assert torch.equal(hist[1][s], one_hist[1])


@pytest.mark.parametrize("wname", [None, "hann"])
def test_plain_power_is_the_plain_psd_steps(wname):
    """The forms' plain transform is the large kernel's four steps in
    torch ops: the plain PSD step's bits frame by frame, and the SK form's
    s1 the plain PSD step's output."""
    N, F = 65536, 8
    w = None if wname is None else torch.from_numpy(make_window(wname, N))
    raw = torch.from_numpy(frames(F, N, 21))
    p = fl.large_power(raw, w)
    for nv in (F, 3):
        want = p.clone()
        want[nv:] = 0.0
        assert torch.equal(fl.fused_psd_large_reference(raw, nv, 8, w),
                           want.reshape(1, 8, N).sum(1).sum(0))
        assert torch.equal(le.sk_large_reference(raw, nv, 8, w)[0],
                           fl.fused_psd_large_reference(raw, nv, 8, w))


# --- the forms' new index arithmetic, transcribed ---


W16 = header_w16().astype(np.complex64)


def pass_a_load(ring_f, N, load):
    """The large kernel's pass A (test_torch_fused_psd_large_regs.pass_a)
    on one frame with PFB-L's load: each thread's 16 samples n = (t + k
    TF1) N2 + c0 + s B + c, the frame's own row from the ring (filled from
    ``ring_f``), made by ``load(re, im, n)``; then the column transform and
    the stores as pass A's. Returns the frame's scratch."""
    t = fl.regs_layout(N)
    N1, N2, C, B = t["N1"], t["N2"], t["C"], t["B"]
    l2 = N2.bit_length() - 1
    tiles = N2 // C
    tw = pass_twiddles_c64(N1)
    table = fl.regs_inter_twiddle(N)
    parts = 2 * C // 16
    ring = np.zeros((tiles, N1 * 2 * C), np.uint8)
    q = np.arange(N1 * parts)
    row, part = q // parts, q % parts
    for j in range(tiles):
        src = row * 2 * N2 + 2 * C * j + 16 * part
        dst = ring_offset(t, row, part)
        for b in range(16):
            ring[j, dst + b] = ring_f[src + b]
    tid = np.arange(t["threads_a"])
    c, th = col_of(t, tid), row_of(t, tid)
    k = np.arange(16)
    rows = th[:, None] + k[None, :] * t["TF1"]
    scratch = np.full(N, np.nan, np.complex64)
    e = np.arange(B * N1)
    for s in range(t["subs"]):
        col = s * B + c
        byte = 2 * col[:, None]
        addr = ring_offset(t, rows, byte >> 4) + (byte & 15)
        re_own = ring[:, addr].astype(np.float32) - np.float32(127)
        im_own = ring[:, addr + 1].astype(np.float32) - np.float32(127)
        n = (rows[None] << l2) + np.arange(tiles)[:, None, None] * C \
            + col[None, :, None]
        re, im = load(re_own, im_own, n)
        v = (re + 1j * im).astype(np.complex64)
        cc = np.broadcast_to(c, v.shape[:-1])
        y = batch_transform(v, th, lambda e: col_index(t, cc, e), N1, tw,
                            W16, B * t["XS"])
        k1 = pass_bin(N1, last_element(N1, th[:, None], k[None, :]))
        xs = np.full((tiles, B * t["XS"]), np.nan, np.complex64)
        xs[:, col_index(t, c[:, None], k1)] = y
        run_ = (np.arange(tiles)[:, None] * (C // B) + s) * N1 * B + e
        scratch[run_] = xs[:, col_index(t, e % B, e // B)] * table[run_]
    return scratch


def pass_b_power(scratch_f, N):
    """|X|^2 of one frame by pass B's slots: (tiles, threads, 16)
    float32."""
    t = fl.regs_layout(N)
    p = np.zeros((t["tiles_b"], 256, 16), np.float32)
    pass_b(scratch_f, p, t, W16)
    return p


def streams_rows(S, F, N, counts, planes, power, windowed=False):
    """Pass B over S streams of F frames on L-S's grid for an H100's
    residency: block (x, s) sums ``power(s, f)`` ((planes, tiles, threads,
    16) float32) over stream s's frames of group x / TILES_B, writing
    plane p's sums by bin into partial row (p S + s) G_s + x / TILES_B.
    Returns (partial rows, G_s)."""
    t = fl.regs_layout(N)
    _, group_b, G_s = fl.streams_grid(S, F, N, *h100_resident(N))
    partial = np.full((planes * S * G_s, N), np.nan, np.float32)
    for s in range(S):
        for j in range(G_s):
            acc = np.zeros((planes, t["tiles_b"], 256, 16), np.float32)
            for f in range(j * group_b, min((j + 1) * group_b, F,
                                            counts[s])):
                acc += power(s, f)
            for p in range(planes):
                partial[(p * S + s) * G_s + j] = pass_b_bins(acc[p], t)
    return partial, G_s


@pytest.mark.parametrize("N,counts,wname", [(32768, (3, 1), None),
                                            (65536, (2, 0), "hann")])
def test_second_plane_transcription(N, counts, wname):
    """SK-L's pass B: |X|^2 and its square summed by slot, the s1 row to
    (0 S + s) G_s + j and the s2 row to (S + s) G_s + j, each staged by
    bin as pass B stages its row; each plane summed per stream: s1 is the
    large kernel's transcription of the stream bit for bit (on its grid),
    within 1e-5 of the float64 sum of |X|^2, and s2 within the SK rule of
    the float64 sum of |X|^4 and of the plain SK-L."""
    S, F = 2, 3
    w = None if wname is None else make_window(wname, N)
    raw = streams_bytes(S, F, N, seed=N)
    t = fl.regs_layout(N)
    cache = {}

    def power(s, f):
        if (s, f) not in cache:
            p = pass_b_power(pass_a(raw[s, f], w, t, W16), N)
            cache[(s, f)] = np.stack([p, p * p])
        return cache[(s, f)]

    planes, G_s = streams_rows(S, F, N, counts, 2, power)
    assert fl.streams_grid(S, F, N, *h100_resident(N))[1] \
        == fl.regs_grid(F, N, *h100_resident(N))[1]
    for s, c in enumerate(counts):
        s1 = stream_rows_sum(planes, S, G_s, 1, s)
        s2 = stream_rows_sum(planes[S * G_s:], S, G_s, 1, s)
        if c == 0:
            assert not s1.any() and not s2.any()
            continue
        assert np.array_equal(s1, regs_transcription(
            raw[s], c, w, h100_resident(N))[0])
        p = power64(raw[s, :c], w)
        wt = None if w is None else torch.from_numpy(w)
        plain = le.fused_psd_sk_large(torch.from_numpy(raw[s]), c, F,
                                      wt)[1].numpy().astype(np.float64)
        s4 = (p * p).sum(0)
        close(s1, p.sum(0), c, 1e-5)
        own = np.abs(plain - s4).max() / s4.mean()
        close(s2, s4, c, 2e-5 if c >= 8 else max(2e-5, 3 * own))
        close(s2, plain, c, 2e-5 if c >= 8 else max(2e-5, 3 * own))


@pytest.mark.parametrize("N,P,F,counts", [(32768, 4, 3, (3, 1)),
                                          (65536, 2, 2, (2,)),
                                          (32768, 16, 3, (0, 3, 2)),
                                          (65536, 32, 2, (1, 2))])
def test_pfb_prepass_transcription(N, P, F, counts):
    """PFB-L's pre-pass (every sample of the frame's N1 x N2 array) over S
    streams with uneven counts: its window holds the virtual rows each
    output frame needs, its sums are the plain sums bit for bit, and pass
    A on L-S's grid reads each sample's sum (16 rows a thread) where the
    pre-pass wrote it."""
    S = len(counts)
    rng = np.random.default_rng(N + P + S)
    virtual = rng.integers(0, 256, (S, P - 1 + F, 2 * N), dtype=np.uint8)
    h = pfb.pfb_prototype(N, P, "hann").reshape(P, N)
    group_a = fl.streams_grid(S, F, N, *h100_resident(N))[0]
    hold_prepass(virtual, h, list(counts), le.sums_shape(N),
                 fl.regs_layout(N), group_a, 16)


@pytest.mark.parametrize("form", ["control", "sums"])
@pytest.mark.parametrize("N,P,F,nv", [(32768, 4, 3, 3), (65536, 2, 2, 1)])
def test_pfb_pass_a_rows_transcription(N, P, F, nv, form):
    """PFB-L's pass A, in its control's form (frame j's own row from the
    ring, filled from virtual row j + P - 1, the older rows from the
    history or the earlier frames) or on the pre-pass's sums (read from
    the scratch where the pre-pass wrote them), the polyphase sum before
    the column transform: the large kernel's transcription of those sums,
    through pass B, sums within 1e-5 of the float64 form and of the plain
    PFB-L, and the next history is the virtual rows from n_valid."""
    rng = np.random.default_rng(N + P)
    slot = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
    history = rng.integers(0, 256, (P - 1, 2 * N), dtype=np.uint8)
    h = pfb.pfb_prototype(N, P, "hann").reshape(P, N)
    virtual = np.concatenate([history, slot])
    t = fl.regs_layout(N)
    shape = le.sums_shape(N)
    scratch = prepass_sums(virtual[None], h, [nv], shape)[0][0]

    def load_of(j):
        return (polyphase_load(virtual, j, P, h) if form == "control"
                else sums_load(scratch[j], shape))

    group_a, group_b, G = fl.regs_grid(F, N, *h100_resident(N))
    rows = []
    for g in range(G):
        acc = np.zeros((t["tiles_b"], 256, 16), np.float32)
        for j in range(g * group_b, min((g + 1) * group_b, F, nv)):
            acc += pass_b_power(pass_a_load(
                virtual[j + P - 1], N, load_of(j)), N)
        rows.append(pass_b_bins(acc, t))
    got = np.sum(np.asarray(rows, np.float64), 0)
    s64 = sum(z64(virtual)[p:p + nv] * h[p].astype(np.float64)
              for p in range(P))
    direct = (np.abs(np.fft.fft(s64, axis=1)) ** 2).sum(0)
    np.testing.assert_allclose(got, direct, rtol=1e-5,
                               atol=1e-6 * direct.mean())
    hist = [torch.from_numpy(history.copy()),
            torch.empty((P - 1, 2 * N), dtype=torch.uint8)]
    plain = le.pfb_large_reference(torch.from_numpy(slot), hist[0], nv, F,
                                   torch.from_numpy(h), hist[1]).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5,
                               atol=1e-6 * direct.mean())
    np.testing.assert_array_equal(hist[1].numpy(), virtual[nv:nv + P - 1])


def ring_sums(history, raw, h, counts, group, resident):
    """PFB-L's pass A on the ring (``large_pfb_ring_a``), its polyphase
    sums transcribed over its grid: block (tile, group, stream) loads
    virtual rows j0 .. j0 + P - 1 (row v from the history where v < P - 1,
    else frame v - (P - 1)) into ring slots v mod P in the own row's
    layout (ring_offset), and after each frame j but its last row j + P
    into slot j mod P; frame j's sum takes tap p from slot (j + p) mod P,
    which must hold virtual row j + p, and h from the resident (P, N1, C)
    slice or from batch s's (N1, B) tile of tap p. Returns ((S, F, N)
    complex64 sums, NaN where no block forms one; the loads by source)."""
    S, F, N2x = raw.shape
    N = N2x // 2
    P = h.shape[0]
    t = fl.regs_layout(N)
    N1, N2, C, B = t["N1"], t["N2"], t["C"], t["B"]
    parts = 2 * C // 16
    q = np.arange(N1 * parts)
    qrow, qpart = q // parts, q % parts
    rows = np.arange(N1)[:, None]
    cols = np.arange(C)[None, :]
    byte = 2 * cols
    addr = ring_offset(t, np.broadcast_to(rows, (N1, C)), byte >> 4) \
        + (byte & 15)
    out = np.full((S, F, N), np.nan, np.complex64)
    loads = {"history": 0, "frames": 0}
    for s in range(S):
        nv = min(max(counts[s], 0), F)
        for j0 in range(0, F, group):
            frames = max(min(j0 + group, nv) - j0, 0)
            for c0 in range(0, N2, C) if frames else ():
                ring = np.zeros((P, N1 * 2 * C), np.uint8)
                holds = [-1] * P

                def load(v):
                    src_row = (history[s, v] if v < P - 1
                               else raw[s, v - (P - 1)])
                    loads["history" if v < P - 1 else "frames"] += 1
                    src = qrow * 2 * N2 + 2 * c0 + 16 * qpart
                    dst = ring_offset(t, qrow, qpart)
                    for b in range(16):
                        ring[v % P, dst + b] = src_row[src + b]
                    holds[v % P] = v

                hsl = np.stack([h[p].reshape(N1, N2)[:, c0:c0 + C]
                                for p in range(P)])
                for p in range(P):
                    load(j0 + p)
                for i in range(frames):
                    j = j0 + i
                    re = np.zeros((N1, C), np.float32)
                    im = np.zeros((N1, C), np.float32)
                    for p in range(P):
                        slot = (j + p) % P
                        assert holds[slot] == j + p
                        if resident:
                            hv = hsl[p]
                        else:
                            hv = np.concatenate(
                                [hsl[p][:, b * B:(b + 1) * B]
                                 for b in range(C // B)], axis=1)
                        xr = ring[slot][addr].astype(np.float32) \
                            - np.float32(127)
                        xi = ring[slot][addr + 1].astype(np.float32) \
                            - np.float32(127)
                        re = re + xr * hv
                        im = im + xi * hv
                    if i + 1 < frames:
                        load(j + P)
                    n = rows * N2 + c0 + cols
                    out[s, j, n] = re + 1j * im
    return out, loads


@pytest.mark.parametrize("N,P,F,counts,group,resident", [
    (32768, 4, 5, (5, 3), 2, False), (65536, 3, 4, (4,), 3, True),
    (1 << 20, 2, 2, (2, 1), 1, False), (32768, 1, 3, (3,), 2, False),
    (65536, 6, 3, (0, 3), 3, True)])
def test_pfb_ring_transcription(N, P, F, counts, group, resident):
    """PFB-L's ring of virtual rows over S streams with uneven counts and
    a group start past the history (group < F): every slot a frame reads
    holds the virtual row its tap needs, the history's rows are loaded
    only by blocks whose first frame needs them, and the sums are the
    plain sums bit for bit (h resident or streamed)."""
    S = len(counts)
    rng = np.random.default_rng(N + P + S)
    history = rng.integers(0, 256, (S, max(P - 1, 0), 2 * N), dtype=np.uint8)
    raw = rng.integers(0, 256, (S, F, 2 * N), dtype=np.uint8)
    h = pfb.pfb_prototype(N, P, "hann").reshape(P, N)
    got, loads = ring_sums(history, raw, h, counts, group, resident)
    tiles = fl.regs_layout(N)["tiles_a"]
    firsts = [j0 for s in range(S) for j0 in range(0, F, group)
              if j0 < min(counts[s], F)]
    assert loads["history"] == tiles * sum(max(P - 1 - j0, 0)
                                           for j0 in firsts)
    for s, c in enumerate(counts):
        c = min(c, F)
        want = fpf.pfb_sums_reference(
            torch.from_numpy(np.concatenate([history[s], raw[s]])),
            torch.from_numpy(h), c).numpy()
        assert np.array_equal(got[s, :c].view(np.uint64),
                              want.view(np.uint64))
        assert np.isnan(got[s, c:]).all()


@pytest.mark.parametrize("N,K,counts", [(32768, 2, (3, 0)),
                                        (65536, 3, (2, 1))])
def test_taper_loop_rows_transcription(N, K, counts):
    """MT-L: both passes once a taper (pass A windowed by taper row k),
    taper k's pass B writing partial row (k S + s) G_s + j;
    est_streams_kernel<kEstTapers> sums each stream's K G_s rows in its
    order and divides by K: within 1e-5 of the float64 form and of the
    plain MT-L-S."""
    S, F = 2, 3
    raw = streams_bytes(S, F, N, seed=N + K)
    tapers = multitaper._session_tapers(N, 4.0, K)
    t = fl.regs_layout(N)
    planes, G_s = streams_rows(
        S, F, N, counts, K, lambda s, f: np.stack([pass_b_power(pass_a(
            raw[s, f], tapers[k], t, W16), N) for k in range(K)]))
    got = np.stack([stream_rows_sum(planes, S, G_s, K, s)
                    for s in range(S)]) / np.float32(K)
    plain = le.tapers_large_streams_reference(
        torch.from_numpy(raw), torch.tensor(counts, dtype=torch.int32), F,
        torch.from_numpy(tapers)).numpy()
    for s, c in enumerate(counts):
        if c == 0:
            assert not got[s].any() and not plain[s].any()
            continue
        direct = (np.abs(np.fft.fft(
            z64(raw[s, :c])[:, None, :] * tapers.astype(np.float64)[None],
            axis=-1)) ** 2).mean(axis=1).sum(axis=0)
        np.testing.assert_allclose(got[s], direct, rtol=1e-5,
                                   atol=1e-6 * direct.mean())
        np.testing.assert_allclose(got[s], plain[s], rtol=1e-5,
                                   atol=1e-6 * direct.mean())


# --- the sources ---


def test_the_large_kernel_and_its_forms_share_the_streams_passes():
    """L-S's passes live in one header that the large kernel and the forms
    both include, not in a copy; the forms' source instantiates every log2
    N from 15 to 22 and names its passes as PASS_A .. PFB_RING_RES_A number
    them (the PFB's pass A on the pre-pass's sums, the pre-pass at two tap
    classes, the control's pass A, the ring's pass A at P = 4, h streamed
    and h resident)."""
    header = (CSRC / "fused_psd_large_streams.cuh").read_text()
    large = (CSRC / "fused_psd_large.cu").read_text()
    est = (CSRC / "fused_psd_large_est.cu").read_text()
    for src in (large, est):
        assert '#include "fused_psd_large_streams.cuh"' in src
    for name in ("large_streams_a(", "large_streams_b("):
        assert name in header
        assert name not in large and name not in est
    assert [int(m) for m in re.findall(
        r"case (\d+): return fn\(std::integral_constant<int, (?:\d+)>",
        est)] == list(range(15, 23))
    order = re.findall(r"case (\d): return reinterpret_cast<const void\*>\("
                       r"(\w+)<", est)
    assert [int(i) for i, _ in order] == [le.PASS_A, le.PASS_A_WINDOWED,
                                          le.PASS_B, le.SK_PASS_B,
                                          le.PFB_PASS_A]
    assert [k for _, k in order] == ["large_streams_a", "large_streams_a",
                                     "large_streams_b", "large_sk_b",
                                     "large_pfb_sums_a"]
    assert f"case {le.PFB_SUMS}: return sums_kernel<4>();" in est
    assert f"case {le.PFB_SUMS_32}: return sums_kernel<32>();" in est
    assert ("default: return reinterpret_cast<const void*>(large_pfb_a<LOG2N>)"
            in est)
    assert int(re.search(r"constexpr int kPasses = (\d+);", est).group(1)) \
        == le.PFB_RING_RES_A + 1
    for which, resident in ((le.PFB_RING_A, "false"),
                            (le.PFB_RING_RES_A, "true")):
        assert re.search(rf"which == kPfbRing{'Res' * (resident == 'true')}"
                         rf"A\s+\? ring_a_smem<LOG2N>\(4, {resident}\)", est)
    assert '#include "pfb_sums.cuh"' in est


def c_table(text, name):
    """The int values of the constexpr array ``name`` of a source, in
    order (its comments dropped)."""
    body = text[text.index(name):]
    body = body[body.index("= {") + 3:body.index("};")]
    return [int(v) for v in re.findall(r"\d+", re.sub(r"//[^\n]*", "",
                                                      body))]


#: Shared memory a block can take on an H100, and an SM's.
BLOCK_SMEM, SM_SMEM = 232448, 233472


@pytest.mark.parametrize("library", ["fused_psd_large_est",
                                     "fused_psd_chirp_large_est"])
def test_pfb_route_table_is_the_sources(library):
    """PFB-L's route by (log2 N, frames, tap class) is the source's
    kPfbRoute, a row a log2 from 15 to 22, a column for few then many
    frames a call (from kPfbManyFrames), an entry a class of sums_taps,
    each value a PfbRoute numbered as ROUTES; PFB-BL's source has no table
    (the pre-pass at every M, P and frame count); each control takes the
    first form at every P."""
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_chirp_large_est as be
    text = (CSRC / f"{library}.cu").read_text()
    if library == "fused_psd_chirp_large_est":
        assert "kPfbLoad" not in text
        assert "static_cast<float*>(out), device, control);" in text
        assert {be.pfb_route(N, P, F) for N in (8194, 99998, 2097150)
                for P in range(1, 33) for F in (1, 64)} == {"sums"}
        return
    assert c_table(text, "kPfbRoute[") == [v for k in range(15, 23)
                                           for few_many in le.PFB_ROUTE[k]
                                           for v in few_many]
    assert ("control ? kRouteLoad\n                  : kPfbRoute[log2n - "
            "kMinLog2N][S * F >= kPfbManyFrames]") in text
    assert int(re.search(r"constexpr int kPfbManyFrames = (\d+);",
                         text).group(1)) == le.MANY_FRAMES
    assert le.pfb_route(1 << 16, 4, le.MANY_FRAMES - 1) == "load"
    assert le.pfb_route(1 << 16, 4, le.MANY_FRAMES) == "ring_res"
    enum = dict(re.findall(r"(kRoute\w+) = (\d+)", text))
    assert enum == {"kRoute" + "".join(w.capitalize() for w in name.split(
        "_")): str(i) for i, name in enumerate(le.ROUTES)}
    assert le.TAP_CLASSES == tuple(le.sums_taps(P) for P in (2, 4, 8, 16, 32))
    assert [le.sums_taps(P) for P in range(1, 33)] == [
        next(c for c in le.TAP_CLASSES if P <= c) for P in range(1, 33)]


@pytest.mark.parametrize("log2n", range(15, 23))
def test_pfb_shared_memory_plan_fits(log2n):
    """Every (log2 N, P <= 32) of PFB-L's and PFB-BL's route tables runs a
    pass A whose shared memory fits a block's 227 KB: the first form's
    where the table gives it, the ring's (P raw slots, h resident or two
    of its tiles in the exchange) only at N <= 2^21, the exchange and two
    slots of a batch's sums elsewhere, two blocks of which fit an SM; the
    pre-pass's 16 x 32 samples turn through 4352 B."""
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_chirp_large_est as be
    N = 1 << log2n
    bl_n = (1 << (log2n - 1)) - 2      # an even N with M = 2^log2n
    for m, n in ((le, N), (be, bl_n)):
        for P, frames in ((P, F) for P in range(1, 33) for F in (1, 64)):
            route = m.pfb_route(n, P, frames)
            smem = m.pfb_smem(n, route, P)
            assert smem <= BLOCK_SMEM, (n, P, route, smem)
            if route.startswith("ring"):
                assert m is le and n <= le.RING_MAX_N, (n, P, route)
            if route == "sums":
                assert 2 * (smem + 1024) <= SM_SMEM
        assert 8 * le.SUMS_TURN * le.SUMS_COLS == 4352
    t = fl.regs_layout(N)
    assert le.pfb_smem(N, "load") == t["smem_a"]
    ring = 8 * t["B"] * t["XS"] + 4 * t["N1"] * 2 * t["C"]
    assert le.pfb_smem(N, "ring") == ring
    assert le.pfb_smem(N, "ring_res") == ring + 16 * t["N1"] * t["C"]
    assert 2 * 4 * t["N1"] * t["B"] <= 8 * t["B"] * t["XS"]


def test_pfb_controls_run_plain_on_the_cpu():
    """On the CPU the PFB forms' controls count as plain calls, as the
    forms do, and give the forms' outputs and histories."""
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_chirp_large_est as be
    fp.COUNTS.reset()
    for m, N, name in ((le, 32768, "large"), (be, 8194, "chirp_large")):
        raw = torch.from_numpy(frames(3, N, 29))
        h = torch.from_numpy(pfb.pfb_prototype(N, 4).reshape(4, N))
        hist = torch.from_numpy(frames(3, N, 30))
        outs = [torch.empty_like(hist) for _ in range(4)]
        one = getattr(m, f"fused_psd_pfb_{name}")(raw, hist, 2, 3, h,
                                                   outs[0])
        ctl = getattr(m, f"fused_psd_pfb_{name}_control")(raw, hist, 2, 3, h,
                                                          outs[1])
        nv = torch.tensor([2], dtype=torch.int32)
        s = getattr(m, f"fused_psd_pfb_{name}_streams")(
            raw[None], hist[None], nv, 3, h, outs[2][None])
        sc = getattr(m, f"fused_psd_pfb_{name}_streams_control")(
            raw[None], hist[None], nv, 3, h, outs[3][None])
        assert torch.equal(one, ctl) and torch.equal(s, sc)
        assert all(torch.equal(outs[0], o) for o in outs[1:])
    counts = vars(fp.COUNTS)
    assert counts["plain"] == 8
    assert not any(v for k, v in counts.items() if k != "plain")


def test_wide_history_blocks_cover_each_row_once():
    """pfb_history_wide_kernel (rows of 2N >= 64 KB: N >= 32768): block
    (x, r, s) copies words [x, x + 1) * kWideHistoryWords of row r, up to
    the row's end, so the grid's blocks copy every word of every row once;
    smaller rows keep pfb_history_kernel, whose one block a row is every
    earlier library's."""
    text = (CSRC / "pfb_history.cuh").read_text()
    wide = int(re.search(r"kWideHistoryBytes = (\d+);", text).group(1))
    words = int(re.search(r"kWideHistoryWords = 256 \* (\d+);",
                          text).group(1)) * 256
    assert wide == 65536 == 4 * 16384
    for N in (32768, 65536, 2097150, 1 << 22):
        row_words = 2 * N // 4
        blocks = -(-row_words // words)
        seen = np.zeros(row_words, np.int64)
        for x in range(blocks):
            for tid in range(256):
                i = np.arange(x * words + tid, min(row_words,
                                                   (x + 1) * words), 256)
                seen[i] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("name", sorted(large_estimator_builds.BUILDS))
def test_probe_builds_edit_the_shipped_source(name):
    """Each build of probes/large_estimator_builds.py edits the shipped
    source where it still reads as the edit expects."""
    text = (CSRC / large_estimator_builds.BUILDS[name][0]).read_text()
    assert large_estimator_builds.edited(name, text) != text


def test_probe_without_a_card_exits_1(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert large_estimator_builds.main([]) == 1
