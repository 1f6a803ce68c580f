"""The CLI estimators at the large even 7-smooth bin counts against the JAX
package's, on the CPU, where the port's steps are the forms' plain PyTorch
versions: SK-ML, MT-ML, PFB-ML and their calls over streams
(csrc/fused_psd_mixed_large_est.cu, forms of ML's two passes at every even
7-smooth N from 16386 to 2^22 that is not a power of two).

The session steps (``--sk-file``, ``--sk-excise``, ``--multitaper``,
``--pfb-taps``) at N = 20000, 49152 and 100000 with n_valid F, F - 1, 1 and
0 (Hann for SK, the gate, K = 7 tapers, the PFB's Blackman prototype at P
= 4), against the JAX steps on the same seeded numpy bytes and against a
direct float64 form; the streams steps at S = 2 with uneven counts against
the JAX sharded steps; whole CLI sessions against the JAX CLI's (text, SK
file, ``.bin`` and ``.met``); the routes of all 1192 N, and that a session
estimator now exits 3 only where the PSD step does. Tolerances are
test_torch_estimators_large.py's: rtol 2e-5 (4e-5 for a sum of |X|^4)
where a row sums at least 8 frames; under 8 frames the largest error over
the row's mean power, against the float64 direct form within that or 3x
the JAX step's own error there (close_to_both); no frame, exact zeros; the
``kept`` row exact; s1 the plain PSD step's bit for bit.

The kernels run only on a card (chip_smoke.py phase 24). Their new index
arithmetic is transcribed in numpy on ML's thread-by-thread transcription
(tests/test_torch_large_awkward_regs.py): SK-ML's second plane of |X|^4
sums and its rows (p S + s) G_s + j, PFB-ML's pass-0 loads (for each
column and row n1 of a tile, the virtual row and the h element of each
tap, the frame's own row from the ring), and MT-ML's taper loop and its
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
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_large as fl
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed as fm
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed_large as ml
from rtl_power_fftw_tpu_torch.ops.kernels import \
    fused_psd_mixed_large_est as me
from rtl_power_fftw_tpu_torch.ops.kernels.fused_psd_pfb import \
    pfb_sums_reference
from rtl_power_fftw_tpu_torch.ops.spectral import PsdStep

from test_torch_awkward_n import CHIP_SMOKE
from test_torch_estimator_streams import (MESH, assert_combined_close,
                                          assert_rows_close, jax_mesh,
                                          stream_rows_sum, streams_bytes)
from test_torch_estimators_chirp_large import (close, direct_pfb_steps,
                                               power64)
from test_torch_estimators_large import close_to_both
from test_torch_estimators_mixed import TONE, frames, z64
from test_torch_fused_psd_mixed_large import session_rtol
from test_torch_kurtosis import assert_sk_files_match, run_both
from test_torch_large_awkward_regs import (CSRC, RESIDENT, ml_pass_a,
                                           ml_pass_b, ml_tables,
                                           ml_transcription)
from test_torch_session import assert_text_outputs_match, mask_stderr, run

CPU = torch.device("cpu")
#: The bin counts of the steps' tests: 125 x 160, 192 x 256, 250 x 400.
SIZES = [20000, 49152, 100000]
ML_SIZES = ml.eligible_sizes()


@pytest.fixture(autouse=True)
def _reset_interrupts():
    for module in (interrupts, jax_interrupts):
        module.reset()
    yield
    for module in (interrupts, jax_interrupts):
        module.reset()


# --- the routes ---


@pytest.mark.parametrize("flag", spectral.CLI_ESTIMATORS)
@pytest.mark.parametrize("sharded", [False, True])
def test_every_ml_n_routes_to_the_forms(flag, sharded):
    """All 1192 N of ML take ML's forms, on one stream and over streams;
    SK under ``bluestein`` keeps BL's forms up to 2^21."""
    assert len(ML_SIZES) == 1192
    for N in ML_SIZES:
        assert spectral.estimator_route(N, flag, sharded=sharded) \
            == "mixed_large"
        if flag.startswith("--sk") and N <= (1 << 21):
            assert spectral.estimator_route(N, flag, "bluestein",
                                            sharded) == "chirp_large"


def test_estimators_exit_3_only_where_the_psd_step_does():
    """Over a sample of N (odd and even, to 2^22 + 2^20) and every N near
    the bands' edges, a session estimator is refused exactly where the PSD
    step's transform route is, on one stream and over streams."""
    rng = np.random.default_rng(28)
    sample = set(int(n) for n in rng.integers(2, (1 << 22) + (1 << 20),
                                              1500))
    for edge in (8192, 16384, 1 << 21, 1 << 22):
        sample.update(range(edge - 6, edge + 7))
    sample.update((4167450, 4194302, 4194304, 4194306))

    def refused(fn):
        try:
            fn()
        except RPFexception as e:
            assert int(e.return_value) == 3
            return True
        return False

    for N in sorted(sample):
        psd = refused(lambda: spectral.transform_route(N))
        for flag in spectral.CLI_ESTIMATORS:
            for sharded in (False, True):
                assert refused(lambda: spectral.estimator_route(
                    N, flag, sharded=sharded)) is psd, (N, flag, sharded)


@pytest.mark.parametrize("N,flag,backend,sharded,route", [
    (20000, "--sk-file", "auto", False, "mixed_large"),
    (49152, "--sk-excise", "auto", True, "mixed_large"),
    (100000, "--multitaper", "auto", False, "mixed_large"),
    (1000000, "--pfb-taps", "auto", True, "mixed_large"),
    (4167450, "--sk-file", "auto", True, "mixed_large"),
    (100000, "--multitaper", "bluestein", True, "mixed_large"),
    (100000, "--sk-file", "bluestein", False, "chirp_large"),
    (1 << 20, "--sk-file", "auto", False, "large"),
    (99998, "--pfb-taps", "auto", False, "chirp_large"),
    (4194302, "--sk-file", "auto", False, None),
    (4194302, "--multitaper", "auto", True, None),
    (1 << 23, "--pfb-taps", "auto", False, None),
    (20001, "--sk-excise", "auto", False, None),
    (20000, "spectrogram", "auto", False, None),
])
def test_estimator_route(N, flag, backend, sharded, route):
    if route is not None:
        assert spectral.estimator_route(N, flag, backend, sharded) == route
        return
    with pytest.raises(RPFexception, match="Not yet ported") as e:
        spectral.estimator_route(N, flag, backend, sharded)
    assert f"{flag}{' over --streams' * sharded} at {N} bins" \
        in str(e.value)
    if flag.startswith("--"):
        assert "not the other even N above 2097152, nor odd N" \
            in str(e.value)


@pytest.mark.parametrize("table,one,streams", [
    ((kurtosis.SK_KERNELS, kurtosis.SK_STREAMS_KERNELS),
     me.fused_psd_sk_mixed_large, me.fused_psd_sk_mixed_large_streams),
    ((multitaper.TAPERS_KERNELS, multitaper.TAPERS_STREAMS_KERNELS),
     me.fused_psd_tapers_mixed_large,
     me.fused_psd_tapers_mixed_large_streams),
    ((pfb.PFB_KERNELS, pfb.PFB_STREAMS_KERNELS),
     me.fused_psd_pfb_mixed_large, me.fused_psd_pfb_mixed_large_streams),
])
def test_each_step_maps_the_route_to_its_form(table, one, streams):
    assert table[0]["mixed_large"] is one
    assert table[1]["mixed_large"] is streams


@pytest.mark.parametrize("N,ok", [(16384, False), (16464, True),
                                  (20000, True), (32768, False),
                                  (20002, False), (4167450, True),
                                  (1 << 22, False), (4194302, False)])
def test_eligible(N, ok):
    assert me.fused_psd_mixed_large_est_eligible(N) is ok


# --- the session steps against the JAX steps ---


@pytest.mark.parametrize("N,wname", [(20000, None), (49152, "hann"),
                                     (100000, None)])
def test_sk_step_matches_direct_and_jax(N, wname):
    F = 8
    w = None if wname is None else make_window(wname, N)
    step = kurtosis.SkSessionStep(N, F, CPU, window=w)
    jstep = jax_kurtosis.SkSessionStep(N, F, window=w)
    assert step._kernel is me.fused_psd_sk_mixed_large
    assert step.path == "plain_sk"
    raw = frames(F, N, N + 1)
    for nv in (F, F - 1, 1, 0):
        got = [t.numpy().astype(np.float64) for t in step(raw, nv)]
        want = [np.asarray(a, np.float64) for a in jstep(raw, nv)]
        p = power64(raw[:nv], w)
        for i, direct in enumerate((p.sum(0), (p * p).sum(0))):
            close_to_both(got[i], want[i], direct, nv, (i + 1) * 2e-5)


@pytest.mark.parametrize("N,wname", [(20000, "hann"), (100000, None)])
def test_sk_excise_step_matches_jax(N, wname):
    F, sigma = 8, 3.0
    w = None if wname is None else make_window(wname, N)
    step = kurtosis.SkSessionStep(N, F, CPU, window=w, excise_sigma=sigma)
    jstep = jax_kurtosis.SkSessionStep(N, F, window=w, excise_sigma=sigma)
    raw = frames(F, N, 31)
    s1, s2, s1c, kept = (t.numpy().astype(np.float64) for t in step(raw, F))
    j = [np.asarray(a, np.float64) for a in jstep(raw, F)]
    np.testing.assert_allclose(s1, j[0], rtol=2e-5)
    np.testing.assert_allclose(s2, j[1], rtol=4e-5)
    np.testing.assert_array_equal(kept, j[3])
    np.testing.assert_allclose(s1c, j[2], rtol=2e-5)


@pytest.mark.parametrize("N,n_valid,wname", [(20000, 5, None),
                                             (49152, 8, "hann"),
                                             (100000, 3, None)])
def test_sk_s1_bit_identical_to_plain_psd_step(N, n_valid, wname):
    """The sidecar leaves the averaged spectrum as it is: s1 is ML's plain
    PSD step's partial bit for bit (on the card ML's output: chip_smoke.py
    phase 24)."""
    F = 8
    w = None if wname is None else make_window(wname, N)
    raw = frames(F, N, 13)
    s1, _ = kurtosis.SkSessionStep(N, F, CPU, window=w)(raw, n_valid)
    ref = PsdStep(N, F, CPU, window=w)
    assert ref.path == "plain_mixed_large"
    assert torch.equal(s1, ref(raw, n_valid))


@pytest.mark.parametrize("N", SIZES)
def test_multitaper_step_matches_direct_and_jax(N):
    F, K, NW = 8, 7, 4.0
    step = multitaper.MultitaperSessionStep(N, F, K=K, NW=NW, device=CPU)
    jstep = jax_mt.MultitaperSessionStep(N, F, K=K, NW=NW)
    assert step._kernel is me.fused_psd_tapers_mixed_large
    assert step.path == "plain_multitaper"
    raw = frames(F, N, N + K)
    t = multitaper._session_tapers(N, NW, K).astype(np.float64)
    for nv in (F, F - 1, 1, 0):
        got = step(raw, nv).numpy().astype(np.float64)
        want = np.asarray(jstep(raw, nv), np.float64)
        direct = (np.abs(np.fft.fft(z64(raw[:nv])[:, None, :] * t[None],
                                    axis=-1)) ** 2).mean(axis=1).sum(axis=0)
        close_to_both(got, want, direct, nv)


@pytest.mark.parametrize("N", SIZES)
def test_pfb_step_matches_direct_and_jax(N):
    """Four steps of one stream (n_valid F, 1, F - 1, 0) on new frames,
    the Blackman prototype, the history carried on the port's step as on
    the JAX step's."""
    F, P, window = 8, 4, "blackman"
    step = pfb.PfbSessionStep(N, F, taps=P, window=window, device=CPU)
    jstep = jax_pfb.PfbSessionStep(N, F, taps=P, window=window)
    assert step._run._kernel is me.fused_psd_pfb_mixed_large
    assert step.path == "plain_pfb"
    counts = (F, 1, F - 1, 0)
    slots = [frames(F, N, N + 7 + k) for k in range(4)]
    h = pfb.pfb_prototype(N, P, window).reshape(P, N)
    for slot, nv, direct in zip(slots, counts,
                                direct_pfb_steps(slots, counts, P, h)):
        got = step(slot, nv).numpy().astype(np.float64)
        want = np.asarray(jstep(slot, nv), np.float64)
        close_to_both(got, want, direct, nv)


def test_tapers_and_prototype_match_jax_at_100000():
    """The host copies the forms read: the DPSS tapers (K = 7, NW = 4) and
    the PFB prototype (P = 4, Hann and Blackman) at 100000 bins are the
    JAX package's, value for value."""
    N = 100000
    np.testing.assert_array_equal(multitaper._session_tapers(N, 4.0, 7),
                                  np.asarray(jax_mt._session_tapers(N, 4.0,
                                                                    7)))
    for window in ("hann", "blackman"):
        np.testing.assert_array_equal(pfb.pfb_prototype(N, 4, window),
                                      np.asarray(jax_pfb.pfb_prototype(
                                          N, 4, window)))


# --- the streams steps against the JAX sharded steps ---


@pytest.mark.parametrize("N,wname,sigma", [(20000, None, 0.0),
                                           (49152, "hann", 3.0),
                                           (100000, None, 3.0)])
def test_sharded_sk_step_matches_jax(N, wname, sigma):
    S, F = 2, 8
    w = None if wname is None else make_window(wname, N)
    raw = streams_bytes(S, F, N, seed=N + S)
    counts = np.array([F, 5], np.int32)
    jstep = jax_kurtosis.ShardedSkStep(jax_mesh(S), N, F, streams=S,
                                       window=w, excise_sigma=sigma)
    step = kurtosis.ShardedSkStep(MESH, N, F, S, window=w,
                                  excise_sigma=sigma)
    assert step._kernel is me.fused_psd_sk_mixed_large_streams
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


@pytest.mark.parametrize("N", [20000, 100000])
def test_sharded_multitaper_step_matches_jax(N):
    S, F, K = 2, 8, 7
    raw = streams_bytes(S, F, N, seed=7 * K + N)
    counts = np.array([F - 1, 2], np.int32)
    jstep = jax_mt.ShardedMultitaperStep(jax_mesh(S), N, F, streams=S, K=K,
                                         NW=4.0)
    step = multitaper.ShardedMultitaperStep(MESH, N, F, S, K=K, NW=4.0)
    assert step._kernel is me.fused_psd_tapers_mixed_large_streams
    want_ps, want_comb = (np.asarray(a, np.float64)
                          for a in jstep(raw, counts))
    ps, comb = step(raw, counts)
    assert_rows_close(ps.numpy(), want_ps, counts)
    assert_combined_close(comb.numpy(), want_comb)


@pytest.mark.parametrize("N", [20000, 49152])
def test_sharded_pfb_step_matches_jax_over_calls_and_reset(N):
    """Three calls, each stream's counts running through 0, 1, F and
    others, the histories carried from call to call, then reset() and a
    fourth call from byte-127 histories."""
    S, F, P = 2, 8, 4
    jstep = jax_pfb.ShardedPfbStep(jax_mesh(S), N, F, streams=S, taps=P)
    step = pfb.ShardedPfbStep(MESH, N, F, S, taps=P)
    assert step._kernel is me.fused_psd_pfb_mixed_large_streams
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


def recorded_rtol(record, N, streams):
    """session_rtol of the recorded frames (each stream's, the largest):
    two float32 budgets, each 1e-5 or the scipy float32 class's own
    largest relative error from the float64 golden, where larger (a 35 dB
    tone at 10^5 bins), test_torch_fused_psd_mixed_large.py's rule for
    ML's sessions."""
    if not streams:
        return session_rtol(record, N, 16, N)
    return max(session_rtol(f"{record}.s{s}", N, 16, N) for s in range(2))


@pytest.mark.parametrize("bins,extra,streams", [
    ("100000", ["--sk-file"], []),
    ("20000", ["--multitaper", "7"], ["--streams", "2"]),
    ("49152", ["--pfb-taps", "4"], []),
    ("20000", ["--sk-file"], ["--streams", "2"]),
])
def test_session_matches_jax(bins, extra, streams, tmp_path):
    """The acceptance sessions: exit 0, the JAX CLI's text (and SK file
    where there is one) within the recorded frames' float32 budget
    (recorded_rtol), and the route's path."""
    record = str(tmp_path / "rec.iq")
    argv = ["-f", "100M", "-n", "16", "-b", bins, "--frames-per-step", "8",
            "--record", record, "--source", TONE] + streams
    if extra != ["--sk-file"]:
        argv += extra
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
    rtol = recorded_rtol(record, int(bins), streams)
    assert assert_text_outputs_match(out_j, out_p, rtol=rtol) == int(bins)
    assert mask_stderr(err_j) == mask_stderr(err_p)
    assert f"Transform path: {path}\n" in err_p


@pytest.mark.parametrize("bins,extra", [("100000", ["--sk-excise", "3"]),
                                        ("20000", ["--multitaper", "7"]),
                                        ("49152", ["--sk-file", "sk.txt"])])
def test_matrix_session_matches_jax(bins, extra, tmp_path):
    """``-m``: the .met (but its timing lines) and the .bin row are the
    JAX CLI's, the row within the recorded frames' float32 budget
    (recorded_rtol; each step's 8 frames a block of the excision gate)."""
    mets, rows = [], []
    record = str(tmp_path / "rec.iq")
    for port in (False, True):
        d = tmp_path / ("port" if port else "jax")
        d.mkdir()
        stem = d / "est"
        more = ([extra[0], str(d / extra[1])] if extra[0] == "--sk-file"
                else extra)
        argv = ["-f", "100M", "-b", bins, "-n", "16", "--frames-per-step",
                "8", "-q", "-m", str(stem), "--record", record, "--source",
                TONE] + more
        rv, _, _ = run(argv, port=port)
        assert int(rv) == 0
        mets.append([m for i, m in enumerate(
            (d / "est.met").read_text().split("\n")) if i not in (6, 7, 8)])
        rows.append(np.fromfile(str(stem) + ".bin", dtype=np.float32))
    assert mets[0] == mets[1] and int(mets[1][0].split()[0]) == int(bins)
    assert rows[1].size == int(bins)
    np.testing.assert_allclose(10.0 ** (rows[1] / 10.0),
                               10.0 ** (rows[0] / 10.0),
                               rtol=recorded_rtol(record, int(bins), []))


@pytest.mark.parametrize("extra,what", [
    (["-b", "4194302", "--multitaper", "7"], "--multitaper at 4194302 bins"),
    (["--streams", "2", "-b", "4194302", "--sk-file", "sk.dat"],
     "--sk-file over --streams at 4194302 bins"),
    (["-b", "8388608", "--pfb-taps", "4"], "8388608 bins"),
])
def test_cli_still_exits_3(extra, what, capsys):
    argv = ["-f", "100M", "-n", "8", "--source", "synthetic:"] + extra
    assert cli.main(argv, device=CPU) == 3
    err = capsys.readouterr().err
    assert "Not yet ported" in err and what in err


# --- the wrappers ---


@pytest.mark.parametrize("N", [16384, 32768, 20002, 4194302])
def test_wrappers_refuse_n_the_forms_do_not_take(N):
    raw = torch.zeros((8, 2 * N), dtype=torch.uint8)
    hist = torch.zeros((1, 2 * N), dtype=torch.uint8)
    with pytest.raises(ValueError, match="does not take"):
        me.fused_psd_sk_mixed_large(raw, 8, 8)
    with pytest.raises(ValueError, match="does not take"):
        me.fused_psd_tapers_mixed_large(raw, 8, 8, torch.ones((2, N)))
    with pytest.raises(ValueError, match="does not take"):
        me.fused_psd_pfb_mixed_large(raw, hist, 8, 8, torch.ones((2, N)),
                                     hist.clone())
    with pytest.raises(ValueError, match="does not take"):
        me.fused_psd_sk_mixed_large_streams(
            raw[None], torch.tensor([8], dtype=torch.int32), 8)


def test_wrappers_refuse_bad_arguments():
    N = 20000
    raw = torch.zeros((8, 2 * N), dtype=torch.uint8)
    with pytest.raises(ValueError, match="sigma"):
        me.fused_psd_sk_mixed_large(raw, 8, 8, sigma=-1.0)
    with pytest.raises(ValueError, match="group"):
        me.fused_psd_sk_mixed_large(raw, 8, 8, group_b=9)
    with pytest.raises(ValueError, match="group"):
        me.fused_psd_tapers_mixed_large(raw, 8, 8, torch.ones((2, N)),
                                        group_b=0)
    with pytest.raises(ValueError, match="n_valid"):
        me.fused_psd_sk_mixed_large_streams(
            raw[None], torch.tensor([8], dtype=torch.int64), 8)
    with pytest.raises(ValueError, match="tapers"):
        me.fused_psd_tapers_mixed_large(raw, 8, 8, torch.ones((2, N - 2)))
    hist = torch.zeros((3, 2 * N), dtype=torch.uint8)
    with pytest.raises(ValueError, match="distinct"):
        me.fused_psd_pfb_mixed_large(raw, hist, 8, 8, torch.ones((4, N)),
                                     hist)


def test_wrappers_on_cpu_count_as_plain():
    N, F = 20000, 8
    fp.COUNTS.reset()
    raw = torch.from_numpy(frames(F, N, 3))
    nv = torch.tensor([F], dtype=torch.int32)
    h = torch.ones((2, N))
    hist = [torch.zeros((1, 2 * N), dtype=torch.uint8) for _ in range(2)]
    me.fused_psd_sk_mixed_large(raw, F, F)
    me.fused_psd_tapers_mixed_large(raw, F, F, torch.ones((2, N)))
    me.fused_psd_pfb_mixed_large(raw, hist[0], F, F, h, hist[1])
    me.fused_psd_sk_mixed_large_streams(raw[None], nv, F)
    me.fused_psd_tapers_mixed_large_streams(raw[None], nv, F,
                                            torch.ones((2, N)))
    me.fused_psd_pfb_mixed_large_streams(raw[None], hist[0][None], nv, F, h,
                                         hist[1][None])
    counts = vars(fp.COUNTS)
    assert counts["plain"] == 6
    assert not any(v for k, v in counts.items() if k != "plain")


def test_streams_references_are_the_one_stream_forms_per_stream():
    """Each stream of the streams forms' plain versions is the one-stream
    plain version on its frames and count (its history for the PFB),
    within 1e-5; SK's s1 bit for bit."""
    S, F, N = 2, 8, 20000
    raw = torch.from_numpy(streams_bytes(S, F, N, seed=5))
    counts = [F, 3]
    nv = torch.tensor(counts, dtype=torch.int32)
    tp = torch.from_numpy(multitaper._session_tapers(N, 4.0, 3))
    h = torch.from_numpy(pfb.pfb_prototype(N, 4).reshape(4, N))
    sk = me.sk_mixed_large_streams_reference(raw, nv, 8, None, 3.0)
    mt = me.tapers_mixed_large_streams_reference(raw, nv, 8, tp)
    hist = [torch.full((S, 3, 2 * N), 127, dtype=torch.uint8)
            for _ in range(2)]
    pf = me.pfb_mixed_large_streams_reference(raw, hist[0], nv, 8, h,
                                              hist[1])
    for s, c in enumerate(counts):
        one_hist = [torch.full((3, 2 * N), 127, dtype=torch.uint8),
                    torch.empty((3, 2 * N), dtype=torch.uint8)]
        one_sk = me.sk_mixed_large_reference(raw[s], c, 8, None, 3.0)
        assert torch.equal(sk[s][0], one_sk[0])
        np.testing.assert_allclose(sk[s].numpy(), one_sk.numpy(), rtol=1e-5)
        np.testing.assert_allclose(
            mt[s].numpy(), me.tapers_mixed_large_reference(
                raw[s], c, 8, tp).numpy(), rtol=1e-5)
        np.testing.assert_allclose(
            pf[s].numpy(), me.pfb_mixed_large_reference(
                raw[s], one_hist[0], c, 8, h, one_hist[1]).numpy(),
            rtol=1e-5)
        assert torch.equal(hist[1][s], one_hist[1])


@pytest.mark.parametrize("wname", [None, "hann"])
def test_plain_power_is_the_plain_psd_steps(wname):
    """The forms' plain transform is ML's plain four steps: the plain PSD
    step's bits frame by frame, and the SK form's s1 its output."""
    N, F = 49152, 8
    w = None if wname is None else torch.from_numpy(make_window(wname, N))
    raw = torch.from_numpy(frames(F, N, 21))
    p = ml.mixed_large_power(raw, w)
    for nv in (F, 3):
        want = p.clone()
        want[nv:] = 0.0
        assert torch.equal(ml.fused_psd_mixed_large_reference(raw, nv, 8, w),
                           want.reshape(1, 8, N).sum(1).sum(0))
        assert torch.equal(me.sk_mixed_large_reference(raw, nv, 8, w)[0],
                           ml.fused_psd_mixed_large_reference(raw, nv, 8, w))


# --- the forms' new index arithmetic, transcribed ---


def frame_power(raw_f, N, window, tabs):
    """|X|^2 of one frame through ML's two passes, transcribed: (N1, N2)
    float32 by element of each row."""
    return ml_pass_b(ml_pass_a(raw_f, N, window, tabs, np.complex64), N,
                     tabs, np.complex64)


def streams_rows(S, F, N, counts, planes, power):
    """ML-S's pass B grid over S streams of F frames for RESIDENT blocks:
    block (x, s) sums ``power(s, f)`` ((planes, N1, N2) float32 by element)
    over stream s's frames of group x / tiles, writing plane p's sums by
    bin (k1 + N1 k2 from element order2[k2] of row k1) into partial row
    (p S + s) G_s + x / tiles. Returns (partial rows, G_s)."""
    t = ml.ml_layout(N)
    group_b = fl.large_group(F, S * t.tiles[1], RESIDENT)
    G_s = -(-F // group_b)
    order2 = fm.element_of_bin(t.plan2, np.arange(t.N2))
    partial = np.full((planes * S * G_s, t.row), np.nan, np.float32)
    for s in range(S):
        for j in range(G_s):
            acc = np.zeros((planes, t.N1, t.N2), np.float32)
            for f in range(j * group_b, min((j + 1) * group_b, F,
                                            counts[s])):
                acc += power(s, f)
            for p in range(planes):
                partial[(p * S + s) * G_s + j, :N] = \
                    acc[p][:, order2].T.reshape(-1)
    return partial, G_s


@pytest.mark.parametrize("N,counts,wname", [(20000, (3, 1), None),
                                            (16464, (2, 0), "hann")])
def test_second_plane_transcription(N, counts, wname):
    """SK-ML's pass B: |X|^2 and its square summed by element, the s1 row
    to (0 S + s) G_s + j and the s2 row to (S + s) G_s + j, each staged by
    bin as pass B stages its row; each plane summed per stream: s1 is ML's
    transcription of the stream bit for bit, within 1e-5 of the float64
    sum of |X|^2, and s2 within the SK rule of the float64 sum of |X|^4
    and of the plain SK-ML."""
    S, F = 2, 3
    w = None if wname is None else make_window(wname, N)
    raw = streams_bytes(S, F, N, seed=N)
    tabs = ml_tables(N, np.complex64)
    cache = {}

    def power(s, f):
        if (s, f) not in cache:
            p = frame_power(raw[s, f], N, w, tabs)
            cache[(s, f)] = np.stack([p, p * p])
        return cache[(s, f)]

    planes, G_s = streams_rows(S, F, N, counts, 2, power)
    for s, c in enumerate(counts):
        s1 = stream_rows_sum(planes, S, G_s, 1, s)[:N]
        s2 = stream_rows_sum(planes[S * G_s:], S, G_s, 1, s)[:N]
        if c == 0:
            assert not s1.any() and not s2.any()
            continue
        assert np.array_equal(s1, ml_transcription(raw[s], c, w))
        p = power64(raw[s, :c], w)
        wt = None if w is None else torch.from_numpy(w)
        plain = me.fused_psd_sk_mixed_large(torch.from_numpy(raw[s]), c, F,
                                            wt)[1].numpy().astype(np.float64)
        s4 = (p * p).sum(0)
        close(s1, p.sum(0), c, 1e-5)
        own = np.abs(plain - s4).max() / s4.mean()
        close(s2, s4, c, max(4e-5, 3 * own))
        close(s2, plain, c, max(4e-5, 3 * own))


def pfb_pass0_loads(N, P, j):
    """ml_pfb_first's loads, transcribed: for every tile, column c and
    thread t of pass A at N (N1's plan, tf = 256 / C), butterfly b = t + i
    tf < S0 = N1 / R0, sample m, tap p: (row n1 = b + m S0, column n2 = c0
    + c, the virtual row read (j + p; the ring's own row, virtual row j +
    P - 1, at p = P - 1), the h element p N + n1 N2 + n2). Returns them as
    an int array (loads, 5), columns past N2 (inactive) left out."""
    t = ml.ml_layout(N)
    a, _ = t.launches()
    C, N2, tiles = t.cols, t.N2, t.n2p // t.cols
    R = t.plan1[0]
    S0 = t.N1 // R
    out = []
    for tile in range(tiles):
        for tid in range(256):
            c, th = tid % C, tid // C
            n2 = tile * C + c
            if n2 >= N2:
                continue
            for i in range(a.rounds[0]):
                b = th + i * a.tf
                if b >= S0:
                    continue
                for m in range(R):
                    n1 = b + m * S0
                    for p in range(P):
                        out.append((n1, n2, p, j + p,
                                    p * N + n1 * N2 + n2))
    return np.asarray(out)


@pytest.mark.parametrize("N,P,j", [(20000, 4, 0), (16464, 3, 2),
                                   (49152, 2, 5)])
def test_pfb_pass0_loads_transcription(N, P, j):
    """PFB-ML's pass 0 reads, for every (n1, n2) sample of the frame once,
    tap p from virtual row j + p (the P - 1 older rows from the history
    or the earlier frames, the frame's own row, virtual row j + P - 1,
    from the ring) and h element p N + n: a half-warp's loads are its C
    adjacent columns of one row. Summed in the kernel's order (p from
    zero, each product and sum rounded to float32), the sums are
    pfb_sums_reference's bit for bit."""
    loads = pfb_pass0_loads(N, P, j)
    t = ml.ml_layout(N)
    n1, n2, p, vrow, hel = loads.T
    assert len(loads) == P * N
    keys = (n1 * t.N2 + n2) * P + p
    assert np.array_equal(np.sort(keys), np.arange(P * N))
    assert np.array_equal(vrow, j + p)
    assert np.array_equal(hel, p * N + n1 * t.N2 + n2)
    # A half-warp (16 threads, C of them a row's columns) reads C adjacent
    # columns of one row at each (m, p).
    assert t.cols in (4, 8, 16)
    rng = np.random.default_rng(N + P + j)
    F = j + 1
    virtual = rng.integers(0, 256, (F + P - 1, 2 * N), dtype=np.uint8)
    h = pfb.pfb_prototype(N, P, "hann").reshape(P, N)
    hf = h.reshape(-1)
    order = np.lexsort((p, n2, n1))
    sr = np.zeros(N, np.float32)
    si = np.zeros(N, np.float32)
    for q in order.reshape(N, P).T:          # tap by tap, p from zero
        n = n1[q] * t.N2 + n2[q]
        xr = virtual[vrow[q], 2 * n].astype(np.float32) - np.float32(127)
        xi = virtual[vrow[q], 2 * n + 1].astype(np.float32) - np.float32(127)
        sr[n] = sr[n] + xr * hf[hel[q]]
        si[n] = si[n] + xi * hf[hel[q]]
    want = pfb_sums_reference(torch.from_numpy(virtual),
                              torch.from_numpy(h), F)[j].numpy()
    assert np.array_equal(sr, want.real) and np.array_equal(si, want.imag)


@pytest.mark.parametrize("N,K,counts", [(20000, 2, (3, 0)),
                                        (16464, 3, (2, 1))])
def test_taper_loop_rows_transcription(N, K, counts):
    """MT-ML: both passes once a taper (pass A windowed by taper row k),
    taper k's pass B writing partial row (k S + s) G_s + j;
    est_streams_kernel<kEstTapers> sums each stream's K G_s rows in its
    order and divides by K: within 1e-5 of the float64 form and of the
    plain MT-ML-S."""
    S, F = 2, 3
    raw = streams_bytes(S, F, N, seed=N + K)
    tapers = multitaper._session_tapers(N, 4.0, K)
    tabs = ml_tables(N, np.complex64)
    planes, G_s = streams_rows(
        S, F, N, counts, K, lambda s, f: np.stack([frame_power(
            raw[s, f], N, tapers[k], tabs) for k in range(K)]))
    got = np.stack([stream_rows_sum(planes, S, G_s, K, s)[:N]
                    for s in range(S)]) / np.float32(K)
    plain = me.tapers_mixed_large_streams_reference(
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


def test_ml_and_its_forms_share_the_streams_passes():
    """ML-S's passes and their shared parts live in one header that ML and
    the forms both include, not in a copy; the forms' source names its
    passes as source_pass numbers them."""
    header = (CSRC / "fused_psd_mixed_large_streams.cuh").read_text()
    ml_src = (CSRC / "fused_psd_mixed_large.cu").read_text()
    est = (CSRC / "fused_psd_mixed_large_est.cu").read_text()
    for src in (ml_src, est):
        assert '#include "fused_psd_mixed_large_streams.cuh"' in src
    for name in ("\nml_streams_cols(", "\nml_streams_rows(",
                 "void ml_first(", "void ml_mid(", "void ml_last_store(",
                 "bool read_ml_plan(", "bool ml_launch_ok("):
        assert header.count(name) == 1
        assert name not in ml_src and name not in est
    for name in ("\nml_cols_kernel(", "\nml_rows_kernel("):
        assert name in ml_src and name not in header
    order = re.findall(r"case (\d): return reinterpret_cast<const void\*>\("
                       r"(\w+)<", est)
    assert [k for _, k in order] == ["ml_streams_cols", "ml_streams_cols",
                                     "ml_streams_rows", "ml_streams_rows",
                                     "ml_sk_rows", "ml_sk_rows"]
    assert "default: return reinterpret_cast<const void*>(ml_pfb_cols)" \
        in est
    small, large = 16464, 4167450
    assert ml.ml_layout(small).which_b == ml.PASS_B_SMALL
    assert ml.ml_layout(large).which_b == ml.PASS_B_LARGE
    assert [me.source_pass(small, w) for w in range(5)] == [0, 1, 2, 4, 6]
    assert [me.source_pass(large, w) for w in range(5)] == [0, 1, 3, 5, 6]


def test_pfb_loads_keep_the_h_and_row_reads_rounded_on_their_own():
    """The polyphase sum takes __fmul_rn and __fadd_rn (no contraction to
    an FMA), as the plain version rounds each product and sum."""
    est = (CSRC / "fused_psd_mixed_large_est.cu").read_text()
    start = est.index("void ml_pfb_first(")
    body = est[start:est.index("ring_dft<R>(v);", start)]
    assert body.count("__fadd_rn(v[m].x, __fmul_rn(") == 2
    assert body.count("__fadd_rn(v[m].y, __fmul_rn(") == 2
    assert "fmaf" not in body


@pytest.mark.parametrize("drive,kind,streams", [
    ("SK-ML", "sk", 1), ("PFB-ML", "pfb", 1), ("SK-ML-S", "sk", 2),
    ("MT-ML-S", "mt", 2), ("PFB-ML-S", "pfb", 2)])
def test_chip_smoke_drive_steps_are_the_sessions(drive, kind, streams,
                                                 monkeypatch, tmp_path):
    """chip_smoke.py phase 24 holds each form at the step its drive runs,
    sized by its drive_frames_per_step: the session on the same argv hands
    the form those frames and chunk, and nothing else (each call after the
    first returns the first's rows, as only the shapes are held here)."""
    argv = list((CHIP_SMOKE.EST24_STREAMS_ARGV if streams > 1
                 else CHIP_SMOKE.EST24_ONE_ARGV)[drive])
    N = int(argv[argv.index("-b") + 1])
    if kind == "sk":
        argv += ["--sk-file", str(tmp_path / "sk.txt")]
    table = {"sk": (kurtosis.SK_KERNELS, kurtosis.SK_STREAMS_KERNELS),
             "mt": (multitaper.TAPERS_KERNELS,
                    multitaper.TAPERS_STREAMS_KERNELS),
             "pfb": (pfb.PFB_KERNELS, pfb.PFB_STREAMS_KERNELS)}[kind][
                 streams > 1]
    form = table["mixed_large"]
    at = 3 if kind == "pfb" else 2   # the chunk's argument
    seen, first = [], []

    def recorded(*args, **kwargs):
        seen.append((tuple(args[0].shape), args[at]))
        if not first:
            first.append(form(*args, **kwargs))
        return first[0]

    monkeypatch.setitem(table, "mixed_large", recorded)
    rv, _, _ = run(argv, port=True)
    F, chunk = spectral.adapt_batch(
        CHIP_SMOKE.drive_frames_per_step(argv, streams))
    shape = (F, 2 * N) if streams == 1 else (streams, F, 2 * N)
    assert int(rv) == 0 and seen and set(seen) == {(shape, chunk)}
