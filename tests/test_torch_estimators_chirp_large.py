"""The CLI estimators at the large chirp-Z bin counts (SK-BL, MT-BL, PFB-BL
and their calls over streams: csrc/fused_psd_chirp_large_est.cu, forms of
BL's three passes, each written once for S >= 1 streams) against the JAX
package's, on the CPU, where the port's steps are the forms' plain PyTorch
versions (BL's three passes in torch ops).

The session steps (``--sk-file``, ``--sk-excise``, ``--multitaper``,
``--pfb-taps``) at N = 8194, 9998, 12002 and 16382 with n_valid F, F - 1,
1 and 0 (Hann for SK at 9998, the PFB's Blackman prototype at 12002), and
SK under ``--fft-backend bluestein`` at 10000 and 16384, against the JAX
steps on the same seeded numpy bytes and against a direct float64 form;
the streams steps at S = 2 with uneven counts against the JAX sharded
steps; whole CLI sessions against the JAX CLI's (text, SK file, ``.bin``
and ``.met``); the routes, and the exit-3 cases that stay (above 16384
bins). Tolerances are test_torch_estimator_streams.py's: rtol 2e-5 where
a row sums at least 8 frames; under 8 frames the largest error over the
row's mean power (a few frames' smallest bins are single periodogram
values near 0); no frame, exact zeros; the ``kept`` row exact; s1 the
plain PSD step's bit for bit.

The kernels run only on a card (chip_smoke.py phase 22). Their new index
arithmetic is transcribed in numpy on BL's thread-by-thread transcription
(tests/test_torch_large_awkward_regs.py): PFB-BL's pass-A row reads (the
frame's own row from the ring, the P - 1 older rows from history or
frames, p in order, the chirp product after the sum), MT-BL's taper loop
and its partial rows (k S + s) G_s + j as est_streams_kernel reads them,
and SK-BL's second plane of |z|^4 sums by pass-C slot.
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
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_chirp_large as bl
from rtl_power_fftw_tpu_torch.ops.kernels import \
    fused_psd_chirp_large_est as be
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_large as fl
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_large_est as le
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
from rtl_power_fftw_tpu_torch.ops.spectral import PsdStep

from test_torch_awkward_n import CHIP_SMOKE
from test_torch_estimator_streams import (MESH, assert_combined_close,
                                          assert_rows_close, jax_mesh,
                                          stream_rows_sum, streams_bytes)
from test_torch_estimators_mixed import TONE, frames, z64
from test_torch_fused_psd_large_regs import last_element
from test_torch_fused_psd_regs import pass_bin
from test_torch_kurtosis import assert_sk_files_match, run_both
from test_torch_large_awkward_regs import (CSRC, RESIDENT, bl_pass_a,
                                           bl_pass_b, bl_pass_c, bl_tables,
                                           bl_transcription, sum_rows)
from test_torch_session import assert_text_outputs_match, mask_stderr, run

CPU = torch.device("cpu")
SIZES = [8194, 9998, 12002, 16382]


@pytest.fixture(autouse=True)
def _reset_interrupts():
    for module in (interrupts, jax_interrupts):
        module.reset()
    yield
    for module in (interrupts, jax_interrupts):
        module.reset()


def power64(raw, window=None):
    """float64 |DFT|^2 of (F, 2N) u8 frames [windowed]."""
    z = z64(raw) * (1.0 if window is None
                    else np.asarray(window, np.float64))
    return np.abs(np.fft.fft(z, axis=1)) ** 2


def close(got, want, n_valid, rtol=2e-5):
    """One row over ``n_valid`` frames, test_torch_estimator_streams.py's
    rule: ``rtol`` (2e-5; twice that for a sum of |X|^4, whose square
    doubles the relative error of |X|^2) from 8 frames, the largest error
    over the row's mean under 8, exact zeros at none."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if n_valid == 0:
        assert not got.any() and not want.any()
    elif n_valid >= 8:
        np.testing.assert_allclose(got, want, rtol=rtol)
    else:
        assert np.abs(got - want).max() <= rtol * np.abs(want).mean()


# --- the routes ---


@pytest.mark.parametrize("N,flag,backend,sharded,route", [
    (9998, "--sk-file", "auto", False, "chirp_large"),
    (8194, "--sk-excise", "auto", False, "chirp_large"),
    (16382, "--multitaper", "auto", False, "chirp_large"),
    (12002, "--pfb-taps", "auto", False, "chirp_large"),
    (9998, "--sk-file", "auto", True, "chirp_large"),
    (16382, "--multitaper", "auto", True, "chirp_large"),
    (12002, "--pfb-taps", "auto", True, "chirp_large"),
    (10000, "--sk-file", "bluestein", False, "chirp_large"),
    (16384, "--sk-excise", "bluestein", True, "chirp_large"),
    (16382, "--sk-file", "bluestein", False, "chirp_large"),
    (10000, "--sk-file", "auto", False, "mixed"),
    (16384, "--sk-file", "auto", False, "regs"),
    (16384, "--pfb-taps", "bluestein", False, "regs"),
    (8192, "--sk-file", "bluestein", False, "bluestein"),
    (4194306, "--sk-file", "auto", False, None),
    (8388608, "--multitaper", "auto", True, None),
    (4194302, "--pfb-taps", "auto", False, None),
    (9998, "spectrogram", "auto", False, None),
])
def test_estimator_route(N, flag, backend, sharded, route):
    """The session's estimators take every even N up to 16384 on one
    stream and over streams; the forms of BL's passes the N in (8192,
    16384] that the power-of-two and mixed-radix forms do not, and SK
    under ``bluestein`` any even N there; above 16384 and for the
    library-only estimators the exit-3 message names the case."""
    if route is not None:
        assert spectral.estimator_route(N, flag, backend, sharded) == route
        return
    with pytest.raises(RPFexception, match="Not yet ported") as e:
        spectral.estimator_route(N, flag, backend, sharded)
    assert int(e.value.return_value) == 3
    assert f"{flag}{' over --streams' * sharded} at {N} bins" \
        in str(e.value)


@pytest.mark.parametrize("sharded", [False, True])
def test_sk_under_bluestein_above_16384_exits_3(sharded):
    with pytest.raises(RPFexception, match="Not yet ported") as e:
        spectral.estimator_route(2097154, "--sk-file", "bluestein", sharded)
    assert (f"--sk-file{' over --streams' * sharded} with --fft-backend "
            "bluestein at 2097154 bins (the chirp-Z estimator kernels take "
            "even N up to 2097152)") in str(e.value)


@pytest.mark.parametrize("table,one,streams", [
    ((kurtosis.SK_KERNELS, kurtosis.SK_STREAMS_KERNELS),
     be.fused_psd_sk_chirp_large, be.fused_psd_sk_chirp_large_streams),
    ((multitaper.TAPERS_KERNELS, multitaper.TAPERS_STREAMS_KERNELS),
     be.fused_psd_tapers_chirp_large,
     be.fused_psd_tapers_chirp_large_streams),
    ((pfb.PFB_KERNELS, pfb.PFB_STREAMS_KERNELS),
     be.fused_psd_pfb_chirp_large, be.fused_psd_pfb_chirp_large_streams),
])
def test_each_step_maps_the_route_to_its_form(table, one, streams):
    assert table[0]["chirp_large"] is one
    assert table[1]["chirp_large"] is streams


@pytest.mark.parametrize("N,ok", [(8192, False), (8194, True), (9998, True),
                                  (16382, True), (16384, True),
                                  (16386, True), (20002, True),
                                  (9999, False), (2097150, True),
                                  (2097152, True), (2097154, False)])
def test_eligible(N, ok):
    """BL's even N, 8194..2^21, at M = chirp_size(N) from 2^15 to 2^22."""
    assert be.fused_psd_chirp_large_est_eligible(N) is ok
    if ok:
        assert bl.chirp_regs_layout(N).log2m == (2 * N - 1).bit_length()


# --- the session steps against the JAX steps ---


@pytest.mark.parametrize("N,wname", [(8194, None), (9998, "hann"),
                                     (12002, None), (16382, None)])
def test_sk_step_matches_direct_and_jax(N, wname):
    F = 8
    w = None if wname is None else make_window(wname, N)
    step = kurtosis.SkSessionStep(N, F, CPU, window=w)
    jstep = jax_kurtosis.SkSessionStep(N, F, window=w)
    assert step._kernel is be.fused_psd_sk_chirp_large
    assert step.path == "plain_sk"
    raw = frames(F, N, N + 1)
    for nv in (F, F - 1, 1, 0):
        got = [t.numpy().astype(np.float64) for t in step(raw, nv)]
        want = [np.asarray(a, np.float64) for a in jstep(raw, nv)]
        p = power64(raw[:nv], w)
        for i, direct in enumerate((p.sum(0), (p * p).sum(0))):
            close(got[i], want[i], nv, (i + 1) * 2e-5)
            close(got[i], direct, nv, (i + 1) * 2e-5)


@pytest.mark.parametrize("N", [9998, 16382])
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


@pytest.mark.parametrize("N", [10000, 16384])
def test_sk_step_under_bluestein_matches_jax(N):
    """``--fft-backend bluestein`` runs SK-BL at a 7-smooth N and at a
    power of two, as the JAX step runs its chirp-Z transform."""
    F = 8
    step = kurtosis.SkSessionStep(N, F, CPU, backend="bluestein")
    jstep = jax_kurtosis.SkSessionStep(N, F, backend="bluestein")
    assert step._kernel is be.fused_psd_sk_chirp_large
    raw = frames(F, N, N + 5)
    for nv in (F, 3):
        got = [t.numpy().astype(np.float64) for t in step(raw, nv)]
        want = [np.asarray(a, np.float64) for a in jstep(raw, nv)]
        p = power64(raw[:nv])
        for i, direct in enumerate((p.sum(0), (p * p).sum(0))):
            close(got[i], want[i], nv, (i + 1) * 2e-5)
            close(got[i], direct, nv, (i + 1) * 2e-5)


@pytest.mark.parametrize("N,n_valid,wname,backend", [
    (9998, 5, None, "auto"), (16382, 8, "hann", "auto"),
    (16384, 6, None, "bluestein"), (10000, 8, None, "bluestein")])
def test_sk_s1_bit_identical_to_plain_psd_step(N, n_valid, wname, backend):
    """The sidecar leaves the averaged spectrum as it is: s1 is BL's
    PsdStep partial bit for bit, under ``bluestein`` too (on the card BL's
    output: chip_smoke.py phase 22)."""
    F = 8
    w = None if wname is None else make_window(wname, N)
    raw = frames(F, N, 13)
    s1, _ = kurtosis.SkSessionStep(N, F, CPU, window=w, backend=backend)(
        raw, n_valid)
    ref = PsdStep(N, F, CPU, window=w, backend=backend)
    assert ref.path == "plain_chirp_large"
    assert torch.equal(s1, ref(raw, n_valid))


@pytest.mark.parametrize("N,K", [(8194, 7), (9998, 2), (12002, 7),
                                 (16382, 7)])
def test_multitaper_step_matches_direct_and_jax(N, K):
    F, NW = 8, 4.0
    step = multitaper.MultitaperSessionStep(N, F, K=K, NW=NW, device=CPU)
    jstep = jax_mt.MultitaperSessionStep(N, F, K=K, NW=NW)
    assert step._kernel is be.fused_psd_tapers_chirp_large
    assert step.path == "plain_multitaper"
    raw = frames(F, N, N + K)
    t = multitaper._session_tapers(N, NW, K).astype(np.float64)
    for nv in (F, F - 1, 1, 0):
        got = step(raw, nv).numpy().astype(np.float64)
        want = np.asarray(jstep(raw, nv), np.float64)
        direct = (np.abs(np.fft.fft(z64(raw[:nv])[:, None, :] * t[None],
                                    axis=-1)) ** 2).mean(axis=1).sum(axis=0)
        close(got, want, nv)
        close(got, direct, nv)


def direct_pfb_steps(slots, counts, P, h):
    """float64 PFB outputs of consecutive steps of one stream from a reset
    history: sum over j < n_valid of |DFT(sum_p h[p] x_{j+p})|^2 of each
    step's virtual rows (the last P - 1 rows kept, then the slot)."""
    N = slots[0].shape[1] // 2
    virtual = np.full((P - 1, 2 * N), 127, np.uint8)
    out = []
    for slot, nv in zip(slots, counts):
        v = np.concatenate([virtual, slot])
        z = z64(v)
        s = sum(z[p:p + nv] * h[p].astype(np.float64) for p in range(P))
        out.append((np.abs(np.fft.fft(s, axis=1)) ** 2).sum(0))
        virtual = v[nv:nv + P - 1]
    return out


@pytest.mark.parametrize("N,window", [(8194, "hann"), (9998, "hann"),
                                      (12002, "blackman"), (16382, "hann")])
def test_pfb_step_matches_direct_and_jax(N, window):
    """Four steps of one stream (n_valid F, 1, F - 1, 0) on new frames,
    the history carried on the port's step as on the JAX step's."""
    F, P = 8, 4
    step = pfb.PfbSessionStep(N, F, taps=P, window=window, device=CPU)
    jstep = jax_pfb.PfbSessionStep(N, F, taps=P, window=window)
    assert step._run._kernel is be.fused_psd_pfb_chirp_large
    assert step.path == "plain_pfb"
    counts = (F, 1, F - 1, 0)
    slots = [frames(F, N, N + 7 + k) for k in range(4)]
    h = pfb.pfb_prototype(N, P, window).reshape(P, N)
    for slot, nv, direct in zip(slots, counts,
                                direct_pfb_steps(slots, counts, P, h)):
        got = step(slot, nv).numpy().astype(np.float64)
        want = np.asarray(jstep(slot, nv), np.float64)
        close(got, want, nv)
        close(got, direct, nv)


# --- the streams steps against the JAX sharded steps ---


@pytest.mark.parametrize("N,wname,sigma,backend", [
    (9998, None, 0.0, "auto"), (16382, "hann", 3.0, "auto"),
    (16384, None, 3.0, "bluestein")])
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
    assert step._kernel is be.fused_psd_sk_chirp_large_streams
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


def test_sharded_multitaper_step_matches_jax():
    S, F, N, K = 2, 8, 12002, 7
    raw = streams_bytes(S, F, N, seed=7 * K + N)
    counts = np.array([F - 1, 2], np.int32)
    jstep = jax_mt.ShardedMultitaperStep(jax_mesh(S), N, F, streams=S, K=K,
                                         NW=4.0)
    step = multitaper.ShardedMultitaperStep(MESH, N, F, S, K=K, NW=4.0)
    assert step._kernel is be.fused_psd_tapers_chirp_large_streams
    want_ps, want_comb = (np.asarray(a, np.float64)
                          for a in jstep(raw, counts))
    ps, comb = step(raw, counts)
    assert_rows_close(ps.numpy(), want_ps, counts)
    assert_combined_close(comb.numpy(), want_comb)


def test_sharded_pfb_step_matches_jax_over_calls_and_reset():
    """Three calls, each stream's counts running through 0, 1, F and
    others, the histories carried from call to call, then reset() and a
    fourth call from byte-127 histories."""
    S, F, N, P = 2, 8, 16382, 4
    jstep = jax_pfb.ShardedPfbStep(jax_mesh(S), N, F, streams=S, taps=P)
    step = pfb.ShardedPfbStep(MESH, N, F, S, taps=P)
    assert step._kernel is be.fused_psd_pfb_chirp_large_streams
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


@pytest.mark.parametrize("bins,extra,path", [
    ("9998", [], "plain_sk (backend=auto, N=9998)"),
    ("9998", ["--streams", "2"], "plain_sk (backend=auto, N=9998)"),
    ("16384", ["--fft-backend", "bluestein"],
     "plain_sk (backend=bluestein, N=16384)"),
])
def test_sk_file_session_matches_jax(bins, extra, path, tmp_path):
    """``-b 9998 --sk-file`` (one stream and two) and ``-b 16384 --sk-file
    --fft-backend bluestein``: the text and the SK file are the JAX
    CLI's."""
    argv = ["-f", "100M", "-n", "16", "-b", bins, "--frames-per-step", "8",
            "--source", TONE] + extra
    (rv_j, out_j, err_j, sk_j), (rv_p, out_p, err_p, sk_p) = run_both(
        argv, tmp_path, "sk.txt")
    assert rv_j == rv_p == 0
    assert assert_text_outputs_match(out_j, out_p) == int(bins)
    assert mask_stderr(err_j) == mask_stderr(err_p)
    assert f"Transform path: {path}" in err_p
    assert_sk_files_match(sk_j, sk_p)
    spectra = 16 * (2 if "--streams" in extra else 1)
    assert f"# Spectra accumulated: {spectra}\n" in sk_p


@pytest.mark.parametrize("extra,path", [
    (["-b", "9998", "--sk-excise", "3"], "plain_sk (backend=auto, N=9998)"),
    (["-b", "12002", "--pfb-taps", "4"], "plain_pfb (N=12002)"),
])
def test_session_matches_jax(extra, path):
    argv = ["-f", "100M", "-n", "24", "--frames-per-step", "8", "--source",
            TONE] + extra
    rv_j, out_j, err_j = run(argv, port=False)
    rv_p, out_p, err_p = run(argv, port=True)
    assert int(rv_j) == int(rv_p) == 0
    assert assert_text_outputs_match(out_j, out_p) == int(extra[1])
    assert mask_stderr(err_j) == mask_stderr(err_p)
    assert f"Transform path: {path}\n" in err_p


def test_multitaper_matrix_session_matches_jax(tmp_path):
    """``-b 16382 --multitaper 7 -m``: the .met (but its timing lines) and
    the .bin row are the JAX CLI's."""
    mets, rows = [], []
    for port in (False, True):
        d = tmp_path / ("port" if port else "jax")
        d.mkdir()
        stem = d / "mt"
        argv = ["-f", "100M", "-b", "16382", "-n", "16",
                "--frames-per-step", "8", "--multitaper", "7", "-q", "-m",
                str(stem), "--source", TONE]
        rv, _, _ = run(argv, port=port)
        assert int(rv) == 0
        mets.append([m for i, m in enumerate(
            (d / "mt.met").read_text().split("\n")) if i not in (6, 7, 8)])
        rows.append(np.fromfile(str(stem) + ".bin", dtype=np.float32))
    assert mets[0] == mets[1] and int(mets[1][0].split()[0]) == 16382
    assert rows[1].size == 16382
    np.testing.assert_allclose(10.0 ** (rows[1] / 10.0),
                               10.0 ** (rows[0] / 10.0), rtol=1e-5)


@pytest.mark.parametrize("bins", ["8194", "9998", "12002", "16382"])
@pytest.mark.parametrize("extra,path", [
    (["--sk-file", "sk.dat"], "plain_sk (backend=auto, N={})"),
    (["--sk-excise", "3"], "plain_sk (backend=auto, N={})"),
    (["--multitaper", "7"], "plain_multitaper (N={})"),
    (["--pfb-taps", "4"], "plain_pfb (N={})"),
])
@pytest.mark.parametrize("streams", [[], ["--streams", "2"]])
def test_cli_exits_0(bins, extra, path, streams, capsys, tmp_path,
                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = (["-f", "100M", "-n", "4", "--frames-per-step", "4", "--source",
             "synthetic:", "-b", bins] + streams + extra)
    assert cli.main(argv, device=CPU) == 0
    assert f"Transform path: {path.format(bins)}\n" in capsys.readouterr().err


@pytest.mark.parametrize("bins", ["10000", "16382", "16384"])
@pytest.mark.parametrize("streams", [[], ["--streams", "2"]])
def test_cli_sk_under_bluestein_exits_0(bins, streams, capsys, tmp_path,
                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = (["-f", "100M", "-n", "4", "--frames-per-step", "4", "--source",
             "synthetic:", "-b", bins, "--sk-file", "sk.dat",
             "--fft-backend", "bluestein"] + streams)
    assert cli.main(argv, device=CPU) == 0
    assert (f"Transform path: plain_sk (backend=bluestein, N={bins})\n"
            in capsys.readouterr().err)


@pytest.mark.parametrize("extra,what", [
    (["-b", "4194302", "--sk-file", "sk.dat"], "--sk-file at 4194302 bins"),
    (["-b", "4194306", "--multitaper", "7"], "--multitaper at 4194306 bins"),
    (["-b", "8388608", "--sk-file", "sk.dat"], "--sk-file at 8388608 bins"),
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
    ("BL_SK_ARGV", "sk", 9998, 1), ("BL_MT_ARGV", "mt", 16382, 1),
    ("BL_PFB_ARGV", "pfb", 12002, 1), ("BL_SK_BLUESTEIN_ARGV", "sk", 16384, 1),
    ("BL_SK_S_ARGV", "sk", 9998, 2), ("BL_MT_S_ARGV", "mt", 16382, 2),
    ("BL_PFB_S_ARGV", "pfb", 12002, 2)])
def test_chip_smoke_drive_steps_are_the_sessions(drive, kind, N, streams,
                                                 monkeypatch, tmp_path):
    """chip_smoke.py phase 22 holds each form at the step its drive runs,
    sized by its drive_frames_per_step: the session on the same argv hands
    the form those frames and chunk, and nothing else (each call after the
    first returns the first's rows, as only the shapes are held here)."""
    argv = list(getattr(CHIP_SMOKE, drive))
    if kind == "sk":
        argv += ["--sk-file", str(tmp_path / "sk.txt")]
    table = {"sk": (kurtosis.SK_KERNELS, kurtosis.SK_STREAMS_KERNELS),
             "mt": (multitaper.TAPERS_KERNELS,
                    multitaper.TAPERS_STREAMS_KERNELS),
             "pfb": (pfb.PFB_KERNELS, pfb.PFB_STREAMS_KERNELS)}[kind][
                 streams > 1]
    form = table["chirp_large"]
    at = 3 if kind == "pfb" else 2   # the chunk's argument
    seen, first = [], []

    def recorded(*args, **kwargs):
        seen.append((tuple(args[0].shape), args[at]))
        if not first:
            first.append(form(*args, **kwargs))
        return first[0]

    monkeypatch.setitem(table, "chirp_large", recorded)
    rv, _, _ = run(argv, port=True)
    F, chunk = spectral.adapt_batch(
        CHIP_SMOKE.drive_frames_per_step(argv, streams))
    shape = (F, 2 * N) if streams == 1 else (streams, F, 2 * N)
    assert int(rv) == 0 and seen and set(seen) == {(shape, chunk)}


# --- the wrappers ---


@pytest.mark.parametrize("N", [8192, 2097154, 20001])
def test_wrappers_refuse_n_the_forms_do_not_take(N):
    raw = torch.zeros((8, 2 * N), dtype=torch.uint8)
    hist = torch.zeros((1, 2 * N), dtype=torch.uint8)
    with pytest.raises(ValueError, match="does not take"):
        be.fused_psd_sk_chirp_large(raw, 8, 8)
    with pytest.raises(ValueError, match="does not take"):
        be.fused_psd_tapers_chirp_large(raw, 8, 8, torch.ones((2, N)))
    with pytest.raises(ValueError, match="does not take"):
        be.fused_psd_pfb_chirp_large(raw, hist, 8, 8, torch.ones((2, N)),
                                     hist.clone())
    with pytest.raises(ValueError, match="does not take"):
        be.fused_psd_sk_chirp_large_streams(
            raw[None], torch.tensor([8], dtype=torch.int32), 8)


def test_wrappers_refuse_bad_arguments():
    N = 9998
    raw = torch.zeros((8, 2 * N), dtype=torch.uint8)
    with pytest.raises(ValueError, match="sigma"):
        be.fused_psd_sk_chirp_large(raw, 8, 8, sigma=-1.0)
    with pytest.raises(ValueError, match="group"):
        be.fused_psd_sk_chirp_large(raw, 8, 8, group_c=9)
    with pytest.raises(ValueError, match="n_valid"):
        be.fused_psd_sk_chirp_large_streams(
            raw[None], torch.tensor([8], dtype=torch.int64), 8)
    with pytest.raises(ValueError, match="tapers"):
        be.fused_psd_tapers_chirp_large(raw, 8, 8, torch.ones((2, N - 2)))
    hist = torch.zeros((3, 2 * N), dtype=torch.uint8)
    with pytest.raises(ValueError, match="distinct"):
        be.fused_psd_pfb_chirp_large(raw, hist, 8, 8, torch.ones((4, N)),
                                     hist)


def test_wrappers_on_cpu_count_as_plain():
    N, F = 8194, 8
    fp.COUNTS.reset()
    raw = torch.from_numpy(frames(F, N, 3))
    nv = torch.tensor([F], dtype=torch.int32)
    h = torch.ones((2, N))
    hist = [torch.zeros((1, 2 * N), dtype=torch.uint8) for _ in range(2)]
    be.fused_psd_sk_chirp_large(raw, F, F)
    be.fused_psd_tapers_chirp_large(raw, F, F, torch.ones((2, N)))
    be.fused_psd_pfb_chirp_large(raw, hist[0], F, F, h, hist[1])
    be.fused_psd_sk_chirp_large_streams(raw[None], nv, F)
    be.fused_psd_tapers_chirp_large_streams(raw[None], nv, F,
                                            torch.ones((2, N)))
    be.fused_psd_pfb_chirp_large_streams(raw[None], hist[0][None], nv, F, h,
                                         hist[1][None])
    counts = vars(fp.COUNTS)
    assert counts["plain"] == 6
    assert not any(v for k, v in counts.items() if k != "plain")


def test_streams_references_are_the_one_stream_forms_per_stream():
    """Each stream of the streams forms' plain versions is the one-stream
    plain version on its frames and count (its history for the PFB),
    within 1e-5 (the batched transform of all streams' frames rounds a
    few bins otherwise than one stream's)."""
    S, F, N = 2, 8, 12002
    raw = torch.from_numpy(streams_bytes(S, F, N, seed=5))
    counts = [F, 3]
    nv = torch.tensor(counts, dtype=torch.int32)
    tp = torch.from_numpy(multitaper._session_tapers(N, 4.0, 3))
    h = torch.from_numpy(pfb.pfb_prototype(N, 4).reshape(4, N))
    sk = be.sk_chirp_large_streams_reference(raw, nv, 8, None, 3.0)
    mt = be.tapers_chirp_large_streams_reference(raw, nv, 8, tp)
    hist = [torch.full((S, 3, 2 * N), 127, dtype=torch.uint8)
            for _ in range(2)]
    pf = be.pfb_chirp_large_streams_reference(raw, hist[0], nv, 8, h,
                                              hist[1])
    for s, c in enumerate(counts):
        one_hist = [torch.full((3, 2 * N), 127, dtype=torch.uint8),
                    torch.empty((3, 2 * N), dtype=torch.uint8)]
        np.testing.assert_allclose(
            sk[s].numpy(), be.sk_chirp_large_reference(
                raw[s], c, 8, None, 3.0).numpy(), rtol=1e-5)
        np.testing.assert_allclose(
            mt[s].numpy(), be.tapers_chirp_large_reference(
                raw[s], c, 8, tp).numpy(), rtol=1e-5)
        np.testing.assert_allclose(
            pf[s].numpy(), be.pfb_chirp_large_reference(
                raw[s], one_hist[0], c, 8, h, one_hist[1]).numpy(),
            rtol=1e-5)
        assert torch.equal(hist[1][s], one_hist[1])


def test_plain_reference_sums_the_plain_power():
    """The forms' plain transform is BL's three passes in torch ops: the
    same bits as BL's plain version per frame."""
    N, F = 9998, 8
    raw = torch.from_numpy(frames(F, N, 21))
    p = bl.chirp_large_power(raw)
    for nv in (F, 3):
        want = p.clone()
        want[nv:] = 0.0
        assert torch.equal(bl.chirp_large_reference(raw, nv, 8),
                           want.reshape(1, 8, N).sum(1).sum(0))


# --- the forms' new index arithmetic, transcribed ---


def bl_bins(N):
    """Pass C's bin m = m2 + M2 m1 of each (batch, thread, slot) of BL's
    transcription (bl_pass_c's |z|^2 layout)."""
    t = bl.chirp_regs_layout(N)
    r = t.regs
    M1, M2, B = r["N1"], r["N2"], r["B"]
    col, th = fl.thread_map(t.M)
    m1 = pass_bin(M1, last_element(M1, th[:, None], np.arange(16)[None, :]))
    return (np.arange(M2 // B)[:, None, None] * B + col[None, :, None]
            + M2 * m1[None])


def pass_c_powers(raw_f, N, tabs, window=None, load=None):
    """BL's passes A, B, C on one frame: |z|^2 by (batch, thread, slot)."""
    return bl_pass_c(bl_pass_b(bl_pass_a(raw_f, N, window, tabs, 4, load),
                               N, tabs), N, tabs)


def polyphase_load(virtual, j, P, h):
    """PFB-BL's pass-A load of output frame j: the ring's own row (virtual
    row j + P - 1, which the ring holds) last, the P - 1 older rows from
    the virtual array (history rows, then frames), p in order from zero,
    each product and sum rounded to float32 on its own."""
    N = h.shape[1]

    def load(re_own, im_own, n):
        nn = np.minimum(n, N - 1)
        sr = np.zeros(re_own.shape, np.float32)
        si = np.zeros(re_own.shape, np.float32)
        for p in range(P):
            if p == P - 1:
                xr, xi = re_own, im_own
            else:
                row = virtual[j + p]
                xr = row[2 * nn].astype(np.float32) - np.float32(127)
                xi = row[2 * nn + 1].astype(np.float32) - np.float32(127)
            sr = sr + xr * h[p][nn]
            si = si + xi * h[p][nn]
        return sr, si
    return load


def prepass_sums(virtual, h, counts, shape):
    """pfb_sums_kernel (csrc/pfb_sums.cuh) transcribed over its grid, on
    S streams' virtual arrays (S, P - 1 + F, 2 bins) u8: block (x, s, g),
    thread tid takes samples (n1, n2) and (n1, n2 + 1), n1 = (x / cols) 16
    + tid / 16, n2 = (x mod cols) 32 + 2 (tid mod 16), where n1 < rows and
    n < bins, over frames [g G, (g + 1) G) (G: ``sums_frames``); it holds
    h[0 .. P-1] of them and a window of their P - 1 older rows (virtual
    rows g G .. g G + P - 2 at first: the history's, then the frames'),
    forms frame j's sums from the window and frame j's own row (p in order
    from zero, each product and sum rounded to float32 on its own) for j <
    counts[s], writes each at ``sums_place`` of stream s's frame j (where
    B < 16
    turned through shared memory: sample i of the block, (i mod 16, i /
    16), at turn[(i / 16) 17 + i mod 16], thread i writing samples i and i
    + 256), and slides
    the window by that own row. Returns (scratch (S, F, frame) complex64,
    NaN where nothing was written; the virtual row each window slot held
    at frame j, (S, F, P - 1), -1 where j was not formed)."""
    S, V = virtual.shape[:2]
    P = h.shape[0]
    F = V - (P - 1)
    bins = virtual.shape[2] // 2
    rows, cols = le.SUMS_ROWS, le.SUMS_COLS
    blocks, grid_s, groups = le.sums_grid(shape, S, F)
    group = le.sums_frames(shape, S, F)
    assert grid_s == S and (groups - 1) * group < F <= groups * group
    per_row = (1 << shape["log2n2"]) // cols
    x = np.arange(blocks)[:, None]
    tid = np.arange(rows * cols // 2)[None, :]
    r_, q_ = tid // (cols // 2), 2 * (tid % (cols // 2))
    n1 = np.stack([(x // per_row) * rows + r_] * 2, -1)
    n2 = (x % per_row) * cols + q_
    n2 = np.stack([n2, n2 + 1], -1)
    if shape["log2b"] < 4:
        # The turn: what thread (r, q) leaves at turn[(q + d) 17 + r] is
        # what thread i mod 256 writes as sample i = (q + d) 16 + r.
        slot = {}
        for d in (0, 1):
            i = (q_ + d) * rows + r_
            at = (i // rows) * le.SUMS_TURN + i % rows
            assert ((at == (q_ + d) * le.SUMS_TURN + r_)).all()
            slot.update(zip(at.ravel().tolist(), i.ravel().tolist()))
        assert sorted(slot.values()) == list(range(rows * cols))
    n = (n1 << shape["log2n2"]) + n2
    keep = (n1 < shape["rows"]) & (n < bins)
    assert (keep[..., 0] == keep[..., 1]).all()
    n1, n2, n = n1[keep], n2[keep], n[keep]
    assert np.unique(n).size == n.size
    pos = le.sums_place(shape, n1, n2)
    assert np.unique(pos).size == pos.size and pos.max() < shape["frame"]
    scratch = np.full((S, F, shape["frame"]), np.nan, np.complex64)
    held = np.full((S, F, P - 1), -1, np.int64)

    def deq(row):
        return (row[2 * n].astype(np.float32) - np.float32(127),
                row[2 * n + 1].astype(np.float32) - np.float32(127))

    for s, g in np.ndindex(S, groups):
        hv = [h[p][n] for p in range(P)]
        first = g * group
        window = [deq(virtual[s, first + p]) for p in range(P - 1)]
        rows = [first + p for p in range(P - 1)]
        for j in range(first, min(first + group, max(counts[s], 0), F)):
            ore, oim = deq(virtual[s, j + P - 1])
            assert (held[s, j] == -1).all()   # one block forms frame j
            held[s, j] = rows
            re = np.zeros(n.shape, np.float32)
            im = np.zeros(n.shape, np.float32)
            for p in range(P - 1):
                re = re + window[p][0] * hv[p]
                im = im + window[p][1] * hv[p]
            re = re + ore * hv[P - 1]
            im = im + oim * hv[P - 1]
            scratch[s, j, pos] = re + 1j * im
            window = window[1:] + [(ore, oim)]
            rows = rows[1:] + [j + P - 1]
    return scratch, held


def pass_a_sums_reads(shape, t, groups, S, F, counts, k_rows):
    """The sums pass A reads on a pass-A grid of ``groups`` frames a
    block over S streams: for block (x, s), frame f of its group (f <
    counts[s]), batch b and thread tid = (c, tt), value k < k_rows: the
    scratch place (c0 / B + b) N1 B + k THREADS_A + tid of frame s F + f
    and the sample n = (tt + k TF1) N2 + c0 + b B + c it transforms.
    Returns (stream, frame, place, n) arrays of the reads with n < bins."""
    B, C, N1, N2, TF = t["B"], t["C"], t["N1"], t["N2"], t["TF1"]
    col, th = fl.thread_map(N1 * N2)
    tid = np.arange(t["threads_a"])
    k = np.arange(k_rows)
    out = []
    for s in range(S):
        for x in range(t["tiles_a"] * -(-F // groups)):
            c0 = (x % t["tiles_a"]) * C
            f0 = (x // t["tiles_a"]) * groups
            for f in range(f0, min(f0 + groups, min(max(counts[s], 0), F))):
                for b in range(t["subs"]):
                    place = ((c0 // B + b) * N1 * B
                             + k * t["threads_a"] + tid[:, None])
                    n = ((th[:, None] + k * TF) * N2 + c0 + b * B
                         + col[:, None])
                    m = n < shape["bins"]
                    out.append((np.full(m.sum(), s), np.full(m.sum(), f),
                                place[m], n[m]))
    return tuple(np.concatenate(a) for a in zip(*out))


def hold_prepass(virtual, h, counts, shape, t, groups, k_rows):
    """The transcribed pre-pass's sums are the plain sums bit for bit at
    every frame j < counts[s], nothing else of the scratch is written, its
    window held virtual rows j .. j + P - 2 at frame j (the history's rows
    while j + p < P - 1, then the frames'), and every sum pass A reads on
    its grid was written, as sample n's. Returns the scratch."""
    S = virtual.shape[0]
    P = h.shape[0]
    F = virtual.shape[1] - (P - 1)
    scratch, held = prepass_sums(virtual, h, counts, shape)
    st, fr, place, n = pass_a_sums_reads(shape, t, groups, S, F, counts,
                                         k_rows)
    for s in range(S):
        nv = min(max(counts[s], 0), F)
        plain = fpf.pfb_sums_reference(torch.from_numpy(virtual[s]),
                                       torch.from_numpy(h), F).numpy()
        for j in range(F):
            if j < nv:
                assert (held[s, j] == j + np.arange(P - 1)).all()
                assert ((held[s, j] < P - 1)
                        == (j + np.arange(P - 1) < P - 1)).all()
                assert (~np.isnan(scratch[s, j])).sum() == shape["bins"]
            else:
                assert (held[s, j] == -1).all()
                assert np.isnan(scratch[s, j]).all()
        mine = st == s
        np.testing.assert_array_equal(scratch[s, fr[mine], place[mine]],
                                      plain[fr[mine], n[mine]])
    return scratch


def sums_load(scratch_f, shape):
    """A pass-A load from the pre-pass's sums of one frame: sample n's sum
    at its ``sums_place``, 0 at n >= bins (which pass A does not read)."""

    def load(re_own, im_own, n):
        ok = n < shape["bins"]
        nn = np.where(ok, n, 0)
        v = scratch_f[le.sums_place(shape, nn >> shape["log2n2"],
                                    nn & ((1 << shape["log2n2"]) - 1))]
        v = np.where(ok, v, 0).astype(np.complex64)
        return v.real.astype(np.float32), v.imag.astype(np.float32)
    return load


@pytest.mark.parametrize("N,P,F,counts", [(8194, 4, 3, (3, 1)),
                                          (12002, 2, 2, (2,)),
                                          (16382, 16, 3, (0, 3, 2)),
                                          (9998, 32, 2, (1, 2))])
def test_pfb_prepass_transcription(N, P, F, counts):
    """PFB-BL's pre-pass (rows n1 < M1 / 2 of M's array, n < N) over S
    streams with uneven counts: its window holds the virtual rows each
    output frame needs, its sums are the plain sums bit for bit, and pass
    A on BL-S's grid reads each of its samples' sums (8 rows a thread)."""
    S = len(counts)
    rng = np.random.default_rng(N + P + S)
    virtual = rng.integers(0, 256, (S, P - 1 + F, 2 * N), dtype=np.uint8)
    h = pfb.pfb_prototype(N, P, "hann").reshape(P, N)
    shape = be.sums_shape(N)
    t = bl.chirp_regs_layout(N).regs
    group_a = bl.streams_grid(S, F, N, (RESIDENT,) * 3)[0]
    hold_prepass(virtual, h, list(counts), shape, t, group_a, 8)


@pytest.mark.parametrize("form", ["control", "sums"])
@pytest.mark.parametrize("N,P,F,nv", [(8194, 4, 3, 3), (12002, 2, 2, 1),
                                      (16382, 4, 2, 2)])
def test_pfb_pass_a_rows_transcription(N, P, F, nv, form):
    """PFB-BL's pass A, in its control's form (frame j's own row from the
    ring, filled from virtual row j + P - 1, the older rows from the
    history or the earlier frames) or on the pre-pass's sums (read from
    the scratch where the pre-pass wrote them), the polyphase sum before
    the chirp product: the sums are the plain version's bit for bit, and
    BL's transcription of them sums within 1e-5 of the float64 form and
    of the plain PFB-BL."""
    rng = np.random.default_rng(N + P)
    slot = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
    history = rng.integers(0, 256, (P - 1, 2 * N), dtype=np.uint8)
    h = pfb.pfb_prototype(N, P, "hann").reshape(P, N)
    virtual = np.concatenate([history, slot])
    plain_sums = fpf.pfb_sums_reference(torch.from_numpy(virtual),
                                        torch.from_numpy(h), F).numpy()
    shape = be.sums_shape(N)
    scratch = prepass_sums(virtual[None], h, [nv], shape)[0][0]

    def load_of(j):
        return (polyphase_load(virtual, j, P, h) if form == "control"
                else sums_load(scratch[j], shape))

    n = np.arange(N)
    for j in range(nv):
        own = virtual[j + P - 1]
        re = own[0::2].astype(np.float32) - np.float32(127)
        im = own[1::2].astype(np.float32) - np.float32(127)
        sr, si = load_of(j)(re, im, n)
        np.testing.assert_array_equal((sr + 1j * si).astype(np.complex64),
                                      plain_sums[j])
    tabs = bl_tables(N)
    m = bl_bins(N)
    _, _, group_c = bl.regs_grid(F, N, (RESIDENT,) * 3)
    rows = []
    for g in range(-(-F // group_c)):
        acc = np.zeros(m.shape, np.float32)
        for j in range(g * group_c, min((g + 1) * group_c, F, nv)):
            acc += pass_c_powers(virtual[j + P - 1], N, tabs,
                                 load=load_of(j))
        row = np.full(bl.chirp_regs_layout(N).row, np.nan, np.float32)
        row[m[m < N]] = acc[m < N]
        rows.append(row)
    got = sum_rows(rows)[:N].astype(np.float64)
    s64 = sum(z64(virtual)[p:p + nv] * h[p].astype(np.float64)
              for p in range(P))
    direct = (np.abs(np.fft.fft(s64, axis=1)) ** 2).sum(0)
    np.testing.assert_allclose(got, direct, rtol=1e-5,
                               atol=1e-6 * direct.mean())
    hist = [torch.from_numpy(history.copy()),
            torch.empty((P - 1, 2 * N), dtype=torch.uint8)]
    plain = be.pfb_chirp_large_reference(torch.from_numpy(slot), hist[0],
                                         nv, F, torch.from_numpy(h),
                                         hist[1]).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5,
                               atol=1e-6 * direct.mean())
    np.testing.assert_array_equal(hist[1].numpy(), virtual[nv:nv + P - 1])


def streams_rows(raw, counts, planes, power):
    """A pass C over S streams of F frames on BL-S's grid for RESIDENT
    blocks of each pass: block (x, s) sums ``power(s, f)`` ((batch,
    thread, slot) float32 arrays, one per plane) over stream s's frames of
    group x / TILES_C into partial rows (p S + s) G_s + x / TILES_C of
    plane p. Returns (partial rows, G_s)."""
    S, F, N = raw.shape[0], raw.shape[1], raw.shape[2] // 2
    m = bl_bins(N)
    _, _, group_c = bl.streams_grid(S, F, N, (RESIDENT,) * 3)
    G_s = -(-F // group_c)
    partial = np.full((planes * S * G_s, bl.chirp_regs_layout(N).row),
                      np.nan, np.float32)
    for s in range(S):
        for j in range(G_s):
            acc = np.zeros((planes,) + m.shape, np.float32)
            for f in range(j * group_c, min((j + 1) * group_c, F,
                                            counts[s])):
                acc += power(s, f)
            for p in range(planes):
                partial[(p * S + s) * G_s + j, m[m < N]] = acc[p][m < N]
    return partial, G_s


@pytest.mark.parametrize("N,K,counts", [(9998, 2, (3, 0)),
                                        (16382, 3, (2, 1))])
def test_taper_loop_rows_transcription(N, K, counts):
    """MT-BL: BL's passes once a taper (pass A windowed by taper row k),
    taper k's pass C writing partial row (k S + s) G_s + j; est_streams
    _kernel<kEstTapers> sums each stream's K G_s rows in its order and
    divides by K: within 1e-5 of the float64 form and of the plain
    MT-BL-S."""
    S, F = 2, 3
    raw = streams_bytes(S, F, N, seed=N + K)
    tapers = multitaper._session_tapers(N, 4.0, K)
    tabs = bl_tables(N)
    planes, G_s = streams_rows(
        raw, counts, K, lambda s, f: np.stack([pass_c_powers(
            raw[s, f], N, tabs, window=tapers[k]) for k in range(K)]))
    got = np.stack([stream_rows_sum(planes, S, G_s, K, s)[:N]
                    for s in range(S)]) / np.float32(K)
    plain = be.tapers_chirp_large_streams_reference(
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


@pytest.mark.parametrize("N,counts,wname", [(9998, (3, 1), None),
                                            (16382, (2, 0), "hann")])
def test_second_plane_transcription(N, counts, wname):
    """SK-BL's pass C: |z|^2 and its square summed by slot, the s1 row to
    (0 S + s) G_s + j and the s2 row to (S + s) G_s + j; each plane summed
    per stream: s1 is BL's transcription of the stream bit for bit (on
    the S = 1 grid: BL's own) and within 1e-5 of the float64 sum of
    |X|^2, s2 within 2e-5 of the float64 sum of |X|^4 and of the plain
    SK-BL (``close``'s rule: err/mean under 8 frames, there s2 within 3x
    plain's own error where that is larger, as chip_smoke.py phase 21
    holds a few frames)."""
    S, F = 2, 3
    w = None if wname is None else make_window(wname, N)
    raw = streams_bytes(S, F, N, seed=N)
    tabs = bl_tables(N)
    cache = {}

    def power(s, f):
        if (s, f) not in cache:
            p = pass_c_powers(raw[s, f], N, tabs, window=w)
            cache[(s, f)] = np.stack([p, p * p])
        return cache[(s, f)]

    planes, G_s = streams_rows(raw, counts, 2, power)
    # At these shapes BL-S's groups are BL's own.
    assert bl.streams_grid(S, F, N, (RESIDENT,) * 3)[2] \
        == bl.regs_grid(F, N, (RESIDENT,) * 3)[2]
    for s, c in enumerate(counts):
        s1 = stream_rows_sum(planes, S, G_s, 1, s)[:N]
        s2 = stream_rows_sum(planes[S * G_s:], S, G_s, 1, s)[:N]
        if c == 0:
            assert not s1.any() and not s2.any()
            continue
        assert np.array_equal(s1, bl_transcription(raw[s], c, w))
        p = power64(raw[s, :c], w)
        wt = None if w is None else torch.from_numpy(w)
        plain = be.fused_psd_sk_chirp_large(torch.from_numpy(raw[s]), c, F,
                                            wt)[1].numpy().astype(np.float64)
        s4 = (p * p).sum(0)
        close(s1, p.sum(0), c, 1e-5)
        # Under 8 frames, phase 21's rule: 2e-5 of the mean or 3x plain's
        # own error (a frame's |X|^4 peaks far above its mean).
        own = np.abs(plain - s4).max() / s4.mean()
        close(s2, s4, c, 2e-5 if c >= 8 else max(2e-5, 3 * own))
        close(s2, plain, c, 2e-5 if c >= 8 else max(2e-5, 3 * own))


def test_one_stream_s1_is_bl_transcription():
    """At S = 1 the SK form's grid is BL's: its s1 transcription (pass C's
    |z|^2 sums, summed as est_streams_kernel sums one plane) is
    bl_transcription's output bit for bit."""
    N, F, nv = 16382, 4, 3
    raw = frames(F, N, 77)[None]
    tabs = bl_tables(N)
    planes, G_s = streams_rows(raw, (nv,), 1, lambda s, f: pass_c_powers(
        raw[s, f], N, tabs)[None])
    s1 = stream_rows_sum(planes, 1, G_s, 1, 0)[:N]
    assert np.array_equal(s1, bl_transcription(raw[0], nv))


# --- the sources ---


def test_bl_and_its_forms_share_the_passes_header():
    """BL's streams passes and pass A's batch live in one header that BL
    and the forms both include, not in a copy; the forms' source
    instantiates BL's log2 M, 15 to 22, each in its dispatch, and names its
    passes as PASS_A .. PFB_CONTROL_A number them (the PFB's pass A on the
    pre-pass's sums, the pre-pass at two tap classes, the control's pass A
    last)."""
    header = (CSRC / "fused_psd_chirp_large_regs.cuh").read_text()
    bl_src = (CSRC / "fused_psd_chirp_large.cu").read_text()
    est = (CSRC / "fused_psd_chirp_large_est.cu").read_text()
    for src in (bl_src, est):
        assert '#include "fused_psd_chirp_large_regs.cuh"' in src
    for name in ("chirp_streams_a(", "chirp_streams_b(", "chirp_streams_c(",
                 "chirp_a_batch(", "struct ChirpRegs"):
        assert name in header
        assert name not in bl_src and name not in est
    assert int(re.search(r"constexpr int kEstMinLog2M = (\d+);",
                         est).group(1)) == 15
    assert int(re.search(r"constexpr int kEstMaxLog2M = (\d+);",
                         est).group(1)) == 22
    assert [int(m) for m in re.findall(
        r"case (\d+): return fn\(std::integral_constant<int, (?:\d+)>",
        est)] == list(range(15, 23))
    order = re.findall(r"case (\d): return reinterpret_cast<const void\*>\("
                       r"(\w+)<", est)
    assert [int(i) for i, _ in order] == [be.PASS_A, be.PASS_A_WINDOWED,
                                          be.PASS_B, be.PASS_C, be.SK_PASS_C,
                                          be.PFB_PASS_A]
    assert [k for _, k in order] == ["chirp_streams_a", "chirp_streams_a",
                                     "chirp_streams_b", "chirp_streams_c",
                                     "chirp_sk_c", "chirp_pfb_sums_a"]
    assert f"case {be.PFB_SUMS}: return sums_kernel<4>();" in est
    assert f"case {be.PFB_SUMS_32}: return sums_kernel<32>();" in est
    assert ("default: return reinterpret_cast<const void*>(chirp_pfb_a<LOG2M>)"
            in est)
    assert int(re.search(r"constexpr int kPasses = (\d+);", est).group(1)) \
        == be.PFB_CONTROL_A + 1
    assert '#include "pfb_sums.cuh"' in est
