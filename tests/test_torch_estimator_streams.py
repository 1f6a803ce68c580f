"""The estimators over ``--streams`` on the PyTorch package against the JAX
package's (``ShardedSkStep``, ``ShardedMultitaperStep``, ``ShardedPfbStep``),
on the CPU, where each streams entry runs its plain PyTorch version.

The JAX steps run on the conftest's CPU devices (a mesh of up to 8). Both
sides take the same seeded numpy bytes and uneven counts, 0 and F among
them. Per-stream rows and the combined sums are held at rtol 2e-5, the
single-stream estimator tests' tolerance; a stream of fewer than 8 frames
is held by its largest error over its mean power instead (a periodogram of
a frame or two has bins near 0, where a relative error measures the
difference of nearly equal terms), and a stream with no valid frame ships
exact zeros. The combined rows are also held to the port's own
single-stream session steps run per stream and summed. The CUDA entries
(``rpf_fused_psd_sk_streams``, ``rpf_fused_psd_tapers_streams``,
``rpf_fused_psd_pfb_streams``) run only on a card (chip_smoke.py phase 16);
their block -> (stream, frames, partial row) arithmetic, the second pass's
row order and the PFB's history rows are transcribed in numpy here.
"""

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu.models import kurtosis as jax_kurtosis
from rtl_power_fftw_tpu.models import multitaper as jax_multitaper
from rtl_power_fftw_tpu.models import pfb as jax_pfb
from rtl_power_fftw_tpu.parallel import make_mesh as jax_make_mesh
from rtl_power_fftw_tpu_torch.auxdata import make_window
from rtl_power_fftw_tpu_torch.config import parse_args
from rtl_power_fftw_tpu_torch.exceptions import RPFexception
from rtl_power_fftw_tpu_torch.models import kurtosis, multitaper, pfb
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_sk as fsk
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_tapers as fmt
from rtl_power_fftw_tpu_torch.ops.spectral import adapt_batch, pad_frames
from rtl_power_fftw_tpu_torch.parallel import (MultiStreamAcquisition,
                                               make_mesh, make_streams_step)
from rtl_power_fftw_tpu_torch.sources import SyntheticSource

from test_torch_fused_psd_regs import h100_resident

CPU = torch.device("cpu")
MESH = make_mesh(CPU)
RTOL = 2e-5
#: Streams with fewer valid frames are held by err/mean (module docstring).
FEW = 8


def streams_bytes(S, F, N, seed):
    return np.random.default_rng(seed).integers(0, 256, (S, F, 2 * N),
                                                dtype=np.uint8)


def uneven(S, F):
    """(S,) counts: all, none, a few and some, repeated."""
    return np.resize(np.array([F, 0, 3, F, F // 2 + 1, F, 1, F - 2],
                              np.int32), S)


def jax_mesh(S):
    return jax_make_mesh(8 if S % 8 == 0 else S)


def assert_rows_close(got, want, counts):
    """Row s of ``got`` against ``want``: rtol 2e-5 where the stream has at
    least FEW frames, err/mean <= 2e-5 where it has fewer, exact zeros
    where it has none."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    for s, c in enumerate(counts):
        if c == 0:
            assert not got[s].any() and not want[s].any()
        elif c >= FEW:
            np.testing.assert_allclose(got[s], want[s], rtol=RTOL)
        else:
            scale = np.abs(want[s]).mean()
            assert np.abs(got[s] - want[s]).max() <= RTOL * scale


def assert_combined_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).mean())


# --- the steps against the JAX package's --------------------------------


@pytest.mark.parametrize("S,N,F,wname,sigma", [
    (8, 256, 16, None, 0.0),
    (8, 1024, 16, "hann", 0.0),
    (2, 256, 32, None, 3.0),
    (8, 1024, 32, "blackman", 3.0),
])
def test_sharded_sk_step_matches_jax(S, N, F, wname, sigma):
    w = None if wname is None else make_window(wname, N)
    raw = streams_bytes(S, F, N, seed=N + S)
    counts = uneven(S, F)
    jstep = jax_kurtosis.ShardedSkStep(jax_mesh(S), N, F, streams=S,
                                       window=w, excise_sigma=sigma)
    step = kurtosis.ShardedSkStep(MESH, N, F, S, window=w,
                                  excise_sigma=sigma)
    assert step.fields == jstep.fields
    assert step.path == "plain_sk" and step.F == F
    want_ps, want_comb = (np.asarray(a, np.float64)
                          for a in jstep(raw, counts))
    ps, comb = step(raw, counts)
    assert ps.shape == (S, N) and comb.shape == (len(step.fields), N)
    assert ps.dtype == comb.dtype == torch.float32
    assert_rows_close(ps.numpy(), want_ps, counts)
    for i, name in enumerate(step.fields):
        if name == "kept":
            np.testing.assert_array_equal(comb[i].numpy(), want_comb[i])
        else:
            assert_combined_close(comb[i].numpy(), want_comb[i])


def test_sharded_sk_excise_gates_only_the_burst_stream():
    """A tone burst in a quarter of one stream's frames: that stream's bin
    is gated (M = its own count), the other streams keep it, and the
    combined kept row is the streams' counts less the burst stream's at
    that bin."""
    S, N, F, sigma = 4, 256, 32, 3.0
    rng = np.random.default_rng(61)
    iq = rng.normal(127.0, 6.0, size=(S, F, 2 * N))
    t = np.arange(N)
    burst = 40.0 * np.exp(2j * np.pi * 13 * t / N)
    iq[2, :F // 4, 0::2] += burst.real
    iq[2, :F // 4, 1::2] += burst.imag
    raw = np.clip(np.round(iq), 0, 255).astype(np.uint8)
    counts = np.array([F, F - 4, F, 0], np.int32)
    step = kurtosis.ShardedSkStep(MESH, N, F, S, excise_sigma=sigma)
    jstep = jax_kurtosis.ShardedSkStep(jax_mesh(S), N, F, streams=S,
                                       excise_sigma=sigma)
    _, comb = step(raw, counts)
    rows = fsk.fused_psd_sk_streams(torch.from_numpy(raw),
                                    torch.from_numpy(counts), 32, None,
                                    sigma).numpy()
    kept = rows[:, 3]
    assert kept[2, 13] == 0.0
    assert kept[0, 13] == F and kept[1, 13] == F - 4 and kept[3, 13] == 0
    assert comb[3, 13].item() == 2 * F - 4
    np.testing.assert_array_equal(comb[3].numpy(),
                                  np.asarray(jstep(raw, counts)[1][3]))
    # s1 * keep drops exactly the gated bins of each stream.
    np.testing.assert_array_equal(rows[:, 2], rows[:, 0] * (kept > 0))


@pytest.mark.parametrize("S,N,F,K", [(8, 256, 16, 2), (2, 1024, 16, 7),
                                     (8, 256, 24, 7)])
def test_sharded_multitaper_step_matches_jax(S, N, F, K):
    raw = streams_bytes(S, F, N, seed=7 * K + S)
    counts = uneven(S, F)
    jstep = jax_multitaper.ShardedMultitaperStep(jax_mesh(S), N, F,
                                                 streams=S, K=K)
    step = multitaper.ShardedMultitaperStep(MESH, N, F, S, K=K)
    assert step.path == "plain_multitaper" and step.F == F
    want_ps, want_comb = (np.asarray(a, np.float64)
                          for a in jstep(raw, counts))
    ps, comb = step(raw, counts)
    assert ps.shape == (S, N) and comb.shape == (N,)
    assert_rows_close(ps.numpy(), want_ps, counts)
    assert_combined_close(comb.numpy(), want_comb)


@pytest.mark.parametrize("S,N,F,P", [(8, 256, 16, 2), (2, 1024, 16, 4),
                                     (8, 256, 24, 4)])
def test_sharded_pfb_step_matches_jax_over_calls_and_reset(S, N, F, P):
    """Three calls, each stream's counts running through 0, fewer than P -
    1 (where P > 2), F and others, the histories carried from call to call,
    then reset() and a fourth call from byte-127 histories."""
    jstep = jax_pfb.ShardedPfbStep(jax_mesh(S), N, F, streams=S, taps=P)
    step = pfb.ShardedPfbStep(MESH, N, F, S, taps=P)
    assert step.path == "plain_pfb" and step.F == F
    schedule = [np.resize(np.array(c, np.int32), S) for c in (
        [F, 0, 1, F, 5, F, 0, F - 3],
        [0, F, F, 1, 0, 9, F, 2],
        [F, 1, 0, F, F, 0, 3, F])]
    for call, counts in enumerate(schedule + ["reset"]):
        if isinstance(counts, str):
            step.reset()
            jstep.reset()
            counts = schedule[0]
        raw = streams_bytes(S, F, N, seed=100 * call + P)
        want_ps, want_comb = (np.asarray(a, np.float64)
                              for a in jstep(raw, counts))
        ps, comb = step(raw, counts)
        assert ps.shape == (S, N) and comb.shape == (N,)
        assert_rows_close(ps.numpy(), want_ps, counts)
        assert_combined_close(comb.numpy(), want_comb)
        # The histories the next call reads are the JAX step's tails.
        np.testing.assert_array_equal(step._history[0].numpy(), jstep._tails)


# --- the combined rows against the port's own single-stream steps --------


def single_stream_steps(kind, N, F):
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


@pytest.mark.parametrize("kind", ["sk", "sk excise", "multitaper", "pfb"])
def test_combined_is_the_single_stream_steps_summed(kind):
    S, N, F = 3, 256, 16
    step = streams_step(kind, N, F, S)
    singles = [single_stream_steps(kind, N, F) for _ in range(S)]
    for call, counts in enumerate(([F, 0, 9], [4, F, 0])):
        counts = np.array(counts, np.int32)
        raw = streams_bytes(S, F, N, seed=50 + call)
        ps, comb = step(raw, counts)
        parts = []
        for s in range(S):
            out = singles[s](raw[s], int(counts[s]))
            parts.append(np.stack([t.numpy() for t in out])
                         if isinstance(out, tuple) else out.numpy())
        want = np.sum(parts, axis=0)
        np.testing.assert_allclose(comb.numpy(), want, rtol=1e-6)
        first = [p[0] if p.ndim == 2 else p for p in parts]
        np.testing.assert_allclose(ps.numpy(), np.stack(first), rtol=1e-6)


# --- the CUDA entries' index arithmetic, transcribed ----------------------


def frame_power32(raw, window=None):
    """|DFT|^2 in float32 of (..., 2N) u8 frames (numpy's transform)."""
    z = ((raw[..., 0::2].astype(np.float64) - 127.0)
         + 1j * (raw[..., 1::2].astype(np.float64) - 127.0))
    if window is not None:
        z = z * np.asarray(window, np.float32).astype(np.float64)
    X = np.fft.fft(z, axis=-1)
    return (X.real ** 2 + X.imag ** 2).astype(np.float32)


def stream_rows_sum(partial, S, G_s, Q, s):
    """est_streams_kernel's sum_stream_rows for stream s: rows r = q * G_s +
    j at (q * S + s) * G_s + j, lane l taking r = l, l + 8, ... in float64,
    the lanes added in order, the total rounded once to float32."""
    rows = np.stack([partial[(r // G_s * S + s) * G_s + r % G_s]
                     for r in range(Q * G_s)]).astype(np.float64)
    t = np.zeros(partial.shape[1])
    for lane in range(8):
        t += rows[lane::8].sum(0)
    return t.astype(np.float32)


def clamp(c, F):
    return min(max(int(c), 0), F)


def sk_streams_transcription(raw, counts, chunk, sigma, resident):
    """rpf_fused_psd_sk_streams: K4's grid over S * F frames; block g
    serves stream g // G_s, its frames [j group, min((j + 1) group, F,
    n_valid[s])) into partial row g (|X|^2) and row S G_s + g (|X|^4);
    then each stream's two planes summed and gated on its own count."""
    S, F, two_n = raw.shape
    N = two_n // 2
    group = fp.k1_group(S * F, chunk, resident)
    G_s = -(-F // group)
    p = frame_power32(raw)
    partial = np.zeros((2 * S * G_s, N), np.float32)
    for g in range(S * G_s):
        s, j = divmod(g, G_s)
        for f in range(j * group, min(j * group + group, F,
                                      clamp(counts[s], F))):
            partial[g] += p[s, f]
            partial[S * G_s + g] += p[s, f] * p[s, f]
    out = np.zeros((S, 4 if sigma > 0 else 2, N), np.float32)
    for s in range(S):
        out[s, 0] = stream_rows_sum(partial, S, G_s, 1, s)
        out[s, 1] = stream_rows_sum(partial[S * G_s:], S, G_s, 1, s)
        if sigma > 0:
            M = np.float32(clamp(counts[s], F))
            keep = fsk.sk_keep(torch.from_numpy(out[s, 0]),
                               torch.from_numpy(out[s, 1]), float(M),
                               sigma).numpy()
            out[s, 2] = out[s, 0] * keep
            out[s, 3] = M * keep
    return out, group


@pytest.mark.parametrize("S,N,fps,counts,sigma,group", [
    (16, 256, 256, None, 0.0, 16),      # config 5's S and F: one wave
    (3, 256, 64, [64, 0, 5], 3.0, 1),
    (4, 128, 24, [24, 9, 0, 17], 0.0, 1),
    (3, 64, 64, [-3, 70, 64], 3.0, 1),  # counts act as their bounds
])
def test_sk_streams_rows_transcription_matches_plain(S, N, fps, counts,
                                                     sigma, group):
    F, chunk = adapt_batch(fps)
    nv = np.full(S, F, np.int32) if counts is None \
        else np.asarray(counts, np.int32)
    raw = streams_bytes(S, F, N, seed=S * N + F)
    got, g = sk_streams_transcription(raw, nv, chunk, sigma,
                                      h100_resident(N))
    assert g == group
    want = fsk.fused_psd_sk_streams_reference(
        torch.from_numpy(raw), torch.from_numpy(nv), chunk, None,
        sigma).numpy()
    for s in range(S):
        if clamp(nv[s], F) == 0:
            assert not got[s].any() and not want[s].any()
            continue
        np.testing.assert_allclose(got[s, :2], want[s, :2], rtol=1e-5)
        # s1 is K4's row: the same partial rows, the same row sum.
    k4 = fp.fused_psd_streams_reference(torch.from_numpy(raw),
                                        torch.from_numpy(nv), chunk).numpy()
    np.testing.assert_allclose(got[:, 0], k4, rtol=1e-5)


def tapers_streams_transcription(raw, counts, chunk, tapers, batch,
                                 resident):
    """rpf_fused_psd_tapers_streams: the batch kernel on
    streams_batch_grid's grid (``batch``) or the control on tapers_group's
    over S * F frames; block (s G_s + j, y) runs tapers [y KB, (y + 1) KB)
    (the control: taper y) of stream s's frames [j group, min((j + 1)
    group, F, n_valid[s])) into partial row y S G_s + s G_s + j; each
    stream's Q G_s rows summed in est_streams_kernel's order, over K."""
    S, F, two_n = raw.shape
    N = two_n // 2
    K = tapers.shape[0]
    if batch:
        group, KB = fmt.streams_batch_grid(S, F, K, N, resident)
    else:
        group, KB = fmt.tapers_group(S * F, chunk, K, resident), 1
    G_s = -(-F // group)
    Q = -(-K // KB)
    z = ((raw[..., 0::2].astype(np.float64) - 127.0)
         + 1j * (raw[..., 1::2].astype(np.float64) - 127.0))
    partial = np.zeros((Q * S * G_s, N), np.float32)
    for y in range(Q):
        for g in range(S * G_s):
            s, j = divmod(g, G_s)
            row = y * S * G_s + g
            for k in range(y * KB, min(y * KB + KB, K)):
                for f in range(j * group, min(j * group + group, F,
                                              clamp(counts[s], F))):
                    X = np.fft.fft(z[s, f] * tapers[k].astype(np.float64))
                    partial[row] += (X.real ** 2 + X.imag ** 2).astype(
                        np.float32)
    out = np.stack([stream_rows_sum(partial, S, G_s, Q, s) / np.float32(K)
                    for s in range(S)])
    return out, (group, KB)


@pytest.mark.parametrize("S,N,F,K,counts,batch,grid", [
    (4, 1024, 16, 7, [16, 0, 5, 9], True, (4, 1)),
    (16, 2048, 8, 7, None, True, (2, 2)),
    (3, 1024, 16, 3, [16, 16, 2], True, (4, 1)),
    (3, 256, 16, 2, [16, 0, 7], False, (1, 1)),
])
def test_tapers_streams_rows_transcription_matches_plain(S, N, F, K, counts,
                                                         batch, grid):
    """The grids are the H100's (264 resident blocks of the batch kernel at
    1024 and 2048 bins, 132 x 2 of the control's)."""
    F, chunk = adapt_batch(F)
    nv = np.full(S, F, np.int32) if counts is None \
        else np.asarray(counts, np.int32)
    raw = streams_bytes(S, F, N, seed=K * N + S)
    tapers = multitaper._session_tapers(N, 4.0, K)
    assert (fmt.batch_shape(N, K) is not None) == batch
    got, g = tapers_streams_transcription(raw, nv, chunk, tapers, batch,
                                          264 if batch else
                                          h100_resident(N, True))
    assert g == grid
    want = fmt.fused_psd_tapers_streams_reference(
        torch.from_numpy(raw), torch.from_numpy(nv), chunk,
        torch.from_numpy(tapers)).numpy()
    assert_rows_close(got, want, np.clip(nv, 0, F))


def test_streams_batch_grid_is_one_wave_sized_on_F():
    """The batch kernel's streams grid: lanes-multiple groups, every stream
    G_s blocks, S G_s within the wave unless a block's lanes each take one
    frame, and the taper ranges from the room the wave leaves."""
    resident = 264
    for S, F, K, N in ((16, 256, 7, 2048), (2, 256, 7, 2048),
                       (1, 64, 16, 1024), (8, 1024, 3, 4096)):
        lanes = fp.regs_shape(N).lanes
        group, per_block = fmt.streams_batch_grid(S, F, K, N, resident)
        G_s = -(-F // group)
        assert group % lanes == 0
        assert S * G_s <= resident or group == lanes
        ranges = -(-K // per_block)
        assert ranges * S * G_s <= max(resident, K * S * G_s)
        assert 1 <= per_block <= K
    assert fmt.streams_batch_grid(16, 256, 7, 2048, resident) == (16, 7)
    assert fmt.streams_batch_grid(1, 256, 7, 2048, resident) == (2, 4)


def pfb_history_transcription(raw, history, counts, P):
    """pfb_history_kernel: row r of stream s's next history is row
    clamp(n_valid[s]) + r of its virtual array (history rows, then slot
    rows)."""
    S, F, _ = raw.shape
    out = np.empty_like(history)
    for s in range(S):
        nv = clamp(counts[s], F)
        for r in range(P - 1):
            v = nv + r
            out[s, r] = history[s, v] if v < P - 1 else raw[s, v - (P - 1)]
    return out


@pytest.mark.parametrize("P", [2, 4, 16])
def test_pfb_history_rows_transcription_matches_plain(P):
    S, N, F = 5, 64, 16
    raw = streams_bytes(S, F, N, seed=P)
    history = np.random.default_rng(P + 1).integers(
        0, 256, (S, P - 1, 2 * N), dtype=np.uint8)
    counts = np.array([0, 1, P - 2, F, 40], np.int32)[:S]
    want_next = pfb_history_transcription(raw, history, counts, P)
    out = torch.empty((S, P - 1, 2 * N), dtype=torch.uint8)
    h = torch.from_numpy(pfb.pfb_prototype(N, P).reshape(P, N))
    fpf.fused_psd_pfb_streams(torch.from_numpy(raw),
                              torch.from_numpy(history.copy()),
                              torch.from_numpy(counts), 8, h, out)
    np.testing.assert_array_equal(out.numpy(), want_next)
    # The JAX step's host rule (pfb.py:372-380) gives the same rows.
    for s in range(S):
        v = clamp(counts[s], F)
        tail = history[s]
        if v >= P - 1:
            tail = raw[s, v - P + 1:v]
        elif v > 0:
            tail = np.concatenate([history[s], raw[s, :v]])[-(P - 1):]
        np.testing.assert_array_equal(want_next[s], tail)


def test_pfb_streams_rows_are_the_single_stream_kernels_rows():
    """Each stream's row and next history are the single-stream plain
    version's on that stream's frames, history and count; ``fresh`` sets
    every stream's history to byte 127 first."""
    S, N, F, P = 4, 128, 16, 4
    raw = streams_bytes(S, F, N, seed=3)
    counts = np.array([F, 0, 2, 11], np.int32)
    h = torch.from_numpy(pfb.pfb_prototype(N, P).reshape(P, N))
    hist = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (S, P - 1, 2 * N), dtype=np.uint8))
    out = torch.empty_like(hist)
    got = fpf.fused_psd_pfb_streams(torch.from_numpy(raw), hist,
                                    torch.from_numpy(counts), 16, h, out,
                                    fresh=True)
    assert (hist == 127).all()
    for s in range(S):
        one = torch.empty((P - 1, 2 * N), dtype=torch.uint8)
        want = fpf.fused_psd_pfb_reference(
            torch.from_numpy(raw[s]), torch.full((P - 1, 2 * N), 127,
                                                 dtype=torch.uint8),
            int(counts[s]), 16, h, one)
        assert torch.equal(got[s], want) and torch.equal(out[s], one)


# --- the wrappers' checks and counts --------------------------------------


def _sk(raw, nv):
    return fsk.fused_psd_sk_streams(raw, nv, 8)


def _mt(raw, nv):
    N = raw.shape[-1] // 2
    return fmt.fused_psd_tapers_streams(raw, nv, 8, torch.ones((3, N)))


def _pfb(raw, nv):
    S, N = raw.shape[0], raw.shape[-1] // 2
    return fpf.fused_psd_pfb_streams(
        raw, torch.zeros((S, 3, 2 * N), dtype=torch.uint8), nv, 8,
        torch.ones((4, N)), torch.zeros((S, 3, 2 * N), dtype=torch.uint8))


ENTRIES = {"sk": _sk, "mt": _mt, "pfb": _pfb}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("make,n_valid,exc", [
    (lambda: torch.zeros((2, 8, 512), dtype=torch.int16), [8, 8], TypeError),
    (lambda: torch.zeros((8, 512), dtype=torch.uint8), [8], ValueError),
    (lambda: torch.zeros((2, 8, 1000), dtype=torch.uint8), [8, 8],
     ValueError),
    (lambda: torch.zeros((2, 512, 8), dtype=torch.uint8).transpose(1, 2),
     [8, 8], ValueError),
    (lambda: torch.zeros((2, 8, 512), dtype=torch.uint8), [8, 8, 8],
     ValueError),
    (lambda: torch.zeros((2, 8, 512), dtype=torch.uint8), None, ValueError),
])
def test_streams_entries_reject_what_the_kernels_do_not_take(entry, make,
                                                             n_valid, exc):
    nv = torch.tensor(n_valid if n_valid is not None else [8, 8],
                      dtype=torch.int32 if n_valid is not None
                      else torch.int64)
    with pytest.raises(exc):
        ENTRIES[entry](make(), nv)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_streams_entries_reject_counts_off_the_frames_device(entry):
    raw = torch.zeros((2, 8, 512), dtype=torch.uint8)
    nv = torch.tensor([8, 8], dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="n_valid on meta"):
        ENTRIES[entry](raw, nv)


@pytest.mark.parametrize("bad", ["tapers", "history", "history_out", "h",
                                 "same", "sigma", "group"])
def test_streams_entries_reject_bad_side_arguments(bad):
    S, N, F = 2, 64, 8
    raw = torch.zeros((S, F, 2 * N), dtype=torch.uint8)
    nv = torch.tensor([F, 0], dtype=torch.int32)
    hist = torch.zeros((S, 3, 2 * N), dtype=torch.uint8)
    with pytest.raises(ValueError):
        if bad == "tapers":
            fmt.fused_psd_tapers_streams(raw, nv, 8, torch.ones((3, N + 1)))
        elif bad == "sigma":
            fsk.fused_psd_sk_streams(raw, nv, 8, None, -1.0)
        elif bad == "group":
            fsk.fused_psd_sk(raw[0], F, 8, group=F + 1)
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
            fpf.fused_psd_pfb_streams(raw, hist, nv, 8, h, out)


def test_streams_entries_on_cpu_count_as_plain():
    counts = fp.COUNTS
    counts.reset()
    raw = torch.zeros((2, 8, 128), dtype=torch.uint8)
    nv = torch.tensor([8, 3], dtype=torch.int32)
    for entry in ENTRIES.values():
        entry(raw, nv)
    fsk.fused_psd_sk_streams_control(raw, nv, 8)
    fmt.fused_psd_tapers_streams_control(raw, nv, 8, torch.ones((3, 64)))
    assert counts.plain == 5
    assert not any(v for k, v in vars(counts).items() if k != "plain")


# --- the steps' own checks, the engine's choice and its reset -------------


def test_sharded_estimator_steps_validation():
    with pytest.raises(RPFexception, match="2 devices") as e:
        kurtosis.ShardedSkStep([CPU, CPU], 256, 8, 2)
    assert int(e.value.return_value) == 3
    for make in (lambda: kurtosis.ShardedSkStep(MESH, 4194306, 8, 2),
                 lambda: kurtosis.ShardedSkStep(MESH, 256, 8, 2,
                                                backend="xla"),
                 lambda: multitaper.ShardedMultitaperStep(MESH, 4194302, 8, 2,
                                                          K=2),
                 lambda: pfb.ShardedPfbStep(MESH, 8388608, 8, 2)):
        with pytest.raises(RPFexception, match="Not yet ported") as e:
            make()
        assert int(e.value.return_value) == 3
    with pytest.raises(ValueError, match="taps"):
        pfb.ShardedPfbStep(MESH, 256, 8, 2, taps=1)
    with pytest.raises(ValueError, match="window"):
        kurtosis.ShardedSkStep(MESH, 256, 8, 2, window=np.ones(128))
    step = multitaper.ShardedMultitaperStep(MESH, 64, 8, 2, K=2)
    with pytest.raises(ValueError, match="counts in"):
        step(np.zeros((2, 8, 128), np.uint8), [9, 0])


@pytest.mark.parametrize("extra,cls,fields", [
    (["--pfb-taps", "4"], pfb.ShardedPfbStep, ("s1",)),
    (["--multitaper", "3"], multitaper.ShardedMultitaperStep, ("s1",)),
    (["--sk-file", "x.sk"], kurtosis.ShardedSkStep, ("s1", "s2")),
    (["--sk-excise", "3"], kurtosis.ShardedSkStep,
     ("s1", "s2", "s1_clean", "kept")),
    ([], None, ("s1",)),
])
def test_engine_picks_the_step_as_the_jax_engine(extra, cls, fields):
    import io
    params = parse_args(["-b", "256", "--streams", "2"] + extra,
                        stderr=io.StringIO())
    step = make_streams_step(params, MESH, 16, 2)
    if cls is not None:
        assert isinstance(step, cls)
    assert getattr(step, "fields", ("s1",)) == fields


@pytest.mark.parametrize("extra,kind", [
    (["--pfb-taps", "4"], "pfb"), (["--sk-excise", "3"], "sk excise"),
    (["--multitaper", "4"], "multitaper"), (["--sk-file", "x"], "sk")])
def test_multistream_estimators_match_sum_of_streams_and_reset(extra, kind):
    """The engine's result fields against the single-stream steps run on
    each stream's acquisition and summed, over two acquisitions in a row:
    run() resets the stateful step, so the second starts from a fresh
    history as a new single-stream step does."""
    import io
    from rtl_power_fftw_tpu_torch.config import BASE_BUF
    S, N, repeats, rate, F = 3, 64, 24, 2_048_000, 16
    params = parse_args(["-b", str(N), "-n", str(repeats), "-r", str(rate),
                         "--streams", str(S)] + extra, stderr=io.StringIO())

    def source(seed):
        s = SyntheticSource(tones=[(100_200_000, 30.0)], noise=5.0,
                            seed=seed)
        s.set_sample_rate(rate)
        return s

    acq = MultiStreamAcquisition(params, [source(seed) for seed in range(S)],
                                 MESH, frames_per_step=F)
    results = [acq.run(freq=100_000_000) for _ in range(2)]
    fields = getattr(acq.step, "fields", ("s1",))
    # Each acquisition reads its bytes rounded up to BASE_BUF (one read).
    nbytes = 2 * N * repeats
    read = min(params.buf_length, BASE_BUF * -(-nbytes // BASE_BUF))
    wants = [{f: np.zeros(N) for f in fields} for _ in results]
    for seed in range(S):
        src = source(seed)
        src.set_frequency(100_000_000)
        for want in wants:
            stream, _ = src.read(read)
            rows = np.asarray(stream)[:nbytes].reshape(repeats, 2 * N)
            single = single_stream_steps(kind, N, F)
            for lo in range(0, repeats, F):
                batch = rows[lo:lo + F]
                out = single(pad_frames(batch, F), len(batch))
                out = out if isinstance(out, tuple) else (out,)
                for f, part in zip(fields, out):
                    want[f] += part.numpy()
    for res, want in zip(results, wants):
        assert res.repeats_done.tolist() == [repeats] * S
        got = {"s1": res.pwr, "s2": res.pwr2, "s1_clean": res.pwr_clean,
               "kept": res.kept}
        for f in fields:
            np.testing.assert_allclose(got[f], want[f], rtol=1e-5)
        for f in set(got) - set(fields):
            assert got[f] is None
