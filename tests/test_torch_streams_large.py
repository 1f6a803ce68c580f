"""``--streams`` above 16384 bins: the streams entries of the large kernel
(L-S), of ML (ML-S) and of BL (BL-S), the routes of ``ShardedPsdStep``
and the frame-sharded long integration (``parallel/longint.py``), against
the JAX package.

The port runs on the CPU, so each streams entry is its plain PyTorch
version (a per-stream loop over the one-stream plain version). L-S's is
held to the JAX Pallas streams kernel in interpret mode (the TPU kernel it
replaces at 32768-65536), ML-S's and BL-S's to the JAX ``ShardedPsdStep``
on a CPU mesh (XLA's FFT: the JAX package has no Pallas kernel there).
The kernels' block -> (stream, frames) arithmetic and each stream's row
sum are pinned by a numpy transcription; the kernels themselves run only
on a card (chip_smoke.py phase 17, and the test marked ``cuda``).
"""

import numpy as np
import pytest
import torch

import rtl_power_fftw_tpu.interrupts as jax_interrupts
import rtl_power_fftw_tpu_torch.interrupts as interrupts
from rtl_power_fftw_tpu.ops.kernels import make_fused_psd_fn
from rtl_power_fftw_tpu.parallel import ShardedPsdStep as JaxShardedPsdStep
from rtl_power_fftw_tpu.parallel import make_mesh as jax_make_mesh
from rtl_power_fftw_tpu.parallel.longint import \
    sharded_accumulate as jax_sharded_accumulate
from rtl_power_fftw_tpu_torch.auxdata import make_window
from rtl_power_fftw_tpu_torch.exceptions import ReturnValue, RPFexception
from rtl_power_fftw_tpu_torch.ops import spectral
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_chirp_large as fbl
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_large as fl
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed_large as fml
from rtl_power_fftw_tpu_torch.parallel import (ShardedPsdStep, make_mesh,
                                               sharded, sharded_accumulate)

from golden import golden_accumulate
from test_torch_awkward_n import CHIP_SMOKE
from test_torch_parallel import golden_streams, make_streams
from test_torch_session import (LINEAR_RTOL, assert_text_outputs_match,
                                outcome, run)

CPU = torch.device("cpu")
RTOL = 1e-5

#: Each streams entry: (wrapper, plain version, one-stream plain version).
ENTRIES = {
    "L-S": (fl.fused_psd_large_streams, fl.fused_psd_large_streams_reference,
            fl.fused_psd_large_reference),
    "ML-S": (fml.fused_psd_mixed_large_streams,
             fml.fused_psd_mixed_large_streams_reference,
             fml.fused_psd_mixed_large_reference),
    "BL-S": (fbl.fused_psd_chirp_large_streams,
             fbl.chirp_large_streams_reference, fbl.chirp_large_reference),
}


@pytest.fixture(autouse=True)
def _reset_interrupts():
    for module in (interrupts, jax_interrupts):
        module.reset()
    yield
    for module in (interrupts, jax_interrupts):
        module.reset()


def tensors(raw, counts, window=None):
    return (torch.from_numpy(raw), torch.from_numpy(np.asarray(counts,
                                                               np.int32)),
            None if window is None else torch.from_numpy(window))


# --- the plain versions against the JAX package --------------------------


@pytest.mark.parametrize("counts", [(8, 0), (3, 8)])
@pytest.mark.parametrize("windowed", [False, True])
def test_large_streams_reference_matches_jax_streams_kernel(windowed,
                                                            counts):
    """L-S's plain version against the Pallas streams variant
    (``make_fused_psd_fn(..., streams=S)``, K4's form at 32768) in
    interpret mode, to test_torch_parallel's tolerance for that kernel
    (its 3-frame stream has deep nulls where the two float32 error
    budgets add; the float64 golden is held to the same)."""
    N, F, S = 32768, 8, 2
    raw = make_streams(S, F, N, seed=31 + windowed)
    nv = np.array(counts, np.int32)
    w = make_window("hann", N) if windowed else None
    fn = make_fused_psd_fn(N, F, windowed=windowed, streams=S,
                           interpret=True)
    args = (raw.reshape(S * F, 2 * N).view(np.uint16), nv)
    want = np.asarray(fn(*args, *((w,) if windowed else ())))
    raw_t, nv_t, w_t = tensors(raw, nv, w)
    got = fl.fused_psd_large_streams(raw_t, nv_t, 8, w_t).numpy()
    assert got.shape == want.shape == (S, N) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(got, golden_streams(raw, nv, w), rtol=1e-4,
                               atol=1e-2)
    empty = nv == 0
    assert not got[empty].any() and not want[empty].any()


@pytest.mark.parametrize("N,window,path", [
    (20000, None, "plain_mixed_large"),
    (20000, "hann", "plain_mixed_large"),
    (8194, None, "plain_chirp_large"),
    (16382, "hann", "plain_chirp_large"),
])
def test_awkward_streams_match_jax_sharded_step(N, window, path):
    """ML-S's and BL-S's plain versions, through the port's
    ``ShardedPsdStep``, against the JAX ``ShardedPsdStep`` on a two-device
    CPU mesh (XLA's four-step or direct FFT), per stream and combined, and
    the float64 golden; a stream of no valid frame ships an exactly zero
    row on both sides."""
    S, F = 2, 16
    w = None if window is None else make_window(window, N)
    raw = make_streams(S, F, N, seed=N % 1000)
    for nv in (np.array([F, 0], np.int32), np.array([9, F], np.int32)):
        jax_step = JaxShardedPsdStep(jax_make_mesh(2), N, F, streams=S,
                                     window=w)
        want_ps, want_comb = jax_step(
            raw.view(np.uint16) if jax_step.takes_u16 else raw, nv)
        want_ps = np.asarray(want_ps, np.float64)
        step = ShardedPsdStep(make_mesh(CPU), N, F, streams=S, window=w)
        assert step.path == path and step.F == F
        ps, comb = step(raw, nv)
        assert ps.shape == (S, N) and comb.shape == (N,)
        ps, comb = ps.numpy(), comb.numpy()
        gold = golden_streams(raw, nv, w)
        live = nv > 0
        np.testing.assert_allclose(ps[live], want_ps[live], rtol=RTOL)
        np.testing.assert_allclose(ps[live], gold[live], rtol=RTOL)
        np.testing.assert_allclose(comb, np.asarray(want_comb), rtol=RTOL)
        np.testing.assert_allclose(comb, gold.sum(0), rtol=RTOL)
        assert not ps[~live].any() and not want_ps[~live].any()


@pytest.mark.parametrize("name,N", [("L-S", 32768), ("ML-S", 20000),
                                    ("BL-S", 8194)])
def test_streams_reference_is_the_one_stream_reference_per_stream(name, N):
    """Each plain version is the one-stream plain version on each stream's
    own frames and count, bit for bit; a count outside [0, F] acts as its
    nearest bound."""
    _, plain, single = ENTRIES[name]
    S, F = 3, 8
    raw, nv, _ = tensors(make_streams(S, F, N, seed=7), [-2, 5, 11])
    got = plain(raw, nv, 8)
    for s, c in enumerate((0, 5, F)):
        assert torch.equal(got[s], single(raw[s], c, 8))
    assert not got[0].any()


# --- the kernels' grids, transcribed -------------------------------------


def streams_block(x, s, tiles, F, group, G_s, counts):
    """large_streams.cuh's streams_block: (partial row, first frame of the
    batch, frames) of block (x, s) of a (G_s tiles, S) grid."""
    j = x // tiles
    f0 = j * group
    nv = min(max(int(counts[s]), 0), F)
    return s * G_s + j, s * F + f0, max(min(f0 + group, nv) - f0, 0)


def one_stream_block(b, tiles, F, group, n_valid):
    """The one-stream passes' block b: (partial row, first frame,
    frames)."""
    g = b // tiles
    f0 = g * group
    return g, f0, max(min(f0 + group, min(F, n_valid)) - f0, 0)


def rows_sum(rows):
    """A stream's partial rows added as the large kernels add them: one row
    as it is; 2..8 in order in float64 from 0.0 (psd_rows_sum,
    streams_rows_sum); more by psd_sum.cuh's lanes (lane l rows l, l + 8,
    ..., lanes added in order)."""
    if len(rows) == 1:
        return rows[0]
    if len(rows) <= 8:
        t = np.zeros(rows.shape[1])
        for r in rows:
            t += r.astype(np.float64)
        return t.astype(np.float32)
    lanes = [rows[lane::8].astype(np.float64).sum(0) for lane in range(8)]
    t = np.zeros(rows.shape[1])
    for lane in lanes:
        t += lane
    return t.astype(np.float32)


def transcribe(pwr, S, F, counts, group, tiles):
    """A streams entry's summing pass and row sums over (S*F, N) float32
    powers, each block's frames added in f32 in order: (S, N) rows, and
    the frames each block took."""
    G_s = -(-F // group)
    partial = np.zeros((S * G_s, pwr.shape[1]), np.float32)
    taken = []
    for s in range(S):
        for x in range(G_s * tiles):
            rest, first, frames = streams_block(x, s, tiles, F, group, G_s,
                                                counts)
            taken.append((x % tiles, first, frames))
            if x % tiles == 0:
                for f in range(first, first + frames):
                    partial[rest] += pwr[f]
    out = np.stack([rows_sum(partial[s * G_s:(s + 1) * G_s])
                    for s in range(S)])
    return out, taken


def powers(raw, window=None):
    flat = raw.reshape(-1, raw.shape[-1])
    z = ((flat[:, 0::2].astype(np.float64) - 127.0)
         + 1j * (flat[:, 1::2].astype(np.float64) - 127.0))
    if window is not None:
        z = z * np.asarray(window, np.float32).astype(np.float64)
    X = np.fft.fft(z, axis=1)
    return (X.real ** 2 + X.imag ** 2).astype(np.float32)


@pytest.mark.parametrize("S,F,counts,tiles,resident", [
    (4, 8, [8, 0, 1, 7], 256, 264),      # L-S at 2^20: one group a stream
    (4, 16, [16, 0, 1, 15], 8, 264),     # L-S at 32768 pass B: 8 rows
    (2, 64, [64, 37], 16, 396),          # 3 groups, the last the shorter
    (3, 40, [40, 39, 13], 2, 264),       # 40 groups of 1
    (2, 64, [-3, 70], 1, 132),           # counts act as their bounds
])
def test_streams_grid_transcription(S, F, counts, tiles, resident):
    """The streams grid (``large_group`` over the S streams' tiles) and
    streams_block: the grid fits the blocks the card holds (or is one
    group a stream), every valid frame of every stream is taken by one
    block of each tile, no block crosses a stream or takes a frame at or
    above its stream's count; each stream's row equals the one-stream
    passes' on its own frames and count with the same group, bit for bit,
    and the float64 golden."""
    group = fl.large_group(F, S * tiles, resident)
    G_s = -(-F // group)
    assert S * G_s * tiles <= max(resident, S * tiles)
    N = 64
    raw = make_streams(S, F, N, seed=S * F)
    nv = np.asarray(counts, np.int32)
    pwr = powers(raw)
    got, taken = transcribe(pwr, S, F, nv, group, tiles)
    for tile in range(tiles):
        seen = [f for t, first, n in taken if t == tile
                for f in range(first, first + n)]
        want = [s * F + f for s in range(S)
                for f in range(min(max(int(nv[s]), 0), F))]
        assert sorted(seen) == want
    for _, first, n in taken:
        if n:
            assert first // F == (first + n - 1) // F
    for s in range(S):
        c = min(max(int(nv[s]), 0), F)
        partial = np.zeros((G_s, N), np.float32)
        for b in range(G_s * tiles):
            g, f0, n = one_stream_block(b, tiles, F, group, c)
            if b % tiles == 0:
                for f in range(f0, f0 + n):
                    partial[g] += pwr[s * F + f]
        assert np.array_equal(got[s], rows_sum(partial))
    gold = golden_streams(raw, nv)
    np.testing.assert_allclose(got, gold, rtol=RTOL)
    assert not got[np.clip(nv, 0, F) == 0].any()


@pytest.mark.parametrize("S", [1, 4, 16])
@pytest.mark.parametrize("N", [32768, 1 << 20, 1 << 22])
def test_large_streams_grid(N, S):
    """fused_psd_large.streams_grid: at S = 1 the one-stream grid
    (regs_grid), else large_group over S times each pass's tiles."""
    t = fl.regs_layout(N)
    for ra, rb in ((264, 264), (396, 264), (132, 132)):
        ga, gb, rows = fl.streams_grid(S, 8, N, ra, rb)
        assert (ga, gb) == (fl.large_group(8, S * t["tiles_a"], ra),
                            fl.large_group(8, S * t["tiles_b"], rb))
        assert rows == -(-8 // gb)
        if S == 1:
            assert (ga, gb, rows) == fl.regs_grid(8, N, ra, rb)


def test_awkward_streams_grids(monkeypatch):
    """ML's and BL's streams grids: large_group over S times each pass's
    tiles; at S = 1 the one-stream grids."""
    monkeypatch.setattr(fml, "resident_blocks",
                        lambda N, which, index: 264 + 132 * (which == 0))
    for N in (20000, 100000, 10 ** 6):
        tiles_a, tiles_b = fml.ml_layout(N).tiles
        for S in (1, 2, 4):
            ga, gb, rows = fml.streams_grid(S, 64, N, False, 0)
            assert ga == fl.large_group(64, S * tiles_a, 396)
            assert gb == fl.large_group(64, S * tiles_b, 264)
            assert rows == -(-64 // gb)
    for N in (8194, 99998, 1 << 21):
        tiles = fbl.chirp_regs_layout(N).tiles
        res = (132, 264, 132)
        assert fbl.streams_grid(1, 64, N, res) == fbl.regs_grid(64, N, res)
        assert fbl.streams_grid(4, 64, N, res) == tuple(
            fl.large_group(64, 4 * t, r) for t, r in zip(tiles, res))


# --- routes and refusals -------------------------------------------------


@pytest.mark.parametrize("N,backend,path", [
    (64, "auto", "plain"), (16384, "auto", "plain"),
    (32768, "auto", "plain_large"), (1 << 20, "auto", "plain_large"),
    (1 << 22, "pallas", "plain_large"),
    (500, "auto", "plain_mixed"), (998, "auto", "plain_bluestein"),
    (16464, "auto", "plain_mixed_large"), (20000, "auto", "plain_mixed_large"),
    (16386, "auto", "plain_chirp_large"),
    (4167450, "auto", "plain_mixed_large"),
    (8194, "auto", "plain_chirp_large"), (99998, "auto", "plain_chirp_large"),
    (2097150, "auto", "plain_chirp_large"),
    (20000, "bluestein", "plain_chirp_large"),
    (4194302, "auto", None), (1 << 23, "auto", None),
    (2097154, "auto", None), (4194300, "auto", None),
    (1 << 22, "bluestein", None), (32768, "xla", None),
])
def test_streams_routes_by_n(N, backend, path):
    """ShardedPsdStep takes every N the one-stream step takes at default
    precision, by transform_route: powers of two and even 7-smooth N to
    2^22, other even N to 2^21; the rest exits 3."""
    if path is None:
        with pytest.raises(RPFexception, match="Not yet ported") as e:
            ShardedPsdStep(make_mesh(CPU), N, 8, streams=2, backend=backend)
        assert e.value.return_value == ReturnValue.InvalidArgument
        return
    step = ShardedPsdStep(make_mesh(CPU), N, 8, streams=2, backend=backend)
    assert step.path == path
    route = spectral.transform_route(N, backend)
    assert sharded.STREAMS_ROUTES[route][1] == spectral.ROUTES[route][1]


def test_streams_routes_cover_every_default_route():
    assert set(sharded.STREAMS_ROUTES) == set(spectral.ROUTES) - {"fast"}
    for route, (kernel, suffix) in sharded.STREAMS_ROUTES.items():
        assert suffix == spectral.ROUTES[route][1]
        assert kernel.__name__.endswith("_streams")


@pytest.mark.parametrize("name,N", [("L-S", 20000), ("ML-S", 32768),
                                    ("BL-S", 1 << 22)])
def test_streams_entries_reject_what_their_kernel_does_not_take(name, N):
    entry = ENTRIES[name][0]
    raw = torch.zeros((2, 8, 2 * N), dtype=torch.uint8)
    with pytest.raises(ValueError, match="does not take"):
        entry(raw, torch.tensor([8, 8], dtype=torch.int32), 8)


@pytest.mark.parametrize("name,N", [("L-S", 32768), ("ML-S", 20000),
                                    ("BL-S", 8194)])
def test_streams_entries_reject_bad_counts(name, N):
    entry = ENTRIES[name][0]
    raw = torch.zeros((2, 8, 2 * N), dtype=torch.uint8)
    for nv in (torch.tensor([8, 8], dtype=torch.int64),
               torch.tensor([8, 8, 8], dtype=torch.int32)):
        with pytest.raises(ValueError, match="n_valid"):
            entry(raw, nv, 8)


def test_streams_calls_on_cpu_count_as_plain():
    counts = fp.COUNTS
    counts.reset()
    for name, N in (("L-S", 32768), ("ML-S", 20000), ("BL-S", 8194)):
        raw = torch.zeros((2, 8, 2 * N), dtype=torch.uint8)
        nv = torch.tensor([8, 3], dtype=torch.int32)
        ENTRIES[name][0](raw, nv, 8)
        ENTRIES[name][0](raw, nv, 8, torch.ones(N))
    assert counts.plain == 6
    assert (counts.kernel_large_streams, counts.kernel_large_streams_windowed,
            counts.kernel_mixed_large_streams,
            counts.kernel_mixed_large_streams_windowed,
            counts.kernel_chirp_large_streams,
            counts.kernel_chirp_large_streams_windowed) == (0,) * 6


# --- sessions against the JAX package's ----------------------------------


@pytest.mark.parametrize("extra", [
    ["-b", "20000"],
    ["-b", "32768"],
    ["-b", "16382", "--window-function", "hann"],
])
def test_large_streams_session_matches_jax_session(extra):
    """--streams 2 above 16384 bins (ML-S, L-S, BL-S windowed) writes the
    JAX session's bytes, to the linear tolerance of the streams
    scenarios."""
    argv = (["-f", "100M", "-n", "16", "--streams", "2",
             "--frames-per-step", "16",
             "--source", "synthetic:tone=100.1M/30,noise=5,seed=3"] + extra)
    res_j, out_j, err_j = outcome(argv, port=False)
    res_p, out_p, err_p = outcome(argv, port=True)
    assert res_p == res_j
    assert not isinstance(res_p, tuple)
    N = int(extra[1])
    assert assert_text_outputs_match(out_j, out_p, rtol=LINEAR_RTOL) == N
    assert err_p == err_j
    assert "Parallel streams: 2 (mesh size M)" in err_p


#: The paths chip_smoke.py's drive() expects of each streams kernel key.
DRIVE_PATHS = {"L-S": "plain_large", "L-S windowed": "plain_large",
               "ML-S": "plain_mixed_large", "BL-S windowed": "plain_chirp_large"}


@pytest.mark.parametrize("drive", [d for d in CHIP_SMOKE.LARGE_STREAMS_DRIVES
                                   if d[2] < 1 << 20],
                         ids=lambda d: d[0])
def test_chip_smoke_streams_drives_run_their_streams_entries(drive):
    """chip_smoke.py phase 17's smaller drives run on the CPU through their
    streams entries' plain versions over the streams they name (the
    config 3 drive over four streams is held to its argv's bins and
    streams below, not run: its plain version at 2^20 takes gigabytes)."""
    label, key, N, streams, repeats, wname, argv = drive
    rv, out, err = run(argv, port=True)
    assert rv == 0
    assert f"Transform path: {DRIVE_PATHS[key]} (backend=auto, N={N})" in err
    assert f"Parallel streams: {streams} (mesh size 1)" in err
    assert f"Actual number of averaged spectra: {streams * repeats}" in err
    assert ("--window-function" in argv) == (wname is not None)


def test_chip_smoke_full_width_drive_is_config3_over_four_streams():
    label, key, N, streams, repeats, wname, argv = \
        CHIP_SMOKE.LARGE_STREAMS_DRIVES[0]
    assert (key, N, streams, wname) == ("L-S", 1 << 20, 4, None)
    assert argv[argv.index("-b") + 1] == str(N)
    assert argv[argv.index("--streams") + 1] == "4"
    assert argv[argv.index("-t") + 1] == str(CHIP_SMOKE.C3_SECONDS)
    assert repeats == -(-CHIP_SMOKE.RATE * CHIP_SMOKE.C3_SECONDS // N) == 20
    assert spectral.transform_route(N) == "large"


# --- the frame-sharded long integration -----------------------------------


@pytest.mark.parametrize("window", [None, "hann"])
def test_sharded_accumulate_matches_jax(window):
    """parallel/longint.py's sharded_accumulate on the port's one device
    against the JAX package's on its 8-device CPU mesh at 32768 bins (the
    large kernel's streams entry at S = 1 on a card), and the float64
    golden; the step cache keys on the window's bytes."""
    N, M = 32768, 13
    w = None if window is None else make_window(window, N)
    stream = np.random.default_rng(55).integers(0, 256, 2 * N * M,
                                                dtype=np.uint8)
    frames = stream.reshape(M, 2 * N)
    pwr, m = sharded_accumulate(frames, N, w, devices=[CPU])
    want, m_j = jax_sharded_accumulate(frames, N, w)
    assert m == m_j == M and pwr.dtype == np.float64 and pwr.shape == (N,)
    np.testing.assert_allclose(pwr, want, rtol=RTOL)
    if w is None:
        gold, _ = golden_accumulate(stream, N, M)
        np.testing.assert_allclose(pwr, np.fft.ifftshift(gold), rtol=RTOL)
    else:
        gold = golden_streams(frames[None], [M], w)[0]
        np.testing.assert_allclose(pwr, gold, rtol=RTOL)


def test_sharded_accumulate_step_cache():
    from rtl_power_fftw_tpu_torch.parallel import longint
    N = 32768
    frames = np.full((3, 2 * N), 127, np.uint8)
    sharded_accumulate(frames, N, devices=[CPU])
    first = next(iter(longint._step_cache.values()))
    sharded_accumulate(frames, N, devices=[CPU])
    assert next(iter(longint._step_cache.values())) is first
    sharded_accumulate(frames, N, make_window("hann", N), devices=[CPU])
    assert len(longint._step_cache) == 1
    assert next(iter(longint._step_cache.values())) is not first
    assert first.path == "plain_large"
    with pytest.raises(ValueError, match="no frames"):
        sharded_accumulate(frames[:0], N, devices=[CPU])


# --- on the card ----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name,N", [("L-S", 32768), ("ML-S", 20000),
                                    ("BL-S", 16382)])
def test_streams_entries_match_plain_on_card(name, N):
    """Runs only where a CUDA device is present (chip_smoke.py phase 17
    covers it in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    entry, plain, _ = ENTRIES[name]
    S, F = 4, 16
    raw = torch.from_numpy(make_streams(S, F, N, seed=11)).cuda()
    nv = torch.tensor([F, 0, 1, F - 1], dtype=torch.int32).cuda()
    got = entry(raw, nv, 16)
    want = plain(raw, nv, 16)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got[[0, 3]].cpu().numpy(),
                               want[[0, 3]].cpu().numpy(), rtol=1e-5)
    assert not got[1].any()
