"""The multitaper estimator of the PyTorch package against the JAX
package's (``--multitaper``, ``--time-bandwidth``, ``multitaper_psd``), on
the CPU, where the port's step is the kernel's plain PyTorch version.

Twins of tests/test_multitaper_session.py:29, 62, 92 and 153 and of
tests/test_models.py's multitaper case, at N = 64 and 256: the step
against float64 and the JAX step, the CLI's checks, whole sessions
against the JAX session, the library function. The kernels
(csrc/fused_psd_tapers.cu) run only on a card; the control's grid (g, k)
-> partial-row map and the batch kernel's frames, ring slots, taper loop
and rows are transcribed in numpy here, with the route's rule.
"""

import io
from pathlib import Path

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
REPO = Path(__file__).resolve().parents[1]


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


@pytest.mark.parametrize("N", [4194306, 20001, 4194302])
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


# --- the batch kernel (psd_tapers_batch_kernel), transcribed ---

CSRC = REPO / "rtl_power_fftw_tpu_torch/ops/kernels/csrc"
H100_SMS = 132


def batch_transcription(raw, n_valid, tapers, group, per_block, C):
    """psd_tapers_batch_kernel's index arithmetic in float64. Block (g, s),
    g < G = max(1, ceil(n_valid / group)), takes frames [f0, f1), f0 = g *
    group, f1 = min(f0 + group, F, n_valid), and tapers [s * per_block,
    min((s + 1) * per_block, K));
    lane p frame i = b * C + c (frame f0 + p + LANES * i) goes into ring
    slot (b & 1) * C + c of its lane, staged for batch 0 before the loop
    and for batch b + 1 at the top of batch b. Each batch runs the block's
    tapers k over its frames c (lane 0's count), a barrier before each
    transform but the batch's first (the top barrier serves it) and one a
    pass after the first in the transform. Asserts that each slot read
    holds the frame the lane needs, issued before its batch's top
    barrier, and that a slot is rewritten only after a barrier that
    follows every read of its frame; that every (frame, taper) with frame
    < n_valid is taken once and no later frame. The block's one partial
    row, s * G + g, is its lanes' float64 sums added in order; est_sum's
    lane l of 8 takes rows l, l + 8, ...; the total is divided by K.
    Returns the total and the partial rows."""
    F, N = raw.shape[0], raw.shape[1] // 2
    K = tapers.shape[0]
    lanes = fp.regs_shape(N).lanes
    passes = len(fp.PASS_PLAN[N])
    G, S = max(1, -(-n_valid // group)), -(-K // per_block)
    z = ((raw[:, 0::2].astype(np.float64) - 127.0)
         + 1j * (raw[:, 1::2].astype(np.float64) - 127.0))
    t64 = tapers.astype(np.float64)
    taken = np.zeros((F, K), int)
    partial = np.full((S * G, N), np.nan)
    for s, g in np.ndindex(S, G):
        f0 = g * group
        f1 = min(f0 + group, F, n_valid)
        ks = range(s * per_block, min((s + 1) * per_block, K))
        iters = -(-max(f1 - f0, 0) // lanes)
        batches = -(-iters // C)
        ring = [[None] * (2 * C) for _ in range(lanes)]
        barriers = 0

        def stage(b):
            if b >= batches:
                return
            for lane in range(lanes):
                for c in range(C):
                    f = f0 + lane + lanes * (b * C + c)
                    if f < f1:
                        old = ring[lane][(b & 1) * C + c]
                        assert old is None or old["read"] < barriers
                        ring[lane][(b & 1) * C + c] = {
                            "frame": f, "batch": b, "issued": barriers,
                            "read": -1}

        acc = np.zeros((lanes, N))
        stage(0)
        for b in range(batches):
            stage(b + 1)
            barriers += 1
            top = barriers
            for k in ks:
                for c in range(min(C, iters - b * C)):
                    for lane in range(lanes):
                        f = f0 + lane + lanes * (b * C + c)
                        if f >= f1:
                            continue
                        slot = ring[lane][(b & 1) * C + c]
                        assert (slot["frame"], slot["batch"]) == (f, b)
                        assert slot["issued"] < top
                        slot["read"] = barriers
                        acc[lane] += np.abs(np.fft.fft(z[f] * t64[k])) ** 2
                        taken[f, k] += 1
                    barriers += (1 if k > ks[0] or c else 0) + passes - 1
        row = acc[0].copy()
        for lane in range(1, lanes):
            row += acc[lane]
        partial[s * G + g] = row
    assert (taken[:n_valid] == 1).all() and (taken[n_valid:] == 0).all()
    total = sum(partial[lane::8].sum(0) for lane in range(8))
    return total / K, partial


def mt_core_xla(raw, n_valid, chunk, tapers):
    """The JAX package's _mt_core in its "xla" mode (the platform FFT over
    the (F K, N) tapered batch) on the same bytes."""
    import jax.numpy as jnp
    F, N = raw.shape[0], raw.shape[1] // 2
    re = raw[:, 0::2].astype(np.float32) - np.float32(127)
    im = raw[:, 1::2].astype(np.float32) - np.float32(127)
    fmask = (np.arange(F) < n_valid).astype(np.float32)
    return np.asarray(jax_mt._mt_core(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(fmask),
        jnp.asarray(tapers), N=N, F=F, K=tapers.shape[0], chunk=chunk,
        mode="xla"), np.float64)


def seeded_tapers(N, K):
    """(K, N) float32 session tapers: K DPSS rows where NW allows them,
    repeated up to K rows."""
    NW = 2.0 if N <= 64 else 4.0
    t = multitaper._session_tapers(N, NW, min(K, int(2 * NW) - 1))
    return np.resize(t, (K, N)).astype(np.float32)


@pytest.mark.parametrize("N,F,n_valid,K,group,per_block,C", [
    (64, 512, 300, 7, 64, 7, 2), (64, 8, 5, 32, 32, 5, 2),
    (512, 512, 300, 1, 64, 1, 2), (256, 256, 200, 32, 48, 32, 1),
    (2048, 64, 50, 4, 12, 3, 4), (2048, 400, 400, 7, 2, 7, 2),
    (4096, 32, 29, 7, 6, 2, 2), (2048, 64, 0, 7, 16, 7, 2)])
def test_batch_transcription(N, F, n_valid, K, group, per_block, C):
    """The batch kernel's frames, ring slots, taper ranges and loop and
    one partial row a block, in float64: every (frame, taper) pair of the
    valid frames once, the ring's slots read and rewritten in order,
    within 1e-5 of the plain version and of the JAX package's _mt_core on
    the same seeded bytes."""
    chunk = adapt_batch(F)[1]
    tp = seeded_tapers(N, K)
    raw = frames(F, N, 100 + K)
    got, partial = batch_transcription(raw, n_valid, tp, group, per_block,
                                       C)
    assert not np.isnan(partial).any()
    if n_valid == 0:
        assert not got.any()
        return
    plain = fmt.fused_psd_tapers_reference(
        torch.from_numpy(raw), n_valid, chunk, torch.from_numpy(tp)).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5)
    np.testing.assert_allclose(got, mt_core_xla(raw, n_valid, chunk, tp),
                               rtol=1e-5)


@pytest.mark.parametrize("N", sorted(fp.PASS_PLAN))
def test_batch_shape_rule(N):
    """batch_shape, a rule on (N, K) alone, at every K: the batch kernel
    where 3 <= K <= 16, 1024 <= N <= 4096 and K N <= 32768, its ring of 2
    BATCH_FRAMES slots a lane beside the exchange buffers within the 227
    KB of a block, the blocks an SM it claims those of the threads and
    shared memory it takes; else the control (None)."""
    shape = fp.regs_shape(N)
    C = fmt.BATCH_FRAMES
    smem = shape.exchange + shape.lanes * (4 * C * N + 32)
    for K in range(1, fmt.MAX_TAPERS + 1):
        got = fmt.batch_shape(N, K)
        if not (3 <= K <= 16 and 1024 <= N <= 4096 and K * N <= 32768):
            assert got is None
            continue
        assert got == fmt.BatchShape(C, smem, min(
            2048 // shape.threads,
            fp.SMEM_PER_SM // (smem + fp.SMEM_RESERVED)))
        assert got.smem == fmt.batch_smem(N, C) <= fp.SMEM_PER_BLOCK
        assert got.blocks_per_sm >= 2


@pytest.mark.parametrize("N", [n for n in sorted(fp.PASS_PLAN) if n <= 4096])
@pytest.mark.parametrize("n_valid", [0, 1, 64, 104, 400, 1000, 4096])
def test_batch_grid_rule(N, n_valid):
    """batch_grid at each K: group the same number of frames for each
    lane, the fewest that cover the valid frames in one wave of the
    resident blocks (a block at least); the taper ranges cover the K
    tapers, are as many as that wave has room for, and keep it one
    wave."""
    lanes = fp.regs_shape(N).lanes
    resident = H100_SMS * 2
    for K in (3, 7, 32):
        group, per_block = fmt.batch_grid(n_valid, K, N, resident)
        G, S = max(1, -(-n_valid // group)), -(-K // per_block)
        assert group % lanes == 0 and 1 <= per_block <= K
        assert G <= resident and (group == lanes
                                  or -(-n_valid // (group - lanes))
                                  > resident)
        assert G * S <= resident
        assert S == -(-K // -(-K // min(K, resident // G)))


def test_batch_route_and_grid_at_the_drives_shapes():
    """The route at the shapes the card runs: 2048 bins K=7 (the drive's),
    2 frames a lane a batch in 67,648 B (34,816 of exchange, 2 lanes of 4
    slots of 4,096 B and 32), and 1024 K=16, 4096 K=7; below 1024 and
    above 4096 bins, K <= 2, K > 16 and K N > 32768 the control. The grid
    on an H100 (132 SMs at 2 blocks, 128 registers a thread) is one wave
    and one taper range at F=4096 (16 frames a block, 256 blocks) and at
    the drive's F=400 (2, 200), 12 frames a block with 3000 valid frames;
    at 256 bins F=1024 a lane's frame each (16 frames a block, 64 blocks)
    and 4 taper ranges of 2."""
    assert fmt.batch_shape(2048, 7) == fmt.BatchShape(2, 67648, 3)
    assert all(fmt.batch_shape(N, K) is not None
               for N, K in ((2048, 16), (1024, 16), (4096, 7), (1024, 3)))
    assert all(fmt.batch_shape(2048, K) is None for K in (1, 2, 17, 32))
    assert all(fmt.batch_shape(N, 7) is None for N in (256, 512, 8192,
                                                       16384))
    assert fmt.batch_shape(4096, 16) is None
    resident = H100_SMS * 2
    for n_valid, grid in ((4096, (16, 7)), (400, (2, 7)), (3000, (12, 7))):
        assert fmt.batch_grid(n_valid, 7, 2048, resident) == grid
    assert fmt.batch_grid(1024, 7, 256, resident) == (16, 2)
    # The control's grid at F=4096: 1.7 waves of K2's 264 resident blocks.
    assert fmt.tapers_group(4096, 64, 7, h100_resident(2048, True)) == 64


def test_batch_kernel_constants_match_the_source():
    """The wrapper's ring pad and block limit are the kernel's, and the
    library's three C entries (one stream, S streams, the attributes) go
    through the shared use_device (csrc/device.cuh)."""
    text = (CSRC / "fused_psd_tapers.cu").read_text()
    assert f"constexpr int kRingPad = {fmt.RING_PAD};" in text
    assert f"constexpr int kMaxSmem = {fp.SMEM_PER_BLOCK};" in text
    device = (CSRC / "device.cuh").read_text()
    assert '#include "device.cuh"' in text and "cudaSetDevice" not in text
    assert "cudaSetDevice(device);" in device.split(
        "use_device(int device)")[1]
    assert text.count("cudaError_t e = use_device(device);") == 3


@pytest.mark.parametrize("N", [64, 128, 256, 512, 2048])
def test_batch_ring_reads_bank_model(N):
    """The u16 reads of a warp's lanes from their rings (4 C N + 32 bytes
    apart; several lanes a warp at N <= 256), each lane reading slot
    (b & 1) * C + c of its own: threads on one 4-byte word share it, and
    no two words of one read share a bank."""
    shape = fp.regs_shape(N)
    TF, R = shape.TF, shape.R
    C = fmt.BATCH_FRAMES
    for slot in range(2 * C):
        for warp in range(shape.threads // 32):
            tid = np.arange(32) + 32 * warp
            lane, t = tid // TF, tid % TF
            for r in range(R):
                byte = (lane * (4 * C * N + fmt.RING_PAD) + slot * 2 * N
                        + 2 * (t + r * TF))
                words = np.unique(byte // 4)
                assert np.bincount(words % 32).max() == 1


def test_tapers_wrappers_run_plain_on_the_cpu():
    """fused_psd_tapers and fused_psd_tapers_control take the plain
    version on CPU tensors and count no kernel launch."""
    fp.COUNTS.reset()
    N, K = 256, 7
    raw = torch.from_numpy(frames(16, N, 2))
    tp = torch.from_numpy(seeded_tapers(N, K))
    a = fmt.fused_psd_tapers(raw, 13, 16, tp)
    b = fmt.fused_psd_tapers_control(raw, 13, 16, tp)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), fmt.fused_psd_tapers_reference(
        raw, 13, 16, tp).numpy(), rtol=0)
    assert (fp.COUNTS.kernel_tapers, fp.COUNTS.kernel_tapers_control,
            fp.COUNTS.plain) == (0, 0, 2)
    with pytest.raises(ValueError, match="tapers"):
        fmt.fused_psd_tapers_control(raw, 13, 16, torch.ones((2, 64)))
    fp.COUNTS.reset()
