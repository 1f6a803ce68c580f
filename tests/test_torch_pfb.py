"""The polyphase filterbank of the PyTorch package against the JAX
package's (``--pfb-taps``, ``pfb_psd``), on the CPU, where the port's step
is the kernel's plain PyTorch version.

Twins of tests/test_pfb.py and tests/test_pfb_session.py:27-104 at N = 64,
128 and 256: the prototype, the step against float64 and the JAX step,
history across steps and its reset, the Datastore across a retune, the
CLI's checks, whole sessions (text, ``.met``) against the JAX session, and
the library function. The kernel (csrc/fused_psd_pfb.cu) runs only on a
card; its virtual-row map over history and slot and its history update
(n_valid < P - 1 included) are transcribed in numpy here.
"""

import io
from pathlib import Path

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu.models import pfb as jax_pfb
from rtl_power_fftw_tpu_torch.config import parse_args
from rtl_power_fftw_tpu_torch.exceptions import RPFexception
from rtl_power_fftw_tpu_torch.models import bartlett_psd, pfb
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
from rtl_power_fftw_tpu_torch.pipeline.datastore import Datastore
from rtl_power_fftw_tpu_torch.probes import estimator_builds

from test_torch_session import assert_text_outputs_match, mask_stderr, run

CPU = torch.device("cpu")
RATE = 2_048_000
CSRC = (Path(__file__).resolve().parents[1]
        / "rtl_power_fftw_tpu_torch/ops/kernels/csrc")


def direct_pfb(raw, N, P, window="hann"):
    """float64 session-semantics PFB: zero prehistory (u8 127), one output
    per input frame."""
    h = pfb.pfb_prototype(N, P, window).astype(np.float64).reshape(P, N)
    z = ((raw[:, 0::2].astype(np.float64) - 127.0)
         + 1j * (raw[:, 1::2].astype(np.float64) - 127.0))
    zpad = np.vstack([np.zeros((P - 1, N), dtype=np.complex128), z])
    pwr = np.zeros(N)
    for j in range(len(z)):
        s = sum(zpad[j + p] * h[p] for p in range(P))
        pwr += np.abs(np.fft.fft(s)) ** 2
    return pwr


def capture(n_complex, seed=0, tone=None, amp=30.0, noise=4.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n_complex)
    x = rng.standard_normal(n_complex) * noise + 1j * (
        rng.standard_normal(n_complex) * noise)
    if tone is not None:
        x = x + amp * np.exp(2j * np.pi * tone * t)
    re = np.clip(np.round(x.real + 127), 0, 255).astype(np.uint8)
    im = np.clip(np.round(x.imag + 127), 0, 255).astype(np.uint8)
    return np.stack([re, im], axis=-1).ravel()


def frames(F, N, seed):
    return np.random.default_rng(seed).integers(0, 256, (F, 2 * N),
                                                dtype=np.uint8)


@pytest.mark.parametrize("M,taps,window", [(64, 4, "hann"), (256, 2, "hann"),
                                           (128, 16, "blackman"),
                                           (64, 1, "boxcar")])
def test_prototype_is_the_jax_packages(M, taps, window):
    np.testing.assert_array_equal(pfb.pfb_prototype(M, taps, window),
                                  jax_pfb.pfb_prototype(M, taps, window))


@pytest.mark.parametrize("N,P", [(128, 4), (64, 2), (256, 16)])
def test_pfb_step_matches_direct_and_jax(N, P):
    """tests/test_pfb_session.py:27: uneven chunks and a padded partial
    batch, as the Datastore stages them."""
    F = 8
    step = pfb.PfbSessionStep(N, F, taps=P, device=CPU)
    jstep = jax_pfb.PfbSessionStep(N, F, taps=P)
    assert step.path == "plain_pfb" and not step.takes_u16
    raw = frames(3 * F + 5, N, 11)
    got = np.zeros(N)
    jax_got = np.zeros(N)
    for lo in range(0, len(raw), F):
        batch = raw[lo:lo + F]
        padded = np.zeros((F, 2 * N), np.uint8)
        padded[:len(batch)] = batch
        got += step(padded, len(batch)).numpy()
        jax_got += np.asarray(jstep(padded, len(batch)), np.float64)
    np.testing.assert_allclose(got, direct_pfb(raw, N, P), rtol=1e-5)
    np.testing.assert_allclose(got, jax_got, rtol=2e-5)


def test_pfb_step_history_with_few_valid_frames_matches_jax():
    """Steps of fewer valid frames than P - 1 keep the old history's last
    rows (pfb.py:251-259), and a step of none keeps it whole."""
    N, P, F = 64, 8, 8
    step = pfb.PfbSessionStep(N, F, taps=P, device=CPU)
    jstep = jax_pfb.PfbSessionStep(N, F, taps=P)
    raw = frames(40, N, 5)
    pos = 0
    for nv in (3, 0, 8, 1, 5, 2, 8):
        padded = np.zeros((F, 2 * N), np.uint8)
        padded[:nv] = raw[pos:pos + nv]
        pos += nv
        got = step(padded, nv).numpy()
        want = np.asarray(jstep(padded, nv), np.float64)
        # A step of a few frames: its smallest bins are single periodogram
        # values near 0, so the error is also held to its mean power.
        np.testing.assert_allclose(got, want, rtol=2e-5,
                                   atol=1e-5 * want.mean())
        np.testing.assert_array_equal(step._run._history[0].numpy(),
                                      jstep._tail)


def test_pfb_session_reset_clears_history():
    N, P, F = 64, 3, 8
    step = pfb.PfbSessionStep(N, F, taps=P, device=CPU)
    raw = frames(F, N, 3)
    first = step(raw, F).numpy().astype(np.float64)
    step.reset()
    again = step(raw, F).numpy().astype(np.float64)
    np.testing.assert_array_equal(first, again)
    third = step(raw, F).numpy().astype(np.float64)
    assert not np.allclose(again, third, rtol=1e-6)


def test_datastore_pfb_end_to_end_and_retune_isolation():
    params = parse_args(["-f", "100M", "-n", "24", "-b", "128",
                         "--pfb-taps", "4", "--frames-per-step", "8",
                         "--source", "synthetic:noise=5,seed=9"],
                        stderr=io.StringIO())
    data = Datastore(params, CPU)
    assert data.transform_path == "plain_pfb"
    raw = np.random.default_rng(21).integers(0, 256, size=(24 * 2 * 128,),
                                             dtype=np.uint8)

    def run_acq():
        data.begin_acquisition()
        data.acquire_slot()
        data.push_buffer(raw)
        return data.finish_acquisition()

    r1 = run_acq()
    r2 = run_acq()  # the same bytes after a "retune": no history leaks
    assert r1.repeats_done == r2.repeats_done == 24
    assert r1.pwr2 is r1.pwr_clean is r1.kept is None
    np.testing.assert_array_equal(r1.pwr, r2.pwr)
    np.testing.assert_allclose(r1.pwr, direct_pfb(raw.reshape(24, 256), 128,
                                                  4), rtol=1e-5)


def test_pfb_cli_validation():
    """tests/test_pfb_session.py:85 on the port's parser."""
    with pytest.raises(RPFexception):
        parse_args(["-f", "100M", "--pfb-taps", "1"])
    with pytest.raises(RPFexception):
        parse_args(["-f", "100M", "--pfb-taps", "4", "--welch-overlap", "50"])
    p = parse_args(["-f", "100M", "--pfb-taps", "4", "--streams", "4"])
    assert p.pfb_taps == 4 and p.streams == 4
    with pytest.raises(RPFexception):
        parse_args(["-f", "100M", "-n", "1024", "--pfb-taps", "4",
                    "--streams", "4", "--shard-transform"])
    with pytest.raises(RPFexception):
        parse_args(["-f", "100M", "--pfb-taps", "4", "-w", "win.txt"])
    p = parse_args(["-f", "100M", "--pfb-taps", "4",
                    "--window-function", "blackman"])
    assert p.pfb_taps == 4 and p.window_function == "blackman"


@pytest.mark.parametrize("N", [4194306, 20001, 4194302])
def test_pfb_step_refuses_sizes_its_kernel_does_not_take(N):
    with pytest.raises(RPFexception,
                       match=f"Not yet ported.*--pfb-taps at {N} bins"):
        pfb.PfbSessionStep(N, 8, taps=4, device=CPU)
    with pytest.raises(ValueError, match="taps"):
        pfb.PfbSessionStep(64, 8, taps=1, device=CPU)


@pytest.mark.parametrize("extra", [["--pfb-taps", "4"],
                                   ["--pfb-taps", "2",
                                    "--window-function", "blackman", "-l"],
                                   ["--pfb-taps", "16", "--frames-per-step",
                                    "8"]])
def test_pfb_session_matches_jax_session(extra):
    argv = ["-f", "100M", "-n", "32", "-b", "256",
            "--source", "synthetic:tone=100.2M/35,noise=6,seed=1"] + extra
    rv_j, out_j, err_j = run(argv, port=False)
    rv_p, out_p, err_p = run(argv, port=True)
    assert int(rv_j) == int(rv_p) == 0
    assert assert_text_outputs_match(out_j, out_p, linear="-l" in extra) \
        == 256
    assert mask_stderr(err_j) == mask_stderr(err_p)
    assert "Transform path: plain_pfb (N=256)" in err_p
    rows = [x.split() for x in out_p.splitlines()
            if x.strip() and not x.startswith("#")]
    freqs = np.array([float(r[0]) for r in rows])
    vals = np.array([float(r[1]) for r in rows])
    assert abs(freqs[np.argmax(vals)] - 100.2e6) < 2 * RATE / 256


def test_pfb_two_hop_matrix_scan_matches_jax(tmp_path):
    """Each hop starts from a reset history: the .bin rows and .met are
    the JAX session's."""
    argv = ["-f", "100M:104M", "-n", "24", "-b", "128", "-q",
            "--pfb-taps", "4", "--frames-per-step", "8",
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
    assert mets[0] == mets[1] and mets[1][0].startswith("256 ")
    np.testing.assert_allclose(10.0 ** (bins[1] / 10.0),
                               10.0 ** (bins[0] / 10.0), rtol=1e-5)


# --- the library function (tests/test_pfb.py) ---

def test_one_tap_boxcar_prototype_is_bartlett():
    M = 256
    iq = capture(64 * M, seed=1, tone=0.1337)
    f1, p1 = pfb.pfb_psd(iq, M, RATE, taps=1, prototype=np.ones(M),
                         device=CPU)
    f2, p2 = bartlett_psd(iq, M, RATE, device=CPU)
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_allclose(p1, p2, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("fps", [1024, 16])
def test_pfb_psd_matches_float64_and_jax(fps):
    M, P = 128, 4
    iq = capture(40 * M, seed=2, tone=0.071)
    freqs, psd = pfb.pfb_psd(iq, M, RATE, taps=P, linear=True,
                             frames_per_step=fps, device=CPU)
    jf, jpsd = jax_pfb.pfb_psd(iq, M, RATE, taps=P, linear=True)
    np.testing.assert_array_equal(freqs, jf)
    h = pfb.pfb_prototype(M, P).astype(np.float64).reshape(P, M)
    z = ((iq[0::2].astype(np.float64) - 127.0)
         + 1j * (iq[1::2].astype(np.float64) - 127.0)).reshape(-1, M)
    T = z.shape[0] - P + 1
    pwr = np.zeros(M)
    for t in range(T):
        pwr += np.abs(np.fft.fft(sum(z[t + p] * h[p] for p in range(P)))) ** 2
    s = np.fft.fftshift(pwr)
    s[M // 2] = (s[M // 2 - 1] + s[M // 2 + 1]) / 2.0
    np.testing.assert_allclose(psd, s / T / M / RATE, rtol=1e-5)
    np.testing.assert_allclose(psd, jpsd, rtol=2e-5)


def test_pfb_channel_isolation_beats_plain_fft():
    M = 256
    tone = (31 + 0.5) / M
    iq = capture(128 * M, seed=3, tone=tone, amp=100.0, noise=0.5)
    _, fft_psd = bartlett_psd(iq, M, RATE, linear=True, device=CPU)
    _, psd = pfb.pfb_psd(iq, M, RATE, taps=4, linear=True, device=CPU)

    def leak(p):
        peak = int(np.argmax(p))
        dist = np.minimum(np.abs(np.arange(M) - peak),
                          M - np.abs(np.arange(M) - peak))
        return np.median(p[dist > M // 4]) / p.max()
    assert leak(psd) < leak(fft_psd) / 10


def test_pfb_errors():
    iq = capture(4 * 64)
    with pytest.raises(ValueError, match="not enough samples"):
        pfb.pfb_psd(iq, 64, RATE, taps=8, device=CPU)
    with pytest.raises(ValueError, match="prototype"):
        pfb.pfb_psd(iq, 64, RATE, taps=2, prototype=np.ones(64), device=CPU)
    with pytest.raises(ValueError, match="taps"):
        pfb.pfb_psd(iq, 64, RATE, taps=0, device=CPU)
    with pytest.raises(RPFexception, match="Not yet ported"):
        pfb.pfb_psd(iq, 4194302, RATE, taps=2, device=CPU)


# --- the kernel's index arithmetic, transcribed ---

def virtual_row(r, P):
    """Where row r of the kernel's virtual array lies (psd_pfb_kernel):
    ("history", r) for r < P - 1, else ("slot", r - (P - 1))."""
    return ("history", r) if r < P - 1 else ("slot", r - (P - 1))


def pfb_transcription(slot, history, n_valid, h):
    """The kernel's load stage and history update in numpy: output frame
    f < n_valid reads virtual row f + p for p = 0 .. P-1 from the history
    (rows < P - 1) or the slot, its polyphase sum built in float32 in p
    order from zero; the next history is virtual rows n_valid .. n_valid
    + P - 2 gathered the same way, and the kernel's two copies (the old
    history's rows from n_valid, then the slot's up to n_valid - 1) give
    the same rows. Returns (sums (n_valid, N) complex64, next history)."""
    P, N = h.shape

    def row(r):
        where, i = virtual_row(r, P)
        return (history if where == "history" else slot)[i]

    def dq(u8):
        return (u8[0::2].astype(np.float32) - np.float32(127),
                u8[1::2].astype(np.float32) - np.float32(127))

    sums = np.zeros((n_valid, N), np.complex64)
    for f in range(n_valid):
        sr = np.zeros(N, np.float32)
        si = np.zeros(N, np.float32)
        for p in range(P):
            xr, xi = dq(row(f + p))
            sr = sr + xr * h[p]
            si = si + xi * h[p]
        sums[f] = sr + 1j * si
    nxt = np.stack([row(r) for r in range(n_valid, n_valid + P - 1)]) \
        if P > 1 else np.zeros((0, slot.shape[1]), np.uint8)
    # The kernel's two copies: "kept" rows of the old history from row
    # n_valid, then the rest from the slot, ending at row n_valid - 1.
    kept = max(0, P - 1 - n_valid)
    taken = P - 1 - kept
    copies = np.concatenate([history[n_valid:n_valid + kept],
                             slot[n_valid - taken:n_valid]])
    np.testing.assert_array_equal(nxt, copies)
    return sums, nxt


@pytest.mark.parametrize("P,F,steps", [(4, 8, (8, 8, 8)),
                                       (8, 8, (3, 0, 2, 8, 1)),
                                       (2, 16, (16, 1, 0, 9)),
                                       (32, 8, (8, 5, 8, 8, 8, 8, 1)),
                                       (1, 8, (8, 4))])
def test_pfb_rows_and_history_transcription(P, F, steps):
    """Over consecutive steps (n_valid < P - 1 among them) the
    transcription's polyphase sums are the plain version's bit for bit,
    its history the JAX step's tail (after a reset, byte 127), and the
    plain version's history the same."""
    N = 64
    h = pfb.pfb_prototype(N, P, "hann").reshape(P, N)
    raw = frames(sum(steps), N, 9)
    history = np.full((P - 1, 2 * N), 127, np.uint8)
    jtail = history.copy()
    hist_t = [torch.empty((P - 1, 2 * N), dtype=torch.uint8)
              for _ in range(2)]
    pos = 0
    for i, nv in enumerate(steps):
        slot = np.zeros((F, 2 * N), np.uint8)
        slot[:nv] = raw[pos:pos + nv]
        pos += nv
        sums, history = pfb_transcription(slot, history, nv, h)
        virtual = torch.from_numpy(np.concatenate([
            np.full((P - 1, 2 * N), 127, np.uint8) if i == 0
            else hist_t[0].numpy(), slot]))
        plain = fpf.pfb_sums_reference(virtual, torch.from_numpy(h),
                                       F).numpy()
        np.testing.assert_array_equal(sums, plain[:nv])
        fpf.fused_psd_pfb(torch.from_numpy(slot), hist_t[0], nv, 8,
                          torch.from_numpy(h), hist_t[1], fresh=i == 0)
        hist_t.reverse()
        np.testing.assert_array_equal(hist_t[0].numpy(), history)
        # The JAX session step's own tail update.
        if nv >= P - 1:
            jtail = slot[nv - P + 1:nv] if P > 1 else jtail
        else:
            jtail = np.concatenate([jtail, slot[:nv]])[-(P - 1):]
        np.testing.assert_array_equal(history, jtail)


def test_pfb_wrapper_checks_and_counts_on_the_cpu():
    fp.COUNTS.reset()
    N, P = 64, 4
    raw = torch.from_numpy(frames(8, N, 1))
    h = torch.ones((P, N))
    hist = [torch.zeros((P - 1, 2 * N), dtype=torch.uint8) for _ in range(2)]
    fpf.fused_psd_pfb(raw, hist[0], 8, 8, h, hist[1], fresh=True)
    assert (fp.COUNTS.kernel_pfb, fp.COUNTS.plain) == (0, 1)
    assert (hist[0] == 127).all()
    with pytest.raises(ValueError, match="distinct"):
        fpf.fused_psd_pfb(raw, hist[0], 8, 8, h, hist[0])
    with pytest.raises(ValueError, match="h must be"):
        fpf.fused_psd_pfb(raw, hist[0], 8, 8, torch.ones((33, N)), hist[1])
    with pytest.raises(ValueError, match="history"):
        fpf.fused_psd_pfb(raw, hist[0][:1], 8, 8, h, hist[1])
    fp.COUNTS.reset()


@pytest.mark.cuda
def test_pfb_kernel_on_card():
    """Runs only where a CUDA device is present (chip_smoke.py phase 14
    covers it in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    N, F, P = 2048, 64, 4
    h = torch.from_numpy(pfb.pfb_prototype(N, P).reshape(P, N))
    raw = torch.from_numpy(frames(F, N, 11))
    hist = [torch.empty((P - 1, 2 * N), dtype=torch.uint8) for _ in range(2)]
    dev_hist = [t.cuda() for t in hist]
    got = fpf.fused_psd_pfb(raw.cuda(), dev_hist[0], 50, 64, h.cuda(),
                            dev_hist[1], fresh=True)
    want = fpf.fused_psd_pfb(raw, hist[0], 50, 64, h, hist[1], fresh=True)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5)
    assert torch.equal(dev_hist[1].cpu(), hist[1])


# --- the ring kernel (psd_pfb_ring_kernel), transcribed ---

def ring_transcription(slot, history, n_valid, h, group, lanes):
    """numpy transcription of psd_pfb_ring_kernel's load stage. Block g
    (frames f0 = g * group .. f1 - 1, f1 = min(f0 + group, F, n_valid))
    stages local row q (virtual row f0 + q) into ring slot q mod (2 lanes
    + P - 1): rows [0, lanes + P - 1) before its first iteration, rows
    [lanes (i + 1) + P - 1, lanes (i + 2) + P - 1) at iteration i, each
    only below its frames + P - 1. Lane l's frame f0 + l + lanes i reads
    tap p from slot (lanes i + l + p) mod slots, its sum built in float32
    in p order from zero. Asserts that each slot read holds the row the
    tap needs, staged before the iteration, and that a slot is rewritten
    only when no later iteration reads its row. Returns (sums (n_valid, N)
    complex64, the local rows each block staged, in order)."""
    P, N = h.shape
    F = slot.shape[0]
    slots = 2 * lanes + P - 1

    def virtual(r):
        where, i = virtual_row(r, P)
        return (history if where == "history" else slot)[i]

    sums = np.zeros((n_valid, N), np.complex64)
    staged_by_block = []
    for f0 in range(0, F, group):
        f1 = min(f0 + group, F, n_valid)
        frames = max(f1 - f0, 0)
        rows = frames + P - 1 if frames else 0
        ring = [None] * slots      # (local row, iteration that staged it)
        staged = []

        def stage(lo, hi, it):
            for q in range(lo, min(hi, rows)):
                old = ring[q % slots]
                assert old is None or old[0] < lanes * max(it, 0)
                ring[q % slots] = (q, it)
                staged.append(q)

        stage(0, lanes + P - 1, -1)
        for i in range(-(-frames // lanes)):
            stage(lanes * (i + 1) + P - 1, lanes * (i + 2) + P - 1, i)
            for lane in range(lanes):
                f = f0 + lane + lanes * i
                if f >= f1:
                    continue
                sr = np.zeros(N, np.float32)
                si = np.zeros(N, np.float32)
                s = (lanes * i + lane) % slots
                for p in range(P):
                    q, it = ring[s]
                    assert q == lanes * i + lane + p and it < i
                    u8 = virtual(f0 + q)
                    sr = sr + (u8[0::2].astype(np.float32)
                               - np.float32(127)) * h[p]
                    si = si + (u8[1::2].astype(np.float32)
                               - np.float32(127)) * h[p]
                    s = (s + 1) % slots
                sums[f] = sr + 1j * si
        staged_by_block.append(staged)
    return sums, staged_by_block


@pytest.mark.parametrize("P,N,F,group,n_valid", [
    (1, 64, 64, 8, 64), (2, 64, 40, 8, 37), (4, 2048, 16, 4, 16),
    (4, 2048, 16, 4, 2), (4, 4096, 8, 2, 7), (32, 256, 64, 16, 64),
    (32, 256, 64, 16, 5), (2, 2048, 8, 8, 0), (32, 64, 96, 32, 90)])
def test_pfb_ring_transcription(P, N, F, group, n_valid):
    """The ring's rows (each staged once a block, read from the slot the
    kernel computes, never overwritten while needed) give
    pfb_transcription's polyphase sums bit for bit, history rows for
    virtual rows < P - 1 (n_valid < P - 1 included)."""
    h = pfb.pfb_prototype(N, P, "hann").reshape(P, N)
    rng = np.random.default_rng(P * 1000 + n_valid)
    slot = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
    history = rng.integers(0, 256, (P - 1, 2 * N), dtype=np.uint8)
    lanes = fp.regs_shape(N).lanes
    sums, staged = ring_transcription(slot, history, n_valid, h, group,
                                      lanes)
    want, _ = pfb_transcription(slot, history, n_valid, h)
    np.testing.assert_array_equal(sums, want)
    for g, rows in enumerate(staged):
        frames = max(min(g * group + group, F, n_valid) - g * group, 0)
        assert rows == list(range(frames + P - 1 if frames else 0))


@pytest.mark.parametrize("N", sorted(fp.PASS_PLAN))
def test_pfb_ring_route_rule(N):
    """ring_shape, a rule on (N, P) alone, at every P: the ring (2 LANES +
    P - 1 slots of 2N + 32 bytes beside the exchange buffers) within the
    227 KB of a block, else the control; the prototype staged exactly
    where it fits and still leaves 2 blocks an SM by shared memory; the
    blocks it claims those of the shared memory it takes."""
    shape = fp.regs_shape(N)
    for P in range(1, fpf.MAX_TAPS + 1):
        ring = shape.exchange + (2 * shape.lanes + P - 1) * (2 * N + 32)
        got = fpf.ring_shape(N, P)
        if ring > fp.SMEM_PER_BLOCK:
            assert got is None
            continue
        assert got.slots == 2 * shape.lanes + P - 1
        with_h = ring + 4 * P * N
        two = 2 * (with_h + fp.SMEM_RESERVED) <= fp.SMEM_PER_SM
        assert got.stage_h == (two and 2 * shape.threads <= 2048)
        assert got.smem == (with_h if got.stage_h else ring)
        assert got.smem <= fp.SMEM_PER_BLOCK
        assert got.blocks_per_sm == min(
            2048 // shape.threads,
            fp.SMEM_PER_SM // (got.smem + fp.SMEM_RESERVED))
        assert got.blocks_per_sm >= (2 if got.stage_h else 1)


def test_pfb_ring_route_at_the_drives_shapes():
    """The route at the shapes the card runs: 2048 bins, 4 taps (the
    drives'): the ring with h staged in 96,480 B, 2 blocks an SM; 4096:
    the ring, h through L2, 3 blocks; 16384 at P >= 2: the control (the
    exchange buffer alone is 139,264 B); 16384 at P = 1: the ring."""
    assert fpf.ring_shape(2048, 4) == fpf.RingShape(7, True, 96480, 2)
    assert fpf.ring_shape(4096, 4) == fpf.RingShape(5, False, 75936, 3)
    assert fp.regs_shape(16384).exchange == 139264
    assert all(fpf.ring_shape(16384, P) is None for P in range(2, 33))
    assert fpf.ring_shape(16384, 1) == fpf.RingShape(2, False, 204864, 1)
    # K1's own shared memory, as the card reports it (51,264 B at 2048).
    assert fp.regs_shape(2048).smem == 51264


@pytest.mark.parametrize("N", [64, 128, 256, 512, 2048])
def test_pfb_ring_row_reads_bank_model(N):
    """The u16 reads of a warp's lanes from their ring slots (2N + 32
    bytes apart, N <= 256 several lanes a warp): threads on one 4-byte
    word share it, and no two words of one read share a bank while the
    lanes' slots run in order; at the ring's wrap at most 2 do."""
    shape = fp.regs_shape(N)
    TF, R = shape.TF, shape.R
    for P in (1, 2, 4, 32):
        slots = 2 * shape.lanes + P - 1
        for i in range(3):
            for p in range(P):
                for warp in range(shape.threads // 32):
                    tid = np.arange(32) + 32 * warp
                    lane, t = tid // TF, tid % TF
                    slot = (shape.lanes * i + lane + p) % slots
                    wrap = np.any(np.diff(slot) < 0)
                    for k in range(R):
                        word = (slot * (2 * N + 32) + 2 * (t + k * TF)) // 4
                        words = np.unique(word)
                        ways = np.bincount(words % 32).max()
                        assert ways <= (2 if wrap else 1)


def test_pfb_control_wrapper_checks_and_counts_on_the_cpu():
    """fused_psd_pfb_control takes the plain version on the CPU, as the
    routed wrapper does, and counts no kernel."""
    fp.COUNTS.reset()
    N, P = 64, 4
    raw = torch.from_numpy(frames(8, N, 1))
    h = torch.from_numpy(pfb.pfb_prototype(N, P).reshape(P, N))
    hist = [torch.zeros((P - 1, 2 * N), dtype=torch.uint8) for _ in range(4)]
    a = fpf.fused_psd_pfb(raw, hist[0], 8, 8, h, hist[1], fresh=True)
    b = fpf.fused_psd_pfb_control(raw, hist[2], 8, 8, h, hist[3], fresh=True,
                                  group=2)
    assert torch.equal(a, b) and torch.equal(hist[1], hist[3])
    assert (fp.COUNTS.kernel_pfb, fp.COUNTS.kernel_pfb_ring,
            fp.COUNTS.plain) == (0, 0, 2)
    fp.COUNTS.reset()


@pytest.mark.parametrize("build", sorted(estimator_builds.BUILDS))
def test_estimator_builds_edit_the_shipped_sources(build):
    """Each build of probes/estimator_builds.py edits the shipped source it
    names exactly where it says (each replaced text found once outside the
    source's streams forms, which stay as they are), and changes it."""
    name, edits, _ = estimator_builds.BUILDS[build]
    text = (CSRC / name).read_text()
    got = estimator_builds.edit(text, build)
    assert got != text
    head, forms, tail = estimator_builds.unfenced(text)
    assert forms in got
    for old, new in edits:
        assert (head + tail).count(old) == 1 and new in got


def test_estimator_builds_probe_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert estimator_builds.main([]) == 1
