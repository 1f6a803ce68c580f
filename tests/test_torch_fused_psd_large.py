"""The PyTorch package's large-N step (``fused_psd_large``: K1/K2 from
32768 to 65536 and P15 at 2^20, on to 2^22) against the JAX package and
the float64 golden, and its sessions against the JAX package's.

On the CPU the wrapper runs the kernel's plain PyTorch version (the four
steps in torch ops). The JAX side runs its CPU ladder (the FFT four-step
rung, ``fft4``, above 8192) or, where this file names it, the Pallas
kernel K1/K2 itself in interpret mode (at 32768 and 65536 it takes about
a second here). Tolerances: 1e-5 relative against the float64 golden
(each side's float32 error is ~1e-6 at these sizes), 2e-5 between the
two packages (two float32 budgets add). The CUDA kernel's tile, split and
bin arithmetic is pinned by a numpy transcription of it; the kernel itself
runs only on a card (chip_smoke.py, and the test marked ``cuda``).
"""


import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu.ops.kernels import make_fused_psd_fn
from rtl_power_fftw_tpu.ops.spectral import PsdStep as JaxPsdStep
from rtl_power_fftw_tpu_torch.auxdata import make_window
from rtl_power_fftw_tpu_torch.exceptions import RPFexception
from rtl_power_fftw_tpu_torch.ops import spectral
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_large as fl

from golden import golden_accumulate
from test_torch_session import (TIMESTAMP, assert_text_outputs_match,
                                mask_stderr, outcome, run)

CPU = torch.device("cpu")
GOLDEN_RTOL = 1e-5
CROSS_RTOL = 2e-5


def frames(F, N, seed):
    return np.random.default_rng(seed).integers(0, 256, (F, 2 * N),
                                                dtype=np.uint8)


def golden(raw, n_valid, window=None):
    N = raw.shape[1] // 2
    pwr, _ = golden_accumulate(raw[:n_valid].ravel(), N, n_valid,
                               window=window)
    return np.fft.ifftshift(pwr)


def plain(raw, n_valid, chunk, window=None):
    w = None if window is None else torch.from_numpy(window)
    return fl.fused_psd_large(torch.from_numpy(raw), n_valid, chunk,
                              w).numpy()


@pytest.mark.parametrize("N,n_valid,window", [
    (32768, 8, None), (32768, 5, "hann"), (65536, 8, "hann"),
    (65536, 3, None)])
def test_plain_matches_jax_step_and_golden(N, n_valid, window):
    """Against the JAX package's own step at N (its CPU fft4 rung)."""
    raw = frames(8, N, N + n_valid)
    w = None if window is None else make_window(window, N)
    got = plain(raw, n_valid, 8, w)
    step = JaxPsdStep(N, 8, window=w)
    assert step.path == "fft4"
    want = np.asarray(step(raw, n_valid), np.float64)
    gold = golden(raw, n_valid, w)
    np.testing.assert_allclose(got, gold, rtol=GOLDEN_RTOL)
    np.testing.assert_allclose(want, gold, rtol=GOLDEN_RTOL)
    np.testing.assert_allclose(got, want, rtol=CROSS_RTOL)


@pytest.mark.parametrize("N,n_valid,window", [
    (32768, 8, None), (32768, 6, "blackman"), (65536, 8, None),
    (65536, 7, "hann")])
def test_plain_matches_jax_kernel(N, n_valid, window):
    """Against K1/K2 itself, make_fused_psd_fn in interpret mode: the JAX
    kernel this step replaces from 32768 to 65536."""
    raw = frames(8, N, 2 * N + n_valid)
    w = None if window is None else make_window(window, N)
    fn = make_fused_psd_fn(N, 8, windowed=w is not None, interpret=True)
    args = (raw.view(np.uint16), n_valid) + (() if w is None else (w,))
    want = np.asarray(fn(*args), np.float64)
    got = plain(raw, n_valid, 8, w)
    np.testing.assert_allclose(want, golden(raw, n_valid, w),
                               rtol=GOLDEN_RTOL)
    np.testing.assert_allclose(got, want, rtol=CROSS_RTOL)


def test_plain_at_config3_size_matches_golden():
    """P15's shape, BASELINE config 3: N = 2^20, F = 8 (the session's step
    at 2^20), 6 valid frames."""
    N = 1 << 20
    raw = frames(8, N, 3)
    w = make_window("hann", N)
    for window in (None, w):
        np.testing.assert_allclose(plain(raw, 6, 8, window),
                                   golden(raw, 6, window), rtol=GOLDEN_RTOL)


def bit_reverse(n_bits):
    i = np.arange(1 << n_bits)
    return np.array([int(format(v, f"0{n_bits}b")[::-1], 2) for v in i])


def dif_radix2(x, tw):
    """fft_radix2.cuh's dif_radix2 on each row of x (one transform per
    row, natural order in, slot i = bin bit_reverse(i) out)."""
    n = x.shape[1]
    j = np.arange(n // 2)
    s = n.bit_length() - 2
    while s >= 0:
        m = 1 << s
        k = j & (m - 1)
        i0 = ((j >> s) << (s + 1)) + k
        a, b = x[:, i0], x[:, i0 + m]
        x[:, i0] = a + b
        x[:, i0 + m] = (a - b) * tw[m - 1 + k]
        s -= 1
    return x


def kernel_transcription(raw, n_valid, chunk, window=None):
    """numpy transcription of csrc/fused_psd_large.cu: the N1 x N2 split,
    pass A per C-column tile (word q -> row q / (C/2), word q % (C/2);
    the padded (C, N1 + 1) tile; the column transforms; slot e -> column
    e % C, row k1 = e / C; the inter-stage twiddle from the two float64
    tables; the scratch[f][k1][n2] store), pass B per R-row tile (the
    padded (R, N2 + 2) rows, the row transforms, accumulator e -> row
    e % R, slot e / R, bin k0 + e % R + N1 * bit_reverse(e / R)) over the
    block's frames in float32, and the float64 sum of the partial rows."""
    F, N = raw.shape[0], raw.shape[1] // 2
    t = fl.large_tiles(N)
    N1, N2, C, R = t["N1"], t["N2"], t["C"], t["R"]
    l1, l2 = N1.bit_length() - 1, N2.bit_length() - 1
    tw1 = fp.stage_twiddles(N1)
    tw1 = (tw1[:, 0] + 1j * tw1[:, 1]).astype(np.complex64)
    tw2 = fp.stage_twiddles(N2)
    tw2 = (tw2[:, 0] + 1j * tw2[:, 1]).astype(np.complex64)
    inter = fl.inter_tables(N)
    inter = inter[:, 0] + 1j * inter[:, 1]
    rev1, rev2 = bit_reverse(l1), bit_reverse(l2)
    group = fl.frames_per_block(F, chunk, N)
    groups = -(-F // group)
    win = None if window is None else np.asarray(window, np.float32) \
        .reshape(N // 2, 2)
    scratch = np.zeros((F, N), np.complex64)

    q = np.arange(N1 * C // 2)
    n1, w = q // (C // 2), q % (C // 2)
    e = np.arange(N1 * C)
    col, k1 = e % C, e // C
    for j in range(groups):
        for f in range(j * group, min((j + 1) * group, F, n_valid)):
            words = raw[f].view(np.uint32).astype(np.int64)
            for c0 in range(0, N2, C):
                word = ((n1 << l2) + c0) // 2 + w
                v = words[word]
                s0 = (((v & 0xFF) - 127)
                      + 1j * (((v >> 8) & 0xFF) - 127)).astype(np.complex64)
                s1 = ((((v >> 16) & 0xFF) - 127)
                      + 1j * ((v >> 24) - 127)).astype(np.complex64)
                if win is not None:
                    s0 = s0 * win[word, 0]
                    s1 = s1 * win[word, 1]
                x = np.zeros((C, N1 + 1), np.complex64)
                x[2 * w, n1] = s0
                x[2 * w + 1, n1] = s1
                x[:, :N1] = dif_radix2(x[:, :N1], tw1)
                y = x[col, rev1[k1]]
                m = (c0 + col) * k1
                tw = (inter[m & (N2 - 1)] * inter[N2 + (m >> l2)])
                scratch[f, (k1 << l2) + c0 + col] = y * tw.astype(np.complex64)

    partial = np.zeros((groups, N), np.float32)
    e = np.arange(R * N2)
    for g in range(groups):
        for k0 in range(0, N1, R):
            acc = np.zeros(R * N2, np.float32)
            for f in range(g * group, min((g + 1) * group, F, n_valid)):
                x = np.zeros((R, N2 + 2), np.complex64)
                x[e >> l2, e & (N2 - 1)] = scratch[f, (k0 << l2) + e]
                x[:, :N2] = dif_radix2(x[:, :N2], tw2)
                X = x[e % R, e // R]
                acc += X.real * X.real + X.imag * X.imag
            partial[g, k0 + e % R + (rev2[e // R] << l1)] = acc
    return partial.astype(np.float64).sum(axis=0)


@pytest.mark.parametrize("N,F,chunk,n_valid,window", [
    (32768, 8, 8, 8, None), (32768, 8, 4, 5, "hann"),
    (65536, 4, 4, 3, "blackman")])
def test_kernel_transcription_matches_golden(N, F, chunk, n_valid, window):
    raw = frames(F, N, 5 * N + n_valid)
    w = None if window is None else make_window(window, N)
    got = kernel_transcription(raw, n_valid, chunk, w)
    np.testing.assert_allclose(got, golden(raw, n_valid, w),
                               rtol=GOLDEN_RTOL)


@pytest.mark.parametrize("N,split,c,r", [
    (32768, (128, 256), 16, 8), (65536, (256, 256), 16, 8),
    (1 << 20, (1024, 1024), 16, 8), (1 << 21, (1024, 2048), 16, 4),
    (1 << 22, (2048, 2048), 8, 4)])
def test_split_and_tiles(N, split, c, r):
    assert fl.large_split(N) == split
    t = fl.large_tiles(N)
    assert (t["N1"], t["N2"], t["C"], t["R"]) == (*split, c, r)
    # Shared memory of a block (padded rows, 8 bytes a value) within the
    # 227 KB a Hopper block may use.
    assert c * (split[0] + 1) * 8 <= 232448
    assert r * (split[1] + 2) * 8 <= 232448


@pytest.mark.parametrize("F,chunk,N,group", [
    (8, 8, 1 << 20, 4),       # config 3's step: 128 pass-A blocks
    (32, 32, 32768, 4),       # the session's step at 32768
    (16, 16, 65536, 2),
    (8, 8, 1 << 22, 8),
    (4096, 64, 32768, 64),    # enough frames: a block takes a whole chunk
])
def test_frames_per_block(F, chunk, N, group):
    assert fl.frames_per_block(F, chunk, N) == group


def test_inter_twiddle_is_the_rounded_float64_value():
    N = 32768
    n1, n2 = fl.large_split(N)
    got = fl.inter_twiddle(N)
    m = np.arange(n1)[:, None] * np.arange(n2)[None, :]
    want = np.exp(-2j * np.pi * m / N)
    # One float32 rounding of a value within ~1e-16 of the exact one.
    np.testing.assert_allclose(got.real, want.real, rtol=0, atol=6e-8)
    np.testing.assert_allclose(got.imag, want.imag, rtol=0, atol=6e-8)
    assert got.dtype == np.complex64


@pytest.mark.parametrize("N,ok", [(16384, False), (32768, True),
                                  (65536, True), (1 << 20, True),
                                  (1 << 22, True), (1 << 23, False),
                                  (49152, False), (0, False)])
def test_eligibility(N, ok):
    assert fl.fused_psd_large_eligible(N) is ok


@pytest.mark.parametrize("make,n_valid,chunk,exc", [
    (lambda: torch.zeros((8, 65536), dtype=torch.int16), 8, 8, TypeError),
    (lambda: torch.zeros(65536, dtype=torch.uint8), 8, 8, ValueError),
    (lambda: torch.zeros((8, 65537), dtype=torch.uint8), 8, 8, ValueError),
    (lambda: torch.zeros((8, 32768), dtype=torch.uint8), 8, 8, ValueError),
    (lambda: torch.zeros((2, 98304), dtype=torch.uint8), 2, 2, ValueError),
    (lambda: torch.zeros((65536, 8), dtype=torch.uint8).t(), 8, 8,
     ValueError),
    (lambda: torch.zeros((8, 65536), dtype=torch.uint8), 8, 3, ValueError),
    (lambda: torch.zeros((8, 65536), dtype=torch.uint8), 9, 8, ValueError),
    (lambda: torch.zeros((8, 65536), dtype=torch.uint8, device="meta"), 8,
     8, ValueError),
])
def test_rejects_what_the_kernel_does_not_take(make, n_valid, chunk, exc):
    with pytest.raises(exc):
        fl.fused_psd_large(make(), n_valid, chunk)


@pytest.mark.parametrize("window", [
    torch.ones(16384), torch.ones(32768, dtype=torch.float64),
    torch.ones(65536)[::2], np.ones(32768, np.float32)])
def test_rejects_windows_the_kernel_does_not_take(window):
    with pytest.raises(ValueError):
        fl.fused_psd_large(torch.zeros((8, 65536), dtype=torch.uint8), 8, 8,
                           window)


def test_cpu_calls_count_as_plain():
    counts = fp.COUNTS
    counts.reset()
    raw = torch.zeros((8, 65536), dtype=torch.uint8)
    fl.fused_psd_large(raw, 8, 8)
    fl.fused_psd_large(raw, 8, 8, torch.ones(32768))
    assert (counts.kernel_large, counts.kernel_large_windowed,
            counts.plain) == (0, 0, 2)
    counts.reset()
    assert (counts.kernel_large, counts.plain) == (0, 0)


@pytest.mark.parametrize("N,window,precision,path", [
    (32768, None, "highest", "plain_large"),
    (65536, "hann", "highest", "plain_large"),
    (1 << 22, None, "highest", "plain_large"),
    (16384, None, "highest", "plain"),
    (32768, None, "high", "plain_large")])
def test_psd_step_routes_large_n(N, window, precision, path, capsys):
    w = None if window is None else make_window(window, N)
    step = spectral.PsdStep(N, 8, CPU, window=w, precision=precision)
    assert step.path == path
    note = capsys.readouterr().err
    if precision == "high":
        # The JAX package's CPU step prints the same line at this size.
        JaxPsdStep(N, 8, precision="high")
        assert note and note == capsys.readouterr().err
        assert note.startswith("Note: --precision high is a no-op")
    else:
        assert note == ""


@pytest.mark.parametrize("kwargs,what", [
    (dict(N=1 << 23), "8388608 bins"),
    (dict(N=49152), "49152 bins"),
    (dict(N=32768, backend="pallas", precision="high"),
     "--precision high at 32768 bins"),
    (dict(N=65536, backend="fft4"), "--fft-backend fft4"),
])
def test_psd_step_still_refuses(kwargs, what):
    args = dict(frames_per_step=8, device=CPU)
    args.update(kwargs)
    with pytest.raises(RPFexception) as e:
        spectral.PsdStep(**args)
    assert int(e.value.return_value) == 3
    assert "Not yet ported" in str(e.value) and what in str(e.value)


# At 2^20 the session averages 4 spectra of noise alone: under the other
# sessions' strong tone the float32 FFT class itself is above 1e-5 of the
# float64 golden per bin at this size (pinned below), so there the kernel
# is held class-relative, by the test below and chip_smoke.py's tone yard.
SESSIONS = {
    "32768": ["-f", "100M", "-b", "32768",
              "--source", "synthetic:tone=100.2M/35,noise=6,seed=1"],
    "65536 hann": ["-f", "100M", "-b", "65536", "--window-function", "hann",
                   "--source", "synthetic:tone=100.3M/35,noise=5,seed=3"],
    "2^20": ["-f", "100M", "-b", "1048576", "-n", "4",
             "--source", "synthetic:noise=6,seed=1"],
}


def test_strong_tone_at_config3_size_is_held_class_relative():
    """Under a strong tone at 2^20 (4 spectra of the 35-count tone over
    noise of 6) the scipy float32 FFT is above 1e-5 of the golden in the
    bins far below the tone, and the plain version stays within the
    class-relative budget's 1.5x of it (the repo's admission rule)."""
    import scipy.fft
    from rtl_power_fftw_tpu_torch.sources.registry import make_source
    N, R = 1 << 20, 4
    src = make_source("synthetic:tone=100.2M/35,noise=6,seed=1", 2_000_000)
    src.set_frequency(100_000_000)
    stream, _ = src.read(2 * N * R)
    raw = np.zeros((8, 2 * N), np.uint8)
    raw[:R] = stream.reshape(R, 2 * N)
    gold = golden(raw, R)
    z = ((raw[:R, 0::2].astype(np.float64) - 127.0)
         + 1j * (raw[:R, 1::2].astype(np.float64) - 127.0))
    X = scipy.fft.fft(z.astype(np.complex64), axis=1)
    cls = (X.real.astype(np.float64) ** 2
           + X.imag.astype(np.float64) ** 2).sum(0)

    def max_rel(a):
        return float((np.abs(a - gold) / gold).max())

    assert max_rel(cls) > GOLDEN_RTOL
    assert max_rel(plain(raw, R, 8)) <= 1.5 * max_rel(cls)


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_session_text_matches_jax_session(name):
    argv = SESSIONS[name]
    res_j, out_j, err_j = outcome(argv, port=False)
    res_p, out_p, err_p = outcome(argv, port=True)
    assert res_p == res_j == 0
    assert assert_text_outputs_match(out_j, out_p) == int(argv[3])
    assert err_p == err_j


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_session_matrix_and_record_match_jax_session(name, tmp_path):
    outs = {}
    for port in (False, True):
        d = tmp_path / ("port" if port else "jax")
        d.mkdir()
        rv, out, err = run(SESSIONS[name] + ["-m", str(d / "m"), "-l",
                                             "--record", str(d / "iq")],
                           port=port)
        assert rv == 0
        outs[port] = (out, mask_stderr(err.replace(str(d), "<dir>")),
                      (d / "m.met").read_text(),
                      np.fromfile(d / "m.bin", dtype=np.float32),
                      (d / "iq").read_bytes())
    (out_j, err_j, met_j, bin_j, rec_j), (out_p, err_p, met_p, bin_p,
                                          rec_p) = outs[False], outs[True]
    N = int(SESSIONS[name][3])
    assert out_p == out_j and err_p == err_j and rec_p == rec_j
    # avgScanDur (line 7) is derived from the second-resolution timestamps.
    assert [TIMESTAMP.sub("<t>", m) for i, m in
            enumerate(met_p.split("\n")) if i != 6] \
        == [TIMESTAMP.sub("<t>", m) for i, m in
            enumerate(met_j.split("\n")) if i != 6]
    assert met_p.split("\n")[0] == f"{N} # frequency bins (columns)"
    assert bin_p.shape == bin_j.shape == (N,)
    np.testing.assert_allclose(bin_p, bin_j, rtol=CROSS_RTOL)


@pytest.mark.parametrize("extra,what", [
    (["-b", "49152"], "49152 bins"),
    (["-b", "8388608", "-n", "1"], "8388608 bins"),
    (["-b", "32768", "--streams", "2"], "--streams at 32768 bins"),
    (["-b", "65536", "--fft-backend", "pallas", "--precision", "high"],
     "--precision high at 65536 bins"),
])
def test_large_n_cases_that_still_exit_3(extra, what):
    argv = ["-f", "100M", "-n", "2", "--source", "synthetic:"] + extra
    res, out, err = outcome(argv, port=True)
    assert res[0] == 3 and what in res[1] and "Not yet ported" in res[1]


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Runs only where a CUDA device is present (chip_smoke.py covers it
    in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    N, F = 32768, 16
    raw = torch.from_numpy(frames(F, N, 11)).cuda()
    w = torch.from_numpy(make_window("hann", N)).cuda()
    before = (fp.COUNTS.kernel_large, fp.COUNTS.kernel_large_windowed)
    for window in (None, w):
        got = fl.fused_psd_large(raw, 13, 16, window)
        want = fl.fused_psd_large_reference(raw, 13, 16, window)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5)
    assert (fp.COUNTS.kernel_large,
            fp.COUNTS.kernel_large_windowed) == (before[0] + 1,
                                                 before[1] + 1)
