"""The large mixed-radix step ("ML": ``fused_psd_mixed_large``, even
7-smooth N from 16386 to 2^22 that are not powers of two) against the JAX
package and the float64 golden, its index arithmetic in numpy, and its
sessions against the JAX package's.

On the CPU the wrapper runs the kernel's plain PyTorch version (the four
steps in torch ops with the kernel's twiddle table); the JAX side runs its
CPU ladder (the fft4 rung at these N). Tolerances: 1e-5 relative against
the float64 golden, 1e-5 between the two packages. The CUDA kernel's
split, tile layout, scratch order and digit-reversed bin map are pinned by
a numpy transcription of its passes (csrc/fft_mixed_tile.cuh: the run-time
passes of fft_mixed.cuh on tiles of columns and rows) in float64 against
numpy.fft (rtol 1e-9) and in float32 against tests/golden.py (rtol 1e-5);
the kernel itself runs only on a card (chip_smoke.py phase 15, and the
test marked ``cuda``).
"""

import numpy as np
import pytest
import torch

from rtl_power_fftw_tpu.ops.spectral import PsdStep as JaxPsdStep
from rtl_power_fftw_tpu_torch.auxdata import make_window
from rtl_power_fftw_tpu_torch.ops import spectral
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed as fm
from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed_large as ml
from rtl_power_fftw_tpu_torch.ops.kernels.fused_psd_large import large_group

from golden import golden_accumulate
from test_torch_fused_psd_mixed import dequantize, dif, psd_sum, twiddle_table
from test_torch_session import (TIMESTAMP, assert_text_outputs_match,
                                mask_stderr, run)

CPU = torch.device("cpu")
GOLDEN_RTOL = 1e-5
CROSS_RTOL = 1e-5
#: resident_blocks stand-in for the grid rule: 132 SMs (an H100) times two
#: blocks.
RESIDENT = 132 * 2


def smooth_eligible():
    """Every N the kernel takes (1192 of them)."""
    out = []
    for a in range(1, 23):
        for b in range(15):
            for c in range(10):
                for d in range(8):
                    n = 2 ** a * 3 ** b * 5 ** c * 7 ** d
                    if n <= ml.MAX_N and ml.fused_psd_mixed_large_eligible(n):
                        out.append(n)
    return sorted(out)


ELIGIBLE = smooth_eligible()


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
    return ml.fused_psd_mixed_large(torch.from_numpy(raw), n_valid, chunk,
                                    w).numpy()


def partial_bins(T, n, plan, bins):
    """tile_power_kernel's map (csrc/fft_mixed_tile.cuh): for transform t
    < T and bin k < n of its transform, the bin t + T·k of the partial row
    (-1 where it is not below ``bins``: not written), and the element of
    the tile it reads, element_of_bin(k)."""
    out = np.arange(T)[:, None] + T * np.arange(n)[None, :]
    return (np.where(out < bins, out, -1),
            fm.element_of_bin(plan, np.arange(n)))


def kernel_transcription(raw, n_valid, chunk, window=None,
                         dtype=np.complex64):
    """The kernel as one step runs it: pass A's column transforms (the
    run-time passes in element order, read back by element_of_bin) times
    the inter-stage twiddle into the (F, N1, N2) scratch; pass B's row
    transforms over each block's frames, |X|^2 summed in float32 by
    element, written by tile_power_kernel's map (partial_bins) into padded
    partial rows; psd_sum.cuh's float64 row sum."""
    F, N = raw.shape[0], raw.shape[1] // 2
    t = ml.mixed_large_layout(N)
    n1, n2 = t.N1, t.N2
    x = dequantize(raw, window, dtype)
    tw1, tw2 = twiddle_table(t.plan1, dtype), twiddle_table(t.plan2, dtype)
    order1 = fm.element_of_bin(t.plan1, np.arange(n1))
    if dtype == np.complex64:
        inter = ml.inter_twiddle(N, n1, n2)
    else:
        inter = np.exp(-2j * np.pi * (np.arange(n1)[:, None]
                                      * np.arange(n2)[None, :] % N) / N)
    scratch = np.zeros((F, n1, n2), dtype)
    for f in range(min(F, n_valid)):
        y = dif(x[f].reshape(n1, n2).T.copy(), t.plan1, tw1)   # [n2, elem]
        # Pass A's store: (k1, n2) at k1 * N2 + n2 of the frame.
        scratch[f].reshape(-1)[np.arange(n1)[:, None] * n2
                               + np.arange(n2)[None, :]] = \
            y[:, order1].T * inter
    bins, elem = partial_bins(n1, n2, t.plan2, N)
    real = np.float32 if dtype == np.complex64 else np.float64
    group = large_group(F, t.tiles_b, RESIDENT)
    rows = []
    for f0 in range(0, F, group):
        acc = np.zeros((n1, n2), real)
        for f in range(f0, min(f0 + group, F, n_valid)):
            Y = dif(scratch[f], t.plan2, tw2)
            acc += (Y.real * Y.real + Y.imag * Y.imag).astype(real)
        row = np.zeros(t.row, real)
        row[bins.ravel()] = acc[:, elem].ravel()
        rows.append(row)
    if dtype != np.complex64:
        return np.stack(rows).sum(0)[:N]
    return psd_sum(np.stack(rows))[:N]


@pytest.mark.parametrize("N,ok", [
    (16384, False), (16386, False), (16464, True), (20000, True),
    (32768, False), (49152, True), (99998, False), (100000, True),
    (10 ** 6, True), (1 << 22, False), (4167450, True), (4 * 3 ** 13, False),
    (19998, False)])
def test_eligibility(N, ok):
    assert ml.fused_psd_mixed_large_eligible(N) == ok


@pytest.mark.parametrize("N,split", [
    (16464, (112, 147)), (20000, (125, 160)), (49152, (192, 256)),
    (100000, (250, 400)), (10 ** 6, (1000, 1000)),
    (4167450, (2025, 2058))])
def test_split_table(N, split):
    """The divisor nearest sqrt(N): the JAX package's fft4 splits at
    20000, 49152, 100000 and 10^6."""
    assert ml.mixed_large_split(N) == split


def test_split_and_layout_of_every_eligible_n():
    """Each eligible N splits within 2048 x 16384 into 7-smooth factors,
    with the plans of the mixed-radix kernel, and each pass's tile fits
    two blocks an SM."""
    assert len(ELIGIBLE) == 1192 and ml.eligible_sizes() == ELIGIBLE
    for N in ELIGIBLE:
        t = ml.mixed_large_layout(N)
        assert t.N1 * t.N2 == N and t.N1 <= ml.MAX_N1 and t.N2 <= 3125
        assert 98 <= t.N1 and fm.smooth7(t.N1) and fm.smooth7(t.N2)
        assert int(np.prod(t.plan1)) == t.N1 and len(t.plan1) <= \
            fm.MAX_PASSES
        assert max(t.smem_a, t.smem_b) <= ml.TILE_SMEM
        assert t.xs1 % 2 == 1 and t.xs1 > fm.pad_index(t.N1 - 1)
        assert t.row % fm.SUM_BINS == 0 and N <= t.row < N + fm.SUM_BINS


@pytest.mark.parametrize("n,extra,buffers,total,count", [
    (125, 0, 1, 160, 16), (1000, 4000, 1, 1000, 8), (2048, 0, 1, 2048, 4),
    (2048, 0, 2, 2048, 2), (2048, 8192, 1, 2048, 4), (160, 0, 1, 5, 8)])
def test_tile_count(n, extra, buffers, total, count):
    assert ml.tile_count(n, extra, buffers, total) == count


def test_tile_ints_are_the_plan():
    assert ml.tile_ints((8, 5, 4)) == [160, 3, 8, 5, 4] + [0] * 7
    assert len(ml.tile_ints(fm.mixed_plan(2 * 3 ** 8))) == 12


@pytest.mark.parametrize("N", [20000, 10 ** 6])
def test_inter_twiddle_is_the_rounded_float64_value(N):
    n1, n2 = ml.mixed_large_split(N)
    got = ml.inter_twiddle(N, n1, n2)
    m = np.arange(n1)[:, None] * np.arange(n2)[None, :]
    want = np.exp(-2j * np.pi * m / N)
    assert got.dtype == np.complex64 and got.shape == (n1, n2)
    assert np.abs(got - want).max() < 1e-7


@pytest.mark.parametrize("N", [16464, 20000])
def test_partial_bins_cover_each_bin_once(N):
    t = ml.mixed_large_layout(N)
    bins, elem = partial_bins(t.N1, t.N2, t.plan2, N)
    assert sorted(bins.ravel()) == list(range(N))
    assert sorted(elem) == list(range(t.N2))


@pytest.mark.parametrize("N", [16464, 20000])
def test_transcription_float64_is_the_dft(N):
    raw = frames(3, N, N)
    got = kernel_transcription(raw, 3, 1, dtype=np.complex128)
    z = dequantize(raw, None, np.complex128)
    want = (np.abs(np.fft.fft(z, axis=1)) ** 2).sum(0)
    np.testing.assert_allclose(got, want, rtol=1e-9)


@pytest.mark.parametrize("N,F,n_valid,window", [
    (20000, 8, 8, None), (20000, 8, 5, "hann"), (49152, 4, 3, None),
    (16464, 16, 16, "blackman")])
def test_transcription_float32_against_golden(N, F, n_valid, window):
    raw = frames(F, N, N + F)
    w = None if window is None else make_window(window, N)
    got = kernel_transcription(raw, n_valid, F, w)
    gold = golden(raw, n_valid, w)
    np.testing.assert_allclose(got, gold, rtol=GOLDEN_RTOL)
    np.testing.assert_allclose(got, plain(raw, n_valid, F, w),
                               rtol=GOLDEN_RTOL)


@pytest.mark.parametrize("N,F,n_valid,window", [
    (20000, 8, 8, None), (20000, 8, 8, "hann"), (49152, 8, 8, None),
    (49152, 8, 6, "hann"), (100000, 8, 8, None), (100000, 8, 8, "hann"),
    (100000, 8, 3, None), (10 ** 6, 8, 4, None)])
def test_step_matches_jax_step_and_golden(N, F, n_valid, window):
    """The port's PsdStep (the plain version) against the JAX package's
    PsdStep (its CPU fft4 rung) on the same frames, and both against the
    float64 golden."""
    raw = frames(F, N, N + n_valid)
    w = None if window is None else make_window(window, N)
    step = spectral.PsdStep(N, F, CPU, window=w)
    assert step.path == "plain_mixed_large"
    got = step(raw, n_valid).numpy()
    want = np.asarray(JaxPsdStep(N, F, window=w)(raw, n_valid), np.float64)
    gold = golden(raw, n_valid, w)
    np.testing.assert_allclose(got, want, rtol=CROSS_RTOL)
    np.testing.assert_allclose(got, gold, rtol=GOLDEN_RTOL)
    np.testing.assert_allclose(want, gold, rtol=GOLDEN_RTOL)


def test_cpu_calls_count_as_plain():
    fp.COUNTS.reset()
    raw = torch.from_numpy(frames(8, 20000, 1))
    ml.fused_psd_mixed_large(raw, 8, 8)
    assert fp.COUNTS.plain == 1
    assert fp.COUNTS.kernel_mixed_large == 0
    assert fp.COUNTS.kernel_mixed_large_windowed == 0


@pytest.mark.parametrize("N", [16384, 32768, 16382, 1 << 23])
def test_rejects_n_the_kernel_does_not_take(N):
    raw = torch.zeros((8, 2 * N), dtype=torch.uint8)
    with pytest.raises(ValueError, match="does not take"):
        ml.fused_psd_mixed_large(raw, 8, 8)


def test_precision_high_runs_full_precision_with_the_note(capsys):
    step = spectral.PsdStep(20000, 8, CPU, precision="high")
    assert step.path == "plain_mixed_large"
    note = capsys.readouterr().err
    # The JAX package's CPU step prints the same line at this size.
    JaxPsdStep(20000, 8, precision="high")
    assert note == capsys.readouterr().err
    assert note.startswith("Note: --precision high is a no-op on the FFT "
                           "four-step path")


def session_rtol(record, N, repeats, hop, window=None):
    """The tolerance between the two packages' session spectra: two
    float32 budgets, each 1e-5 or, where the float32 FFT class itself is
    further from the float64 golden on the session's own frames (a 35 dB
    tone at 10^5 bins), that class's largest relative error (CLAUDE.md's
    class-relative rule)."""
    import scipy.fft
    stream = np.fromfile(record, dtype=np.uint8)
    raw = np.stack([stream[2 * hop * f:2 * hop * f + 2 * N]
                    for f in range(repeats)])
    z = ((raw[:, 0::2].astype(np.float64) - 127.0)
         + 1j * (raw[:, 1::2].astype(np.float64) - 127.0))
    if window is not None:
        z = z * np.asarray(window, np.float64)
    X = np.fft.fft(z, axis=1)
    gold = (X.real ** 2 + X.imag ** 2).sum(0)
    Xc = scipy.fft.fft(z.astype(np.complex64), axis=1)
    cls = (Xc.real.astype(np.float64) ** 2
           + Xc.imag.astype(np.float64) ** 2).sum(0)
    return 2 * max(GOLDEN_RTOL, float((np.abs(cls - gold) / gold).max()))


def session_matches_jax_session(argv, path, hop_of_n, window, tmp_path,
                                matrix):
    """A session of the port (on the CPU) and of the JAX package on the
    same argv: the same exit code, masked stderr and recorded stream, the
    port on ``path``; in text mode the same lines, values within
    :func:`session_rtol` of the port's recorded frames; in matrix mode the
    same stdout and .met (timestamps masked), a .bin within it."""
    N, repeats = int(argv[argv.index("-b") + 1]), int(argv[argv.index("-n")
                                                              + 1])
    outs = {}
    for port in (False, True):
        d = tmp_path / ("port" if port else "jax")
        d.mkdir()
        extra = ["--record", str(d / "iq")] + (["-m", str(d / "m")]
                                              if matrix else [])
        rv, out, err = run(argv + extra, port=port)
        assert int(rv) == 0
        if port:
            assert f"Transform path: {path} (backend=" in err
        outs[port] = (out, mask_stderr(err.replace(str(d), "<dir>")),
                      (d / "iq").read_bytes(), d)
    (out_j, err_j, rec_j, d_j), (out_p, err_p, rec_p, d_p) = \
        outs[False], outs[True]
    assert err_p == err_j and rec_p == rec_j
    w = None if window is None else make_window(window, N)
    rtol = session_rtol(d_p / "iq", N, repeats, hop_of_n(N), w)
    if not matrix:
        assert assert_text_outputs_match(out_j, out_p, rtol=rtol) == N
        return
    assert out_p == out_j
    met_p, met_j = ((d / "m.met").read_text() for d in (d_p, d_j))
    # avgScanDur (line 7) is derived from the second-resolution timestamps.
    assert [TIMESTAMP.sub("<t>", m) for i, m in
            enumerate(met_p.split("\n")) if i != 6] \
        == [TIMESTAMP.sub("<t>", m) for i, m in
            enumerate(met_j.split("\n")) if i != 6]
    assert met_p.split("\n")[0] == f"{N} # frequency bins (columns)"
    bin_p, bin_j = (np.fromfile(d / "m.bin", dtype=np.float32)
                    for d in (d_p, d_j))
    assert bin_p.shape == bin_j.shape == (N,)
    np.testing.assert_allclose(10.0 ** (bin_p / 10.0), 10.0 ** (bin_j / 10.0),
                               rtol=rtol)


SESSIONS = {
    # (argv, hop of N, window)
    "100000": (["-f", "100M", "-b", "100000", "-n", "16", "--source",
                "synthetic:tone=100.2M/35,noise=6,seed=1"],
               lambda N: N, None),
    "20000 hann welch": (["-f", "100M", "-b", "20000", "-n", "40",
                          "--window-function", "hann", "--welch-overlap",
                          "50", "--source",
                          "synthetic:tone=100.3M/35,noise=5,seed=3"],
                         lambda N: N // 2, "hann"),
}


@pytest.mark.parametrize("matrix", [False, True])
@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_session_matches_jax_session(name, matrix, tmp_path):
    argv, hop, window = SESSIONS[name]
    session_matches_jax_session(argv, "plain_mixed_large", hop, window,
                                tmp_path, matrix)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Runs only where a CUDA device is present (chip_smoke.py phase 15
    covers it in full); on a CPU host it skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py)")
    N, F = 20000, 16
    raw = torch.from_numpy(frames(F, N, 11)).cuda()
    got = ml.fused_psd_mixed_large(raw, F, F).cpu().numpy()
    want = ml.fused_psd_mixed_large_reference(raw.cpu(), F, F).numpy()
    np.testing.assert_allclose(got, want, rtol=GOLDEN_RTOL)
