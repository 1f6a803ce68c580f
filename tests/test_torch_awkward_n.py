"""Awkward bin counts on the port: the route table
(``ops.spectral.transform_route``), the single-stream and multi-stream
steps at N that are not powers of two against the JAX package's steps on
the same bytes, and whole CLI sessions at such N against the JAX
package's.

On the CPU the port's steps are the kernels' plain versions (K1's
``torch.fft.fft`` for the mixed-radix route, the chirp-Z transcription
for the chirp-Z route); the JAX steps run their own ladders on the
CPU. Steps agree within 2e-5 (two float32 budgets) and each is within
1e-5 of the float64 golden (tests/golden.py); sessions agree as
tests/test_torch_session.py's do (text, .met with timestamps masked,
stderr, and a .bin within 2e-5 in linear power).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import rtl_power_fftw_tpu.interrupts as jax_interrupts
import rtl_power_fftw_tpu_torch.interrupts as interrupts
from rtl_power_fftw_tpu.ops import spectral as jax_spectral
from rtl_power_fftw_tpu.parallel import ShardedPsdStep as JaxShardedPsdStep
from rtl_power_fftw_tpu.parallel import make_mesh as jax_make_mesh
from rtl_power_fftw_tpu_torch import cli
from rtl_power_fftw_tpu_torch.auxdata import make_window
from rtl_power_fftw_tpu_torch.exceptions import ReturnValue, RPFexception
from rtl_power_fftw_tpu_torch.ops import spectral
from rtl_power_fftw_tpu_torch.parallel import ShardedPsdStep, make_mesh
from rtl_power_fftw_tpu_torch.parallel import sharded

from golden import golden_accumulate
from test_torch_session import (TIMESTAMP, assert_text_outputs_match,
                                mask_stderr, run)

CPU = torch.device("cpu")
CROSS_RTOL = 2e-5
GOLDEN_RTOL = 1e-5
#: The reference's documented example session (doc/rtl_power_fftw.1.md
#: 182-201: 144.1-146.1 MHz, 500 bins, matrix mode), cut to 20 spectra,
#: on a synthetic tone.
MAN_PAGE = ["-f", "144.1M:146.1M", "-b", "500", "-n", "20",
            "--source", "synthetic:tone=145.3M/35,noise=6,seed=3"]


@pytest.fixture(autouse=True)
def _reset_interrupts():
    for module in (interrupts, jax_interrupts):
        module.reset()
    yield
    for module in (interrupts, jax_interrupts):
        module.reset()


ROUTE_TABLE = [
    # (N, backend, fast, route or None for exit 3)
    (64, "auto", False, "regs"), (16384, "pallas", False, "regs"),
    (2048, "auto", True, "fast"), (32768, "auto", False, "large"),
    (1 << 22, "auto", True, "large"), (1 << 20, "pallas", True, None),
    (128, "auto", True, None),
    (2, "auto", False, "mixed"), (32, "auto", False, "mixed"),
    (6, "auto", False, "mixed"), (500, "auto", False, "mixed"),
    (500, "pallas", True, "mixed"), (2400, "auto", False, "mixed"),
    (12000, "auto", False, "mixed"), (16200, "auto", True, "mixed"),
    (998, "auto", False, "bluestein"), (22, "pallas", False, "bluestein"),
    (8182, "auto", True, "bluestein"), (8192 - 2, "auto", False,
                                        "bluestein"),
    (8194, "auto", False, "chirp_large"),
    (16382, "auto", False, "chirp_large"),
    (49152, "auto", False, "mixed_large"), (1 << 23, "auto", False, None),
    (20000, "auto", False, "mixed_large"),
    (20000, "auto", True, "mixed_large"),
    (10 ** 6, "pallas", False, "mixed_large"),
    (4167450, "auto", False, "mixed_large"),
    (16464, "auto", False, "mixed_large"),
    (20002, "pallas", True, "chirp_large"),
    (99998, "auto", False, "chirp_large"),
    ((1 << 21) - 2, "auto", False, "chirp_large"),
    (4194302, "auto", False, None), ((1 << 21) + 2, "auto", False, None),
    ((1 << 22) + 6 * 7, "auto", False, None),
    (500, "bluestein", False, "bluestein"),
    (2048, "bluestein", True, "bluestein"),
    (8192, "bluestein", False, "bluestein"),
    (16384, "bluestein", False, "chirp_large"),
    (20000, "bluestein", True, "chirp_large"),
    (1 << 21, "bluestein", False, "chirp_large"),
    (1 << 22, "bluestein", False, None), (500, "xla", False, None),
    (998, "fourstep", False, None), (20000, "fft4", False, None),
    (99998, "xla", False, None),
]


@pytest.mark.parametrize("N,backend,fast,route", ROUTE_TABLE)
def test_transform_route(N, backend, fast, route):
    if route is None:
        with pytest.raises(RPFexception) as e:
            spectral.transform_route(N, backend, fast)
        assert e.value.return_value == ReturnValue.InvalidArgument
        assert "Not yet ported" in str(e.value)
    else:
        assert spectral.transform_route(N, backend, fast) == route


@pytest.mark.parametrize("extra,rc,what", [
    # The large awkward-N kernels' bins run (BL at 8194 and 16382, ML at
    # 49152) ...
    (["-b", "8194"], 0, "Transform path: plain_chirp_large (backend=auto, "
     "N=8194)"),
    (["-b", "16382"], 0, "Transform path: plain_chirp_large (backend=auto, "
     "N=16382)"),
    (["-b", "49152"], 0, "Transform path: plain_mixed_large (backend=auto, "
     "N=49152)"),
    # ... and what is left still exits 3.
    (["-b", str(1 << 23)], 3, f"{1 << 23} bins"),
    (["-b", "4194302"], 3, "4194302 bins"),
    (["-b", "4194302", "--streams", "2"], 3, "4194302 bins"),
    (["-b", "4194302", "--multitaper", "7"], 3,
     "--multitaper at 4194302 bins"),
])
def test_awkward_bins_above_the_kernels_exit_3(extra, rc, what, capsys):
    argv = ["-f", "100M", "-n", "4", "--source", "synthetic:"] + extra
    assert cli.main(argv, device=CPU) == rc
    err = capsys.readouterr().err
    assert what in err
    assert ("Not yet ported" in err) == (rc == 3)


@pytest.mark.parametrize("N,rc,what", [
    (8194, 0, "Transform path: plain_chirp_large (backend=bluestein, "
     "N=8194)"),
    (1 << 22, 3, f"--fft-backend bluestein at {1 << 22} bins"),
])
def test_bluestein_backend_above_8192_exits_3(N, rc, what, capsys):
    argv = ["-f", "100M", "-n", "4", "-b", str(N), "--fft-backend",
            "bluestein", "--source", "synthetic:"]
    assert cli.main(argv, device=CPU) == rc
    assert what in capsys.readouterr().err


def frames(F, N, seed):
    return np.random.default_rng(seed).integers(0, 256, (F, 2 * N),
                                                dtype=np.uint8)


def golden_partial(raw, n_valid, window=None):
    N = raw.shape[1] // 2
    if window is None:
        gold, _ = golden_accumulate(raw[:n_valid].ravel(), N, n_valid)
        return np.fft.ifftshift(gold)
    z = ((raw[:n_valid, 0::2].astype(np.float64) - 127)
         + 1j * (raw[:n_valid, 1::2].astype(np.float64) - 127)) * window
    X = np.fft.fft(z, axis=1)
    return (X.real ** 2 + X.imag ** 2).sum(0)


@pytest.mark.parametrize("N,path", [(500, "plain_mixed"),
                                    (998, "plain_bluestein"),
                                    (2400, "plain_mixed")])
@pytest.mark.parametrize("window", [None, "hann"])
def test_psd_step_matches_jax_step(N, path, window):
    F, n_valid = 24, 21
    raw = frames(F, N, N + (window is not None))
    w = None if window is None else make_window(window, N)
    step = spectral.PsdStep(N, F, CPU, window=w)
    assert step.path == path
    got = step(raw, n_valid).numpy()
    want = np.asarray(jax_spectral.PsdStep(N, F, window=w)(raw, n_valid),
                      np.float64)
    np.testing.assert_allclose(got, want, rtol=CROSS_RTOL)
    np.testing.assert_allclose(got, golden_partial(raw, n_valid, w),
                               rtol=GOLDEN_RTOL)


@pytest.mark.parametrize("N,path", [(500, "plain_mixed"),
                                    (998, "plain_bluestein"),
                                    (2400, "plain_mixed")])
@pytest.mark.parametrize("window", [None, "hann"])
def test_sharded_step_matches_jax_sharded_step(N, path, window):
    S, F = 8, 16
    w = None if window is None else make_window(window, N)
    raw = np.random.default_rng(N).integers(0, 256, (S, F, 2 * N),
                                            dtype=np.uint8)
    n_valid = np.array([F, 8, 0, F, 12, F, 10, F], np.int32)
    step = ShardedPsdStep(make_mesh(CPU), N, F, streams=S, window=w)
    assert step.path == path
    ps, comb = (t.numpy() for t in step(raw, n_valid))
    jax_step = JaxShardedPsdStep(jax_make_mesh(8), N, F, streams=S, window=w)
    want_ps, want_comb = jax_step(raw, n_valid)
    live = n_valid > 0
    np.testing.assert_allclose(ps[live], np.asarray(want_ps)[live],
                               rtol=CROSS_RTOL)
    np.testing.assert_allclose(comb, np.asarray(want_comb), rtol=CROSS_RTOL)
    gold = np.stack([golden_partial(raw[s], n_valid[s], w)
                     if n_valid[s] else np.zeros(N) for s in range(S)])
    np.testing.assert_allclose(ps[live], gold[live], rtol=GOLDEN_RTOL)
    assert not ps[~live].any()


def test_precision_high_at_awkward_n_runs_full_precision(capsys):
    step = spectral.PsdStep(998, 16, CPU, precision="high")
    assert step.path == "plain_bluestein"
    assert ("Note: --precision high is a no-op on the chirp-Z FFT path "
            "selected here (backend=auto, N=998)") in capsys.readouterr().err
    raw = frames(16, 998, 4)
    np.testing.assert_allclose(step(raw, 16).numpy(), golden_partial(raw, 16),
                               rtol=GOLDEN_RTOL)


def test_bluestein_backend_at_a_power_of_two():
    step = spectral.PsdStep(512, 16, CPU, backend="bluestein")
    assert step.path == "plain_bluestein"
    raw = frames(16, 512, 5)
    np.testing.assert_allclose(step(raw, 13).numpy(), golden_partial(raw, 13),
                               rtol=GOLDEN_RTOL)


@pytest.mark.parametrize("extra,path", [
    ([], "plain_mixed"),
    (["-b", "998"], "plain_bluestein"),
    (["-b", "600", "--window-function", "hann"], "plain_mixed"),
    (["--streams", "2"], "plain_mixed"),
    (["-b", "998", "--fft-backend", "bluestein"], "plain_bluestein"),
])
def test_session_matches_jax_session(extra, path, tmp_path):
    """The man-page session cut to 20 spectra (and its variants: awkward
    N through the chirp-Z route, a windowed awkward N, two streams, the
    explicit chirp-Z backend): the same text, .met (timestamps masked)
    and stderr as the JAX package's, and a .bin within 2e-5."""
    argv = MAN_PAGE + extra
    results = {}
    for port in (False, True):
        stem = str(tmp_path / ("port" if port else "jax"))
        rv, out, err = run(argv + ["-m", stem], port=port)
        assert int(rv) == 0
        with open(stem + ".met") as f:
            met = [TIMESTAMP.sub("<t>", line) for line in f]
        results[port] = (out, err, met,
                         np.fromfile(stem + ".bin", dtype=np.float32))
    (out_j, err_j, met_j, bin_j), (out_p, err_p, met_p, bin_p) = \
        results[False], results[True]
    assert out_j == out_p
    assert mask_stderr(err_j) == mask_stderr(err_p)
    assert f"Transform path: {path} " in err_p
    # avgScanDur (line 7) is derived from the second-resolution timestamps.
    assert [m for i, m in enumerate(met_j) if i != 6] \
        == [m for i, m in enumerate(met_p) if i != 6]
    assert bin_j.shape == bin_p.shape and bin_p.size % 2 == 0
    np.testing.assert_allclose(10.0 ** (bin_p / 10.0), 10.0 ** (bin_j / 10.0),
                               rtol=CROSS_RTOL)


@pytest.mark.parametrize("extra", [[], ["-b", "998", "-l"]])
def test_text_session_matches_jax_session(extra):
    rv_j, out_j, err_j = run(MAN_PAGE + extra, port=False)
    rv_p, out_p, err_p = run(MAN_PAGE + extra, port=True)
    assert int(rv_j) == int(rv_p) == 0
    assert assert_text_outputs_match(out_j, out_p, linear="-l" in extra,
                                     rtol=CROSS_RTOL)
    assert mask_stderr(err_j) == mask_stderr(err_p)


def test_man_page_session_exits_0_on_the_cli(capsys):
    assert cli.main(MAN_PAGE, device=CPU) == 0
    captured = capsys.readouterr()
    assert captured.out.startswith("# rtl-power-fftw output\n")
    assert "Transform path: plain_mixed (backend=auto, N=500)" in captured.err


def load_chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP_SMOKE = load_chip_smoke()


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("drive,route,N", [("MAN_PAGE_ARGV", "mixed", 500),
                                           ("B998_ARGV", "bluestein", 998)])
def test_chip_smoke_drive_steps_are_the_sessions(drive, route, N, streams,
                                                 monkeypatch):
    """chip_smoke.py holds each awkward-N kernel to its plain version at
    the steps its drives run, sized by its drive_frames_per_step: the
    session on the same argv hands its kernel those frames and chunk, and
    nothing else."""
    argv = list(getattr(CHIP_SMOKE, drive))
    if streams > 1:
        argv += ["--streams", str(streams)]
    seen = []
    for table in (spectral.ROUTES, sharded.STREAMS_ROUTES):
        kernel, suffix = table[route]

        def recorded(raw, n_valid, chunk, window=None, kernel=kernel):
            seen.append((tuple(raw.shape), chunk))
            return kernel(raw, n_valid, chunk, window)

        monkeypatch.setitem(table, route, (recorded, suffix))
    rv, _, _ = run(argv, port=True)
    F, chunk = spectral.adapt_batch(
        CHIP_SMOKE.drive_frames_per_step(argv, streams))
    shape = (F, 2 * N) if streams == 1 else (streams, F, 2 * N)
    assert rv == 0 and seen and set(seen) == {(shape, chunk)}


@pytest.mark.parametrize("drive", CHIP_SMOKE.LARGE_AWKWARD_DRIVES,
                         ids=lambda d: d[0])
def test_chip_smoke_large_drives_take_their_kernels(drive):
    """Each drive of chip_smoke.py's phase 15 routes to the kernel it is
    held to (ML for 7-smooth N, BL for the others and for --fft-backend
    bluestein; the windowed counter where it has a window), with the hop
    its golden assumes."""
    label, key, N, repeats, hop, window, matrix, extra = drive
    backend = (extra[extra.index("--fft-backend") + 1]
               if "--fft-backend" in extra else "auto")
    route = spectral.transform_route(N, backend)
    assert route == {"ML": "mixed_large", "BL": "chirp_large"}[key[:2]]
    assert (window is not None) == key.endswith("windowed") \
        == ("--window-function" in extra)
    assert hop == (N // 2 if "--welch-overlap" in extra else N)
    assert repeats >= 8 and f"-b {N}" in label
