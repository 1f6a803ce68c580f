"""The PyTorch package's whole session against the JAX package's.

Both sessions read the same synthetic bytes (the source is deterministic
and invariant to read chunking). The JAX side runs its Pallas kernel in
interpret mode (``--fft-backend pallas``); the port runs on the CPU, so
its step is the kernel's plain PyTorch version. Text headers, frequencies,
``.met`` files (timestamps masked) and stderr printouts must match byte
for byte; spectra must agree within 1e-5 relative in linear power, or,
under ``--precision high``, within the relaxed tier's RELAXED_RTOL: both
sides run the fast bf16-split scheme, but at different N1 x N2 splits
(the JAX kernel's 128-lane rule against the port's tensor-core rule), so
their f32 rounding differs.
"""

import io
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import rtl_power_fftw_tpu.interrupts as interrupts
from rtl_power_fftw_tpu.auxdata import AuxData, make_window
from rtl_power_fftw_tpu.config import parse_args
from rtl_power_fftw_tpu.exceptions import RPFexception
from rtl_power_fftw_tpu.session import run_session as jax_run_session
from rtl_power_fftw_tpu.sources.registry import open_device
from rtl_power_fftw_tpu_torch.session import run_session

from golden import golden_accumulate, golden_finalize

CPU = torch.device("cpu")
TONE_DRIVE = ["-f", "100M", "-n", "50", "-b", "512", "--frames-per-step", "16",
              "--fft-backend", "pallas",
              "--source", "synthetic:tone=100.2M/35,noise=6,seed=1"]
SCAN_DRIVE = ["-f", "100M:106M", "-n", "16", "-b", "256", "-q",
              "--frames-per-step", "8", "--fft-backend", "pallas",
              "--source", "synthetic:tone=104.9M/40,noise=5,seed=2,dead=103M"]
LINEAR_RTOL = 1e-5
# tests/test_kernels.py:144 holds the fast kernel to 1e-4 of the golden.
RELAXED_RTOL = 1e-4
TIMESTAMP = re.compile(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d UTC")
MESH_SIZE = re.compile(r"\(mesh size \d+\)")


@pytest.fixture(autouse=True)
def _reset_interrupts():
    interrupts.reset()
    yield
    interrupts.reset()


def run(argv, port: bool):
    params = parse_args(argv, stderr=io.StringIO())
    aux = AuxData(params, stderr=io.StringIO())
    source = open_device(params)
    out, err = io.StringIO(), io.StringIO()
    kwargs = {"device": CPU} if port else {}
    fn = run_session if port else jax_run_session
    rv = fn(params, source, aux, stdout=out, stderr=err, install_sigint=False,
            **kwargs)
    return rv, out.getvalue(), err.getvalue()


def last_digit_unit(text: str) -> float:
    """One unit in the last printed digit of a decimal number."""
    mant, _, exp = text.lower().partition("e")
    decimals = len(mant.partition(".")[2])
    return 10.0 ** (int(exp or 0) - decimals)


def assert_text_outputs_match(jax_out: str, port_out: str,
                              linear: bool = False,
                              rtol: float = LINEAR_RTOL) -> int:
    """Returns the number of spectrum values compared. ``rtol`` is
    relative in linear power (converted to dB unless ``linear``)."""
    db_tol = 10.0 * np.log10(1.0 + rtol)
    a, b = jax_out.split("\n"), port_out.split("\n")
    assert len(a) == len(b)
    n_values = 0
    for x, y in zip(a, b):
        if x.startswith("#") or not x:
            assert TIMESTAMP.sub("<t>", x) == TIMESTAMP.sub("<t>", y)
            continue
        (fx, vx), (fy, vy) = x.split(), y.split()
        assert fx == fy
        # Each side is rounded to six significant digits when printed.
        tol = (rtol * abs(float(vx)) if linear else db_tol) \
            + max(last_digit_unit(vx), last_digit_unit(vy))
        assert abs(float(vx) - float(vy)) <= tol, (x, y)
        n_values += 1
    return n_values


def _mask_line(line: str) -> str:
    if line.startswith("Buffer queue histogram:"):
        # Which bucket a grab lands in depends on thread timing; the
        # bucket count and the number of grabs do not.
        counts = [int(v) for v in line.split(":")[1].split()]
        return f"Buffer queue histogram: {len(counts)} buckets, {sum(counts)}"
    # The JAX package spreads --streams over its 8-device CPU mesh; the
    # port runs them on one device.
    line = MESH_SIZE.sub("(mesh size M)", line)
    return TIMESTAMP.sub("<t>", line)


def mask_stderr(err: str) -> list:
    # The transform-path line names each package's own step.
    return [_mask_line(line) for line in err.splitlines()
            if not line.startswith("Transform path:")]


@pytest.mark.parametrize("extra", ["", "linear", "baseline"])
def test_tone_drive_matches_jax_session(extra, tmp_path):
    argv = list(TONE_DRIVE)
    if extra == "linear":
        argv.append("-l")
    elif extra == "baseline":
        base = tmp_path / "baseline.dat"
        base.write_text("\n".join(f"{-40.0 + 0.01 * i:.4f}"
                                   for i in range(512)))
        argv += ["-B", str(base)]
    rv_j, out_j, err_j = run(argv, port=False)
    rv_p, out_p, err_p = run(argv, port=True)
    assert int(rv_j) == int(rv_p) == 0
    assert assert_text_outputs_match(out_j, out_p, linear=extra == "linear")
    assert mask_stderr(err_j) == mask_stderr(err_p)
    assert "Transform path: plain (backend=pallas, N=512)" in err_p


def test_tone_drive_matches_golden():
    N, repeats, rate = 512, 50, 2_000_000
    rv, out, _ = run(TONE_DRIVE, port=True)
    assert rv == 0
    params = parse_args(TONE_DRIVE, stderr=io.StringIO())
    src = open_device(params)
    src.set_sample_rate(rate)
    src.set_frequency(100_000_000)
    stream, _ = src.read(2 * N * repeats)
    pwr, done = golden_accumulate(stream, N, repeats)
    want = golden_finalize(pwr, done, rate)
    got = np.array([float(line.split()[1]) for line in out.split("\n")
                    if line and not line.startswith("#")])
    # Text output has 6 significant digits; compare at that precision.
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)


def test_scan_matrix_drive_matches_jax_session(tmp_path):
    outs = {}
    for port in (False, True):
        stem = str(tmp_path / ("port" if port else "jax"))
        rv, out, err = run(SCAN_DRIVE + ["-m", stem], port=port)
        assert rv == 0
        assert "Unable to tune to 103000000. Dropping from frequency list." in err
        with open(stem + ".met") as f:
            met = f.read().split("\n")
        outs[port] = (out, mask_stderr(err), met,
                      np.fromfile(stem + ".bin", dtype=np.float32))
    (out_j, err_j, met_j, bin_j), (out_p, err_p, met_p, bin_p) = \
        outs[False], outs[True]
    assert out_j == out_p          # matrix mode: only the set separator
    assert err_j == err_p
    # avgScanDur (line 7) is derived from the second-resolution timestamps.
    assert [TIMESTAMP.sub("<t>", m) for i, m in enumerate(met_j) if i != 6] \
        == [TIMESTAMP.sub("<t>", m) for i, m in enumerate(met_p) if i != 6]
    assert met_p[0] == "512 # frequency bins (columns)"
    assert bin_j.shape == bin_p.shape == (512,)
    np.testing.assert_allclose(10.0 ** (bin_p / 10.0), 10.0 ** (bin_j / 10.0),
                               rtol=LINEAR_RTOL)


def test_record_and_stitch_outputs_match_jax_session(tmp_path):
    files = {}
    for port in (False, True):
        d = tmp_path / ("port" if port else "jax")
        d.mkdir()
        rv, _, _ = run(SCAN_DRIVE + ["-m", str(d / "m"), "--record",
                                    str(d / "iq.raw"), "--stitch-out",
                                    str(d / "stitch.dat")], port=port)
        assert rv == 0
        files[port] = ((d / "iq.raw").read_bytes(),
                       (d / "stitch.dat").read_text().splitlines())
    (rec_j, stitch_j), (rec_p, stitch_p) = files[False], files[True]
    # Two live hops, each read rounded up to 16384 bytes.
    assert rec_p == rec_j and len(rec_p) == 2 * 16384
    assert stitch_p[0] == stitch_j[0] == "# stitched spectrum: 2 hops, 512 bins"
    assert len(stitch_p) == len(stitch_j)


def test_stats_json_one_record_per_scan(tmp_path):
    stats = tmp_path / "stats.jsonl"
    rv, _, _ = run(SCAN_DRIVE + ["-m", str(tmp_path / "m"),
                                 "--stats-json", str(stats)], port=True)
    assert rv == 0
    records = [json.loads(line) for line in stats.read_text().splitlines()]
    assert [r["tuned_freq"] for r in records] == [101_000_000, 105_000_000]
    assert all(r["transform_path"] == "plain" and r["repeats_done"] == 16
               for r in records)


def test_unwritable_stats_json_is_invalid_input(tmp_path):
    with pytest.raises(RPFexception) as e:
        run(TONE_DRIVE + ["--stats-json", str(tmp_path / "no" / "s.jsonl")],
            port=True)
    assert int(e.value.return_value) == 5


def outcome(argv, port: bool):
    """(result, stdout, masked stderr) of one session; a typed failure is
    (exit code, message)."""
    try:
        rv, out, err = run(argv, port=port)
    except RPFexception as e:
        return (int(e.return_value), str(e)), "", []
    return int(rv), out, mask_stderr(err)


def _aux_file(tmp_path, name, values):
    p = tmp_path / name
    p.write_text("\n".join(f"{v:.9g}" for v in values) + "\n")
    return str(p)


def _file_source(tmp_path, n_bytes):
    p = tmp_path / "stream.iq"
    np.random.default_rng(8).integers(0, 256, n_bytes, dtype=np.uint8) \
        .tofile(p)
    return f"file:{p}"


SCENARIOS = {
    "dropped samples": lambda tmp: [
        "-f", "100M", "-n", "40", "-b", "256", "-s", "16384",
        "--source", "synthetic:tone=100.1M/30,noise=5,seed=4,drop_every=2"],
    "every hop dead": lambda tmp: [
        "-f", "100M", "-n", "8", "-b", "256",
        "--source", "synthetic:noise=5,dead=100M"],
    "stream ends mid-spectrum": lambda tmp: [
        "-f", "100M", "-n", "100", "-b", "256",
        "--source", _file_source(tmp, 2 * 256 * 30 + 100)],
    "stream too short": lambda tmp: [
        "-f", "100M", "-n", "10", "-b", "256",
        "--source", _file_source(tmp, 300)],
    "welch overlap": lambda tmp: [
        "-f", "100M", "-n", "30", "-b", "256", "--welch-overlap", "50",
        "--source", "synthetic:tone=100.3M/30,noise=5,seed=5"],
    "hop overlap, ppm, gain": lambda tmp: [
        "-f", "100M:103M", "-o", "20", "-p", "3", "-g", "150", "-n", "8",
        "-b", "128", "--source", "synthetic:tone=101.5M/30,noise=5,seed=6"],
    "quiet hops": lambda tmp: [
        "-f", "100M:106M", "-q", "-n", "8", "-b", "64",
        "--source", "synthetic:noise=5,seed=7"],
    "integration time": lambda tmp: [
        "-f", "1M", "-t", "0.1", "-b", "128", "-r", "100000",
        "--source", "synthetic:noise=5,seed=9"],
    "small buffers": lambda tmp: [
        "-f", "100M", "--buffers", "2", "-s", "32768", "-n", "100",
        "-b", "512", "--source", "synthetic:tone=99.5M/30,noise=5,seed=9"],
    "hann window": lambda tmp: [
        "-f", "100M", "-n", "30", "-b", "512", "--window-function", "hann",
        "--source", "synthetic:tone=100.3M/35,noise=5,seed=12"],
    "window file (-w)": lambda tmp: [
        "-f", "100M", "-n", "24", "-b", "256",
        "-w", _aux_file(tmp, "blackman.txt", make_window("blackman", 256)),
        "--source", "synthetic:tone=99.7M/30,noise=5,seed=13"],
    # BASELINE config 2's shape (Welch 50%, Hann, baseline) at N = 1024.
    "welch + hann + baseline": lambda tmp: [
        "-f", "100M", "-n", "40", "-b", "1024", "--window-function", "hann",
        "--welch-overlap", "50",
        "-B", _aux_file(tmp, "base.dat",
                        [-60.0 + 0.003 * i for i in range(1024)]),
        "--source", "synthetic:tone=100.2M/35,noise=6,seed=1"],
    "precision high": lambda tmp: [
        "-f", "100M", "-n", "30", "-b", "512", "--precision", "high",
        "--source", "synthetic:tone=100.3M/35,noise=5,seed=14"],
    "precision high + hann": lambda tmp: [
        "-f", "100M", "-n", "30", "-b", "1024", "--precision", "high",
        "--window-function", "hann",
        "--source", "synthetic:tone=100.4M/35,noise=5,seed=15"],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax_session(name, tmp_path):
    argv = SCENARIOS[name](tmp_path) + ["--frames-per-step", "16"]
    if int(argv[argv.index("-b") + 1]) >= 256:
        # The JAX Pallas kernel (interpret mode) takes N >= 256; below
        # that the JAX side runs its CPU FFT rung.
        argv += ["--fft-backend", "pallas"]
    res_j, out_j, err_j = outcome(argv, port=False)
    res_p, out_p, err_p = outcome(argv, port=True)
    assert res_p == res_j
    rtol = RELAXED_RTOL if "--precision" in argv else LINEAR_RTOL
    n_values = assert_text_outputs_match(out_j, out_p, rtol=rtol)
    assert n_values > 0 or isinstance(res_j, tuple)
    assert err_p == err_j


@pytest.mark.parametrize("n_interrupts,argv,said", [
    (1, ["-f", "1M", "-n", "4", "-b", "64", "-c",
         "--source", "synthetic:noise=5,seed=10"],
     "Interrupted, will try to finish this pass."),
    (2, ["-f", "100M:110M", "-n", "4", "-b", "64",
         "--source", "synthetic:noise=5,seed=11"],
     "Interrupted, finishing now."),
])
def test_interrupts_match_jax_session(n_interrupts, argv, said):
    results = []
    for port in (False, True):
        interrupts.reset()
        for _ in range(n_interrupts):
            interrupts.raise_interrupt()
        results.append(outcome(argv, port=port))
    (res_j, out_j, err_j), (res_p, out_p, err_p) = results
    assert res_p == res_j == 0
    assert assert_text_outputs_match(out_j, out_p) == 64
    assert err_p == err_j and said in err_p


def test_met_sidecar_matches_golden_fixture(tmp_path, monkeypatch):
    """tests/test_met_golden.py's frozen-clock 2-hop matrix session,
    byte-compared against the same checked-in fixture."""
    import time
    from rtl_power_fftw_tpu.sources import SyntheticSource

    epoch = 1_767_323_045  # 2026-01-02 03:04:05 UTC
    calls = {"n": 0}

    def fake_time():
        calls["n"] += 1
        return float(epoch + calls["n"])

    fixed_struct = time.gmtime(epoch)
    monkeypatch.setattr(time, "time", fake_time)
    monkeypatch.setattr(time, "gmtime", lambda *a: fixed_struct)

    base = str(tmp_path / "gold")
    params = parse_args(
        ["-f", "100M:104M", "-n", "10", "-b", "64", "-r", "2048000",
         "-m", base, "--source", "synthetic:"], stderr=io.StringIO())
    src = SyntheticSource(tones=[(101_000_000, 30.0)], noise=5.0, seed=11)
    aux = AuxData(params, stderr=io.StringIO())
    rv = run_session(params, src, aux, device=CPU, stdout=io.StringIO(),
                     stderr=io.StringIO(), install_sigint=False)
    assert rv == 0
    fixture = Path(__file__).parent / "fixtures" / "golden_session.met"
    assert Path(base + ".met").read_bytes() == fixture.read_bytes()
    bin_data = np.fromfile(base + ".bin", dtype=np.float32)
    assert bin_data.shape == (128,) and np.isfinite(bin_data).all()
