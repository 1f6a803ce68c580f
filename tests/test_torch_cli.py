"""The PyTorch package's command line: exit codes, unported options, and
that importing and running it never imports jax."""

import os
import subprocess
import sys

import pytest
import torch

import rtl_power_fftw_tpu_torch.interrupts as interrupts
from rtl_power_fftw_tpu_torch import cli
from rtl_power_fftw_tpu_torch.ops.kernels._build import KernelBuildError
from rtl_power_fftw_tpu_torch.ops.kernels.fused_psd import KernelLaunchError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SMALL = ["-f", "100M", "-n", "4", "-b", "256",
         "--source", "synthetic:tone=100.05M/30,noise=5,seed=1"]


@pytest.fixture(autouse=True)
def _reset_interrupts():
    interrupts.reset()
    yield
    interrupts.reset()


def test_no_cuda_device_exits_7(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(SMALL) == 7
    assert "No CUDA device available" in capsys.readouterr().err


@pytest.mark.parametrize("extra", [
    ["--shard-transform"],
    ["-b", "4194302", "--sk-file", "sk.dat"],
    ["-b", "2097154", "--sk-file", "sk.dat", "--fft-backend", "bluestein"],
    ["--sk-excise", "3", "--fft-backend", "xla"],
    ["--fft-backend", "fourstep"],
    ["--fft-backend", "xla", "--window-function", "hann"],
    ["--precision", "high", "-b", "128"],
    ["--profile", "trace"],
    ["--fft-backend", "matmul"],
    ["--streams", "2", "--shard-transform"],
    ["--streams", "2", "--fft-backend", "xla"],
    ["--streams", "2", "--multitaper", "7", "-b", "4194302"],
    ["--streams", "2", "--sk-file", "sk.dat", "--fft-backend", "xla", "-b",
     "500"],
    ["-b", "4194306", "--multitaper", "7"],
])
def test_unported_options_exit_3(extra, capsys):
    assert cli.main(SMALL + extra, device=CPU) == 3
    assert "Not yet ported" in capsys.readouterr().err


@pytest.mark.parametrize("extra,path", [
    (["--window-function", "hann"], "plain"),
    (["--precision", "high"], "plain_fast"),
    (["--precision", "high", "--window-function", "blackman"], "plain_fast"),
    (["--streams", "4"], "plain"),
    (["--streams", "2", "--window-function", "hann"], "plain"),
])
def test_windowed_and_relaxed_sessions_exit_0(extra, path, capsys):
    assert cli.main(SMALL + extra, device=CPU) == 0
    captured = capsys.readouterr()
    assert captured.out.startswith("# rtl-power-fftw output\n")
    assert f"Transform path: {path} " in captured.err


@pytest.mark.parametrize("extra,path", [
    (["--pfb-taps", "4"], "plain_pfb (N=256)"),
    (["--multitaper", "2"], "plain_multitaper (N=256)"),
    (["--sk-file", "sk.dat"], "plain_sk (backend=auto, N=256)"),
    (["--sk-excise", "3"], "plain_sk (backend=auto, N=256)"),
    (["--streams", "2", "--pfb-taps", "4"], "plain_pfb (N=256)"),
    (["--streams", "2", "--multitaper", "2"], "plain_multitaper (N=256)"),
    (["--streams", "2", "--sk-file", "sk.dat"],
     "plain_sk (backend=auto, N=256)"),
    (["--streams", "2", "--sk-excise", "3"],
     "plain_sk (backend=auto, N=256)"),
    (["-b", "500", "--multitaper", "2"], "plain_multitaper (N=500)"),
    (["-b", "32", "--pfb-taps", "4"], "plain_pfb (N=32)"),
    (["-b", "998", "--sk-file", "sk.dat"], "plain_sk (backend=auto, N=998)"),
    (["-b", "2048", "--sk-file", "sk.dat", "--fft-backend", "bluestein"],
     "plain_sk (backend=bluestein, N=2048)"),
    (["--streams", "2", "--sk-file", "sk.dat", "-b", "998"],
     "plain_sk (backend=auto, N=998)"),
    (["--streams", "2", "--sk-file", "sk.dat", "-b", "500"],
     "plain_sk (backend=auto, N=500)"),
    (["--streams", "2", "--pfb-taps", "4", "-b", "500"], "plain_pfb (N=500)"),
    (["-b", "32768", "--sk-file", "sk.dat"],
     "plain_sk (backend=auto, N=32768)"),
    (["-b", "20002", "--sk-file", "sk.dat"],
     "plain_sk (backend=auto, N=20002)"),
    (["-b", "100000", "--sk-file", "sk.dat"],
     "plain_sk (backend=auto, N=100000)"),
    (["--streams", "2", "--multitaper", "7", "-b", "20000"],
     "plain_multitaper (N=20000)"),
    (["-b", "20000", "--multitaper", "7"], "plain_multitaper (N=20000)"),
])
def test_single_stream_estimators_exit_0(extra, path, capsys, tmp_path,
                                         monkeypatch):
    """The four estimator options run their kernels' path, on one stream
    and over ``--streams``, at the powers of two and the awkward bin counts
    (on the CPU, the plain versions)."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(SMALL + extra, device=CPU) == 0
    captured = capsys.readouterr()
    assert captured.out.startswith("# rtl-power-fftw output\n")
    assert f"Transform path: {path}\n" in captured.err
    if "--sk-file" in extra:
        assert (tmp_path / "sk.dat").read_text().startswith(
            "# rtl-power-fftw spectral kurtosis\n")


@pytest.mark.parametrize("bins,rc", [("8194", 0), ("8388608", 3),
                                     ("4194302", 3)])
def test_ineligible_bins_exit_3(bins, rc, capsys):
    """8194 bins run on the large chirp-Z kernel's path; bins above 2^22,
    and non-7-smooth bins above 2^21, still exit 3."""
    assert cli.main(["-f", "100M", "-n", "4", "-b", bins, "--source",
                     "synthetic:"], device=CPU) == rc
    err = capsys.readouterr().err
    assert f"{bins} bins" in err if rc else \
        f"Transform path: plain_chirp_large (backend=auto, N={bins})" in err


def test_parse_error_exits_4(capsys):
    assert cli.main(["--no-such-option"], device=CPU) == 4


def test_cpu_session_exits_0(capsys):
    assert cli.main(SMALL, device=CPU) == 0
    out = capsys.readouterr().out
    assert out.startswith("# rtl-power-fftw output\n")


@pytest.mark.parametrize("error,code", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), 7),
    (KernelLaunchError("fused_psd launch failed"), 7),
    (KernelBuildError("nvcc failed on fused_psd_mixed.cu"), 7),
])
def test_device_runtime_errors_exit_7(monkeypatch, capsys, error, code):
    def fail(*args, **kwargs):
        raise error

    monkeypatch.setattr(cli, "run_session", fail)
    assert cli.main(SMALL, device=CPU) == code
    assert "Device runtime error" in capsys.readouterr().err


def test_plain_runtime_error_is_not_a_device_error(monkeypatch):
    def fail(*args, **kwargs):
        raise RuntimeError("a bug")

    monkeypatch.setattr(cli, "run_session", fail)
    with pytest.raises(RuntimeError, match="a bug"):
        cli.main(SMALL, device=CPU)


def _python(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def _imports_of_a_cpu_session(argv) -> subprocess.CompletedProcess:
    """Runs cli.main(argv) on the CPU in a fresh interpreter; prints the
    exit code and every jax module imported."""
    return _python(
        "-c",
        "import io, sys, contextlib, torch\n"
        "import rtl_power_fftw_tpu_torch\n"
        "from rtl_power_fftw_tpu_torch.cli import main\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        f"    rc = main({argv!r}, device=torch.device('cpu'))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes'))\n"
        "print(rc, bad)\n")


def test_port_never_imports_jax():
    proc = _imports_of_a_cpu_session(SMALL)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "0 []"


def test_streams_session_never_imports_jax():
    proc = _imports_of_a_cpu_session(SMALL + ["--streams", "3"])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "0 []"


def test_estimator_sessions_never_import_jax(tmp_path):
    """One interpreter runs a session of each estimator (the SK file in a
    temporary directory), importing the estimator modules and kernels."""
    sk = str(tmp_path / "sk.dat")
    proc = _python(
        "-c",
        "import io, sys, contextlib, torch\n"
        "from rtl_power_fftw_tpu_torch.cli import main\n"
        "import rtl_power_fftw_tpu_torch.models\n"
        "rcs = []\n"
        f"for extra in ({['--pfb-taps', '4']!r}, {['--multitaper', '2']!r},\n"
        f"              {['--sk-file', sk, '--sk-excise', '3']!r}):\n"
        "    with contextlib.redirect_stdout(io.StringIO()), \\\n"
        "            contextlib.redirect_stderr(io.StringIO()):\n"
        f"        rcs.append(main({SMALL!r} + extra,\n"
        "                        device=torch.device('cpu')))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes')\n"
        "             or m.startswith('rtl_power_fftw_tpu.'))\n"
        "print(rcs, bad)\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[0, 0, 0] []"


def test_module_entry_point_without_cuda_exits_7():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _python("-m", "rtl_power_fftw_tpu_torch", *SMALL)
    assert proc.returncode == 7, proc.stderr
    assert "No CUDA device available" in proc.stderr


def _exit_code(argv):
    """In-process; argparse help/version raise SystemExit."""
    try:
        return cli.main(argv, device=CPU)
    except SystemExit as e:
        return e.code if e.code is not None else 0


@pytest.mark.parametrize("argv,code", [
    (["--help"], 0),
    (["--version"], 0),
    (["-n", "1"], 1),                                   # NoDeviceFound
    (["-d", "2", "--source", "synthetic:", "-n", "1", "-b", "64"], 2),
    (["-b", "-5"], 3),                                  # InvalidArgument
    (["--bogus-flag"], 4),                              # CLI parse error
    (["-B", "/does/not/exist", "-n", "1", "--source", "synthetic:"], 5),
    (["-w", "/does/not/exist", "-n", "1"], 5),           # as the JAX package
])
def test_exit_code_table(argv, code, capsys):
    assert _exit_code(argv) == code
