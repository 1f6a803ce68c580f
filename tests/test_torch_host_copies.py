"""The PyTorch package's own host modules against the JAX package's
originals, and that the port imports neither jax nor the JAX package.

The port keeps copies of ``exceptions``, ``config``, ``planning``,
``auxdata``, ``interrupts``, ``output``, ``utils``, ``sources`` and
``native``. Each copy must behave as its original on the same input:
equal ``Params`` fields or the same exit code and message, the same hop
plans, writer bytes, source bytes, loader bytes, stitched spectra and
windows. Everything here is exact.
"""

import ast
import contextlib
import dataclasses
import io
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from rtl_power_fftw_tpu import auxdata as j_auxdata
from rtl_power_fftw_tpu import config as j_config
from rtl_power_fftw_tpu import exceptions as j_exceptions
from rtl_power_fftw_tpu import planning as j_planning
from rtl_power_fftw_tpu.native import binding as j_binding
from rtl_power_fftw_tpu.output import matrix as j_matrix
from rtl_power_fftw_tpu.output import stats as j_stats
from rtl_power_fftw_tpu.output import text as j_text
from rtl_power_fftw_tpu.sources import file as j_file
from rtl_power_fftw_tpu.sources import registry as j_registry
from rtl_power_fftw_tpu.utils import stitch as j_stitch
from rtl_power_fftw_tpu_torch import auxdata, config, exceptions, planning
from rtl_power_fftw_tpu_torch.native import binding
from rtl_power_fftw_tpu_torch.output import matrix, stats, text
from rtl_power_fftw_tpu_torch.sources import file as file_source
from rtl_power_fftw_tpu_torch.sources import registry
from rtl_power_fftw_tpu_torch.utils import stitch

from test_cli_fuzz import FLAG_POOL

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "rtl_power_fftw_tpu_torch"


def parse_outcome(parse_args, argv):
    """(kind, value, stdout, stderr) of one parse: the Params fields, or
    the exit code and message of an RPFexception or SystemExit."""
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            params = parse_args(argv, stderr=err)
    except (exceptions.RPFexception, j_exceptions.RPFexception) as e:
        return ("error", (int(e.return_value), str(e)), out.getvalue(),
                err.getvalue())
    except SystemExit as e:
        return ("exit", e.code, out.getvalue(), err.getvalue())
    return ("params", dataclasses.asdict(params), out.getvalue(),
            err.getvalue())


def _argv_cases():
    cases = [list(flag) for flag in FLAG_POOL]
    rng = random.Random(20261016)
    for _ in range(24):
        argv = []
        for _ in range(rng.randint(2, 5)):
            argv += rng.choice(FLAG_POOL)
        cases.append(argv)
    cases += [["-b", "501"], ["-s", "20000"], ["-b", "1001", "-s", "20000"],
              ["-f", "100M:110M"], ["-f", "110M:100M"], ["-f", "110M:"],
              ["-f", "1420405752"], ["-n", "10", "-t", "5"], ["-T"],
              ["-m", "myscan"], ["-e", "5m"],
              ["-w", "foo.dat", "--window-function", "hann"],
              ["-b", "1048576", "-t", "10", "-l"], ["--help"], ["--version"]]
    return cases


ARGV_CASES = _argv_cases()


@pytest.mark.parametrize("argv", ARGV_CASES,
                         ids=[" ".join(a) or "empty" for a in ARGV_CASES])
def test_parse_args_matches_original(argv):
    assert (parse_outcome(config.parse_args, argv)
            == parse_outcome(j_config.parse_args, argv))


def test_version_prints_the_same_bytes():
    ours = parse_outcome(config.parse_args, ["--version"])
    theirs = parse_outcome(j_config.parse_args, ["--version"])
    assert ours == theirs == ("exit", 0, "rtl_power_fftw_tpu 0.2.0\n", "")


@pytest.mark.parametrize("argv,rate", [
    (["-f", "100M:110M"], 2_048_000),
    (["-f", "144M:146M"], 2_000_000),
    (["-f", "100M:103M", "-o", "20"], 2_400_000),
    (["-f", "88M:108M", "-o", "35", "-n", "7"], 2_048_000),
    (["-f", "100M:100.5M"], 2_048_000),
    (["-f", "1G", "-t", "3"], 1_000_000),
    (["-f", "50M", "-n", "0"], 2_048_000),
])
def test_plan_matches_original(argv, rate):
    ours = config.parse_args(argv, stderr=io.StringIO())
    theirs = j_config.parse_args(argv, stderr=io.StringIO())
    plan, j_plan = planning.Plan(ours, rate), j_planning.Plan(theirs, rate)
    assert plan.freqs_to_tune == j_plan.freqs_to_tune
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    a, b = io.StringIO(), io.StringIO()
    plan.print(file=a)
    j_plan.print(file=b)
    assert a.getvalue() == b.getvalue()


def _spectrum(seed, n=64):
    rng = np.random.default_rng(seed)
    freqs = 100e6 + (np.arange(n) - n / 2) * 2.048e6 / n
    return freqs, rng.normal(-50.0, 7.0, n)


def test_text_writer_bytes_match_original():
    outs = []
    for module in (text, j_text):
        out = io.StringIO()
        w = module.TextWriter(out)
        for seed, tuned in ((1, 100_000_000), (2, 101_234_567)):
            freqs, values = _spectrum(seed)
            w.write_spectrum(freqs, values, "2026-01-02 03:04:05 UTC",
                             "2026-01-02 03:04:06 UTC", tuned, 2_048_000, 64)
        w.end_measurement_set()
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and outs[0].startswith("# rtl-power-fftw")


def test_matrix_writer_and_stats_bytes_match_original(tmp_path):
    outs = []
    for name, m_mod, s_mod in (("port", matrix, stats),
                               ("jax", j_matrix, j_stats)):
        st = s_mod.SessionStats()
        base = tmp_path / name
        w = m_mod.MatrixWriter(f"{base}.bin", f"{base}.met", st)
        w.truncate()
        st.begin_scan("2026-01-02 03:04:05 UTC")
        for seed, tuned in ((3, 100_000_000), (4, 102_000_000)):
            w.append_row(_spectrum(seed)[1], tuned, 102_000_000)
        st.end_scan("2026-01-02 03:04:07 UTC")
        st.startFreq, st.endFreq, st.stepFreq = 98_976_000, 103_008_000, 32_000
        w.write_meta(64, 11, 2_048_000)
        outs.append((Path(f"{base}.bin").read_bytes(),
                     Path(f"{base}.met").read_bytes(),
                     dataclasses.asdict(st)))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("spec", [
    "synthetic:tone=100.2M/35,noise=6,seed=1",
    "synthetic:tone=104.9M/40,noise=5,seed=2,dead=103M",
    "synthetic:noise=5,seed=4,drop_every=2",
])
def test_synthetic_source_bytes_match_original(spec):
    reads = []
    for reg in (registry, j_registry):
        src = reg.make_source(spec, 2_000_000)
        src.set_frequency(100_000_000)
        got = [src.read(n) for n in (16384, 1000, 65536, 16384)]
        reads.append([(bytes(b), ok) for b, ok in got])
        src.close()
    assert reads[0] == reads[1]
    # Extra streams of one spec (--streams) get the same seeds.
    a = registry.make_sources(spec, 3, 2_000_000)
    b = j_registry.make_sources(spec, 3, 2_000_000)
    for x, y in zip(a, b):
        x.set_frequency(100_000_000)
        y.set_frequency(100_000_000)
        assert bytes(x.read(4096)[0]) == bytes(y.read(4096)[0])


def _recorded(tmp_path, n_bytes=300_000):
    p = tmp_path / "rec.iq"
    data = np.random.default_rng(17).integers(0, 256, n_bytes,
                                              dtype=np.uint8)
    p.write_bytes(data.tobytes())
    return p, data


def _read_all(src, size):
    chunks = []
    while True:
        try:
            buf, ok = src.read(size)
        except (exceptions.StreamEOF, j_exceptions.StreamEOF) as eof:
            if eof.partial is not None:
                chunks.append(np.asarray(eof.partial).copy())
            return np.concatenate(chunks)
        assert ok
        chunks.append(np.asarray(buf).copy())


@pytest.mark.parametrize("use_native", [False, True])
def test_file_source_bytes_match_original(tmp_path, use_native):
    p, data = _recorded(tmp_path)
    got = []
    for mod in (file_source, j_file):
        src = mod.FileSource(str(p), use_native=use_native)
        got.append(_read_all(src, 16384))
        src.close()
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], data)


def _native_available(mod) -> bool:
    """mod.native_available(), retried while another test process may
    still be writing the library it builds on first use."""
    for _ in range(20):
        try:
            return mod.native_available()
        except OSError:
            time.sleep(0.5)
    return mod.native_available()


def test_native_loader_builds_from_the_ports_source_and_reads_the_same(
        tmp_path):
    assert Path(binding._SRC).parent == PORT / "native"
    assert Path(binding._SRC).read_bytes() == Path(j_binding._SRC).read_bytes()
    if not (_native_available(binding) and _native_available(j_binding)):
        pytest.skip("no C++ toolchain for the native loader")
    assert Path(binding._SO).parent == PORT / "native"
    p, data = _recorded(tmp_path)
    got = []
    for mod in (binding, j_binding):
        fd = os.open(str(p), os.O_RDONLY)
        try:
            with mod.NativeLoader(buf_bytes=16384, n_buffers=4) as ld:
                ld.start_fd(fd)
                chunks = []
                while (item := ld.acquire(timeout_ms=5000)) is not None:
                    chunks.append(item[1].copy())
                    ld.release(item[0])
                got.append(np.concatenate(chunks))
        finally:
            os.close(fd)
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], data)


@pytest.mark.parametrize("db", [True, False])
def test_merge_spectra_matches_original(db):
    hops = []
    for h, center in enumerate((100_000_000, 101_600_000, 103_100_000)):
        freqs = center + (np.arange(128) - 64) * 2_048_000 / 128
        vals = np.random.default_rng(h).normal(-40 if db else 1e-3,
                                               3 if db else 1e-4, 128)
        hops.append((freqs, vals))
    ours = stitch.merge_spectra(hops, db=db)
    theirs = j_stitch.merge_spectra(hops, db=db)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_parse_text_matches_original():
    out = io.StringIO()
    w = j_text.TextWriter(out)
    for seed in (5, 6):
        freqs, values = _spectrum(seed)
        w.write_spectrum(freqs, values, "t0", "t1", 100_000_000, 2_048_000,
                         64)
    w.end_measurement_set()
    ours = stitch.parse_text(io.StringIO(out.getvalue()))
    theirs = j_stitch.parse_text(io.StringIO(out.getvalue()))
    assert len(ours) == len(theirs) == 1
    for (fa, va), (fb, vb) in zip(ours[0], theirs[0]):
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("name", sorted(j_auxdata.WINDOW_FUNCTIONS))
def test_make_window_matches_original(name):
    assert sorted(auxdata.WINDOW_FUNCTIONS) == sorted(
        j_auxdata.WINDOW_FUNCTIONS)
    for n in (64, 2048, 32768):
        ours, theirs = auxdata.make_window(name, n), j_auxdata.make_window(
            name, n)
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


def test_exceptions_carry_the_same_codes():
    assert ({m.name: int(m) for m in exceptions.ReturnValue}
            == {m.name: int(m) for m in j_exceptions.ReturnValue})
    e = exceptions.TuneError(103_000_000)
    f = j_exceptions.TuneError(103_000_000)
    assert (str(e), e.frequency()) == (str(f), f.frequency())
    e = exceptions.RPFexception("m", exceptions.ReturnValue.InvalidInput)
    f = j_exceptions.RPFexception("m", j_exceptions.ReturnValue.InvalidInput)
    assert (str(e), int(e.return_value)) == (str(f), int(f.return_value))


def _imported_names(path: Path):
    """Top-level module names of every import in ``path``, including
    importlib.import_module("...") and __import__("...") on literals."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr",
                          getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value


PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_the_jax_package(path):
    bad = sorted({name for name in _imported_names(path)
                  if name.split(".")[0] in ("jax", "jaxlib",
                                            "rtl_power_fftw_tpu")})
    assert bad == []


def test_ast_scan_sees_an_import_of_the_jax_package(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import importlib\n"
                 "from rtl_power_fftw_tpu.config import parse_args\n"
                 "def f():\n    import jax.numpy\n"
                 "    importlib.import_module('rtl_power_fftw_tpu.ops')\n"
                 "from . import rtl_power_fftw_tpu_torch\n")
    assert sorted(_imported_names(p)) == [
        "importlib", "jax.numpy", "rtl_power_fftw_tpu.config",
        "rtl_power_fftw_tpu.ops"]


def test_port_modules_leave_jax_and_the_jax_package_unimported():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    code = (
        "import sys\n"
        "import rtl_power_fftw_tpu_torch.cli, rtl_power_fftw_tpu_torch.session\n"
        "import rtl_power_fftw_tpu_torch.models\n"
        "import rtl_power_fftw_tpu_torch.parallel\n"
        "import rtl_power_fftw_tpu_torch.native\n"
        "import rtl_power_fftw_tpu_torch.utils.stitch\n"
        "from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_large\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'ml_dtypes', 'rtl_power_fftw_tpu')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
