"""The large awkward-N kernels' launch shapes, measured on the card: BL's
three register passes (``ops/kernels/csrc/fused_psd_chirp_large.cu``)
and ML's two division-free passes (``csrc/fused_psd_mixed_large.cu``) as
shipped and in other builds, each a copy of the sources edited before
nvcc (:func:`build_sources`), or, for ``rows8``, another row shape of
ML's pass B in the wrapper:

* BL ``a1``, ``a2``: pass A held to one block an SM at every M, or to
  the large kernel's blocks (``LargeRegs::MIN_BLOCKS_A``); shipped, one at
  M = 2^17..2^19;
* BL ``b1``, ``b2``: pass B one or two blocks at every M; shipped, one at
  M2 = 512 and 1024;
* BL ``c1``, ``c2``: pass C one or two blocks at every M; shipped, one up
  to M = 2^20;
* ML ``cols2``: pass A held to two blocks an SM (128 registers); shipped,
  three (80);
* ML ``rows8``, ``rows16``: pass B at most 8 rows a block at every N2,
  or 16 wherever they fit; shipped, 16 up to N2 = 256
  (``fused_psd_mixed_large.rows_shape``).

At each N:F it prints one line a kernel: the device µs a call of each
build (calls queued behind a sleep kernel, the least of three runs),
twice in turns; then each form's and each control's device µs by pass
at 10^6:8 (ML) and 99998:64 (BL) from torch.profiler, whose records the
card has been seen to drop (the run is repeated until one holds every
launch, up to four times).

Run: ``python -m rtl_power_fftw_tpu_torch.probes.large_awkward_builds``.
Needs a CUDA card and nvcc; without a card it exits 1. The copies and
their libraries go to ``ops/kernels/build/large_awkward_builds/``.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..ops.kernels import _build
from ..ops.kernels import fused_psd_chirp_large as bl
from ..ops.kernels import fused_psd_mixed_large as ml
from ._timing import card
from .ring_layouts import device_us

BL_BOUNDS = {
    "a": "ChirpRegs<LOG2M>::MIN_BLOCKS_A)\nchirp_regs_a",
    "b": "ChirpRegs<LOG2M>::MIN_BLOCKS_B)\nchirp_regs_b",
    "c": "ChirpRegs<LOG2M>::MIN_BLOCKS_C)\nchirp_regs_c",
}
ML_COLS = "__launch_bounds__(kColsThreads, 3)\nml_cols_kernel"
#: Source edits of each build: (library, [(old, new)]).
BUILDS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "a1": ("fused_psd_chirp_large",
           [(BL_BOUNDS["a"], "1)\nchirp_regs_a")]),
    "a2": ("fused_psd_chirp_large",
           [(BL_BOUNDS["a"],
             "LargeRegs<LOG2M>::MIN_BLOCKS_A)\nchirp_regs_a")]),
    "b1": ("fused_psd_chirp_large", [(BL_BOUNDS["b"], "1)\nchirp_regs_b")]),
    "b2": ("fused_psd_chirp_large", [(BL_BOUNDS["b"], "2)\nchirp_regs_b")]),
    "c1": ("fused_psd_chirp_large", [(BL_BOUNDS["c"], "1)\nchirp_regs_c")]),
    "c2": ("fused_psd_chirp_large", [(BL_BOUNDS["c"], "2)\nchirp_regs_c")]),
    "cols2": ("fused_psd_mixed_large",
              [(ML_COLS, "__launch_bounds__(kColsThreads, 2)\n"
                         "ml_cols_kernel")]),
}
#: N:F (and a Hann window) of each kernel's timed shapes: phase 15's, and
#: BL at every M from 2^17 to 2^21.
BL_SHAPES = ((16382, 256, False), (20002, 256, True), (65538, 32, False),
             (99998, 64, False), (131070, 16, False), (262142, 16, False),
             (499998, 8, False), (999998, 8, False), (2 ** 21, 8, False))
ML_SHAPES = ((16464, 256, False), (20000, 256, True), (49152, 128, False),
             (100000, 64, False), (10 ** 6, 8, False), (4167450, 2, False))
#: The by-pass splits: N:F, the form's passes, the control's.
SPLITS = {"ML": (10 ** 6, 8, ["ml_cols_kernel", "ml_rows_kernel"],
                 ["tile_cols_kernel", "tile_power_kernel"]),
          "BL": (99998, 64, ["chirp_regs_a", "chirp_regs_b", "chirp_regs_c"],
                 ["tile_cols_kernel", "chirp_turn_kernel",
                  "tile_power_kernel"])}
SUMS = ["psd_rows_sum", "psd_sum_kernel"]


def build_sources(text: str, edits) -> str:
    """A library source's text with a build's edits; raises if the source
    no longer has exactly one of what an edit replaces."""
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"no single {old!r}")
        text = text.replace(old, new)
    return text


def build_all() -> Dict[str, ctypes.CDLL]:
    """Each build from its edited copy of the sources, one nvcc each, all
    at once."""
    root = _build.BUILD_DIR / "large_awkward_builds"
    procs = {}
    for name, (library, edits) in BUILDS.items():
        src = root / name
        if src.exists():
            shutil.rmtree(src)
        shutil.copytree(_build.CSRC, src)
        path = src / f"{library}.cu"
        path.write_text(build_sources(path.read_text(), edits))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(root / f"lib{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise _build.KernelBuildError(f"{name}: {err[-4000:]}")
        lib = ctypes.CDLL(str(root / f"lib{name}.so"))
        for fn, argtypes in _build.SIGNATURES[BUILDS[name][0]].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.rpf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rpf_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


_ROWS_SHAPE = ml.rows_shape


def rows8(n2: int, plan) -> Tuple[int, int]:
    """``rows_shape`` with at most 8 rows a block at every N2."""
    tf, lanes = _ROWS_SHAPE(n2, plan)
    while lanes > 8:
        tf, lanes = 2 * tf, lanes // 2
    return tf, lanes


def rows16(n2: int, plan) -> Tuple[int, int]:
    """``rows_shape`` with 16 rows a block wherever their two slots fit
    and a thread's last-pass sums stay within RING_ACC[-1]."""
    tf, lanes = _ROWS_SHAPE(n2, plan)
    while (lanes < 16 and tf > 16 and 32 * lanes * (n2 + 16) <= ml.TILE_SMEM
           and -(-(n2 // plan[-1]) // (tf // 2)) * plan[-1]
           <= ml.RING_ACC[-1]):
        tf, lanes = tf // 2, 2 * lanes
    return tf, lanes


def use(library: str, lib: ctypes.CDLL, rows=_ROWS_SHAPE) -> None:
    """Points a wrapper at ``lib`` and ML's layout at ``rows`` (plans,
    layouts and residency asked anew)."""
    _build._libs[library] = lib
    ml.rows_shape = rows
    for mod in (bl, ml):
        mod._plans.clear()
        mod.resident_blocks.cache_clear()
    ml.ml_layout.cache_clear()


def by_pass(fn: Callable[[], object], passes, calls: int = 10,
            tries: int = 4):
    """{kernel: (launches, device µs a launch)} of ``calls`` calls under
    torch.profiler: the first of ``tries`` runs in which each of
    ``passes`` shows ``calls`` launches, or None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0))
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        out = {}
        for m in list(passes) + SUMS:
            hit = [(n, us) for k, n, us in rows if m in k]
            n = sum(c for c, _ in hit)
            out[m] = (n, sum(us for _, us in hit) / max(n, 1))
        if all(out[m][0] == calls for m in passes):
            return out
    return None


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    libs = build_all()
    shipped = {name: _build.load(name) for name in
               ("fused_psd_chirp_large", "fused_psd_mixed_large")}
    print(f"# large awkward-N builds on {card(dev)}")
    rng = np.random.default_rng(0)
    for library, kernel, shapes, builds in (
            ("fused_psd_chirp_large", bl.fused_psd_chirp_large, BL_SHAPES,
             ["a1", "a2", "b1", "b2", "c1", "c2"]),
            ("fused_psd_mixed_large", ml.fused_psd_mixed_large, ML_SHAPES,
             ["cols2", "rows8", "rows16"])):
        for N, F, hann in shapes:
            raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                                dtype=np.uint8)).to(dev)
            w = (torch.from_numpy((0.5 - 0.5 * np.cos(
                2 * np.pi * np.arange(N) / N)).astype(np.float32)).to(dev)
                 if hann else None)
            times: Dict[str, List[float]] = {}
            for _ in range(2):
                for name in ["shipped"] + builds:
                    use(library, libs.get(name, shipped[library]),
                        {"rows8": rows8, "rows16": rows16}.get(
                            name, _ROWS_SHAPE))
                    times.setdefault(name, []).append(
                        device_us(lambda: kernel(raw, F, F, w)))
            use(library, shipped[library])
            print(f"{library} N={N} F={F} hann={hann}: " + ", ".join(
                f"{name} {min(t):.1f} us ({t[0]:.1f}/{t[1]:.1f})"
                for name, t in times.items()))
    for name, (N, F, passes, control_passes) in SPLITS.items():
        mod = ml if name == "ML" else bl
        raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        for label, fn, names in (
                ("the form", mod.fused_psd_mixed_large if name == "ML"
                 else mod.fused_psd_chirp_large, passes),
                ("the control", mod.fused_psd_mixed_large_control
                 if name == "ML" else mod.fused_psd_chirp_large_control,
                 control_passes)):
            split = by_pass(lambda: fn(raw, F, F), names)
            if split is None:
                print(f"{name} {label} N={N} F={F} by pass: not measured "
                      "(no profiler run held every launch)")
                continue
            print(f"{name} {label} N={N} F={F} by pass: " + "; ".join(
                f"{k} {us:.1f} us a launch ({n} launches)"
                for k, (n, us) in split.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
