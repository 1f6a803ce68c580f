"""The CLI estimators' forms of the large kernel's passes, measured on the
card: SK-L, MT-L and PFB-L (``ops/kernels/csrc/fused_psd_large_est.cu``)
beside the large kernel on the same frames, SK-L and PFB-L as shipped and
in their first forms, and each form's device time by kernel. The builds
are copies of the sources edited before nvcc
(:func:`.large_awkward_builds.build_sources`):

* ``sk_b2``: SK's pass B (``large_sk_b``) at two blocks an SM at every N
  (128 registers; it spills 216-232 B a thread at N2 >= 512); shipped,
  one block an SM there (255 registers, no spill);
* ``pfb_k``: PFB-L's pass A load a sample at a time (PFB-BL's
  ``pfb_sum``: the P taps of one sample, then the next); shipped, tap by
  tap over a thread's 16 samples;
* ``hist1``: the PFB's next histories by ``pfb_history_kernel``, one
  block a row, at every N; shipped, ``pfb_history_wide_kernel`` from rows
  of 64 KB (N >= 32768).

At each N:F it prints the device µs a call (calls queued behind a sleep
kernel, the least of three runs) of the large kernel and of SK-L or PFB-L
as shipped and in each build, twice in turns; then, at 2^20:8 and 2^22:8,
the device µs of each kernel a form launches, summed over its launches in
one call, from torch.profiler (whose records the card has been seen to
drop: the run is repeated until one holds every launch, up to four
times).

Run: ``python -m rtl_power_fftw_tpu_torch.probes.large_estimator_builds``.
Needs a CUDA card and nvcc; without a card it exits 1. The copy and its
library go to ``ops/kernels/build/large_estimator_builds/``.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..models.multitaper import _session_tapers
from ..models.pfb import pfb_prototype
from ..ops.kernels import _build
from ..ops.kernels import fused_psd_large as fl
from ..ops.kernels import fused_psd_large_est as le
from ._timing import card
from .large_awkward_builds import build_sources
from .ring_layouts import device_us

LIBRARY = "fused_psd_large_est"
PFB_K_LOAD = """\
  float2 v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int row = t + k * TF;
    const unsigned own = *reinterpret_cast<const uint16_t*>(
        tile + ring_offset<LOG2N>(row, byte >> 4) + (byte & 15));
    float re = 0.0f;
    float im = 0.0f;
    for (int p = 0; p < taps; ++p) {
      unsigned u = own;
      if (p < taps - 1) {
        const int r = j + p;
        const uint8_t* src =
            r < taps - 1 ? history + static_cast<size_t>(r) * 2 * L::N
                         : frames + static_cast<size_t>(r - (taps - 1)) * 2 *
                                        L::N;
        u = __ldg(reinterpret_cast<const uint16_t*>(src) + n0 +
                  (row << L::LOG2N2));
      }
      const float hv = __ldg(h + static_cast<size_t>(p) * L::N + n0 +
                             (row << L::LOG2N2));
      re = __fadd_rn(re, __fmul_rn(dequant_byte(u & 0xFFu), hv));
      im = __fadd_rn(im, __fmul_rn(dequant_byte(u >> 8), hv));
    }
    v[k] = make_float2(re, im);
  }
"""
#: Source edits of each build: (source, [(old, new)]).
BUILDS = {
    "sk_b2": ("fused_psd_large_est.cu",
              [("LargeRegs<LOG2N>::N2 >= 512 ? 1 : 2)\nlarge_sk_b(",
                "2)\nlarge_sk_b(")]),
    "pfb_k": ("fused_psd_large_est.cu",
              [(None, PFB_K_LOAD)]),
    "hist1": ("pfb_history.cuh",
              [("constexpr int kWideHistoryBytes = 65536;",
                "constexpr int kWideHistoryBytes = 1 << 30;")]),
}
#: The shipped load of PFB-L's pass A, which ``pfb_k`` replaces: from its
#: accumulators' zeroing to the end of its tap loop.
PFB_LOAD_BEGIN = "  float2 v[16];\n#pragma unroll\n  for (int k = 0; k < 16; ++k) v[k]"
PFB_LOAD_END = "  first_pass<L::LOG2N1>(v, x, twiddle, t,\n"
#: N:F (and a Hann window) of the timed shapes: phase 23's and the
#: excision drive's step.
SHAPES = ((65536, 16, True), (1 << 20, 8, False), (1 << 22, 8, False),
          (65536, 256, True))
#: The kernels each form launches, by the name torch.profiler gives them.
KERNELS = {"L": ["large_regs_a", "large_regs_b"],
           "SK-L": ["large_streams_a", "large_sk_b"],
           "MT-L": ["large_streams_a", "large_streams_b",
                    "est_streams_kernel"],
           "PFB-L": ["large_pfb_a", "large_streams_b", "pfb_history_kernel"]}


def edited(name: str, text: str) -> str:
    """``text`` (the build's source as shipped) with build ``name``'s
    edits; ``pfb_k`` replaces the load between PFB_LOAD_BEGIN and
    PFB_LOAD_END. Raises where the source no longer reads as an edit
    expects."""
    edits = BUILDS[name][1]
    if edits[0][0] is None:
        if text.count(PFB_LOAD_BEGIN) != 1:
            raise ValueError(f"no single {PFB_LOAD_BEGIN!r}")
        lo = text.index(PFB_LOAD_BEGIN)
        hi = text.index(PFB_LOAD_END, lo)
        return text[:lo] + edits[0][1] + text[hi:]
    return build_sources(text, edits)


def build_all() -> Dict[str, ctypes.CDLL]:
    """Each build from its edited copy of the sources, one nvcc each, all
    at once."""
    root = _build.BUILD_DIR / "large_estimator_builds"
    procs = {}
    for name, (source, _) in BUILDS.items():
        src = root / name
        if src.exists():
            shutil.rmtree(src)
        shutil.copytree(_build.CSRC, src)
        path = src / source
        path.write_text(edited(name, path.read_text()))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(root / f"lib{name}.so"), str(src / f"{LIBRARY}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise _build.KernelBuildError(f"{name}: {err[-4000:]}")
        lib = ctypes.CDLL(str(root / f"lib{name}.so"))
        for fn, argtypes in _build.SIGNATURES[LIBRARY].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.rpf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rpf_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def by_kernel(fn: Callable[[], object], names: List[str],
              calls: int = 10, tries: int = 4) -> Optional[Dict]:
    """{kernel: (launches a call, device µs a call)} of ``calls`` calls
    under torch.profiler: the first of ``tries`` runs in which each of
    ``names`` shows a whole number of launches a call, or None."""
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
        for m in names:
            hit = [(n, us) for k, n, us in rows if m in k]
            out[m] = (sum(n for n, _ in hit), sum(us for _, us in hit))
        if all(n > 0 and n % calls == 0 for n, _ in out.values()):
            return {m: (n // calls, us / calls) for m, (n, us) in out.items()}
    return None


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    libs = build_all()
    shipped = _build.load(LIBRARY)
    print(f"# large estimator builds on {card(dev)}")
    rng = np.random.default_rng(0)
    for N, F, hann in SHAPES:
        raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        w = (torch.from_numpy((0.5 - 0.5 * np.cos(
            2 * np.pi * np.arange(N) / N)).astype(np.float32)).to(dev)
             if hann else None)
        h = torch.from_numpy(pfb_prototype(N, 4).reshape(4, N)).to(dev)
        hist = [torch.full((3, 2 * N), 127, dtype=torch.uint8, device=dev)
                for _ in range(2)]
        forms = {"SK-L": (["shipped", "sk_b2"],
                          lambda: le.fused_psd_sk_large(raw, F, F, w)),
                 "PFB-L": (["shipped", "pfb_k", "hist1"],
                           lambda: le.fused_psd_pfb_large(
                               raw, hist[0], F, F, h, hist[1]))}
        times: Dict[str, List[float]] = {}
        for _ in range(2):
            times.setdefault("L", []).append(
                device_us(lambda: fl.fused_psd_large(raw, F, F, w)))
            for form, (names, fn) in forms.items():
                for name in names:
                    _build._libs[LIBRARY] = libs.get(name, shipped)
                    times.setdefault(f"{form} {name}", []).append(
                        device_us(fn))
        _build._libs[LIBRARY] = shipped
        print(f"N={N} F={F} hann={hann}: " + ", ".join(
            f"{name} {min(t):.1f} us ({t[0]:.1f}/{t[1]:.1f})"
            for name, t in times.items()))
    for N, F in ((1 << 20, 8), (1 << 22, 8)):
        raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        tp = torch.from_numpy(_session_tapers(N, 4.0, 7)).to(dev)
        h = torch.from_numpy(pfb_prototype(N, 4).reshape(4, N)).to(dev)
        hist = [torch.full((3, 2 * N), 127, dtype=torch.uint8, device=dev)
                for _ in range(2)]
        for form, fn in (
                ("L", lambda: fl.fused_psd_large(raw, F, F)),
                ("SK-L", lambda: le.fused_psd_sk_large(raw, F, F)),
                ("MT-L", lambda: le.fused_psd_tapers_large(raw, F, F, tp)),
                ("PFB-L", lambda: le.fused_psd_pfb_large(
                    raw, hist[0], F, F, h, hist[1]))):
            split = by_kernel(fn, KERNELS[form])
            if split is None:
                print(f"{form} N={N} F={F} by kernel: not measured (no "
                      "profiler run held every launch)")
                continue
            print(f"{form} N={N} F={F} by kernel: " + "; ".join(
                f"{k} {us:.1f} us a call ({n} launches)"
                for k, (n, us) in split.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
