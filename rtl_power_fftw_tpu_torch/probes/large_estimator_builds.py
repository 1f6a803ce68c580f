"""The CLI estimators' forms of the large kernels' passes, measured on the
card: SK-L, MT-L and PFB-L (``ops/kernels/csrc/fused_psd_large_est.cu``)
beside the large kernel, and PFB-BL (``csrc/fused_psd_chirp_large_est.cu``)
beside BL, on the same frames; SK-L and the PFB forms as shipped, PFB-L
and PFB-BL also by their controls (build ``ctl``: their first forms, the
polyphase sums in pass A's load, which the libraries keep as
``rpf_fused_psd_pfb_large_control`` and ``rpf_fused_psd_pfb_chirp_large_
control``), and in other builds; each form's device time by kernel. The
builds are copies of the sources edited before nvcc
(:func:`.large_awkward_builds.build_sources`):

* ``sk_b2``: SK's pass B (``large_sk_b``) at two blocks an SM at every N
  (128 registers; it spills 216-232 B a thread at N2 >= 512); shipped,
  one block an SM there (255 registers, no spill);
* ``pfb_k``: the control's pass A load a sample at a time (PFB-BL's
  control's ``pfb_sum``: the P taps of one sample, then the next); the
  control as kept, tap by tap over a thread's 16 samples;
* ``hist1``: the PFB's next histories by ``pfb_history_kernel``, one
  block a row, at every N; shipped, ``pfb_history_wide_kernel`` from rows
  of 64 KB (N >= 32768);
* ``sums_d4``: the pre-pass (``pfb_sums_kernel``) with four frames' own
  rows in flight a thread; shipped, eight;
* ``sums_pad0``: the pre-pass's turn through shared memory unpadded (16
  float2 a column: its stores conflict 16 ways); shipped, 17;
* ``sums_flat``: the pre-pass writing each sum from the thread that forms
  it (8-byte pieces 128 bytes apart where B < 16); shipped, turned
  through shared memory into 256-byte runs;
* ``sums_whole``: the pre-pass with all of a stream's frames a block;
  shipped, frames split into groups until the grid has 2048 blocks;
* ``sums_all``: PFB-L on the pre-pass at every (N, P, frames), the route
  sweep's "sums" candidate;
* ``ring``, ``ring_res``: PFB-L's pass A on the ring of virtual rows
  (``large_pfb_ring_a``), h streamed tap by tap or resident, at every (N,
  P, frames) where it is built and fits (else the pre-pass), the route
  sweep's "ring" candidates; each bit-checked against the control.

Shipped: the route table ``kPfbRoute`` (``fused_psd_large_est.PFB_ROUTE``)
by log2 N, few (S F < 64) or many frames a call, and tap class; PFB-BL the
pre-pass at every (M, P). Device µs on an NVIDIA H100 80GB HBM3, 700.00 W
(route sweeps, this probe): at 32768–2^17 with 16 frames the first form
(the ring 1.00–1.37x it, the pre-pass 1.15–1.47x), but the pre-pass at
2^17 for P >= 16 and ``ring_res`` at 2^17 P = 8 (0.92x); with 64 or 256
frames (and S = 2 F = 64 at 32768) ``ring_res`` for P <= 8 (0.63–0.97x the
first form; 2^16–2^17 P = 2 the first form, ``ring_res`` 1.03–1.06x) and
the pre-pass for P >= 16 (0.52–0.87x, but 1.19x at 2^17 F=64 P=32, the
one many-frame case the first form won); from 2^18 at P <= 4 the ring
(``ring`` to 2^19: 0.80–0.94x the pre-pass at F = 8, 0.77–0.90x at F =
64; ``ring_res`` at 2^20–2^21: 0.78–0.89x, 159.1 against 178.5 at 2^20
F=8 P=4), at P >= 8
the pre-pass (the streamed ring 1.13–1.75x it at P = 8, one block an SM;
P >= 16 does not fit), and at 2^22 the pre-pass at every P (783.1 against
2798.8 at F=8 P=4; the ring is not built there, an h tile row being 8
bytes). The frame counts 17–63 were not swept. PFB-BL's pre-pass:
0.19–0.98x its first form (1141.8 against 1926.9 at 2097150 F=8 P=4).
The pre-pass's builds at 2^22 F=8 P=4 against the shipped 783.5:
``sums_d4`` 785.1, ``sums_pad0`` 853.6, ``sums_flat`` 1319.2,
``sums_whole`` 783.8 (at 65536 F=256: 214.8–215.4 each, the first form
there).

At each N:F it prints the device µs a call (calls queued behind a sleep
kernel, the least of three runs) of the base kernel and of each form as
shipped, by its control and in each build, twice in turns; then, at 2^20:8
and 2^22:8 (the large kernel's forms) and 2097150:8 (BL's), the device µs
of each kernel a form launches, summed over its launches in one call, from
torch.profiler (whose records the card has been seen to drop: the run is
repeated until one holds every launch, up to four times).

Run: ``python -m rtl_power_fftw_tpu_torch.probes.large_estimator_builds``.
Needs a CUDA card and nvcc; without a card it exits 1. The copies and
their libraries go to ``ops/kernels/build/large_estimator_builds/``.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..models.multitaper import _session_tapers
from ..models.pfb import pfb_prototype
from ..ops.kernels import _build
from ..ops.kernels import fused_psd_chirp_large as fbl
from ..ops.kernels import fused_psd_chirp_large_est as be
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
#: Source edits of each build: (source, [(old, new)]); a header's edits
#: are built into LIBRARY.
BUILDS = {
    "sk_b2": ("fused_psd_large_est.cu",
              [("LargeRegs<LOG2N>::N2 >= 512 ? 1 : 2)\nlarge_sk_b(",
                "2)\nlarge_sk_b(")]),
    "pfb_k": ("fused_psd_large_est.cu",
              [(None, PFB_K_LOAD)]),
    "hist1": ("pfb_history.cuh",
              [("constexpr int kWideHistoryBytes = 65536;",
                "constexpr int kWideHistoryBytes = 1 << 30;")]),
    "sums_d4": ("pfb_sums.cuh",
                [("constexpr int kSumsDepth = 8;",
                  "constexpr int kSumsDepth = 4;")]),
    "sums_pad0": ("pfb_sums.cuh",
                  [("constexpr int kSumsTurn = kSumsRows + 1;",
                    "constexpr int kSumsTurn = kSumsRows;")]),
    "sums_flat": ("pfb_sums.cuh",
                  [("const bool turned = shape.log2b < 4;",
                    "const bool turned = false;")]),
    "sums_whole": ("pfb_sums.cuh",
                   [("constexpr int kSumsBlocks = 2048;",
                     "constexpr int kSumsBlocks = 1;")]),
    "sums_all": ("fused_psd_large_est.cu",
                 [(None, "control ? kRouteLoad : kRouteSums);")]),
    "ring": ("fused_psd_large_est.cu",
             [(None, "control ? kRouteLoad : kRouteRing);"),
              (None, "false")]),
    "ring_res": ("fused_psd_large_est.cu",
                 [(None, "control ? kRouteLoad : kRouteRingRes);"),
                  (None, "true")]),
}
#: The form each build is timed as: SK-L, PFB-L or PFB-BL as shipped, or
#: the PFB-L control.
BUILD_FORM = {"sk_b2": "SK-L", "pfb_k": "PFB-L ctl", "hist1": "PFB-L",
              "sums_d4": "PFB-L", "sums_pad0": "PFB-L", "sums_flat": "PFB-L",
              "sums_whole": "PFB-L", "sums_all": "route", "ring": "PFB-L",
              "ring_res": "PFB-L"}
#: The ring builds' edits: PFB-L's pass A on the ring (h resident or not,
#: the second edit's word) at every N and P but the control's, where the
#: ring is built and its shared memory at P fits a block, else on the
#: pre-pass.
ENTRY_ROUTE = ("control ? kRouteLoad\n                  : kPfbRoute["
               "log2n - kMinLog2N][S * F >= kPfbManyFrames]\n"
               "                             [log2_of(sums_taps(P)) - 1]);")
RING_AT = ("  const dim3 grid(l.g_a() * L::TILES_A, l.S);\n"
           "  cudaError_t e = cudaSuccess;\n")
RING_EDIT = """\
  if (route == kRouteRing || route == kRouteRingRes) {{
    bool fits = false;
    if constexpr (ring_built<LOG2N>()) {{
      fits = ring_a_smem<LOG2N>(P, {0}) <= kRingSmemMax;
    }}
    if (!fits) route = kRouteSums;
  }}
"""
#: The control's load of PFB-L's pass A, which ``pfb_k`` replaces: from its
#: accumulators' zeroing to the end of its tap loop.
PFB_LOAD_BEGIN = "  float2 v[16];\n#pragma unroll\n  for (int k = 0; k < 16; ++k) v[k]"
PFB_LOAD_END = "  first_pass<L::LOG2N1>(v, x, twiddle, t,\n"
#: N:F (and a Hann window) of the timed shapes of the large kernel's forms
#: (phase 23's, the excision drive's step and phase 25's 2^22), and of
#: BL's PFB (phase 22's and phase 25's).
SHAPES = ((65536, 16, True), (1 << 20, 8, False), (1 << 22, 8, False),
          (65536, 256, True))
BL_SHAPES = ((16382, 256), (99998, 64), (2097150, 8))
#: The route sweep: the PFB forms' routes (the pre-pass, build
#: ``sums_all``; the first form, the control; for PFB-L up to RING_MAX_N
#: the ring, builds ``ring`` and ``ring_res``) and as shipped at every log2
#: N (log2 M) the forms take and these tap counts, F frames; then PFB-L's
#: at the drives' own frames (ROUTE_DRIVES: N, F a stream, S streams).
ROUTE_TAPS = (2, 4, 8, 16, 32)
ROUTE_N = {"L": tuple(1 << k for k in range(15, 23)),
           "BL": (16382, 32766, 65534, 131070, 262142, 524286, 1048574,
                  2097150)}
ROUTE_DRIVES = ((32768, 64, 2), (65536, 256, 1), (1 << 20, 8, 1))
#: The ring builds' bit checks against the control: (N, F, P, counts a
#: stream, history and h 16-byte aligned).
RING_BITS = ((65536, 16, 4, (16,), True), (65536, 16, 4, (15,), True),
             (65536, 256, 4, (256,), True), (1 << 20, 8, 4, (8,), True),
             (1 << 20, 8, 4, (1,), True), (1 << 20, 8, 4, (0,), True),
             (1 << 20, 8, 4, (8,), False), (1 << 18, 8, 1, (8,), True),
             (1 << 18, 8, 2, (8,), True), (1 << 18, 8, 3, (8,), True),
             (1 << 18, 8, 6, (8,), True), (1 << 18, 8, 8, (8,), True),
             (1 << 21, 8, 4, (8,), True), (32768, 64, 4, (64, 37), True),
             (1 << 18, 8, 4, (8, 5), True))
#: The parts of a run, all by default.
PARTS = ("bits", "shapes", "bl", "split", "route")


def route_frames(N: int) -> int:
    """The sweep's frames at N: 16 up to 2^17 bins, 8 above."""
    return 16 if N <= 1 << 17 else 8
#: The kernels each form launches, by the name torch.profiler gives them.
KERNELS = {"L": ["large_regs_a", "large_regs_b"],
           "SK-L": ["large_streams_a", "large_sk_b"],
           "MT-L": ["large_streams_a", "large_streams_b",
                    "est_streams_kernel"],
           "PFB-L": ["pfb_sums_kernel", "large_pfb_sums_a",
                     "large_streams_b", "pfb_history"],
           "PFB-L ctl": ["large_pfb_a", "large_streams_b", "pfb_history"],
           "PFB-L ring": ["large_pfb_ring_a", "large_streams_b",
                          "pfb_history"],
           "BL": ["chirp_regs_a", "chirp_regs_b", "chirp_regs_c"],
           "PFB-BL": ["pfb_sums_kernel", "chirp_pfb_sums_a",
                      "chirp_streams_b", "chirp_streams_c", "pfb_history"],
           "PFB-BL ctl": ["chirp_pfb_a", "chirp_streams_b",
                          "chirp_streams_c", "pfb_history"]}


def library_of(name: str) -> str:
    """The library build ``name`` compiles: its source's, or LIBRARY for
    a header's edits."""
    source = BUILDS[name][0]
    return source[:-3] if source.endswith(".cu") else LIBRARY


def edited(name: str, text: str) -> str:
    """``text`` (the build's source as shipped) with build ``name``'s
    edits; ``pfb_k`` replaces the load between PFB_LOAD_BEGIN and
    PFB_LOAD_END. Raises where the source no longer reads as an edit
    expects."""
    edits = BUILDS[name][1]
    if name == "sums_all":
        return build_sources(text, [(ENTRY_ROUTE, edits[0][1])])
    if name.startswith("ring"):
        return build_sources(text, [
            (ENTRY_ROUTE, edits[0][1]),
            (RING_AT, RING_AT + RING_EDIT.format(edits[1][1]))])
    if edits[0][0] is None:
        if text.count(PFB_LOAD_BEGIN) != 1:
            raise ValueError(f"no single {PFB_LOAD_BEGIN!r}")
        lo = text.index(PFB_LOAD_BEGIN)
        hi = text.index(PFB_LOAD_END, lo)
        return text[:lo] + edits[0][1] + text[hi:]
    return build_sources(text, edits)


def build_all(names) -> Dict[str, ctypes.CDLL]:
    """Each build of ``names`` from its edited copy of the sources, one
    nvcc each, all at once."""
    root = _build.BUILD_DIR / "large_estimator_builds"
    procs = {}
    for name in names:
        source = BUILDS[name][0]
        src = root / name
        if src.exists():
            shutil.rmtree(src)
        shutil.copytree(_build.CSRC, src)
        path = src / source
        path.write_text(edited(name, path.read_text()))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(root / f"lib{name}.so"),
             str(src / f"{library_of(name)}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise _build.KernelBuildError(f"{name}: {err[-4000:]}")
        lib = ctypes.CDLL(str(root / f"lib{name}.so"))
        for fn, argtypes in _build.SIGNATURES[library_of(name)].items():
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


def _timed(forms: Dict[str, Callable[[], object]], libs, shipped) -> Dict:
    """Device µs of each form twice in turns: {label: [us, us]}; a form
    named "<form> <build>" runs with that build's library in its
    library's place."""
    times: Dict[str, List[float]] = {}
    for _ in range(2):
        for label, fn in forms.items():
            build = label.split()[-1]
            if build in libs:
                lib = library_of(build)
                _build._libs[lib] = libs[build]
            times.setdefault(label, []).append(device_us(fn))
            _build._libs.update(shipped)
    return times


def _print_times(head: str, times: Dict[str, List[float]]) -> None:
    print(head + ", ".join(f"{name} {min(t):.1f} us ({t[0]:.1f}/{t[1]:.1f})"
                           for name, t in times.items()))


def _split(form: str, label: str, fn) -> None:
    split = by_kernel(fn, KERNELS[form])
    if split is None:
        print(f"{label} by kernel: not measured (no profiler run held "
              "every launch)")
        return
    print(f"{label} by kernel: " + "; ".join(
        f"{k} {us:.1f} us a call ({n} launches)"
        for k, (n, us) in split.items()))


def _with(libs, shipped, build, fn):
    """``fn()`` with build ``build``'s library in its library's place
    (None: as shipped)."""
    if build:
        _build._libs[library_of(build)] = libs[build]
    try:
        return fn()
    finally:
        _build._libs.update(shipped)


def _pfb_call(form, raw, hist, h, F, counts, out_hist=None):
    """One PFB call on S = len(counts) streams: the one-stream entry at S
    = 1 (``counts`` a tuple), else the streams entry with ``counts`` an
    (S,) int32 tensor on the card (made before the call, so that a timed
    call copies nothing from the host); returns (output, next history)."""
    out_hist = torch.empty_like(hist) if out_hist is None else out_hist
    if len(counts) == 1:
        return form(raw[0], hist[0], counts[0], F, h, out_hist[0]), out_hist
    return form(raw, hist, counts, F, h, out_hist), out_hist


def _forms(S):
    return ((le.fused_psd_pfb_large, le.fused_psd_pfb_large_control)
            if S == 1 else (le.fused_psd_pfb_large_streams,
                            le.fused_psd_pfb_large_streams_control))


def ring_bits(dev, rng, libs, shipped) -> None:
    """Each ring build's output and next history against the control's,
    bit for bit, at RING_BITS (history and h as 4-byte-aligned views where
    the case says so)."""
    for build in ("ring", "ring_res"):
        if build not in libs:
            continue
        for N, F, P, counts, aligned in RING_BITS:
            S = len(counts)
            raw = torch.from_numpy(rng.integers(
                0, 256, (S, F, 2 * N), dtype=np.uint8)).to(dev)
            skew = 0 if aligned else 4
            hist = torch.from_numpy(rng.integers(
                0, 256, S * max(P - 1, 0) * 2 * N + skew,
                dtype=np.uint8)).to(dev)[skew:].view(S, max(P - 1, 0), 2 * N)
            h = torch.empty(P * N + 1, device=dev)[1 - skew // 4:][:P * N]
            h.copy_(torch.from_numpy(pfb_prototype(N, P)))
            h = h.view(P, N)
            form, ctl = _forms(S)
            if S > 1:
                counts = torch.tensor(counts, dtype=torch.int32, device=dev)
            got = _with(libs, shipped, build,
                        lambda: _pfb_call(form, raw, hist, h, F, counts))
            want = _pfb_call(ctl, raw, hist, h, F, counts)
            torch.cuda.synchronize()
            same = torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                 want[1])
            print(f"bits {build} N={N} F={F} P={P} counts "
                  f"{list(counts) if S == 1 else counts.tolist()} "
                  f"aligned {aligned}: {'the control' if same else 'NOT'}"
                  f" bit for bit")


def route_sweep(dev, rng, libs, shipped, cases=None) -> None:
    """PFB-L and PFB-BL on each route (PFB-L's pre-pass by build
    ``sums_all``, its ring by ``ring`` and ``ring_res`` up to RING_MAX_N;
    PFB-BL's pre-pass as shipped; the first form by the control) and as
    shipped, at every N of ROUTE_N and P of ROUTE_TAPS, then PFB-L at
    ROUTE_DRIVES, in turns: device µs and each route's ratio to the first
    form."""
    cases = cases or [(f, N, route_frames(N), 1) for f, Ns in ROUTE_N.items()
                      for N in Ns] + [("L", N, F, S)
                                      for N, F, S in ROUTE_DRIVES]
    for f, N, F, S in cases:
        mod = le if f == "L" else be
        if f == "L":
            new, ctl = _forms(S)
            builds = {"sums": "sums_all", "load": None}
            if N <= le.RING_MAX_N:
                builds.update(ring="ring", ring_res="ring_res")
        else:
            new, ctl = (be.fused_psd_pfb_chirp_large,
                        be.fused_psd_pfb_chirp_large_control)
            builds = {"sums": None, "load": None}
        builds = {k: b for k, b in builds.items() if b is None or b in libs}
        builds["shipped"] = None
        raw = torch.from_numpy(rng.integers(0, 256, (S, F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        for P in ROUTE_TAPS:
            h = torch.from_numpy(pfb_prototype(N, P).reshape(P, N)).to(dev)
            hist = torch.full((S, P - 1, 2 * N), 127, dtype=torch.uint8,
                              device=dev)
            counts = ((F,) if S == 1 else
                      torch.full((S,), F, dtype=torch.int32, device=dev))
            out_hist = torch.empty_like(hist)
            t = {k: [] for k in builds}
            for order in (list(builds), list(builds)[::-1]):
                for k in order:
                    fn = ctl if k == "load" else new
                    t[k].append(_with(libs, shipped, builds[k], lambda: (
                        device_us(lambda: _pfb_call(fn, raw, hist, h, F,
                                                    counts, out_hist),
                                  calls=10))))
            best = {k: min(v) for k, v in t.items()}
            print(f"route PFB-{f} N={N} S={S} F={F} P={P}: " + ", ".join(
                f"{k} {best[k]:.1f} us ({v[0]:.1f}/{v[1]:.1f}, "
                f"{best[k] / best['load']:.3f} of the first form)"
                for k, v in t.items() if k != "shipped")
                + f"; shipped ({mod.pfb_route(N, P, S * F)}) "
                f"{best['shipped']:.1f}"
                " us")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m rtl_power_fftw_tpu_torch.probes."
             "large_estimator_builds", description=__doc__.split("\n")[0])
    p.add_argument("--builds", nargs="*", default=list(BUILDS),
                   choices=list(BUILDS), help="the builds to make and time")
    p.add_argument("--parts", nargs="*", default=list(PARTS),
                   choices=PARTS, help="the parts of the run")
    p.add_argument("--route-cases", nargs="*", default=None,
                   metavar="FAMILY:N:F:S",
                   help="the route sweep's cases (default: ROUTE_N at "
                        "route_frames, then ROUTE_DRIVES)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    # The shipped libraries build beside the copies, all at once.
    base = threading.Thread(target=_build.build, args=(
        [LIBRARY, "fused_psd_chirp_large_est", "fused_psd_large",
         "fused_psd_chirp_large"],))
    base.start()
    libs = build_all(args.builds)
    base.join()
    shipped = {name: _build.load(name)
               for name in (LIBRARY, "fused_psd_chirp_large_est")}
    print(f"# large estimator builds on {card(dev)}")
    rng = np.random.default_rng(0)
    P = 4
    if "bits" in args.parts:
        ring_bits(dev, rng, libs, shipped)
    for N, F, hann in SHAPES if "shapes" in args.parts else ():
        raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        w = (torch.from_numpy((0.5 - 0.5 * np.cos(
            2 * np.pi * np.arange(N) / N)).astype(np.float32)).to(dev)
             if hann else None)
        h = torch.from_numpy(pfb_prototype(N, P).reshape(P, N)).to(dev)
        hist = [torch.full((P - 1, 2 * N), 127, dtype=torch.uint8,
                           device=dev) for _ in range(2)]
        calls = {
            "L": lambda: fl.fused_psd_large(raw, F, F, w),
            "SK-L": lambda: le.fused_psd_sk_large(raw, F, F, w),
            "PFB-L": lambda: le.fused_psd_pfb_large(raw, hist[0], F, F, h,
                                                    hist[1]),
            "PFB-L ctl": lambda: le.fused_psd_pfb_large_control(
                raw, hist[0], F, F, h, hist[1])}
        forms = {"L": calls["L"], "SK-L shipped": calls["SK-L"],
                 "PFB-L shipped": calls["PFB-L"],
                 "PFB-L ctl": calls["PFB-L ctl"]}
        for name, form in BUILD_FORM.items():
            if form in calls and name in libs and not (
                    name.startswith("ring") and N > le.RING_MAX_N):
                forms[f"{form} {name}"] = calls[form]
        _print_times(f"N={N} F={F} hann={hann} P={P}: ",
                     _timed(forms, libs, shipped))
    for N, F in BL_SHAPES if "bl" in args.parts else ():
        raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        h = torch.from_numpy(pfb_prototype(N, P).reshape(P, N)).to(dev)
        hist = [torch.full((P - 1, 2 * N), 127, dtype=torch.uint8,
                           device=dev) for _ in range(2)]
        forms = {
            "BL": lambda: fbl.fused_psd_chirp_large(raw, F, F),
            "PFB-BL shipped": lambda: be.fused_psd_pfb_chirp_large(
                raw, hist[0], F, F, h, hist[1]),
            "PFB-BL ctl": lambda: be.fused_psd_pfb_chirp_large_control(
                raw, hist[0], F, F, h, hist[1])}
        for name, form in BUILD_FORM.items():
            if form == "PFB-BL" and name in libs:
                forms[f"{form} {name}"] = forms["PFB-BL shipped"]
        _print_times(f"N={N} F={F} P={P}: ", _timed(forms, libs, shipped))
    for N, F in ((1 << 20, 8), (1 << 22, 8)) if "split" in args.parts else ():
        raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        tp = torch.from_numpy(_session_tapers(N, 4.0, 7)).to(dev)
        h = torch.from_numpy(pfb_prototype(N, P).reshape(P, N)).to(dev)
        hist = [torch.full((P - 1, 2 * N), 127, dtype=torch.uint8,
                           device=dev) for _ in range(2)]
        for form, fn in (
                ("L", lambda: fl.fused_psd_large(raw, F, F)),
                ("SK-L", lambda: le.fused_psd_sk_large(raw, F, F)),
                ("MT-L", lambda: le.fused_psd_tapers_large(raw, F, F, tp)),
                ("PFB-L", lambda: le.fused_psd_pfb_large(
                    raw, hist[0], F, F, h, hist[1])),
                ("PFB-L ctl", lambda: le.fused_psd_pfb_large_control(
                    raw, hist[0], F, F, h, hist[1]))):
            _split(form, f"{form} N={N} F={F}", fn)
        if "ring" in libs and N <= le.RING_MAX_N:
            _with(libs, shipped, "ring", lambda: _split(
                "PFB-L ring", f"PFB-L ring N={N} F={F}",
                lambda: le.fused_psd_pfb_large(raw, hist[0], F, F, h,
                                               hist[1])))
    if "route" in args.parts:
        route_sweep(dev, rng, libs, shipped, [
            (f, int(N), int(F), int(S)) for f, N, F, S in (
                c.split(":") for c in args.route_cases or ())])
    if "split" not in args.parts:
        return 0
    N, F = BL_SHAPES[-1]
    raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                        dtype=np.uint8)).to(dev)
    h = torch.from_numpy(pfb_prototype(N, P).reshape(P, N)).to(dev)
    hist = [torch.full((P - 1, 2 * N), 127, dtype=torch.uint8, device=dev)
            for _ in range(2)]
    for form, fn in (
            ("BL", lambda: fbl.fused_psd_chirp_large(raw, F, F)),
            ("PFB-BL", lambda: be.fused_psd_pfb_chirp_large(
                raw, hist[0], F, F, h, hist[1])),
            ("PFB-BL ctl", lambda: be.fused_psd_pfb_chirp_large_control(
                raw, hist[0], F, F, h, hist[1]))):
        _split(form, f"{form} N={N} F={F}", fn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
