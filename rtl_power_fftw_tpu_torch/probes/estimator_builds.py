"""The redesigned estimator kernels against other builds of them, measured
on the card (2048 bins, F = 4096 and the drives' step F = 400).

Each build is a copy of ``ops/kernels/csrc`` edited before nvcc
(:func:`edit`), one library each:

* ``pfb_unroll4``: the ring kernel's tap loop unrolled by 4;
* ``pfb_p4``: its tap loop over P = 4 taps fixed at compile time, whole
  (timing at P = 4 only);
* ``pfb_prmt``: its dequantization by one byte permute a value
  (``__byte_perm``) in place of two logic operations;
* ``pfb_noh``, ``pfb_norow``, ``pfb_nofft``: cuts of the ring kernel
  (timing only, their sums are not the PFB's): the prototype taken as 1.0
  (no h loads), the ring rows not read (a value of the slot and sample),
  the transform left out;
* ``sk_lb3``, ``k1_lb1``: ``psd_regs_kernel`` under
  ``__launch_bounds__(THREADS, B)``, B = 3 for the SK plane cut (2
  windowed) and 1 for every other cut: ``fused_psd_sk`` (the plane cut
  held to K1's 80 registers, on the shipped K1's grid) and ``fused_psd``
  (K1 and K2 with B = 1, which is not the shipped build's bare
  ``__launch_bounds__(THREADS)``, on their own grid);
* ``batch_w0``: the multitaper batch kernel with pass 0's twiddles (the
  thread's R - 1 constants) loaded into registers once a block, not
  through ``__ldg`` in every transform;
* ``batch_pf``: the multitaper batch kernel with the thread's R values of
  the next taper row prefetched into L1 (``prefetch.global.L1``) when it
  loads the current one;
* ``mt_nofft``, ``batch_nofft``: the multitaper control
  (``kRegsTapers``, grid (G, K)) and the batch kernel
  (``psd_tapers_batch_kernel``) with the transform left out (timing
  only): the control loads, dequantizes and tapers each frame once a
  taper, the batch kernel loads it once and tapers it K times.

It prints one line a build and kernel: the device µs a call (calls queued
behind a sleep kernel, the least of three runs), the registers, spill
bytes and blocks an SM, and the grid; for the PFB the ring kernel with
the prototype staged in shared memory and read through L2, and the
shipped ring kernel over a sweep of frames a block; for the multitaper
the batch kernel at 1, 2, 4 and 8 frames a lane a batch and over a sweep
of frames a block, and its route sweep against the control at every N
it fits (K = 2, 3, 7, 16, 32; F = 400, 4096 and the CLI's step); then
the control and ``torch.fft.fft`` of the complex64 frames (F polyphase
sums for the PFB, F K tapered frames for the multitaper, K = 7).

Run: ``python -m rtl_power_fftw_tpu_torch.probes.estimator_builds [part
...]``, the parts ``pfb``, ``sk`` (with K1), ``mt`` (the multitaper
control) and ``batch`` (the multitaper batch kernel); default: all.
Needs a CUDA card and nvcc; without a card it exits 1, on an unknown part
2. The copies and their libraries go to
``ops/kernels/build/estimator_builds/``.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from ..config import BASE_BUF, DEFAULT_BUF_MULTIPLIER
from ..models.multitaper import _session_tapers
from ..models.pfb import pfb_prototype
from ..ops.kernels import _build
from ..ops.kernels import fused_psd as fp
from ..ops.kernels import fused_psd_pfb as fpf
from ..ops.kernels import fused_psd_sk as fsk
from ..ops.kernels import fused_psd_tapers as fmt
from ..ops.spectral import adapt_batch
from ._timing import card
from .ring_layouts import device_us

N, P, K = 2048, 4, 7
FRAMES = (4096, 400)
PFB_SOURCE = "fused_psd_pfb.cu"
REGS_HEADER = "fused_psd_regs.cuh"
#: The ring kernel's tap loop, its loads and its transform, as shipped.
TAP_LOOP = ("      for (int p = 0; p < P; ++p) {\n"
            "        const uint16_t* row =\n")
H_LOAD = ("const float hv = STAGE_H ? hp[t + k * TF] : "
          "__ldg(hp + t + k * TF);")
ROW_LOAD = "const unsigned u = row[t + k * TF];"
DEQUANT = ("\n          v[k].x = __fadd_rn(v[k].x, __fmul_rn(dequant_byte(u & "
           "0xFFu), hv));\n          v[k].y = __fadd_rn(v[k].y, "
           "__fmul_rn(dequant_byte(u >> 8), hv));")
PRMT = ("\n          v[k].x = __fadd_rn(v[k].x, __fmul_rn(__uint_as_float("
        "__byte_perm(u, 0x4B000000u, 0x7440)) - 8388735.0f, hv));\n"
        "          v[k].y = __fadd_rn(v[k].y, __fmul_rn(__uint_as_float("
        "__byte_perm(u, 0x4B000000u, 0x7441)) - 8388735.0f, hv));")
RING_FFT = ("        if (++slot == slots) slot = 0;\n      }\n    }\n"
            "    regs_transform<LOG2N>(v, x, twiddle, t, active);\n")
FFT_CUTS = ("  constexpr bool FFT = CUT == kRegsFull || CUT == kRegsSk ||\n"
            "                       CUT == kRegsTapers || CUT == kRegsSkPlane;")
BOUNDS = ("template <int LOG2N, bool WINDOWED, int CUT = kRegsFull>\n"
          "__global__ void __launch_bounds__(RegsShape<LOG2N>::THREADS)\n")
#: build -> (edited file, (old, new) edits, libraries it builds)
BUILDS: Dict[str, Tuple[str, Tuple[Tuple[str, str], ...], Tuple[str, ...]]] = {
    "pfb_unroll4": (PFB_SOURCE, ((TAP_LOOP, "#pragma unroll 4\n" + TAP_LOOP),),
                    ("fused_psd_pfb",)),
    "pfb_p4": (PFB_SOURCE, ((TAP_LOOP, "#pragma unroll\n" + TAP_LOOP.replace(
        "p < P", "p < 4")),), ("fused_psd_pfb",)),
    "pfb_prmt": (PFB_SOURCE, ((H_LOAD + DEQUANT, H_LOAD + PRMT),),
                 ("fused_psd_pfb",)),
    "pfb_noh": (PFB_SOURCE, ((H_LOAD, "const float hv = 1.0f;"),),
                ("fused_psd_pfb",)),
    "pfb_norow": (PFB_SOURCE, ((ROW_LOAD, "const unsigned u = "
                                "(t + k * TF + slot) & 0xFFFFu;"),),
                  ("fused_psd_pfb",)),
    "pfb_nofft": (PFB_SOURCE, ((RING_FFT, RING_FFT.replace(
        "regs_transform<LOG2N>(v, x, twiddle, t, active);",
        "__syncthreads();")),), ("fused_psd_pfb",)),
}
LB = ((BOUNDS, BOUNDS.replace(
    "__launch_bounds__(RegsShape<LOG2N>::THREADS)",
    "__launch_bounds__(RegsShape<LOG2N>::THREADS,\n"
    "                  CUT == kRegsSkPlane ? (WINDOWED ? 2 : 3) : 1)")),)
BUILDS["sk_lb3"] = (REGS_HEADER, LB, ("fused_psd_sk",))
BUILDS["k1_lb1"] = (REGS_HEADER, LB, ("fused_psd",))
BUILDS["mt_nofft"] = (REGS_HEADER, ((FFT_CUTS, FFT_CUTS.replace(
    "CUT == kRegsTapers || ", "")),), ("fused_psd_tapers",))
#: batch_w0: regs_transform with pass 0's twiddles from registers, and
#: their load after the sums' zeroing.
W0_TRANSFORM = """// regs_transform with pass 0's twiddles w0[r] held by the thread.
template <int LOG2N>
__device__ __forceinline__ void regs_transform_w0(
    float2 (&v)[RegsPlan<LOG2N>::R], float2* x,
    const float2 (&w0)[RegsPlan<LOG2N>::R], const float2* twiddle, int t,
    bool active) {
  using P = RegsPlan<LOG2N>;
  constexpr int R = P::R, TF = P::TF;
  if (active) {
    dif_regs<R>(v, 0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k1 = rev_bits(r, log2_of(R));
      float2 y = v[r];
      if (k1 != 0) y = cmul(y, w0[r].x, w0[r].y);
      x[pad_index(t + k1 * TF)] = y;
    }
  }
  __syncthreads();
  if (active) regs_pass<LOG2N, 1>(v, x, twiddle, t);
  if constexpr (P::PASSES > 2) {
    __syncthreads();
    if (active) regs_pass<LOG2N, 2>(v, x, twiddle, t);
  }
  if constexpr (P::PASSES > 3) {
    __syncthreads();
    if (active) regs_pass<LOG2N, 3>(v, x, twiddle, t);
  }
}

"""
W0_LOAD = """  float2 w0[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = rev_bits(r, log2_of(R));
    w0[r] = q != 0 ? __ldg(twiddle + q * TF + t) : make_float2(1.0f, 0.0f);
  }
"""
BATCH_KERNEL = "// Block (g, s) sums |DFT(x_f * taper_k)|^2"
ACC_ZERO = "  for (int r = 0; r < R; ++r) acc[r] = 0.0f;\n"
BATCH_FFT = "        regs_transform<LOG2N>(v, x, twiddle, t, active);\n"
BUILDS["batch_w0"] = ("fused_psd_tapers.cu", (
    (BATCH_KERNEL, W0_TRANSFORM + BATCH_KERNEL),
    (ACC_ZERO, ACC_ZERO + W0_LOAD),
    (BATCH_FFT, "        regs_transform_w0<LOG2N>(v, x, w0, twiddle, t, "
                "active);\n")), ("fused_psd_tapers",))
BUILDS["batch_nofft"] = ("fused_psd_tapers.cu", (
    (BATCH_FFT, "        __syncthreads();\n"),), ("fused_psd_tapers",))
WIN_LOAD = ("      for (int r = 0; r < R; ++r) win[r] = __ldg(row + r * TF);"
            "\n")
BUILDS["batch_pf"] = ("fused_psd_tapers.cu", ((WIN_LOAD, WIN_LOAD + """\
      if (k + 1 < k1) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          asm volatile("prefetch.global.L1 [%0];" ::"l"(row + N + r * TF));
        }
      }
"""),), ("fused_psd_tapers",))
#: The libraries each part times.
PARTS = {"pfb": ("fused_psd_pfb",), "sk": ("fused_psd", "fused_psd_sk"),
         "mt": ("fused_psd_tapers",), "batch": ("fused_psd_tapers",)}


def part(build: str) -> str:
    """The part of :data:`PARTS` that times ``build``."""
    return "sk" if build.startswith(("sk", "k1")) else build.split("_")[0]


#: The fences around a source's streams forms (fused_psd_tapers.cu,
#: fused_psd_pfb.cu), which repeat the single-stream kernels' bodies line
#: for line: a build edits the single-stream kernels, outside them.
STREAMS_BEGIN = "// The streams forms: begin"
STREAMS_END = "// The streams forms: end."


def unfenced(text: str) -> Tuple[str, str, str]:
    """(before, fenced, after): a source's text around its streams forms
    (the fences in ``fenced``; "" and "" where it has none)."""
    head, begin, rest = text.partition(STREAMS_BEGIN)
    forms, end, tail = rest.partition(STREAMS_END)
    return head, begin + forms + end, tail


def edit(text: str, build: str) -> str:
    """The edited file's text for ``build``, its streams forms left as they
    are; raises if the shipped source no longer has what an edit replaces
    (once, outside the streams forms)."""
    name, edits, _ = BUILDS[build]
    head, forms, tail = unfenced(text)
    for old, new in edits:
        if head.count(old) + tail.count(old) != 1:
            raise ValueError(f"{build}: no single {old!r} in {name}")
        head, tail = head.replace(old, new), tail.replace(old, new)
    return head + forms + tail


def build_all(parts=tuple(PARTS)) -> Dict[Tuple[str, str], ctypes.CDLL]:
    """{(build, library): loaded library} of the builds of ``parts``, one
    nvcc a library, all at once; ("shipped", library) is the library as
    shipped."""
    root = _build.BUILD_DIR / "estimator_builds"
    procs = {}
    for build, (name, _, libraries) in BUILDS.items():
        if part(build) not in parts:
            continue
        src = root / build
        if src.exists():
            shutil.rmtree(src)
        shutil.copytree(_build.CSRC, src)
        (src / name).write_text(edit((src / name).read_text(), build))
        for lib in libraries:
            out = root / f"lib{lib}_{build}.so"
            procs[(build, lib)] = out, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                 str(src / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {("shipped", lib): _build.load(lib)
            for p in parts for lib in PARTS[p]}
    for key, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise _build.KernelBuildError(f"{key}: {err[-4000:]}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in _build.SIGNATURES[key[1]].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.rpf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rpf_cuda_error_string.restype = ctypes.c_char_p
        libs[key] = lib
    return libs


def use(libs, build: str) -> None:
    """Points the wrappers at ``build``'s libraries (the shipped ones where
    it has none), their residency asked anew."""
    for lib in {lib for _, lib in libs}:
        _build._libs[lib] = libs.get((build, lib), libs[("shipped", lib)])
    fp.resident_blocks.cache_clear()
    fpf.resident_blocks.cache_clear()
    fpf.ring_resident_blocks.cache_clear()


def ring(raw, hist, F, chunk, h, stage_h, group=None):
    """The ring kernel with the prototype staged or not, on ``group``
    frames a block (default: K1's rule over its residency); returns the
    output, the attributes and the group."""
    attrs = fp.library_attributes("fused_psd_pfb", N, P, 1, int(stage_h))
    if group is None:
        sms = torch.cuda.get_device_properties(raw.device)
        group = fp.k1_group(F, chunk, sms.multi_processor_count
                            * attrs["blocks_per_sm"])
    out = fp._launch(
        "fused_psd_pfb", raw, h, -(-F // group), (N,),
        lambda lib, r, tw, hp, partial, out, stream:
        lib.rpf_fused_psd_pfb(r, hist[0].data_ptr(), tw, hp, partial, out,
                              hist[1].data_ptr(), raw.device.index,
                              N.bit_length() - 1, F,
                              group, F, P, 0, 1, int(stage_h), stream),
        library="fused_psd_pfb", raw_align=fpf.RING_ALIGN)
    return out, attrs, group


def line(label, t, attrs, extra=""):
    print(f"{label}: device {t:.1f} us, {attrs['registers']} registers, "
          f"{attrs['spill_bytes']} B spill, {attrs['blocks_per_sm']} "
          f"blocks/SM{extra}")


def pfb_part(libs, dev, raw, F, chunk) -> None:
    """The ring kernel's builds, its frames-a-block sweep, the control and
    torch.fft.fft of the polyphase sums."""
    h = torch.from_numpy(pfb_prototype(N, P).reshape(P, N)).to(dev)
    hist = [torch.full((P - 1, 2 * N), 127, dtype=torch.uint8, device=dev)
            for _ in range(2)]
    use(libs, "shipped")
    want = fpf.fused_psd_pfb_control(raw, hist[0], F, chunk, h, hist[1])
    for build in ("shipped", "pfb_unroll4", "pfb_p4", "pfb_prmt",
                  "pfb_noh", "pfb_norow", "pfb_nofft"):
        use(libs, build)
        for stage_h in (True, False):
            got, attrs, group = ring(raw, hist, F, chunk, h, stage_h)
            rel = float(((got - want).abs() / want.abs().max()).max())
            t = device_us(lambda: ring(raw, hist, F, chunk, h, stage_h))
            line(f"N={N} F={F} P={P} {build} ring, h "
                 f"{'staged' if stage_h else 'through L2'}", t, attrs,
                 f", {group} frames a block; max rel vs the control "
                 f"{rel:.2e}")
    use(libs, "shipped")
    for group in (g for g in (1, 2, 4, 8, 16, 32) if chunk % g == 0):
        for stage_h in (True, False):
            _, attrs, _ = ring(raw, hist, F, chunk, h, stage_h, group)
            t = device_us(lambda: ring(raw, hist, F, chunk, h, stage_h,
                                       group))
            line(f"N={N} F={F} P={P} shipped ring at {group} frames a "
                 f"block, h {'staged' if stage_h else 'through L2'}", t,
                 attrs)
    t = device_us(lambda: fpf.fused_psd_pfb_control(raw, hist[0], F,
                                                    chunk, h, hist[1]))
    line(f"N={N} F={F} P={P} control", t,
         fpf.kernel_attributes(N, P, False))
    sums = fpf.pfb_sums_reference(torch.cat([hist[0], raw]), h, F)
    print(f"N={N} F={F} torch.fft.fft of the polyphase sums: device "
          f"{device_us(lambda: torch.fft.fft(sums, dim=-1)):.1f} us")


def sk_part(libs, dev, raw, F, chunk) -> None:
    """K1, K2 and the SK plane kernel and control, unwindowed and Hann,
    each as shipped and under launch bounds."""
    hann = torch.hann_window(N, periodic=False, dtype=torch.float32,
                             device=dev)
    for w, wname in ((None, "unwindowed"), (hann, "hann")):
        k = "K1" if w is None else "K2"
        for build, label, fn, attrs in (
                ("shipped", k, lambda: fp.fused_psd(raw, F, chunk, w),
                 lambda: fp.kernel_attributes(N, w is not None)),
                ("k1_lb1", k, lambda: fp.fused_psd(raw, F, chunk, w),
                 lambda: fp.kernel_attributes(N, w is not None)),
                ("shipped", "SK control",
                 lambda: fsk.fused_psd_sk_control(raw, F, chunk, w),
                 lambda: fsk.kernel_attributes(N, w is not None, False)),
                ("shipped", "SK plane",
                 lambda: fsk.fused_psd_sk(raw, F, chunk, w),
                 lambda: fsk.kernel_attributes(N, w is not None, True)),
                ("sk_lb3", "SK plane",
                 lambda: fsk.fused_psd_sk(raw, F, chunk, w),
                 lambda: fsk.kernel_attributes(N, w is not None, True))):
            use(libs, build)
            group = fp.k1_group(F, chunk, fp.resident_blocks(
                N, w is not None, dev.index))
            line(f"N={N} F={F} {wname} {build} {label}", device_us(fn),
                 attrs(), f", K1's grid {group} frames a block")
    use(libs, "shipped")


def batch(raw, tp, C, group=None):
    """The multitaper batch kernel on (F, 2N) frames and (K, N) tapers at
    C frames a lane a batch, on ``group`` frames a block and one taper
    range (default: the route's grid rule over its residency at C);
    returns the output, the attributes and the group."""
    F, n = raw.shape[0], raw.shape[1] // 2
    k = tp.shape[0]
    attrs = fp.library_attributes("fused_psd_tapers", n, C)
    per_block = k
    if group is None:
        sms = torch.cuda.get_device_properties(raw.device)
        group, per_block = fmt.batch_grid(
            F, k, n, sms.multi_processor_count * attrs["blocks_per_sm"])
    out = fp._launch(
        "fused_psd_tapers", raw, tp, -(-k // per_block) * -(-F // group),
        (n,),
        lambda lib, r, tw, t, partial, out, stream:
        lib.rpf_fused_psd_tapers(r, tw, t, partial, out, raw.device.index,
                                 n.bit_length() - 1, F, group, k, F, C,
                                 per_block, stream),
        library="fused_psd_tapers")
    return out, attrs, group


def batch_part(libs, dev, raw, F, chunk) -> None:
    """The multitaper's batch kernel at K = 7: the route, the next taper
    row prefetched (batch_pf), pass 0's twiddles in registers (batch_w0)
    and its cut without the transform (batch_nofft), each at C = 1, 2, 4
    and 8 frames a batch; the route's C over a sweep of frames a block."""
    tp = torch.from_numpy(_session_tapers(N, 4.0, K)).to(dev)
    use(libs, "shipped")
    want = fmt.fused_psd_tapers_reference(raw, F, chunk, tp)
    for build in ("shipped", "batch_pf", "batch_w0", "batch_nofft"):
        use(libs, build)
        for C in (1, 2, 4, 8):
            got, attrs, group = batch(raw, tp, C)
            rel = float(((got - want).abs() / want.abs()).max())
            t = device_us(lambda: batch(raw, tp, C))
            line(f"N={N} F={F} K={K} {build} batch C={C}"
                 f"{' (the route)' if C == fmt.BATCH_FRAMES else ''}",
                 t, attrs, f", {group} frames a block; max rel vs plain "
                 f"{rel:.2e}")
    use(libs, "shipped")
    for group in (g for g in (1, 2, 4, 8, 16, 32, 64) if chunk % g == 0):
        _, attrs, _ = batch(raw, tp, fmt.BATCH_FRAMES, group)
        t = device_us(lambda: batch(raw, tp, fmt.BATCH_FRAMES, group))
        line(f"N={N} F={F} K={K} shipped batch (the route's C) at {group} "
             f"frames a block", t, attrs)


def route_sweep(dev) -> None:
    """The multitaper batch kernel (at the route's C and grid rule)
    against the control at every N the batch kernel fits, K = 2, 3, 7,
    16, 32, F = 400, 4096 and the CLI's step at N (its default buffer
    over 2N bytes, at most 4096): device µs of each, in turns, and the
    route batch_shape takes."""
    rng = np.random.default_rng(1)
    for n in sorted(fp.PASS_PLAN)[:-1]:
        step = min(4096, BASE_BUF * DEFAULT_BUF_MULTIPLIER // (2 * n))
        for frames in sorted({400, step, 4096}):
            F, chunk = adapt_batch(frames)
            raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * n),
                                                dtype=np.uint8)).to(dev)
            for k in (2, 3, 7, 16, 32):
                tp = torch.from_numpy(np.resize(_session_tapers(
                    n, 4.0 if n > 64 else 2.0, min(k, 7 if n > 64 else 3)),
                    (k, n)).astype(np.float32)).to(dev)
                times = [device_us(fn) for fn in (
                    lambda: batch(raw, tp, fmt.BATCH_FRAMES),
                    lambda: fmt.fused_psd_tapers_control(raw, F, chunk, tp))
                    * 2]
                group, per_block = fmt.batch_grid(
                    F, k, n, fmt.batch_resident_blocks(n, dev.index))
                route = ("batch" if fmt.batch_shape(n, k) is not None
                         else "control")
                print(f"route sweep N={n} F={F} K={k}: batch "
                      f"{times[0]:.1f}/{times[2]:.1f} us ({group} frames a "
                      f"block, {-(-k // per_block)} taper ranges), control "
                      f"{times[1]:.1f}/{times[3]:.1f} us, ratio "
                      f"{min(times[0], times[2]) / min(times[1], times[3]):.3f}"
                      f"; the route: {route}")


def mt_part(libs, dev, raw, F, chunk) -> None:
    """The multitaper control at K = 7 as shipped and without its
    transform (mt_nofft), and torch.fft.fft of the F K tapered frames."""
    tp = torch.from_numpy(_session_tapers(N, 4.0, K)).to(dev)
    group = fmt.tapers_group(F, chunk, K, fp.resident_blocks(N, True,
                                                             dev.index))
    for build in ("shipped", "mt_nofft"):
        use(libs, build)
        t = device_us(lambda: fmt.fused_psd_tapers_control(raw, F, chunk,
                                                           tp))
        line(f"N={N} F={F} K={K} {build} control", t,
             fmt.kernel_attributes(N, False),
             f", {group} frames a block, grid ({-(-F // group)}, {K})")
    use(libs, "shipped")
    z = torch.complex(raw[:, 0::2].float() - 127.0,
                      raw[:, 1::2].float() - 127.0)
    zz = (z[:, None, :] * tp[None]).reshape(F * K, N)
    print(f"N={N} F={F} K={K} torch.fft.fft of the tapered frames: device "
          f"{device_us(lambda: torch.fft.fft(zz, dim=-1)):.1f} us")


def main(argv=None) -> int:
    parts = (sys.argv[1:] if argv is None else list(argv)) or list(PARTS)
    if any(p not in PARTS for p in parts):
        print(f"parts: {' '.join(PARTS)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    libs = build_all(parts)
    print(f"# estimator builds on {card(dev)}")
    rng = np.random.default_rng(0)
    for frames in FRAMES:
        F, chunk = adapt_batch(frames)
        raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        for name, run in (("pfb", pfb_part), ("sk", sk_part),
                          ("mt", mt_part), ("batch", batch_part)):
            if name in parts:
                run(libs, dev, raw, F, chunk)
        z = torch.complex(raw[:, 0::2].float() - 127.0,
                          raw[:, 1::2].float() - 127.0)
        print(f"N={N} F={F} torch.fft.fft of the frames: device "
              f"{device_us(lambda: torch.fft.fft(z, dim=-1)):.1f} us")
    if "batch" in parts:
        use(libs, "shipped")
        route_sweep(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
