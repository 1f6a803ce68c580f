"""The redesigned SK and PFB kernels against other builds of them, measured
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
  ``__launch_bounds__(THREADS)``, on their own grid).

It prints one line a build and kernel: the device µs a call (calls queued
behind a sleep kernel, the least of three runs), the registers, spill
bytes and blocks an SM, and the grid; for the PFB the ring kernel with
the prototype staged in shared memory and read through L2, and the
shipped ring kernel over a sweep of frames a block; then the control and
``torch.fft.fft`` of the complex64 frames (F polyphase sums for the PFB).

Run: ``python -m rtl_power_fftw_tpu_torch.probes.estimator_builds``.
Needs a CUDA card and nvcc; without a card it exits 1. The copies and
their libraries go to ``ops/kernels/build/estimator_builds/``.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.pfb import pfb_prototype
from ..ops.kernels import _build
from ..ops.kernels import fused_psd as fp
from ..ops.kernels import fused_psd_pfb as fpf
from ..ops.kernels import fused_psd_sk as fsk
from ..ops.spectral import adapt_batch
from ._timing import card
from .ring_layouts import device_us

N, P = 2048, 4
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


def edit(text: str, build: str) -> str:
    """The edited file's text for ``build``; raises if the shipped source
    no longer has what an edit replaces."""
    name, edits, _ = BUILDS[build]
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"{build}: no single {old!r} in {name}")
        text = text.replace(old, new)
    return text


def build_all() -> Dict[Tuple[str, str], ctypes.CDLL]:
    """{(build, library): loaded library}, one nvcc a library, all at
    once; ("shipped", library) is the library as shipped."""
    root = _build.BUILD_DIR / "estimator_builds"
    procs = {}
    for build, (name, _, libraries) in BUILDS.items():
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
            for lib in ("fused_psd", "fused_psd_sk", "fused_psd_pfb")}
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
    for lib in ("fused_psd", "fused_psd_sk", "fused_psd_pfb"):
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


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    libs = build_all()
    print(f"# estimator builds on {card(dev)}")
    rng = np.random.default_rng(0)
    h = torch.from_numpy(pfb_prototype(N, P).reshape(P, N)).to(dev)
    hist = [torch.full((P - 1, 2 * N), 127, dtype=torch.uint8, device=dev)
            for _ in range(2)]
    hann = torch.hann_window(N, periodic=False, dtype=torch.float32,
                             device=dev)
    for frames in FRAMES:
        F, chunk = adapt_batch(frames)
        raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        z = torch.complex(raw[:, 0::2].float() - 127.0,
                          raw[:, 1::2].float() - 127.0)
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
        print(f"N={N} F={F} torch.fft.fft of the frames: device "
              f"{device_us(lambda: torch.fft.fft(z, dim=-1)):.1f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
