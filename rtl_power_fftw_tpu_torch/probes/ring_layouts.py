"""The mixed-radix kernel's layout, measured on the card: the kernel of
``ops/kernels/csrc/fused_psd_mixed_ring.cuh`` as shipped (``plain``: no
exchange padding, ``__launch_bounds__(512, 1)``, so up to 128 registers a
thread) and in three other layouts, each a copy of the sources edited
before nvcc (:func:`layout_sources`):

* ``pad16``: element e of a lane's exchange buffer at e + (e >> 4),
  ``fft_regs.cuh``'s float2 every 16 elements;
* ``small64``: the class of at most ``kRingAccSmall`` last-pass sums held
  to 64 registers (two 512-thread blocks an SM);
* ``pad16_small64``: both.

At each N:F it prints one line a layout: the device µs a call (calls
queued behind a sleep kernel, the least of three runs), the registers,
spill bytes and blocks an SM the kernel gets there, and its max relative
error against the plain version; then the control
(``fused_psd_mixed_control``) and ``torch.fft.fft`` of the complex64
frames the same way.

Run: ``python -m rtl_power_fftw_tpu_torch.probes.ring_layouts [N:F ...]``
(default :data:`SHAPES`). Needs a CUDA card and nvcc; without a card it
exits 1. The copies and their libraries go to
``ops/kernels/build/ring_layouts/``.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import time
from typing import Callable, Dict

import numpy as np
import torch

from ..ops.kernels import _build
from ..ops.kernels import fused_psd as fp
from ..ops.kernels import fused_psd_mixed as fm
from ..ops.spectral import adapt_batch
from ._timing import card

#: N:F of the default run: the man-page step, the timed 2400 and 12000
#: shapes of chip_smoke.py, and plans with radix-16 passes (768, 96) and
#: a long radix-3 run (13122).
SHAPES = ("500:120", "2400:4096", "12000:64", "6000:256", "768:2048",
          "4800:1024", "13122:64", "96:4096")
LAYOUTS = ("plain", "pad16", "small64", "pad16_small64")
HEADER = "fused_psd_mixed_ring.cuh"
BOUNDS = "__launch_bounds__(kRingMaxThreads, 1)"
#: A lane's exchange buffer in float2, padded: (n - 1) + ((n - 1) >> 4) + 1
#: at most.
PADDED = "({n} + {n} / 16 + 1)"


def layout_sources(text: str, layout: str) -> str:
    """The ring header's text for ``layout``; raises if the header no
    longer has what an edit replaces."""
    if "pad16" in layout:
        text, hits = re.subn(r"\bx\[([^\]]+)\]", r"x[xpad(\1)]", text)
        edits = (("namespace {\n",
                  "namespace {\n__device__ __forceinline__ int xpad(int e) "
                  "{ return e + (e >> 4); }\n"),
                 ("round16(p.lanes * p.n * 8)",
                  f"round16(p.lanes * {PADDED.format(n='p.n')} * 8)"),
                 ("round16(p.lanes * n * 8)",
                  f"round16(p.lanes * {PADDED.format(n='n')} * 8)"),
                 ("+ lane * n;", f"+ lane * {PADDED.format(n='n')};"))
        if hits != 5:
            raise ValueError(f"{HEADER}: {hits} exchange accesses, not 5")
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"{HEADER}: no single {old!r}")
            text = text.replace(old, new)
    if "small64" in layout:
        if text.count(BOUNDS) != 1:
            raise ValueError(f"{HEADER}: no single {BOUNDS}")
        text = text.replace(BOUNDS, "__launch_bounds__(kRingMaxThreads, "
                                    "ACC <= kRingAccSmall ? 2 : 1)")
    return text


def build_layouts() -> Dict[str, ctypes.CDLL]:
    """Each layout but ``plain`` built from its edited copy of the
    sources, one nvcc each, all at once; ``plain`` is the library as
    shipped."""
    root = _build.BUILD_DIR / "ring_layouts"
    procs = {}
    for layout in LAYOUTS[1:]:
        src = root / layout
        if src.exists():
            shutil.rmtree(src)
        shutil.copytree(_build.CSRC, src)
        header = src / HEADER
        header.write_text(layout_sources(header.read_text(), layout))
        procs[layout] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(root / f"lib{layout}.so"), str(src / "fused_psd_mixed.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {"plain": _build.load("fused_psd_mixed")}
    for layout, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise _build.KernelBuildError(f"{layout}: {err[-4000:]}")
        lib = ctypes.CDLL(str(root / f"lib{layout}.so"))
        for fn, argtypes in _build.SIGNATURES["fused_psd_mixed"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.rpf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rpf_cuda_error_string.restype = ctypes.c_char_p
        libs[layout] = lib
    return libs


def use(lib: ctypes.CDLL) -> None:
    """Points the mixed-radix wrapper at ``lib`` (its launch plans and
    residency asked anew)."""
    _build._libs["fused_psd_mixed"] = lib
    fm._ring_plans.clear()
    fm.ring_resident_blocks.cache_clear()


def device_us(fn: Callable[[], object], calls: int = 20,
              reps: int = 3) -> float:
    """Device µs of one call of ``fn``: ``calls`` calls queued behind a
    sleep kernel that outlasts their enqueue, timed by CUDA events; the
    least of ``reps``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    cycles = int(2 * (time.perf_counter() - t0) * 2e9)
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        best = min(best, 1000.0 * start.elapsed_time(end) / calls)
    return best


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    shapes = [tuple(int(v) for v in s.split(":")) for s in argv or SHAPES]
    if not all(fm.fused_psd_mixed_eligible(N) for N, _ in shapes):
        print(f"not all of {shapes} are mixed-radix N", file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    libs = build_layouts()
    print(f"# ring layouts on {card(dev)}")
    rng = np.random.default_rng(0)
    for N, frames in shapes:
        F, chunk = adapt_batch(frames)
        raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        want = fp.fused_psd_reference(raw, F, chunk).double()
        for layout, lib in libs.items():
            use(lib)
            try:
                got = fm.fused_psd_mixed(raw, F, chunk).double()
            except fp.KernelLaunchError as e:
                print(f"N={N} F={F} {layout}: {e}")
                continue
            rel = float(((got - want).abs() / want.abs().max()).max())
            t = device_us(lambda: fm.fused_psd_mixed(raw, F, chunk))
            a = fm.ring_attributes(fm.ring_launch(N))
            print(f"N={N} F={F} {layout}: device {t:.1f} us, "
                  f"{a['registers']} registers, {a['spill_bytes']} B spill, "
                  f"{a['blocks_per_sm']} blocks/SM; max rel vs plain "
                  f"{rel:.2e}")
        use(libs["plain"])
        z = torch.complex(raw[:, 0::2].float() - 127.0,
                          raw[:, 1::2].float() - 127.0)
        control = device_us(lambda: fm.fused_psd_mixed_control(raw, F, chunk))
        fft = device_us(lambda: torch.fft.fft(z, dim=-1))
        print(f"N={N} F={F} control: device {control:.1f} us; "
              f"torch.fft.fft: device {fft:.1f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
