"""Whether the kernels of an earlier tree compile to the same SASS here.

K1, K2 and K4's ``fused_psd``, K3's ``fused_psd_fast``, the large-N
``fused_psd_large``, the probes' ``fused_psd_probe``, the awkward-N
``fused_psd_mixed`` (whose earlier kernels are the control), the
estimators' ``fused_psd_sk``, ``fused_psd_tapers`` and ``fused_psd_pfb``
(which share ``fused_psd_regs.cuh`` with K1) and the large awkward-N
``fused_psd_mixed_large`` and ``fused_psd_chirp_large`` (whose earlier
kernels are the controls; the latter shares the large kernel's register
passes) and the library estimators' ``fused_psd_frames``,
``fused_psd_csd`` and ``fused_psd_scf`` and the estimators' forms of the
mixed-radix kernel, ``fused_psd_mixed_est``, of the chirp-Z kernel,
``fused_psd_chirp_est``, of BL's passes, ``fused_psd_chirp_large_est``,
of the large kernel's passes, ``fused_psd_large_est``, and of ML's
passes, ``fused_psd_mixed_large_est``
(a source the earlier tree lacks has no earlier kernels) are each compiled twice with the build's own nvcc
flags, from ``csrc/`` and from the earlier tree's ``csrc/``, and
``cuobjdump -sass`` of the two libraries is compared kernel by kernel:
every kernel of the
earlier build must be in this one with the same instructions. Names are
compared demangled, with the template argument ``S1_FORM = 0``
(``FastVariant``'s last parameter, whose default is the earlier template)
dropped; listings are compared with the whitespace
collapsed (cuobjdump pads its columns to the widest line of the file) and
the branch labels renumbered in each kernel (their numbers run across the
file). Needs nvcc and cuobjdump; no card.

Run: ``git archive <commit> rtl_power_fftw_tpu_torch/ops/kernels/csrc |
tar -x -C DIR`` and then ``python -m
rtl_power_fftw_tpu_torch.ops.kernels.sass_diff
DIR/rtl_power_fftw_tpu_torch/ops/kernels/csrc``. Prints one line per
source and exits 1 if any earlier kernel is missing or differs.

``--write-digest FILE`` (after DIR) also writes the earlier tree's
kernels as a digest, {library: {kernel: sha256 of its normalized SASS}},
with the nvcc release that built them (:data:`DIGEST`, committed beside
the sources): ``chip_smoke.py`` holds the libraries it builds to it
(:func:`check_digest`), so that a run from a checkout alone compares
every earlier kernel without the earlier sources.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict

from . import _build

SOURCES = ("fused_psd", "fused_psd_fast", "fused_psd_large", "fused_psd_probe",
           "fused_psd_mixed", "fused_psd_sk", "fused_psd_tapers",
           "fused_psd_pfb", "fused_psd_mixed_large", "fused_psd_chirp_large",
           "fused_psd_frames", "fused_psd_csd", "fused_psd_scf",
           "fused_psd_mixed_est", "fused_psd_chirp_est",
           "fused_psd_chirp_large_est", "fused_psd_large_est",
           "fused_psd_mixed_large_est")
#: The parent tree's kernels, written by ``--write-digest``.
DIGEST = Path(__file__).with_name("sass_digest.json")


def nvcc_release(nvcc: str) -> str:
    """The "release x.y, Vx.y.z" part of ``nvcc --version``."""
    text = subprocess.run([nvcc, "--version"], capture_output=True,
                          text=True, check=True).stdout
    m = re.search(r"release [^\n]*", text)
    return m.group(0) if m else text.strip().splitlines()[-1]


def digest(lib: Path, bin_dir: str) -> Dict[str, str]:
    """{kernel: sha256 of its normalized SASS} of a library."""
    return {k: hashlib.sha256(v.encode()).hexdigest()
            for k, v in listing(lib, bin_dir).items()}


def check_digest(libs: Dict[str, Path], path: Path = DIGEST):
    """Hold built libraries ({source: library}) to a digest: returns the
    nvcc release of each side and, per source, (earlier kernels, those
    missing or different here, kernels new here)."""
    nvcc = _build._nvcc()
    bin_dir = os.path.dirname(nvcc)
    want = json.loads(Path(path).read_text())
    out = {}
    for name in SOURCES:
        old = want["kernels"].get(name, {})
        new = digest(libs[name], bin_dir)
        out[name] = (len(old), sorted(k for k in old if new.get(k) != old[k]),
                     len(set(new) - set(old)))
    return want["nvcc"], nvcc_release(nvcc), out


def listing(lib: Path, bin_dir: str) -> Dict[str, str]:
    """{demangled kernel name: its normalized SASS} of a library."""
    text = subprocess.run([os.path.join(bin_dir, "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    kernels, name, body = {}, None, []
    for line in text.splitlines() + ["Function : <end>"]:
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                labels: Dict[str, str] = {}
                kernels[name] = "\n".join(
                    re.sub(r"\.L_x_\d+", lambda x: labels.setdefault(
                        x.group(0), f".L{len(labels)}"), b) for b in body)
            name, body = m.group(1), []
        elif name and line.strip().startswith("/*"):
            body.append(" ".join(line.split()))
    names = list(kernels)
    plain = subprocess.run([os.path.join(bin_dir, "cu++filt")],
                           input="\n".join(names), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    return {re.sub(r"(FastVariant<[^<>]*), \(int\)0>", r"\1>", p): kernels[n]
            for n, p in zip(names, plain)}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    write = None
    if len(args) == 3 and args[1] == "--write-digest":
        write = Path(args[2])
    elif len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    earlier = Path(args[0])
    sources = SOURCES
    nvcc = _build._nvcc()
    bin_dir = os.path.dirname(nvcc)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        libs, procs = {}, []
        for side, csrc in (("earlier", earlier), ("here", _build.CSRC)):
            for name in sources:
                if not (csrc / f"{name}.cu").is_file():
                    continue   # new here: no earlier kernels
                out = Path(tmp) / f"{side}_{name}.so"
                libs[(side, name)] = out
                procs.append(subprocess.Popen(
                    [nvcc, *_build.NVCC_FLAGS, "-o", str(out),
                     str(csrc / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for p in procs:
            _, err = p.communicate()
            if p.returncode != 0:
                print(err, file=sys.stderr)
                return 2
        for name in sources:
            old = (listing(libs[("earlier", name)], bin_dir)
                   if ("earlier", name) in libs else {})
            new = listing(libs[("here", name)], bin_dir)
            other = [k for k in old if new.get(k) != old[k]]
            print(f"sass_diff {name}: {len(old)} earlier kernels, "
                  f"{len(old) - len(other)} identical here, {len(other)} "
                  f"missing or different; {len(set(new) - set(old))} new")
            for k in other:
                print(f"  differs: {k}")
            ok &= not other
        if write is not None:
            write.write_text(json.dumps({
                "nvcc": nvcc_release(nvcc), "flags": list(_build.NVCC_FLAGS),
                "kernels": {name: digest(libs[("earlier", name)], bin_dir)
                            for name in sources
                            if ("earlier", name) in libs}},
                indent=1, sort_keys=True)
                + "\n")
            print(f"sass_diff: wrote the earlier tree's digest to {write}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
