"""Whether the kernels of an earlier tree compile to the same SASS here.

K3's ``fused_psd_fast`` and the probes' ``fused_psd_probe`` are each
compiled twice with the build's own nvcc flags, from ``csrc/`` and from
the earlier tree's ``csrc/``, and ``cuobjdump -sass`` of the two
libraries is compared kernel by kernel:
every kernel of the earlier build must be in this one with the same
instructions. Names are compared demangled, with the template argument
``S1_FORM = 0`` (``FastVariant``'s last parameter, whose default is the
earlier template) dropped; listings are compared with the whitespace
collapsed (cuobjdump pads its columns to the widest line of the file) and
the branch labels renumbered in each kernel (their numbers run across the
file). Needs nvcc and cuobjdump; no card.

Run: ``git archive <commit> rtl_power_fftw_tpu_torch/ops/kernels/csrc |
tar -x -C DIR`` and then ``python -m
rtl_power_fftw_tpu_torch.ops.kernels.sass_diff
DIR/rtl_power_fftw_tpu_torch/ops/kernels/csrc``. Prints one line per
source and exits 1 if any earlier kernel is missing or differs.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict

from . import _build


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
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    earlier = Path(args[0])
    sources = ("fused_psd_fast", "fused_psd_probe")
    nvcc = _build._nvcc()
    bin_dir = os.path.dirname(nvcc)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        libs, procs = {}, []
        for side, csrc in (("earlier", earlier), ("here", _build.CSRC)):
            for name in sources:
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
            old = listing(libs[("earlier", name)], bin_dir)
            new = listing(libs[("here", name)], bin_dir)
            other = [k for k in old if new.get(k) != old[k]]
            print(f"sass_diff {name}: {len(old)} earlier kernels, "
                  f"{len(old) - len(other)} identical here, {len(other)} "
                  f"missing or different; {len(set(new) - set(old))} new")
            for k in other:
                print(f"  differs: {k}")
            ok &= not other
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
