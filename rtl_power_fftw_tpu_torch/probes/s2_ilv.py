"""P19 (``probes/s2_ilv.py:build``) on the card: a block's frames taken
2 (``ilv``) or 4 (``ilv4``) at a time as independent chains, against one
at a time (``base``, the 6-product scheme).

Run: ``python -m rtl_power_fftw_tpu_torch.probes.s2_ilv [variant[:tile]
...] [--device cpu|cuda]``. Prints one line per variant (the default
list: the TPU probe's own), ``name tile per-step µs GS/s max_rel``, with
the Hopper variant it runs in brackets; tile is the frames one block sums,
a multiple of the chains. See
:mod:`rtl_power_fftw_tpu_torch.ops.kernels.fused_psd_probe` for the
variants.
"""

import sys

from ._timing import run_probe


def main(argv=None) -> int:
    return run_probe("P19", argv)


if __name__ == "__main__":
    sys.exit(main())
