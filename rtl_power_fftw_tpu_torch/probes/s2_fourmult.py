"""P14 (``probes/s2_fourmult.py:build``) on the card: stage 2 as the
4-mult complex product (``v7``) against the 6-product Karatsuba (``v6``).

Run: ``python -m rtl_power_fftw_tpu_torch.probes.s2_fourmult
[variant[:tile] ...] [tone] [--device cpu|cuda]``. Prints one line per
variant (the default list: the TPU probe's own), ``name tile per-step µs
GS/s max_rel``, with the Hopper variant it runs in brackets; tile is the
frames one block sums; ``tone`` runs on the TPU probe's 35 dB tone. See
:mod:`rtl_power_fftw_tpu_torch.ops.kernels.fused_psd_probe` for the
variants.
"""

import sys

from ._timing import run_probe


def main(argv=None) -> int:
    return run_probe("P14", argv)


if __name__ == "__main__":
    sys.exit(main())
