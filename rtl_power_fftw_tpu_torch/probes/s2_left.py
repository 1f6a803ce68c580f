"""P16 (``probes/s2_left.py:build``) on the card: the dequantization
offset folded after stage 1 (``e2``), stage 2 with Z as the right operand
(``left``), both (``e2left``), against the 6-product scheme (``base``).

Run: ``python -m rtl_power_fftw_tpu_torch.probes.s2_left
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
    return run_probe("P16", argv)


if __name__ == "__main__":
    sys.exit(main())
