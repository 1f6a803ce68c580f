"""P17 (``probes/s2_u32t.py:build``) on the card: the stage-1 A registers
built from u32 words of (n1, n1 + 1) pairs, raw bytes with the -127
offset folded after stage 1 (``u32t``), against the 6-product scheme
(``base``).

Run: ``python -m rtl_power_fftw_tpu_torch.probes.s2_u32t
[variant[:tile] ...] [--device cpu|cuda]``. Prints one line per variant
(the default list: the TPU probe's own), ``name tile per-step µs GS/s
max_rel``, with the Hopper variant it runs in brackets; tile is the frames
one block sums. See
:mod:`rtl_power_fftw_tpu_torch.ops.kernels.fused_psd_probe` for the
variants.
"""

import sys

from ._timing import run_probe


def main(argv=None) -> int:
    return run_probe("P17", argv)


if __name__ == "__main__":
    sys.exit(main())
