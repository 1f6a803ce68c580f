"""P11 (``probes/s2_pipe.py:build``) on the card: a 1-deep software
pipeline of a block's frames (``pipe``: stage 1 of one frame beside stage
2 of the one before, one barrier a frame) against the 6-product scheme
(``base``).

Run: ``python -m rtl_power_fftw_tpu_torch.probes.s2_pipe [variant[:tile]
...] [--device cpu|cuda]``. Prints one line per variant (the default
list: the TPU probe's own), ``name tile per-step µs GS/s max_rel``, with
the Hopper variant it runs in brackets; tile is the frames one block
sums. See :mod:`rtl_power_fftw_tpu_torch.ops.kernels.fused_psd_probe` for
the variants.
"""

import sys

from ._timing import run_probe


def main(argv=None) -> int:
    return run_probe("P11", argv)


if __name__ == "__main__":
    sys.exit(main())
