"""P18 (``probes/s1_lanes.py:build``) on the card.

Run: ``python -m rtl_power_fftw_tpu_torch.probes.s1_lanes [variant[:tile] ...]
[--device cpu|cuda]``. Prints one line per variant (the
default list: the TPU probe's own), ``name tile per-step µs GS/s
max_rel|(timing only)``, with the Hopper variant it runs in brackets;
tile is the frames one block sums. See
:mod:`rtl_power_fftw_tpu_torch.ops.kernels.fused_psd_probe` for the
variants.
"""

import sys

from ._timing import run_probe


def main(argv=None) -> int:
    return run_probe("P18", argv)


if __name__ == "__main__":
    sys.exit(main())
