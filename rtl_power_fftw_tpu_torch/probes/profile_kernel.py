"""P1 (``probes/profile_pallas.py:build``) on the card: K3's time with its
stages changed (full, s2x1, s1x1, nomm, notw, dg3d), and P1's question of
K1 (k1_full, k1_nofft, k1_dqonly).

Run: ``python -m rtl_power_fftw_tpu_torch.probes.profile_kernel
[variant[:tile] ...] [--device cpu|cuda]``. Prints one line
per variant (by default all of them), ``name tile per-step µs GS/s
max_rel|(timing only)``, with the Hopper variant it runs in brackets;
tile is the frames one block sums. See
:mod:`rtl_power_fftw_tpu_torch.ops.kernels.fused_psd_probe` for the
variants.
"""

import sys

from ._timing import run_probe


def main(argv=None) -> int:
    return run_probe("P1", argv)


if __name__ == "__main__":
    sys.exit(main())
