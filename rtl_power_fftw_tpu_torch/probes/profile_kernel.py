"""P1 (``probes/profile_pallas.py:build``) on the card: K3's time with its
stages changed (full, s2x1, s1x1, nomm, notw, dg3d), and P1's question of
K1 (k1_full, k1_nofft, k1_dqonly); and the module's other builds by the
names its argv takes: P2 ``pack8`` (``build_pack8``), P6 ``pack8c``
(``build_pack8c``), P5 ``s1wide`` (``build_s1wide``, which the TPU ran
at tiles 128 and 256: here ``s1wide s1wide:8``), P3 ``dg3dall``
(``build_dg3dall``), P4 ``s1cat`` (``build_s1cat``), P7 ``s1k32`` and
``s1k96`` (``build_s1k`` at reps 1 and 3; ``s1k96`` runs K3), P8
``best`` (``build_best``, at tiles 128 and 256: ``best best:8``), P9
``v5`` and ``v5left`` (``build_v5``'s kar and left modes; ``v5`` runs K3)
and P10 ``v6`` and ``v6k`` (``build_v6``, narrow and K-stacked; ``v6``
runs the 6-product scheme ``tpu6``).

Run: ``python -m rtl_power_fftw_tpu_torch.probes.profile_kernel
[variant[:tile] ...] [--device cpu|cuda]``. Prints one line per variant
(by default P1's nine, then pack8, as the TPU module's run without argv),
each under its TPU probe's header line,
``name tile per-step µs GS/s max_rel|(timing only)``, with the Hopper
variant it runs in brackets; tile is the frames one block sums. See
:mod:`rtl_power_fftw_tpu_torch.ops.kernels.fused_psd_probe` for the
variants.
"""

import sys

from ._timing import run_probe


def main(argv=None) -> int:
    return run_probe("P1", argv)


if __name__ == "__main__":
    sys.exit(main())
