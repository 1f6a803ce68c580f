"""The port's probe entry points: the stage-attribution, stage-2, stage-1
packing, Karatsuba and K-stacking probes of the TPU kernels, asked of the
port's Hopper kernels.

Each module runs as ``python -m rtl_power_fftw_tpu_torch.probes.<name>
[variant[:tile] ...] [--device cpu|cuda]`` and prints one
line per variant, ``name tile per-step µs GS/s max_rel|(timing only)``:

- ``profile_kernel``: P1 (``probes/profile_pallas.py:build``) on K3's
  template, and K1's cuts (``k1_full``, ``k1_nofft``, ``k1_dqonly``);
  also P2 ``pack8``, P6 ``pack8c``, P5 ``s1wide``, P3 ``dg3dall``, P4
  ``s1cat``, P7 ``s1k32``/``s1k96``, P8 ``best``, P9 ``v5``/``v5left``
  and P10 ``v6``/``v6k`` (the same module's other builds);
- ``s1_lanes``: P18 (``probes/s1_lanes.py:build``);
- ``s1_lanes2``: P13 (``probes/s1_lanes2.py:build``);
- ``cast_test``: P12's nine relayouts (``probes/cast_test.py``);
- ``s2_fourmult``: P14 (``probes/s2_fourmult.py:build``), also ``tone``;
- ``s2_left``: P16 (``probes/s2_left.py:build``), also ``tone``;
- ``s2_ilv``: P19 (``probes/s2_ilv.py:build``);
- ``s2_pipe``: P11 (``probes/s2_pipe.py:build``);
- ``s2_u32t``: P17 (``probes/s2_u32t.py:build``).

They run on the card unless ``--device cpu`` is given. On the card a step
is the TPU probes' F = 4096 frames; on the CPU they run the plain versions
on 16 frames and time nothing. The variants and their plain
versions are in :mod:`rtl_power_fftw_tpu_torch.ops.kernels.fused_psd_probe`.
"""
