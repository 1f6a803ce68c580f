"""Smoke run of rtl_power_fftw_tpu_torch on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):

1. machine: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: compiles every CUDA source in ``ops/kernels/csrc`` with nvcc,
   one process per source, started together; ptxas's registers and spill
   of every instantiation (24 of the large kernel's radix-2 control, 24
   of its register passes), each large-N pass's registers, spill, shared
   memory and blocks per SM at every N, and every kernel of the libraries
   of ``sass_diff.SOURCES`` (the estimators' three and the library
   estimators' three among them) held to the SASS of
   ``ops/kernels/sass_digest.json``, written by ``sass_diff
   --write-digest`` from a tree's ``csrc/`` (the parent tree's kernels
   and the instantiations its change added, once ``sass_diff`` held the
   parent's kernels unchanged);
3. K1 (``fused_psd``, the register transform of ``fused_psd_regs.cuh``)
   against its plain PyTorch version on the card, at the shapes the main
   path gives it and at N = 256, 2048, 16384, with a masked ``n_valid``
   case, against a float64 transcription of
   ``tests/golden.py:golden_accumulate``, run twice for determinism, and
   its admission yard: 60 seeds of 35 dB tones, unwindowed, at N = 256,
   2048 and 16384 against the scipy float32 FFT of the same frames (the
   FFTW-class error budget), with the per-seed p99 of the ratio;
4. K2 (``fused_psd`` with a window) against its plain version and the
   windowed float64 golden (Hann and Blackman, N = 256, 2048, 8192, one
   masked case, run twice for determinism), and its admission yard: 60
   seeds of 35 dB tones with a Hann window at N = 2048, 8192 (BASELINE
   config 2's size) and 16384 against the scipy float32 FFT of the same
   windowed input, with the per-seed p99 of the ratio;
5. K3 (``fused_psd_fast``, ``--precision high``; the kernel of
   ``fused_psd_fast_smem.cuh``) against its plain version and
   the golden, unwindowed, Hann and Blackman, at the step the
   ``--precision high`` drive gives it, run twice for determinism, a
   frame of each case bit for bit the control's (K3 as it was before,
   ``fused_psd_fast_control``), its registers, spill, shared memory and
   blocks per SM at every N, and under 12 seeds of 35 dB tones against
   the JAX fast scheme's own error on the same realizations;
6. K4 (``fused_psd_streams``, the ``--streams`` step) against its plain
   version, the per-stream float64 golden and K1 (or K2) run on each
   stream's own frames and count, at BASELINE config 5's step (16
   streams, 2048 bins, 256 frames), at 4 streams of 8192 bins with Hann,
   at 3 streams of 256 bins with counts (F, 0, 5) and at the windowed
   streams scan drive's own step (4 streams, 256 bins, Hann, the frames
   per step its acquisition picks, 32 valid frames per stream), each run
   twice for determinism, rows of zero count exactly 0; then 12 seeds of
   35 dB tones at config 5's step, the combined sum against the scipy
   float32 FFT (the FFTW-class budget);
7. times a call of K1, K2, K3, K4, the large-N kernel, their plain
   versions and ``torch.fft.fft`` with CUDA events (the host's enqueue
   counted where it is the longer), and beside them the device times of
   each kernel and of ``torch.fft.fft`` (CUDA events around calls queued
   behind a sleep kernel, so that the host's enqueue is not counted); at
   each K1/K2 shape the radix-2 kernel K1 and K2 were
   (``fused_psd_probe.radix2_psd``, the control) before and after them,
   both ways, the ratios printed; K1 at N = 2048, F = 4096 and K2 at
   N = 8192, F = 1024 with Hann must take at most half the control's
   device time. At each large-N shape (32768 F=32, 65536 Hann F=16, 2^20
   F=8 unwindowed and Hann, 2^22 F=8) the large kernel's radix-2 passes
   (``fused_psd_probe.large_radix2_psd``, with the wrapper they had) are
   the control, before and after it both ways, within 1e-5 of it, and
   the host part of a call of each wrapper (no sync) is timed; the
   register passes must take at most half the control's device time at
   2^20 F=8 (config 3's step) and at most the control's at the others.
   At each K3 shape (2048 F=4096 unwindowed and Hann, 8192 F=1024, the
   drive's 2048 F=400 Blackman) K3 as it was (``fused_psd_fast_control``,
   with its wrapper and grid) is the control the same way, within 2e-5
   of the kernel, the host parts timed too; the kernel must take at most
   0.6 of the control's device time at 2048 F=4096 unwindowed and at
   most the control's at the others; then K3's stage split at 2048
   F=4096, unwindowed and Hann, from its cuts (``fused_psd_fast_cut``);
8. end to end through ``cli.main`` in-process: the canonical 2048-bin
   20,000-spectrum drive (K1), a hopping matrix drive with a dead hop
   (K1), BASELINE config 2 (8192 bins, Hann, 50% Welch overlap; K2)
   against a float64 Welch transcription of the recorded stream, fed
   back to itself with ``-B``, a ``--precision high`` drive with a
   Blackman window file (K3), BASELINE config 5 (``--streams 16``; K4)
   against the float64 golden of the 16 recorded streams, and a windowed
   hopping matrix drive over 4 streams with a dead hop (K4 windowed).
   Then BASELINE config 3 (``-b 1048576 -t 10``, the large-N kernel)
   against the float64 golden of its recorded stream, a windowed
   large-N drive (``-b 65536 --window-function hann``), and a sweep of
   8-spectrum matrix-mode drives at every size the large kernel takes
   (32768 to 2^22), unwindowed and with Hann, each against its recorded
   stream's golden (1e-5, or 3x the scipy float32 FFT's error on the same
   frames where that is larger).
   Every launch counter is reset just before each drive; the drive's
   kernel must have launched and no plain version may have run;
9. the large-N kernel (``fused_psd_large``, K1/K2 from 32768 and P15 at
   2^20): against its plain version and the float64 golden at every size
   from N = 32768 to 2^22, with and without windows and masked, each run
   twice for determinism; its 60-seed tone yard at 32768, 65536 and 2^20,
   unwindowed and Hann, against the scipy float32 class with the
   per-seed p99; its times, and ptxas's register and spill lines for
   every instantiation. (Runs before the drives; numbered here for the
   kernels line.)
10. a profile of the config 3 drive under ``torch.profiler``: device time
   by kernel and copy per step (pass A, pass B and the row sums apart;
   the result's read-back into pinned memory among them), and the
   device's busy share of the wall; and one more
   config 5 drive with the consumer's calls timed on its own thread: its
   rounds split into waiting for the producers, filling the pinned slot,
   the upload, the step's enqueue, the event waits and the float64
   accumulation;
11. the stage-attribution, stage-2, stage-1 packing, Karatsuba and
   K-stacking probes (``fused_psd_probe``: P1, P18, P13, P14, P16, P19,
   P11, P17, P2, P6, P5, P3, P4, P7, P8, P9 and P10 as variants of K3's
   template, K1's cuts, P12's relayouts), right after the build: every
   variant against its plain version at N = 2048,
   F = 4096, with all frames valid and with 1000, twice for determinism;
   P1 ``full`` and ``dg3d``, P2 ``pack8`` and P9 ``v5left`` bit-identical
   to the shipping K3, ``k1r_full`` to K1 and ``k1_full`` (the radix-2
   control) within 1e-5 of it, the layout variants and the
   schedules (P19 ``ilv``, ``ilv4``, P11 ``pipe``) of the 6-product
   scheme and its order from Z's 3-term split planes (``tpu6_zplanes``)
   to its ``full``, P17 ``u32t`` to P16 ``e2``, P4 ``s1cat`` to P3
   ``dg3dall``; P10 ``v6k``'s largest difference from the 6-product
   scheme printed; P12 equal to torch's
   reshape/permute; ptxas's
   registers and spills of every instantiation at N = 2048 (the shipping
   K1's and K3's beside them, and K1's blocks per SM at every size);
   each variant's slope time (the probes' own
   method), its plain version's, its bound and ``torch.fft.fft``'s;
   and device time by kernel under ``torch.profiler`` for K3, ``dg3d``,
   the radix-2 kernel, K1 and the gather cut (the row sum's own time
   beside each group kernel's); K1's cuts again at the canonical step
   (F = 400) beside ``torch.fft.fft``; then each variant's registers,
   spill, shared memory and resident blocks per SM, and its time again
   with its occupancy pinned
   to that of the whole kernel it is compared with (K3's and the
   6-product scheme's for K3's template, and for the 6-product scheme's
   variants, the left forms (P9 ``v5left`` among them), K3 and the other
   variants that get fewer blocks than K3 also the least any of the
   6-product family gets; the radix-2 kernel's for its cuts, K1's for
   K1's), its output unchanged;
12. the probes' entry points (``python -m
   rtl_power_fftw_tpu_torch.probes.{profile_kernel,s1_lanes,s1_lanes2,
   cast_test,s2_fourmult,s2_left,s2_ilv,s2_pipe,s2_u32t}``, and
   ``profile_kernel pack8c s1wide s1wide:8``, ``profile_kernel dg3dall
   s1cat s1k32 s1k96 best best:8``, ``profile_kernel v5 v5left v6
   v6k`` and the register kernel's cuts, ``profile_kernel k1r_full
   k1r_dqonly k1r_nofft``) in-process, each with every launch
   counter reset just before it: exit 0, one line per variant run, and
   every one of those variants launched (the probes' ``launches`` are
   this run's); then ``profile_kernel`` again over a
   sweep of frames per block (``variant:tile``) for K3, ``dg3d``, the
   radix-2 kernel and K1,
   and ``s2_pipe`` and ``s2_ilv`` at 16 frames a block, their launches on
   lines of their own.

13. the awkward-N kernels (``fused_psd_mixed``: even 7-smooth N up to
   16384; ``fused_psd_bluestein``: the chirp-Z kernel, any even N up to
   8192; and their streams entries): against their plain versions and the
   float64 golden at N = 500 (the man-page drive's step), 2400 (also Hann
   and masked), 12000, 998 (also Hann and masked, and the -b 998 drive's
   step, its last masked) and 8182, and the streams entries at counts
   (F, 0, 5) and at the two-stream drives' steps (500 x 120 frames, 998 x
   824), each run twice for determinism,
   (the streams entry at 510 with Hann also held to 1.1e-6 of the golden,
   plain's distance beside), and a sweep of every even 7-smooth N to
   16384 and a spread of even N to 8192 through the chirp-Z kernel (8
   frames each);
   their 60-seed tone yards (500, 2400 unwindowed, 6000 Hann; 998
   unwindowed and Hann) against the scipy float32 class with the
   per-seed p99; a call, the device's and the wrapper's host time at
   500 (F = 32, and the man-page drive's step, 120), 2400/4096, 998/4096,
   8182/1024 and the streams entries at 2 x 2048 frames of 2400 and 998,
   beside ``torch.fft.fft`` and the bound (k1_work's count, log2 N
   real); the man-page drive
   (``-f 144.1M:146.1M -b 500 -n 100 -m``, its .bin against the golden of
   the recorded stream), its two-stream form, and -b 998 tone drives
   (one and two streams), each through its kernel alone.
14. the estimator kernels (``fused_psd_sk``: spectral kurtosis, K1/K2's
   group kernel with a second sum of |X|^4, in a shared-memory plane up
   to 8192 bins, in registers (the control, the kernel it was
   redesigned from) at 16384;
   ``fused_psd_tapers``: the multitaper, one block running every taper
   of its frames from a shared-memory ring of raw frames where it fits,
   else the control, K2's kernel with a taper axis on its grid;
   ``fused_psd_pfb``: the polyphase filterbank, K1's transform after a
   P-row load, from a shared-memory ring of raw rows where it fits, else
   the control, P rows a frame through L2): their registers, spill,
   shared memory and blocks per SM at 256, 2048 and 16384 bins, each new
   kernel beside its control; against their plain versions and the
   float64 golden, twice each (SK at 2048 F=4096, Hann masked, the
   drive's step with the gate, 256, 16384; SK's s1 against K1's/K2's
   output bit for bit, every row against the control's bit for bit, and
   the gate's rows against ``sk_keep`` of its own moments; multitaper K =
   7 (also masked) and 1 at 2048, the drive's step, 16384 K = 4, 256 F
   = 1024 K = 7, 8192 F = 256 K = 7, 1024 F = 800 K = 16 and 4096 F = 200
   K = 7, each on the route and on the control, with their device times
   in turns (the route at most 1.05 of the control's where it is the
   batch kernel); the PFB at P = 2, 4, 16
   (F = 512) and P = 4 at the drive's step, at F = 4096 and at 16384
   bins, each over three steps of one stream, the second with fewer
   valid frames than P - 1, the history on the card equal to plain's,
   output and history the control's bit for bit on the same grid; a step
   of fewer than 64 frames held by its error over the mean power against
   the float64 golden, plain's beside it; the timed shapes within 1e-5 of
   plain too);
   60-seed tone yards of SK's s2, the multitaper (K = 7) and the PFB (P =
   4) against the scipy float32 class; the drives ``-b 2048 --sk-file``
   (unwindowed and Hann; the SK file against the float64 SK of the
   recorded stream), ``--sk-excise 3`` on a recorded stream with a tone
   burst in one of four 256-frame blocks, ``--multitaper 7``,
   ``--pfb-taps 4`` and a two-hop matrix-mode scan with it (each hop
   against its own frames from a reset history), each through its kernel
   alone (the new kernels: no control and no plain launch); a call, the
   device's and the wrapper's host time at 2048 F=4096 and at the drives'
   step beside the control's (device time at most 1.05 of it),
   ``torch.fft.fft`` on the same transforms and the bound.

15. the large awkward-N kernels (``fused_psd_mixed_large``, ML: the
   four-step mixed-radix kernel, even 7-smooth N from 16386 to 2^22 that
   are not powers of two; ``fused_psd_chirp_large``, BL: the three-pass
   chirp-Z kernel, the other even N from 8194 to 2^21): each pass's
   registers, spill, shared memory and blocks per SM; against their
   plain versions and the float64 golden, twice each (the same bits), at
   ML 20000 F=256 Hann, 49152 F=128, 100000 F=64 (and masked, Blackman),
   10^6 F=8, and BL 16382 F=256, 20002 F=256 Hann, 99998 F=64 (and
   masked), 499998 F=8 (M = 2^20) and 2^21 F=8; a spread of 31 ML and 15
   BL sizes (4 frames, within 1e-5 of the golden or 3x the scipy float32
   class on the same frames); their 60-seed tone yards (ML 20000 and
   Hann, 100000, 10^6; BL 16382, 99998, 2^21) against the scipy float32
   class with the per-seed p99; a call, the device's and the wrapper's
   host time at each unmasked shape beside the plain version,
   ``torch.fft.fft`` and the bound (``awkward_bound_ms``); and six drives
   on the line source, each through its kernel alone: ``-b 100000``,
   ``-b 20000`` Hann with 50% Welch overlap, ``-b 1000000 -m`` (8
   spectra, the ``.bin`` row against the golden), ``-b 16382
   --fft-backend bluestein``, ``-b 99998 -m`` and ``-b 20002`` Hann; the
   two matrix drives once more under ``torch.profiler``, device time by
   pass.

16. the estimators' streams entries (``fused_psd_sk_streams``,
   ``fused_psd_tapers_streams``, ``fused_psd_pfb_streams``: each
   single-stream kernel with S folded into its grid, the counts on the
   device) at BASELINE config 5's step (16 streams, 2048 bins, 256 frames)
   with uneven counts (0 and F among them): against their plain versions
   and the per-stream float64 golden (SK windowed and not, with and
   without the gate; MT at K = 7, the batch kernel, and K = 2, the
   control; the PFB over three steps and a ``reset()``), twice each; each
   stream's rows the single-stream kernel's on the same grid bit for bit
   (SK's s1 K4's rows, its gate each stream's own ``sk_keep``), the PFB's
   histories plain's and the virtual rows'; 60-seed yards of the three
   (16 streams of 16 frames) against the scipy float32 class; four
   drives through ``cli.main``, each on its streams kernel alone:
   ``--streams 16 --sk-file`` (its SK file, M = 16 x 1024, against the
   float64 SK), ``--streams 16 --sk-excise 3`` on 16 recordings with a
   burst in one stream's block, ``--streams 16 --multitaper 7`` and a
   two-hop ``--streams 4 --pfb-taps 4`` matrix scan; a call, the
   device's and the wrapper's host time of each entry at the step with
   every frame valid, beside 16 single-stream calls, the plain version,
   ``torch.fft.fft`` on the same transforms and the bound (the
   multitaper's streams control in turns beside it).

17. the streams entries of the large kernel (``fused_psd_large_streams``,
   L-S), ML (``fused_psd_mixed_large_streams``, ML-S) and BL
   (``fused_psd_chirp_large_streams``, BL-S): each pass with S folded
   into its grid, the counts on the card. At S = 4 with counts (0, 1,
   F - 1, F), unwindowed and with Hann (L-S 32768 F=16 and F=64, 2^20
   F=8; ML-S 20000 F=16, 100000 F=64; BL-S 16382 F=16, 99998 F=64):
   twice each (the same bits), each stream's row the one-stream kernel's
   on the same frames, count and groups bit for bit, against the plain
   version and the per-stream float64 golden by the error over the mean
   (plain's distance beside), zero rows exact; ``parallel/longint.py``'s
   ``sharded_accumulate`` at 2^20 on the card (L-S at S = 1), the
   one-stream kernel's bits; 60-seed yards (L-S 65536 Hann, ML-S 20000,
   BL-S 16382; 4 streams of 16 frames) against the scipy float32 class;
   a call, the device's and the wrapper's host time at S = 4 (L-S 2^20
   F=8 and 65536 F=16 Hann, ML-S 10^6 F=8 and 100000 F=64, BL-S 99998
   F=64 unwindowed and Hann) beside S one-stream calls (device time in
   turns), the plain version, ``torch.fft.fft`` on the S F frames and the
   bound; four drives through ``cli.main``, each on its streams kernel
   alone, against the mean of the per-stream float64 goldens of the
   recorded streams: ``--streams 4 -b 1048576 -t 10`` (config 3's bins
   over four receivers), ``--streams 2 -b 100000``, ``--streams 2 -b
   99998 --window-function hann`` and ``--streams 2 -b 32768
   --window-function hann``.

18. the library estimators' kernels: FR (``fused_psd_frames``, K1's
   group kernel storing each valid frame's fftshifted |X|^2 or its X),
   PFB-C (``fused_psd_pfb.pfb_channelize``, the PFB's load and transform
   storing each output frame's X), CSD (``fused_psd_csd``, the four sums
   of two streams' spectra) and SCF (``fused_psd_scf``, the sums of
   shifted products of X over lags): registers, spill, shared memory and
   blocks per SM at 64, 2048 and 16384 bins; each against its plain
   version and the float64 golden, twice (the same bits), at N = 64,
   2048 and 16384, unwindowed and Hann, n_valid 0, 1, F - 1 and F (by the
   error over the golden's mean, 1e-5 or 3x plain's distance where that
   is larger; CSD over the two streams' mean power, SCF over the alpha =
   0 row's mean); FR's |X|^2 rows summed in the two-stage order against
   K1's (K2's) output; PFB-C at P = 1 and 4 (the control's load at 16384
   bins, P = 4), its |X|^2 summed against ``fused_psd_pfb`` on the same
   rows; 60-seed tone yards at N = 2048, F = 64 (FR's rows, PFB-C's X,
   CSD's four sums with Hann, SCF's rows k >= 1 of K = 16) against the
   scipy float32 class on the same realizations; ``models.spectrogram``
   (2 s at 2.048 MS/s, hop 1024, average 4, Hann: 4 launches),
   ``models.pfb_channelize`` (M = 2048, P = 4, 4 s), ``models.coherence``
   (two 1 s streams sharing the tone, Hann: gamma2 ~1 at the tone, low
   elsewhere and at DC) and ``models.spectral_correlation`` (K = 16 on an
   AM signal: the peak off alpha = 0 at the modulation lag), each against
   a float64 golden of the same bytes and through its kernels alone; a
   call, the device's and the wrapper's host time of each kernel at its
   drive's step beside plain, ``torch.fft.fft`` and the bound, and FR at
   2048 F=4096 beside K1's device time.

19. the CLI estimators at the awkward bin counts (``fused_psd_mixed_est``:
   SK-M, MT-M and PFB-M, forms of the mixed-radix kernel): their
   registers, spill and blocks per SM beside M's at 30..16000 bins; each
   against its plain version and the float64 golden, twice (the same
   bits), at N = 500 (the man-page step), 2400 (F = 4096), 6000 Hann,
   12000, 16000 and 30, n_valid F, F - 1, 1 and 0 (SK with the gate at
   500 and 12000; the PFB as four steps of one stream at P = 4, also 16
   at 500 and 1 at 30, its history plain's and the virtual rows'); SK-M's
   s1 ``fused_psd_mixed``'s output bit for bit there and at each of the
   317 plans phase 13 walks (8 frames, s2 within 2e-5 of the golden);
   60-seed tone yards at 500 and 2400 (SK's s2, also with Hann at 2400,
   MT K = 7, PFB P = 4) against the scipy float32 class; a call, the
   device's time beside M's on the same frames, the wrapper's host time,
   plain, ``torch.fft.fft`` and the bound at 2400 F=4096 and at each
   drive's step; five drives through ``cli.main``, each on its kernel
   alone: the man-page scan with ``--sk-file`` (its .bin and SK file
   against the float64 golden), ``--sk-excise 3`` on the burst stream at
   500 bins, ``-b 2400 -n 4000 --multitaper 7``, ``-b 12000 -n 400
   --pfb-taps 4`` and ``-b 10000 --sk-file --window-function hann``.

20. the CLI estimators at the chirp-Z bin counts (``fused_psd_chirp_est``:
   SK-B, MT-B and PFB-B, forms of the chirp-Z kernel): their registers,
   spill and blocks per SM beside B's at each M from 64 to 16384; each
   against its plain version and the float64 golden, twice (the same
   bits), at N = 22, 998 (the SK drive's step), 4094 with Hann, 8188 and
   2048 (the ``--fft-backend bluestein`` drive's step), n_valid F, F - 1,
   1 and 0 (SK with the gate at 998 and 8188; the PFB as four steps of
   one stream at P = 4, also 16 at 998 and 1 at 22, its history plain's
   and the virtual rows'), and at each drive's own step, full and its
   last, partial one; SK-B's s1 ``fused_psd_bluestein``'s output bit for
   bit in every case; 60-seed tone yards at 998 (64 frames) and 8188 (16)
   (SK's s2 with and without Hann, MT K = 7, PFB P = 4) against the scipy
   float32 class; a call, the device's time beside B's on the same frames
   in turns, the wrapper's host time, plain, ``torch.fft.fft`` and the
   bound at 998 F=4096 and at each drive's step; six drives through
   ``cli.main``, each on its kernel alone: ``-b 998 -n 100 --sk-file``,
   ``--sk-excise 3`` on the burst stream at 998 bins, ``-b 998 -n 4000
   --multitaper 7``, ``-b 4094 -n 400 --pfb-taps 4``, ``-b 8188 --sk-file
   --window-function hann`` and ``-b 2048 --sk-file --fft-backend
   bluestein`` (each SK file against the float64 SK of its frames).

21. the CLI estimators over ``--streams`` at the awkward bin counts (the
   streams forms SK-M-S, MT-M-S, PFB-M-S of ``fused_psd_mixed_est`` and
   SK-B-S, MT-B-S, PFB-B-S of ``fused_psd_chirp_est``: each one-stream
   form with the stream folded into its grid, the counts on the card):
   registers, spill, shared memory and blocks per SM beside the
   one-stream forms' at 500, 2400, 12000, 16000 and 998, 4094, 8188
   bins; each against its plain version and the per-stream float64
   golden (``hold_streams``), twice (the same bits), at S = 2 and 16
   with uneven counts (mixed 500, 2400 Hann, 12000, 16000 Hann, 30;
   chirp-Z 998, 22 Hann, 4094 Hann, 8188, 2048), SK with and without the
   gate; SK's s1 the PSD streams entry's rows (M-S, B-S) bit for bit,
   each stream's rows the one-stream form's on the same groups, the gate
   each stream's own ``sk_keep`` and a burst in one stream gating that
   stream alone; the PFB over three steps and a reset, its histories
   plain's, the virtual rows' and the one-stream form's; 60-seed yards at
   500 and 998 (2 streams of 32 frames; SK's s2 with and without Hann,
   MT K = 7, PFB P = 4); a call, the device's time beside two one-stream
   calls and M-S / B-S in turns, the wrapper's host time, plain,
   ``torch.fft.fft`` and the bound at S = 2, F = 2048 (2400 and 998
   bins), and the device time at each drive's step; nine drives through
   ``cli.main``, each on its streams form alone: the man-page scan
   ``--streams 2 --sk-file``, ``--streams 2 --pfb-taps 4 -b 500``,
   ``--streams 2 --sk-file -b 998``, ``--streams 2 --sk-excise 3 -b
   998`` on two recordings with a burst in one, ``--streams 4
   --multitaper 7 -b 2400``, ``--streams 2 --sk-file -b 2048
   --fft-backend bluestein``, ``--streams 16 --frames-per-step 256 -b
   500 --sk-file`` (config 5's shape at the man page's bins),
   ``--streams 2 --multitaper 7 -b 998`` and ``--streams 2 --pfb-taps 4
   -b 4094`` (each SK file against the float64 SK of every stream's
   frames).

22. the CLI estimators at the large chirp-Z bin counts
   (``fused_psd_chirp_large_est``: SK-BL, MT-BL and PFB-BL on BL's
   passes at M = 2^15, each written once for S >= 1 streams; SK-BL-S,
   MT-BL-S, PFB-BL-S their calls over streams): each pass's registers,
   spill and blocks per SM beside BL's (spill at most BL's); each form
   against its plain version and the per-stream float64 golden
   (``hold_streams``, phase 21's few-frame rule), twice (the same bits),
   on one stream at N = 16382 (F = 256), 9998 with Hann, 12002, 8194 and
   16384, n_valid F, F - 1, 1 and 0 (the PFB as four steps), and at S = 2
   (16382) and 4 (9998 with Hann) with uneven counts (the PFB over four
   steps and a reset), SK with and without the gate; SK's s1 BL's (BL-S's)
   rows bit for bit, each stream's rows and history the S = 1 form's on
   the same groups; the same at each drive's own step, every frame valid
   and its last step's count among uneven ones; 60-seed yards of each
   form (16382, 16 frames; 9998, two streams of 8); a call, the device's
   time beside BL (BL-S) and, over streams, two one-stream calls in turns,
   the wrapper's host time, plain, ``torch.fft.fft`` and the bound at
   16382 F = 256 and S = 2 F = 128, and the device time at each drive's
   step; eight drives through ``cli.main``, each on its form alone: ``-b
   9998 --sk-file``, ``--sk-excise 3`` on the burst stream at 9998 bins,
   ``-b 16382 --multitaper 7``, ``-b 12002 --pfb-taps 4``, ``-b 16384
   --sk-file --fft-backend bluestein`` and, over ``--streams 2``, ``-b
   9998 --sk-file``, ``-b 16382 --multitaper 7`` and ``-b 12002
   --pfb-taps 4`` (each SK file against the float64 SK of its frames).

Every kernel entry of the ``{"kernels": [...]}`` line carries its bound
(the larger of its bytes over 3.35 TB/s and its operations over the
card's peak for their type, from the entry's shape), its launches in its
drive, and the time of ``torch.fft.fft`` on the same frames already in
complex64 on the card (the transform alone, not the whole function). Its
``ms``, ``plain_ms`` and ``library_ms`` are phase 7's times a call, its
``device_ms`` the kernel's device time (a probe's: its slope time, for
both ``ms`` and ``device_ms``); where a control was timed (the radix-2
kernels, K3's earlier kernel), ``control_ms`` and ``control_device_ms`` are
its, and for the large kernel and K3 ``host_ms`` and ``control_host_ms``
the two wrappers' host parts.

Stdout ends with that line and then the result line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

CSRC = "rtl_power_fftw_tpu_torch/ops/kernels/csrc/"
TPU_KERNEL = "rtl_power_fftw_tpu/ops/kernels/fused_psd.py:"
UNIFORM_RTOL = 1e-5
GOLDEN_RTOL = 1e-5
# The chirp-Z streams entry at N = 510 with Hann: its distance from the
# float64 golden (5.1e-7 on an H100; plain's, cuFFT's, 1.1e-6).
CHIRP510_GOLDEN_RTOL = 1.1e-6
# K3 against its plain version: the same split, terms and bf16 products;
# only the order of f32 sums differs (tensor-core accumulation against
# cuBLAS f32), so a per-bin relative bound far inside the relaxed tier.
FAST_VS_PLAIN_RTOL = 2e-5
# The relaxed tier (tests/test_kernels.py:144) and the JAX fast kernel's
# documented floors (fused_psd.py:300-302): ~2e-6 uniform, ~4e-5 under a
# 35 dB tone.
RELAXED_RTOL = 1e-4
FAST_FLOOR_UNIFORM = 2e-6
FAST_FLOOR_TONE = 4e-5
# The drives' synthetic source: a 35 dB tone at 100.2 MHz, 2 MS/s.
SOURCE = "synthetic:tone=100.2M/35,noise=6,seed=1"
RATE = 2_000_000
# BASELINE config 5 (bench_configs.py:159-198): 16 streams.
C5_STREAMS = 16
# The large-N drives' source: a weak line (amplitude 2 counts, under the
# noise's 6) in noise, as long integrations look for. Under SOURCE's
# stronger tone the float32 error of any FFT at 2^20 (the scipy float32
# class's too) exceeds 1e-5 of the golden in the bins far below the tone;
# the tone yard holds the kernel to that class instead.
LINE_SOURCE = "synthetic:tone=100.2M/2,noise=6,seed=1"
# BASELINE config 3 (bench_configs.py:149-153): 2^20 bins; -t 10 cuts its
# time-limited continuous accumulation to 10 s of stream (20 spectra).
C3_N = 1 << 20
C3_SECONDS = 10
# The card's published peaks (NVIDIA's H100 SXM data sheet, at 700 W):
# device memory, FP32 on the CUDA cores, dense bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
# The windowed hopping matrix drive over 4 streams (K4 windowed), less its
# "-m <path>".
STREAMS_SCAN_ARGV = ["-f", "100M:106M", "-n", "32", "-b", "256",
                     "--streams", "4", "--window-function", "hann", "-q",
                     "--source",
                     "synthetic:tone=104.9M/40,noise=5,seed=2,dead=103M"]


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


_POOL = None


def host_pool() -> concurrent.futures.ThreadPoolExecutor:
    """The yards' pool for their host-side work a seed (numpy goldens,
    the scipy float32 class, the errors): numpy and scipy.fft release the
    GIL, so the seeds' host work runs on the host's cores while the main
    thread makes the card's calls. Each seed's numbers are those a serial
    loop gives."""
    global _POOL
    if _POOL is None:
        _POOL = concurrent.futures.ThreadPoolExecutor(
            max_workers=os.cpu_count() or 4)
    return _POOL


def max_rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1e-30)).max())


def golden_partial(raw: np.ndarray, n_valid: int,
                   window=None) -> np.ndarray:
    """float64 transcription of tests/golden.py:golden_accumulate over the
    first ``n_valid`` frames, returned in unshifted bin order (the
    reference's (-1)^n flip pre-shifts; ifftshift undoes it)."""
    N = raw.shape[1] // 2
    flip = np.where(np.arange(N) % 2 == 0, 1.0, -1.0)
    if window is not None:
        flip = flip * np.asarray(window, np.float64)
    pwr = np.zeros(N, np.float64)
    for lo in range(0, n_valid, 256):
        part = raw[lo:min(lo + 256, n_valid)].astype(np.float64)
        z = (part[:, 0::2] - 127.0) + 1j * (part[:, 1::2] - 127.0)
        X = np.fft.fft(z * flip, axis=1)
        pwr += (X.real ** 2 + X.imag ** 2).sum(axis=0)
    return np.fft.ifftshift(pwr)


def golden_finalize_linear(pwr_shifted: np.ndarray, repeats: int,
                           rate: int) -> np.ndarray:
    """tests/golden.py:golden_finalize with linear=True, vectorized."""
    p = pwr_shifted.copy()
    N = len(p)
    p[N // 2] = (p[N // 2 - 1] + p[N // 2 + 1]) / 2.0
    return p / repeats / N / rate


def tone_frames(N: int, F: int, seed: int) -> np.ndarray:
    """A 35 dB tone (amplitude 100 over unit noise) at a random frequency
    and phase, as in tests/test_numerics.py."""
    rng = np.random.default_rng(seed)
    f0 = rng.uniform(0.05, 0.45)
    ph = rng.uniform(0, 2 * np.pi)
    t = np.arange(F * N)
    x = 100.0 * np.exp(1j * (2 * np.pi * f0 * t + ph)) + (
        rng.standard_normal(F * N) + 1j * rng.standard_normal(F * N))
    re8 = np.clip(np.round(x.real + 127), 0, 255).astype(np.uint8)
    im8 = np.clip(np.round(x.imag + 127), 0, 255).astype(np.uint8)
    return np.stack([re8, im8], axis=-1).reshape(F, 2 * N)


def scipy_f32_class(raw: np.ndarray, window=None) -> np.ndarray:
    """The FFTW-class yardstick: scipy's float32 FFT of the same (windowed)
    input, |X|^2 summed over frames in float64, unshifted bins."""
    import scipy.fft
    z = ((raw[:, 0::2].astype(np.float64) - 127.0)
         + 1j * (raw[:, 1::2].astype(np.float64) - 127.0))
    if window is not None:
        z = z * np.asarray(window, np.float64)
    Xc = scipy.fft.fft(z.astype(np.complex64), axis=1)
    return (Xc.real.astype(np.float64) ** 2
            + Xc.imag.astype(np.float64) ** 2).sum(0)


def jax_fast_n1(N: int) -> int:
    """N1 of the JAX fast kernel's split (fused_psd.py:_split): N2 the
    larger of 128 and floor(sqrt(N)) as a power of two."""
    return N // max(128, 1 << ((N.bit_length() - 1) >> 1))


def last_digit_unit(text: str) -> float:
    """One unit in the last printed digit of a decimal number."""
    mant, _, exp = text.lower().partition("e")
    return 10.0 ** (int(exp or 0) - len(mant.partition(".")[2]))


def spectrum(out: str):
    rows = [line.split() for line in out.splitlines()
            if line and not line.startswith("#")]
    return (np.array([float(f) for f, _ in rows]),
            np.array([float(v) for _, v in rows]), [v for _, v in rows])


def event_times_us(fn, iters: int = 60, warmup: int = 10) -> float:
    """Median time of one call on the stream, from CUDA events around
    each: its device time, or the host's enqueue where that is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return 1000.0 * statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_times_us(fn, calls: int = 20, reps: int = 3) -> float:
    """Device time of one call of ``fn``: CUDA events around ``calls``
    calls enqueued behind a sleep kernel that outlasts the host's enqueue
    of them (twice the host time they took, at up to 2 GHz), so that they
    run back to back and no host time is counted; the least of ``reps``.
    A call whose device time is below its host time (a wrapper's Python,
    its allocations and launches) measures that host time per call in
    event_times_us, and its device time here."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    cycles = int(2 * (time.perf_counter() - t0) * 2e9)
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        best = min(best, 1000.0 * start.elapsed_time(end) / calls)
    return best


def host_us(fn, calls: int = 100) -> float:
    """Host time of one call of ``fn`` on the host's clock, with no sync:
    a wrapper's work up to its launches (the queue is never full here);
    the device is waited for after the clock stops."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / calls


def run_cli(argv, main):
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def phase_k2(dev, rng, fp, adapt_batch, make_window):
    """K2 against its plain version and the windowed golden, then its
    60-seed tone yard. Returns K2's max abs error at N=2048 F=4096."""
    cases = [  # (label, N, frames_per_step, n_valid or None, window)
        ("N=256 hann", 256, 1024, None, "hann"),
        ("N=2048 F=4096 blackman", 2048, 4096, None, "blackman"),
        ("N=2048 hann masked", 2048, 4096, 1000, "hann"),
        ("N=8192 hann (config 2 step)", 8192, 104, None, "hann"),
        ("N=8192 F=1024 blackman", 8192, 1024, None, "blackman"),
    ]
    fp.COUNTS.reset()
    max_abs = None
    for label, N, fps, n_valid, wname in cases:
        F, chunk = adapt_batch(fps)
        nv = F if n_valid is None else n_valid
        w_np = make_window(wname, N)
        w = torch.from_numpy(w_np).to(dev)
        raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        got = fp.fused_psd(raw, nv, chunk, w)
        again = fp.fused_psd(raw, nv, chunk, w)
        want = fp.fused_psd_reference(raw, nv, chunk, w)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"K2 {label}: not deterministic")
        got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
        gold = golden_partial(raw_np, nv, w_np)
        err_plain, err_gold = max_rel(got_np, want_np), max_rel(got_np, gold)
        print(f"K2 {label} (N={N} F={F} chunk={chunk} n_valid={nv}): max "
              f"rel vs plain {err_plain:.3e}, vs float64 golden "
              f"{err_gold:.3e} (plain vs golden "
              f"{max_rel(want_np, gold):.3e})")
        check(np.all(np.isfinite(got_np)), f"K2 {label}: non-finite output")
        check(err_plain <= UNIFORM_RTOL, f"K2 {label}: {err_plain} vs plain")
        check(err_gold <= GOLDEN_RTOL, f"K2 {label}: {err_gold} vs golden")
        if label.startswith("N=2048 F=4096"):
            max_abs = float(np.abs(got_np.astype(np.float64) - want_np).max())
    check(fp.COUNTS.kernel_windowed == 2 * len(cases)
          and fp.COUNTS.kernel == 0 and fp.COUNTS.plain == 0,
          f"K2 launch counter did not move as expected: {vars(fp.COUNTS)}")

    # Admission yard (ROADMAP): 60 seeds, Hann, 35 dB tones.
    tone_yard("K2", dev, fp, make_window, "hann",
              ((2048, 64), (8192, 64), (16384, 32)), 3000)
    return max_abs


def tone_yard(label, dev, fp, make_window, wname, sizes, seed0,
              kernel=None, plain_fn=None) -> None:
    """A kernel's admission yard (ROADMAP North star): 60 seeds of 35 dB
    tones at each (N, F) of ``sizes`` through ``kernel`` (default
    ``fused_psd``; its plain version ``plain_fn``; windowed by ``wname``,
    or not), against the scipy float32 FFT of the same input: median <=
    1.5x and max <= 3x its error, the per-seed p99 of the ratio
    printed."""
    kernel = kernel or fp.fused_psd
    plain_fn = plain_fn or fp.fused_psd_reference
    for N, F in sizes:
        w_np = None if wname is None else make_window(wname, N)
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        def errors(raw_np, got, plain_got, w_np=w_np, F=F):
            gold = golden_partial(raw_np, F, w_np)
            return (max_rel(got, gold), max_rel(plain_got, gold),
                    max_rel(scipy_f32_class(raw_np, w_np), gold))

        seeds = []
        for seed in range(60):
            raw_np = tone_frames(N, F, seed0 + seed)
            raw = torch.from_numpy(raw_np).to(dev)
            seeds.append(host_pool().submit(
                errors, raw_np, kernel(raw, F, F, w).cpu().numpy(),
                plain_fn(raw, F, F, w).cpu().numpy()))
        ours, plain, cls = zip(*(f.result() for f in seeds))
        e, c = np.asarray(ours), np.asarray(cls)
        r = e / c
        med_r, max_r = np.median(e) / np.median(c), e.max() / c.max()
        print(f"{label} yard N={N} F={F} window={wname}, 60 seeds of 35 dB "
              f"tones: max rel median {np.median(e):.3e} / max "
              f"{e.max():.3e}; scipy f32 {np.median(c):.3e} / "
              f"{c.max():.3e}; plain (cuFFT) {np.median(plain):.3e} / "
              f"{max(plain):.3e}; ratio median {med_r:.2f}x (<= 1.5), max "
              f"{max_r:.2f}x (<= 3), per-seed p99 "
              f"{np.quantile(r, 0.99):.2f}x, per-seed max {r.max():.2f}x")
        check(med_r <= 1.5 and max_r <= 3.0,
              f"{label} yard N={N}: above the FFTW-class budget")


def phase_k3(dev, rng, ff, adapt_batch, make_window, card):
    """K3 (the kernel of fused_psd_fast_smem.cuh) against its plain
    version, the golden and the JAX fast scheme, and a frame of each case
    against the control (its products and per-frame sums, so bit for
    bit); its registers, spill, shared memory and blocks per SM at every
    N. Returns K3's max abs error at N=2048 F=4096."""
    for N in sorted(ff.SMEM_PLAN):
        for windowed in (False, True):
            a = ff.kernel_attributes(N, windowed)
            lay = ff.smem_layout(N, windowed)
            print(f"occupancy fused_psd_fast N={N} "
                  f"{'windowed' if windowed else 'unwindowed'} on {card}: "
                  f"{a['registers']} registers, {a['spill_bytes']} B spill, "
                  f"{a['static_smem']} + {a['dynamic_smem']} B shared, "
                  f"{a['threads']} threads, {a['blocks_per_sm']} blocks/SM "
                  f"(stage weights resident: {int(lay['s1'])}{int(lay['s2'])}"
                  f", Z passes {lay['ZP']}); its k1_group grid aims at "
                  f"{ff.resident_blocks(N, windowed, dev.index)} blocks")
            check(a["blocks_per_sm"] >= 1 and a["dynamic_smem"]
                  == lay["bytes"], f"K3 N={N}: {a} against {lay}")
    ff.COUNTS.reset()
    max_abs = None
    cases = [  # (label, N, frames_per_step, n_valid or None, window, bound)
        ("N=2048 F=4096", 2048, 4096, None, None, 2 * FAST_FLOOR_UNIFORM),
        ("N=2048 F=4096 hann", 2048, 4096, None, "hann",
         2 * FAST_FLOOR_UNIFORM),
        ("N=256 masked", 256, 1024, 700, None, RELAXED_RTOL),
        ("precision-high drive step", 2048, 400, None, "blackman",
         RELAXED_RTOL),
        ("N=8192 F=1024 hann", 8192, 1024, None, "hann", RELAXED_RTOL),
        ("N=16384 F=64 blackman", 16384, 64, None, "blackman", RELAXED_RTOL),
    ]
    for label, N, fps, n_valid, wname, bound in cases:
        F, chunk = adapt_batch(fps)
        nv = F if n_valid is None else n_valid
        w_np = None if wname is None else make_window(wname, N)
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        got = ff.fused_psd_fast(raw, nv, chunk, w)
        again = ff.fused_psd_fast(raw, nv, chunk, w)
        want = ff.fused_psd_fast_reference(raw, nv, chunk, w)
        jax_scheme = ff.fused_psd_fast_reference(raw, nv, chunk, w,
                                                 n1=jax_fast_n1(N))
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"K3 {label}: not deterministic")
        # One frame: the control's products and sums, bit for bit.
        one = raw[:8]
        check(torch.equal(ff.fused_psd_fast(one, 1, 8, w),
                          ff.fused_psd_fast_control(one, 1, 8, w)),
              f"K3 {label}: a frame is not the control's bit for bit")
        got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
        gold = golden_partial(raw_np, nv, w_np)
        err_plain, err_gold = max_rel(got_np, want_np), max_rel(got_np, gold)
        print(f"K3 {label} (N={N} F={F} chunk={chunk} n_valid={nv} window="
              f"{wname}; N1 x N2 = {ff.fast_split(N)}): max rel vs plain "
              f"{err_plain:.3e} (<= {FAST_VS_PLAIN_RTOL:g}), vs float64 "
              f"golden {err_gold:.3e} (<= {bound:g}); plain vs golden "
              f"{max_rel(want_np, gold):.3e}; JAX split "
              f"N1={jax_fast_n1(N)} vs golden "
              f"{max_rel(jax_scheme.cpu().numpy(), gold):.3e}")
        check(np.all(np.isfinite(got_np)), f"K3 {label}: non-finite output")
        check(err_plain <= FAST_VS_PLAIN_RTOL, f"K3 {label}: vs plain")
        check(err_gold <= bound, f"K3 {label}: vs golden")
        if label == "N=2048 F=4096":
            max_abs = float(np.abs(got_np.astype(np.float64) - want_np).max())
    check(ff.COUNTS.kernel == 3 * len(cases) and ff.COUNTS.plain == 0,
          f"K3 launch counter did not move as expected: {vars(ff.COUNTS)}")

    # Under 35 dB tones: within 2x of the JAX fast scheme's own error on
    # the same realizations (its split, run by the plain transcription).
    N, F = 2048, 64
    ours, plain, jax_s = [], [], []
    for seed in range(12):
        raw_np = tone_frames(N, F, 500 + seed)
        gold = golden_partial(raw_np, F)
        raw = torch.from_numpy(raw_np).to(dev)
        ours.append(max_rel(ff.fused_psd_fast(raw, F, 64).cpu().numpy(),
                            gold))
        plain.append(max_rel(ff.fused_psd_fast_reference(raw, F, 64)
                             .cpu().numpy(), gold))
        jax_s.append(max_rel(ff.fused_psd_fast_reference(
            raw, F, 64, n1=jax_fast_n1(N)).cpu().numpy(), gold))
    med_r = statistics.median(ours) / statistics.median(jax_s)
    max_r = max(ours) / max(jax_s)
    print(f"K3 35 dB tone N={N} F={F}, 12 seeds: max rel median "
          f"{statistics.median(ours):.3e} / max {max(ours):.3e}; plain "
          f"{statistics.median(plain):.3e} / {max(plain):.3e}; JAX fast "
          f"scheme (N1={jax_fast_n1(N)}) {statistics.median(jax_s):.3e} / "
          f"{max(jax_s):.3e}; ratios median {med_r:.2f}x, max "
          f"{max_r:.2f}x (<= 2); documented floor {FAST_FLOOR_TONE:g}")
    check(med_r <= 2.0 and max_r <= 2.0,
          "K3 tone error above 2x the JAX fast scheme's")
    return max_abs


def streams_scan_plan(dev) -> dict:
    """The step the streams scan drive runs: its options parsed as the CLI
    parses them, and the shape the multi-stream acquisition builds from
    them (a stand-in source per stream; only their number is read)."""
    from rtl_power_fftw_tpu_torch.config import parse_args
    from rtl_power_fftw_tpu_torch.parallel.multistream import (
        MultiStreamAcquisition)
    params = parse_args(STREAMS_SCAN_ARGV + ["-m", "unused"])
    acq = MultiStreamAcquisition(params, [None] * params.streams, [dev],
                                 frames_per_step=params.frames_per_step)
    return {"S": acq.S, "N": params.N, "F": acq.step.F,
            "chunk": acq.step._chunk, "repeats": params.repeats}


def phase_k4(dev, rng, fp, adapt_batch, make_window, ShardedPsdStep):
    """K4 against its plain version, the per-stream golden and K1/K2 on
    each stream alone, then 35 dB tones at config 5's step. Returns K4's
    max abs error at config 5's step, unwindowed and with Hann."""
    scan = streams_scan_plan(dev)
    cases = [  # (label, S, N, frames_per_step, counts or None for F, window)
        ("config 5 step", C5_STREAMS, 2048, 256, None, None),
        ("config 5 step hann", C5_STREAMS, 2048, 256, None, "hann"),
        ("S=4 N=8192 hann", 4, 8192, 64, None, "hann"),
        ("S=3 N=256 uneven", 3, 256, 64, lambda F: [F, 0, 5], None),
        ("streams scan drive step", scan["S"], scan["N"], scan["F"],
         lambda F: [scan["repeats"]] * scan["S"], "hann"),
    ]
    max_abs = {}
    for label, S, N, fps, counts, wname in cases:
        F, chunk = adapt_batch(fps)
        if label.startswith("streams scan"):
            check((F, chunk) == (scan["F"], scan["chunk"]),
                  f"K4 {label}: step {F}/{chunk} is not the drive's {scan}")
        nv = np.array(counts(F) if counts else [F] * S, np.int32)
        w_np = None if wname is None else make_window(wname, N)
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        raw_np = rng.integers(0, 256, (S, F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        nv_dev = torch.from_numpy(nv).to(dev)
        fp.COUNTS.reset()
        got = fp.fused_psd_streams(raw, nv_dev, chunk, w)
        again = fp.fused_psd_streams(raw, nv_dev, chunk, w)
        want = fp.fused_psd_streams_reference(raw, nv_dev, chunk, w)
        alone = torch.stack([fp.fused_psd(raw[s], int(nv[s]), chunk, w)
                             for s in range(S)])
        torch.cuda.synchronize()
        k4 = ("kernel_streams" if w is None else "kernel_streams_windowed")
        check(getattr(fp.COUNTS, k4) == 2 and fp.COUNTS.plain == 0,
              f"K4 {label}: launch counter {vars(fp.COUNTS)}")
        check(torch.equal(got, again), f"K4 {label}: not deterministic")
        got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
        alone_np = alone.cpu().numpy()
        check(np.all(np.isfinite(got_np)), f"K4 {label}: non-finite output")
        check(not got_np[nv == 0].any(), f"K4 {label}: a zero-count row "
              "is not exactly 0")
        errs = []
        for s in range(S):
            gold = golden_partial(raw_np[s], int(nv[s]), w_np)
            errs.append((max_rel(got_np[s], want_np[s]),
                         max_rel(got_np[s], gold),
                         max_rel(got_np[s], alone_np[s])))
        e_plain, e_gold, e_alone = (max(e[i] for e in errs) for i in range(3))
        group = fp.k1_group(S * F, chunk, fp.resident_blocks(
            N, w is not None, raw.device.index))
        print(f"K4 {label} (S={S} N={N} F={F} chunk={chunk} frames/block "
              f"{group} n_valid="
              f"{nv.tolist() if counts else F}): max rel per stream vs plain "
              f"{e_plain:.3e}, vs float64 golden {e_gold:.3e}, vs "
              f"{'K1' if w is None else 'K2'} on the stream alone "
              f"{e_alone:.3e}")
        check(e_plain <= UNIFORM_RTOL, f"K4 {label}: {e_plain} vs plain")
        check(e_gold <= GOLDEN_RTOL, f"K4 {label}: {e_gold} vs golden")
        check(e_alone <= UNIFORM_RTOL, f"K4 {label}: {e_alone} vs K1/K2")
        if label.startswith("config 5 step"):
            max_abs[wname] = float(np.abs(got_np.astype(np.float64)
                                          - want_np).max())

    # Under 35 dB tones: the combined sum of config 5's step within the
    # FFTW-class budget, median <= 1.5x and max <= 3x the scipy float32
    # FFT's error.
    S, N, F = C5_STREAMS, 2048, 256
    step = ShardedPsdStep([dev], N, F, streams=S)
    full = np.full(S, F, np.int32)
    ours, plain, yard = [], [], []
    for seed in range(12):
        raw_np = tone_frames(N, S * F, 700 + seed)
        gold = golden_partial(raw_np, S * F)
        _, combined = step(raw_np.reshape(S, F, 2 * N), full)
        ours.append(max_rel(combined.cpu().numpy(), gold))
        raw = torch.from_numpy(raw_np.reshape(S, F, 2 * N)).to(dev)
        plain.append(max_rel(fp.fused_psd_streams_reference(
            raw, torch.from_numpy(full).to(dev), 64).sum(0).cpu().numpy(),
            gold))
        yard.append(max_rel(scipy_f32_class(raw_np), gold))
    med_r = statistics.median(ours) / statistics.median(yard)
    max_r = max(ours) / max(yard)
    print(f"K4 35 dB tone, config 5 step (S={S} N={N} F={F}), combined, "
          f"12 seeds: max rel median {statistics.median(ours):.3e} / max "
          f"{max(ours):.3e}; scipy f32 {statistics.median(yard):.3e} / "
          f"{max(yard):.3e}; plain (cuFFT) {statistics.median(plain):.3e} / "
          f"{max(plain):.3e}; ratios median {med_r:.2f}x (<= 1.5), max "
          f"{max_r:.2f}x (<= 3)")
    check(med_r <= 1.5 and max_r <= 3.0,
          "K4 tone error above the FFTW-class budget")
    return max_abs


def phase_times(dev, rng, fp, ff, fl, fpp, adapt_batch, make_window, card):
    """Median CUDA-event times a call (us/step, event_times_us: what a
    caller waits, the host's enqueue included where it is the longer):
    kernel, plain, kernel again, and torch.fft.fft over the same frames
    already in complex64 on the card (the transform alone: the library
    yardstick); beside them the device times of the kernel and of
    torch.fft.fft (device_times_us: the calls queued behind a sleep
    kernel). At the K1/K2 shapes also the radix-2 control
    (``fpp.radix2_psd``), and at the large-N shapes the large kernel's
    radix-2 passes (``fpp.large_radix2_psd``), before and after them both
    ways, its output within 1e-5 of the kernel's; at the large-N shapes
    also the host part of a call of each wrapper (host_us). Returns the
    times by shape and the control's (event, device, event again, device
    again[, host, the kernel's host]) by shape."""
    times, control = {}, {}
    shapes = [("K1", 2048, 4096, None), ("K1", 2048, 400, None),
              ("K1", 256, 3200, None), ("K1", 16384, 256, None),
              ("K2", 2048, 4096, "hann"), ("K2", 8192, 1024, "hann"),
              ("K2", 8192, 104, "hann"), ("K3", 2048, 4096, None),
              ("K3", 2048, 4096, "hann"), ("K3", 8192, 1024, None),
              ("K3", 2048, 400, "blackman"), ("K4", 2048, 256, None),
              ("K4", 2048, 256, "hann"), ("L", C3_N, 8, None),
              ("L", C3_N, 8, "hann"), ("L", 65536, 16, "hann"),
              ("L", 32768, 32, None), ("L", 1 << 22, 8, None)]
    for name, N, fps, wname in shapes:
        F, chunk = adapt_batch(fps)
        S = C5_STREAMS if name == "K4" else 1
        raw = torch.from_numpy(rng.integers(
            0, 256, (S, F, 2 * N) if name == "K4" else (F, 2 * N),
            dtype=np.uint8)).to(dev)
        w = (None if wname is None
             else torch.from_numpy(make_window(wname, N)).to(dev))
        nv = F
        if name == "K4":
            kernel, plain = fp.fused_psd_streams, fp.fused_psd_streams_reference
            nv = torch.full((S,), F, dtype=torch.int32, device=dev)
        elif name == "K3":
            kernel, plain = ff.fused_psd_fast, ff.fused_psd_fast_reference
        elif name == "L":
            kernel, plain = fl.fused_psd_large, fl.fused_psd_large_reference
        else:
            kernel, plain = fp.fused_psd, fp.fused_psd_reference
        flat = raw.reshape(S * F, 2 * N)
        z = torch.complex(flat[:, 0::2].float() - 127.0,
                          flat[:, 1::2].float() - 127.0)

        control_fn = {"L": fpp.large_radix2_psd,
                      "K3": ff.fused_psd_fast_control}.get(name,
                                                           fpp.radix2_psd)

        def radix2_call():
            return control_fn(raw, nv, chunk, w)

        radix2 = name in ("L", "K3") or (name in ("K1", "K2")
                                         and N in fpp.RADIX2_N)
        # The control: the radix-2 kernels, or the kernel K3 replaced
        # (the same scheme; its sums in another order).
        vs_limit = FAST_VS_PLAIN_RTOL if name == "K3" else UNIFORM_RTOL
        if radix2:
            vs = max_rel(radix2_call().cpu().numpy(),
                         kernel(raw, nv, chunk, w).cpu().numpy())
            check(vs <= vs_limit, f"time {name} N={N}: the control is {vs} "
                  "from the kernel")
            before = (event_times_us(radix2_call),
                      device_times_us(radix2_call))
            host_before = (host_us(radix2_call) if name in ("L", "K3")
                           else None)
        k_us = event_times_us(lambda: kernel(raw, nv, chunk, w))
        p_us = event_times_us(lambda: plain(raw, nv, chunk, w))
        lib_us = event_times_us(lambda: torch.fft.fft(z, dim=-1))
        k_us2 = event_times_us(lambda: kernel(raw, nv, chunk, w))
        kd_us = device_times_us(lambda: kernel(raw, nv, chunk, w))
        libd_us = device_times_us(lambda: torch.fft.fft(z, dim=-1))
        b_ms, b_by = bound_ms(name, S * F, N, w is not None, S)
        times[(name, N, F, wname)] = (k_us, p_us, k_us2, lib_us, b_ms, b_by,
                                      kd_us, libd_us)
        if radix2 and name == "K3":
            after = (event_times_us(radix2_call),
                     device_times_us(radix2_call))
            k_host = host_us(lambda: kernel(raw, nv, chunk, w))
            r_host = min(host_before, host_us(radix2_call))
            control[(name, N, F, wname)] = before + after + (r_host, k_host)
            group = fp.k1_group(F, chunk, ff.resident_blocks(
                N, w is not None, dev.index))
            k_best, r_best = min(k_us, k_us2), min(before[0], after[0])
            print(f"time {name} N={N} F={F} window={wname} on {card}: the "
                  f"control (the kernel K3 replaced) {before[0]:.1f} / "
                  f"{after[0]:.1f} us a call, device {before[1]:.1f} / "
                  f"{after[1]:.1f} us, host {r_host:.1f} us (frames/block "
                  f"{fp.frames_per_block(F, chunk)}; max rel from the "
                  f"kernel {vs:.3e}), the kernel {k_us:.1f} / {k_us2:.1f} a "
                  f"call, device {kd_us:.1f}, host {k_host:.1f} us "
                  f"(frames/block {group}): kernel/control "
                  f"{k_best / r_best:.3f} a call, "
                  f"{kd_us / min(before[1], after[1]):.3f} on the device, "
                  f"{k_host / r_host:.3f} on the host")
        elif radix2 and name == "L":
            after = (event_times_us(radix2_call),
                     device_times_us(radix2_call))
            k_host = host_us(lambda: kernel(raw, nv, chunk, w))
            r_host = min(host_before, host_us(radix2_call))
            control[(name, N, F, wname)] = before + after + (r_host, k_host)
            grid = fl.regs_grid(F, N, fl.resident_blocks(
                N, fl.PASS_A if w is None else fl.PASS_A_WINDOWED,
                dev.index), fl.resident_blocks(N, fl.PASS_B, dev.index))
            k_best, r_best = min(k_us, k_us2), min(before[0], after[0])
            print(f"time {name} N={N} F={F} window={wname} on {card}: the "
                  f"radix-2 control {before[0]:.1f} / {after[0]:.1f} us a "
                  f"call, device {before[1]:.1f} / {after[1]:.1f} us, host "
                  f"{r_host:.1f} us (frames/block "
                  f"{fl.frames_per_block(F, chunk, N)}; max rel from the "
                  f"kernel {vs:.3e}), the kernel {k_us:.1f} / {k_us2:.1f} a "
                  f"call, device {kd_us:.1f}, host {k_host:.1f} us (frames "
                  f"a pass-A block, a pass-B block, partial rows {grid}): "
                  f"kernel/control {k_best / r_best:.3f} a call, "
                  f"{kd_us / min(before[1], after[1]):.3f} on the device, "
                  f"{k_host / r_host:.3f} on the host")
        elif radix2:
            after = (event_times_us(radix2_call),
                     device_times_us(radix2_call))
            control[(name, N, F, wname)] = before + after
            group = fp.k1_group(F, chunk, fp.resident_blocks(
                N, w is not None, dev.index))
            k_best, r_best = min(k_us, k_us2), min(before[0], after[0])
            print(f"time {name} N={N} F={F} window={wname} on {card}: the "
                  f"radix-2 control {before[0]:.1f} / {after[0]:.1f} us a "
                  f"call, device {before[1]:.1f} / {after[1]:.1f} us "
                  f"(frames/block {fp.frames_per_block(F, chunk)}; max rel "
                  f"from the kernel {vs:.3e}), the kernel {k_us:.1f} / "
                  f"{k_us2:.1f} a call, device {kd_us:.1f} (frames/block "
                  f"{group}): kernel/control {k_best / r_best:.3f} a call, "
                  f"{kd_us / min(before[1], after[1]):.3f} on the device")
        frames = S * F
        print(f"time {name} N={N} F={F}{f' S={S}' if S > 1 else ''} window="
              f"{wname} on {card}: kernel {k_us:.1f} us a call "
              f"({frames * N / k_us / 1e3:.2f} GS/s; repeat {k_us2:.1f} us; "
              f"device {kd_us:.1f} us), plain {p_us:.1f} us a call "
              f"({frames * N / p_us / 1e3:.2f} GS/s), torch.fft.fft of the "
              f"complex64 frames {lib_us:.1f} us a call (device "
              f"{libd_us:.1f}), bound {1e3 * b_ms:.2f} us ({b_by})")
    return times, control


def reset_counts(fp, ff) -> None:
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed as fm
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    fm.CONTROL_COUNTS.reset()
    fp.COUNTS.reset()
    ff.COUNTS.reset()
    ff.CONTROL_COUNTS.reset()
    ff.CUT_COUNTS.reset()
    fpp.COUNTS.reset()


def launch_counts(fp, ff) -> dict:
    """Every launch counter by the kernel (or plain version) it counts;
    "L" is the large-N kernel, "M" the mixed-radix kernel, "B" the chirp-Z
    kernel, "ML" and "BL" their large forms (the four-step mixed-radix and
    the three-pass chirp-Z kernels), "SK", "MT" and "PFB" the estimators'
    kernels (SK's plane
    kernel, the multitaper's batch kernel, the PFB's ring kernel), "SK
    control", "MT control" and "PFB control" the kernels those three were
    redesigned from, "SK-S", "MT-S" and "PFB-S" (and their controls) the
    estimators' streams entries, "L-S", "ML-S" and "BL-S" (and their
    windowed forms) the streams entries of the large kernel, ML and BL,
    "FR", "PFB-C", "CSD" and "SCF" (FR and CSD with their windowed forms)
    the library estimators' kernels, "SK-M", "MT-M" and "PFB-M" the CLI
    estimators' forms of the mixed-radix kernel, "SK-B", "MT-B" and
    "PFB-B" their forms of the chirp-Z kernel, "SK-M-S" ... "PFB-B-S" the
    streams forms of those six, "SK-BL", "MT-BL" and "PFB-BL" their forms
    of BL's passes and "SK-BL-S" ... "PFB-BL-S" those over streams,
    "SK-L", "MT-L" and "PFB-L" their forms of the large kernel's passes
    and "SK-L-S" ... "PFB-L-S" those over streams, "PFB-L control",
    "PFB-L-S control", "PFB-BL control" and "PFB-BL-S control" the first
    forms of those four PFB forms (the controls of their redesign),
    "SK-ML", "MT-ML" and
    "PFB-ML" their forms of ML's passes and "SK-ML-S" ... "PFB-ML-S" those
    over streams, "M/B control" the
    kernel M and
    B replaced (and its plain versions), "probes" every probe variant
    together."""
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed as fm
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    return {"K1": fp.COUNTS.kernel, "K2": fp.COUNTS.kernel_windowed,
            "K3": ff.COUNTS.kernel, "K4": fp.COUNTS.kernel_streams,
            "K4 windowed": fp.COUNTS.kernel_streams_windowed,
            "L": fp.COUNTS.kernel_large,
            "L windowed": fp.COUNTS.kernel_large_windowed,
            "M": fp.COUNTS.kernel_mixed,
            "M streams": fp.COUNTS.kernel_mixed_streams,
            "B": fp.COUNTS.kernel_bluestein,
            "B streams": fp.COUNTS.kernel_bluestein_streams,
            "ML": fp.COUNTS.kernel_mixed_large,
            "ML windowed": fp.COUNTS.kernel_mixed_large_windowed,
            "BL": fp.COUNTS.kernel_chirp_large,
            "BL windowed": fp.COUNTS.kernel_chirp_large_windowed,
            "SK": fp.COUNTS.kernel_sk_plane, "SK control": fp.COUNTS.kernel_sk,
            "MT": fp.COUNTS.kernel_tapers,
            "MT control": fp.COUNTS.kernel_tapers_control,
            "PFB": fp.COUNTS.kernel_pfb_ring,
            "PFB control": fp.COUNTS.kernel_pfb,
            "SK-S": fp.COUNTS.kernel_sk_streams,
            "SK-S control": fp.COUNTS.kernel_sk_streams_control,
            "MT-S": fp.COUNTS.kernel_tapers_streams,
            "MT-S control": fp.COUNTS.kernel_tapers_streams_control,
            "PFB-S": fp.COUNTS.kernel_pfb_streams,
            "PFB-S control": fp.COUNTS.kernel_pfb_streams_control,
            "L-S": fp.COUNTS.kernel_large_streams,
            "L-S windowed": fp.COUNTS.kernel_large_streams_windowed,
            "ML-S": fp.COUNTS.kernel_mixed_large_streams,
            "ML-S windowed": fp.COUNTS.kernel_mixed_large_streams_windowed,
            "BL-S": fp.COUNTS.kernel_chirp_large_streams,
            "BL-S windowed": fp.COUNTS.kernel_chirp_large_streams_windowed,
            "FR": fp.COUNTS.kernel_frames,
            "FR windowed": fp.COUNTS.kernel_frames_windowed,
            "PFB-C": fp.COUNTS.kernel_pfb_channelize,
            "CSD": fp.COUNTS.kernel_csd,
            "CSD windowed": fp.COUNTS.kernel_csd_windowed,
            "SCF": fp.COUNTS.kernel_scf,
            "SK-M": fp.COUNTS.kernel_sk_mixed,
            "MT-M": fp.COUNTS.kernel_tapers_mixed,
            "PFB-M": fp.COUNTS.kernel_pfb_mixed,
            "SK-B": fp.COUNTS.kernel_sk_chirp,
            "MT-B": fp.COUNTS.kernel_tapers_chirp,
            "PFB-B": fp.COUNTS.kernel_pfb_chirp,
            "SK-M-S": fp.COUNTS.kernel_sk_mixed_streams,
            "MT-M-S": fp.COUNTS.kernel_tapers_mixed_streams,
            "PFB-M-S": fp.COUNTS.kernel_pfb_mixed_streams,
            "SK-B-S": fp.COUNTS.kernel_sk_chirp_streams,
            "MT-B-S": fp.COUNTS.kernel_tapers_chirp_streams,
            "PFB-B-S": fp.COUNTS.kernel_pfb_chirp_streams,
            "SK-BL": fp.COUNTS.kernel_sk_chirp_large,
            "MT-BL": fp.COUNTS.kernel_tapers_chirp_large,
            "PFB-BL": fp.COUNTS.kernel_pfb_chirp_large,
            "SK-BL-S": fp.COUNTS.kernel_sk_chirp_large_streams,
            "MT-BL-S": fp.COUNTS.kernel_tapers_chirp_large_streams,
            "PFB-BL-S": fp.COUNTS.kernel_pfb_chirp_large_streams,
            "SK-L": fp.COUNTS.kernel_sk_large,
            "MT-L": fp.COUNTS.kernel_tapers_large,
            "PFB-L": fp.COUNTS.kernel_pfb_large,
            "SK-L-S": fp.COUNTS.kernel_sk_large_streams,
            "MT-L-S": fp.COUNTS.kernel_tapers_large_streams,
            "PFB-L-S": fp.COUNTS.kernel_pfb_large_streams,
            "PFB-L control": fp.COUNTS.kernel_pfb_large_control,
            "PFB-L-S control": fp.COUNTS.kernel_pfb_large_streams_control,
            "PFB-BL control": fp.COUNTS.kernel_pfb_chirp_large_control,
            "PFB-BL-S control":
                fp.COUNTS.kernel_pfb_chirp_large_streams_control,
            "SK-ML": fp.COUNTS.kernel_sk_mixed_large,
            "MT-ML": fp.COUNTS.kernel_tapers_mixed_large,
            "PFB-ML": fp.COUNTS.kernel_pfb_mixed_large,
            "SK-ML-S": fp.COUNTS.kernel_sk_mixed_large_streams,
            "MT-ML-S": fp.COUNTS.kernel_tapers_mixed_large_streams,
            "PFB-ML-S": fp.COUNTS.kernel_pfb_mixed_large_streams,
            "K3 control": ff.CONTROL_COUNTS.kernel
            + ff.CONTROL_COUNTS.plain + ff.CUT_COUNTS.kernel,
            "M/B control": fm.CONTROL_COUNTS.kernel_mixed
            + fm.CONTROL_COUNTS.kernel_bluestein + fm.CONTROL_COUNTS.plain,
            "plain": fp.COUNTS.plain, "plain_fast": ff.COUNTS.plain,
            "probes": sum(fpp.COUNTS.kernel.values())
            + sum(fpp.COUNTS.plain.values())}


def check_only(counts: dict, kernel: str, label: str) -> None:
    others = {k: v for k, v in counts.items() if k != kernel and v}
    check(counts[kernel] > 0 and not others,
          f"{label} did not run through {kernel} alone: {counts}")


def drive(label, argv, cli, fp, ff, kernel, N, golden_fn, rtol, streams=1,
          peak_bins=1):
    """One drive through ``cli.main`` with every launch counter reset just
    before it: exit 0, the transform path of ``kernel`` (over ``streams``
    streams), a finite N-bin linear spectrum peaking at 100.2 MHz (within
    ``peak_bins`` bins) within ``rtol`` of ``golden_fn()``, and launches
    of ``kernel`` alone. Returns its launches."""
    reset_counts(fp, ff)
    rc, out, err, wall = run_cli(argv, cli.main)
    counts = launch_counts(fp, ff)
    log(err[-1200:])
    check(rc == 0, f"{label} drive exited {rc}")
    path = {"K3": "cuda_fast", "L": "cuda_large",
            "L windowed": "cuda_large", "M": "cuda_mixed",
            "M streams": "cuda_mixed", "B": "cuda_bluestein",
            "B streams": "cuda_bluestein", "ML": "cuda_mixed_large",
            "ML windowed": "cuda_mixed_large", "BL": "cuda_chirp_large",
            "BL windowed": "cuda_chirp_large", "SK": "cuda_sk",
            "MT": "cuda_multitaper", "PFB": "cuda_pfb", "SK-S": "cuda_sk",
            "MT-S": "cuda_multitaper",
            "PFB-S": "cuda_pfb", "L-S": "cuda_large",
            "L-S windowed": "cuda_large", "ML-S": "cuda_mixed_large",
            "ML-S windowed": "cuda_mixed_large", "BL-S": "cuda_chirp_large",
            "BL-S windowed": "cuda_chirp_large", "SK-M": "cuda_sk",
            "MT-M": "cuda_multitaper", "PFB-M": "cuda_pfb",
            "SK-B": "cuda_sk", "MT-B": "cuda_multitaper",
            "PFB-B": "cuda_pfb", "SK-M-S": "cuda_sk",
            "MT-M-S": "cuda_multitaper", "PFB-M-S": "cuda_pfb",
            "SK-B-S": "cuda_sk", "MT-B-S": "cuda_multitaper",
            "PFB-B-S": "cuda_pfb", "SK-BL": "cuda_sk",
            "MT-BL": "cuda_multitaper", "PFB-BL": "cuda_pfb",
            "SK-BL-S": "cuda_sk", "MT-BL-S": "cuda_multitaper",
            "PFB-BL-S": "cuda_pfb", "SK-L": "cuda_sk",
            "MT-L": "cuda_multitaper", "PFB-L": "cuda_pfb",
            "SK-L-S": "cuda_sk", "MT-L-S": "cuda_multitaper",
            "PFB-L-S": "cuda_pfb", "SK-ML": "cuda_sk",
            "MT-ML": "cuda_multitaper", "PFB-ML": "cuda_pfb",
            "SK-ML-S": "cuda_sk", "MT-ML-S": "cuda_multitaper",
            "PFB-ML-S": "cuda_pfb"}.get(kernel, "cuda")
    check(f"Transform path: {path} " in err, f"{label} drive off {kernel}")
    if streams > 1:
        check(f"Parallel streams: {streams} (mesh size 1)" in err,
              f"{label} drive: not over {streams} streams")
    freqs, vals, _ = spectrum(out)
    check(len(vals) == N and np.all(np.isfinite(vals)),
          f"{label} drive: malformed spectrum")
    peak = freqs[int(np.argmax(vals))]
    check(abs(peak - 100.2e6) <= peak_bins * RATE / N,
          f"{label} drive: peak at {peak}")
    err_gold = max_rel(vals, golden_fn())
    hist = [line for line in err.splitlines()
            if line.startswith("Buffer queue histogram:")]
    print(f"e2e {label} ({' '.join(argv)}): exit 0 in {wall:.2f} s wall; "
          f"peak {peak / 1e6:.4f} MHz; max rel vs float64 golden "
          f"{err_gold:.3e} (<= {rtol:g}); {hist[-1] if hist else ''}; "
          f"launches {counts}")
    check(err_gold <= rtol, f"{label} drive vs float64 golden")
    check_only(counts, kernel, f"{label} drive")
    return counts[kernel]


def recorded_golden(record, N, repeats, hop, window=None):
    """Linear float64 golden spectrum of a recorded stream, frames of N
    samples at a hop of ``hop`` samples (Welch overlap when hop < N)."""
    stream = np.fromfile(record, dtype=np.uint8)
    check(len(stream) >= 2 * (hop * (repeats - 1) + N),
          f"recorded stream {record} too short")
    pwr = np.zeros(N)
    for f0 in range(0, repeats, 256):
        frames = np.stack([stream[2 * hop * f:2 * hop * f + 2 * N]
                           for f in range(f0, min(f0 + 256, repeats))])
        pwr += golden_partial(frames, len(frames), window)
    return golden_finalize_linear(np.fft.fftshift(pwr), repeats, RATE)


def drive_config2(cli, fp, ff, make_window, tmp):
    """BASELINE config 2 through the CLI (K2): linear spectrum against a
    float64 Welch transcription of the recorded stream, then the dB run
    fed back to itself with -B. Returns the K2 launches of the drive."""
    N, repeats, hop = 8192, 4000, 4096
    record = os.path.join(tmp, "config2.iq")
    base = ["-f", "100M", "-n", str(repeats), "-b", str(N),
            "--window-function", "hann", "--welch-overlap", "50",
            "--source", SOURCE]
    w = make_window("hann", N)
    launches = drive(
        "config 2", base + ["-l", "--record", record], cli, fp, ff, "K2", N,
        lambda: recorded_golden(record, N, repeats, hop, w), GOLDEN_RTOL)

    # Baseline feedback: the same drive in dB, then with its own output as
    # -B: every residual is the rounding of the printed baseline.
    reset_counts(fp, ff)
    rc, out_db, _, wall_db = run_cli(base, cli.main)
    check(rc == 0, f"config 2 dB drive exited {rc}")
    baseline = os.path.join(tmp, "config2_baseline.dat")
    with open(baseline, "w") as f:
        f.write(out_db)
    rc, out_res, _, wall_res = run_cli(base + ["-B", baseline], cli.main)
    check(rc == 0, f"config 2 baseline drive exited {rc}")
    _, _, db_text = spectrum(out_db)
    _, res, _ = spectrum(out_res)
    units = np.array([last_digit_unit(v) for v in db_text])
    worst = float(np.max(np.abs(res) / units))
    counts = launch_counts(fp, ff)
    print(f"e2e config 2 in dB then -B its own output: exit 0 in "
          f"{wall_db:.2f} s + {wall_res:.2f} s wall; max |residual| "
          f"{np.abs(res).max():.3g} dB = {worst:.2f} units of the sixth "
          f"printed digit; launches {counts}")
    check(worst <= 1.0, "config 2 baseline residual above one printed unit")
    check_only(counts, "K2", "config 2 baseline drives")
    return launches


def drive_precision_high(cli, fp, ff, make_window, tmp):
    """--precision high with a Blackman window file through the CLI (K3).
    Returns the K3 launches of the drive."""
    N, repeats = 2048, 2000
    w = make_window("blackman", N)
    wfile = os.path.join(tmp, "blackman.txt")
    with open(wfile, "w") as f:
        f.write("\n".join(f"{v:.9g}" for v in w) + "\n")
    record = os.path.join(tmp, "high.iq")
    argv = ["-f", "100M", "-n", str(repeats), "-b", str(N), "--precision",
            "high", "-w", wfile, "-l", "--record", record, "--source", SOURCE]
    return drive("precision high", argv, cli, fp, ff, "K3", N,
                 lambda: recorded_golden(record, N, repeats, N, w),
                 RELAXED_RTOL)


def config5_argv(record: str):
    """BASELINE config 5's drive: 16 streams of 4,000 2048-bin spectra,
    256 frames a step, recorded to ``record``.s<i>."""
    return ["-f", "100M", "-n", "4000", "-b", "2048", "--streams",
            str(C5_STREAMS), "--frames-per-step", "256", "-l", "--record",
            record, "--source", SOURCE]


def drive_config5(cli, fp, ff, tmp):
    """BASELINE config 5 through the CLI (K4): 16 streams, the combined
    linear spectrum against the float64 golden of the 16 recorded
    streams. Returns the K4 launches of the drive."""
    N, repeats = 2048, 4000
    record = os.path.join(tmp, "config5.iq")
    argv = config5_argv(record)

    def golden():
        # The combined spectrum averages S·repeats spectra: the mean of
        # the per-stream linear goldens.
        return sum(recorded_golden(f"{record}.s{s}", N, repeats, N)
                   for s in range(C5_STREAMS)) / C5_STREAMS

    return drive("config 5", argv, cli, fp, ff, "K4", N, golden, GOLDEN_RTOL,
                 streams=C5_STREAMS)


def drive_streams_scan(cli, fp, ff, tmp):
    """A windowed hopping matrix drive over 4 streams with a dead hop
    (K4 windowed). Returns its launches."""
    scan = os.path.join(tmp, "streams_scan")
    argv = STREAMS_SCAN_ARGV + ["-m", scan]
    reset_counts(fp, ff)
    rc, _, err, wall = run_cli(argv, cli.main)
    counts = launch_counts(fp, ff)
    log(err[-800:])
    check(rc == 0, f"streams scan drive exited {rc}")
    check("Parallel streams: 4 (mesh size 1)" in err
          and "Transform path: cuda " in err, "streams scan drive off K4")
    check("Unable to tune to 103000000. Dropping from frequency list."
          in err, "streams scan drive: dead hop not dropped")
    with open(scan + ".met") as f:
        meta = [line.split("#")[0].strip() for line in f]
    cols, nrows = int(meta[0]), int(meta[1])
    data = np.fromfile(scan + ".bin", dtype=np.float32)
    check(cols == 2 * 256 and nrows == 1 and data.size == cols
          and np.all(np.isfinite(data)),
          f"streams scan drive: .met says {cols}x{nrows}, .bin has "
          f"{data.size}")
    hop = int(np.argmax(data)) // 256
    peak = 105e6 + (int(np.argmax(data)) % 256 - 128) * RATE / 256
    check(hop == 1 and abs(peak - 104.9e6) <= RATE / 256,
          f"streams scan drive: peak at {peak} Hz in hop {hop}")
    print(f"e2e streams scan drive ({' '.join(STREAMS_SCAN_ARGV)}): exit 0 in "
          f"{wall:.2f} s wall; dead hop dropped; .met {cols}x{nrows}, .bin "
          f"{data.nbytes} bytes; peak {peak / 1e6:.4f} MHz; launches {counts}")
    check_only(counts, "K4 windowed", "streams scan drive")
    return counts["K4 windowed"]


def tone_frames_dev(N: int, F: int, seed: int, dev) -> torch.Tensor:
    """tone_frames made on the card (a torch generator seeded with
    ``seed``): (F, 2N) uint8, a 35 dB tone at a random frequency and
    phase over unit noise."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f0 = 0.05 + 0.4 * torch.rand((), generator=g, device=dev,
                                 dtype=torch.float64)
    ph = 2 * np.pi * torch.rand((), generator=g, device=dev,
                                dtype=torch.float64)
    t = torch.arange(F * N, device=dev, dtype=torch.float64)
    arg = 2 * np.pi * f0 * t + ph
    noise = torch.randn((2, F * N), generator=g, device=dev,
                        dtype=torch.float64)
    re = torch.clamp(torch.round(100.0 * torch.cos(arg) + noise[0] + 127),
                     0, 255)
    im = torch.clamp(torch.round(100.0 * torch.sin(arg) + noise[1] + 127),
                     0, 255)
    return torch.stack([re, im], dim=-1).to(torch.uint8).reshape(F, 2 * N)


def power64_dev(raw: torch.Tensor, window=None) -> torch.Tensor:
    """float64 |DFT|^2 of each (..., 2N) u8 frame on the card (cuFFT in
    float64), unshifted bins."""
    z = torch.complex(raw[..., 0::2].double() - 127.0,
                      raw[..., 1::2].double() - 127.0)
    if window is not None:
        z = z * window.double()
    X = torch.fft.fft(z, dim=-1)
    return X.real ** 2 + X.imag ** 2


def golden_partial_dev(raw: torch.Tensor, window=None) -> np.ndarray:
    """The float64 golden of every frame of ``raw`` computed on the card
    (power64_dev), summed: for the tone yards at sizes where the numpy
    golden would take minutes."""
    return power64_dev(raw, window).sum(0).cpu().numpy()


def rate_bound_ms(nbytes: float, bf16_flops: float, fp32_ops: float):
    """The least time the card could take for this work, and what bounds
    it: the larger of the bytes over the memory rate and the operations
    over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = bf16_flops / BF16_FLOP_PER_S + fp32_ops / FP32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def bound_ms(kind: str, frames: int, N: int, windowed: bool,
             out_rows: int = 1):
    """rate_bound_ms of one call: K3's work as the probes count it
    (fused_psd_probe.k3_work; 2 N (12 N1 + 9 N2) bf16 flops per frame, 24
    N1 windowed), and the FFT-based steps' (K1, K2, K4, the large-N
    kernel "L") as k1_work does: the function's least work, the frames
    and output's bytes and the split-radix count, 4 N log2 N - 6 N + 8
    FP32 flops per frame, and dequantize and |X|^2."""
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    if kind == "K3":
        return rate_bound_ms(*fpp.k3_work(frames, N, 6 if windowed else 3,
                                          windowed=windowed))
    return rate_bound_ms(*fpp.k1_work(frames, N, windowed=windowed,
                                      out_rows=out_rows))


def k3_split(dev, rng, ff, make_window, card) -> None:
    """Where K3's device time goes at N = 2048, F = 4096, unwindowed and
    with Hann: its cuts (``fused_psd_fast_cut``: the frame's copies and
    the stage-1 gather; then stage 1, the twiddle and Z's planes) and the
    whole kernel, device times (device_times_us), each cut keeping the
    work before it; the differences are the parts."""
    N, F, chunk = 2048, 4096, 64
    raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                        dtype=np.uint8)).to(dev)
    for wname in (None, "hann"):
        w = (None if wname is None
             else torch.from_numpy(make_window(wname, N)).to(dev))
        us = []
        for cut in (ff.CUT_GATHER, ff.CUT_STAGE1):
            a = ff.fused_psd_fast_cut(cut, raw, F, chunk, w)
            b = ff.fused_psd_fast_cut(cut, raw, F, chunk, w)
            torch.cuda.synchronize()
            check(torch.equal(a, b) and bool(torch.isfinite(a).all()),
                  f"K3 cut {cut}: not deterministic or not finite")
            us.append(device_times_us(
                lambda: ff.fused_psd_fast_cut(cut, raw, F, chunk, w)))
        us.append(device_times_us(lambda: ff.fused_psd_fast(raw, F, chunk,
                                                             w)))
        print(f"split K3 N={N} F={F} window={wname} on {card}: device us "
              f"copies + gather {us[0]:.1f}, + stage 1, twiddle and Z "
              f"planes {us[1]:.1f} (+{us[1] - us[0]:.1f}), + stage 2 "
              f"{us[2]:.1f} (+{us[2] - us[1]:.1f}); the row sum in each")


def device_yard(label, dev, kernel, plain_fn, make_window, wname, N, F,
                seed0) -> None:
    """A kernel's admission yard at sizes where the numpy golden would
    take minutes: 60 seeds of 35 dB tones made on the card
    (tone_frames_dev), the float64 golden on the card (cuFFT in float64),
    against the scipy float32 class of the same frames: median <= 1.5x
    and max <= 3x its error, the per-seed p99 of the ratio printed."""
    w_np = None if wname is None else make_window(wname, N)
    w = None if w_np is None else torch.from_numpy(w_np).to(dev)
    def errors(raw_np, gold, got, plain_got):
        return (max_rel(got, gold), max_rel(plain_got, gold),
                max_rel(scipy_f32_class(raw_np, w_np), gold))

    seeds = []
    for seed in range(60):
        raw = tone_frames_dev(N, F, seed0 + seed, dev)
        seeds.append(host_pool().submit(
            errors, raw.cpu().numpy(), golden_partial_dev(raw, w),
            kernel(raw, F, F, w).cpu().numpy(),
            plain_fn(raw, F, F, w).cpu().numpy()))
    ours, plain, cls = zip(*(f.result() for f in seeds))
    e, c = np.asarray(ours), np.asarray(cls)
    r = e / c
    med_r, max_r = np.median(e) / np.median(c), e.max() / c.max()
    print(f"{label} yard N={N} F={F} window={wname}, 60 seeds of 35 dB "
          f"tones: max rel median {np.median(e):.3e} / max {e.max():.3e}; "
          f"scipy f32 {np.median(c):.3e} / {c.max():.3e}; plain "
          f"{np.median(plain):.3e} / {max(plain):.3e}; ratio median "
          f"{med_r:.2f}x (<= 1.5), max {max_r:.2f}x (<= 3), per-seed p99 "
          f"{np.quantile(r, 0.99):.2f}x, per-seed max {r.max():.2f}x")
    check(med_r <= 1.5 and max_r <= 3.0,
          f"{label} yard N={N} window={wname}: above the FFTW-class budget")


def matrix_drive(label, argv, cli, fp, ff, kernel, N, repeats, record,
                 matrix, window=None):
    """One matrix-mode drive (``argv`` writes the matrix ``matrix`` and
    records its stream to ``record``) through ``kernel`` alone: exit 0, a finite N-bin ``.bin``
    row peaking at 100.2 MHz, within 1e-5 of the float64 golden of the
    recorded stream or 3x the scipy float32 FFT's error on the same
    frames, whichever is larger (no printed digits to round). Returns the
    kernel's launches."""
    reset_counts(fp, ff)
    rc, _, err, wall = run_cli(argv, cli.main)
    counts = launch_counts(fp, ff)
    check(rc == 0, f"{label} drive exited {rc}")
    check_only(counts, kernel, f"{label} drive")
    vals = np.fromfile(matrix + ".bin", dtype=np.float32)
    check(vals.size == N and np.all(np.isfinite(vals)),
          f"{label} drive: .bin holds {vals.size} values")
    peak = 100e6 + (int(np.argmax(vals)) - N // 2) * RATE / N
    check(abs(peak - 100.2e6) <= RATE / N, f"{label} drive: peak at {peak}")
    frames = np.fromfile(record, dtype=np.uint8)[:2 * N * repeats] \
        .reshape(repeats, 2 * N)
    gold = golden_finalize_linear(
        np.fft.fftshift(golden_partial(frames, repeats, window)), repeats,
        RATE)
    cls = golden_finalize_linear(
        np.fft.fftshift(scipy_f32_class(frames, window)), repeats, RATE)
    err_gold, err_cls = max_rel(vals, gold), max_rel(cls, gold)
    # 1e-5, or 3x the float32 class where the class itself is near it: at
    # 2^22 the deepest of 4M bins of 8 spectra take scipy's float32 FFT to
    # ~1.1e-5 of the golden on this stream.
    budget = max(GOLDEN_RTOL, 3.0 * err_cls)
    print(f"e2e {label} ({' '.join(argv)}): exit 0 in {wall:.2f} s wall; "
          f"peak {peak / 1e6:.4f} MHz; .bin max rel vs float64 golden "
          f"{err_gold:.3e} (<= {budget:.3g}); scipy float32 on the same "
          f"frames {err_cls:.3e}; launches {counts}")
    check(err_gold <= budget, f"{label} drive vs float64 golden")
    return counts[kernel]


def phase_large(dev, rng, fp, fl, adapt_batch, make_window):
    """The large-N kernel against its plain version and the float64
    golden, twice each, then its 60-seed tone yard. Returns its max abs
    error against the plain version at config 3's step and at the
    windowed drive's step."""
    cases = [  # (label, N, frames_per_step, n_valid or None, window)
        ("N=32768 F=8", 32768, 8, None, None),
        ("N=32768 F=8 hann", 32768, 8, None, "hann"),
        ("N=32768 session step", 32768, 25, None, None),
        ("N=65536 F=8", 65536, 8, None, None),
        ("N=65536 F=8 hann masked", 65536, 8, 5, "hann"),
        ("N=65536 hann (windowed drive step)", 65536, 12, None, "hann"),
        ("N=2^17 F=8 hann", 1 << 17, 1, None, "hann"),
        ("N=2^18 F=8", 1 << 18, 1, None, None),
        ("N=2^19 F=8 masked", 1 << 19, 1, 6, None),
        ("N=2^20 F=8 (config 3 step)", C3_N, 1, None, None),
        ("N=2^20 F=8 hann", C3_N, 1, None, "hann"),
        ("N=2^20 F=8 masked", C3_N, 1, 3, None),
        ("N=2^21 F=8 hann", 1 << 21, 1, None, "hann"),
        ("N=2^22 F=8 blackman", 1 << 22, 1, None, "blackman"),
    ]
    fp.COUNTS.reset()
    max_abs = {}
    n_windowed = 0
    for label, N, fps, n_valid, wname in cases:
        F, chunk = adapt_batch(fps)
        nv = F if n_valid is None else n_valid
        w_np = None if wname is None else make_window(wname, N)
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        n_windowed += w is not None
        raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        got = fl.fused_psd_large(raw, nv, chunk, w)
        again = fl.fused_psd_large(raw, nv, chunk, w)
        want = fl.fused_psd_large_reference(raw, nv, chunk, w)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"large {label}: not deterministic")
        got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
        gold = golden_partial(raw_np, nv, w_np)
        err_plain, err_gold = max_rel(got_np, want_np), max_rel(got_np, gold)
        grid = fl.regs_grid(F, N, fl.resident_blocks(
            N, fl.PASS_A if w is None else fl.PASS_A_WINDOWED, dev.index),
            fl.resident_blocks(N, fl.PASS_B, dev.index))
        print(f"large {label} (N={N} F={F} chunk={chunk} n_valid={nv} "
              f"window={wname}; N1 x N2 = {fl.large_split(N)}, frames a "
              f"pass-A block, a pass-B block, partial rows {grid}): max rel "
              "vs plain "
              f"{err_plain:.3e}, vs float64 golden {err_gold:.3e} (plain vs "
              f"golden {max_rel(want_np, gold):.3e})")
        check(np.all(np.isfinite(got_np)), f"large {label}: non-finite")
        check(err_plain <= UNIFORM_RTOL, f"large {label}: {err_plain} vs plain")
        check(err_gold <= GOLDEN_RTOL, f"large {label}: {err_gold} vs golden")
        if label.startswith("N=2^20 F=8 (config 3") or "drive step" in label:
            max_abs[wname] = float(np.abs(got_np.astype(np.float64)
                                          - want_np).max())
    check(fp.COUNTS.kernel_large == 2 * (len(cases) - n_windowed)
          and fp.COUNTS.kernel_large_windowed == 2 * n_windowed
          and fp.COUNTS.plain == 0,
          f"large launch counter did not move as expected: {vars(fp.COUNTS)}")

    # Admission yard: 60 seeds of 35 dB tones per size, unwindowed and
    # Hann, median <= 1.5x and max <= 3x the scipy float32 class.
    for N, F in ((32768, 32), (65536, 16), (C3_N, 8)):
        for wname in (None, "hann"):
            device_yard("large", dev, fl.fused_psd_large,
                        fl.fused_psd_large_reference, make_window, wname, N,
                        F, 9000)
    return max_abs


def drive_config3(cli, fp, ff, tmp):
    """BASELINE config 3 through the CLI (the large-N kernel): 2^20 bins,
    -t 10, against the float64 golden of the recorded stream. Returns the
    kernel's launches and the drive's argv."""
    N = C3_N
    repeats = math.ceil(RATE * C3_SECONDS / N)
    record = os.path.join(tmp, "config3.iq")
    argv = ["-f", "100M", "-b", str(N), "-t", str(C3_SECONDS), "-l",
            "--record", record, "--source", LINE_SOURCE]
    launches = drive("config 3", argv, cli, fp, ff, "L", N,
                     lambda: recorded_golden(record, N, repeats, N),
                     GOLDEN_RTOL)
    return launches, argv


def drive_large_windowed(cli, fp, ff, make_window, tmp):
    """A windowed large-N drive (-b 65536 --window-function hann) against
    the windowed float64 golden of its recorded stream. Returns the
    kernel's windowed launches."""
    N, repeats = 65536, 500
    record = os.path.join(tmp, "large_hann.iq")
    argv = ["-f", "100M", "-n", str(repeats), "-b", str(N),
            "--window-function", "hann", "-l", "--record", record,
            "--source", LINE_SOURCE]
    w = make_window("hann", N)
    return drive("large windowed", argv, cli, fp, ff, "L windowed", N,
                 lambda: recorded_golden(record, N, repeats, N, w),
                 GOLDEN_RTOL)


def drive_large_sweep(cli, fp, ff, make_window, tmp) -> None:
    """Every size the large-N kernel takes (32768 to 2^22), unwindowed and
    with Hann, through the CLI in matrix mode: 8 spectra each, through the
    large kernel alone, the float32 ``.bin`` row (no printed digits to
    round) against the float64 golden of the recorded stream, within 1e-5
    or 3x the scipy float32 FFT's error on the same frames (the FFTW-class
    budget), whichever is larger."""
    repeats = 8
    for log2n in range(15, 23):
        N = 1 << log2n
        for wname in (None, "hann"):
            label = f"large sweep 2^{log2n}" + (f" {wname}" if wname else "")
            kernel = "L" if wname is None else "L windowed"
            record = os.path.join(tmp, "sweep.iq")
            matrix = os.path.join(tmp, "sweep")
            argv = (["-f", "100M", "-n", str(repeats), "-b", str(N), "-l",
                     "-q", "-m", matrix, "--record", record, "--source",
                     LINE_SOURCE]
                    + ([] if wname is None else ["--window-function", wname]))
            matrix_drive(label, argv, cli, fp, ff, kernel, N, repeats,
                         record, matrix,
                         None if wname is None else make_window(wname, N))


def device_rows(prof):
    """[(kernel or copy name, calls, device us)] of a torch.profiler run."""
    from torch.autograd import DeviceType
    return [(evt.key, evt.count,
             getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0)))
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA]


def profile_drive(label, argv, cli, markers) -> None:
    """One more run of a drive under torch.profiler: device time by
    kernel (and copy) name, per call, and the device's busy share of the
    drive's wall time. Prints "not measured" where the profiler sees no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        rc, _, _, wall = run_cli(argv, cli.main)
    check(rc == 0, f"profiled {label} drive exited {rc}")
    rows = device_rows(prof)
    busy = sum(us for _, _, us in rows)
    if not rows or busy <= 0:
        print(f"profile {label}: the profiler recorded no device time "
              "(device times not measured)")
        return
    parts = []
    for marker in markers:
        hit = [(k, n, us) for k, n, us in rows if marker in k]
        n = sum(c for _, c, _ in hit)
        us = sum(t for _, _, t in hit)
        parts.append(f"{marker}: {n} calls, {us / max(n, 1):.1f} us/call, "
                     f"{us / 1e3:.2f} ms")
    print(f"profile {label} ({' '.join(argv)}): wall {wall:.2f} s, device "
          f"busy {busy / 1e3:.2f} ms ({100.0 * busy / 1e6 / wall:.3f}% of "
          f"wall); " + "; ".join(parts))


def profile_consumer(label, argv, cli) -> None:
    """One more run of a ``--streams`` drive with the consumer's calls
    timed on the host clock, on the consumer's thread only (the one that
    runs ``MultiStreamAcquisition._consume``): its rounds split into
    waiting for the producers' batches (the semaphore), filling the pinned
    slot (``_fill``), the upload (``SlotRing.upload``), the step's enqueue
    (``ShardedPsdStep.__call__``), the waits on CUDA events (slot reuse and
    read-back) and the float64 accumulation (the read-back's callback), per
    round. cProfile is not used: from Python 3.12 it traces every thread
    on one stack, and the producers' frames land in the consumer's."""
    import threading
    from rtl_power_fftw_tpu_torch.parallel import multistream, sharded
    from rtl_power_fftw_tpu_torch.pipeline import datastore
    spent, calls, consumer = {}, {}, []

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            if key != "consumer" and (
                    not consumer or threading.get_ident() != consumer[0]):
                return fn(*args, **kwargs)
            if key == "consumer":
                consumer.append(threading.get_ident())
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
                calls[key] = calls.get(key, 0) + 1
        return wrapper

    submit = datastore.SlotRing.submit
    patches = [
        (multistream.MultiStreamAcquisition, "_consume", "consumer"),
        (multistream.MultiStreamAcquisition, "_fill", "fill"),
        (datastore.SlotRing, "upload", "upload"),
        (sharded.ShardedPsdStep, "__call__", "step enqueue"),
        (torch.cuda.Event, "synchronize", "event waits"),
        (threading.Semaphore, "acquire", "wait for producers")]
    saved = [(owner, name, owner.__dict__[name]) for owner, name, _ in patches]
    try:
        for owner, name, key in patches:
            fn = getattr(owner, name)
            wrapped = timed(key, fn)
            setattr(owner, name, staticmethod(wrapped)
                    if isinstance(owner.__dict__[name], staticmethod)
                    else wrapped)
        datastore.SlotRing.submit = lambda self, outputs, callback: submit(
            self, outputs, timed("float64 accumulation", callback))
        rc, _, _, wall = run_cli(argv, cli.main)
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
        datastore.SlotRing.submit = submit
    check(rc == 0, f"timed {label} drive exited {rc}")
    rounds, total = calls.get("fill", 0), spent.get("consumer", 0.0)
    check(rounds > 0 and total > 0, f"{label}: no consumer rounds timed")
    parts = [(key, spent.get(key, 0.0)) for _, _, key in patches[1:]] + [
        ("float64 accumulation", spent.get("float64 accumulation", 0.0))]
    rest = total - sum(t for _, t in parts)
    print(f"profile {label} consumer (host clock, {' '.join(argv)}): wall "
          f"{wall:.2f} s, consumer {total:.3f} s over {rounds} rounds, "
          f"{1e3 * total / rounds:.2f} ms a round: "
          + ", ".join(f"{name} {1e3 * t / rounds:.2f} ms"
                      for name, t in parts)
          + f", the rest (sweeps, bookkeeping) {1e3 * rest / rounds:.2f} ms")


def template_ptxas(log_text: str, marker: str, first_arg: str = ""):
    """(marker<template arguments>, registers/spill summary) for each
    instantiation ptxas reports in ``log_text`` whose mangled name holds
    ``marker`` (and whose first template argument is ``first_arg``, when
    given): the integer and bool arguments in order, variant parameters
    included."""
    out, name, spill = [], None, ""
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1] if "'" in line else line
            args = re.findall(r"L[ib](\d+)E", mangled)
            name = (f"{marker}<{', '.join(args)}>"
                    if marker in mangled and args
                    and (not first_arg or args[0] == first_arg) else None)
            spill = ""
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            out.append((name, line.split("ptxas info    :")[-1].strip()
                        + "; " + spill))
            name = None
    return out


def phase_probes(dev, rng, fpp, ff, fp, adapt_batch, card):
    """Every stage-attribution probe variant against its plain version and
    its parity class, twice each, then its time. Returns {variant or P12
    case: (ms, plain_ms, bound_ms, bound_by, max_abs, library_ms)}."""
    from rtl_power_fftw_tpu_torch.probes._timing import slope_us
    N = fpp.N
    F, chunk = adapt_batch(4096)
    raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                        dtype=np.uint8)).to(dev)
    z = torch.complex(raw[:, 0::2].float() - 127.0,
                      raw[:, 1::2].float() - 127.0)
    fft_us = event_times_us(lambda: torch.fft.fft(z, dim=-1))
    masked = min(1000, F // 4)   # 1000 of the 4096 frames
    # The probes' K3 is the kernel K3 replaced, on its grid: the
    # control.
    ship = {("K3", nv): ff.fused_psd_fast_control(raw, nv, chunk)
            for nv in (F, masked)}
    ship.update({("K1", nv): fp.fused_psd(raw, nv, chunk)
                 for nv in (F, masked)})
    fpp.COUNTS.reset()
    results, launched = {}, 0
    for name, v in fpp.VARIANTS.items():
        errs = []
        for nv in (F, masked):
            got = fpp.fused_psd_probe(name, raw, nv, chunk)
            again = fpp.fused_psd_probe(name, raw, nv, chunk)
            want = fpp.fused_psd_probe_reference(name, raw, nv, chunk)
            torch.cuda.synchronize()
            launched += 2
            check(torch.equal(got, again), f"probe {name}: not deterministic")
            check(bool(torch.isfinite(got).all()), f"probe {name}: non-finite")
            err = max_rel(got.cpu().numpy(), want.cpu().numpy())
            errs.append(err)
            check(err <= v.rtol, f"probe {name} n_valid={nv}: {err} vs plain "
                  f"(<= {v.rtol:g})")
            if v.parity != "plain":
                # the shipping K3 or K1, or a variant run before it
                check(torch.equal(got, ship[(v.parity, nv)]),
                      f"probe {name} n_valid={nv}: not bit-identical to "
                      f"{v.parity}")
            ship[(name, nv)] = got
            if name == "k1_full":
                # the radix-2 control against K1 as it ships
                vs = max_rel(got.cpu().numpy(),
                             ship[("K1", nv)].cpu().numpy())
                print(f"probe k1_full n_valid={nv} against K1 (register "
                      f"transform): max rel {vs:.3e} (<= {UNIFORM_RTOL:g})")
                check(vs <= UNIFORM_RTOL, f"probe k1_full n_valid={nv}: "
                      f"{vs} from K1")
            if v.s2_form == fpp.KSTACKED:
                # the 6-product scheme's products in another f32 order
                vs = max_rel(got.cpu().numpy(),
                             ship[("tpu6", nv)].cpu().numpy())
                print(f"probe {name} n_valid={nv} against tpu6: max rel "
                      f"{vs:.3e}")
            if nv == F:
                max_abs = float((got.double() - want.double()).abs().max())
        k_us = slope_us(lambda it: fpp.fused_psd_probe(name, raw, F, chunk,
                                                       iters=it))
        p_us = event_times_us(
            lambda: fpp.fused_psd_probe_reference(name, raw, F, chunk),
            iters=20, warmup=3)
        b_ms, b_by = rate_bound_ms(*v.work(F))
        done = ""
        if v.s1_form in fpp.ZERO_BLOCK_FORMS:
            # the bound is the spectrum's work; this, the zero blocks' too
            d_ms, d_by = rate_bound_ms(*v.work(F, zero_blocks=True))
            done = f" ({1e3 * d_ms:.1f} us, {d_by}, with its zero blocks)"
        results[name] = (k_us / 1e3, p_us / 1e3, b_ms, b_by, max_abs,
                         fft_us / 1e3)
        print(f"probe {name} ({'; '.join(v.tpu)}) N={N} F={F} chunk={chunk} "
              f"frames/block {fpp.block_frames(name, F, chunk, None, dev)} "
              f"on {card}: "
              f"{k_us:.1f} us/step ({F * N / k_us / 1e3:.2f} GS/s), plain "
              f"{p_us:.1f} us, bound {1e3 * b_ms:.1f} us ({b_by}){done}, "
              f"torch.fft.fft {fft_us:.1f} us; max rel vs plain "
              f"{errs[0]:.3e} / masked {errs[1]:.3e} (<= {v.rtol:g}); "
              f"parity {v.parity}")
    check(sum(fpp.COUNTS.kernel.values()) >= launched
          and not fpp.COUNTS.plain,
          f"probe launch counter did not move as expected: {fpp.COUNTS.kernel}"
          f", plain {fpp.COUNTS.plain}")
    for name in ("k3", "zplanes", "k1_full", "k1r_full", "gather"):
        profile_calls(f"probe {name} N={N} F={F}",
                      lambda: fpp.fused_psd_probe(name, raw, F, chunk),
                      ("group_kernel", "regs_kernel", "psd_sum_kernel"))
    # K1's cuts at the canonical drive's step, where torch.fft.fft of the
    # same frames takes less than K1.
    Fc, cc = adapt_batch(400)
    few, zc = raw[:Fc], z[:Fc]
    cuts = []
    for name in ("k1r_full", "k1r_dqonly", "k1r_nofft"):
        us = slope_us(lambda it: fpp.fused_psd_probe(name, few, Fc, cc,
                                                     iters=it))
        cuts.append(f"{name} {us:.1f}")
    print(f"probe K1's cuts N={N} F={Fc} chunk={cc} frames/block "
          f"{fpp.block_frames('k1r_full', Fc, cc, None, dev)} on {card}: "
          f"{', '.join(cuts)} us/step; torch.fft.fft "
          f"{device_times_us(lambda: torch.fft.fft(zc, dim=-1)):.1f} us")
    profile_calls(f"probe k1r_full N={N} F={Fc}",
                  lambda: fpp.fused_psd_probe("k1r_full", few, Fc, cc),
                  ("regs_kernel", "psd_sum_kernel"))
    probe_occupancy(fpp, raw, F, chunk, card, slope_us)

    n = fpp.T * fpp._N1 * fpp._N2
    for case, r in fpp.RELAYOUTS.items():
        x = torch.arange(n, dtype=torch.float32, device=dev).reshape(r.in_shape)
        got = fpp.relayout(case, x)
        want = fpp.relayout_reference(case, x)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"P12 {r.name}: not equal to torch's")
        k_us = slope_us(lambda it: fpp.relayout(case, x, iters=it))
        p_us = event_times_us(lambda: fpp.relayout_reference(case, x))
        lib_us = event_times_us(lambda: r.fn(x).contiguous())
        b_ms, b_by = rate_bound_ms(2 * 4 * n, 0.0, 0.0)
        results[case] = (k_us / 1e3, p_us / 1e3, b_ms, b_by, 0.0,
                         lib_us / 1e3)
        print(f"probe P12 {r.name} {r.in_shape} -> {r.out_shape} on {card}: "
              f"{k_us:.2f} us/step, plain (torch, contiguous) {p_us:.2f} us, "
              f"bound {1e3 * b_ms:.3f} us ({b_by}); exact")
    return results


def probe_occupancy(fpp, raw, F, chunk, card, slope_us) -> None:
    """Each probe variant's registers, spill, shared memory and resident
    blocks per SM as it launches, and its time again at the occupancy of
    the whole kernels it is compared with: K3's and the 6-product scheme's
    (every variant of K3's template at both; the 6-product scheme's
    variants, and K3 and those of the others that get fewer blocks than
    K3, also at the least occupancy any of that family gets), the radix-2
    kernel's (its cuts), K1's (the register kernel's cuts). A pinned
    launch pads the block's shared memory (largest carveout) so that no
    more blocks reside; its output must not change. K3 pinned at its own
    occupancy is the control: what the padding and carveout alone cost."""
    own = {name: fpp.probe_attributes(name)["blocks_per_sm"]
           for name in fpp.VARIANTS}
    pins = {"k3": own["k3"], "tpu6": own["tpu6"], "k1": own["k1_full"],
            "k1r": own["k1r_full"]}
    # The chained variants' and the wide stage 1's registers allow one
    # block a SM. The left forms (P16's, P9's) run at this family's pins
    # too.
    tpu6_family = [n for n, v in fpp.VARIANTS.items()
                   if n.startswith("tpu6") or v.s2_form == fpp.LEFT]
    least_tpu6 = min(own[n] for n in tpu6_family)
    least_k3 = min(own[n] for n, v in fpp.VARIANTS.items()
                   if v.kernel == "k3" and n not in tpu6_family)

    def pins_of(name: str, v) -> set:
        if v.kernel in ("k1", "k1r"):
            return {pins[v.kernel]}
        both = {pins["k3"], pins["tpu6"]}
        if name in tpu6_family:
            return both | {least_tpu6}
        if name == "k3" or own[name] < pins["k3"]:
            return both | {least_k3}
        return both

    for name, v in fpp.VARIANTS.items():
        a = fpp.probe_attributes(name)
        base = fpp.fused_psd_probe(name, raw, F, chunk)
        k_us = slope_us(lambda it: fpp.fused_psd_probe(name, raw, F, chunk,
                                                       iters=it))
        parts = []
        for b in sorted(pins_of(name, v), reverse=True):
            p = fpp.probe_attributes(name, b)
            got = fpp.fused_psd_probe(name, raw, F, chunk, blocks_per_sm=b)
            torch.cuda.synchronize()
            check(torch.equal(got, base), f"probe {name} at {b} blocks/SM: "
                  "output changed")
            check(p["blocks_per_sm"] <= b, f"probe {name}: {p} at pin {b}")
            p_us = slope_us(lambda it: fpp.fused_psd_probe(
                name, raw, F, chunk, iters=it, blocks_per_sm=b))
            parts.append(f"at {b} blocks/SM ({p['blocks_per_sm']} resident, "
                         f"{p['dynamic_smem']} B dynamic) {p_us:.1f} us/step")
        print(f"probe occupancy {name} on {card}: {a['registers']} registers, "
              f"{a['spill_bytes']} B spill, {a['static_smem']} + "
              f"{a['dynamic_smem']} B shared, {a['blocks_per_sm']} "
              f"blocks/SM: {k_us:.1f} us/step; " + "; ".join(parts))


def profile_calls(label, fn, markers, calls: int = 10, whole=(),
                  tries: int = 1) -> None:
    """Device time by kernel name of ``calls`` calls of ``fn`` under
    torch.profiler, per call ("not measured" where the profiler sees no
    device time). The profiler on the card has been seen to drop a run's
    records (all, or all but a few launches): with ``whole``, the run is
    repeated, up to ``tries`` times, until each of those markers shows
    ``calls`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        hits = {m: [(n, us) for k, n, us in rows if m in k] for m in markers}
        if (rows and sum(us for _, _, us in rows) > 0
                and all(sum(n for n, _ in hits[m]) == calls for m in whole)):
            break
    else:
        what = ("recorded no device time" if tries == 1 else
                f"recorded every launch in no run of {tries}")
        print(f"profile {label}: the profiler {what} (device times not "
              "measured)")
        return
    parts = [f"{m} {sum(us for _, us in hits[m]) / calls:.1f} us/call "
             f"({sum(n for n, _ in hits[m])} launches)" for m in markers]
    run = f" (run {attempt} of {tries})" if tries > 1 else ""
    print(f"profile {label}, {calls} calls{run}: " + "; ".join(parts))


#: profile_kernel's frames-per-block sweep (the default is 4 at F = 4096),
#: and the schedules' at 16 frames a block beside the 6-product scheme's.
TILE_SWEEP = ["full:1", "full:2", "full:8", "full:16", "dg3d:1", "dg3d:16",
              "k1_full:1", "k1_full:2", "k1_full:8", "k1_full:16",
              "k1r_full:4", "k1r_full:8", "k1r_full:32"]
SCHEDULE_SWEEP = {"s2_pipe": ["base:16", "pipe:16"],
                  "s2_ilv": ["ilv:16", "ilv4:16"]}


#: The probes' entry-point runs: (module, argv, the TPU probes it drives).
#: profile_kernel's run without argv is P1's, then P2's (pack8), as the
#: TPU module's; P6, P5, P3, P4, P7, P8, P9 and P10 are its builds by
#: name, s1wide and best at 4 and 8 frames a block (the TPU's tiles 128
#: and 256, profile_pallas.py:508-511, 782-787); the register kernel's
#: cuts run under P1's map, and a probe's launches are those of the first
#: run that drives it.
PROBE_RUNS = (("profile_kernel", [], ("P1", "P2")),
              ("profile_kernel", ["pack8c", "s1wide", "s1wide:8"],
               ("P6", "P5")),
              ("profile_kernel", ["dg3dall", "s1cat", "s1k32", "s1k96",
                                  "best", "best:8"],
               ("P3", "P4", "P7", "P8")),
              ("profile_kernel", ["v5", "v5left", "v6", "v6k"],
               ("P9", "P10")),
              ("profile_kernel", ["k1r_full", "k1r_dqonly", "k1r_nofft"],
               ("P1",)),
              ("s1_lanes", [], ("P18",)), ("s1_lanes2", [], ("P13",)),
              ("cast_test", [], ("P12",)), ("s2_fourmult", [], ("P14",)),
              ("s2_left", [], ("P16",)), ("s2_ilv", [], ("P19",)),
              ("s2_pipe", [], ("P11",)), ("s2_u32t", [], ("P17",)))


def drive_probes(fpp) -> dict:
    """The probes' entry points in-process (PROBE_RUNS), every launch
    counter reset just before each run: exit 0, one line per variant run,
    each of those variants launched and no plain version run. Returns
    {TPU probe: launches of its variants in the run that drove it}."""
    import importlib
    launches = {}
    for module, argv, tpus in PROBE_RUNS:
        entry = importlib.import_module(
            f"rtl_power_fftw_tpu_torch.probes.{module}")
        fpp.COUNTS.reset()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = entry.main(list(argv))
        wall = time.perf_counter() - t0
        text = out.getvalue()
        print(text, end="")
        lines = [ln for ln in text.splitlines() if not ln.startswith("#")]
        if tpus == ("P12",):
            want, runs = list(fpp.RELAYOUTS), len(fpp.RELAYOUTS)
        else:
            want = [p.variants[name] for p, name in fpp.entry_variants(
                tpus[0], [a.partition(":")[0] for a in argv])]
            runs = len(want)
        missing = [v for v in want if fpp.COUNTS.kernel[v] == 0]
        print(f"e2e probe {' '.join([module] + argv)} ({', '.join(tpus)}): "
              f"exit {rc} in {wall:.2f} s wall; {len(lines)} lines; launches "
              f"{dict(fpp.COUNTS.kernel)}")
        check(rc == 0, f"probe entry {module} exited {rc}")
        check(len(lines) == runs, f"probe entry {module}: {len(lines)} "
              f"lines for {runs} variant runs")
        check(not missing and not fpp.COUNTS.plain,
              f"probe entry {module}: not launched {missing}, plain "
              f"{dict(fpp.COUNTS.plain)}")
        for tpu in tpus:
            own = (fpp.RELAYOUTS if tpu == "P12"
                   else set(fpp.PROBES[tpu].variants.values()))
            launches.setdefault(tpu, sum(fpp.COUNTS.kernel[v] for v in own))
    from rtl_power_fftw_tpu_torch.probes import profile_kernel
    fpp.COUNTS.reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = profile_kernel.main(TILE_SWEEP)
    print(out.getvalue(), end="")
    check(rc == 0 and len(out.getvalue().splitlines()) == len(TILE_SWEEP) + 1,
          f"profile_kernel tile sweep exited {rc}")
    print(f"e2e probe profile_kernel tile sweep (P1): launches "
          f"{dict(fpp.COUNTS.kernel)}")
    for module, specs in SCHEDULE_SWEEP.items():
        entry = importlib.import_module(
            f"rtl_power_fftw_tpu_torch.probes.{module}")
        fpp.COUNTS.reset()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = entry.main(specs)
        print(out.getvalue(), end="")
        check(rc == 0 and len(out.getvalue().splitlines()) == len(specs) + 1,
              f"{module} tile sweep exited {rc}")
        print(f"e2e probe {module} tile sweep: launches "
              f"{dict(fpp.COUNTS.kernel)}")
    return launches


# The reference's documented example session (doc/rtl_power_fftw.1.md
# 182-201: 144.1-146.1 MHz, 500 bins, 100 spectra, matrix mode) on a
# synthetic tone in the band, less its "-m <path>".
MAN_PAGE_ARGV = ["-f", "144.1M:146.1M", "-b", "500", "-n", "100",
                 "--source", "synthetic:tone=145.3M/35,noise=6,seed=1"]


# The -b 998 tone drive of phase 13, less its "--record <path>".
B998_ARGV = ["-f", "100M", "-n", "2000", "-b", "998", "-l", "--source",
             SOURCE]


def drive_frames_per_step(argv, streams: int = 1) -> int:
    """The frames a step of the drive with ``argv`` takes, before
    adapt_batch: its planned buffer // 2N, as the session sizes its step,
    at most 4096 (the Datastore) or, over ``streams`` > 1, from 64 to 2048
    (MultiStreamAcquisition). The man-page drive's buffer is the smallest
    multiple of BASE_BUF that holds its 100 frames (114 frames, a step of
    120); the -b 998 drive's is the default 1638400 bytes (820 frames, a
    step of 824)."""
    from rtl_power_fftw_tpu_torch.config import parse_args
    from rtl_power_fftw_tpu_torch.planning import Plan
    params = parse_args(argv, stderr=io.StringIO())
    Plan(params, RATE)
    frames = params.buf_length // (2 * params.N)
    if streams > 1:
        return max(64, min(frames, 2048))
    return max(1, min(frames, 4096))


def awkward_bound_ms(frames: int, N: int, windowed: bool,
                     out_rows: int = 1):
    """rate_bound_ms of a step at N bins that need not be a power of two:
    k1_work's count with a real-valued log2 N (the frames and output's
    bytes; 4 N log2 N - 6 N + 8 FP32 flops a frame for the transform, 2 N
    to dequantize, 2 N for |X|^2 and the sum, 2 N for a window)."""
    nbytes = frames * 2 * N + 4 * N * out_rows + (4 * N if windowed else 0)
    fp32 = 4 * N * math.log2(N) - 2 * N + 8 + (2 * N if windowed else 0)
    return rate_bound_ms(nbytes, 0.0, frames * fp32)


def phase_awkward(dev, rng, fp, fm, fb, adapt_batch, make_window, cli, ff,
                  card):
    """13. The awkward-N kernels (``fused_psd_mixed``, ``fused_psd_bluestein``
    and their streams entries): against their plain versions and the
    float64 golden, twice each; every plan of each; their 60-seed tone
    yards against the scipy float32 class; their times beside the control
    they replaced (``fused_psd_mixed_control``,
    ``fused_psd_bluestein_control``), ``torch.fft.fft`` and the bound; the
    man-page drive, its two-stream form and -b 998 drives through the CLI,
    each on its kernel alone. Returns the kernels-line entries."""
    t0 = time.perf_counter()
    man_page_fps = drive_frames_per_step(MAN_PAGE_ARGV)
    b998_F = adapt_batch(drive_frames_per_step(B998_ARGV))[0]
    b998_last = 2000 % b998_F
    controls = {"M": fm.fused_psd_mixed_control,
                "Ms": fm.fused_psd_mixed_control,
                "B": fb.fused_psd_bluestein_control,
                "Bs": fb.fused_psd_bluestein_control}
    kernels = {"M": (fm.fused_psd_mixed, fp.fused_psd_reference),
               "B": (fb.fused_psd_bluestein, fb.bluestein_psd_reference),
               "Ms": (fm.fused_psd_mixed_streams,
                      fp.fused_psd_streams_reference),
               "Bs": (fb.fused_psd_bluestein_streams,
                      fb.bluestein_psd_streams_reference)}
    cases = [  # (kernel, label, N, frames_per_step, n_valid or None, window)
        ("M", "N=500 man-page step", 500, man_page_fps, 100, None),
        ("M", "N=2400 F=4096", 2400, 4096, None, None),
        ("M", "N=2400 F=4096 hann masked", 2400, 4096, 3000, "hann"),
        ("M", "N=12000 F=64", 12000, 64, None, None),
        ("B", "N=998 F=4096", 998, 4096, None, None),
        ("B", "N=998 F=4096 hann masked", 998, 4096, 2500, "hann"),
        ("B", "N=998 -b 998 drive step", 998, b998_F, None, None),
        ("B", "N=998 -b 998 drive's last step", 998, b998_F, b998_last,
         None),
        ("B", "N=8182 F=1024", 8182, 1024, None, None),
    ]
    reset_counts(fp, ff)
    for name, label, N, fps, n_valid, wname in cases:
        kernel, plain = kernels[name]
        F, chunk = adapt_batch(fps)
        nv = F if n_valid is None else n_valid
        w_np = None if wname is None else make_window(wname, N)
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        got = kernel(raw, nv, chunk, w)
        again = kernel(raw, nv, chunk, w)
        want = plain(raw, nv, chunk, w)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{name} {label}: not deterministic")
        got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
        gold = golden_partial(raw_np, nv, w_np)
        err_plain, err_gold = max_rel(got_np, want_np), max_rel(got_np, gold)
        print(f"awkward {name} {label} (N={N} F={F} chunk={chunk} "
              f"n_valid={nv}): max rel vs plain {err_plain:.3e}, vs float64 "
              f"golden {err_gold:.3e} (plain vs golden "
              f"{max_rel(want_np, gold):.3e})")
        check(np.all(np.isfinite(got_np)) and got_np.shape == (N,),
              f"{name} {label}: malformed output")
        check(err_plain <= UNIFORM_RTOL, f"{name} {label}: {err_plain} vs "
              "plain")
        check(err_gold <= GOLDEN_RTOL, f"{name} {label}: {err_gold} vs golden")
    counts = launch_counts(fp, ff)
    n_m = 2 * sum(case[0] == "M" for case in cases)
    check(counts["M"] == n_m and counts["B"] == 2 * len(cases) - n_m
          and counts["plain"] == 0 and counts["M/B control"] == 0,
          f"awkward launch counts: {counts}")
    # The streams entries: counts (F, 0, 5), per stream against plain and
    # the golden, the empty stream exactly 0; then the steps of the
    # two-stream drives, with their counts (the man-page drive's 100 of
    # 120 frames a stream; the -b 998 drive's first step and its last).
    for name, N, fps, counts, wname in (
            ("Ms", 500, 256, None, None), ("Ms", 2400, 64, None, "hann"),
            ("Bs", 998, 128, None, None), ("Bs", 510, 64, None, "hann"),
            ("Ms", 500, drive_frames_per_step(MAN_PAGE_ARGV, 2), (100, 100),
             None),
            ("Bs", 998, drive_frames_per_step(B998_ARGV, 2),
             (b998_F, b998_last), None)):
        kernel, plain = kernels[name]
        F, chunk = adapt_batch(fps)
        w_np = None if wname is None else make_window(wname, N)
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        nv_np = np.array(counts or (F, 0, 5), np.int32)
        raw_np = rng.integers(0, 256, (len(nv_np), F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        nv = torch.from_numpy(nv_np).to(dev)
        got, again = kernel(raw, nv, chunk, w), kernel(raw, nv, chunk, w)
        want = plain(raw, nv, chunk, w).cpu().numpy()
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{name} N={N} F={F}: not "
              "deterministic")
        got = got.cpu().numpy()
        ctrl = controls[name](raw, nv, chunk, w).cpu().numpy()
        live = [s for s in range(len(nv_np)) if nv_np[s] > 0]
        golds = {s: golden_partial(raw_np[s], int(nv_np[s]), w_np)
                 for s in live}
        errs = [max_rel(got[s], golds[s]) for s in live]
        err_plain = max(max_rel(got[s], want[s]) for s in live)
        empty = [float(got[s].max()) for s in range(len(nv_np))
                 if nv_np[s] == 0]
        print(f"awkward {name} S={len(nv_np)} N={N} F={F} chunk={chunk} "
              f"window={wname} counts {nv_np.tolist()}: max rel vs plain "
              f"{err_plain:.3e}, vs float64 golden {max(errs):.3e} (plain "
              f"vs golden {max(max_rel(want[s], golds[s]) for s in live):.3e}"
              f"; the control vs golden "
              f"{max(max_rel(ctrl[s], golds[s]) for s in live):.3e}, vs "
              f"plain {max(max_rel(ctrl[s], want[s]) for s in live):.3e})"
              f"{f'; empty stream max {empty[0]}' if empty else ''}")
        check(err_plain <= UNIFORM_RTOL and max(errs) <= GOLDEN_RTOL
              and not any(empty), f"{name} N={N} F={F}")
        if (name, N, wname) == ("Bs", 510, "hann"):
            # Here plain (cuFFT) is further from the float64 golden than
            # the kernel, so the kernel is held to the golden itself.
            plain_gold = max(max_rel(want[s], golds[s]) for s in live)
            print(f"awkward Bs N=510 hann criterion: the kernel's max rel "
                  f"vs the float64 golden {max(errs):.3e} (<= "
                  f"{CHIRP510_GOLDEN_RTOL:g}); plain's {plain_gold:.3e}")
            check(max(errs) <= CHIRP510_GOLDEN_RTOL, "Bs N=510 hann: "
                  f"{max(errs)} from the float64 golden")
    # Every plan the mixed-radix kernel takes (each even 7-smooth N up
    # to 16384) and a spread of the chirp-Z kernel's (every even N to 256,
    # every 62nd to 8192, the top two), 8 random frames each, every third
    # with Hann, against the float64 golden.
    sweep = ([("M", N) for N in range(2, fm.MAX_N + 1, 2)
              if fm.fused_psd_mixed_eligible(N)]
             + [("B", N) for N in [*range(2, 258, 2), *range(258, 8190, 62),
                                   8190, 8192]])
    worst = (0.0, None)
    for i, (name, N) in enumerate(sweep):
        w_np = make_window("hann", N) if i % 3 == 2 else None
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        raw_np = rng.integers(0, 256, (8, 2 * N), dtype=np.uint8)
        got = kernels[name][0](torch.from_numpy(raw_np).to(dev), 8, 8, w)
        err = max_rel(got.cpu().numpy(), golden_partial(raw_np, 8, w_np))
        if err >= worst[0]:
            worst = (err, (name, N, "hann" if w_np is not None else None))
    print(f"awkward sweep of {len(sweep)} plans ("
          f"{sum(n == 'M' for n, _ in sweep)} mixed-radix, "
          f"{sum(n == 'B' for n, _ in sweep)} chirp-Z), 8 frames each: "
          f"worst max rel vs float64 golden {worst[0]:.3e} at {worst[1]}")
    check(worst[0] <= GOLDEN_RTOL, f"awkward sweep: {worst}")
    print(f"wall: awkward checks in {time.perf_counter() - t0:.1f} s")

    # The admission yards: median <= 1.5x, max <= 3x the scipy float32
    # class; a band whose yard fails is not routed.
    tone_yard("mixed", dev, fp, make_window, None, ((500, 64), (2400, 64)),
              9000, *kernels["M"])
    tone_yard("mixed", dev, fp, make_window, "hann", ((6000, 32),), 9100,
              *kernels["M"])
    for wname, seed0 in ((None, 9200), ("hann", 9300)):
        tone_yard("chirp-Z", dev, fp, make_window, wname, ((998, 64),), seed0,
                  *kernels["B"])
    print(f"wall: awkward yards in {time.perf_counter() - t0:.1f} s")

    # Times (PERF.md states their prediction): the kernel and the control it
    # replaced one after the other at every phase-13 shape: a call (CUDA
    # events around each), the device's part (calls queued behind a sleep
    # kernel, twice each in turns), the wrapper's host part, the plain
    # version and torch.fft.fft on the same frames (complex64 on the card);
    # each entry's max abs error against its plain version there. The
    # device time must be at most 0.6 of the control's for the mixed-radix
    # kernel at 2400/4096, 0.7 for the chirp-Z kernel at 998/4096, 1.05
    # everywhere else.
    limits = {("M", 2400, 4096): 0.6, ("B", 998, 4096): 0.7}
    times = {}
    for name, N, fps, S in (("M", 500, 32, 1), ("M", 500, man_page_fps, 1),
                            ("M", 2400, 4096, 1), ("M", 12000, 64, 1),
                            ("B", 998, 4096, 1), ("B", 998, b998_F, 1),
                            ("B", 8182, 1024, 1), ("Ms", 2400, 2048, 2),
                            ("Bs", 998, 2048, 2)):
        kernel, plain = kernels[name]
        control = controls[name]
        F, chunk = adapt_batch(fps)
        shape = (S, F, 2 * N) if S > 1 else (F, 2 * N)
        raw = torch.from_numpy(rng.integers(0, 256, shape,
                                            dtype=np.uint8)).to(dev)
        nv = (torch.full((S,), F, dtype=torch.int32, device=dev) if S > 1
              else F)
        flat = raw.reshape(S * F, 2 * N)
        z = torch.complex(flat[:, 0::2].float() - 127.0,
                          flat[:, 1::2].float() - 127.0)
        got = kernel(raw, nv, chunk).double()
        max_abs = float((got - plain(raw, nv, chunk).double()).abs().max())
        control_rel = max_rel(control(raw, nv, chunk).cpu().numpy(),
                              got.cpu().numpy())
        t = {"max_abs": max_abs,
             "call": event_times_us(lambda: kernel(raw, nv, chunk)),
             "control": event_times_us(lambda: control(raw, nv, chunk)),
             "plain": event_times_us(lambda: plain(raw, nv, chunk)),
             "lib": event_times_us(lambda: torch.fft.fft(z, dim=-1))}
        kd = [device_times_us(lambda: kernel(raw, nv, chunk))]
        cd = [device_times_us(lambda: control(raw, nv, chunk))]
        cd.append(device_times_us(lambda: control(raw, nv, chunk)))
        kd.append(device_times_us(lambda: kernel(raw, nv, chunk)))
        t.update(device=min(kd), control_device=min(cd),
                 lib_device=device_times_us(lambda: torch.fft.fft(z, dim=-1)),
                 host=host_us(lambda: kernel(raw, nv, chunk)),
                 control_host=host_us(lambda: control(raw, nv, chunk)))
        t["bound"] = awkward_bound_ms(S * F, N, False, S)
        times[(name, N, F)] = t
        limit = limits.get((name, N, F), 1.05)
        ratio = t["device"] / t["control_device"]
        b_us = 1e3 * t["bound"][0]
        print(f"time awkward {name} N={N} F={F}{f' S={S}' * (S > 1)} on "
              f"{card}: kernel {t['call']:.1f} us a call, device "
              f"{kd[0]:.1f}/{kd[1]:.1f} us, host {t['host']:.1f} us "
              f"({S * F * N / t['device'] / 1e3:.2f} GS/s on the device); "
              f"control {t['control']:.1f} us a call, device "
              f"{cd[0]:.1f}/{cd[1]:.1f} us, host {t['control_host']:.1f} "
              f"us; device/control {ratio:.3f} (<= {limit}); plain "
              f"{t['plain']:.1f} us a call; torch.fft.fft of the complex64 "
              f"frames {t['lib']:.1f} us a call (device "
              f"{t['lib_device']:.1f}), kernel/fft on the device "
              f"{t['device'] / t['lib_device']:.3f}; bound {b_us:.2f} us "
              f"({t['bound'][1]}), device/bound {t['device'] / b_us:.1f}x; "
              f"max abs vs plain {max_abs:.4g}; control vs kernel max rel "
              f"{control_rel:.3e}")
        check(control_rel <= UNIFORM_RTOL, f"{name} N={N} F={F}: the "
              f"control and the kernel differ by {control_rel}")
        check(ratio <= limit, f"{name} N={N} F={F}: {t['device']:.1f} us of "
              f"device time is above {limit} of the control's "
              f"{t['control_device']:.1f} us")
    print(f"wall: awkward times in {time.perf_counter() - t0:.1f} s")

    # The drives, each on its kernel alone.
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        launches["M"] = drive_man_page(cli, fp, ff, tmp, 1)
        launches["M streams"] = drive_man_page(cli, fp, ff, tmp, 2)
        for S, key in ((1, "B"), (2, "B streams")):
            record = os.path.join(tmp, f"b998_{S}.iq")
            N, repeats = 998, 2000
            argv = B998_ARGV + ["--record", record]
            if S > 1:
                argv += ["--streams", str(S)]

            def golden(record=record, S=S, N=N, repeats=repeats):
                if S == 1:
                    return recorded_golden(record, N, repeats, N)
                return sum(recorded_golden(f"{record}.s{s}", N, repeats, N)
                           for s in range(S)) / S

            launches[key] = drive(f"-b 998 tone{' --streams 2' * (S > 1)}",
                                  argv, cli, fp, ff, key, N, golden,
                                  GOLDEN_RTOL, streams=S)
    print(f"wall: awkward phase in {time.perf_counter() - t0:.1f} s")

    def entry(name, source, replaces, key, times_key):
        t = times[times_key]
        return {"name": name, "route": "cuda", "source": CSRC + source,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": t["max_abs"], "ms": t["call"] / 1000.0,
                "plain_ms": t["plain"] / 1000.0, "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": t["lib"] / 1000.0,
                "device_ms": t["device"] / 1000.0,
                "host_ms": t["host"] / 1000.0,
                "control_ms": t["control"] / 1000.0,
                "control_device_ms": t["control_device"] / 1000.0,
                "control_host_ms": t["control_host"] / 1000.0}

    xla_ladder = "rtl_power_fftw_tpu/ops/spectral.py:388"
    chirp_z = "rtl_power_fftw_tpu/ops/dft.py:1069"
    return [entry("fused_psd_mixed", "fused_psd_mixed.cu", xla_ladder, "M",
                  ("M", 2400, 4096)),
            entry("fused_psd_mixed_streams", "fused_psd_mixed.cu", xla_ladder,
                  "M streams", ("Ms", 2400, 2048)),
            entry("fused_psd_bluestein", "fused_psd_mixed.cu", chirp_z,
                  "B", ("B", 998, 4096)),
            entry("fused_psd_bluestein_streams", "fused_psd_mixed.cu",
                  chirp_z, "B streams", ("Bs", 998, 2048))]


def drive_man_page(cli, fp, ff, tmp, streams: int, sk: bool = False) -> int:
    """The man-page session (matrix mode) through the CLI on the
    mixed-radix kernel (its streams entry over ``streams`` > 1; with
    ``sk``, ``--sk-file`` on SK-M, or over streams on SK-M-S): exit 0,
    the kernel's path, a .met of one 500-bin scan, a .bin (dB) within 1e-5
    of the float64 golden of the recorded stream(s) in linear power, its
    peak at the tone, the SK file (``sk``) within 1e-4 of the float64 SK
    of the same frames (every stream's together, M = streams x 100), and
    launches of the kernel alone. Returns them."""
    N, repeats = 500, 100
    stem = os.path.join(tmp, f"man_page_{streams}{'_sk' * sk}")
    record = stem + ".iq"
    argv = MAN_PAGE_ARGV + ["-m", stem, "--record", record]
    shown = MAN_PAGE_ARGV + (["--sk-file"] if sk else [])
    key = ("SK-M-S" if streams > 1 else "SK-M") if sk else (
        "M" if streams == 1 else "M streams")
    if streams > 1:
        argv += ["--streams", str(streams)]
        shown += ["--streams", str(streams)]
    if sk:
        argv += [f"--sk-file={stem}.sk"]
    reset_counts(fp, ff)
    rc, _, err, wall = run_cli(argv, cli.main)
    counts = launch_counts(fp, ff)
    log(err[-800:])
    check(rc == 0, f"man-page drive ({' '.join(shown)}) exited {rc}")
    path = "cuda_sk" if sk else "cuda_mixed"
    check(f"Transform path: {path} " in err, f"man-page drive off {key}")
    with open(stem + ".met") as f:
        meta = [line.split("#")[0].strip() for line in f]
    data = np.fromfile(stem + ".bin", dtype=np.float32)
    check(int(meta[0]) == N and int(meta[1]) == 1 and data.size == N
          and np.all(np.isfinite(data)),
          f"man-page drive: .met {meta[:2]}, .bin {data.size} values")
    records = ([record] if streams == 1
               else [f"{record}.s{s}" for s in range(streams)])
    gold = sum(recorded_golden(r, N, repeats, N) for r in records) / streams
    err_gold = max_rel(10.0 ** (data.astype(np.float64) / 10.0), gold)
    peak = 145.1e6 + (int(np.argmax(data)) - N // 2) * RATE / N
    sk_line = ""
    if sk:
        sk_file, sk_err = sk_file_error(
            stem + ".sk", np.concatenate([recorded_frames(r, N)[:repeats]
                                          for r in records]),
            streams * repeats)
        sk_line = (f"; SK file {len(sk_file)} bins, max |SK - float64 "
                   f"golden| {sk_err:.3e} (<= 1e-4)")
        check(len(sk_file) == N and sk_err <= 1e-4,
              "man-page drive: SK file")
    print(f"e2e man-page drive ({' '.join(shown)}): exit 0 in {wall:.2f} s "
          f"wall; .met {meta[0]}x{meta[1]}; peak {peak / 1e6:.4f} MHz; max "
          f"rel vs float64 golden {err_gold:.3e} (<= {GOLDEN_RTOL:g}, the "
          f".bin's float32 dB){sk_line}; launches {counts}")
    check(abs(peak - 145.3e6) <= RATE / N, f"man-page drive: peak at {peak}")
    check(err_gold <= GOLDEN_RTOL, "man-page drive vs float64 golden")
    check_only(counts, key, "man-page drive")
    return counts[key]


# The estimator drives of phase 14 (2048 bins, the tone source, linear
# output), less their "--record <path>" and output files.
EST_ARGV = ["-f", "100M", "-n", "4000", "-b", "2048", "-l", "--source",
            SOURCE]
# The two-hop matrix-mode PFB scan (hops at 101 and 102 MHz), less its
# "-m <path>" and "--record <path>".
PFB_SCAN_ARGV = ["-f", "100M:103M", "-n", "100", "-b", "2048", "-q",
                 "--pfb-taps", "4", "--source", SOURCE]


def recorded_frames(record, N):
    """The (n, 2N) u8 frames of a recorded stream."""
    stream = np.fromfile(record, dtype=np.uint8)
    return stream[:len(stream) // (2 * N) * 2 * N].reshape(-1, 2 * N)


def dequant64(raw):
    """(F, 2N) u8 -> (F, N) complex128, u8 - 127."""
    return ((raw[:, 0::2].astype(np.float64) - 127.0)
            + 1j * (raw[:, 1::2].astype(np.float64) - 127.0))


def golden_moments(raw, n_valid, window=None):
    """float64 s1 = sum of |X|^2 and s2 = sum of |X|^4 over the first
    n_valid frames, unshifted bins."""
    N = raw.shape[1] // 2
    s1, s2 = np.zeros(N), np.zeros(N)
    for lo in range(0, n_valid, 256):
        z = dequant64(raw[lo:min(lo + 256, n_valid)])
        if window is not None:
            z = z * np.asarray(window, np.float64)
        p = np.abs(np.fft.fft(z, axis=1)) ** 2
        s1 += p.sum(0)
        s2 += (p * p).sum(0)
    return s1, s2


def golden_tapers(raw, n_valid, tapers):
    """float64 sum over the first n_valid frames of the mean over the K
    tapers (float32 rows, as the kernel reads them) of |DFT|^2."""
    N = raw.shape[1] // 2
    t = np.asarray(tapers, np.float64)
    pwr = np.zeros(N)
    for lo in range(0, n_valid, 64):
        z = dequant64(raw[lo:min(lo + 64, n_valid)])
        pwr += (np.abs(np.fft.fft(z[:, None, :] * t[None], axis=-1)) ** 2
                ).mean(axis=1).sum(axis=0)
    return pwr


def golden_pfb(virtual, n_valid, h):
    """float64 sum over output frames j < n_valid of |DFT(sum over p of
    h[p] x_{j+p})|^2 of a (F + P - 1, 2N) virtual row array."""
    P = h.shape[0]
    z = dequant64(virtual)
    hh = np.asarray(h, np.float64)
    s = sum(z[p:p + n_valid] * hh[p] for p in range(P))
    return (np.abs(np.fft.fft(s, axis=1)) ** 2).sum(0)


def k1_work_any(F: int, N: int, windowed: bool = False, out_rows: int = 1):
    """fused_psd_probe.k1_work at any even N: its count with a real-valued
    log2 N where N is not a power of two, as awkward_bound_ms counts."""
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    if N & (N - 1) == 0:
        return fpp.k1_work(F, N, windowed=windowed, out_rows=out_rows)
    nbytes = F * 2 * N + 4 * N * out_rows + (4 * N if windowed else 0)
    fp32 = 4 * N * math.log2(N) - 2 * N + 8 + (2 * N if windowed else 0)
    return float(nbytes), 0.0, float(F * fp32)


def estimator_bound_ms(kind: str, F: int, N: int, windowed: bool = False,
                       K: int = 1, P: int = 1):
    """rate_bound_ms of an estimator call from k1_work's count at any N
    (k1_work_any; bytes read and written once; split-radix FP32
    operations of the N-point function, at the chirp-Z N too, as
    awkward_bound_ms counts B's, not the chirp-Z algorithm's two M-point
    transforms): SK F (k1_work + 2N)
    with two output rows (four with the gate); MT F K (k1_work + 2N), the
    (K, N) tapers read once; PFB F (k1_work + 4 P N), (F + P - 1) 2N + 4 P
    N bytes read."""
    if kind == "SK":
        nbytes, _, fp32 = k1_work_any(F, N, windowed=windowed, out_rows=2)
        return rate_bound_ms(nbytes, 0.0, fp32 + F * 2 * N)
    if kind == "MT":
        nbytes, _, fp32 = k1_work_any(F, N, windowed=True)
        return rate_bound_ms(nbytes + 4 * N * (K - 1), 0.0,
                             K * (fp32 + F * 2 * N))
    _, _, fp32 = k1_work_any(F, N)
    nbytes = (F + P - 1) * 2 * N + 4 * P * N + 4 * N
    return rate_bound_ms(nbytes, 0.0, fp32 + F * 4 * P * N)


def estimator_yard(label, kernel_fn, golden_fn, class_fn, N, F, seed0,
                   seeds: int = 60):
    """An estimator's admission yard: ``seeds`` seeds of 35 dB tones
    (tone_frames) through ``kernel_fn(raw_np) -> numpy``, against the
    float64 ``golden_fn(raw_np)``, and the scipy float32 class
    ``class_fn(raw_np)``: median <= 1.5x and max <= 3x its error, per-seed
    p99 printed."""
    def errors(raw_np, got):
        gold = golden_fn(raw_np)
        return max_rel(got, gold), max_rel(class_fn(raw_np), gold)

    done = []
    for seed in range(seeds):
        raw_np = tone_frames(N, F, seed0 + seed)
        done.append(host_pool().submit(errors, raw_np, kernel_fn(raw_np)))
    ours, cls = zip(*(f.result() for f in done))
    e, c = np.asarray(ours), np.asarray(cls)
    r = e / c
    med_r, max_r = np.median(e) / np.median(c), e.max() / c.max()
    print(f"{label} yard N={N} F={F}, {seeds} seeds of 35 dB tones: max rel "
          f"median {np.median(e):.3e} / max {e.max():.3e}; scipy f32 "
          f"{np.median(c):.3e} / {c.max():.3e}; ratio median {med_r:.2f}x "
          f"(<= 1.5), max {max_r:.2f}x (<= 3), per-seed p99 "
          f"{np.quantile(r, 0.99):.2f}x, per-seed max {r.max():.2f}x")
    check(med_r <= 1.5 and max_r <= 3.0,
          f"{label} yard N={N}: above the FFTW-class budget")


def phase_estimators(dev, rng, fp, adapt_batch, make_window, cli, ff, card):
    """14. The estimator kernels (``fused_psd_sk``, ``fused_psd_tapers``,
    ``fused_psd_pfb``): against their plain versions and the float64
    golden, twice each; SK's s1 against K1's/K2's output bit for bit and
    SK's and the PFB's outputs against their controls' (the kernels they
    were redesigned from)
    bit for bit; the PFB's history across three steps; the 60-seed tone
    yards of SK's s2, the multitaper and the PFB; the CLI drives, each on
    its kernel alone; times beside the control, the plain version,
    torch.fft.fft and the bound. Returns the kernels-line entries."""
    import scipy.fft
    from rtl_power_fftw_tpu_torch.models.multitaper import _session_tapers
    from rtl_power_fftw_tpu_torch.models.pfb import pfb_prototype
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_sk as fsk
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_tapers as fmt
    t0 = time.perf_counter()
    drive_F = adapt_batch(drive_frames_per_step(EST_ARGV))[0]
    for N in (256, 2048, 16384):
        rows = []
        for w in (False, True):
            wn = " windowed" if w else ""
            if fsk.plane_fits(N):
                rows.append((f"fused_psd_sk plane{wn} (the route)",
                             fsk.kernel_attributes(N, w, True)))
            rows.append((f"fused_psd_sk control{wn}"
                         f"{'' if fsk.plane_fits(N) else ' (the route)'}",
                         fsk.kernel_attributes(N, w, False)))
        mt = fmt.batch_shape(N, 7) is not None
        if fmt.batch_smem(N, fmt.BATCH_FRAMES) <= fp.SMEM_PER_BLOCK:
            rows.append((f"fused_psd_tapers batch ({fmt.BATCH_FRAMES} "
                         f"frames a lane a batch"
                         f"{'; the route at K=7' if mt else ''})",
                         fmt.kernel_attributes(N, True)))
        rows.append((f"fused_psd_tapers control"
                     f"{'' if mt else ' (the route at K=7)'}",
                     fmt.kernel_attributes(N, False)))
        shape = fpf.ring_shape(N, 4)
        if shape is not None:
            rows.append((f"fused_psd_pfb ring P=4 (the route; {shape.slots} "
                         f"row slots, h {'staged' if shape.stage_h else 'through L2'})",
                         fpf.kernel_attributes(N, 4, True)))
        rows.append((f"fused_psd_pfb control P=4"
                     f"{' (the route)' if shape is None else ''}",
                     fpf.kernel_attributes(N, 4, False)))
        for name, attrs in rows:
            print(f"occupancy {name} N={N} on {card}: {attrs['registers']} "
                  f"registers, {attrs['spill_bytes']} B spill, "
                  f"{attrs['static_smem']} + {attrs['dynamic_smem']} B "
                  f"shared, {attrs['threads']} threads, "
                  f"{attrs['blocks_per_sm']} blocks/SM")
    reset_counts(fp, ff)
    want_counts = {"SK": 0, "SK control": 0, "MT": 0, "MT control": 0,
                   "PFB": 0, "PFB control": 0}

    # SK: s1 is K1's (K2's) output bit for bit, every row the control's
    # (the kernel it was redesigned from, on the same grid) bit for bit;
    # s1 and s2 within
    # 1e-5 of plain and of the float64 golden; under a gate, the kept rows
    # are the gate of the kernel's own s1 and s2 (sk_keep), bit for bit.
    for label, N, fps, n_valid, wname, sigma in (
            ("F=4096", 2048, 4096, None, None, 0.0),
            ("F=4096 hann masked", 2048, 4096, 3000, "hann", 0.0),
            ("drive step, gate 3", 2048, drive_F, None, None, 3.0),
            ("F=1024", 256, 1024, None, None, 0.0),
            ("F=64 gate 3", 16384, 64, None, None, 3.0)):
        F, chunk = adapt_batch(fps)
        nv = F if n_valid is None else n_valid
        w_np = None if wname is None else make_window(wname, N)
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        got = fsk.fused_psd_sk(raw, nv, chunk, w, sigma)
        again = fsk.fused_psd_sk(raw, nv, chunk, w, sigma)
        ctl = fsk.fused_psd_sk_control(raw, nv, chunk, w, sigma)
        k1 = fp.fused_psd(raw, nv, chunk, w)
        want = fsk.fused_psd_sk_reference(raw, nv, chunk, w, sigma)
        torch.cuda.synchronize()
        route = "SK" if fsk.plane_fits(N) else "SK control"
        want_counts[route] += 2
        want_counts["SK control"] += 1
        check(torch.equal(got, again), f"SK {label}: not deterministic")
        check(torch.equal(got[0], k1), f"SK {label}: s1 is not K1's output")
        check(torch.equal(got, ctl), f"SK {label}: not the control's bits")
        got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
        g1, g2 = golden_moments(raw_np, nv, w_np)
        errs = [max_rel(got_np[i], want_np[i]) for i in range(2)]
        golds = [max_rel(got_np[0], g1), max_rel(got_np[1], g2)]
        line = (f"estimators SK {label} (N={N} F={F} chunk={chunk} "
                f"n_valid={nv} window={wname}; the route: "
                f"{'plane' if route == 'SK' else 'control'}): s1 bit for bit "
                f"{'K2' if wname else 'K1'}'s, s1, s2 and gate rows the "
                f"control's; max rel vs plain s1 "
                f"{errs[0]:.3e} s2 {errs[1]:.3e}, vs float64 golden s1 "
                f"{golds[0]:.3e} s2 {golds[1]:.3e}")
        if sigma > 0.0:
            keep = fsk.sk_keep(got[0].cpu(), got[1].cpu(), float(nv),
                               sigma).numpy()
            check(np.array_equal(got_np[3], nv * keep)
                  and np.array_equal(got_np[2], got_np[0] * keep),
                  f"SK {label}: the gate epilogue is not sk_keep's")
            apart = int(((want_np[3] > 0) != (keep > 0)).sum())
            line += (f"; gate {sigma:g}: {int(keep.sum())} of {N} bins kept "
                     f"(plain {int((want_np[3] > 0).sum())}, decisions "
                     f"differing {apart})")
        print(line)
        check(max(errs) <= UNIFORM_RTOL and max(golds) <= GOLDEN_RTOL,
              f"SK {label}: {errs} vs plain, {golds} vs golden")

    # MT: the route (the batch kernel where batch_shape admits it, else
    # the control) and the control, each twice (the same bits again),
    # within 1e-5 of plain and of the float64 golden; their device times
    # in turns, the batch kernel's at most 1.05 of the control's.
    for label, N, fps, n_valid, K in (
            ("K=7 F=4096", 2048, 4096, None, 7),
            ("K=1 F=4096 masked", 2048, 4096, 2500, 1),
            ("K=7 F=4096 masked", 2048, 4096, 3000, 7),
            ("K=7 drive step", 2048, drive_F, None, 7),
            ("K=4 F=64", 16384, 64, None, 4),
            ("K=7 F=1024", 256, 1024, None, 7),
            ("K=7 F=256", 8192, 256, None, 7),
            ("K=16 F=800", 1024, 800, None, 16),
            ("K=7 F=200", 4096, 200, None, 7)):
        F, chunk = adapt_batch(fps)
        nv = F if n_valid is None else n_valid
        tp_np = _session_tapers(N, 4.0, K)
        tp = torch.from_numpy(tp_np).to(dev)
        raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        shape = fmt.batch_shape(N, K)
        got = fmt.fused_psd_tapers(raw, nv, chunk, tp)
        again = fmt.fused_psd_tapers(raw, nv, chunk, tp)
        ctl = fmt.fused_psd_tapers_control(raw, nv, chunk, tp)
        ctl_again = fmt.fused_psd_tapers_control(raw, nv, chunk, tp)
        want = fmt.fused_psd_tapers_reference(raw, nv, chunk, tp)
        torch.cuda.synchronize()
        want_counts["MT" if shape is not None else "MT control"] += 2
        want_counts["MT control"] += 2
        check(torch.equal(got, again) and torch.equal(ctl, ctl_again),
              f"MT {label}: not deterministic")
        gold = golden_tapers(raw_np, nv, tp_np)
        want_np = want.cpu().numpy()
        errs = {name: (max_rel(out.cpu().numpy(), want_np),
                       max_rel(out.cpu().numpy(), gold))
                for name, out in (("route", got), ("control", ctl))}
        if shape is None:
            route = "the control"
            timing = ""
        else:
            group, per_block = fmt.batch_grid(
                nv, K, N, fmt.batch_resident_blocks(N, dev.index))
            route = (f"the batch kernel, {shape.frames} frames a lane a "
                     f"batch, {group} frames a block, "
                     f"{-(-K // per_block)} taper ranges")
            kd, cd = [], []
            for _ in range(2):
                kd.append(device_times_us(
                    lambda: fmt.fused_psd_tapers(raw, nv, chunk, tp)))
                cd.append(device_times_us(
                    lambda: fmt.fused_psd_tapers_control(raw, nv, chunk,
                                                         tp)))
            # device_times_us's launches: 1 + calls + reps * calls, twice.
            want_counts["MT"] += 2 * (1 + 20 + 3 * 20)
            want_counts["MT control"] += 2 * (1 + 20 + 3 * 20)
            ratio = min(kd) / min(cd)
            timing = (f"; device {kd[0]:.1f}/{kd[1]:.1f} us, the control "
                      f"{cd[0]:.1f}/{cd[1]:.1f}, ratio {ratio:.3f} (<= 1.05)")
            check(ratio <= 1.05, f"MT {label}: {min(kd):.1f} us of device "
                  f"time is above 1.05 of the control's {min(cd):.1f} us")
        print(f"estimators MT {label} (N={N} F={F} chunk={chunk} n_valid="
              f"{nv} K={K}; the route: {route}): max rel vs plain "
              f"{errs['route'][0]:.3e}, vs float64 golden "
              f"{errs['route'][1]:.3e}; the control {errs['control'][0]:.3e}"
              f", {errs['control'][1]:.3e}{timing}")
        check(all(e[0] <= UNIFORM_RTOL and e[1] <= GOLDEN_RTOL
                  for e in errs.values()),
              f"MT {label}: {errs} (vs plain, vs golden)")

    # PFB: three consecutive steps of one stream (the second with fewer
    # valid frames than P - 1), the history on the card carried across
    # them and equal to plain's bit for bit, output and history the
    # control's (the kernel it was redesigned from, run on the route's
    # grid with histories of
    # its own) bit for bit; each step within 1e-5 of plain and of the
    # float64 golden where it sums >= 64 frames, and the three steps'
    # total (what a session accumulates) within 1e-5 of the golden. A
    # step of a few frames is held by its distance from the float64
    # golden over the mean power, <= 1e-5, with plain's distance printed
    # beside: its smallest bins are single periodogram values near 0,
    # whose max relative error measures the difference of nearly equal
    # terms, plain's own as much as the kernel's (both printed, not held).
    # The shapes: P = 2, 4, 16 at F = 512; the drives' step and the timed
    # F = 4096 (each a grid of its own, from the kernel's residency);
    # 16384 bins (the route: the control), with a one-frame second step.
    pfb_cases = ((2, 2048, 512, 0), (4, 2048, 512, 2), (16, 2048, 512, 14),
                 (4, 2048, drive_F, 2), (4, 2048, 4096, 2),
                 (4, 16384, 64, 1))
    for P, N, F, few in pfb_cases:
        chunk = adapt_batch(F)[1]
        h_np = pfb_prototype(N, P).reshape(P, N)
        h = torch.from_numpy(h_np).to(dev)
        hist = [torch.empty((P - 1, 2 * N), dtype=torch.uint8, device=dev)
                for _ in range(2)]
        hist_p = [torch.empty((P - 1, 2 * N), dtype=torch.uint8)
                  for _ in range(2)]
        hist_c = [torch.empty_like(t) for t in hist]
        ring_route = fpf.ring_shape(N, P) is not None
        group = fpf.pfb_group(F, chunk, N, P, dev.index, ring_route)
        want_counts["PFB" if ring_route else "PFB control"] += 5
        want_counts["PFB control"] += 3
        virtual = np.full((P - 1, 2 * N), 127, np.uint8)
        total, gold_total = np.zeros(N), np.zeros(N)
        for step, nv in enumerate((F, few, F - 5)):
            raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
            raw = torch.from_numpy(raw_np)
            got = fpf.fused_psd_pfb(raw.to(dev), hist[0], nv, chunk, h,
                                    hist[1], fresh=step == 0)
            ctl = fpf.fused_psd_pfb_control(raw.to(dev), hist_c[0], nv, chunk,
                                            h, hist_c[1], fresh=step == 0,
                                            group=group)
            want = fpf.fused_psd_pfb_reference(raw, hist_p[0], nv, chunk,
                                               h.cpu(), hist_p[1],
                                               fresh=step == 0)
            torch.cuda.synchronize()
            same_ctl = (torch.equal(got, ctl)
                        and torch.equal(hist[1], hist_c[1]))
            virtual = np.concatenate([virtual, raw_np])
            gold = golden_pfb(virtual, nv, h_np)
            virtual = virtual[nv:nv + P - 1]
            got_np = got.cpu().numpy()
            total += got_np
            gold_total += gold
            same_hist = torch.equal(hist[1].cpu(), hist_p[1])
            want_np = want.numpy()
            rel_plain = max_rel(got_np, want_np)
            if nv >= 64:
                err_plain = rel_plain
                err_gold = max_rel(got_np, gold)
                note = ""
            else:
                scale = max(gold.mean(), 1e-30)
                err_plain = float(np.abs(got_np - want_np).max()) / scale
                err_gold = float(np.abs(got_np - gold).max()) / scale
                note = (f" (the criterion, err/mean vs the float64 golden "
                        f"<= {GOLDEN_RTOL:g}: plain's "
                        f"{float(np.abs(want_np - gold).max()) / scale:.3e}; "
                        f"max rel vs the golden {max_rel(got_np, gold):.3e}, "
                        f"plain's {max_rel(want_np, gold):.3e}, and vs plain "
                        f"{rel_plain:.3e}, not held)")
            print(f"estimators PFB P={P} N={N} F={F} step {step} n_valid="
                  f"{nv} ({'ring' if ring_route else 'control'}, {group} "
                  f"frames a block): max "
                  f"{'rel' if nv >= 64 else 'err/mean'} vs plain "
                  f"{err_plain:.3e}, vs float64 golden {err_gold:.3e}{note}; "
                  f"history bit for bit plain's {same_hist}; output and "
                  f"history bit for bit the control's {same_ctl}")
            check(err_plain <= UNIFORM_RTOL and err_gold <= GOLDEN_RTOL
                  and same_hist and same_ctl, f"PFB P={P} step {step}")
            check(np.array_equal(hist[1].cpu().numpy(), virtual),
                  f"PFB P={P} step {step}: history is not rows n_valid .. "
                  "n_valid + P - 2")
            hist.reverse()
            hist_p.reverse()
            hist_c.reverse()
        err_total = max_rel(total, gold_total)
        print(f"estimators PFB P={P}: the three steps' total, max rel vs "
              f"float64 golden {err_total:.3e}")
        check(err_total <= GOLDEN_RTOL, f"PFB P={P}: total vs golden")
        # The same bits again from the same history and slot.
        raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        spare = torch.empty_like(hist[0])
        a = fpf.fused_psd_pfb(raw, hist[0], F, chunk, h, hist[1])
        b = fpf.fused_psd_pfb(raw, hist[0], F, chunk, h, spare)
        torch.cuda.synchronize()
        check(torch.equal(a, b) and torch.equal(hist[1], spare),
              f"PFB P={P}: not deterministic")
    counts = launch_counts(fp, ff)
    check(all(counts[k] == v for k, v in want_counts.items())
          and counts["plain"] == 0,
          f"estimator launch counts: {counts}, expected {want_counts}")
    print(f"wall: estimator checks in {time.perf_counter() - t0:.1f} s")

    # The admission yards (2048 bins, 64 frames a seed).
    N, F = 2048, 64

    def sk_s2(raw_np):
        raw = torch.from_numpy(raw_np).to(dev)
        return fsk.fused_psd_sk(raw, F, F)[1].cpu().numpy()

    def f32_class(z64):
        Xc = scipy.fft.fft(z64.astype(np.complex64), axis=-1)
        return (Xc.real.astype(np.float64) ** 2
                + Xc.imag.astype(np.float64) ** 2)

    reset_counts(fp, ff)
    estimator_yard("SK s2 (plane kernel)", sk_s2,
                   lambda raw_np: golden_moments(raw_np, F)[1],
                   lambda raw_np: (f32_class(dequant64(raw_np)) ** 2).sum(0),
                   N, F, 14000)
    tp_np = _session_tapers(N, 4.0, 7)
    tp = torch.from_numpy(tp_np).to(dev)
    estimator_yard(
        "multitaper K=7 (batch kernel)",
        lambda raw_np: fmt.fused_psd_tapers(
            torch.from_numpy(raw_np).to(dev), F, F, tp).cpu().numpy(),
        lambda raw_np: golden_tapers(raw_np, F, tp_np),
        lambda raw_np: f32_class(
            dequant64(raw_np)[:, None, :]
            * tp_np.astype(np.float64)[None]).mean(1).sum(0),
        N, F, 14100)
    P = 4
    h_np = pfb_prototype(N, P).reshape(P, N)
    h = torch.from_numpy(h_np).to(dev)
    hist = [torch.empty((P - 1, 2 * N), dtype=torch.uint8, device=dev)
            for _ in range(2)]

    def pfb_virtual(raw_np):
        return np.concatenate([np.full((P - 1, 2 * N), 127, np.uint8),
                               raw_np])

    def pfb_class(raw_np):
        sums = fpf.pfb_sums_reference(torch.from_numpy(pfb_virtual(raw_np)),
                                      torch.from_numpy(h_np), F).numpy()
        return f32_class(sums.astype(np.complex128)).sum(0)

    estimator_yard(
        "PFB P=4 (ring kernel)",
        lambda raw_np: fpf.fused_psd_pfb(
            torch.from_numpy(raw_np).to(dev), hist[0], F, F, h, hist[1],
            fresh=True).cpu().numpy(),
        lambda raw_np: golden_pfb(pfb_virtual(raw_np), F, h_np),
        pfb_class, N, F, 14200)
    counts = launch_counts(fp, ff)
    check(counts["SK"] == counts["MT"] == counts["PFB"] == 60
          and counts["SK control"] == counts["MT control"] == 0
          and counts["PFB control"] == 0 and counts["plain"] == 0,
          f"estimator yards' launches: {counts}")
    print(f"wall: estimator yards in {time.perf_counter() - t0:.1f} s")

    # The drives, each on its kernel alone.
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        N, repeats = 2048, 4000
        for key, extra, wname in (
                ("SK", ["--sk-file"], None),
                ("SK hann", ["--sk-file", "--window-function", "hann"],
                 "hann"),
                ("MT", ["--multitaper", "7"], None),
                ("PFB", ["--pfb-taps", "4"], None)):
            record = os.path.join(tmp, f"est_{len(launches)}.iq")
            sk_path = os.path.join(tmp, f"est_{len(launches)}.sk")
            argv = EST_ARGV + [f"--sk-file={sk_path}" if a == "--sk-file"
                               else a for a in extra] + ["--record", record]
            w_np = None if wname is None else make_window(wname, N)

            def golden(key=key, record=record, w_np=w_np):
                raw_np = recorded_frames(record, N)[:repeats]
                if key.startswith("SK"):
                    pwr = golden_moments(raw_np, repeats, w_np)[0]
                elif key == "MT":
                    pwr = golden_tapers(raw_np, repeats,
                                        _session_tapers(N, 4.0, 7))
                else:
                    pwr = golden_pfb(np.concatenate([np.full(
                        (3, 2 * N), 127, np.uint8), raw_np]), repeats,
                        pfb_prototype(N, 4).reshape(4, N))
                return golden_finalize_linear(np.fft.fftshift(pwr), repeats,
                                              RATE)

            # The tapers' spectral window is 2 NW = 8 bins wide: its peak
            # may fall NW bins from the tone.
            launches[key] = drive(f"estimator {key}", argv, cli, fp, ff,
                                  key.split()[0], N, golden, GOLDEN_RTOL,
                                  peak_bins=4 if key == "MT" else 1)
            if key.startswith("SK"):
                sk_file, err = sk_file_error(
                    sk_path, recorded_frames(record, N)[:repeats], repeats,
                    w_np)
                print(f"e2e estimator {key} SK file: {len(sk_file)} bins, "
                      f"'# Spectra accumulated: {repeats}', max |SK - float64 "
                      f"golden| {err:.3e} (<= 1e-4), SK at the tone "
                      f"{sk_file[int(np.argmax(np.abs(sk_file - 1.0)))]:.4g}")
                check(len(sk_file) == N and err <= 1e-4,
                      f"{key} drive: SK file")
        launches["SK excise"] = drive_sk_excise(cli, fp, ff, tmp)
        launches["PFB scan"] = drive_pfb_scan(cli, fp, ff, tmp)
    print(f"wall: estimator drives in {time.perf_counter() - t0:.1f} s")

    # Times (PERF.md states their prediction): at 2048 F=4096 and at the
    # drives' step, a call (CUDA events around each), the device's part
    # (behind a sleep kernel, twice, in turns with the control's, which
    # must be at least the kernel's / 1.05), the wrapper's
    # host part, the plain version and torch.fft.fft on the same
    # transforms (F frames; F K tapered frames; F polyphase sums, complex64
    # on the card).
    times = {}
    for kind, F, arg in (("SK", 4096, 0.0), ("SK", drive_F, 0.0),
                         ("MT", 4096, 7), ("MT", drive_F, 7),
                         ("PFB", 4096, 4), ("PFB", drive_F, 4)):
        N = 2048
        chunk = adapt_batch(F)[1]
        raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        z = torch.complex(raw[:, 0::2].float() - 127.0,
                          raw[:, 1::2].float() - 127.0)
        if kind == "SK":
            def kernel():
                return fsk.fused_psd_sk(raw, F, chunk)

            def plain():
                return fsk.fused_psd_sk_reference(raw, F, chunk)

            def control():
                return fsk.fused_psd_sk_control(raw, F, chunk)
            zz = z
            bound = estimator_bound_ms("SK", F, N)
        elif kind == "MT":
            tp = torch.from_numpy(_session_tapers(N, 4.0, arg)).to(dev)

            def kernel():
                return fmt.fused_psd_tapers(raw, F, chunk, tp)

            def plain():
                return fmt.fused_psd_tapers_reference(raw, F, chunk, tp)

            def control():
                return fmt.fused_psd_tapers_control(raw, F, chunk, tp)
            zz = (z[:, None, :] * tp[None]).reshape(F * arg, N)
            bound = estimator_bound_ms("MT", F, N, K=arg)
        else:
            h = torch.from_numpy(pfb_prototype(N, arg).reshape(arg, N)).to(
                dev)
            hist = [torch.full((arg - 1, 2 * N), 127, dtype=torch.uint8,
                               device=dev) for _ in range(2)]

            def kernel():
                return fpf.fused_psd_pfb(raw, hist[0], F, chunk, h, hist[1])

            def plain():
                return fpf.fused_psd_pfb_reference(raw, hist[0], F, chunk, h,
                                                   hist[1])

            def control():
                return fpf.fused_psd_pfb_control(raw, hist[0], F, chunk, h,
                                                 hist[1])
            zz = fpf.pfb_sums_reference(torch.cat([hist[0], raw]), h, F)
            bound = estimator_bound_ms("PFB", F, N, P=arg)
        got = kernel().double()
        want = plain().double()
        max_abs = float((got - want).abs().max())
        rel = max_rel(got.cpu().numpy(), want.cpu().numpy())
        check(rel <= UNIFORM_RTOL, f"estimator {kind} N={N} F={F}: "
              f"{rel} vs plain")
        t = {"max_abs": max_abs, "bound": bound,
             "call": event_times_us(kernel), "plain": event_times_us(plain),
             "lib": event_times_us(lambda: torch.fft.fft(zz, dim=-1)),
             "device": min(device_times_us(kernel), device_times_us(kernel)),
             "lib_device": device_times_us(lambda: torch.fft.fft(zz, dim=-1)),
             "host": host_us(kernel)}
        times[(kind, F)] = t
        b_us = 1e3 * bound[0]
        kd = [t["device"], device_times_us(kernel)]
        cd = [device_times_us(control), device_times_us(control)]
        t.update(device=min(kd), control_device=min(cd),
                 control=event_times_us(control),
                 control_host=host_us(control))
        ratio = t["device"] / t["control_device"]
        ctl_line = (f"; the control {t['control']:.1f} "
                    f"us a call, device {cd[0]:.1f}/{cd[1]:.1f} us "
                    f"(the kernel's {kd[0]:.1f}/{kd[1]:.1f}), host "
                    f"{t['control_host']:.1f} us; device/control "
                    f"{ratio:.3f} (<= 1.05)")
        check(ratio <= 1.05, f"estimator {kind} N={N} F={F}: "
              f"{t['device']:.1f} us of device time is above 1.05 of "
              f"the control's {t['control_device']:.1f} us")
        print(f"time estimator {kind} N={N} F={F}"
              f"{f' K={arg}' if kind == 'MT' else ''}"
              f"{f' P={arg}' if kind == 'PFB' else ''} on {card}: kernel "
              f"{t['call']:.1f} us a call, device {t['device']:.1f} us, host "
              f"{t['host']:.1f} us ({F * N / t['device'] / 1e3:.2f} GS/s on "
              f"the device); plain {t['plain']:.1f} us a call; torch.fft.fft "
              f"of the {tuple(zz.shape)} complex64 transforms {t['lib']:.1f} "
              f"us a call (device {t['lib_device']:.1f}), kernel/fft on the "
              f"device {t['device'] / t['lib_device']:.3f}; bound "
              f"{b_us:.2f} us ({bound[1]}), device/bound "
              f"{t['device'] / b_us:.1f}x; max abs vs plain {max_abs:.4g}, "
              f"max rel {rel:.3e} (<= {UNIFORM_RTOL:g}){ctl_line}")
    print(f"wall: estimator phase in {time.perf_counter() - t0:.1f} s")

    def entry(name, source, replaces, key, times_key, control):
        t = times[times_key]
        out = {"name": name, "route": "cuda", "source": CSRC + source,
               "replaces": replaces, "launches": launches[key],
               "max_abs_err": t["max_abs"], "ms": t["call"] / 1000.0,
               "plain_ms": t["plain"] / 1000.0, "bound_ms": t["bound"][0],
               "bound_by": t["bound"][1], "library_ms": t["lib"] / 1000.0,
               "device_ms": t["device"] / 1000.0,
               "host_ms": t["host"] / 1000.0,
               # the kernel it was redesigned from
               "control": control, "control_ms": t["control"] / 1000.0,
               "control_device_ms": t["control_device"] / 1000.0,
               "control_host_ms": t["control_host"] / 1000.0}
        return out

    return [entry("fused_psd_sk (plane)", "fused_psd_sk.cu",
                  "rtl_power_fftw_tpu/models/kurtosis.py:46", "SK",
                  ("SK", 4096), "psd_regs_kernel<.., kRegsSk>"),
            entry("fused_psd_tapers (batch)", "fused_psd_tapers.cu",
                  "rtl_power_fftw_tpu/models/multitaper.py:60", "MT",
                  ("MT", 4096), "psd_regs_kernel<.., kRegsTapers>"),
            entry("fused_psd_pfb (ring)", "fused_psd_pfb.cu",
                  "rtl_power_fftw_tpu/models/pfb.py:48", "PFB",
                  ("PFB", 4096), "psd_pfb_kernel")]


def drive_sk_excise(cli, fp, ff, tmp, N: int = 2048, key: str = "SK",
                    window: Optional[str] = None) -> int:
    """``--sk-excise 3`` through the CLI on a recorded N-bin stream (2048,
    the SK kernel's; 500, SK-M's: ``key``; with ``--window-function
    window`` where given) with a tone burst in one of
    four 256-frame blocks (as tests/test_sk_session.py:222-246 builds its
    stream): exit 0, the kernel ``key`` alone, the spectrum within 1e-5 of
    the float64 golden of the excised average (each block gated on its own
    float64 SK), the burst's bin back at the noise floor, and the
    --stats-json record. Returns the kernel's launches."""
    from rtl_power_fftw_tpu_torch.models.kurtosis import compute_sk
    F, blocks = 256, 4
    repeats = F * blocks
    rng = np.random.default_rng(41)
    iq = rng.normal(127.0, 6.0, size=2 * N * repeats)
    t = np.arange(N * F)
    burst = 40.0 * np.exp(2j * np.pi * 9 * t / N)
    lo = 2 * N * F
    iq[lo:lo + 2 * N * F:2] += burst.real
    iq[lo + 1:lo + 2 * N * F:2] += burst.imag
    raw_np = np.clip(np.round(iq), 0, 255).astype(np.uint8)
    path = os.path.join(tmp, f"rfi_{N}.iq")
    raw_np.tofile(path)
    stats = os.path.join(tmp, f"rfi_stats_{N}.jsonl")
    argv = (["-f", "100M", "-b", str(N), "-n", str(repeats), "-l",
             "--frames-per-step", str(F), "--sk-excise", "3"]
            + ([] if window is None else ["--window-function", window])
            + ["--stats-json", stats, "--source", f"file:{path}"])
    from rtl_power_fftw_tpu_torch.auxdata import make_window
    w = None if window is None else make_window(window, N)
    reset_counts(fp, ff)
    rc, out, err, wall = run_cli(argv, cli.main)
    counts = launch_counts(fp, ff)
    log(err[-800:])
    check(rc == 0, f"sk-excise drive exited {rc}")
    check("Transform path: cuda_sk " in err, "sk-excise drive off SK")
    frames_np = raw_np.reshape(-1, 2 * N)
    s1 = np.zeros(N)
    clean = np.zeros(N)
    kept = np.zeros(N)
    for b in range(blocks):
        g1, g2 = golden_moments(frames_np[b * F:(b + 1) * F], F, w)
        keep = np.abs(compute_sk(g1, g2, F) - 1.0) <= 3.0 * 2.0 / np.sqrt(F)
        s1 += g1
        clean += np.where(keep, g1, 0.0)
        kept += np.where(keep, F, 0.0)
    pwr = np.where(kept > 0, clean / np.maximum(kept, 1.0) * repeats, s1)
    gold = golden_finalize_linear(np.fft.fftshift(pwr), repeats, RATE)
    _, vals, _ = spectrum(out)
    raw_gold = golden_finalize_linear(np.fft.fftshift(s1), repeats, RATE)
    burst_bin = N // 2 + 9
    floor = np.median(raw_gold)
    err_gold = max_rel(vals, gold)
    with open(stats) as f:
        rec = json.loads(f.readline())
    summary = [x for x in err.splitlines() if x.startswith("SK excision")]
    print(f"e2e sk-excise drive ({' '.join(argv[:-4])}): exit 0 in "
          f"{wall:.2f} s wall; {summary}; stats-json kept fraction {rec['sk_kept_fraction']:.6f}, bins "
          f"fully flagged {rec['sk_bins_fully_flagged']} (float64 gate "
          f"{kept.sum() / (repeats * N):.6f}); burst bin unexcised "
          f"{raw_gold[burst_bin] / floor:.1f}x the floor, excised "
          f"{vals[burst_bin] / floor:.3f}x; max rel vs float64 golden "
          f"{err_gold:.3e} (<= {GOLDEN_RTOL:g}); launches {counts}")
    check(raw_gold[burst_bin] > 10.0 * floor
          and vals[burst_bin] < 1.26 * floor, "sk-excise drive: burst")
    check(err_gold <= GOLDEN_RTOL, "sk-excise drive vs float64 golden")
    check(abs(rec["sk_kept_fraction"] - kept.sum() / (repeats * N)) < 1e-9,
          "sk-excise drive: kept fraction")
    check_only(counts, key, f"sk-excise drive at {N} bins")
    return counts[key]


def drive_pfb_scan(cli, fp, ff, tmp) -> int:
    """The two-hop matrix-mode PFB scan through the CLI: exit 0, the PFB
    kernel alone, a .met of two 2048-bin hops, and each hop's .bin row
    within 1e-5 of the float64 golden of its own recorded frames with a
    history reset to zero at its start (the history does not cross the
    retune). Returns the kernel's launches."""
    from rtl_power_fftw_tpu_torch.models.pfb import pfb_prototype
    N, repeats, P = 2048, 100, 4
    stem = os.path.join(tmp, "pfb_scan")
    record = stem + ".iq"
    argv = PFB_SCAN_ARGV + ["-m", stem, "--record", record]
    reset_counts(fp, ff)
    rc, _, err, wall = run_cli(argv, cli.main)
    counts = launch_counts(fp, ff)
    log(err[-800:])
    check(rc == 0, f"PFB scan drive exited {rc}")
    check("Transform path: cuda_pfb " in err, "PFB scan drive off PFB")
    with open(stem + ".met") as f:
        meta = [line.split("#")[0].strip() for line in f]
    data = np.fromfile(stem + ".bin", dtype=np.float32)
    check(int(meta[0]) == 2 * N and int(meta[1]) == 1
          and data.size == 2 * N, f"PFB scan: .met {meta[:2]}, .bin "
          f"{data.size} values")
    rows = recorded_frames(record, N)
    check(len(rows) == 2 * repeats, f"PFB scan recorded {len(rows)} frames")
    h = pfb_prototype(N, P).reshape(P, N)
    errs = []
    for hop in range(2):
        virtual = np.concatenate([np.full((P - 1, 2 * N), 127, np.uint8),
                                  rows[hop * repeats:(hop + 1) * repeats]])
        gold = golden_finalize_linear(
            np.fft.fftshift(golden_pfb(virtual, repeats, h)), repeats, RATE)
        got = 10.0 ** (data[hop * N:(hop + 1) * N].astype(np.float64) / 10.0)
        errs.append(max_rel(got, gold))
    print(f"e2e PFB scan drive ({' '.join(argv[:-4])}): exit 0 in {wall:.2f} "
          f"s wall; .met {meta[0]}x{meta[1]}; max rel vs float64 golden by "
          f"hop {errs[0]:.3e}, {errs[1]:.3e} (<= {GOLDEN_RTOL:g}, the .bin's "
          f"float32 dB; each hop from a reset history); launches {counts}")
    check(max(errs) <= GOLDEN_RTOL, "PFB scan vs float64 golden")
    check_only(counts, "PFB", "PFB scan drive")
    return counts["PFB"]


# Phase 16's shape: BASELINE config 5's step (16 streams of 256 frames of
# 2048 bins) with uneven counts, 0 and F among them.
ES_N, ES_F = 2048, 256
ES_COUNTS = [256, 0, 7, 256, 1, 253, 256, 100, 256, 0, 37, 256, 2, 256, 64,
             256]
# The drives of phase 16: config 5's (16 streams, 256 frames a step, the
# tone source, linear output) with each estimator, 1024 spectra a stream,
# less their "--record <path>" and output files; and the two-hop PFB scan
# over 4 streams, less its "-m <path>" and "--record <path>".
C5_EST_ARGV = ["-f", "100M", "-n", "1024", "-b", "2048", "--streams",
               str(C5_STREAMS), "--frames-per-step", "256", "-l", "--source",
               SOURCE]
PFB_STREAMS_SCAN_ARGV = ["-f", "100M:103M", "-n", "100", "-b", "2048", "-q",
                         "--streams", "4", "--pfb-taps", "4", "--source",
                         SOURCE]


def hold_streams(label, got, want, gold, counts,
                 few_limit: float = GOLDEN_RTOL,
                 plain_factor: float = 0.0, class_rel=None) -> str:
    """A streams entry's (S, N) rows against their plain version and the
    float64 golden: a stream of at least 64 frames by max rel (<= 1e-5 of
    both), one of fewer by its largest error over its mean row value
    against the golden (<= ``few_limit``, or ``plain_factor`` times
    plain's own where that is larger, est_errors' rule; plain's printed
    beside: its smallest bins are single periodogram values near 0), or,
    where ``class_rel`` gives each stream's scipy float32 class max rel,
    by its max rel within 3x the class's (matrix_drive's FFTW-class
    budget), one of none by exact zeros."""
    rel_plain = rel_gold = few = few_plain = few_class = 0.0
    for s, c in enumerate(counts):
        if c == 0:
            check(not got[s].any() and not want[s].any(),
                  f"{label}: stream {s} of no frame is not zero")
        elif c >= 64:
            rel_plain = max(rel_plain, max_rel(got[s], want[s]))
            rel_gold = max(rel_gold, max_rel(got[s], gold[s]))
        else:
            scale = max(float(gold[s].mean()), 1e-30)
            few = max(few, float(np.abs(got[s] - gold[s]).max()) / scale)
            few_plain = max(few_plain,
                            float(np.abs(want[s] - gold[s]).max()) / scale)
            if class_rel is not None:
                few_class = max(few_class,
                                max_rel(got[s], gold[s]) / class_rel[s])
    limit = max(few_limit, plain_factor * few_plain)
    by_class = class_rel is not None and few_class <= 3.0
    check(rel_plain <= UNIFORM_RTOL and rel_gold <= GOLDEN_RTOL
          and (few <= limit or by_class), f"{label}: {rel_plain} vs plain, "
          f"{rel_gold} vs golden, {few} err/mean at few-frame streams "
          f"(limit {limit:.3g}, plain's {few_plain:.3e}"
          + (f"; max rel {few_class:.3f}x the scipy f32 class's"
             if class_rel is not None else "") + ")")
    return (f"max rel vs plain {rel_plain:.3e}, vs float64 golden "
            f"{rel_gold:.3e} (streams of >= 64 frames); err/mean vs the "
            f"golden {few:.3e} (<= {limit:.3g}; plain's {few_plain:.3e})"
            + (f", max rel {few_class:.3f}x the scipy f32 class's (<= 3)"
               if class_rel is not None else "")
            + " at 1..63 frames; zero rows exact")


def f32_class_rows(z64):
    """|scipy float32 FFT|^2 of complex128 rows, in float64."""
    import scipy.fft
    Xc = scipy.fft.fft(z64.astype(np.complex64), axis=-1, workers=-1)
    return Xc.real.astype(np.float64) ** 2 + Xc.imag.astype(np.float64) ** 2


def phase_estimator_streams(dev, rng, fp, adapt_batch, make_window, cli, ff,
                            card):
    """16. The estimators' streams entries (``fused_psd_sk_streams``,
    ``fused_psd_tapers_streams``, ``fused_psd_pfb_streams``) at config 5's
    step: against their plain versions and the float64 golden, twice each;
    each stream's rows against the single-stream kernel's on the same grid
    bit for bit; the PFB's histories over three steps and a reset; their
    60-seed yards; four CLI drives, each on its streams kernel alone; times
    beside S single-stream calls, torch.fft.fft and the bound. Returns the
    kernels-line entries."""
    from rtl_power_fftw_tpu_torch.models.kurtosis import compute_sk
    from rtl_power_fftw_tpu_torch.models.multitaper import _session_tapers
    from rtl_power_fftw_tpu_torch.models.pfb import (ShardedPfbStep,
                                                     pfb_prototype)
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_sk as fsk
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_tapers as fmt
    t0 = time.perf_counter()
    S, N, F = C5_STREAMS, ES_N, ES_F
    chunk = adapt_batch(F)[1]
    counts = np.array(ES_COUNTS, np.int32)
    nv = torch.from_numpy(counts).to(dev)
    raw_np = rng.integers(0, 256, (S, F, 2 * N), dtype=np.uint8)
    raw = torch.from_numpy(raw_np).to(dev)
    reset_counts(fp, ff)
    want_counts = {"SK": 0, "SK-S": 0, "SK-S control": 0, "K4": 0,
                   "K4 windowed": 0, "MT": 0, "MT control": 0, "MT-S": 0,
                   "MT-S control": 0, "PFB": 0, "PFB-S": 0}

    # SK-S: twice (the same bits), the control's cut (kRegsSk) the same
    # bits, s1 K4's rows, each stream the single-stream kernel's rows on
    # K4's grid, the gate the stream's own sk_keep; s1 and s2 against
    # plain and the float64 golden.
    for wname in (None, "hann"):
        w_np = None if wname is None else make_window(wname, N)
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        gold = [golden_moments(raw_np[s], int(c), w_np)
                for s, c in enumerate(counts)]
        for sigma in (0.0, 3.0):
            label = f"SK-S window={wname} gate={sigma:g}"
            got = fsk.fused_psd_sk_streams(raw, nv, chunk, w, sigma)
            again = fsk.fused_psd_sk_streams(raw, nv, chunk, w, sigma)
            ctl = fsk.fused_psd_sk_streams_control(raw, nv, chunk, w, sigma)
            k4 = fp.fused_psd_streams(raw, nv, chunk, w)
            want = fsk.fused_psd_sk_streams_reference(raw, nv, chunk, w,
                                                      sigma)
            group = fp.k1_group(S * F, chunk, fp.resident_blocks(
                N, w is not None, dev.index))
            singles = [fsk.fused_psd_sk(raw[s], int(c), chunk, w, sigma,
                                        group=group)
                       for s, c in enumerate(counts)]
            torch.cuda.synchronize()
            want_counts["SK-S"] += 2
            want_counts["SK-S control"] += 1
            want_counts["K4" if w is None else "K4 windowed"] += 1
            want_counts["SK"] += S
            check(torch.equal(got, again), f"{label}: not deterministic")
            check(torch.equal(got, ctl), f"{label}: not the control's bits")
            check(torch.equal(got[:, 0], k4), f"{label}: s1 is not K4's")
            check(all(torch.equal(got[s], singles[s]) for s in range(S)),
                  f"{label}: a stream is not the single-stream kernel's")
            g_np, w_rows = got.cpu().numpy(), want.cpu().numpy()
            # A few frames' sum of |X|^4 doubles |X|^2's relative error,
            # and a few large bins set its mean (a single frame's largest
            # p^2 is ~30x its mean at 2048 bins): its err/mean limit is
            # twice s1's.
            line = [f"moment {i + 1}: " + hold_streams(
                f"{label} s{i + 1}", g_np[:, i], w_rows[:, i],
                np.stack([g[i] for g in gold]), counts,
                (i + 1) * GOLDEN_RTOL) for i in range(2)]
            if sigma > 0.0:
                M = torch.from_numpy(counts.astype(np.float32))[:, None]
                keep = fsk.sk_keep(got[:, 0].cpu(), got[:, 1].cpu(), M,
                                   sigma).numpy()
                check(np.array_equal(g_np[:, 3], M.numpy() * keep)
                      and np.array_equal(g_np[:, 2], g_np[:, 0] * keep),
                      f"{label}: the gate is not each stream's sk_keep")
                line.append(f"gate: {int(keep.sum())} of {S * N} stream-bins "
                            f"kept, each stream's sk_keep bit for bit")
            print(f"estimator streams {label} (S={S} N={N} F={F} chunk="
                  f"{chunk} counts {ES_COUNTS}; {group} frames a block): "
                  f"the same bits twice, the control's cut's, s1 K4's, each "
                  f"stream the single-stream kernel's; " + "; ".join(line))

    # MT-S: K = 7 (the batch kernel) and K = 2 (the control's route), the
    # route and the streams control twice, each stream the single-stream
    # kernel's rows on the same grid where its taper ranges are one (or
    # its count 0 or F: the same rows), against plain and the golden.
    for K in (7, 2):
        tp_np = _session_tapers(N, 4.0, K)
        tp = torch.from_numpy(tp_np).to(dev)
        shape = fmt.batch_shape(N, K)
        got = fmt.fused_psd_tapers_streams(raw, nv, chunk, tp)
        again = fmt.fused_psd_tapers_streams(raw, nv, chunk, tp)
        ctl = fmt.fused_psd_tapers_streams_control(raw, nv, chunk, tp)
        ctl_again = fmt.fused_psd_tapers_streams_control(raw, nv, chunk, tp)
        want = fmt.fused_psd_tapers_streams_reference(raw, nv, chunk, tp)
        if shape is not None:
            grid = fmt.streams_batch_grid(
                S, F, K, N, fmt.batch_resident_blocks(N, dev.index))
            singles = [fmt.fused_psd_tapers(raw[s], int(c), chunk, tp,
                                            grid=grid)
                       for s, c in enumerate(counts)]
            want_counts["MT"] += S
            same = [-(-K // grid[1]) == 1 or c in (0, F) for c in counts]
        else:
            grid = (fmt.tapers_group(S * F, chunk, K, fp.resident_blocks(
                N, True, dev.index)), 1)
            singles = [fmt.fused_psd_tapers_control(raw[s], int(c), chunk,
                                                    tp, group=grid[0])
                       for s, c in enumerate(counts)]
            want_counts["MT control"] += S
            same = [True] * S
        ctl_grid = fmt.tapers_group(S * F, chunk, K, fp.resident_blocks(
            N, True, dev.index))
        ctl_singles = [fmt.fused_psd_tapers_control(raw[s], int(c), chunk,
                                                    tp, group=ctl_grid)
                       for s, c in enumerate(counts)]
        torch.cuda.synchronize()
        want_counts["MT-S" if shape is not None else "MT-S control"] += 2
        want_counts["MT-S control"] += 2
        want_counts["MT control"] += S
        label = f"MT-S K={K}"
        check(torch.equal(got, again) and torch.equal(ctl, ctl_again),
              f"{label}: not deterministic")
        check(all(torch.equal(got[s], singles[s])
                  for s in range(S) if same[s])
              and all(torch.equal(ctl[s], ctl_singles[s]) for s in range(S)),
              f"{label}: a stream is not the single-stream kernel's")
        gold = np.stack([golden_tapers(raw_np[s], int(c), tp_np)
                         for s, c in enumerate(counts)])
        want_np = want.cpu().numpy()
        route = hold_streams(label, got.cpu().numpy(), want_np, gold, counts)
        control = hold_streams(f"{label} control", ctl.cpu().numpy(),
                               want_np, gold, counts)
        print(f"estimator streams {label} (S={S} N={N} F={F}; the route: "
              f"{'the batch kernel' if shape else 'the control'}, grid "
              f"{grid}; the control's {ctl_grid} frames a block): the same "
              f"bits twice; {sum(same)} of {S} streams the single-stream "
              f"kernel's bits on the same grid (the rest: several taper "
              f"ranges over another block count), the control's all "
              f"{S}; the route: {route}; the control: {control}")

    # PFB-S: ShardedPfbStep (P = 4) over three steps, counts 0, fewer than
    # P - 1 and F among them, then reset() and a fourth, against the same
    # step on the CPU (plain) and each stream's single-stream kernel on the
    # same grid; the history on the card plain's and the virtual rows'.
    P = 4
    h_np = pfb_prototype(N, P).reshape(P, N)
    h = torch.from_numpy(h_np).to(dev)
    step = ShardedPfbStep([dev], N, F, S, taps=P)
    plain = ShardedPfbStep([torch.device("cpu")], N, F, S, taps=P)
    group = fpf.pfb_group(S * F, chunk, N, P, dev.index,
                          fpf.ring_shape(N, P) is not None)
    hs = [[torch.empty((P - 1, 2 * N), dtype=torch.uint8, device=dev)
           for _ in range(2)] for _ in range(S)]
    virtual = [None] * S
    schedule = [counts, np.roll(counts, 3), np.roll(counts, 7), counts]
    for k, cnt in enumerate(schedule):
        fresh = k in (0, 3)
        if k == 3:
            step.reset()
            plain.reset()
        step_raw = rng.integers(0, 256, (S, F, 2 * N), dtype=np.uint8)
        got, comb = step(torch.from_numpy(step_raw).to(dev),
                         torch.from_numpy(cnt).to(dev))
        want, want_comb = plain(step_raw, cnt)
        singles = [fpf.fused_psd_pfb(torch.from_numpy(step_raw[s]).to(dev),
                                     hs[s][0], int(c), chunk, h, hs[s][1],
                                     fresh=fresh, group=group)
                   for s, c in enumerate(cnt)]
        torch.cuda.synchronize()
        want_counts["PFB-S"] += 1
        want_counts["PFB"] += S
        gold = []
        for s, c in enumerate(cnt):
            if fresh:
                virtual[s] = np.full((P - 1, 2 * N), 127, np.uint8)
            v = np.concatenate([virtual[s], step_raw[s]])
            gold.append(golden_pfb(v, int(c), h_np))
            virtual[s] = v[int(c):int(c) + P - 1]
        hist = step._history[0].cpu().numpy()
        same_hist = (np.array_equal(hist, plain._history[0].numpy())
                     and np.array_equal(hist, np.stack(virtual)))
        same_single = all(torch.equal(got[s], singles[s])
                          and torch.equal(step._history[0][s], hs[s][1])
                          for s in range(S))
        label = f"PFB-S P={P} step {k}{' (after reset())' if k == 3 else ''}"
        check(same_hist and same_single, f"{label}: history {same_hist}, "
              f"single-stream bits {same_single}")
        check(torch.allclose(comb, got.sum(dim=0)), f"{label}: combined")
        line = hold_streams(label, got.cpu().numpy(), want.numpy(),
                            np.stack(gold), cnt)
        print(f"estimator streams {label} (S={S} N={N} F={F}, {group} frames "
              f"a block, counts {cnt.tolist()}): histories on the card "
              f"plain's and the virtual rows' bit for bit, each stream's "
              f"rows and history the single-stream kernel's; {line}")
        for s in range(S):
            hs[s].reverse()
    # The plain step above ran on the CPU (one plain call a step).
    want_counts["plain"] = len(schedule)
    counts_now = launch_counts(fp, ff)
    check(all(counts_now[k] == v for k, v in want_counts.items()),
          f"estimator streams launch counts: {counts_now}, expected "
          f"{want_counts}")
    print(f"wall: estimator streams checks in "
          f"{time.perf_counter() - t0:.1f} s")

    # The yards: 16 streams of 2048 bins (config 5's), 16 frames a stream
    # a seed (the drive's 256 cut for the float64 goldens' time), each
    # stream's rows against the float64 golden and the scipy float32 class.
    Fy = 16
    yard_nv = torch.full((S,), Fy, dtype=torch.int32, device=dev)
    z64 = lambda r: dequant64(r.reshape(S * Fy, 2 * N)).reshape(S, Fy, N)
    reset_counts(fp, ff)
    estimator_yard(
        "SK-S s2 (16 streams of 16 frames)",
        lambda r: fsk.fused_psd_sk_streams(
            torch.from_numpy(r.reshape(S, Fy, 2 * N)).to(dev), yard_nv,
            Fy)[:, 1].cpu().numpy(),
        lambda r: np.stack([golden_moments(x, Fy)[1]
                            for x in r.reshape(S, Fy, 2 * N)]),
        lambda r: (f32_class_rows(z64(r)) ** 2).sum(1), N, S * Fy, 16000)
    tp_np = _session_tapers(N, 4.0, 7)
    tp = torch.from_numpy(tp_np).to(dev)
    estimator_yard(
        "MT-S K=7 (16 streams of 16 frames)",
        lambda r: fmt.fused_psd_tapers_streams(
            torch.from_numpy(r.reshape(S, Fy, 2 * N)).to(dev), yard_nv, Fy,
            tp).cpu().numpy(),
        lambda r: np.stack([golden_tapers(x, Fy, tp_np)
                            for x in r.reshape(S, Fy, 2 * N)]),
        lambda r: f32_class_rows(z64(r)[:, :, None, :] * tp_np.astype(
            np.float64)[None, None]).mean(2).sum(1), N, S * Fy, 16100)
    hist = [torch.empty((S, P - 1, 2 * N), dtype=torch.uint8, device=dev)
            for _ in range(2)]
    warm = np.full((P - 1, 2 * N), 127, np.uint8)

    def pfb_class(r):
        rows = []
        for x in r.reshape(S, Fy, 2 * N):
            sums = fpf.pfb_sums_reference(
                torch.from_numpy(np.concatenate([warm, x])),
                torch.from_numpy(h_np), Fy).numpy()
            rows.append(f32_class_rows(sums.astype(np.complex128)).sum(0))
        return np.stack(rows)

    estimator_yard(
        "PFB-S P=4 (16 streams of 16 frames)",
        lambda r: fpf.fused_psd_pfb_streams(
            torch.from_numpy(r.reshape(S, Fy, 2 * N)).to(dev), hist[0],
            yard_nv, Fy, h, hist[1], fresh=True).cpu().numpy(),
        lambda r: np.stack([golden_pfb(np.concatenate([warm, x]), Fy, h_np)
                            for x in r.reshape(S, Fy, 2 * N)]),
        pfb_class, N, S * Fy, 16200)
    counts_now = launch_counts(fp, ff)
    check(counts_now["SK-S"] == counts_now["MT-S"] == counts_now["PFB-S"]
          == 60 and sum(counts_now.values()) == 180,
          f"estimator streams yards' launches: {counts_now}")
    print(f"wall: estimator streams yards in "
          f"{time.perf_counter() - t0:.1f} s")

    # The drives, each on its streams kernel alone.
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        repeats = 1024
        for key, extra in (("SK-S", ["--sk-file"]),
                           ("MT-S", ["--multitaper", "7"])):
            record = os.path.join(tmp, f"{key}.iq")
            sk_path = os.path.join(tmp, f"{key}.sk")
            argv = C5_EST_ARGV + [f"--sk-file={sk_path}" if a == "--sk-file"
                                  else a for a in extra] + [
                "--record", record]

            def streams_frames(record=record):
                return [recorded_frames(f"{record}.s{s}", N)[:repeats]
                        for s in range(S)]

            def golden(key=key, frames=streams_frames):
                if key == "SK-S":
                    pwr = sum(golden_moments(x, repeats)[0]
                              for x in frames())
                else:
                    pwr = sum(golden_tapers(x, repeats,
                                            _session_tapers(N, 4.0, 7))
                              for x in frames())
                return golden_finalize_linear(np.fft.fftshift(pwr),
                                              S * repeats, RATE)

            launches[key] = drive(f"streams estimator {key}", argv, cli, fp,
                                  ff, key, N, golden, GOLDEN_RTOL, streams=S,
                                  peak_bins=4 if key == "MT-S" else 1)
            if key == "SK-S":
                with open(sk_path) as f:
                    text = f.read()
                rows = [line.split() for line in text.splitlines()
                        if line and not line.startswith("#")]
                sk_file = np.array([float(v) for _, v in rows])
                moments = [golden_moments(x, repeats)
                           for x in streams_frames()]
                M = S * repeats
                sk_gold = np.fft.fftshift(compute_sk(
                    sum(m[0] for m in moments), sum(m[1] for m in moments),
                    M))
                err = float(np.abs(sk_file - sk_gold).max())
                print(f"e2e streams estimator SK-S SK file: {len(rows)} "
                      f"bins, '# Spectra accumulated: {M}' (S x repeats), "
                      f"max |SK - float64 golden| {err:.3e} (<= 1e-4)")
                check(len(rows) == N and f"# Spectra accumulated: {M}"
                      in text and err <= 1e-4, "SK-S drive: SK file")
        launches["SK-S excise"] = drive_streams_sk_excise(cli, fp, ff, tmp)
        launches["PFB-S"] = drive_streams_pfb_scan(cli, fp, ff, tmp)
    print(f"wall: estimator streams drives in "
          f"{time.perf_counter() - t0:.1f} s")

    # Times at config 5's step, every frame valid (PERF.md states the
    # prediction): a call (CUDA events, median of 60), the device time
    # and the wrapper's host part; the same work as S single-stream calls
    # of F frames; the plain version; torch.fft.fft on the same S F (F K,
    # S F polyphase sums) frames, complex64 on the card; the bound at S F
    # frames. The multitaper's control (the taper axis) in turns beside
    # its batch kernel.
    full = torch.full((S,), F, dtype=torch.int32, device=dev)
    z = torch.complex(raw[..., 0::2].float() - 127.0,
                      raw[..., 1::2].float() - 127.0).reshape(S * F, N)
    tp = torch.from_numpy(_session_tapers(N, 4.0, 7)).to(dev)
    hist = [torch.full((S, P - 1, 2 * N), 127, dtype=torch.uint8,
                       device=dev) for _ in range(2)]
    one_hist = [torch.full((P - 1, 2 * N), 127, dtype=torch.uint8,
                           device=dev) for _ in range(2)]
    entries = {
        "SK-S": (lambda: fsk.fused_psd_sk_streams(raw, full, chunk),
                 lambda: fsk.fused_psd_sk_streams_reference(raw, full,
                                                            chunk),
                 lambda: [fsk.fused_psd_sk(raw[s], F, chunk)
                          for s in range(S)],
                 z, estimator_bound_ms("SK", S * F, N)),
        "MT-S": (lambda: fmt.fused_psd_tapers_streams(raw, full, chunk, tp),
                 lambda: fmt.fused_psd_tapers_streams_reference(
                     raw, full, chunk, tp),
                 lambda: [fmt.fused_psd_tapers(raw[s], F, chunk, tp)
                          for s in range(S)],
                 (z[:, None, :] * tp[None]).reshape(S * F * 7, N),
                 estimator_bound_ms("MT", S * F, N, K=7)),
        "PFB-S": (lambda: fpf.fused_psd_pfb_streams(raw, hist[0], full,
                                                    chunk, h, hist[1]),
                  lambda: fpf.fused_psd_pfb_streams_reference(
                      raw, hist[0], full, chunk, h, hist[1]),
                  lambda: [fpf.fused_psd_pfb(raw[s], one_hist[0], F, chunk,
                                             h, one_hist[1])
                           for s in range(S)],
                  torch.cat([fpf.pfb_sums_reference(
                      torch.cat([hist[0][s], raw[s]]), h, F)
                      for s in range(S)]),
                  estimator_bound_ms("PFB", S * F, N, P=P)),
    }
    times = {}
    for key, (kernel, plain_fn, singles, zz, bound) in entries.items():
        got = kernel().double()
        want = plain_fn().double()
        max_abs = float((got - want).abs().max())
        rel = max_rel(got.cpu().numpy(), want.cpu().numpy())
        check(rel <= UNIFORM_RTOL, f"{key} timed shape: {rel} vs plain")
        t = {"max_abs": max_abs, "bound": bound,
             "call": event_times_us(kernel), "plain": event_times_us(plain_fn),
             "host": host_us(kernel),
             "singles": event_times_us(singles, iters=20, warmup=3),
             "singles_device": device_times_us(singles, calls=4),
             "lib": event_times_us(lambda: torch.fft.fft(zz, dim=-1)),
             "lib_device": device_times_us(lambda: torch.fft.fft(zz, dim=-1))}
        kd = [device_times_us(kernel)]
        line = ""
        if key == "MT-S":
            def control():
                return fmt.fused_psd_tapers_streams_control(raw, full, chunk,
                                                            tp)
            cd = [device_times_us(control)]
            kd.append(device_times_us(kernel))
            cd.append(device_times_us(control))
            t.update(control=event_times_us(control), control_device=min(cd),
                     control_host=host_us(control))
            line = (f"; the streams control (the taper axis) "
                    f"{t['control']:.1f} us a call, device {cd[0]:.1f}/"
                    f"{cd[1]:.1f} us (the batch kernel's {kd[0]:.1f}/"
                    f"{kd[1]:.1f}, in turns), host {t['control_host']:.1f} "
                    f"us; batch/control on the device "
                    f"{min(kd) / min(cd):.3f}")
        t["device"] = min(kd)
        times[key] = t
        b_us = 1e3 * bound[0]
        print(f"time estimator streams {key} S={S} N={N} F={F}"
              f"{' K=7' if key == 'MT-S' else ''}"
              f"{' P=4' if key == 'PFB-S' else ''} on {card}: a call "
              f"{t['call']:.1f} us, device {t['device']:.1f} us, host "
              f"{t['host']:.1f} us ({S * F * N / t['device'] / 1e3:.2f} GS/s "
              f"on the device); {S} single-stream calls of {F} frames "
              f"{t['singles']:.1f} us (device {t['singles_device']:.1f}), "
              f"{t['singles'] / t['call']:.2f}x a streams call; plain "
              f"{t['plain']:.1f} us; torch.fft.fft of the "
              f"{tuple(zz.shape)} complex64 transforms {t['lib']:.1f} us a "
              f"call (device {t['lib_device']:.1f}), kernel/fft on the "
              f"device {t['device'] / t['lib_device']:.3f}; bound "
              f"{b_us:.2f} us ({bound[1]}), device/bound "
              f"{t['device'] / b_us:.1f}x; max abs vs plain {max_abs:.4g}, "
              f"max rel {rel:.3e}{line}")
    print(f"wall: estimator streams phase in {time.perf_counter() - t0:.1f} s")

    def entry(name, source, replaces, key, launch_key):
        t = times[key]
        out = {"name": name, "route": "cuda", "source": CSRC + source,
               "replaces": replaces, "launches": launches[launch_key],
               "max_abs_err": t["max_abs"], "ms": t["call"] / 1000.0,
               "plain_ms": t["plain"] / 1000.0, "bound_ms": t["bound"][0],
               "bound_by": t["bound"][1], "library_ms": t["lib"] / 1000.0,
               "device_ms": t["device"] / 1000.0,
               "host_ms": t["host"] / 1000.0,
               "singles_ms": t["singles"] / 1000.0}
        if "control" in t:
            out.update(control="psd_regs_kernel<.., kRegsTapers> (streams)",
                       control_ms=t["control"] / 1000.0,
                       control_device_ms=t["control_device"] / 1000.0,
                       control_host_ms=t["control_host"] / 1000.0)
        return out

    return [entry("fused_psd_sk_streams", "fused_psd_sk.cu",
                  "rtl_power_fftw_tpu/models/kurtosis.py:205", "SK-S",
                  "SK-S"),
            entry("fused_psd_tapers_streams", "fused_psd_tapers.cu",
                  "rtl_power_fftw_tpu/models/multitaper.py:227", "MT-S",
                  "MT-S"),
            entry("fused_psd_pfb_streams", "fused_psd_pfb.cu",
                  "rtl_power_fftw_tpu/models/pfb.py:262", "PFB-S", "PFB-S")]


def drive_streams_sk_excise(cli, fp, ff, tmp, S: int = C5_STREAMS,
                            N: int = 2048, key: str = "SK-S",
                            burst_stream: int = 5) -> int:
    """``--streams 16 --sk-excise 3`` through the CLI on 16 recorded
    streams of 512 2048-bin frames (two 256-frame blocks each; ``S``
    streams of ``N`` bins on the streams form ``key``), a tone burst in
    block 1 of stream 5 (``burst_stream``) only: each stream's file comes
    from its own recording (the session's ``make_sources`` is given one
    per stream for this drive), exit 0, the SK streams kernel alone, the
    spectrum within 1e-5 of the float64 golden of the excised average
    (each stream's blocks gated on their own float64 SK) at every bin
    whose float64 SK stays 1e-3 of the limit away from it in every block,
    the burst's bin back at the noise floor, the kept fraction of
    --stats-json. Returns the kernel's launches."""
    from rtl_power_fftw_tpu_torch import session as session_mod
    from rtl_power_fftw_tpu_torch.models.kurtosis import compute_sk
    from rtl_power_fftw_tpu_torch.sources import FileSource
    F, blocks = 256, 2
    repeats = F * blocks
    rng = np.random.default_rng(43)
    base = os.path.join(tmp, f"streams_rfi_{N}.iq")
    frames = []
    for s in range(S):
        iq = rng.normal(127.0, 6.0, size=2 * N * repeats)
        if s == burst_stream:
            t = np.arange(N * F)
            burst = 40.0 * np.exp(2j * np.pi * 9 * t / N)
            iq[2 * N * F::2] += burst.real
            iq[2 * N * F + 1::2] += burst.imag
        raw_np = np.clip(np.round(iq), 0, 255).astype(np.uint8)
        raw_np.tofile(f"{base}.s{s}")
        frames.append(raw_np.reshape(-1, 2 * N))
    stats = os.path.join(tmp, f"streams_rfi_stats_{N}.jsonl")
    argv = ["-f", "100M", "-b", str(N), "-n", str(repeats), "-l",
            "--streams", str(S), "--frames-per-step", str(F), "--sk-excise",
            "3", "--stats-json", stats, "--source", f"file:{base}.s0"]
    make_sources = session_mod.make_sources
    session_mod.make_sources = lambda spec, n, rate: [
        FileSource(f"{base}.s{i + 1}", sample_rate=rate) for i in range(n)]
    try:
        reset_counts(fp, ff)
        rc, out, err, wall = run_cli(argv, cli.main)
    finally:
        session_mod.make_sources = make_sources
    counts = launch_counts(fp, ff)
    log(err[-800:])
    check(rc == 0, f"streams sk-excise drive exited {rc}")
    check("Transform path: cuda_sk " in err
          and f"Parallel streams: {S} (mesh size 1)" in err,
          f"streams sk-excise drive off {key}")
    s1 = np.zeros(N)
    clean = np.zeros(N)
    kept = np.zeros(N)
    near = np.zeros(N, bool)
    limit = 3.0 * 2.0 / np.sqrt(F)
    for s in range(S):
        for b in range(blocks):
            g1, g2 = golden_moments(frames[s][b * F:(b + 1) * F], F)
            dist = np.abs(compute_sk(g1, g2, F) - 1.0)
            keep = dist <= limit
            near |= np.abs(dist - limit) <= 1e-3 * limit
            s1 += g1
            clean += np.where(keep, g1, 0.0)
            kept += np.where(keep, F, 0.0)
    total = S * repeats
    pwr = np.where(kept > 0, clean / np.maximum(kept, 1.0) * total, s1)
    gold = golden_finalize_linear(np.fft.fftshift(pwr), total, RATE)
    raw_gold = golden_finalize_linear(np.fft.fftshift(s1), total, RATE)
    _, vals, _ = spectrum(out)
    held = ~np.fft.fftshift(near)
    err_gold = max_rel(vals[held], gold[held])
    burst_bin = N // 2 + 9
    floor = np.median(raw_gold)
    with open(stats) as f:
        rec = json.loads(f.readline())
    frac = kept.sum() / (total * N)
    summary = [x for x in err.splitlines() if x.startswith("SK excision")]
    hist = [x for x in err.splitlines()
            if x.startswith("Buffer queue histogram:")]
    print(f"e2e streams sk-excise drive ({' '.join(argv[:-5])}, a burst in "
          f"stream {burst_stream}'s block 1): exit 0 in {wall:.2f} s wall; "
          f"{summary}; stats-json kept fraction "
          f"{rec['sk_kept_fraction']:.6f} (float64 gate {frac:.6f}); burst "
          f"bin unexcised {raw_gold[burst_bin] / floor:.1f}x the floor, "
          f"excised {vals[burst_bin] / floor:.3f}x; max rel vs float64 "
          f"golden {err_gold:.3e} (<= {GOLDEN_RTOL:g}) at {int(held.sum())} "
          f"of {N} bins ({N - int(held.sum())} with a block's float64 SK "
          f"within 1e-3 of the limit); {hist[-1] if hist else ''}; launches "
          f"{counts}")
    check(raw_gold[burst_bin] > 10.0 * floor
          and vals[burst_bin] < 1.26 * floor, "streams sk-excise: burst")
    check(err_gold <= GOLDEN_RTOL, "streams sk-excise drive vs golden")
    check(abs(rec["sk_kept_fraction"] - frac)
          <= np.fft.fftshift(near).sum() * F / (total * N) + 1e-9,
          "streams sk-excise drive: kept fraction")
    check_only(counts, key, "streams sk-excise drive")
    return counts[key]


def drive_streams_pfb_scan(cli, fp, ff, tmp) -> int:
    """The two-hop matrix-mode PFB scan over 4 streams through the CLI:
    exit 0, the PFB streams kernel alone, a .met of two 2048-bin hops, and
    each hop's .bin row within 1e-5 of the float64 golden of its streams'
    recorded frames, each stream's history reset to zero at the hop's
    start. Returns the kernel's launches."""
    from rtl_power_fftw_tpu_torch.models.pfb import pfb_prototype
    S, N, repeats, P = 4, 2048, 100, 4
    stem = os.path.join(tmp, "pfb_streams_scan")
    record = stem + ".iq"
    argv = PFB_STREAMS_SCAN_ARGV + ["-m", stem, "--record", record]
    reset_counts(fp, ff)
    rc, _, err, wall = run_cli(argv, cli.main)
    counts = launch_counts(fp, ff)
    log(err[-800:])
    check(rc == 0, f"PFB streams scan drive exited {rc}")
    check("Transform path: cuda_pfb " in err
          and f"Parallel streams: {S} (mesh size 1)" in err,
          "PFB streams scan drive off PFB-S")
    with open(stem + ".met") as f:
        meta = [line.split("#")[0].strip() for line in f]
    data = np.fromfile(stem + ".bin", dtype=np.float32)
    check(int(meta[0]) == 2 * N and int(meta[1]) == 1
          and data.size == 2 * N, f"PFB streams scan: .met {meta[:2]}, .bin "
          f"{data.size} values")
    rows = [recorded_frames(f"{record}.s{s}", N) for s in range(S)]
    check(all(len(r) == 2 * repeats for r in rows),
          f"PFB streams scan recorded {[len(r) for r in rows]} frames")
    h = pfb_prototype(N, P).reshape(P, N)
    warm = np.full((P - 1, 2 * N), 127, np.uint8)
    errs = []
    for hop in range(2):
        pwr = sum(golden_pfb(np.concatenate(
            [warm, r[hop * repeats:(hop + 1) * repeats]]), repeats, h)
            for r in rows)
        gold = golden_finalize_linear(np.fft.fftshift(pwr), S * repeats, RATE)
        got = 10.0 ** (data[hop * N:(hop + 1) * N].astype(np.float64) / 10.0)
        errs.append(max_rel(got, gold))
    hist = [x for x in err.splitlines()
            if x.startswith("Buffer queue histogram:")]
    print(f"e2e PFB streams scan drive ({' '.join(argv[:-4])}): exit 0 in "
          f"{wall:.2f} s wall; .met {meta[0]}x{meta[1]}; max rel vs float64 "
          f"golden by hop {errs[0]:.3e}, {errs[1]:.3e} (<= {GOLDEN_RTOL:g}, "
          f"the .bin's float32 dB; every stream's history reset at each hop); "
          f"{hist[-1] if hist else ''}; launches {counts}")
    check(max(errs) <= GOLDEN_RTOL, "PFB streams scan vs float64 golden")
    check_only(counts, "PFB-S", "PFB streams scan drive")
    return counts["PFB-S"]


# The drives of phase 15 (the line source: a tone of amplitude 2, under
# which the float32 class stays within 1e-5 of the golden at these N).
LARGE_AWKWARD_DRIVES = [
    # (label, kernel, N, repeats, hop, window, matrix, extra argv)
    ("-b 100000", "ML", 100000, 64, 100000, None, False, []),
    ("-b 20000 hann welch", "ML windowed", 20000, 200, 10000, "hann", False,
     ["--window-function", "hann", "--welch-overlap", "50"]),
    ("-b 1000000 -m", "ML", 10 ** 6, 8, 10 ** 6, None, True, []),
    ("-b 16382 --fft-backend bluestein", "BL", 16382, 200, 16382, None,
     False, ["--fft-backend", "bluestein"]),
    ("-b 99998 -m", "BL", 99998, 16, 99998, None, True, []),
    ("-b 20002 hann", "BL windowed", 20002, 64, 20002, "hann", False,
     ["--window-function", "hann"]),
]


def phase_large_awkward(dev, rng, fp, fml, fbl, adapt_batch, make_window,
                        cli, ff, card):
    """15. The large awkward-N kernels (``fused_psd_mixed_large``, ML:
    the division-free passes; ``fused_psd_chirp_large``, BL: the register
    passes): against their plain versions and the float64 golden, twice
    each, at the phase's shapes and over a spread of N; their 60-seed tone
    yards against the scipy float32 class; their times beside their
    first forms (the controls), ``torch.fft.fft`` and the bound; each form's
    device time by pass at 10^6 F=8 (ML) and 99998 F=64 (BL); the six
    drives, each on its kernel alone. Returns the kernels-line entries."""
    t0 = time.perf_counter()
    kernels = {"ML": (fml.fused_psd_mixed_large,
                      fml.fused_psd_mixed_large_reference),
               "BL": (fbl.fused_psd_chirp_large, fbl.chirp_large_reference)}
    big = fbl.MAX_N
    cases = [  # (kernel, N, frames_per_step, n_valid or None, window)
        ("ML", 20000, 256, None, "hann"), ("ML", 49152, 128, None, None),
        ("ML", 100000, 64, None, None), ("ML", 10 ** 6, 8, None, None),
        ("ML", 100000, 64, 37, "blackman"),
        ("BL", 16382, 256, None, None), ("BL", 20002, 256, None, "hann"),
        ("BL", 99998, 64, None, None), ("BL", 499998, 8, None, None),
        ("BL", big, 4, None, None), ("BL", 99998, 64, 21, None),
    ]
    controls = {"ML": fml.fused_psd_mixed_large_control,
                "BL": fbl.fused_psd_chirp_large_control}
    passes = ("A", "A windowed", "B", "C")
    for name in ("ML", "BL"):
        mod = fml if name == "ML" else fbl
        for N in {"ML": (20000, 100000, 10 ** 6, 4167450),
                  "BL": (16382, 20002, 99998, 499998, big)}[name]:
            layout = (fml.ml_layout(N) if name == "ML"
                      else fbl.chirp_regs_layout(N))
            form = layout if name == "ML" else layout.regs
            for which in range(4 if name == "BL" else 3):
                a = mod.kernel_attributes(N, which)
                check(a["dynamic_smem"] == layout.smem[max(which - 1, 0)],
                      f"{name} N={N} pass {which}: {a['dynamic_smem']} B "
                      f"of shared memory, the layout says {layout.smem}")
                print(f"occupancy {name} N={N} pass {passes[which]} on "
                      f"{card}: {a['registers']} registers, "
                      f"{a['spill_bytes']} B spill, {a['static_smem']} + "
                      f"{a['dynamic_smem']} B shared, {a['threads']} "
                      f"threads, {a['blocks_per_sm']} blocks/SM, the grid "
                      f"aims at {mod.resident_blocks(N, which, dev.index)} "
                      f"blocks; layout {form}")
    reset_counts(fp, ff)
    max_abs = {}
    for name, N, fps, n_valid, wname in cases:
        kernel, plain = kernels[name]
        F, chunk = adapt_batch(fps)
        nv = F if n_valid is None else n_valid
        w_np = None if wname is None else make_window(wname, N)
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        got = kernel(raw, nv, chunk, w)
        again = kernel(raw, nv, chunk, w)
        want = plain(raw, nv, chunk, w)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{name} N={N}: not deterministic")
        got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
        gold = golden_partial(raw_np, nv, w_np)
        err_plain, err_gold = max_rel(got_np, want_np), max_rel(got_np, gold)
        print(f"large awkward {name} N={N} F={F} chunk={chunk} n_valid={nv} "
              f"window={wname}: max rel vs plain {err_plain:.3e}, vs "
              f"float64 golden {err_gold:.3e} (plain vs golden "
              f"{max_rel(want_np, gold):.3e})")
        check(np.all(np.isfinite(got_np)) and got_np.shape == (N,),
              f"{name} N={N}: malformed output")
        check(err_plain <= UNIFORM_RTOL, f"{name} N={N}: {err_plain} vs "
              "plain")
        check(err_gold <= GOLDEN_RTOL, f"{name} N={N}: {err_gold} vs golden")
        max_abs[(name, N, F, wname)] = float(
            np.abs(got_np.astype(np.float64) - want_np).max())
    counts = launch_counts(fp, ff)
    n_ml = sum(c[0] == "ML" for c in cases)
    check(counts["ML"] + counts["ML windowed"] == 2 * n_ml
          and counts["BL"] + counts["BL windowed"] == 2 * (len(cases) - n_ml)
          and counts["plain"] == 0,
          f"large awkward launch counts: {counts}")
    # A spread of N through each kernel (every 40th N ML takes, its
    # largest, and one N of each of ML's layouts, tile width x threads a
    # row x rows a block x class of sums, that those miss; even N through
    # BL from 8194 to its largest), 4 frames each,
    # every third with Hann, against the float64 golden on the card: within
    # 1e-5, or 3x the scipy float32 FFT's error on the same frames where
    # that is larger (a few random frames leave the deepest of millions of
    # bins far below the mean, where the float32 class itself is above
    # 1e-5 of the golden).
    ml_all = fml.eligible_sizes()
    layouts = {}
    for N in ml_all:
        t = fml.ml_layout(N)
        layouts.setdefault((t.cols, t.tf, t.lanes, t.which_b), N)
    spread = ml_all[::40] + ml_all[-1:]
    seen = {(t.cols, t.tf, t.lanes, t.which_b)
            for t in map(fml.ml_layout, spread)}
    spread += [N for key, N in layouts.items() if key not in seen]
    sweep = ([("ML", N) for N in spread]
             + [("BL", N) for N in (8194, 8196, 9998, 12286, 16386, 24574,
                                    32770, 49150, 65538, 131070, 262142,
                                    524286, 999998, big - 2, big)])
    worst = (0.0, None)
    for i, (name, N) in enumerate(sweep):
        w_np = make_window("hann", N) if i % 3 == 2 else None
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        raw_np = rng.integers(0, 256, (4, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        got = kernels[name][0](raw, 4, 4, w)
        gold = golden_partial_dev(raw, w)
        err = max_rel(got.cpu().numpy(), gold)
        budget = max(GOLDEN_RTOL,
                     3.0 * max_rel(scipy_f32_class(raw_np, w_np), gold))
        if err / budget >= worst[0]:
            worst = (err / budget, (name, N, "hann" if w_np is not None
                                    else None, err, budget))
    print(f"large awkward sweep of {len(sweep)} N ("
          f"{sum(n == 'ML' for n, _ in sweep)} ML, "
          f"{sum(n == 'BL' for n, _ in sweep)} BL), 4 frames each: worst "
          f"max rel vs float64 golden over its budget {worst[0]:.3f} at "
          f"(kernel, N, window, max rel, budget) = {worst[1]}")
    check(worst[0] <= 1.0, f"large awkward sweep: {worst}")
    print(f"wall: large awkward checks in {time.perf_counter() - t0:.1f} s")

    # The admission yards: median <= 1.5x, max <= 3x the scipy float32
    # class; a band whose yard fails is not routed.
    for name, wname, N, F, seed0 in (
            ("ML", None, 20000, 16, 9400), ("ML", "hann", 20000, 16, 9500),
            ("ML", None, 100000, 8, 9600), ("ML", None, 10 ** 6, 4, 9700),
            ("BL", None, 16382, 16, 9800), ("BL", None, 99998, 8, 9900),
            ("BL", None, big, 4, 10000)):
        device_yard(name, dev, *kernels[name], make_window, wname, N, F,
                    seed0)
    print(f"wall: large awkward yards in {time.perf_counter() - t0:.1f} s")

    # Times (PERF.md states their prediction): a call (CUDA events around
    # each), the device's part (calls queued behind a sleep kernel; the new
    # form and the control, the first form, in turns, twice each), the
    # wrapper's host part, the plain version and torch.fft.fft on the same
    # frames (complex64 on the card), the bound.
    times = {}
    for name, N, fps, n_valid, wname in cases:
        if n_valid is not None:
            continue
        kernel, plain = kernels[name]
        control = controls[name]
        F, chunk = adapt_batch(fps)
        w = (None if wname is None
             else torch.from_numpy(make_window(wname, N)).to(dev))
        raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        z = torch.complex(raw[:, 0::2].float() - 127.0,
                          raw[:, 1::2].float() - 127.0)
        t = {"call": event_times_us(lambda: kernel(raw, F, chunk, w)),
             "plain": event_times_us(lambda: plain(raw, F, chunk, w)),
             "lib": event_times_us(lambda: torch.fft.fft(z, dim=-1)),
             "devices": [], "control_devices": [],
             "lib_device": device_times_us(lambda: torch.fft.fft(z, dim=-1)),
             "host": host_us(lambda: kernel(raw, F, chunk, w)),
             "bound": awkward_bound_ms(F, N, w is not None),
             "max_abs": max_abs[(name, N, F, wname)]}
        for _ in range(2):
            t["devices"].append(device_times_us(
                lambda: kernel(raw, F, chunk, w)))
            t["control_devices"].append(device_times_us(
                lambda: control(raw, F, chunk, w)))
        t["device"] = min(t["devices"])
        t["control_device"] = min(t["control_devices"])
        times[(name, N, wname)] = t
        b_us = 1e3 * t["bound"][0]
        print(f"time large awkward {name} N={N} F={F} window={wname} on "
              f"{card}: kernel {t['call']:.1f} us a call, device "
              f"{t['devices'][0]:.1f}/{t['devices'][1]:.1f} us, host "
              f"{t['host']:.1f} us ({F * N / t['device'] / 1e3:.2f} GS/s on "
              f"the device); the control (the first form) device "
              f"{t['control_devices'][0]:.1f}/{t['control_devices'][1]:.1f} "
              f"us, kernel/control {t['device'] / t['control_device']:.3f}; "
              f"plain {t['plain']:.1f} us a call; torch.fft.fft of the "
              f"complex64 frames {t['lib']:.1f} us a call (device "
              f"{t['lib_device']:.1f}), kernel/fft on the device "
              f"{t['device'] / t['lib_device']:.3f}; bound {b_us:.2f} us "
              f"({t['bound'][1]}), device/bound {t['device'] / b_us:.1f}x; "
              f"max abs vs plain {t['max_abs']:.4g}")
    print(f"wall: large awkward times in {time.perf_counter() - t0:.1f} s")

    # Where each form's device time goes, by pass: the kernel calls alone
    # at 10^6 F=8 (ML) and 99998 F=64 (BL), under torch.profiler.
    split = {"ML": (10 ** 6, 8, ["ml_cols_kernel", "ml_rows_kernel"],
                    ["tile_cols_kernel", "tile_power_kernel"]),
             "BL": (99998, 64, ["chirp_regs_a", "chirp_regs_b",
                                "chirp_regs_c"],
                    ["tile_cols_kernel", "chirp_turn_kernel",
                     "tile_power_kernel"])}
    for name, (N, fps, new_passes, control_passes) in split.items():
        F, chunk = adapt_batch(fps)
        raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        sums = ["psd_rows_sum", "psd_sum_kernel"]
        profile_calls(f"{name} N={N} F={F} by pass on {card}",
                      lambda: kernels[name][0](raw, F, chunk),
                      new_passes + sums, whole=new_passes, tries=4)
        profile_calls(f"{name} control N={N} F={F} by pass on {card}",
                      lambda: controls[name](raw, F, chunk),
                      control_passes + sums, whole=control_passes, tries=4)
    print(f"wall: large awkward splits in {time.perf_counter() - t0:.1f} s")

    # The drives, each on its kernel alone; then where the two matrix
    # drives' device time goes, by pass (torch.profiler).
    launches, profiled = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, key, N, repeats, hop, wname, matrix, extra in \
                LARGE_AWKWARD_DRIVES:
            record = os.path.join(tmp, f"drive_{N}.iq")
            stem = os.path.join(tmp, f"drive_{N}")
            argv = (["-f", "100M", "-n", str(repeats), "-b", str(N), "-l"]
                    + extra + (["-q", "-m", stem] if matrix else [])
                    + ["--record", record, "--source", LINE_SOURCE])
            w = None if wname is None else make_window(wname, N)
            if matrix:
                n = matrix_drive(label, argv, cli, fp, ff, key, N, repeats,
                                 record, stem, w)
                profiled[key] = (label, argv)
            else:
                n = drive(label, argv, cli, fp, ff, key, N,
                          lambda record=record, N=N, repeats=repeats,
                          hop=hop, w=w: recorded_golden(record, N, repeats,
                                                        hop, w),
                          GOLDEN_RTOL)
            launches[key] = launches.get(key, 0) + n
        for key, passes in (("ML", ["ml_cols_kernel", "ml_rows_kernel"]),
                            ("BL", ["chirp_regs_a", "chirp_regs_b",
                                    "chirp_regs_c"])):
            label, argv = profiled[key]
            profile_drive(label, argv, cli,
                          passes + ["psd_rows_sum", "psd_sum_kernel",
                                    "Memcpy HtoD", "Memcpy DtoH"])
    print(f"wall: large awkward phase in {time.perf_counter() - t0:.1f} s")

    def entry(name, source, replaces, key, times_key):
        t = times[times_key]
        return {"name": name, "route": "cuda", "source": CSRC + source,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": t["max_abs"], "ms": t["call"] / 1000.0,
                "plain_ms": t["plain"] / 1000.0, "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": t["lib"] / 1000.0,
                "device_ms": t["device"] / 1000.0,
                "control_device_ms": t["control_device"] / 1000.0,
                "host_ms": t["host"] / 1000.0}

    xla_ladder = "rtl_power_fftw_tpu/ops/spectral.py:388"
    chirp_z = "rtl_power_fftw_tpu/ops/dft.py:1069"
    return [entry("fused_psd_mixed_large", "fused_psd_mixed_large.cu",
                  xla_ladder, "ML", ("ML", 10 ** 6, None)),
            entry("fused_psd_mixed_large (windowed)",
                  "fused_psd_mixed_large.cu", xla_ladder, "ML windowed",
                  ("ML", 20000, "hann")),
            entry("fused_psd_chirp_large", "fused_psd_chirp_large.cu",
                  chirp_z, "BL", ("BL", 99998, None)),
            entry("fused_psd_chirp_large (windowed)",
                  "fused_psd_chirp_large.cu", chirp_z, "BL windowed",
                  ("BL", 20002, "hann"))]


# Phase 17's drives over --streams (the line source), less their
# "--record <path>": BASELINE config 3's bins over four receivers (L-S, the
# full-width drive), and -b 100000 (ML-S), -b 99998 with Hann (BL-S) and
# -b 32768 with Hann (L-S windowed) over two.
LARGE_STREAMS_DRIVES = [
    # (label, kernel, N, streams, repeats, window, argv less --record)
    ("config 3 over 4 streams", "L-S", C3_N, 4,
     math.ceil(RATE * C3_SECONDS / C3_N), None,
     ["-f", "100M", "-b", str(C3_N), "-t", str(C3_SECONDS), "-l",
      "--streams", "4", "--source", LINE_SOURCE]),
    ("-b 100000 over 2 streams", "ML-S", 100000, 2, 64, None,
     ["-f", "100M", "-n", "64", "-b", "100000", "-l", "--streams", "2",
      "--source", LINE_SOURCE]),
    ("-b 99998 hann over 2 streams", "BL-S windowed", 99998, 2, 64, "hann",
     ["-f", "100M", "-n", "64", "-b", "99998", "--window-function", "hann",
      "-l", "--streams", "2", "--source", LINE_SOURCE]),
    ("-b 32768 hann over 2 streams", "L-S windowed", 32768, 2, 128, "hann",
     ["-f", "100M", "-n", "128", "-b", "32768", "--window-function", "hann",
      "-l", "--streams", "2", "--source", LINE_SOURCE]),
]


def hold_rows_by_mean(label, got, want, gold, cls, counts) -> str:
    """A streams entry's (S, N) rows against their plain version and the
    float64 golden by their largest error over the stream's mean golden
    value (a stream of few frames has single periodogram values near 0,
    where a relative error means nothing): each within 1e-5, or 3x the
    scipy float32 FFT's distance from the golden on the same frames
    (``cls``) where that is larger; plain's distance printed beside; a
    stream of no frame by exact zeros."""
    e_plain = e_gold = e_ref = e_cls = 0.0
    for s, c in enumerate(counts):
        if c == 0:
            check(not got[s].any() and not want[s].any(),
                  f"{label}: stream {s} of no frame is not zero")
            continue
        scale = max(float(gold[s].mean()), 1e-30)
        e_plain = max(e_plain, float(np.abs(got[s] - want[s]).max()) / scale)
        e_gold = max(e_gold, float(np.abs(got[s] - gold[s]).max()) / scale)
        e_ref = max(e_ref, float(np.abs(want[s] - gold[s]).max()) / scale)
        e_cls = max(e_cls, float(np.abs(cls[s] - gold[s]).max()) / scale)
    budget = max(GOLDEN_RTOL, 3.0 * e_cls)
    check(e_plain <= budget and e_gold <= budget,
          f"{label}: err/mean {e_plain} vs plain, {e_gold} vs golden "
          f"(budget {budget})")
    return (f"err/mean vs plain {e_plain:.3e}, vs float64 golden "
            f"{e_gold:.3e} (<= {budget:.3g}; plain vs golden {e_ref:.3e}, "
            f"scipy float32 {e_cls:.3e}); zero rows exact")


def phase_large_streams(dev, rng, fp, fl, fml, fbl, adapt_batch,
                        make_window, cli, ff, card):
    """17. The streams entries of the large kernel (L-S), ML (ML-S) and BL
    (BL-S): each pass's registers, spill and blocks per SM; at S = 4 with
    counts (0, 1, F - 1, F), windowed and not, against their plain
    versions and the float64 golden, twice each, and each stream's row
    against the one-stream kernel on the same frames, count and groups,
    bit for bit; the frame-sharded long integration at 2^20 (S = 1)
    against the one-stream kernel, bit for bit; their 60-seed yards; times
    beside S one-stream calls, the plain version, torch.fft.fft on the S F
    frames and the bound; four CLI drives, each on its streams kernel
    alone. Returns the kernels-line entries."""
    from rtl_power_fftw_tpu_torch.parallel import sharded_accumulate
    t0 = time.perf_counter()
    S = 4
    entries = {  # name: (streams entry, plain, one stream on given groups)
        "L-S": (fl.fused_psd_large_streams,
                fl.fused_psd_large_streams_reference,
                lambda raw, c, chunk, w, g: fl.fused_psd_large(
                    raw, c, chunk, w, group_b=g[1]), fl._streams_grids),
        "ML-S": (fml.fused_psd_mixed_large_streams,
                 fml.fused_psd_mixed_large_streams_reference,
                 lambda raw, c, chunk, w, g: fml.fused_psd_mixed_large(
                     raw, c, chunk, w, group_b=g[1]), fml._streams_grids),
        "BL-S": (fbl.fused_psd_chirp_large_streams,
                 fbl.chirp_large_streams_reference,
                 lambda raw, c, chunk, w, g: fbl.fused_psd_chirp_large(
                     raw, c, chunk, w, group_c=g[2]), fbl._streams_grids),
    }
    cases = [("L-S", 32768, 16), ("L-S", 32768, 64), ("L-S", C3_N, 8),
             ("ML-S", 20000, 16), ("ML-S", 100000, 64),
             ("BL-S", 16382, 16), ("BL-S", 99998, 64)]
    reset_counts(fp, ff)
    singles_n = {"L": 0, "ML": 0, "BL": 0}
    for name, N, F in cases:
        kernel, plain, single, grids = entries[name]
        chunk = adapt_batch(F)[1]
        counts = [0, 1, F - 1, F]
        nv = torch.tensor(counts, dtype=torch.int32, device=dev)
        raw = torch.from_numpy(rng.integers(0, 256, (S, F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        for wname in (None, "hann"):
            w_np = None if wname is None else make_window(wname, N)
            w = None if w_np is None else torch.from_numpy(w_np).to(dev)
            label = f"{name} N={N} F={F} window={wname}"
            got = kernel(raw, nv, chunk, w)
            again = kernel(raw, nv, chunk, w)
            want = plain(raw, nv, chunk, w)
            grid = grids[(N, S, F, w is not None, dev.index)]
            ones = torch.stack([single(raw[s], c, chunk, w, grid)
                                for s, c in enumerate(counts)])
            singles_n[name[:-2]] += S
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"{label}: not deterministic")
            check(torch.equal(got, ones), f"{label}: a stream's row is not "
                  "the one-stream kernel's on the same groups")
            g_np = got.cpu().numpy()
            check(g_np.shape == (S, N) and np.all(np.isfinite(g_np)),
                  f"{label}: malformed output")
            gold = np.stack([golden_partial_dev(raw[s, :c], w) if c else
                             np.zeros(N) for s, c in enumerate(counts)])
            cls = np.stack([scipy_f32_class(raw[s, :c].cpu().numpy(), w_np)
                            if c else np.zeros(N)
                            for s, c in enumerate(counts)])
            line = hold_rows_by_mean(label, g_np, want.cpu().numpy(), gold,
                                     cls, counts)
            print(f"large streams {label} S={S} chunk={chunk} counts "
                  f"{counts}, groups {grid} (frames a block of each pass, "
                  f"partial rows a stream): the same bits twice, each "
                  f"stream the one-stream kernel's on those groups; {line}")
    counts_now = launch_counts(fp, ff)
    n = {k: 2 * 2 * sum(c[0] == k for c in cases)
         for k in ("L-S", "ML-S", "BL-S")}
    check(all(counts_now[k] + counts_now[k + " windowed"] == n[k]
              for k in n)
          and counts_now["L"] + counts_now["L windowed"] == singles_n["L"]
          and counts_now["ML"] + counts_now["ML windowed"] == singles_n["ML"]
          and counts_now["BL"] + counts_now["BL windowed"] == singles_n["BL"]
          and counts_now["plain"] == 0,
          f"large streams launch counts: {counts_now}")

    # The frame-sharded long integration on the one card (S = 1): the
    # large kernel's streams entry, the one-stream kernel's bits.
    M = 8
    frames = rng.integers(0, 256, (M, 2 * C3_N), dtype=np.uint8)
    reset_counts(fp, ff)
    pwr, m = sharded_accumulate(frames, C3_N, devices=[dev])
    counts_now = launch_counts(fp, ff)
    one = fl.fused_psd_large(torch.from_numpy(frames).to(dev), M,
                             adapt_batch(M)[1]).cpu().numpy()
    check(m == M and counts_now["L-S"] == 1 and sum(counts_now.values()) == 1
          and np.array_equal(pwr, one.astype(np.float64)),
          f"sharded_accumulate at 2^20: launches {counts_now}, not the "
          "one-stream kernel's bits")
    print(f"large streams longint sharded_accumulate N={C3_N} M={M} on one "
          f"device: L-S at S = 1 ({counts_now['L-S']} launch), "
          f"fused_psd_large's bits")
    print(f"wall: large streams checks in {time.perf_counter() - t0:.1f} s")

    # The admission yards: S streams of 16 frames of each seed's tone, the
    # rows' sum (the step's combined output) against the golden of the
    # S 16 frames.
    for name, wname, N, seed0 in (("L-S", "hann", 65536, 17000),
                                  ("ML-S", None, 20000, 17100),
                                  ("BL-S", None, 16382, 17200)):
        kernel = entries[name][0]
        single_plain = {"L-S": fl.fused_psd_large_reference,
                        "ML-S": fml.fused_psd_mixed_large_reference,
                        "BL-S": fbl.chirp_large_reference}[name]
        full = torch.full((S,), 16, dtype=torch.int32, device=dev)
        device_yard(f"{name} (S={S} streams of 16 frames)", dev,
                    lambda raw, n_valid, chunk, w, kernel=kernel, full=full:
                    kernel(raw.reshape(S, 16, -1), full, 16, w).sum(0),
                    single_plain, make_window, wname, N, S * 16, seed0)
    print(f"wall: large streams yards in {time.perf_counter() - t0:.1f} s")

    # Times at S = 4, every frame valid (PERF.md states the prediction):
    # a call (CUDA events, median of 60), the device time and the
    # wrapper's host part; the same work as S one-stream calls; the plain
    # version; torch.fft.fft on the S F frames, complex64 on the card; the
    # bound at S F frames and S output rows.
    singles = {"L-S": fl.fused_psd_large, "ML-S": fml.fused_psd_mixed_large,
               "BL-S": fbl.fused_psd_chirp_large}
    times = {}
    for name, N, F, wname in (("L-S", C3_N, 8, None),
                              ("L-S", 65536, 16, "hann"),
                              ("ML-S", 10 ** 6, 8, None),
                              ("ML-S", 100000, 64, None),
                              ("BL-S", 99998, 64, None),
                              ("BL-S", 99998, 64, "hann")):
        kernel, plain = entries[name][:2]
        w = (None if wname is None
             else torch.from_numpy(make_window(wname, N)).to(dev))
        raw = torch.from_numpy(rng.integers(0, 256, (S, F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        full = torch.full((S,), F, dtype=torch.int32, device=dev)
        chunk = adapt_batch(F)[1]
        z = torch.complex(raw[..., 0::2].float() - 127.0,
                          raw[..., 1::2].float() - 127.0).reshape(S * F, N)
        got = kernel(raw, full, chunk, w).double()
        want = plain(raw, full, chunk, w).double()
        rel = max_rel(got.cpu().numpy(), want.cpu().numpy())
        check(rel <= UNIFORM_RTOL, f"{name} N={N} timed shape: {rel} vs "
              "plain")
        bound = (bound_ms("L", S * F, N, w is not None, out_rows=S)
                 if name == "L-S"
                 else awkward_bound_ms(S * F, N, w is not None, out_rows=S))

        def call():
            return kernel(raw, full, chunk, w)

        def ones():
            return [singles[name](raw[s], F, chunk, w) for s in range(S)]

        t = {"max_abs": float((got - want).abs().max()), "bound": bound,
             "call": event_times_us(call),
             "plain": event_times_us(lambda: plain(raw, full, chunk, w),
                                     iters=10, warmup=2),
             "host": host_us(call),
             "singles": event_times_us(ones, iters=20, warmup=3),
             "lib": event_times_us(lambda: torch.fft.fft(z, dim=-1)),
             "lib_device": device_times_us(lambda: torch.fft.fft(z, dim=-1))}
        kd, sd = [], []
        for _ in range(2):   # in turns
            kd.append(device_times_us(call))
            sd.append(device_times_us(ones, calls=5))
        t.update(device=min(kd), singles_device=min(sd))
        times[(name, N, wname)] = t
        b_us = 1e3 * bound[0]
        print(f"time large streams {name} S={S} N={N} F={F} window={wname} "
              f"on {card}: a call {t['call']:.1f} us, device "
              f"{kd[0]:.1f}/{kd[1]:.1f} us, host {t['host']:.1f} us "
              f"({S * F * N / t['device'] / 1e3:.2f} GS/s on the device); "
              f"{S} one-stream calls of {F} frames {t['singles']:.1f} us "
              f"(device {sd[0]:.1f}/{sd[1]:.1f}), streams/one-stream on the "
              f"device {t['device'] / t['singles_device']:.3f}; plain "
              f"{t['plain']:.1f} us; torch.fft.fft of the {S * F} complex64 "
              f"frames {t['lib']:.1f} us a call (device "
              f"{t['lib_device']:.1f}), kernel/fft on the device "
              f"{t['device'] / t['lib_device']:.3f}; bound {b_us:.2f} us "
              f"({bound[1]}), device/bound {t['device'] / b_us:.1f}x; max "
              f"abs vs plain {t['max_abs']:.4g}, max rel {rel:.3e}")
    print(f"wall: large streams times in {time.perf_counter() - t0:.1f} s")

    # The drives, each on its streams kernel alone: the combined spectrum
    # is the mean of the per-stream linear goldens of the recorded
    # streams.
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, key, N, streams, repeats, wname, argv in \
                LARGE_STREAMS_DRIVES:
            record = os.path.join(tmp, f"streams_{N}.iq")
            w = None if wname is None else make_window(wname, N)

            def golden(record=record, N=N, streams=streams, repeats=repeats,
                       w=w):
                return sum(recorded_golden(f"{record}.s{s}", N, repeats, N,
                                           w)
                           for s in range(streams)) / streams

            launches[key] = drive(f"large streams {label}",
                                  argv + ["--record", record], cli, fp, ff,
                                  key, N, golden, GOLDEN_RTOL,
                                  streams=streams)
    print(f"wall: large streams phase in {time.perf_counter() - t0:.1f} s")

    def entry(name, source, replaces, key, times_key):
        t = times[times_key]
        return {"name": name, "route": "cuda", "source": CSRC + source,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": t["max_abs"], "ms": t["call"] / 1000.0,
                "plain_ms": t["plain"] / 1000.0, "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": t["lib"] / 1000.0,
                "device_ms": t["device"] / 1000.0,
                "host_ms": t["host"] / 1000.0,
                "singles_ms": t["singles"] / 1000.0,
                "singles_device_ms": t["singles_device"] / 1000.0}

    xla_ladder = "rtl_power_fftw_tpu/ops/spectral.py:388"
    chirp_z = "rtl_power_fftw_tpu/ops/dft.py:1069"
    return [entry("fused_psd_large_streams", "fused_psd_large.cu",
                  TPU_KERNEL + "435", "L-S", ("L-S", C3_N, None)),
            entry("fused_psd_large_streams (windowed)", "fused_psd_large.cu",
                  TPU_KERNEL + "435", "L-S windowed",
                  ("L-S", 65536, "hann")),
            entry("fused_psd_mixed_large_streams",
                  "fused_psd_mixed_large.cu", xla_ladder, "ML-S",
                  ("ML-S", 10 ** 6, None)),
            entry("fused_psd_chirp_large_streams (windowed)",
                  "fused_psd_chirp_large.cu", chirp_z, "BL-S windowed",
                  ("BL-S", 99998, "hann"))]


# Phase 18's library drives: an RTL-SDR's line rate (2.048 MS/s) from the
# synthetic tone source, N = 2048 bins (channels).
LIB_RATE = 2_048_000
LIB_N = 2048
LIB_TONE = "tone=100.2M/35,noise=6"


def synthetic_bytes(spec: str, seconds: float) -> np.ndarray:
    """``seconds`` of the synthetic source ``spec`` (no "synthetic:"),
    tuned to 100 MHz at LIB_RATE: interleaved u8 IQ."""
    from rtl_power_fftw_tpu_torch.sources.synthetic import \
        parse_synthetic_spec
    src = parse_synthetic_spec(spec)
    src.set_sample_rate(LIB_RATE)
    src.set_frequency(100_000_000)
    buf, _ = src.read(2 * int(LIB_RATE * seconds))
    return buf


def spectra64(raw, window=None):
    """float64 DFT of every (u8 - 127)[x window] frame of (F, 2N) bytes."""
    z = dequant64(raw)
    if window is not None:
        z = z * np.asarray(window, np.float64)
    return np.fft.fft(z, axis=1)


def fft_class(z):
    """The scipy float32 FFT of the rows of ``z``, in float64."""
    import scipy.fft
    return scipy.fft.fft(z.astype(np.complex64), axis=1).astype(
        np.complex128)


def spectra_class(raw, window=None):
    """The scipy float32 FFT of the same (windowed) frames, in float64."""
    z = dequant64(raw)
    if window is not None:
        z = z * np.asarray(window, np.float64)
    return fft_class(z)


def csd64(X, Y):
    """The four sums of the cross-spectral step, float64: sum |X|^2, sum
    |Y|^2, sum Re(X conj Y), sum Im(X conj Y)."""
    c = (X * np.conj(Y)).sum(0)
    return np.stack([(np.abs(X) ** 2).sum(0), (np.abs(Y) ** 2).sum(0),
                     c.real, c.imag])


def scf64(X, k0, K):
    """(2, K, N) float64 sums of roll(X, -k) conj(X) over frames."""
    s = np.stack([(np.roll(X, -k, axis=1) * np.conj(X)).sum(0)
                  for k in range(k0, k0 + K)])
    return np.stack([s.real, s.imag])


def csd_scale(sums):
    """The cross-spectral planes' scale: the geometric mean of the two
    streams' mean power."""
    return max(float(np.sqrt(sums[0].mean() * sums[1].mean())), 1e-30)


def yard_by_scale(label, kernel_fn, golden_fn, class_fn, metric, N, F,
                  seed0) -> None:
    """A tone yard with its own error measure: 60 seeds of 35 dB tones
    (tone_frames, F + extra rows as each function takes them), the
    kernel's and the scipy float32 class's ``metric(got, golden)``:
    median <= 1.5x and max <= 3x the class's, per-seed p99 printed."""
    def errors(seed, got):
        gold = golden_fn(seed)
        return metric(got, gold), metric(class_fn(seed), gold)

    seeds = [host_pool().submit(errors, seed0 + seed,
                                kernel_fn(seed0 + seed))
             for seed in range(60)]
    ours, cls = zip(*(f.result() for f in seeds))
    e, c = np.asarray(ours), np.asarray(cls)
    r = e / c
    med_r, max_r = np.median(e) / np.median(c), e.max() / c.max()
    print(f"{label} yard N={N} F={F}, 60 seeds of 35 dB tones: error "
          f"median {np.median(e):.3e} / max {e.max():.3e}; scipy f32 "
          f"{np.median(c):.3e} / {c.max():.3e}; ratio median {med_r:.2f}x "
          f"(<= 1.5), max {max_r:.2f}x (<= 3), per-seed p99 "
          f"{np.quantile(r, 0.99):.2f}x, per-seed max {r.max():.2f}x")
    check(med_r <= 1.5 and max_r <= 3.0,
          f"{label} yard N={N}: above the FFTW-class budget")


def library_bound_ms(kind: str, F: int, N: int, windowed: bool = False,
                     K: int = 1, P: int = 1, complex_out: bool = False):
    """rate_bound_ms of a library kernel's call from k1_work's count (the
    split-radix transform; bytes read and written once): FR F frames in,
    F rows of |X|^2 (4N B) or X (8N B) out; PFB-C (F + P - 1) rows and the
    (P, N) prototype in, F rows of X out, 4 P N more FP32 a frame; CSD two
    streams' frames in, four rows out, two transforms and 8N a frame for
    the cross products; SCF the (F, N) complex64 X in, (2, K, N) out, 8 K
    N FP32 a frame."""
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    _, _, fp32 = fpp.k1_work(F, N, windowed=windowed)
    win = 4 * N if windowed else 0
    if kind == "FR":
        return rate_bound_ms(F * 2 * N + F * N * (8 if complex_out else 4)
                             + win, 0.0, fp32)
    if kind == "PFB-C":
        return rate_bound_ms((F + P - 1) * 2 * N + 4 * P * N + 8 * F * N,
                             0.0, fp32 + F * 4 * P * N)
    if kind == "CSD":
        return rate_bound_ms(2 * F * 2 * N + 16 * N + win, 0.0,
                             2 * fp32 + F * 8 * N)
    return rate_bound_ms(F * N * 8 + 2 * K * N * 4, 0.0, 8.0 * K * N * F)


def phase_library_estimators(dev, rng, fp, adapt_batch, make_window, ff,
                             card):
    """18. The library estimators' kernels: FR (``fused_psd_frames``, both
    stores), PFB-C (``fused_psd_pfb.pfb_channelize``), CSD
    (``fused_psd_csd``) and SCF (``fused_psd_scf``): registers, spill and
    blocks per SM; each against its plain version and the float64 golden,
    twice (the same bits), at N = 64, 2048 and 16384, unwindowed and Hann,
    n_valid 0, 1, F - 1 and F; FR's |X|^2 rows summed in the tree order
    against K1's output, PFB-C's |X|^2 summed against the PFB kernel's on
    the same rows; 60-seed tone yards at N = 2048, F = 64; the four
    library functions at full width through their kernels alone; times.
    Returns the kernels line's entries."""
    from rtl_power_fftw_tpu_torch import models
    from rtl_power_fftw_tpu_torch.models.pfb import pfb_prototype
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_csd as fcsd
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_frames as ffr
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_scf as fscf
    t0 = time.perf_counter()
    for N in (64, 2048, 16384):
        for label, a in (
                [(f"FR {o} {'windowed' if w else 'unwindowed'}",
                  ffr.kernel_attributes(N, w, o == "complex"))
                 for o in ffr.MODES for w in (False, True)]
                + [(f"CSD {'windowed' if w else 'unwindowed'}",
                    fcsd.kernel_attributes(N, w)) for w in (False, True)]
                + [("PFB-C P=4 ("
                    + ("ring" if fpf.ring_shape(N, 4) else "control's load")
                    + ")", fpf.channelize_attributes(N, 4))]):
            print(f"occupancy library {label} N={N} on {card}: "
                  f"{a['registers']} registers, {a['spill_bytes']} B spill, "
                  f"{a['static_smem']} + {a['dynamic_smem']} B shared, "
                  f"{a['threads']} threads, {a['blocks_per_sm']} blocks/SM")
    a = fscf.kernel_attributes()
    print(f"occupancy library SCF on {card}: {a['registers']} registers, "
          f"{a['spill_bytes']} B spill, {a['static_smem']} B shared, "
          f"{a['threads']} threads, {a['blocks_per_sm']} blocks/SM")

    # Each kernel against its plain version and the float64 golden.
    for N in (64, 2048, 16384):
        F = 64 if N == 16384 else 256
        chunk = adapt_batch(F)[1]
        for wname in (None, "hann"):
            w_np = None if wname is None else make_window(wname, N)
            w = None if w_np is None else torch.from_numpy(w_np).to(dev)
            raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
            rawy_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
            raw = torch.from_numpy(raw_np).to(dev)
            rawy = torch.from_numpy(rawy_np).to(dev)
            X64 = spectra64(raw_np, w_np)
            Y64 = spectra64(rawy_np, w_np)
            for nv in (0, 1, F - 1, F):
                tag = f"N={N} F={F} window={wname} n_valid={nv}"
                # FR, both stores.
                for out in ffr.MODES:
                    got = ffr.fused_psd_frames(raw, nv, w, out)[:nv]
                    again = ffr.fused_psd_frames(raw, nv, w, out)[:nv]
                    want = ffr.fused_psd_frames_reference(raw, nv, w,
                                                          out)[:nv]
                    torch.cuda.synchronize()
                    check(torch.equal(got, again),
                          f"FR {out} {tag}: not deterministic")
                    if nv == 0:
                        continue
                    if out == "complex":
                        g_np = got.cpu().numpy().astype(np.complex128)
                        p_np = want.cpu().numpy().astype(np.complex128)
                        gold = X64[:nv]
                    else:
                        g_np = got.cpu().numpy().astype(np.float64)
                        p_np = want.cpu().numpy().astype(np.float64)
                        gold = np.fft.fftshift(np.abs(X64[:nv]) ** 2, axes=1)
                    scale = float(np.abs(gold).mean())
                    e_plain = float(np.abs(g_np - p_np).max()) / scale
                    e_gold = float(np.abs(g_np - gold).max()) / scale
                    e_ref = float(np.abs(p_np - gold).max()) / scale
                    budget = max(GOLDEN_RTOL, 3.0 * e_ref)
                    print(f"library FR {out} {tag}: err/mean vs plain "
                          f"{e_plain:.3e}, vs float64 golden {e_gold:.3e} "
                          f"(<= {budget:.3g}; plain vs golden {e_ref:.3e})")
                    check(e_plain <= UNIFORM_RTOL and e_gold <= budget,
                          f"FR {out} {tag}: {e_plain} vs plain, {e_gold} "
                          "vs golden")
                    if out == "power_shifted":
                        # FR's rows summed in the tree order: K1's (K2's)
                        # output.
                        rows = torch.zeros((F, N), device=dev)
                        rows[:nv] = torch.fft.ifftshift(got, dim=-1)
                        tree = rows.reshape(F // chunk, chunk, N).sum(1).sum(0)
                        k1 = fp.fused_psd(raw, nv, chunk, w)
                        e_k1 = float((tree - k1).abs().max()
                                     / k1.abs().mean())
                        print(f"library FR rows summed vs K1 {tag}: err/mean "
                              f"{e_k1:.3e} (<= {UNIFORM_RTOL:g})")
                        check(e_k1 <= UNIFORM_RTOL, f"FR {tag} vs K1: {e_k1}")
                # CSD.
                got = fcsd.fused_psd_csd(raw, rawy, nv, chunk, w)
                again = fcsd.fused_psd_csd(raw, rawy, nv, chunk, w)
                want = fcsd.fused_psd_csd_reference(raw, rawy, nv, chunk, w)
                torch.cuda.synchronize()
                check(torch.equal(got, again), f"CSD {tag}: not "
                      "deterministic")
                if nv == 0:
                    check(not got.any(), f"CSD {tag}: no frame, not zero")
                else:
                    gold = csd64(X64[:nv], Y64[:nv])
                    scale = csd_scale(gold)
                    g_np = got.cpu().numpy().astype(np.float64)
                    p_np = want.cpu().numpy().astype(np.float64)
                    e_plain = float(np.abs(g_np - p_np).max()) / scale
                    e_gold = float(np.abs(g_np - gold).max()) / scale
                    e_ref = float(np.abs(p_np - gold).max()) / scale
                    budget = max(GOLDEN_RTOL, 3.0 * e_ref)
                    print(f"library CSD {tag}: err over the streams' power "
                          f"vs plain {e_plain:.3e}, vs float64 golden "
                          f"{e_gold:.3e} (<= {budget:.3g}; plain vs golden "
                          f"{e_ref:.3e})")
                    check(e_plain <= UNIFORM_RTOL and e_gold <= budget,
                          f"CSD {tag}: {e_plain} vs plain, {e_gold} vs "
                          "golden")
                # SCF on FR's X of the same frames.
                if wname is not None:
                    continue
                X = ffr.fused_psd_frames(raw, nv, None, "complex")
                for k0, K in ((0, 5), (3, 40)):
                    if K == 40 and nv != F:
                        continue
                    got = fscf.fused_psd_scf(X, nv, chunk, k0, K)
                    again = fscf.fused_psd_scf(X, nv, chunk, k0, K)
                    want = fscf.fused_psd_scf_reference(X, nv, chunk, k0, K)
                    torch.cuda.synchronize()
                    check(torch.equal(got, again), f"SCF {tag}: not "
                          "deterministic")
                    if nv == 0:
                        check(not got.any(), f"SCF {tag}: not zero")
                        continue
                    gold = scf64(X64[:nv], k0, K)
                    scale = float((np.abs(X64[:nv]) ** 2).sum(0).mean())
                    g_np = got.cpu().numpy().astype(np.float64)
                    p_np = want.cpu().numpy().astype(np.float64)
                    e_plain = float(np.abs(g_np - p_np).max()) / scale
                    e_gold = float(np.abs(g_np - gold).max()) / scale
                    e_ref = float(np.abs(p_np - gold).max()) / scale
                    budget = max(GOLDEN_RTOL, 3.0 * e_ref)
                    print(f"library SCF {tag} lags {k0}..{k0 + K - 1}: err "
                          f"over the alpha = 0 row's mean vs plain "
                          f"{e_plain:.3e}, vs float64 golden {e_gold:.3e} "
                          f"(<= {budget:.3g}; plain vs golden {e_ref:.3e})")
                    check(e_plain <= UNIFORM_RTOL and e_gold <= budget,
                          f"SCF {tag}: {e_plain} vs plain, {e_gold} vs "
                          "golden")
        # PFB-C at P = 4 (and 1), F output frames, against plain, the golden
        # and the PFB kernel's sum of |X|^2 on the same rows.
        for P in (1, 4):
            F = 64 if N == 16384 else 256
            chunk = adapt_batch(F)[1]
            rows_np = rng.integers(0, 256, (F + P - 1, 2 * N), dtype=np.uint8)
            rows = torch.from_numpy(rows_np).to(dev)
            h_np = pfb_prototype(N, P)
            h = torch.from_numpy(h_np.reshape(P, N).copy()).to(dev)
            got = fpf.pfb_channelize(rows, h)
            again = fpf.pfb_channelize(rows, h)
            want = fpf.pfb_channelize_reference(rows, h)
            torch.cuda.synchronize()
            tag = (f"N={N} T={F} P={P} "
                   f"({'ring' if fpf.ring_shape(N, P) else 'control load'})")
            check(torch.equal(got, again), f"PFB-C {tag}: not deterministic")
            z = dequant64(rows_np)
            hh = h_np.reshape(P, N).astype(np.float64)
            gold = np.fft.fft(sum(z[p:p + F] * hh[p] for p in range(P)),
                              axis=1)
            g_np = got.cpu().numpy().astype(np.complex128)
            p_np = want.cpu().numpy().astype(np.complex128)
            scale = float(np.abs(gold).mean())
            e_plain = float(np.abs(g_np - p_np).max()) / scale
            e_gold = float(np.abs(g_np - gold).max()) / scale
            e_ref = float(np.abs(p_np - gold).max()) / scale
            budget = max(GOLDEN_RTOL, 3.0 * e_ref)
            hist = rows[:P - 1].clone()
            hist_out = torch.empty_like(hist)
            psd = fpf.fused_psd_pfb(rows[P - 1:].contiguous(), hist, F, chunk,
                                    h, hist_out)
            pw = (got.real ** 2 + got.imag ** 2).reshape(
                F // chunk, chunk, N).sum(1).sum(0)
            e_psd = float((pw - psd).abs().max() / psd.abs().mean())
            print(f"library PFB-C {tag}: err/mean vs plain {e_plain:.3e}, vs "
                  f"float64 golden {e_gold:.3e} (<= {budget:.3g}; plain vs "
                  f"golden {e_ref:.3e}); |X|^2 summed vs fused_psd_pfb "
                  f"{e_psd:.3e} (<= {UNIFORM_RTOL:g})")
            check(e_plain <= UNIFORM_RTOL and e_gold <= budget
                  and e_psd <= UNIFORM_RTOL, f"PFB-C {tag}")
    print(f"wall: library kernels against plain in "
          f"{time.perf_counter() - t0:.1f} s")

    # 60-seed tone yards at N = 2048, F = 64.
    N, F, P, K = 2048, 64, 4, 16
    hann = make_window("hann", N)
    h_np = pfb_prototype(N, P).reshape(P, N)
    h_dev = torch.from_numpy(h_np.copy()).to(dev)

    def to_dev(a):
        return torch.from_numpy(a).to(dev)

    def by_mean(got, gold):
        return float(np.abs(got - gold).max() / np.abs(gold).mean())

    yard_by_scale(
        "library FR (|X|^2 rows, err/mean)",
        lambda s: ffr.fused_psd_frames(to_dev(tone_frames(N, F, s)), F, None,
                                       "power_shifted").cpu().numpy()
        .astype(np.float64),
        lambda s: np.fft.fftshift(np.abs(spectra64(tone_frames(N, F, s)))
                                  ** 2, axes=1),
        lambda s: np.fft.fftshift(np.abs(spectra_class(tone_frames(N, F, s)))
                                  ** 2, axes=1),
        by_mean, N, F, 18000)

    def pfb_sums(s):
        z = dequant64(tone_frames(N, F + P - 1, s))
        return sum(z[p:p + F] * h_np[p].astype(np.float64)
                   for p in range(P))

    yard_by_scale(
        "library PFB-C (X, err over mean |X|)",
        lambda s: fpf.pfb_channelize(to_dev(tone_frames(N, F + P - 1, s)),
                                     h_dev).cpu().numpy()
        .astype(np.complex128),
        lambda s: np.fft.fft(pfb_sums(s), axis=1),
        lambda s: fft_class(pfb_sums(s)),
        by_mean, N, F, 18100)

    def csd_metric(got, gold):
        return float(np.abs(got - gold).max()) / csd_scale(gold)

    yard_by_scale(
        "library CSD (four sums, Hann, err over the streams' power)",
        lambda s: fcsd.fused_psd_csd(
            to_dev(tone_frames(N, F, s)), to_dev(tone_frames(N, F, s + 7000)),
            F, F, to_dev(hann)).cpu().numpy().astype(np.float64),
        lambda s: csd64(spectra64(tone_frames(N, F, s), hann),
                        spectra64(tone_frames(N, F, s + 7000), hann)),
        lambda s: csd64(spectra_class(tone_frames(N, F, s), hann),
                        spectra_class(tone_frames(N, F, s + 7000), hann)),
        csd_metric, N, F, 18200)

    def scf_metric(got, gold):
        scale = float(np.abs(gold[0, 0]).mean())
        return float(np.abs(got[:, 1:] - gold[:, 1:]).max()) / scale

    yard_by_scale(
        f"library SCF (rows k >= 1 of K = {K}, err over the alpha = 0 "
        "row's mean)",
        lambda s: fscf.fused_psd_scf(
            ffr.fused_psd_frames(to_dev(tone_frames(N, F, s)), F, None,
                                 "complex"), F, F, 0, K).cpu().numpy()
        .astype(np.float64),
        lambda s: scf64(spectra64(tone_frames(N, F, s)), 0, K),
        lambda s: scf64(spectra_class(tone_frames(N, F, s)), 0, K),
        scf_metric, N, F, 18300)
    print(f"wall: library yards done at {time.perf_counter() - t0:.1f} s")

    # The library functions at full width, each through its kernels alone.
    launches = {}
    walls = {}

    def counted(label, fn, kernels):
        reset_counts(fp, ff)
        t1 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t1
        counts = launch_counts(fp, ff)
        others = {k: v for k, v in counts.items()
                  if v and k not in kernels}
        check(all(counts[k] > 0 for k in kernels) and not others,
              f"library drive {label} did not run through {kernels} alone: "
              f"{counts}")
        for k in kernels:
            launches[k] = launches.get(k, 0) + counts[k]
        return result, {k: counts[k] for k in kernels}

    # spectrogram: 2 s, hop 1024, average 4, Hann, 1024 frames a step.
    iq = synthetic_bytes(LIB_TONE + ",seed=1", 2.0)
    (times_s, freqs, S), c = counted(
        "spectrogram", lambda: models.spectrogram(
            iq, LIB_N, LIB_RATE, center_freq=100_000_000, hop=1024,
            average=4, window=hann, linear=True, frames_per_step=1024,
            device=dev), ["FR windowed"])
    frames = (len(iq) // 2 - LIB_N) // 1024 + 1
    rows = frames // 4
    check(S.shape == (rows, LIB_N) and c["FR windowed"] == 4
          and np.all(np.isfinite(S)),
          f"spectrogram: {S.shape}, launches {c} (want ({rows}, {LIB_N}), 4)")
    idx = np.arange(rows * 4)[:, None] * 2048 + np.arange(2 * LIB_N)[None]

    def waterfall(spectra_fn):
        pwr = np.zeros((rows, LIB_N))
        for lo in range(0, rows * 4, 400):
            at = idx[lo:lo + 400]
            pwr[lo // 4:(lo + len(at)) // 4] = (np.abs(spectra_fn(
                iq[at], hann)) ** 2).reshape(-1, 4, LIB_N).sum(1)
        out = np.fft.fftshift(pwr, axes=1)
        out[:, LIB_N // 2] = (out[:, LIB_N // 2 - 1]
                              + out[:, LIB_N // 2 + 1]) / 2.0
        return out / 4 / LIB_N / LIB_RATE

    gold = waterfall(spectra64)
    rms = np.sqrt((gold ** 2).mean(axis=1, keepdims=True))
    e_rms = float((np.abs(S - gold) / rms).max())
    e_cls = float((np.abs(waterfall(spectra_class) - gold) / rms).max())
    budget = max(GOLDEN_RTOL, 3.0 * e_cls)
    peak = freqs[int(np.argmax(S.mean(0)))]
    print(f"library drive spectrogram ({len(iq) // 2} samples at "
          f"{LIB_RATE} S/s, N={LIB_N}, hop 1024, average 4, Hann, 1024 "
          f"frames a step): {frames} frames, {rows} rows in "
          f"{walls['spectrogram']:.3f} s wall; peak {peak / 1e6:.4f} MHz; vs "
          f"the float64 golden err over the row's RMS {e_rms:.3e} (<= "
          f"{budget:.3g}; scipy float32 {e_cls:.3e}), max rel "
          f"{max_rel(S, gold):.3e}; launches {c}")
    check(e_rms <= budget and abs(peak - 100.2e6) <= LIB_RATE / LIB_N,
          "spectrogram drive vs golden")

    # pfb_channelize: M = 2048, P = 4, 4 s of stream.
    iq = synthetic_bytes(LIB_TONE + ",seed=2", 4.0)
    y, c = counted("pfb_channelize", lambda: models.pfb_channelize(
        iq, LIB_N, taps=4, device=dev), ["PFB-C"])
    T = T_ch = len(iq) // (2 * LIB_N) - 3
    hh = pfb_prototype(LIB_N, 4).reshape(4, LIB_N).astype(np.float64)
    z = dequant64(iq[:(T + 3) * 2 * LIB_N].reshape(-1, 2 * LIB_N))
    sums = sum(z[p:p + T] * hh[p] for p in range(4))
    gold = np.fft.fft(sums, axis=1)
    scale = float(np.abs(gold).mean())
    e_ch = float(np.abs(y - gold).max()) / scale
    e_cls = float(np.abs(fft_class(sums) - gold).max()) / scale
    budget = max(GOLDEN_RTOL, 3.0 * e_cls)
    check(y.shape == (T, LIB_N) and y.dtype == np.complex64
          and c["PFB-C"] == -(-T // 1024), f"pfb_channelize: {y.shape}, {c}")
    print(f"library drive pfb_channelize (M={LIB_N}, P=4, "
          f"{len(iq) // 2} samples): T={T} in "
          f"{walls['pfb_channelize']:.3f} s wall; vs the float64 golden "
          f"err over mean |X| {e_ch:.3e} (<= {budget:.3g}; scipy float32 "
          f"{e_cls:.3e}); launches {c}")
    check(e_ch <= budget, "pfb_channelize drive vs golden")
    del z, sums, gold, y

    # coherence: two 1 s streams sharing the tone, independent noise, Hann.
    iq_x = synthetic_bytes(LIB_TONE + ",seed=3", 1.0)
    iq_y = synthetic_bytes(LIB_TONE + ",seed=4", 1.0)
    (freqs, g2, csd), c = counted("coherence", lambda: models.coherence(
        iq_x, iq_y, LIB_N, LIB_RATE, center_freq=100_000_000, window=hann,
        device=dev), ["CSD windowed"])
    M = M_coh = len(iq_x) // (2 * LIB_N)
    ctr = LIB_N // 2

    def coherence_of(spectra_fn):
        sums = csd64(spectra_fn(iq_x[:M * 2 * LIB_N].reshape(M, -1), hann),
                     spectra_fn(iq_y[:M * 2 * LIB_N].reshape(M, -1), hann))
        sh = [np.fft.fftshift(s) for s in sums]
        sxx, syy, sxy = sh[0], sh[1], sh[2] + 1j * sh[3]
        for arr in (sxx, syy, sxy):
            arr[ctr] = (arr[ctr - 1] + arr[ctr + 1]) / 2.0
        scale = (np.sqrt(np.sqrt((sxx ** 2).mean() * (syy ** 2).mean()))
                 / M / LIB_N / LIB_RATE)
        return (np.abs(sxy) ** 2 / np.maximum(sxx * syy, 1e-300),
                sxy / M / LIB_N / LIB_RATE, scale)

    g_gold, csd_gold, scale = coherence_of(spectra64)
    g_cls, csd_cls, _ = coherence_of(spectra_class)
    e_g = float(np.abs(g2 - g_gold).max())
    e_c = float(np.abs(csd - csd_gold).max()) / scale
    e_gc = float(np.abs(g_cls - g_gold).max())
    e_cc = float(np.abs(csd_cls - csd_gold).max()) / scale
    b_g, b_c = max(1e-5, 3.0 * e_gc), max(GOLDEN_RTOL, 3.0 * e_cc)
    tone = int(np.argmin(np.abs(freqs - 100.2e6)))
    others = np.delete(g2, np.arange(tone - 3, tone + 4))
    print(f"library drive coherence (two 1 s streams, shared tone, "
          f"independent noise, Hann, M={M}): {walls['coherence']:.3f} s wall; "
          f"gamma2 {g2[tone]:.4f} at the tone bin, median elsewhere "
          f"{np.median(others):.4f}, DC bin {g2[ctr]:.4f}; vs the float64 "
          f"golden gamma2 abs {e_g:.3e} (<= {b_g:.3g}; scipy float32 "
          f"{e_gc:.3e}), CSD err over the streams' RMS power {e_c:.3e} (<= "
          f"{b_c:.3g}; scipy float32 {e_cc:.3e}); launches {c}")
    check(g2[tone] > 0.95 and np.median(others) < 0.05 and g2[ctr] < 0.05
          and e_g <= b_g and e_c <= b_c, "coherence drive")

    # spectral_correlation, K = 16, an AM signal (4 bins of modulation).
    fm_bins, K = 4, 16
    n = LIB_RATE // 2
    t = np.arange(n)
    am = (1.0 + 0.9 * np.cos(2 * np.pi * fm_bins / LIB_N * t)) * 40.0 \
        * np.exp(2j * np.pi * (300 / LIB_N) * t)
    g = np.random.default_rng(6)
    x = am + 3.0 * (g.standard_normal(n) + 1j * g.standard_normal(n))
    iq = np.stack([np.clip(np.round(x.real + 127), 0, 255),
                   np.clip(np.round(x.imag + 127), 0, 255)],
                  axis=-1).astype(np.uint8).reshape(-1)
    (alphas, scf, coh), c = counted(
        "spectral_correlation", lambda: models.spectral_correlation(
            iq, LIB_N, LIB_RATE, max_alpha_bins=K, device=dev),
        ["FR", "SCF"])
    M = len(iq) // (2 * LIB_N)

    def scf_of(spectra_fn):
        s = scf64(spectra_fn(iq[:M * 2 * LIB_N].reshape(M, -1)), 0, K)
        return (s[0] + 1j * s[1]) / M

    gold = scf_of(spectra64)
    scale = float(np.abs(gold[0]).mean())
    e_s = float(np.abs(scf - gold).max()) / scale
    e_cls = float(np.abs(scf_of(spectra_class) - gold).max()) / scale
    budget = max(GOLDEN_RTOL, 3.0 * e_cls)
    scores = coh[1:].max(axis=1)
    print(f"library drive spectral_correlation (AM at {fm_bins} bins, K={K}, "
          f"M={M}): {walls['spectral_correlation']:.3f} s wall; peak "
          f"coherence off alpha = 0 at lag {int(np.argmax(scores)) + 1} "
          f"({scores.max():.3f}; median of the others "
          f"{np.median(np.delete(scores, fm_bins - 1)):.3f}); vs the float64 "
          f"golden err over the alpha = 0 row's mean {e_s:.3e} (<= "
          f"{budget:.3g}; scipy float32 {e_cls:.3e}); launches {c}")
    check(int(np.argmax(scores)) + 1 == fm_bins and e_s <= budget,
          "spectral_correlation drive")
    print(f"wall: library drives done at {time.perf_counter() - t0:.1f} s")

    # Each wrapper against its plain version at the grids the drives run,
    # where a block takes several frames (k1_group's group over the lanes):
    # each drive's full step (in timed below) and its last, partial step.
    def hold(label, kernel, plain, scale, group=None):
        """``kernel`` twice (the same bits) and ``plain`` once on the same
        inputs, held by the largest error over ``scale(plain's output)``;
        returns the largest absolute error."""
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"library {label}: not deterministic")
        kind = np.complex128 if got.is_complex() else np.float64
        g_np = got.cpu().numpy().astype(kind)
        p_np = want.cpu().numpy().astype(kind)
        err = float(np.abs(g_np - p_np).max())
        rel = err / scale(p_np)
        grid = "" if group is None else f", {group} frames a block"
        print(f"library {label}{grid}: err vs plain {rel:.3e} (<= "
              f"{UNIFORM_RTOL:g}), two calls the same bits")
        check(rel <= UNIFORM_RTOL, f"library {label}: {rel} vs plain")
        return err

    def mean_abs(a):
        return float(np.abs(a).mean())

    def lag0_mean(a):
        return float(np.abs(a[0, 0]).mean())

    def frames_group(F, windowed, complex_out):
        return fp.library_plan("fused_psd_frames", LIB_N, F, ffr.GROUP_CHUNK,
                               dev.index, int(windowed),
                               int(complex_out)).group

    def step_frames(F, seed):
        return torch.from_numpy(np.random.default_rng(seed).integers(
            0, 256, (F, 2 * LIB_N), dtype=np.uint8)).to(dev)

    w = torch.from_numpy(hann).to(dev)
    F, nv = 1024, frames % 1024
    raw = step_frames(F, 1)
    hold(f"FR windowed power N={LIB_N} F={F} n_valid={nv} (spectrogram's "
         "last step)", lambda: ffr.fused_psd_frames(raw, nv, w)[:nv],
         lambda: ffr.fused_psd_frames_reference(raw, nv, w)[:nv], mean_abs,
         frames_group(F, True, False))
    F, nv = 512, M_coh % 512
    raw, rawy = step_frames(F, 2), step_frames(F, 3)
    hold(f"CSD N={LIB_N} F={F} Hann n_valid={nv} (coherence's last step)",
         lambda: fcsd.fused_psd_csd(raw, rawy, nv, 64, w),
         lambda: fcsd.fused_psd_csd_reference(raw, rawy, nv, 64, w),
         csd_scale, fp.library_plan("fused_psd_csd", LIB_N, F, 64, dev.index,
                                    1).group)
    F, chunk = adapt_batch(min(M, 512))
    raw = step_frames(F, 4)
    hold(f"FR complex N={LIB_N} F={F} n_valid={M} (spectral_correlation's "
         "step)", lambda: ffr.fused_psd_frames(raw, M, None, "complex")[:M],
         lambda: ffr.fused_psd_frames_reference(raw, M, None, "complex")[:M],
         mean_abs, frames_group(F, False, True))
    X = ffr.fused_psd_frames(raw, M, None, "complex")
    hold(f"SCF N={LIB_N} F={F} chunk={chunk} K={K} n_valid={M} "
         "(spectral_correlation's step)",
         lambda: fscf.fused_psd_scf(X, M, chunk, 0, K),
         lambda: fscf.fused_psd_scf_reference(X, M, chunk, 0, K), lag0_mean)
    T = T_ch % 1024
    rows_t = step_frames(T + 3, 5)
    hold(f"PFB-C M={LIB_N} T={T} P=4 (pfb_channelize's last step)",
         lambda: fpf.pfb_channelize(rows_t, h_dev),
         lambda: fpf.pfb_channelize_reference(rows_t, h_dev), mean_abs,
         fp.library_plan("fused_psd_pfb", LIB_N, T, fpf.CHANNELIZE_CHUNK,
                         dev.index, 4, 1, int(fpf.ring_shape(LIB_N, 4)
                                              .stage_h),
                         entry="rpf_pfb_channelize_attributes").group)

    # Times at each drive's step, each kernel held against plain there.
    times = {}

    def timed(key, kernel, plain, lib_frames, bound, scale):
        max_abs = hold(key, kernel, plain, scale)
        call = event_times_us(kernel)
        kd = [device_times_us(kernel), device_times_us(kernel)]
        out = kernel()
        torch.cuda.synchronize()
        back = []
        for _ in range(20):   # the library function's read-back of a step
            t1 = time.perf_counter()
            out.cpu()
            back.append(1e6 * (time.perf_counter() - t1))
        t = {"call": call, "device": min(kd), "host": host_us(kernel),
             "readback": statistics.median(back),
             "plain": event_times_us(plain, iters=10, warmup=2),
             "lib": event_times_us(lambda: torch.fft.fft(lib_frames, dim=-1)),
             "lib_device": device_times_us(
                 lambda: torch.fft.fft(lib_frames, dim=-1)),
             "bound": bound, "max_abs": max_abs}
        times[key] = t
        b_us = 1e3 * bound[0]
        print(f"time library {key} on {card}: {call:.1f} us a call, device "
              f"{kd[0]:.1f}/{kd[1]:.1f} us, host {t['host']:.1f} us; the "
              f"output's read-back ({out.nbytes / 2 ** 20:.2f} MiB, .cpu(), "
              f"host clock) {t['readback']:.1f} us; plain "
              f"{t['plain']:.1f} us; torch.fft.fft of the "
              f"{tuple(lib_frames.shape)} complex64 frames {t['lib']:.1f} us "
              f"(device {t['lib_device']:.1f}), kernel/fft on the device "
              f"{t['device'] / t['lib_device']:.3f}; bound {b_us:.2f} us "
              f"({bound[1]}), device/bound {t['device'] / b_us:.1f}x")
        return t

    def frames_dev(F):
        raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * LIB_N),
                                            dtype=np.uint8)).to(dev)
        z = torch.complex(raw[:, 0::2].float() - 127.0,
                          raw[:, 1::2].float() - 127.0)
        return raw, z

    raw, z = frames_dev(1024)
    timed("FR windowed power N=2048 F=1024 (spectrogram's step)",
          lambda: ffr.fused_psd_frames(raw, 1024, w),
          lambda: ffr.fused_psd_frames_reference(raw, 1024, w), z,
          library_bound_ms("FR", 1024, LIB_N, True), mean_abs)
    raw, z = frames_dev(4096)
    fr4096 = timed("FR power N=2048 F=4096",
                   lambda: ffr.fused_psd_frames(raw, 4096),
                   lambda: ffr.fused_psd_frames_reference(raw, 4096), z,
                   library_bound_ms("FR", 4096, LIB_N), mean_abs)
    k1_dev = min(device_times_us(lambda: fp.fused_psd(raw, 4096, 64))
                 for _ in range(2))
    print(f"time library FR power N=2048 F=4096 on {card}: device "
          f"{fr4096['device']:.1f} us beside K1's {k1_dev:.1f} us on the same "
          f"frames (FR/K1 {fr4096['device'] / k1_dev:.3f}; FR writes "
          f"{4096 * LIB_N * 4 / 2 ** 20:.0f} MiB of rows, K1 one row)")
    raw, z = frames_dev(512)
    X = ffr.fused_psd_frames(raw, 512, None, "complex")
    timed("FR complex N=2048 F=512 (spectral_correlation's step)",
          lambda: ffr.fused_psd_frames(raw, 512, None, "complex"),
          lambda: ffr.fused_psd_frames_reference(raw, 512, None, "complex"),
          z, library_bound_ms("FR", 512, LIB_N, complex_out=True), mean_abs)
    timed(f"SCF N=2048 F=512 K={K} (spectral_correlation's step)",
          lambda: fscf.fused_psd_scf(X, 512, 64, 0, K),
          lambda: fscf.fused_psd_scf_reference(X, 512, 64, 0, K), z,
          library_bound_ms("SCF", 512, LIB_N, K=K), lag0_mean)
    rawy, zy = frames_dev(512)
    timed("CSD N=2048 F=512 Hann (coherence's step)",
          lambda: fcsd.fused_psd_csd(raw, rawy, 512, 64, w),
          lambda: fcsd.fused_psd_csd_reference(raw, rawy, 512, 64, w),
          torch.cat([z, zy]),
          library_bound_ms("CSD", 512, LIB_N, True), csd_scale)
    rows_t, _ = frames_dev(1027)
    timed("PFB-C M=2048 T=1024 P=4 (pfb_channelize's step)",
          lambda: fpf.pfb_channelize(rows_t, h_dev),
          lambda: fpf.pfb_channelize_reference(rows_t, h_dev),
          frames_dev(1024)[1],
          library_bound_ms("PFB-C", 1024, LIB_N, P=4), mean_abs)
    # PFB-C's ring form (ring_shape's at 2048, P = 4) against the control's
    # load at the same step, in turns; the control held against plain too.
    hold("PFB-C M=2048 T=1024 P=4, the control's load",
         lambda: fpf.pfb_channelize(rows_t, h_dev, ring=False),
         lambda: fpf.pfb_channelize_reference(rows_t, h_dev), mean_abs)
    ring_us, control_us = [], []
    for _ in range(3):
        ring_us.append(device_times_us(
            lambda: fpf.pfb_channelize(rows_t, h_dev)))
        control_us.append(device_times_us(
            lambda: fpf.pfb_channelize(rows_t, h_dev, ring=False)))
    times["PFB-C control"] = min(control_us)
    print(f"time library PFB-C M=2048 T=1024 P=4 on {card}: device, in "
          f"turns, ring form {', '.join(f'{t:.2f}' for t in ring_us)} us, "
          f"control's load {', '.join(f'{t:.2f}' for t in control_us)} us; "
          f"ring/control {min(ring_us) / min(control_us):.3f} (spreads "
          f"{max(ring_us) - min(ring_us):.2f} and "
          f"{max(control_us) - min(control_us):.2f} us)")
    print(f"wall: library phase in {time.perf_counter() - t0:.1f} s")

    def entry(name, source, replaces, key, times_key, **extra):
        t = times[times_key]
        return extra | {"name": name, "route": "cuda", "source": CSRC + source,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": t["max_abs"], "ms": t["call"] / 1000.0,
                "plain_ms": t["plain"] / 1000.0, "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": t["lib"] / 1000.0,
                "device_ms": t["device"] / 1000.0,
                "host_ms": t["host"] / 1000.0,
                "readback_ms": t["readback"] / 1000.0,
                "library_device_ms": t["lib_device"] / 1000.0,
                "drive_wall_s": walls[{"FR": "spectral_correlation",
                                       "FR windowed": "spectrogram",
                                       "PFB-C": "pfb_channelize",
                                       "CSD windowed": "coherence",
                                       "SCF": "spectral_correlation"}[key]]}

    return [entry("fused_psd_frames (FR, complex)", "fused_psd_frames.cu",
                  "rtl_power_fftw_tpu/models/cyclo.py:42", "FR",
                  "FR complex N=2048 F=512 (spectral_correlation's step)"),
            entry("fused_psd_frames (FR, windowed power)",
                  "fused_psd_frames.cu",
                  "rtl_power_fftw_tpu/models/spectrogram.py:23",
                  "FR windowed",
                  "FR windowed power N=2048 F=1024 (spectrogram's step)"),
            entry("pfb_channelize (PFB-C)", "fused_psd_pfb.cu",
                  "rtl_power_fftw_tpu/models/pfb.py:401", "PFB-C",
                  "PFB-C M=2048 T=1024 P=4 (pfb_channelize's step)",
                  control_device_ms=times["PFB-C control"] / 1000.0),
            entry("fused_psd_csd (CSD, windowed)", "fused_psd_csd.cu",
                  "rtl_power_fftw_tpu/models/coherence.py:29",
                  "CSD windowed", "CSD N=2048 F=512 Hann (coherence's step)"),
            entry("fused_psd_scf (SCF)", "fused_psd_scf.cu",
                  "rtl_power_fftw_tpu/models/cyclo.py:42", "SCF",
                  f"SCF N=2048 F=512 K={K} (spectral_correlation's step)")]


# Phase 19's CLI drives at the awkward bin counts, at the tone source with
# linear output (less their "--record <path>" and SK file): the multitaper
# at 2400 bins, the PFB at 12000, SK with Hann at 10000. The man-page scan
# (MAN_PAGE_ARGV, with its SK file) and --sk-excise 3 at 500 bins
# (drive_sk_excise's burst stream) are the other two.
MIXED_MT_ARGV = ["-f", "100M", "-n", "4000", "-b", "2400", "-l",
                 "--multitaper", "7", "--source", SOURCE]
MIXED_PFB_ARGV = ["-f", "100M", "-n", "400", "-b", "12000", "-l",
                  "--pfb-taps", "4", "--source", SOURCE]
MIXED_SK_HANN_ARGV = ["-f", "100M", "-n", "400", "-b", "10000", "-l",
                      "--window-function", "hann", "--source", SOURCE]


def est_errors(got, want, gold, n_valid):
    """(vs plain, vs the float64 golden, the limit of both, the measure)
    of an estimator row over ``n_valid`` frames: over 64 frames and more
    the max relative error, limit 1e-5; over fewer the error over the
    golden's mean power (phase 14's rule: a few frames' smallest bins are
    single periodogram values near 0), limit 1e-5 or 3x plain's own
    distance from the golden where that is larger (phase 18's rule: a
    single frame's |X|^4 peaks far above its mean, plain's error there as
    large)."""
    got, want, gold = (np.asarray(a, np.float64) for a in (got, want, gold))
    if n_valid >= 64:
        return max_rel(got, want), max_rel(got, gold), GOLDEN_RTOL, "max rel"
    scale = max(float(gold.mean()), 1e-30)
    plain = float(np.abs(want - gold).max()) / scale
    return (float(np.abs(got - want).max()) / scale,
            float(np.abs(got - gold).max()) / scale,
            max(GOLDEN_RTOL, 3.0 * plain), "err/mean")


def sk_file_error(sk_path, frames_np, repeats, window=None):
    """(the SK values, max |SK - float64 SK|) of an SK file that says it
    accumulated ``repeats`` spectra, against the float64 SK of the frames
    it was accumulated over."""
    from rtl_power_fftw_tpu_torch.models.kurtosis import compute_sk
    with open(sk_path) as f:
        text = f.read()
    check(f"# Spectra accumulated: {repeats}" in text,
          f"{sk_path}: not {repeats} spectra")
    values = np.array([float(line.split()[1]) for line in text.splitlines()
                       if line and not line.startswith("#")])
    g1, g2 = golden_moments(frames_np, repeats, window)
    gold = np.fft.fftshift(compute_sk(g1, g2, repeats))
    if values.shape != gold.shape:
        return values, float("inf")
    return values, float(np.abs(values - gold).max())


def phase_mixed_estimators(dev, rng, fp, adapt_batch, make_window, cli, ff,
                           card):
    """19. The CLI estimators at the awkward bin counts (SK-M, MT-M, PFB-M
    of ``fused_psd_mixed_est``): their registers, spill and blocks per SM
    beside M's; each against its plain version and the float64 golden,
    twice (the same bits), at N = 500 (the man-page step), 2400, 6000
    with Hann, 12000, 16000 and 30, n_valid F, F - 1, 1 and 0 (the PFB as
    four steps of one stream, its history the plain version's and the
    virtual rows'); SK-M's s1 M's output bit for bit there and at every
    plan phase 13 walks; the 60-seed yards at 500 and 2400 (SK's s2 also
    with Hann); times at 2400 F=4096 and at the drives' steps beside M,
    torch.fft.fft and the bound; five CLI drives, each on its kernel
    alone. Returns the kernels-line entries."""
    import scipy.fft
    from rtl_power_fftw_tpu_torch.models.multitaper import _session_tapers
    from rtl_power_fftw_tpu_torch.models.pfb import pfb_prototype
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed as fm
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_mixed_est as fe
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_sk as fsk
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_tapers as fmt
    t0 = time.perf_counter()
    man_F = adapt_batch(drive_frames_per_step(MAN_PAGE_ARGV))[0]
    mt_F = adapt_batch(drive_frames_per_step(MIXED_MT_ARGV))[0]
    pfb_F = adapt_batch(drive_frames_per_step(MIXED_PFB_ARGV))[0]
    sk_hann_F = adapt_batch(drive_frames_per_step(MIXED_SK_HANN_ARGV))[0]
    attrs = {}
    for N in (30, 500, 2400, 6000, 10000, 12000, 16000):
        shape = fm.ring_launch(N)
        rows = [("M", fm.ring_attributes(shape, False))]
        for name, cut, w in (("SK-M", fe.SK, False),
                             ("SK-M windowed", fe.SK, True),
                             ("MT-M", fe.TAPERS, True),
                             ("PFB-M", fe.PFB, False)):
            rows.append((name, fe.kernel_attributes(N, cut, w)))
        for name, a in rows:
            attrs[(name, N)] = a
            print(f"occupancy {name} N={N} plan {shape.plan} on {card}: "
                  f"{a['registers']} registers, {a['spill_bytes']} B spill, "
                  f"{a['static_smem']} + {a['dynamic_smem']} B shared, "
                  f"{a['threads']} threads ({shape.lanes} lanes of "
                  f"{shape.tf}), last-pass sums {shape.acc} of "
                  f"{shape.acc_class}, {a['blocks_per_sm']} blocks/SM")
    reset_counts(fp, ff)
    want = {"SK-M": 0, "MT-M": 0, "PFB-M": 0, "M": 0}

    # Each kernel against plain and the float64 golden, twice.
    for N, fps, wname in ((500, man_F, None), (2400, 4096, None),
                          (6000, 256, "hann"), (12000, 64, None),
                          (16000, 64, None), (30, 256, None)):
        F, chunk = adapt_batch(fps)
        w_np = None if wname is None else make_window(wname, N)
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        tp_np = _session_tapers(N, 4.0, 7)
        tp = torch.from_numpy(tp_np).to(dev)
        sigma = 3.0 if N in (500, 12000) else 0.0
        for nv in (F, F - 1, 1, 0):
            got = fe.fused_psd_sk_mixed(raw, nv, chunk, w, sigma)
            again = fe.fused_psd_sk_mixed(raw, nv, chunk, w, sigma)
            m = fm.fused_psd_mixed(raw, nv, chunk, w)
            ref = fsk.fused_psd_sk_reference(raw, nv, chunk, w, sigma)
            mt = fe.fused_psd_tapers_mixed(raw, nv, chunk, tp)
            mt_again = fe.fused_psd_tapers_mixed(raw, nv, chunk, tp)
            mt_ref = fmt.fused_psd_tapers_reference(raw, nv, chunk, tp)
            torch.cuda.synchronize()
            want["SK-M"] += 2
            want["MT-M"] += 2
            want["M"] += 1
            label = f"N={N} F={F} chunk={chunk} n_valid={nv} window={wname}"
            check(torch.equal(got, again) and torch.equal(mt, mt_again),
                  f"SK-M/MT-M {label}: not deterministic")
            check(torch.equal(got[0], m), f"SK-M {label}: s1 is not M's")
            got_np, ref_np = got.cpu().numpy(), ref.cpu().numpy()
            mt_np, mt_ref_np = mt.cpu().numpy(), mt_ref.cpu().numpy()
            gate = ""
            if sigma > 0.0:
                keep = fsk.sk_keep(got[0].cpu(), got[1].cpu(), float(nv),
                                   sigma).numpy()
                check(np.array_equal(got_np[3], nv * keep)
                      and np.array_equal(got_np[2], got_np[0] * keep),
                      f"SK-M {label}: the gate epilogue is not sk_keep's")
                gate = (f"; gate {sigma:g}: {int(keep.sum())} of {N} kept "
                        f"(plain {int((ref_np[3] > 0).sum())})")
            if nv == 0:
                check(not got_np[:2].any() and not mt_np.any(),
                      f"SK-M/MT-M {label}: rows of no frame are not 0")
                print(f"mixed estimators SK-M, MT-M {label}: the same bits "
                      f"twice, s1 M's, every row 0{gate}")
                continue
            g1, g2 = golden_moments(raw_np, nv, w_np)
            errs = {"SK-M s1": est_errors(got_np[0], ref_np[0], g1, nv),
                    "SK-M s2": est_errors(got_np[1], ref_np[1], g2, nv),
                    "MT-M K=7": est_errors(
                        mt_np, mt_ref_np, golden_tapers(raw_np, nv, tp_np),
                        nv)}
            print(f"mixed estimators {label}: the same bits twice, SK-M's "
                  f"s1 M's; " + "; ".join(
                      f"{k} {e[3]} vs plain {e[0]:.3e}, vs float64 golden "
                      f"{e[1]:.3e} (<= {e[2]:.3g})" for k, e in errs.items())
                  + gate)
            check(all(e[0] <= e[2] and e[1] <= e[2] for e in errs.values()),
                  f"SK-M/MT-M {label}: {errs}")
        # PFB-M: four steps of one stream (n_valid F, 1, F - 1, 0), the
        # history carried on the card; P = 16 at 500 bins too, P = 1 at 30.
        for P in (4,) + ((16,) if N == 500 else (1,) if N == 30 else ()):
            h_np = pfb_prototype(N, P).reshape(P, N)
            h = torch.from_numpy(h_np).to(dev)
            hist = [torch.empty((P - 1, 2 * N), dtype=torch.uint8,
                                device=dev) for _ in range(2)]
            hist_p = [torch.empty((P - 1, 2 * N), dtype=torch.uint8)
                      for _ in range(2)]
            virtual = np.full((P - 1, 2 * N), 127, np.uint8)
            for step, nv in enumerate((F, 1, F - 1, 0)):
                slot_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
                slot = torch.from_numpy(slot_np)
                got = fe.fused_psd_pfb_mixed(slot.to(dev), hist[0], nv, chunk,
                                             h, hist[1], fresh=step == 0)
                ref = fpf.fused_psd_pfb_reference(slot, hist_p[0], nv, chunk,
                                                  h.cpu(), hist_p[1],
                                                  fresh=step == 0)
                torch.cuda.synchronize()
                want["PFB-M"] += 1
                virtual = np.concatenate([virtual, slot_np])
                gold = golden_pfb(virtual, nv, h_np)
                virtual = virtual[nv:nv + P - 1]
                same_hist = (torch.equal(hist[1].cpu(), hist_p[1])
                             and np.array_equal(hist[1].cpu().numpy(),
                                                virtual))
                got_np = got.cpu().numpy()
                if nv == 0:
                    e = (0.0, 0.0, 0.0, "zero")
                    check(not got_np.any(), f"PFB-M N={N} P={P}: no frame")
                else:
                    e = est_errors(got_np, ref.numpy(), gold, nv)
                print(f"mixed estimators PFB-M N={N} F={F} P={P} step {step} "
                      f"n_valid={nv}: {e[3]} vs plain {e[0]:.3e}, vs float64 "
                      f"golden {e[1]:.3e} (<= {e[2]:.3g}); history plain's "
                      f"and rows n_valid .. n_valid + P - 2: {same_hist}")
                check(e[0] <= e[2] and e[1] <= e[2] and same_hist,
                      f"PFB-M N={N} P={P} step {step}")
                hist.reverse()
                hist_p.reverse()
            spare = torch.empty_like(hist[0])
            a = fe.fused_psd_pfb_mixed(raw, hist[0], F, chunk, h, hist[1])
            b = fe.fused_psd_pfb_mixed(raw, hist[0], F, chunk, h, spare)
            torch.cuda.synchronize()
            want["PFB-M"] += 2
            check(torch.equal(a, b) and torch.equal(hist[1], spare),
                  f"PFB-M N={N} P={P}: not deterministic")
    # SK-M at every plan phase 13 walks (each even 7-smooth N to 16384),
    # 8 frames each, every third with Hann: s1 M's bits, s1 within 1e-5
    # and s2 within 2e-5 of the float64 golden (the square doubles the
    # relative error of |X|^2).
    plans = [N for N in range(2, fm.MAX_N + 1, 2)
             if fm.fused_psd_mixed_eligible(N)]
    worst = [(0.0, None), (0.0, None)]
    for i, N in enumerate(plans):
        w_np = make_window("hann", N) if i % 3 == 2 else None
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        raw_np = rng.integers(0, 256, (8, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        got = fe.fused_psd_sk_mixed(raw, 8, 8, w)
        m = fm.fused_psd_mixed(raw, 8, 8, w)
        want["SK-M"] += 1
        want["M"] += 1
        check(torch.equal(got[0], m), f"SK-M sweep N={N}: s1 is not M's")
        got_np = got.cpu().numpy()
        for k, g in enumerate(golden_moments(raw_np, 8, w_np)):
            err = max_rel(got_np[k], g)
            if err >= worst[k][0]:
                worst[k] = (err, (N, "hann" if w_np is not None else None))
    print(f"mixed estimators SK-M sweep of {len(plans)} plans, 8 frames "
          f"each: s1 M's bits at every plan; worst max rel vs float64 "
          f"golden s1 {worst[0][0]:.3e} at {worst[0][1]}, s2 "
          f"{worst[1][0]:.3e} at {worst[1][1]}")
    check(worst[0][0] <= GOLDEN_RTOL and worst[1][0] <= 2 * GOLDEN_RTOL,
          f"SK-M sweep: {worst}")
    counts = launch_counts(fp, ff)
    check(all(counts[k] == v for k, v in want.items())
          and counts["plain"] == 0 and not any(
              v for k, v in counts.items() if k not in want),
          f"mixed estimator launch counts: {counts}, expected {want}")
    print(f"wall: mixed estimator checks in {time.perf_counter() - t0:.1f} s")

    # The yards: 60 seeds of 35 dB tones at 500 and 2400 bins, 64 frames.
    F = 64

    def f32_class(z):
        Xc = scipy.fft.fft(z.astype(np.complex64), axis=-1)
        return (Xc.real.astype(np.float64) ** 2
                + Xc.imag.astype(np.float64) ** 2)

    reset_counts(fp, ff)
    for N in (500, 2400):
        for wname in (None, "hann") if N == 2400 else (None,):
            w_np = None if wname is None else make_window(wname, N)
            w = None if w_np is None else torch.from_numpy(w_np).to(dev)
            wz = 1.0 if w_np is None else w_np.astype(np.float64)
            estimator_yard(
                f"SK-M s2{' hann' if wname else ''}",
                lambda raw_np, w=w: fe.fused_psd_sk_mixed(
                    torch.from_numpy(raw_np).to(dev), F, F, w)[1].cpu()
                .numpy(),
                lambda raw_np, w_np=w_np: golden_moments(raw_np, F, w_np)[1],
                lambda raw_np, wz=wz: (f32_class(dequant64(raw_np) * wz)
                                       ** 2).sum(0),
                N, F, 19000 + N + (wname is not None))
        tp_np = _session_tapers(N, 4.0, 7)
        tp = torch.from_numpy(tp_np).to(dev)
        estimator_yard(
            "MT-M K=7",
            lambda raw_np, tp=tp: fe.fused_psd_tapers_mixed(
                torch.from_numpy(raw_np).to(dev), F, F, tp).cpu().numpy(),
            lambda raw_np, tp_np=tp_np: golden_tapers(raw_np, F, tp_np),
            lambda raw_np, tp_np=tp_np: f32_class(
                dequant64(raw_np)[:, None, :]
                * tp_np.astype(np.float64)[None]).mean(1).sum(0),
            N, F, 19100 + N)
        P = 4
        h_np = pfb_prototype(N, P).reshape(P, N)
        h = torch.from_numpy(h_np).to(dev)
        hist = [torch.empty((P - 1, 2 * N), dtype=torch.uint8, device=dev)
                for _ in range(2)]

        def pfb_virtual(raw_np, N=N, P=P):
            return np.concatenate([np.full((P - 1, 2 * N), 127, np.uint8),
                                   raw_np])

        def pfb_class(raw_np, h_np=h_np, pfb_virtual=pfb_virtual):
            sums = fpf.pfb_sums_reference(
                torch.from_numpy(pfb_virtual(raw_np)),
                torch.from_numpy(h_np), F).numpy()
            return f32_class(sums.astype(np.complex128)).sum(0)

        estimator_yard(
            "PFB-M P=4",
            lambda raw_np, h=h, hist=hist: fe.fused_psd_pfb_mixed(
                torch.from_numpy(raw_np).to(dev), hist[0], F, F, h, hist[1],
                fresh=True).cpu().numpy(),
            lambda raw_np, h_np=h_np, pfb_virtual=pfb_virtual: golden_pfb(
                pfb_virtual(raw_np), F, h_np),
            pfb_class, N, F, 19200 + N)
    counts = launch_counts(fp, ff)
    check(counts["SK-M"] == 180 and counts["MT-M"] == counts["PFB-M"] == 120
          and counts["plain"] == 0, f"mixed estimator yards' launches: "
          f"{counts}")
    print(f"wall: mixed estimator yards in {time.perf_counter() - t0:.1f} s")

    # Times (PERF.md states their prediction): at 2400 F=4096 and at each
    # drive's own step, a call (CUDA events), the device's part (twice, in
    # turns with M's on the same frames), the wrapper's host part, the
    # plain version and torch.fft.fft on the same transforms (F frames; F
    # K tapered frames; F polyphase sums), and the bound.
    times = {}
    for kind, N, F, wname, arg in (
            ("SK-M", 2400, 4096, None, 0.0), ("SK-M", 500, man_F, None, 0.0),
            ("SK-M", 500, 256, None, 3.0),
            ("SK-M", 10000, sk_hann_F, "hann", 0.0),
            ("MT-M", 2400, 4096, None, 7), ("MT-M", 2400, mt_F, None, 7),
            ("PFB-M", 2400, 4096, None, 4), ("PFB-M", 12000, pfb_F, None, 4)):
        chunk = adapt_batch(F)[1]
        w = (None if wname is None
             else torch.from_numpy(make_window(wname, N)).to(dev))
        raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        z = torch.complex(raw[:, 0::2].float() - 127.0,
                          raw[:, 1::2].float() - 127.0)
        if kind == "SK-M":
            def kernel():
                return fe.fused_psd_sk_mixed(raw, F, chunk, w, arg)

            def plain():
                return fsk.fused_psd_sk_reference(raw, F, chunk, w, arg)
            zz = z if w is None else z * w
            bound = estimator_bound_ms("SK", F, N, windowed=w is not None)
            cut = fe.SK
        elif kind == "MT-M":
            tp = torch.from_numpy(_session_tapers(N, 4.0, arg)).to(dev)

            def kernel():
                return fe.fused_psd_tapers_mixed(raw, F, chunk, tp)

            def plain():
                return fmt.fused_psd_tapers_reference(raw, F, chunk, tp)
            zz = (z[:, None, :] * tp[None]).reshape(F * arg, N)
            bound = estimator_bound_ms("MT", F, N, K=arg)
            cut = fe.TAPERS
        else:
            h = torch.from_numpy(pfb_prototype(N, arg).reshape(arg, N)).to(
                dev)
            hist = [torch.full((arg - 1, 2 * N), 127, dtype=torch.uint8,
                               device=dev) for _ in range(2)]

            def kernel():
                return fe.fused_psd_pfb_mixed(raw, hist[0], F, chunk, h,
                                              hist[1])

            def plain():
                return fpf.fused_psd_pfb_reference(raw, hist[0], F, chunk, h,
                                                   hist[1])
            zz = fpf.pfb_sums_reference(torch.cat([hist[0], raw]), h, F)
            bound = estimator_bound_ms("PFB", F, N, P=arg)
            cut = fe.PFB

        def mixed():
            return fm.fused_psd_mixed(raw, F, chunk, w)
        got, ref = kernel().double(), plain().double()
        rel = max_rel(got.cpu().numpy(), ref.cpu().numpy())
        check(rel <= UNIFORM_RTOL, f"{kind} N={N} F={F}: {rel} vs plain")
        kd, md = [], []
        for _ in range(2):
            kd.append(device_times_us(kernel))
            md.append(device_times_us(mixed))
        t = {"max_abs": float((got - ref).abs().max()), "bound": bound,
             "call": event_times_us(kernel), "plain": event_times_us(plain),
             "lib": event_times_us(lambda: torch.fft.fft(zz, dim=-1)),
             "lib_device": device_times_us(lambda: torch.fft.fft(zz,
                                                                 dim=-1)),
             "device": min(kd), "m_device": min(md), "host": host_us(kernel)}
        times[(kind, N, F)] = t
        a = fe.kernel_attributes(N, cut, w is not None or cut == fe.TAPERS)
        b_us = 1e3 * bound[0]
        print(f"time mixed estimator {kind} N={N} F={F}"
              f"{f' window={wname}' if wname else ''}"
              f"{f' gate {arg:g}' if kind == 'SK-M' and arg else ''}"
              f"{f' K={arg}' if kind == 'MT-M' else ''}"
              f"{f' P={arg}' if kind == 'PFB-M' else ''} on {card}: kernel "
              f"{t['call']:.1f} us a call, device {kd[0]:.1f}/{kd[1]:.1f} "
              f"us, host {t['host']:.1f} us ({F * N / t['device'] / 1e3:.2f} "
              f"GS/s on the device; {a['registers']} registers, "
              f"{a['spill_bytes']} B spill, {a['blocks_per_sm']} blocks/SM); "
              f"M on the same frames device {md[0]:.1f}/{md[1]:.1f} us, "
              f"kernel/M {t['device'] / t['m_device']:.3f}; plain "
              f"{t['plain']:.1f} us a call; torch.fft.fft of the "
              f"{tuple(zz.shape)} complex64 transforms {t['lib']:.1f} us a "
              f"call (device {t['lib_device']:.1f}); bound {b_us:.2f} us "
              f"({bound[1]}), device/bound {t['device'] / b_us:.1f}x; max "
              f"abs vs plain {t['max_abs']:.4g}, max rel {rel:.3e}")
    print(f"wall: mixed estimator times in {time.perf_counter() - t0:.1f} s")

    # The drives, each on its kernel alone.
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        launches["SK-M man-page"] = drive_man_page(cli, fp, ff, tmp, 1,
                                                   sk=True)
        launches["SK-M excise"] = drive_sk_excise(cli, fp, ff, tmp, N=500,
                                                  key="SK-M")
        for key, argv, N, repeats in (
                ("MT-M", MIXED_MT_ARGV, 2400, 4000),
                ("PFB-M", MIXED_PFB_ARGV, 12000, 400),
                ("SK-M hann", MIXED_SK_HANN_ARGV, 10000, 400)):
            record = os.path.join(tmp, f"{key.split()[0]}_{N}.iq")
            sk_path = os.path.join(tmp, f"hann_{N}.sk")
            extra = [f"--sk-file={sk_path}"] if key == "SK-M hann" else []
            w_np = make_window("hann", N) if key == "SK-M hann" else None

            def golden(key=key, record=record, N=N, repeats=repeats,
                       w_np=w_np):
                raw_np = recorded_frames(record, N)[:repeats]
                if key == "MT-M":
                    pwr = golden_tapers(raw_np, repeats,
                                        _session_tapers(N, 4.0, 7))
                elif key == "PFB-M":
                    pwr = golden_pfb(np.concatenate([np.full(
                        (3, 2 * N), 127, np.uint8), raw_np]), repeats,
                        pfb_prototype(N, 4).reshape(4, N))
                else:
                    pwr = golden_moments(raw_np, repeats, w_np)[0]
                return golden_finalize_linear(np.fft.fftshift(pwr), repeats,
                                              RATE)

            # The tapers' spectral window is 2 NW = 8 bins wide: its peak
            # may fall NW bins from the tone.
            launches[key] = drive(f"mixed estimator {key} -b {N}",
                                  argv + extra + ["--record", record], cli,
                                  fp, ff, key.split()[0], N, golden,
                                  GOLDEN_RTOL,
                                  peak_bins=4 if key == "MT-M" else 1)
            if extra:
                sk_file, sk_err = sk_file_error(
                    sk_path, recorded_frames(record, N)[:repeats], repeats,
                    w_np)
                print(f"e2e mixed estimator {key} SK file: {len(sk_file)} "
                      f"bins, max |SK - float64 golden| {sk_err:.3e} (<= "
                      "1e-4)")
                check(len(sk_file) == N and sk_err <= 1e-4, f"{key} drive: "
                      "SK file")
    print(f"wall: mixed estimator phase in {time.perf_counter() - t0:.1f} s")

    def entry(name, kind, launches_n, replaces):
        t = times[(kind, 2400, 4096)]
        return {"name": name, "route": "cuda",
                "source": CSRC + "fused_psd_mixed_est.cu",
                "replaces": replaces, "launches": launches_n,
                "max_abs_err": t["max_abs"], "ms": t["call"] / 1000.0,
                "plain_ms": t["plain"] / 1000.0, "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": t["lib"] / 1000.0,
                "device_ms": t["device"] / 1000.0,
                "host_ms": t["host"] / 1000.0,
                "mixed_device_ms": t["m_device"] / 1000.0}

    return [entry("fused_psd_sk_mixed (SK-M)", "SK-M",
                  launches["SK-M man-page"] + launches["SK-M excise"]
                  + launches["SK-M hann"],
                  "rtl_power_fftw_tpu/models/kurtosis.py:46"),
            entry("fused_psd_tapers_mixed (MT-M)", "MT-M", launches["MT-M"],
                  "rtl_power_fftw_tpu/models/multitaper.py:60"),
            entry("fused_psd_pfb_mixed (PFB-M)", "PFB-M", launches["PFB-M"],
                  "rtl_power_fftw_tpu/models/pfb.py:48")]


# Phase 20's CLI drives at the chirp-Z bin counts, at the tone source with
# linear output (less their "--record <path>" and SK file): SK at 998
# bins, the multitaper at 998, the PFB at 4094, SK with Hann at 8188 and
# SK under --fft-backend bluestein at 2048. --sk-excise 3 at 998 bins
# (drive_sk_excise's burst stream) is the sixth.
CHIRP_SK_ARGV = ["-f", "100M", "-n", "100", "-b", "998", "-l", "--source",
                 SOURCE]
CHIRP_MT_ARGV = ["-f", "100M", "-n", "4000", "-b", "998", "-l",
                 "--multitaper", "7", "--source", SOURCE]
CHIRP_PFB_ARGV = ["-f", "100M", "-n", "400", "-b", "4094", "-l",
                  "--pfb-taps", "4", "--source", SOURCE]
CHIRP_SK_HANN_ARGV = ["-f", "100M", "-n", "400", "-b", "8188", "-l",
                      "--window-function", "hann", "--source", SOURCE]
CHIRP_SK_BLUESTEIN_ARGV = ["-f", "100M", "-n", "400", "-b", "2048", "-l",
                           "--fft-backend", "bluestein", "--source", SOURCE]


def phase_chirp_estimators(dev, rng, fp, adapt_batch, make_window, cli, ff,
                           card):
    """20. The CLI estimators at the chirp-Z bin counts (SK-B, MT-B, PFB-B
    of ``fused_psd_chirp_est``): their registers, spill and blocks per SM
    beside B's at each M from 64 to 16384; each against its plain version
    and the float64 golden, twice (the same bits), at N = 22, 998 (the SK
    drive's step), 4094 with Hann, 8188 and 2048 (the ``bluestein``
    drive's step), n_valid F, F - 1, 1 and 0 (the PFB as four steps of one
    stream, its history plain's and the virtual rows'), and at each
    drive's own step, full and its last, partial one; SK-B's s1
    ``fused_psd_bluestein``'s output bit for bit in every case (at 2048
    the PSD step under ``--fft-backend bluestein``); the 60-seed yards at
    998 and 8188 (SK's s2 also with Hann); times at 998 F=4096 and at the
    drives' steps beside B in turns on the same frames, ``torch.fft.fft``
    and the bound; six CLI drives, each on its kernel alone. Returns the
    kernels-line entries."""
    import scipy.fft
    from rtl_power_fftw_tpu_torch.models.multitaper import _session_tapers
    from rtl_power_fftw_tpu_torch.models.pfb import pfb_prototype
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_bluestein as fb
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_chirp_est as fc
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_sk as fsk
    t0 = time.perf_counter()
    excise_F = 256   # drive_sk_excise's --frames-per-step
    steps = {}       # each drive: (its kernel, N, F, its last step's n_valid)
    for key, argv, N, repeats in (
            ("SK-B", CHIRP_SK_ARGV, 998, 100),
            ("SK-B excise", None, 998, 4 * excise_F),
            ("MT-B", CHIRP_MT_ARGV, 998, 4000),
            ("PFB-B", CHIRP_PFB_ARGV, 4094, 400),
            ("SK-B hann", CHIRP_SK_HANN_ARGV, 8188, 400),
            ("SK-B bluestein", CHIRP_SK_BLUESTEIN_ARGV, 2048, 400)):
        F = adapt_batch(excise_F if argv is None
                        else drive_frames_per_step(argv))[0]
        steps[key] = (N, F, repeats - (-(-repeats // F) - 1) * F)
    attrs = {}
    for N in (22, 62, 126, 254, 510, 998, 2046, 4094, 8188):
        shape = fb.chirp_launch(N)
        rows = [("B", fb.chirp_attributes(N, False)),
                ("B windowed", fb.chirp_attributes(N, True))]
        for name, cut, w in (("SK-B", fc.SK, False),
                             ("SK-B windowed", fc.SK, True),
                             ("MT-B", fc.TAPERS, True),
                             ("PFB-B", fc.PFB, False)):
            rows.append((name, fc.kernel_attributes(N, cut, w)))
        for name, a in rows:
            attrs[(name, N)] = a
            print(f"occupancy {name} N={N} M={shape.M} on {card}: "
                  f"{a['registers']} registers, {a['spill_bytes']} B spill, "
                  f"{a['static_smem']} + {a['dynamic_smem']} B shared, "
                  f"{a['threads']} threads ({shape.lanes} lanes of "
                  f"{shape.tf}), {a['blocks_per_sm']} blocks/SM")
    reset_counts(fp, ff)
    want = {"SK-B": 0, "MT-B": 0, "PFB-B": 0, "B": 0}

    def sk_case(raw, raw_np, nv, chunk, w, w_np, sigma, label):
        """SK-B twice, B and plain on one step: the same bits twice, s1 B's,
        the gate sk_keep's, within the limit of plain and the golden."""
        got = fc.fused_psd_sk_chirp(raw, nv, chunk, w, sigma)
        again = fc.fused_psd_sk_chirp(raw, nv, chunk, w, sigma)
        b = fb.fused_psd_bluestein(raw, nv, chunk, w)
        ref = fc.sk_chirp_reference(raw, nv, chunk, w, sigma)
        torch.cuda.synchronize()
        want["SK-B"] += 2
        want["B"] += 1
        check(torch.equal(got, again), f"SK-B {label}: not deterministic")
        check(torch.equal(got[0], b), f"SK-B {label}: s1 is not B's")
        got_np, ref_np = got.cpu().numpy(), ref.cpu().numpy()
        gate = ""
        if sigma > 0.0:
            keep = fsk.sk_keep(got[0].cpu(), got[1].cpu(), float(nv),
                               sigma).numpy()
            check(np.array_equal(got_np[3], nv * keep)
                  and np.array_equal(got_np[2], got_np[0] * keep),
                  f"SK-B {label}: the gate epilogue is not sk_keep's")
            gate = (f"; gate {sigma:g}: {int(keep.sum())} of "
                    f"{got_np.shape[1]} kept (plain "
                    f"{int((ref_np[3] > 0).sum())})")
        if nv == 0:
            check(not got_np[:2].any(), f"SK-B {label}: rows of no frame "
                  "are not 0")
            return {}, gate
        g1, g2 = golden_moments(raw_np, nv, w_np)
        return {"SK-B s1": est_errors(got_np[0], ref_np[0], g1, nv),
                "SK-B s2": est_errors(got_np[1], ref_np[1], g2, nv)}, gate

    def mt_case(raw, raw_np, nv, chunk, tp, tp_np, label):
        mt = fc.fused_psd_tapers_chirp(raw, nv, chunk, tp)
        again = fc.fused_psd_tapers_chirp(raw, nv, chunk, tp)
        ref = fc.tapers_chirp_reference(raw, nv, chunk, tp)
        torch.cuda.synchronize()
        want["MT-B"] += 2
        check(torch.equal(mt, again), f"MT-B {label}: not deterministic")
        mt_np = mt.cpu().numpy()
        if nv == 0:
            check(not mt_np.any(), f"MT-B {label}: rows of no frame are "
                  "not 0")
            return {}
        return {f"MT-B K={tp.shape[0]}": est_errors(
            mt_np, ref.cpu().numpy(), golden_tapers(raw_np, nv, tp_np), nv)}

    def report(label, errs, gate=""):
        print(f"chirp estimators {label}: the same bits twice"
              + (", SK-B's s1 B's" if any("SK" in k for k in errs) else "")
              + "".join(f"; {k} {e[3]} vs plain {e[0]:.3e}, vs float64 "
                        f"golden {e[1]:.3e} (<= {e[2]:.3g})"
                        for k, e in errs.items()) + gate)
        check(all(e[0] <= e[2] and e[1] <= e[2] for e in errs.values()),
              f"chirp estimators {label}: {errs}")

    # Each kernel against plain and the float64 golden, twice.
    for N, F, wname, sigma in ((998, steps["SK-B"][1], None, 3.0),
                               (22, 256, None, 0.0),
                               (4094, steps["PFB-B"][1], "hann", 0.0),
                               (8188, steps["SK-B hann"][1], None, 3.0),
                               (2048, steps["SK-B bluestein"][1], None,
                                0.0)):
        chunk = adapt_batch(F)[1]
        w_np = None if wname is None else make_window(wname, N)
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        tp_np = _session_tapers(N, 4.0, 7)
        tp = torch.from_numpy(tp_np).to(dev)
        for nv in (F, F - 1, 1, 0):
            label = f"N={N} F={F} chunk={chunk} n_valid={nv} window={wname}"
            errs, gate = sk_case(raw, raw_np, nv, chunk, w, w_np, sigma,
                                 label)
            errs.update(mt_case(raw, raw_np, nv, chunk, tp, tp_np, label))
            report(label, errs, gate)
        # PFB-B: four steps of one stream (n_valid F, 1, F - 1, 0), the
        # history carried on the card; P = 16 at 998 bins too, 1 at 22.
        for P in (4,) + ((16,) if N == 998 else (1,) if N == 22 else ()):
            h_np = pfb_prototype(N, P).reshape(P, N)
            h = torch.from_numpy(h_np).to(dev)
            hist = [torch.empty((P - 1, 2 * N), dtype=torch.uint8,
                                device=dev) for _ in range(2)]
            hist_p = [torch.empty((P - 1, 2 * N), dtype=torch.uint8)
                      for _ in range(2)]
            virtual = np.full((P - 1, 2 * N), 127, np.uint8)
            for step, nv in enumerate((F, 1, F - 1, 0)):
                slot_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
                slot = torch.from_numpy(slot_np)
                got = fc.fused_psd_pfb_chirp(slot.to(dev), hist[0], nv,
                                             chunk, h, hist[1],
                                             fresh=step == 0)
                ref = fc.pfb_chirp_reference(slot, hist_p[0], nv, chunk,
                                             h.cpu(), hist_p[1],
                                             fresh=step == 0)
                torch.cuda.synchronize()
                want["PFB-B"] += 1
                virtual = np.concatenate([virtual, slot_np])
                gold = golden_pfb(virtual, nv, h_np)
                virtual = virtual[nv:nv + P - 1]
                same_hist = (torch.equal(hist[1].cpu(), hist_p[1])
                             and np.array_equal(hist[1].cpu().numpy(),
                                                virtual))
                got_np = got.cpu().numpy()
                if nv == 0:
                    e = (0.0, 0.0, 0.0, "zero")
                    check(not got_np.any(), f"PFB-B N={N} P={P}: no frame")
                else:
                    e = est_errors(got_np, ref.numpy(), gold, nv)
                print(f"chirp estimators PFB-B N={N} F={F} P={P} step "
                      f"{step} n_valid={nv}: {e[3]} vs plain {e[0]:.3e}, vs "
                      f"float64 golden {e[1]:.3e} (<= {e[2]:.3g}); history "
                      f"plain's and rows n_valid .. n_valid + P - 2: "
                      f"{same_hist}")
                check(e[0] <= e[2] and e[1] <= e[2] and same_hist,
                      f"PFB-B N={N} P={P} step {step}")
                hist.reverse()
                hist_p.reverse()
            spare = torch.empty_like(hist[0])
            a = fc.fused_psd_pfb_chirp(raw, hist[0], F, chunk, h, hist[1])
            b = fc.fused_psd_pfb_chirp(raw, hist[0], F, chunk, h, spare)
            torch.cuda.synchronize()
            want["PFB-B"] += 2
            check(torch.equal(a, b) and torch.equal(hist[1], spare),
                  f"PFB-B N={N} P={P}: not deterministic")
    # Each drive's own step, full and its last, partial one, on its own
    # kernel (the PFB from a reset history, as a hop starts).
    for key, (N, F, last) in steps.items():
        chunk = adapt_batch(F)[1]
        w_np = make_window("hann", N) if key == "SK-B hann" else None
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        for nv in sorted({F, last}, reverse=True):
            label = f"{key} drive step N={N} F={F} n_valid={nv}"
            if key.startswith("SK-B"):
                errs, gate = sk_case(raw, raw_np, nv, chunk, w, w_np,
                                     3.0 if key == "SK-B excise" else 0.0,
                                     label)
            elif key == "MT-B":
                tp_np = _session_tapers(N, 4.0, 7)
                errs, gate = mt_case(raw, raw_np, nv, chunk,
                                     torch.from_numpy(tp_np).to(dev), tp_np,
                                     label), ""
            else:
                h_np = pfb_prototype(N, 4).reshape(4, N)
                h = torch.from_numpy(h_np).to(dev)
                hist = [torch.empty((3, 2 * N), dtype=torch.uint8,
                                    device=dev) for _ in range(3)]
                hist_p = [torch.empty((3, 2 * N), dtype=torch.uint8)
                          for _ in range(2)]
                got = fc.fused_psd_pfb_chirp(raw, hist[0], nv, chunk, h,
                                             hist[1], fresh=True)
                again = fc.fused_psd_pfb_chirp(raw, hist[0], nv, chunk, h,
                                               hist[2])
                ref = fc.pfb_chirp_reference(raw.cpu(), hist_p[0], nv,
                                             chunk, h.cpu(), hist_p[1],
                                             fresh=True)
                torch.cuda.synchronize()
                want["PFB-B"] += 2
                check(torch.equal(got, again)
                      and torch.equal(hist[1], hist[2])
                      and torch.equal(hist[1].cpu(), hist_p[1]),
                      f"PFB-B {label}: not deterministic or not plain's "
                      "history")
                virtual = np.concatenate([np.full((3, 2 * N), 127,
                                                  np.uint8), raw_np])
                errs, gate = {"PFB-B P=4": est_errors(
                    got.cpu().numpy(), ref.numpy(),
                    golden_pfb(virtual, nv, h_np), nv)}, ""
            report(label, errs, gate)
    counts = launch_counts(fp, ff)
    check(all(counts[k] == v for k, v in want.items())
          and counts["plain"] == 0 and not any(
              v for k, v in counts.items() if k not in want),
          f"chirp estimator launch counts: {counts}, expected {want}")
    print(f"wall: chirp estimator checks in {time.perf_counter() - t0:.1f} s")

    # The yards: 60 seeds of 35 dB tones at 998 (64 frames) and 8188 bins
    # (16 frames: the float64 golden of 7 tapers there takes ~0.1 s a seed).
    def f32_class(z):
        Xc = scipy.fft.fft(z.astype(np.complex64), axis=-1)
        return (Xc.real.astype(np.float64) ** 2
                + Xc.imag.astype(np.float64) ** 2)

    reset_counts(fp, ff)
    for N, F in ((998, 64), (8188, 16)):
        for wname in (None, "hann"):
            w_np = None if wname is None else make_window(wname, N)
            w = None if w_np is None else torch.from_numpy(w_np).to(dev)
            wz = 1.0 if w_np is None else w_np.astype(np.float64)
            estimator_yard(
                f"SK-B s2{' hann' if wname else ''}",
                lambda raw_np, w=w, F=F: fc.fused_psd_sk_chirp(
                    torch.from_numpy(raw_np).to(dev), F, F, w)[1].cpu()
                .numpy(),
                lambda raw_np, w_np=w_np, F=F: golden_moments(
                    raw_np, F, w_np)[1],
                lambda raw_np, wz=wz: (f32_class(dequant64(raw_np) * wz)
                                       ** 2).sum(0),
                N, F, 20000 + N + (wname is not None))
        tp_np = _session_tapers(N, 4.0, 7)
        tp = torch.from_numpy(tp_np).to(dev)
        estimator_yard(
            "MT-B K=7",
            lambda raw_np, tp=tp, F=F: fc.fused_psd_tapers_chirp(
                torch.from_numpy(raw_np).to(dev), F, F, tp).cpu().numpy(),
            lambda raw_np, tp_np=tp_np, F=F: golden_tapers(raw_np, F, tp_np),
            lambda raw_np, tp_np=tp_np: f32_class(
                dequant64(raw_np)[:, None, :]
                * tp_np.astype(np.float64)[None]).mean(1).sum(0),
            N, F, 20100 + N)
        P = 4
        h_np = pfb_prototype(N, P).reshape(P, N)
        h = torch.from_numpy(h_np).to(dev)
        hist = [torch.empty((P - 1, 2 * N), dtype=torch.uint8, device=dev)
                for _ in range(2)]

        def pfb_virtual(raw_np, N=N, P=P):
            return np.concatenate([np.full((P - 1, 2 * N), 127, np.uint8),
                                   raw_np])

        def pfb_class(raw_np, h_np=h_np, pfb_virtual=pfb_virtual, F=F):
            sums = fpf.pfb_sums_reference(
                torch.from_numpy(pfb_virtual(raw_np)),
                torch.from_numpy(h_np), F).numpy()
            return f32_class(sums.astype(np.complex128)).sum(0)

        estimator_yard(
            "PFB-B P=4",
            lambda raw_np, h=h, hist=hist, F=F: fc.fused_psd_pfb_chirp(
                torch.from_numpy(raw_np).to(dev), hist[0], F, F, h, hist[1],
                fresh=True).cpu().numpy(),
            lambda raw_np, h_np=h_np, pfb_virtual=pfb_virtual, F=F:
            golden_pfb(pfb_virtual(raw_np), F, h_np),
            pfb_class, N, F, 20200 + N)
    counts = launch_counts(fp, ff)
    check(counts["SK-B"] == 240 and counts["MT-B"] == counts["PFB-B"] == 120
          and counts["plain"] == 0, f"chirp estimator yards' launches: "
          f"{counts}")
    print(f"wall: chirp estimator yards in {time.perf_counter() - t0:.1f} s")

    # Times (PERF.md states their prediction): at 998 F=4096 (B's timed
    # shape) and at each drive's own step, a call (CUDA events), the
    # device's part (twice, in turns with B's on the same frames), the
    # wrapper's host part, the plain version and torch.fft.fft on the same
    # transforms (F frames; F K tapered frames; F polyphase sums), and the
    # bound.
    times = {}
    for kind, N, F, wname, arg in (
            ("SK-B", 998, 4096, None, 0.0),
            ("SK-B", 998, steps["SK-B"][1], None, 0.0),
            ("SK-B", 998, excise_F, None, 3.0),
            ("SK-B", 8188, steps["SK-B hann"][1], "hann", 0.0),
            ("SK-B", 2048, steps["SK-B bluestein"][1], None, 0.0),
            ("MT-B", 998, 4096, None, 7),
            ("MT-B", 998, steps["MT-B"][1], None, 7),
            ("PFB-B", 998, 4096, None, 4),
            ("PFB-B", 4094, steps["PFB-B"][1], None, 4)):
        chunk = adapt_batch(F)[1]
        w = (None if wname is None
             else torch.from_numpy(make_window(wname, N)).to(dev))
        raw = torch.from_numpy(rng.integers(0, 256, (F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        z = torch.complex(raw[:, 0::2].float() - 127.0,
                          raw[:, 1::2].float() - 127.0)
        if kind == "SK-B":
            def kernel():
                return fc.fused_psd_sk_chirp(raw, F, chunk, w, arg)

            def plain():
                return fc.sk_chirp_reference(raw, F, chunk, w, arg)
            zz = z if w is None else z * w
            bound = estimator_bound_ms("SK", F, N, windowed=w is not None)
            cut = fc.SK
        elif kind == "MT-B":
            tp = torch.from_numpy(_session_tapers(N, 4.0, arg)).to(dev)

            def kernel():
                return fc.fused_psd_tapers_chirp(raw, F, chunk, tp)

            def plain():
                return fc.tapers_chirp_reference(raw, F, chunk, tp)
            zz = (z[:, None, :] * tp[None]).reshape(F * arg, N)
            bound = estimator_bound_ms("MT", F, N, K=arg)
            cut = fc.TAPERS
        else:
            h = torch.from_numpy(pfb_prototype(N, arg).reshape(arg, N)).to(
                dev)
            hist = [torch.full((arg - 1, 2 * N), 127, dtype=torch.uint8,
                               device=dev) for _ in range(2)]

            def kernel():
                return fc.fused_psd_pfb_chirp(raw, hist[0], F, chunk, h,
                                              hist[1])

            def plain():
                return fc.pfb_chirp_reference(raw, hist[0], F, chunk, h,
                                              hist[1])
            zz = fpf.pfb_sums_reference(torch.cat([hist[0], raw]), h, F)
            bound = estimator_bound_ms("PFB", F, N, P=arg)
            cut = fc.PFB

        def chirp():
            return fb.fused_psd_bluestein(raw, F, chunk, w)
        got, ref = kernel().double(), plain().double()
        rel = max_rel(got.cpu().numpy(), ref.cpu().numpy())
        check(rel <= UNIFORM_RTOL, f"{kind} N={N} F={F}: {rel} vs plain")
        kd, bd = [], []
        for _ in range(2):
            kd.append(device_times_us(kernel))
            bd.append(device_times_us(chirp))
        t = {"max_abs": float((got - ref).abs().max()), "bound": bound,
             "call": event_times_us(kernel), "plain": event_times_us(plain),
             "lib": event_times_us(lambda: torch.fft.fft(zz, dim=-1)),
             "lib_device": device_times_us(lambda: torch.fft.fft(zz,
                                                                 dim=-1)),
             "device": min(kd), "b_device": min(bd), "host": host_us(kernel)}
        times[(kind, N, F)] = t
        a = fc.kernel_attributes(N, cut, w is not None or cut == fc.TAPERS)
        b_us = 1e3 * bound[0]
        print(f"time chirp estimator {kind} N={N} F={F}"
              f"{f' window={wname}' if wname else ''}"
              f"{f' gate {arg:g}' if kind == 'SK-B' and arg else ''}"
              f"{f' K={arg}' if kind == 'MT-B' else ''}"
              f"{f' P={arg}' if kind == 'PFB-B' else ''} on {card}: kernel "
              f"{t['call']:.1f} us a call, device {kd[0]:.1f}/{kd[1]:.1f} "
              f"us, host {t['host']:.1f} us ({F * N / t['device'] / 1e3:.2f} "
              f"GS/s on the device; {a['registers']} registers, "
              f"{a['spill_bytes']} B spill, {a['blocks_per_sm']} blocks/SM); "
              f"B on the same frames device {bd[0]:.1f}/{bd[1]:.1f} us, "
              f"kernel/B {t['device'] / t['b_device']:.3f}; plain "
              f"{t['plain']:.1f} us a call; torch.fft.fft of the "
              f"{tuple(zz.shape)} complex64 transforms {t['lib']:.1f} us a "
              f"call (device {t['lib_device']:.1f}); bound {b_us:.2f} us "
              f"({bound[1]}), device/bound {t['device'] / b_us:.1f}x; max "
              f"abs vs plain {t['max_abs']:.4g}, max rel {rel:.3e}")
    print(f"wall: chirp estimator times in {time.perf_counter() - t0:.1f} s")

    # The drives, each on its kernel alone.
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        launches["SK-B excise"] = drive_sk_excise(cli, fp, ff, tmp, N=998,
                                                  key="SK-B")
        for key, argv in (("SK-B", CHIRP_SK_ARGV), ("MT-B", CHIRP_MT_ARGV),
                          ("PFB-B", CHIRP_PFB_ARGV),
                          ("SK-B hann", CHIRP_SK_HANN_ARGV),
                          ("SK-B bluestein", CHIRP_SK_BLUESTEIN_ARGV)):
            N = steps[key][0]
            repeats = int(argv[argv.index("-n") + 1])
            record = os.path.join(tmp, f"{key.replace(' ', '_')}_{N}.iq")
            sk_path = os.path.join(tmp, f"{key.replace(' ', '_')}_{N}.sk")
            sk = key.startswith("SK")
            extra = [f"--sk-file={sk_path}"] if sk else []
            w_np = make_window("hann", N) if key == "SK-B hann" else None

            def golden(key=key, record=record, N=N, repeats=repeats,
                       w_np=w_np):
                raw_np = recorded_frames(record, N)[:repeats]
                if key == "MT-B":
                    pwr = golden_tapers(raw_np, repeats,
                                        _session_tapers(N, 4.0, 7))
                elif key == "PFB-B":
                    pwr = golden_pfb(np.concatenate([np.full(
                        (3, 2 * N), 127, np.uint8), raw_np]), repeats,
                        pfb_prototype(N, 4).reshape(4, N))
                else:
                    pwr = golden_moments(raw_np, repeats, w_np)[0]
                return golden_finalize_linear(np.fft.fftshift(pwr), repeats,
                                              RATE)

            # The tapers' spectral window is 2 NW = 8 bins wide: its peak
            # may fall NW bins from the tone.
            launches[key] = drive(f"chirp estimator {key} -b {N}",
                                  argv + extra + ["--record", record], cli,
                                  fp, ff, key.split()[0], N, golden,
                                  GOLDEN_RTOL,
                                  peak_bins=4 if key == "MT-B" else 1)
            if sk:
                sk_file, sk_err = sk_file_error(
                    sk_path, recorded_frames(record, N)[:repeats], repeats,
                    w_np)
                print(f"e2e chirp estimator {key} SK file: {len(sk_file)} "
                      f"bins, max |SK - float64 golden| {sk_err:.3e} (<= "
                      "1e-4)")
                check(len(sk_file) == N and sk_err <= 1e-4, f"{key} drive: "
                      "SK file")
    print(f"wall: chirp estimator phase in {time.perf_counter() - t0:.1f} s")

    def entry(name, kind, launches_n, replaces):
        t = times[(kind, 998, 4096)]
        return {"name": name, "route": "cuda",
                "source": CSRC + "fused_psd_chirp_est.cu",
                "replaces": replaces, "launches": launches_n,
                "max_abs_err": t["max_abs"], "ms": t["call"] / 1000.0,
                "plain_ms": t["plain"] / 1000.0, "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": t["lib"] / 1000.0,
                "device_ms": t["device"] / 1000.0,
                "host_ms": t["host"] / 1000.0,
                "chirp_device_ms": t["b_device"] / 1000.0}

    return [entry("fused_psd_sk_chirp (SK-B)", "SK-B",
                  sum(launches[k] for k in launches if k.startswith("SK")),
                  "rtl_power_fftw_tpu/models/kurtosis.py:46"),
            entry("fused_psd_tapers_chirp (MT-B)", "MT-B", launches["MT-B"],
                  "rtl_power_fftw_tpu/models/multitaper.py:60"),
            entry("fused_psd_pfb_chirp (PFB-B)", "PFB-B", launches["PFB-B"],
                  "rtl_power_fftw_tpu/models/pfb.py:48")]



# Phase 21's CLI drives over --streams at the awkward bin counts (the tone
# source, linear output), less their "--record <path>" and SK files: the
# man-page scan over two streams with --sk-file (drive_man_page), and
# these; the burst drive is drive_streams_sk_excise at 998 bins over 2.
AWK_PFB_ARGV = ["-f", "100M", "-n", "400", "-b", "500", "-l", "--streams",
                "2", "--pfb-taps", "4", "--source", SOURCE]
AWK_SK998_ARGV = ["-f", "100M", "-n", "100", "-b", "998", "-l",
                  "--streams", "2", "--source", SOURCE]
AWK_MT_ARGV = ["-f", "100M", "-n", "1000", "-b", "2400", "-l", "--streams",
               "4", "--multitaper", "7", "--source", SOURCE]
AWK_SK_BLUESTEIN_ARGV = ["-f", "100M", "-n", "400", "-b", "2048", "-l",
                         "--streams", "2", "--fft-backend", "bluestein",
                         "--source", SOURCE]
AWK_C5_ARGV = ["-f", "100M", "-n", "1024", "-b", "500", "--streams",
               str(C5_STREAMS), "--frames-per-step", "256", "-l", "--source",
               SOURCE]
AWK_MT998_ARGV = ["-f", "100M", "-n", "400", "-b", "998", "-l", "--streams",
                  "2", "--multitaper", "7", "--source", SOURCE]
AWK_PFB4094_ARGV = ["-f", "100M", "-n", "200", "-b", "4094", "-l",
                    "--streams", "2", "--pfb-taps", "4", "--source", SOURCE]


# The seeds of phases 22 and 23's yards: 60 until phase 24 joined the
# script, halved to keep the whole run inside its time limit (each form is
# still held against its plain version and the golden at every shape).
LARGE_EST_YARD_SEEDS = 30
# Phase 21 holds a stream of fewer than 64 frames as phases 19 and 20 hold
# the one-stream forms, whose rows each stream's are bit for bit: within
# its limit or this many times plain's own error over the mean, where
# that is larger (est_errors).
FEW_PLAIN = 3.0


def drive_awkward_streams(label, argv, key, kind, cli, fp, ff, tmp) -> int:
    """One drive over ``--streams`` through ``cli.main`` (drive()): the
    streams form ``key`` alone, the spectrum against the mean of the
    per-stream float64 goldens of the recorded streams (``kind`` SK: their
    s1; MT: K = 7 tapers; PFB: P = 4 from reset histories), and for SK the
    SK file (M = S repeats) within 1e-4 of the float64 SK of every
    stream's frames together. Returns the drive's launches of ``key``."""
    from rtl_power_fftw_tpu_torch.models.multitaper import _session_tapers
    from rtl_power_fftw_tpu_torch.models.pfb import pfb_prototype
    N = int(argv[argv.index("-b") + 1])
    repeats = int(argv[argv.index("-n") + 1])
    S = int(argv[argv.index("--streams") + 1])
    tag = re.sub(r"\W+", "_", label)
    record = os.path.join(tmp, f"{tag}.iq")
    sk_path = os.path.join(tmp, f"{tag}.sk")
    extra = [f"--sk-file={sk_path}"] if kind == "SK" else []

    def frames():
        return [recorded_frames(f"{record}.s{s}", N)[:repeats]
                for s in range(S)]

    def golden():
        if kind == "MT":
            tp = _session_tapers(N, 4.0, 7)
            pwr = sum(golden_tapers(x, repeats, tp) for x in frames())
        elif kind == "PFB":
            h = pfb_prototype(N, 4).reshape(4, N)
            warm = np.full((3, 2 * N), 127, np.uint8)
            pwr = sum(golden_pfb(np.concatenate([warm, x]), repeats, h)
                      for x in frames())
        else:
            pwr = sum(golden_moments(x, repeats)[0] for x in frames())
        return golden_finalize_linear(np.fft.fftshift(pwr), S * repeats,
                                      RATE)

    launches = drive(label, argv + extra + ["--record", record], cli, fp,
                     ff, key, N, golden, GOLDEN_RTOL, streams=S,
                     peak_bins=4 if kind == "MT" else 1)
    if kind == "SK":
        sk_file, sk_err = sk_file_error(sk_path, np.concatenate(frames()),
                                        S * repeats)
        print(f"e2e {label} SK file: {len(sk_file)} bins, '# Spectra "
              f"accumulated: {S * repeats}' (S x repeats), max |SK - "
              f"float64 golden| {sk_err:.3e} (<= 1e-4)")
        check(len(sk_file) == N and sk_err <= 1e-4, f"{label}: SK file")
    return launches


def phase_awkward_streams(dev, rng, fp, adapt_batch, make_window, cli, ff,
                          card):
    """21. The CLI estimators over ``--streams`` at the awkward bin counts
    (the streams forms SK-M-S, MT-M-S, PFB-M-S of ``fused_psd_mixed_est``
    and SK-B-S, MT-B-S, PFB-B-S of ``fused_psd_chirp_est``): each form's
    registers, spill, shared bytes and blocks per SM beside its one-stream
    form's; each against its plain version and the per-stream float64
    golden (``hold_streams``), twice (the same bits), at S = 2 and 16 with
    uneven counts, SK with and without Hann and the gate; SK's s1 the PSD
    streams entry's rows (M-S, B-S) bit for bit, each stream's rows the
    one-stream form's on the same groups, the gate on each stream's own
    count (a burst in one stream gates only that stream's bin); the PFB's
    histories over three steps and a reset against plain's and the
    one-stream form's; the same holds at each drive's own step (S, F),
    every frame valid and its last step's count among uneven ones, the
    PFB over both steps; 60-seed yards at 500 and 998 with S = 2; times at
    S = 2, F = 2048 (2400 mixed, 998 chirp-Z) beside two one-stream calls,
    M-S or B-S, ``torch.fft.fft`` and the bound, and at the drives' steps;
    nine drives, each on its streams form alone. Returns the kernels-line
    entries."""
    from rtl_power_fftw_tpu_torch.models.multitaper import _session_tapers
    from rtl_power_fftw_tpu_torch.models.pfb import pfb_prototype
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_bluestein as fb
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_chirp_est as fc
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed as fm
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_mixed_est as fe
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_sk as fsk
    t0 = time.perf_counter()
    fams = {
        "M": dict(mod=fe, sk=fe.fused_psd_sk_mixed_streams,
                  mt=fe.fused_psd_tapers_mixed_streams,
                  pfb=fe.fused_psd_pfb_mixed_streams,
                  sk1=fe.fused_psd_sk_mixed, mt1=fe.fused_psd_tapers_mixed,
                  pfb1=fe.fused_psd_pfb_mixed,
                  psd=fm.fused_psd_mixed_streams,
                  sk_ref=fe.fused_psd_sk_streams_reference,
                  mt_ref=fe.fused_psd_tapers_streams_reference,
                  pfb_ref=fe.fused_psd_pfb_streams_reference,
                  psd_key="M streams"),
        "B": dict(mod=fc, sk=fc.fused_psd_sk_chirp_streams,
                  mt=fc.fused_psd_tapers_chirp_streams,
                  pfb=fc.fused_psd_pfb_chirp_streams,
                  sk1=fc.fused_psd_sk_chirp, mt1=fc.fused_psd_tapers_chirp,
                  pfb1=fc.fused_psd_pfb_chirp,
                  psd=fb.fused_psd_bluestein_streams,
                  sk_ref=fc.sk_chirp_streams_reference,
                  mt_ref=fc.tapers_chirp_streams_reference,
                  pfb_ref=fc.pfb_chirp_streams_reference,
                  psd_key="B streams")}

    # Registers, spill, shared memory and residency beside the one-stream
    # forms'.
    for fam, sizes in (("M", (500, 2400, 12000, 16000)),
                       ("B", (998, 4094, 8188))):
        mod = fams[fam]["mod"]
        for N in sizes:
            for name, cut, w in (("SK", mod.SK, False),
                                 ("SK windowed", mod.SK, True),
                                 ("MT", mod.TAPERS, True),
                                 ("PFB", mod.PFB, False)):
                a = mod.kernel_attributes(N, cut, w)
                b = mod.kernel_attributes(N, cut, w, streams=True)
                print(f"occupancy {name.split()[0]}-{fam}-S"
                      f"{' windowed' if w and cut == mod.SK else ''} N={N} "
                      f"on {card}: {b['registers']} registers, "
                      f"{b['spill_bytes']} B spill, {b['static_smem']} + "
                      f"{b['dynamic_smem']} B shared, {b['threads']} "
                      f"threads, {b['blocks_per_sm']} blocks/SM; the "
                      f"one-stream form {a['registers']} registers, "
                      f"{a['spill_bytes']} B spill, {a['static_smem']} + "
                      f"{a['dynamic_smem']} B shared, {a['blocks_per_sm']} "
                      f"blocks/SM")
    reset_counts(fp, ff)
    want = {k: 0 for k in ("SK-M-S", "MT-M-S", "PFB-M-S", "SK-B-S",
                           "MT-B-S", "PFB-B-S", "SK-M", "MT-M", "PFB-M",
                           "SK-B", "MT-B", "PFB-B", "M streams",
                           "B streams")}

    def hold_sk(fam, raw, raw_np, counts, chunk, w, w_np, sigmas, head):
        """SK-fam-S on ``raw`` at ``counts``, for each gate of ``sigmas``:
        twice, against plain and the per-stream golden, s1 the PSD streams
        entry's rows, each stream the one-stream form's on the same
        groups, the gate each stream's own sk_keep."""
        f = fams[fam]
        S, F, N = raw.shape[0], raw.shape[1], raw.shape[2] // 2
        nv = torch.from_numpy(counts).to(dev)
        gold = [golden_moments(raw_np[s], int(c), w_np)
                for s, c in enumerate(counts)]
        sk_group = f["mod"].sk_group(S * F, chunk, N, w is not None,
                                     dev.index)
        for sigma in sigmas:
            got = f["sk"](raw, nv, chunk, w, sigma)
            again = f["sk"](raw, nv, chunk, w, sigma)
            psd = f["psd"](raw, nv, chunk, w)
            ref = f["sk_ref"](raw, nv, chunk, w, sigma)
            singles = [f["sk1"](raw[s], int(c), chunk, w, sigma,
                                group=sk_group)
                       for s, c in enumerate(counts)]
            torch.cuda.synchronize()
            want[f"SK-{fam}-S"] += 2
            want[f["psd_key"]] += 1
            want[f"SK-{fam}"] += S
            label = f"SK-{fam}-S {head} gate={sigma:g}"
            check(torch.equal(got, again), f"{label}: not deterministic")
            check(torch.equal(got[:, 0], psd),
                  f"{label}: s1 is not {f['psd_key']}'s rows")
            check(all(torch.equal(got[s], singles[s]) for s in range(S)),
                  f"{label}: a stream is not the one-stream form's")
            g_np, r_np = got.cpu().numpy(), ref.cpu().numpy()
            line = [f"s{i + 1}: " + hold_streams(
                f"{label} s{i + 1}", g_np[:, i], r_np[:, i],
                np.stack([g[i] for g in gold]), counts,
                (i + 1) * GOLDEN_RTOL, FEW_PLAIN) for i in range(2)]
            if sigma > 0.0:
                M = torch.from_numpy(counts.astype(np.float32))[:, None]
                keep = fsk.sk_keep(got[:, 0].cpu(), got[:, 1].cpu(), M,
                                   sigma).numpy()
                check(np.array_equal(g_np[:, 3], M.numpy() * keep)
                      and np.array_equal(g_np[:, 2], g_np[:, 0] * keep),
                      f"{label}: the gate is not each stream's sk_keep")
                line.append(f"gate {int(keep.sum())} of {S * N} "
                            "stream-bins kept, each stream's sk_keep")
            print(f"{label} ({sk_group} frames a block): the same bits "
                  f"twice, s1 {f['psd_key']}'s rows, each stream the "
                  f"one-stream form's; " + "; ".join(line))

    def hold_mt(fam, raw, raw_np, counts, chunk, head, K=7):
        """MT-fam-S on ``raw`` at ``counts``: twice, against plain and the
        per-stream golden, each stream the one-stream form's on the same
        groups."""
        f = fams[fam]
        S, F, N = raw.shape[0], raw.shape[1], raw.shape[2] // 2
        nv = torch.from_numpy(counts).to(dev)
        tp_np = _session_tapers(N, 4.0 if N > 30 else 2.0, K)
        tp = torch.from_numpy(tp_np).to(dev)
        mt_group = f["mod"].tapers_group(S * F, chunk, N, K, dev.index,
                                         streams=True)
        got = f["mt"](raw, nv, chunk, tp)
        again = f["mt"](raw, nv, chunk, tp)
        ref = f["mt_ref"](raw, nv, chunk, tp)
        singles = [f["mt1"](raw[s], int(c), chunk, tp, group=mt_group)
                   for s, c in enumerate(counts)]
        torch.cuda.synchronize()
        want[f"MT-{fam}-S"] += 2
        want[f"MT-{fam}"] += S
        label = f"MT-{fam}-S {head} K={K}"
        check(torch.equal(got, again), f"{label}: not deterministic")
        check(all(torch.equal(got[s], singles[s]) for s in range(S)),
              f"{label}: a stream is not the one-stream form's")
        gold_mt = np.stack([golden_tapers(raw_np[s], int(c), tp_np)
                            for s, c in enumerate(counts)])
        print(f"{label} ({mt_group} frames a block): the same bits twice, "
              f"each stream the one-stream form's; " + hold_streams(
                  label, got.cpu().numpy(), ref.cpu().numpy(), gold_mt,
                  counts, plain_factor=FEW_PLAIN))

    def hold_pfb(fam, N, S, F, chunk, schedule, resets, head, P=4):
        """PFB-fam-S over the steps of ``schedule`` (each step's counts;
        fresh histories at the steps of ``resets``), new frames each step:
        twice, the histories on the card plain's and the virtual rows' bit
        for bit, each stream's rows and history the one-stream form's,
        against plain and the per-stream golden."""
        f = fams[fam]
        h_np = pfb_prototype(N, P).reshape(P, N)
        h = torch.from_numpy(h_np).to(dev)
        pfb_group = f["mod"].pfb_group(S * F, chunk, N, dev.index,
                                       streams=True)
        hist = [torch.empty((S, P - 1, 2 * N), dtype=torch.uint8,
                            device=dev) for _ in range(3)]
        hist_p = [torch.empty((S, P - 1, 2 * N), dtype=torch.uint8)
                  for _ in range(2)]
        hs = [[torch.empty((P - 1, 2 * N), dtype=torch.uint8, device=dev)
               for _ in range(2)] for _ in range(S)]
        virtual = [None] * S
        for k, cnt in enumerate(schedule):
            fresh = k in resets
            step_np = rng.integers(0, 256, (S, F, 2 * N), dtype=np.uint8)
            step = torch.from_numpy(step_np).to(dev)
            c_dev = torch.from_numpy(cnt).to(dev)
            got = f["pfb"](step, hist[0], c_dev, chunk, h, hist[1],
                           fresh=fresh)
            again = f["pfb"](step, hist[0], c_dev, chunk, h, hist[2])
            ref = f["pfb_ref"](step.cpu(), hist_p[0], torch.from_numpy(cnt),
                               chunk, h.cpu(), hist_p[1], fresh=fresh)
            singles = [f["pfb1"](step[s], hs[s][0], int(c), chunk, h,
                                 hs[s][1], fresh=fresh, group=pfb_group)
                       for s, c in enumerate(cnt)]
            torch.cuda.synchronize()
            want[f"PFB-{fam}-S"] += 2
            want[f"PFB-{fam}"] += S
            gold_p = []
            for s, c in enumerate(cnt):
                if fresh:
                    virtual[s] = np.full((P - 1, 2 * N), 127, np.uint8)
                v = np.concatenate([virtual[s], step_np[s]])
                gold_p.append(golden_pfb(v, int(c), h_np))
                virtual[s] = v[int(c):int(c) + P - 1]
            same_hist = (torch.equal(hist[1], hist[2])
                         and torch.equal(hist[1].cpu(), hist_p[1])
                         and np.array_equal(hist[1].cpu().numpy(),
                                            np.stack(virtual)))
            same_one = all(torch.equal(got[s], singles[s])
                           and torch.equal(hist[1][s], hs[s][1])
                           for s in range(S))
            label = (f"PFB-{fam}-S {head} P={P} step {k}"
                     f"{' (a reset)' if fresh and k else ''}")
            check(torch.equal(got, again) and same_hist and same_one,
                  f"{label}: the same bits twice, histories {same_hist}, "
                  f"one-stream bits {same_one}")
            print(f"{label} counts {cnt.tolist()} ({pfb_group} frames a "
                  "block): the same bits twice, histories on the card "
                  "plain's and the virtual rows' bit for bit, each "
                  "stream's rows and history the one-stream form's; "
                  + hold_streams(label, got.cpu().numpy(), ref.numpy(),
                                 np.stack(gold_p), cnt,
                                 plain_factor=FEW_PLAIN))
            hist[0], hist[1] = hist[1], hist[0]
            hist_p.reverse()
            for s in range(S):
                hs[s].reverse()

    def case(fam, N, S, F, wname):
        """Each form of ``fam`` at S streams of F frames, uneven counts
        (F - 1 and 2 at S = 2; F, 0, 3, F - 1, 1, ... at S = 16): twice,
        against plain and the per-stream golden, SK's s1 the PSD streams
        entry's, each stream the one-stream form's on the same groups; the
        PFB over three steps and a reset."""
        chunk = adapt_batch(F)[1]
        counts = (np.array([F - 1, 2], np.int32) if S == 2 else
                  np.resize(np.array([F, 0, 3, F - 1, 1, F, F // 2 + 1, 2],
                                     np.int32), S))
        w_np = None if wname is None else make_window(wname, N)
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        raw_np = rng.integers(0, 256, (S, F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        head = (f"awkward streams {fam} N={N} S={S} F={F} chunk={chunk} "
                f"window={wname} counts {counts.tolist()}")
        hold_sk(fam, raw, raw_np, counts, chunk, w, w_np, (0.0, 3.0), head)
        hold_mt(fam, raw, raw_np, counts, chunk, head)
        hold_pfb(fam, N, S, F, chunk,
                 [counts, np.roll(counts, 1), np.roll(counts, 3), counts],
                 (0, 3), head)

    man_F = adapt_batch(drive_frames_per_step(MAN_PAGE_ARGV, 2))[0]
    for fam, N, S, F, wname in (("M", 500, 2, man_F, None),
                                ("M", 2400, 16, 64, "hann"),
                                ("M", 12000, 2, 16, None),
                                ("M", 16000, 2, 16, "hann"),
                                ("M", 30, 16, 64, None),
                                ("B", 998, 2, 64, None),
                                ("B", 22, 16, 64, "hann"),
                                ("B", 4094, 2, 32, "hann"),
                                ("B", 8188, 2, 16, None),
                                ("B", 2048, 2, 64, None)):
        case(fam, N, S, F, wname)

    # A burst in one stream: that stream's bin is gated on its own count,
    # the other streams keep it.
    for fam, N in (("M", 500), ("B", 998)):
        S, F = 4, 64
        iq = rng.normal(127.0, 6.0, size=(S, F, 2 * N))
        burst = 40.0 * np.exp(2j * np.pi * 9 * np.arange(N) / N)
        iq[1, :F // 4, 0::2] += burst.real
        iq[1, :F // 4, 1::2] += burst.imag
        raw = torch.from_numpy(np.clip(np.round(iq), 0, 255).astype(
            np.uint8)).to(dev)
        counts = np.array([F, F, F - 4, 0], np.int32)
        rows = fams[fam]["sk"](raw, torch.from_numpy(counts).to(dev), 16,
                               None, 3.0).cpu().numpy()
        want[f"SK-{fam}-S"] += 1
        kept = rows[:, 3, 9]
        check(kept[1] == 0.0 and kept[0] == F and kept[2] == F - 4
              and kept[3] == 0, f"SK-{fam}-S burst: kept {kept}")
        print(f"awkward streams SK-{fam}-S N={N} S={S} F={F}, a burst at "
              f"bin 9 in stream 1's first {F // 4} frames, counts "
              f"{counts.tolist()}: kept at bin 9 {kept.tolist()} (the "
              "burst stream gated alone, on its own count)")

    # Each drive's own step (S, F, chunk; its kernel, the gate), held as
    # the cases above: every frame valid, then the drive's last step's
    # count beside uneven ones (F - 1, a stream with none, one frame);
    # the PFB over the two steps from a reset history, as a hop starts.
    drive_steps = []
    for label, kind, fam, argv, S, sigma in (
            ("man page --streams 2 --sk-file", "SK", "M", MAN_PAGE_ARGV, 2,
             0.0),
            ("--streams 2 --pfb-taps 4 -b 500", "PFB", "M", AWK_PFB_ARGV, 2,
             0.0),
            ("--streams 2 --sk-file -b 998", "SK", "B", AWK_SK998_ARGV, 2,
             0.0),
            ("--streams 2 --sk-excise 3 -b 998", "SK", "B", None, 2, 3.0),
            ("--streams 4 --multitaper 7 -b 2400", "MT", "M", AWK_MT_ARGV,
             4, 0.0),
            ("--streams 2 --sk-file -b 2048 bluestein", "SK", "B",
             AWK_SK_BLUESTEIN_ARGV, 2, 0.0),
            ("--streams 16 -b 500 --sk-file", "SK", "M", AWK_C5_ARGV, 16,
             0.0),
            ("--streams 2 --multitaper 7 -b 998", "MT", "B", AWK_MT998_ARGV,
             2, 0.0),
            ("--streams 2 --pfb-taps 4 -b 4094", "PFB", "B",
             AWK_PFB4094_ARGV, 2, 0.0)):
        if argv is None:   # drive_streams_sk_excise: 2 x 256 frames
            N, repeats, F, chunk = 998, 512, *adapt_batch(256)
        else:
            N = int(argv[argv.index("-b") + 1])
            repeats = int(argv[argv.index("-n") + 1])
            F, chunk = adapt_batch(256 if "--frames-per-step" in argv
                                   else drive_frames_per_step(argv, S))
        last = repeats - (-(-repeats // F) - 1) * F
        drive_steps.append((label, kind, fam, N, S, F, chunk, sigma))
        full = np.full(S, F, np.int32)
        uneven = np.resize(np.array([last, F - 1, 0, 1], np.int32), S)
        head = (f"awkward streams {fam} at the drive step of {label} "
                f"(N={N} S={S} F={F} chunk={chunk}, last step {last})")
        if kind == "PFB":
            hold_pfb(fam, N, S, F, chunk, [full, uneven], (0,), head)
            continue
        for counts in (full, uneven):
            raw_np = rng.integers(0, 256, (S, F, 2 * N), dtype=np.uint8)
            raw = torch.from_numpy(raw_np).to(dev)
            at = f"{head} counts {counts.tolist()}"
            if kind == "SK":
                hold_sk(fam, raw, raw_np, counts, chunk, None, None,
                        (sigma,), at)
            else:
                hold_mt(fam, raw, raw_np, counts, chunk, at)
    counts_now = launch_counts(fp, ff)
    check(all(counts_now[k] == v for k, v in want.items())
          and not any(v for k, v in counts_now.items() if k not in want),
          f"awkward streams launch counts: {counts_now}, expected {want}")
    print(f"wall: awkward streams checks in {time.perf_counter() - t0:.1f} s")

    # The yards: 60 seeds of 35 dB tones at 500 and 998 bins, two streams
    # of 32 frames a seed, each stream's rows against the float64 golden
    # and the scipy float32 class.
    reset_counts(fp, ff)
    S, Fy = 2, 32
    yard_nv = torch.full((S,), Fy, dtype=torch.int32, device=dev)
    for fam, N in (("M", 500), ("B", 998)):
        f = fams[fam]

        def split(r, N=N):
            return r.reshape(S, Fy, 2 * N)

        def z64s(r, N=N):
            return dequant64(r).reshape(S, Fy, N)

        for wname in (None, "hann"):
            w_np = None if wname is None else make_window(wname, N)
            w = None if w_np is None else torch.from_numpy(w_np).to(dev)
            wz = 1.0 if w_np is None else w_np.astype(np.float64)
            estimator_yard(
                f"SK-{fam}-S s2{' hann' if wname else ''} (2 streams of "
                f"{Fy} frames)",
                lambda r, f=f, w=w, split=split: f["sk"](
                    torch.from_numpy(split(r)).to(dev), yard_nv, Fy,
                    w)[:, 1].cpu().numpy(),
                lambda r, w_np=w_np, split=split: np.stack(
                    [golden_moments(x, Fy, w_np)[1] for x in split(r)]),
                lambda r, wz=wz, z64s=z64s: (f32_class_rows(z64s(r) * wz)
                                             ** 2).sum(1),
                N, S * Fy, 21000 + N + (wname is not None))
        tp_np = _session_tapers(N, 4.0, 7)
        tp = torch.from_numpy(tp_np).to(dev)
        estimator_yard(
            f"MT-{fam}-S K=7 (2 streams of {Fy} frames)",
            lambda r, f=f, tp=tp, split=split: f["mt"](
                torch.from_numpy(split(r)).to(dev), yard_nv, Fy,
                tp).cpu().numpy(),
            lambda r, tp_np=tp_np, split=split: np.stack(
                [golden_tapers(x, Fy, tp_np) for x in split(r)]),
            lambda r, tp_np=tp_np, z64s=z64s: f32_class_rows(
                z64s(r)[:, :, None, :] * tp_np.astype(np.float64)[None, None]
            ).mean(2).sum(1), N, S * Fy, 21100 + N)
        P = 4
        h_np = pfb_prototype(N, P).reshape(P, N)
        h = torch.from_numpy(h_np).to(dev)
        hist = [torch.empty((S, P - 1, 2 * N), dtype=torch.uint8,
                            device=dev) for _ in range(2)]
        warm = np.full((P - 1, 2 * N), 127, np.uint8)

        def pfb_class(r, h_np=h_np, warm=warm, split=split):
            rows = []
            for x in split(r):
                sums = fpf.pfb_sums_reference(
                    torch.from_numpy(np.concatenate([warm, x])),
                    torch.from_numpy(h_np), Fy).numpy()
                rows.append(f32_class_rows(sums.astype(np.complex128)).sum(0))
            return np.stack(rows)

        estimator_yard(
            f"PFB-{fam}-S P=4 (2 streams of {Fy} frames)",
            lambda r, f=f, h=h, hist=hist, split=split: f["pfb"](
                torch.from_numpy(split(r)).to(dev), hist[0], yard_nv, Fy, h,
                hist[1], fresh=True).cpu().numpy(),
            lambda r, h_np=h_np, warm=warm, split=split: np.stack(
                [golden_pfb(np.concatenate([warm, x]), Fy, h_np)
                 for x in split(r)]),
            pfb_class, N, S * Fy, 21200 + N)
    counts_now = launch_counts(fp, ff)
    check(all(counts_now[f"{k}-{fam}-S"] == (120 if k == "SK" else 60)
              for k in ("SK", "MT", "PFB") for fam in "MB")
          and sum(counts_now.values()) == 480,
          f"awkward streams yards' launches: {counts_now}")
    print(f"wall: awkward streams yards in {time.perf_counter() - t0:.1f} s")

    # Times (PERF.md states their prediction) at S = 2, F = 2048 (2400
    # bins for the mixed-radix forms, 998 for the chirp-Z forms: phase
    # 13's M-S and B-S shapes): a call (median of 60 event-timed calls),
    # the device's part beside two one-stream calls of the form on the
    # same frames and the PSD streams entry, in turns, the wrapper's host
    # part, the plain version, torch.fft.fft on the same transforms and
    # the bound at S F frames; then the device time at each drive's step.
    times = {}
    S, F = 2, 2048
    for fam, N in (("M", 2400), ("B", 998)):
        f = fams[fam]
        chunk = adapt_batch(F)[1]
        raw = torch.from_numpy(rng.integers(0, 256, (S, F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        full = torch.full((S,), F, dtype=torch.int32, device=dev)
        z = torch.complex(raw[..., 0::2].float() - 127.0,
                          raw[..., 1::2].float() - 127.0).reshape(S * F, N)
        tp = torch.from_numpy(_session_tapers(N, 4.0, 7)).to(dev)
        P = 4
        h = torch.from_numpy(pfb_prototype(N, P).reshape(P, N)).to(dev)
        hist = [torch.full((S, P - 1, 2 * N), 127, dtype=torch.uint8,
                           device=dev) for _ in range(2)]
        one_hist = [torch.full((P - 1, 2 * N), 127, dtype=torch.uint8,
                               device=dev) for _ in range(2)]
        forms = {
            "SK": (lambda: f["sk"](raw, full, chunk),
                   lambda: f["sk_ref"](raw, full, chunk),
                   lambda: [f["sk1"](raw[s], F, chunk) for s in range(S)],
                   z, estimator_bound_ms("SK", S * F, N)),
            "MT": (lambda: f["mt"](raw, full, chunk, tp),
                   lambda: f["mt_ref"](raw, full, chunk, tp),
                   lambda: [f["mt1"](raw[s], F, chunk, tp)
                            for s in range(S)],
                   (z[:, None, :] * tp[None]).reshape(S * F * 7, N),
                   estimator_bound_ms("MT", S * F, N, K=7)),
            "PFB": (lambda: f["pfb"](raw, hist[0], full, chunk, h, hist[1]),
                    lambda: f["pfb_ref"](raw, hist[0], full, chunk, h,
                                         hist[1]),
                    lambda: [f["pfb1"](raw[s], one_hist[0], F, chunk, h,
                                       one_hist[1]) for s in range(S)],
                    torch.cat([fpf.pfb_sums_reference(
                        torch.cat([hist[0][s], raw[s]]), h, F)
                        for s in range(S)]),
                    estimator_bound_ms("PFB", S * F, N, P=P))}

        def psd_call(f=f, raw=raw, full=full, chunk=chunk):
            return f["psd"](raw, full, chunk)

        for kind, (kernel, plain_fn, singles, zz, bound) in forms.items():
            got = kernel().double()
            ref = plain_fn().double()
            rel = max_rel(got.cpu().numpy(), ref.cpu().numpy())
            check(rel <= UNIFORM_RTOL, f"{kind}-{fam}-S timed shape: {rel} "
                  "vs plain")
            kd, sd, pd = [], [], []
            for _ in range(2):
                kd.append(device_times_us(kernel))
                sd.append(device_times_us(singles, calls=10))
                pd.append(device_times_us(psd_call))
            t = {"max_abs": float((got - ref).abs().max()), "bound": bound,
                 "call": event_times_us(kernel),
                 "plain": event_times_us(plain_fn, iters=20, warmup=3),
                 "host": host_us(kernel),
                 "singles": event_times_us(singles, iters=20, warmup=3),
                 "lib": event_times_us(lambda: torch.fft.fft(zz, dim=-1)),
                 "lib_device": device_times_us(lambda: torch.fft.fft(
                     zz, dim=-1)),
                 "device": min(kd), "singles_device": min(sd),
                 "psd_device": min(pd)}
            times[(kind, fam)] = t
            b_us = 1e3 * bound[0]
            print(f"time awkward streams {kind}-{fam}-S S={S} N={N} F={F}"
                  f"{' K=7' if kind == 'MT' else ''}"
                  f"{' P=4' if kind == 'PFB' else ''} on {card}: a call "
                  f"{t['call']:.1f} us, device {kd[0]:.1f}/{kd[1]:.1f} us, "
                  f"host {t['host']:.1f} us "
                  f"({S * F * N / t['device'] / 1e3:.2f} GS/s on the "
                  f"device); two one-stream calls "
                  f"{t['singles']:.1f} us, device {sd[0]:.1f}/{sd[1]:.1f} "
                  f"(streams/two {t['device'] / t['singles_device']:.3f}); "
                  f"{f['psd_key']} device {pd[0]:.1f}/{pd[1]:.1f} us "
                  f"(form/{f['psd_key']} {t['device'] / t['psd_device']:.3f})"
                  f"; plain {t['plain']:.1f} us; torch.fft.fft of the "
                  f"{tuple(zz.shape)} complex64 transforms {t['lib']:.1f} us "
                  f"a call (device {t['lib_device']:.1f}); bound "
                  f"{b_us:.2f} us ({bound[1]}), device/bound "
                  f"{t['device'] / b_us:.1f}x; max abs vs plain "
                  f"{t['max_abs']:.4g}, max rel {rel:.3e}")
    # Each drive's own step, every frame valid: the form's device time
    # beside the PSD streams entry's on the same frames.
    for label, kind, fam, N, S, F, chunk, sigma in drive_steps:
        if sigma > 0.0:
            continue
        f = fams[fam]
        raw = torch.from_numpy(rng.integers(0, 256, (S, F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        full = torch.full((S,), F, dtype=torch.int32, device=dev)
        if kind == "SK":
            def kernel(f=f, raw=raw, full=full, chunk=chunk):
                return f["sk"](raw, full, chunk)
        elif kind == "MT":
            tp = torch.from_numpy(_session_tapers(N, 4.0, 7)).to(dev)

            def kernel(f=f, raw=raw, full=full, chunk=chunk, tp=tp):
                return f["mt"](raw, full, chunk, tp)
        else:
            h = torch.from_numpy(pfb_prototype(N, 4).reshape(4, N)).to(dev)
            hist = [torch.full((S, 3, 2 * N), 127, dtype=torch.uint8,
                               device=dev) for _ in range(2)]

            def kernel(f=f, raw=raw, full=full, chunk=chunk, h=h,
                       hist=hist):
                return f["pfb"](raw, hist[0], full, chunk, h, hist[1])

        def psd_call(f=f, raw=raw, full=full, chunk=chunk):
            return f["psd"](raw, full, chunk)
        kd = device_times_us(kernel)
        pd = device_times_us(psd_call)
        print(f"time awkward streams {kind}-{fam}-S at the drive step of "
              f"{label} (S={S} N={N} F={F}) on {card}: device {kd:.1f} us, "
              f"{f['psd_key']} {pd:.1f} us, {kd / pd:.3f}x; a call "
              f"{event_times_us(kernel, iters=20, warmup=3):.1f} us")
    print(f"wall: awkward streams times in {time.perf_counter() - t0:.1f} s")

    # The drives, each on its streams form alone.
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        launches["SK-M-S"] = drive_man_page(cli, fp, ff, tmp, 2, sk=True)
        launches["SK-M-S"] += drive_awkward_streams(
            "awkward streams --streams 16 -b 500 --sk-file", AWK_C5_ARGV,
            "SK-M-S", "SK", cli, fp, ff, tmp)
        launches["PFB-M-S"] = drive_awkward_streams(
            "awkward streams --streams 2 --pfb-taps 4 -b 500", AWK_PFB_ARGV,
            "PFB-M-S", "PFB", cli, fp, ff, tmp)
        launches["MT-M-S"] = drive_awkward_streams(
            "awkward streams --streams 4 --multitaper 7 -b 2400",
            AWK_MT_ARGV, "MT-M-S", "MT", cli, fp, ff, tmp)
        launches["SK-B-S"] = drive_awkward_streams(
            "awkward streams --streams 2 --sk-file -b 998", AWK_SK998_ARGV,
            "SK-B-S", "SK", cli, fp, ff, tmp)
        launches["SK-B-S"] += drive_streams_sk_excise(
            cli, fp, ff, tmp, S=2, N=998, key="SK-B-S", burst_stream=1)
        launches["SK-B-S"] += drive_awkward_streams(
            "awkward streams --streams 2 --sk-file -b 2048 --fft-backend "
            "bluestein", AWK_SK_BLUESTEIN_ARGV, "SK-B-S", "SK", cli, fp,
            ff, tmp)
        launches["MT-B-S"] = drive_awkward_streams(
            "awkward streams --streams 2 --multitaper 7 -b 998",
            AWK_MT998_ARGV, "MT-B-S", "MT", cli, fp, ff, tmp)
        launches["PFB-B-S"] = drive_awkward_streams(
            "awkward streams --streams 2 --pfb-taps 4 -b 4094",
            AWK_PFB4094_ARGV, "PFB-B-S", "PFB", cli, fp, ff, tmp)
    print(f"wall: awkward streams phase in {time.perf_counter() - t0:.1f} s")

    def entry(name, kind, fam, replaces):
        t = times[(kind, fam)]
        return {"name": name, "route": "cuda",
                "source": CSRC + ("fused_psd_mixed_est.cu" if fam == "M"
                                  else "fused_psd_chirp_est.cu"),
                "replaces": replaces, "launches": launches[f"{kind}-{fam}-S"],
                "max_abs_err": t["max_abs"], "ms": t["call"] / 1000.0,
                "plain_ms": t["plain"] / 1000.0, "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": t["lib"] / 1000.0,
                "device_ms": t["device"] / 1000.0,
                "host_ms": t["host"] / 1000.0,
                "singles_ms": t["singles"] / 1000.0,
                "singles_device_ms": t["singles_device"] / 1000.0,
                "streams_psd_device_ms": t["psd_device"] / 1000.0}

    return [entry(f"fused_psd_{name}_{fam_name}_streams ({kind}-{fam}-S)",
                  kind, fam, replaces)
            for fam, fam_name in (("M", "mixed"), ("B", "chirp"))
            for kind, name, replaces in (
                ("SK", "sk", "rtl_power_fftw_tpu/models/kurtosis.py:205"),
                ("MT", "tapers",
                 "rtl_power_fftw_tpu/models/multitaper.py:227"),
                ("PFB", "pfb", "rtl_power_fftw_tpu/models/pfb.py:262"))]

# Phase 22's CLI drives at the large chirp-Z bin counts (the tone source,
# linear output), less their "--record <path>" and SK files; the burst
# drive is drive_sk_excise at 9998 bins.
BL_SK_ARGV = ["-f", "100M", "-n", "200", "-b", "9998", "-l", "--source",
              SOURCE]
BL_MT_ARGV = ["-f", "100M", "-n", "400", "-b", "16382", "-l",
              "--multitaper", "7", "--source", SOURCE]
BL_PFB_ARGV = ["-f", "100M", "-n", "400", "-b", "12002", "-l",
               "--pfb-taps", "4", "--source", SOURCE]
BL_SK_BLUESTEIN_ARGV = ["-f", "100M", "-n", "200", "-b", "16384", "-l",
                        "--fft-backend", "bluestein", "--source", SOURCE]
BL_SK_S_ARGV = ["-f", "100M", "-n", "200", "-b", "9998", "-l", "--streams",
                "2", "--source", SOURCE]
BL_MT_S_ARGV = ["-f", "100M", "-n", "200", "-b", "16382", "-l",
                "--streams", "2", "--multitaper", "7", "--source", SOURCE]
BL_PFB_S_ARGV = ["-f", "100M", "-n", "200", "-b", "12002", "-l",
                 "--streams", "2", "--pfb-taps", "4", "--source", SOURCE]
# Phase 22's cases: (N, F, window, SK gates) on one stream; (N, S, F,
# window, counts) over streams; (S, F) of its timed calls at 16382 bins.
BL_EST_ONE = ((16382, 256, None, (0.0, 3.0)), (9998, 64, "hann", (3.0,)),
              (12002, 32, None, (0.0,)), (8194, 16, None, (0.0,)),
              (16384, 16, None, (0.0,)))
BL_EST_STREAMS = ((16382, 2, 128, None, (127, 2)),
                  (9998, 4, 32, "hann", (32, 0, 3, 31)))
BL_EST_TIMED = ((1, 256), (2, 128))


def phase_large_estimators(dev, rng, fp, adapt_batch, make_window, cli, ff,
                           card):
    """22. The CLI estimators at the large chirp-Z bin counts (SK-BL, MT-BL,
    PFB-BL of ``fused_psd_chirp_large_est``, forms of BL's passes, and
    their calls over streams SK-BL-S, MT-BL-S, PFB-BL-S): each pass's
    registers, spill and blocks per SM beside BL's (spill at most BL's);
    each form against its plain version and the per-stream float64 golden
    (``hold_streams``: phase 21's few-frame rule), twice (the same bits),
    on one stream at N = 16382 (F = 256), 9998 Hann, 12002, 8194 and 16384
    with n_valid F, F - 1, 1 and 0 (the PFB as four steps of one stream)
    and at S = 2 (16382) and 4 (9998 Hann) with uneven counts (the PFB
    over four steps and a reset), SK with and without the gate; SK's s1
    BL's (BL-S's) rows bit for bit, each stream's rows (and PFB history)
    the S = 1 form's on the same groups, the gate each stream's own
    ``sk_keep``; the same holds at each drive's own step, every frame
    valid and at its last step's count among uneven ones; yards
    (LARGE_EST_YARD_SEEDS seeds) of each form (16382, 16 frames; 9998, two
    streams of 8); a call, the
    device's time beside BL (BL-S) on the same frames and, over streams,
    two one-stream calls, in turns, the wrapper's host time, plain,
    ``torch.fft.fft`` and the bound at 16382 F = 256 and S = 2 F = 128;
    the device time at each drive's step; eight drives, each on its form
    alone. Returns the kernels-line entries."""
    from rtl_power_fftw_tpu_torch.models.multitaper import _session_tapers
    from rtl_power_fftw_tpu_torch.models.pfb import pfb_prototype
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_chirp_large as fbl
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_chirp_large_est as be
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_sk as fsk
    t0 = time.perf_counter()

    # Registers, spill, shared memory and residency of each pass beside
    # BL's own (SK's pass C beside BL's C, the PFB's pass A beside BL's A).
    names = ("BL-S pass A", "BL-S pass A windowed", "BL-S pass B",
             "BL-S pass C", "SK-BL pass C", "PFB-BL pass A")
    for which, name in enumerate(names):
        a = be.kernel_attributes(16382, which, dev)
        b = fbl.kernel_attributes(16382, (0, 1, 2, 3, 3, 0)[which], dev)
        print(f"occupancy {name} (fused_psd_chirp_large_est) M=32768 on "
              f"{card}: {a['registers']} registers, {a['spill_bytes']} B "
              f"spill, {a['static_smem']} + {a['dynamic_smem']} B shared, "
              f"{a['threads']} threads, {a['blocks_per_sm']} blocks/SM; "
              f"BL's pass {b['registers']} registers, {b['spill_bytes']} B "
              f"spill, {b['blocks_per_sm']} blocks/SM")
        check(a["spill_bytes"] <= b["spill_bytes"],
              f"{name}: spills more than BL's pass")

    # Each drive: (N, S, F, its last step's count).
    drives = (("SK-BL", BL_SK_ARGV, 1), ("SK-BL excise", None, 1),
              ("MT-BL", BL_MT_ARGV, 1), ("PFB-BL", BL_PFB_ARGV, 1),
              ("SK-BL bluestein", BL_SK_BLUESTEIN_ARGV, 1),
              ("SK-BL-S", BL_SK_S_ARGV, 2), ("MT-BL-S", BL_MT_S_ARGV, 2),
              ("PFB-BL-S", BL_PFB_S_ARGV, 2))
    steps = {}
    for key, argv, S in drives:
        if argv is None:   # drive_sk_excise: 4 blocks of 256 frames
            N, repeats, F = 9998, 1024, 256
        else:
            N = int(argv[argv.index("-b") + 1])
            repeats = int(argv[argv.index("-n") + 1])
            F = adapt_batch(drive_frames_per_step(argv, S))[0]
        steps[key] = (N, S, F, repeats - (-(-repeats // F) - 1) * F)
    reset_counts(fp, ff)
    want = {k: 0 for k in ("SK-BL", "MT-BL", "PFB-BL", "SK-BL-S", "MT-BL-S",
                           "PFB-BL-S", "BL", "BL windowed", "BL-S",
                           "BL-S windowed")}

    def psd_key(S, w):
        return ("BL" if S == 1 else "BL-S") + (" windowed" if w is not None
                                               else "")

    def hold_sk(head, raw, raw_np, counts, chunk, w, w_np, sigmas):
        """SK on (S, F, 2N) frames at ``counts``: the one-stream form at S =
        1, else the streams form, twice; against plain and the per-stream
        golden; s1 BL's (BL-S's) rows; each stream the S = 1 form's on the
        same groups; the gate each stream's sk_keep."""
        S, F, N = raw.shape[0], raw.shape[1], raw.shape[2] // 2
        nv = torch.from_numpy(counts).to(dev)
        gc = be.grid(N, S, F, w is not None, dev.index)[2]
        gold = [golden_moments(raw_np[s], int(c), w_np)
                for s, c in enumerate(counts)]
        for sigma in sigmas:
            if S == 1:
                c = int(counts[0])

                def form():
                    return be.fused_psd_sk_chirp_large(raw[0], c, chunk, w,
                                                       sigma)[None]
                psd = fbl.fused_psd_chirp_large(raw[0], c, chunk, w)[None]
                ref = be.sk_chirp_large_reference(raw[0], c, chunk, w,
                                                  sigma)[None]
            else:
                def form():
                    return be.fused_psd_sk_chirp_large_streams(
                        raw, nv, chunk, w, sigma)
                psd = fbl.fused_psd_chirp_large_streams(raw, nv, chunk, w)
                ref = be.sk_chirp_large_streams_reference(raw, nv, chunk, w,
                                                          sigma)
            got, again = form(), form()
            singles = [be.fused_psd_sk_chirp_large(
                raw[s], int(c), chunk, w, sigma, group_c=gc)
                for s, c in enumerate(counts)]
            torch.cuda.synchronize()
            key = "SK-BL" if S == 1 else "SK-BL-S"
            want[key] += 2
            want["SK-BL"] += S
            want[psd_key(S, w)] += 1
            label = f"SK-BL{'-S' * (S > 1)} {head} gate={sigma:g}"
            check(torch.equal(got, again), f"{label}: not deterministic")
            check(torch.equal(got[:, 0], psd), f"{label}: s1 is not "
                  f"{psd_key(S, w)}'s rows")
            check(all(torch.equal(got[s], singles[s]) for s in range(S)),
                  f"{label}: a stream is not the S = 1 form's")
            g_np, r_np = got.cpu().numpy(), ref.cpu().numpy()
            line = [f"s{i + 1}: " + hold_streams(
                f"{label} s{i + 1}", g_np[:, i], r_np[:, i],
                np.stack([g[i] for g in gold]), counts,
                (i + 1) * GOLDEN_RTOL, FEW_PLAIN) for i in range(2)]
            if sigma > 0.0:
                M = torch.from_numpy(counts.astype(np.float32))[:, None]
                keep = fsk.sk_keep(got[:, 0].cpu(), got[:, 1].cpu(), M,
                                   sigma).numpy()
                check(np.array_equal(g_np[:, 3], M.numpy() * keep)
                      and np.array_equal(g_np[:, 2], g_np[:, 0] * keep),
                      f"{label}: the gate is not each stream's sk_keep")
                line.append(f"gate {int(keep.sum())} of {S * N} "
                            "stream-bins kept, each stream's sk_keep")
            print(f"{label} (group_c {gc}): the same bits twice, s1 "
                  f"{psd_key(S, w)}'s rows, each stream the S = 1 form's; "
                  + "; ".join(line))

    def hold_mt(head, raw, raw_np, counts, chunk, K=7):
        """MT on (S, F, 2N) frames at ``counts``, as hold_sk holds SK."""
        S, F, N = raw.shape[0], raw.shape[1], raw.shape[2] // 2
        nv = torch.from_numpy(counts).to(dev)
        gc = be.grid(N, S, F, True, dev.index)[2]
        tp_np = _session_tapers(N, 4.0, K)
        tp = torch.from_numpy(tp_np).to(dev)
        if S == 1:
            def form():
                return be.fused_psd_tapers_chirp_large(
                    raw[0], int(counts[0]), chunk, tp)[None]
            ref = be.tapers_chirp_large_reference(raw[0], int(counts[0]),
                                                  chunk, tp)[None]
        else:
            def form():
                return be.fused_psd_tapers_chirp_large_streams(raw, nv,
                                                               chunk, tp)
            ref = be.tapers_chirp_large_streams_reference(raw, nv, chunk, tp)
        got, again = form(), form()
        singles = [be.fused_psd_tapers_chirp_large(raw[s], int(c), chunk, tp,
                                                   group_c=gc)
                   for s, c in enumerate(counts)]
        torch.cuda.synchronize()
        want["MT-BL" if S == 1 else "MT-BL-S"] += 2
        want["MT-BL"] += S
        label = f"MT-BL{'-S' * (S > 1)} {head} K={K}"
        check(torch.equal(got, again), f"{label}: not deterministic")
        check(all(torch.equal(got[s], singles[s]) for s in range(S)),
              f"{label}: a stream is not the S = 1 form's")
        gold = np.stack([golden_tapers(raw_np[s], int(c), tp_np)
                         for s, c in enumerate(counts)])
        print(f"{label} (group_c {gc}): the same bits twice, each stream "
              f"the S = 1 form's; " + hold_streams(
                  label, got.cpu().numpy(), ref.cpu().numpy(), gold, counts,
                  plain_factor=FEW_PLAIN))

    def hold_pfb(head, N, S, F, chunk, schedule, resets, P=4):
        """PFB over the steps of ``schedule`` (each step's (S,) counts;
        fresh histories at the steps of ``resets``), new frames each step:
        twice, the histories on the card plain's and the virtual rows',
        each stream's rows and history the S = 1 form's on the same
        groups, against plain and the per-stream golden."""
        h_np = pfb_prototype(N, P).reshape(P, N)
        h = torch.from_numpy(h_np).to(dev)
        gc = be.grid(N, S, F, False, dev.index)[2]
        shape = (S, P - 1, 2 * N)
        hist = [torch.empty(shape, dtype=torch.uint8, device=dev)
                for _ in range(3)]
        hist_p = [torch.empty(shape, dtype=torch.uint8, device=dev)
                  for _ in range(2)]
        hs = [[torch.empty(shape[1:], dtype=torch.uint8, device=dev)
               for _ in range(2)] for _ in range(S)]
        virtual = [None] * S
        for k, cnt in enumerate(schedule):
            fresh = k in resets
            step_np = rng.integers(0, 256, (S, F, 2 * N), dtype=np.uint8)
            step = torch.from_numpy(step_np).to(dev)
            c_dev = torch.from_numpy(cnt).to(dev)
            if S == 1:
                c = int(cnt[0])
                got = be.fused_psd_pfb_chirp_large(
                    step[0], hist[0][0], c, chunk, h, hist[1][0],
                    fresh=fresh)[None]
                again = be.fused_psd_pfb_chirp_large(
                    step[0], hist[0][0], c, chunk, h, hist[2][0])[None]
                ref = be.pfb_chirp_large_reference(
                    step[0], hist_p[0][0], c, chunk, h, hist_p[1][0],
                    fresh=fresh)[None]
            else:
                got = be.fused_psd_pfb_chirp_large_streams(
                    step, hist[0], c_dev, chunk, h, hist[1], fresh=fresh)
                again = be.fused_psd_pfb_chirp_large_streams(
                    step, hist[0], c_dev, chunk, h, hist[2])
                ref = be.pfb_chirp_large_streams_reference(
                    step, hist_p[0], c_dev, chunk, h, hist_p[1],
                    fresh=fresh)
            singles = [be.fused_psd_pfb_chirp_large(
                step[s], hs[s][0], int(c), chunk, h, hs[s][1], fresh=fresh,
                group_c=gc) for s, c in enumerate(cnt)]
            torch.cuda.synchronize()
            want["PFB-BL" if S == 1 else "PFB-BL-S"] += 2
            want["PFB-BL"] += S
            gold = []
            for s, c in enumerate(cnt):
                if fresh:
                    virtual[s] = np.full((P - 1, 2 * N), 127, np.uint8)
                v = np.concatenate([virtual[s], step_np[s]])
                gold.append(golden_pfb(v, int(c), h_np))
                virtual[s] = v[int(c):int(c) + P - 1]
            same_hist = (torch.equal(hist[1], hist[2])
                         and torch.equal(hist[1], hist_p[1])
                         and np.array_equal(hist[1].cpu().numpy(),
                                            np.stack(virtual)))
            same_one = all(torch.equal(got[s], singles[s])
                           and torch.equal(hist[1][s], hs[s][1])
                           for s in range(S))
            label = (f"PFB-BL{'-S' * (S > 1)} {head} P={P} step {k}"
                     f"{' (a reset)' if fresh and k else ''}")
            check(torch.equal(got, again) and same_hist and same_one,
                  f"{label}: the same bits twice, histories {same_hist}, "
                  f"S = 1 bits {same_one}")
            print(f"{label} counts {cnt.tolist()} (group_c {gc}): the same "
                  "bits twice, histories on the card plain's and the "
                  "virtual rows' bit for bit, each stream's rows and "
                  "history the S = 1 form's; " + hold_streams(
                      label, got.cpu().numpy(), ref.cpu().numpy(),
                      np.stack(gold),
                      cnt, plain_factor=FEW_PLAIN))
            hist[0], hist[1] = hist[1], hist[0]
            hist_p.reverse()
            for s in range(S):
                hs[s].reverse()

    def case(N, S, F, wname, sigmas, schedule, resets):
        """SK, MT and the PFB at S streams of F frames over the counts of
        ``schedule`` (SK and MT at each; the PFB as the schedule's steps
        from a reset)."""
        chunk = adapt_batch(F)[1]
        w_np = None if wname is None else make_window(wname, N)
        w = None if w_np is None else torch.from_numpy(w_np).to(dev)
        raw_np = rng.integers(0, 256, (S, F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        for counts in schedule:
            head = (f"large chirp-Z N={N} S={S} F={F} chunk={chunk} "
                    f"window={wname} counts {counts.tolist()}")
            hold_sk(head, raw, raw_np, counts, chunk, w, w_np, sigmas)
            hold_mt(head, raw, raw_np, counts, chunk)
        hold_pfb(f"large chirp-Z N={N} S={S} F={F} chunk={chunk}", N, S, F,
                 chunk, schedule, resets)

    for N, F, wname, sigmas in BL_EST_ONE:
        case(N, 1, F, wname, sigmas,
             [np.array([c], np.int32) for c in (F, F - 1, 1, 0)], (0,))
    for N, S, F, wname, counts in BL_EST_STREAMS:
        counts = np.array(counts, np.int32)
        case(N, S, F, wname, (0.0, 3.0),
             [counts, np.roll(counts, 1), np.roll(counts, 3), counts], (0, 3))
    # Each drive's own step (N, S, F, chunk; the gate of the burst drive),
    # every frame valid, then its last step's count beside uneven ones;
    # the PFB over both steps from a reset history, as a hop starts.
    for key, (N, S, F, last) in steps.items():
        chunk = adapt_batch(F)[1]
        head = (f"at the drive step of {key} (N={N} S={S} F={F} "
                f"chunk={chunk}, last step {last})")
        full = np.full(S, F, np.int32)
        uneven = np.resize(np.array([last, F - 1, 0, 1], np.int32), S)
        if key.startswith("PFB"):
            hold_pfb(head, N, S, F, chunk, [full, uneven], (0,))
            continue
        for counts in (full, uneven):
            raw_np = rng.integers(0, 256, (S, F, 2 * N), dtype=np.uint8)
            raw = torch.from_numpy(raw_np).to(dev)
            at = f"{head} counts {counts.tolist()}"
            if key.startswith("SK"):
                hold_sk(at, raw, raw_np, counts, chunk, None, None,
                        (3.0 if key == "SK-BL excise" else 0.0,))
            else:
                hold_mt(at, raw, raw_np, counts, chunk)
    counts_now = launch_counts(fp, ff)
    check(all(counts_now[k] == v for k, v in want.items())
          and not any(v for k, v in counts_now.items() if k not in want),
          f"large chirp-Z estimator launch counts: {counts_now}, expected "
          f"{want}")
    print(f"wall: large chirp-Z estimator checks in "
          f"{time.perf_counter() - t0:.1f} s")

    # The yards: LARGE_EST_YARD_SEEDS seeds of 35 dB tones, each form
    # against the float64 golden and the scipy float32 class: one stream at
    # 16382 (16 frames a seed), two streams of 8 frames at 9998.
    reset_counts(fp, ff)
    for N, S, Fy in ((16382, 1, 16), (9998, 2, 8)):
        nv = torch.full((S,), Fy, dtype=torch.int32, device=dev)
        tag = "" if S == 1 else "-S"
        head = "" if S == 1 else f" ({S} streams of {Fy} frames)"

        def split(r, N=N, S=S, Fy=Fy):
            return r.reshape(S, Fy, 2 * N)

        def z64s(r, N=N, S=S, Fy=Fy):
            return dequant64(r).reshape(S, Fy, N)

        def on_card(r, split=split):
            return torch.from_numpy(split(r)).to(dev)

        if S == 1:
            def sk_fn(r, on_card=on_card):
                return be.fused_psd_sk_chirp_large(
                    on_card(r)[0], Fy, Fy)[1:2].cpu().numpy()

            def mt_fn(r, tp, on_card=on_card):
                return be.fused_psd_tapers_chirp_large(
                    on_card(r)[0], Fy, Fy, tp)[None].cpu().numpy()

            def pfb_fn(r, h, hist, on_card=on_card):
                return be.fused_psd_pfb_chirp_large(
                    on_card(r)[0], hist[0][0], Fy, Fy, h, hist[1][0],
                    fresh=True)[None].cpu().numpy()
        else:
            def sk_fn(r, on_card=on_card, nv=nv):
                return be.fused_psd_sk_chirp_large_streams(
                    on_card(r), nv, Fy)[:, 1].cpu().numpy()

            def mt_fn(r, tp, on_card=on_card, nv=nv):
                return be.fused_psd_tapers_chirp_large_streams(
                    on_card(r), nv, Fy, tp).cpu().numpy()

            def pfb_fn(r, h, hist, on_card=on_card, nv=nv):
                return be.fused_psd_pfb_chirp_large_streams(
                    on_card(r), hist[0], nv, Fy, h, hist[1],
                    fresh=True).cpu().numpy()
        estimator_yard(
            f"SK-BL{tag} s2{head}", sk_fn,
            lambda r, split=split: np.stack(
                [golden_moments(x, Fy)[1] for x in split(r)]),
            lambda r, z64s=z64s: (f32_class_rows(z64s(r)) ** 2).sum(1),
            N, S * Fy, 22000 + N, LARGE_EST_YARD_SEEDS)
        tp_np = _session_tapers(N, 4.0, 7)
        tp = torch.from_numpy(tp_np).to(dev)
        estimator_yard(
            f"MT-BL{tag} K=7{head}", lambda r, tp=tp: mt_fn(r, tp),
            lambda r, tp_np=tp_np, split=split: np.stack(
                [golden_tapers(x, Fy, tp_np) for x in split(r)]),
            lambda r, tp_np=tp_np, z64s=z64s: f32_class_rows(
                z64s(r)[:, :, None, :] * tp_np.astype(np.float64)[None, None]
            ).mean(2).sum(1), N, S * Fy, 22100 + N, LARGE_EST_YARD_SEEDS)
        P = 4
        h_np = pfb_prototype(N, P).reshape(P, N)
        h = torch.from_numpy(h_np).to(dev)
        hist = [torch.empty((S, P - 1, 2 * N), dtype=torch.uint8,
                            device=dev) for _ in range(2)]
        warm = np.full((P - 1, 2 * N), 127, np.uint8)

        def pfb_class(r, h_np=h_np, warm=warm, split=split, Fy=Fy):
            rows = []
            for x in split(r):
                sums = fpf.pfb_sums_reference(
                    torch.from_numpy(np.concatenate([warm, x])),
                    torch.from_numpy(h_np), Fy).numpy()
                rows.append(f32_class_rows(sums.astype(np.complex128)).sum(0))
            return np.stack(rows)

        estimator_yard(
            f"PFB-BL{tag} P=4{head}",
            lambda r, h=h, hist=hist: pfb_fn(r, h, hist),
            lambda r, h_np=h_np, warm=warm, split=split: np.stack(
                [golden_pfb(np.concatenate([warm, x]), Fy, h_np)
                 for x in split(r)]),
            pfb_class, N, S * Fy, 22200 + N, LARGE_EST_YARD_SEEDS)
    counts_now = launch_counts(fp, ff)
    check(all(counts_now[k] == LARGE_EST_YARD_SEEDS
              for k in ("SK-BL", "MT-BL", "PFB-BL", "SK-BL-S", "MT-BL-S",
                        "PFB-BL-S"))
          and sum(counts_now.values()) == 6 * LARGE_EST_YARD_SEEDS,
          f"large chirp-Z estimator yards' launches: {counts_now}")
    print(f"wall: large chirp-Z estimator yards in "
          f"{time.perf_counter() - t0:.1f} s")

    # Times (PERF.md states their prediction): one stream at 16382 F = 256
    # beside BL, S = 2 at F = 128 a stream beside two one-stream calls and
    # BL-S, all on the same frames and in turns: a call (median of 60
    # event-timed calls), the device's part (twice), the wrapper's host
    # part, the plain version, torch.fft.fft on the same transforms (F
    # frames; F K tapered frames; F polyphase sums) and the bound; then
    # the device time at each drive's step beside BL (BL-S).
    times = {}
    N, K, P = 16382, 7, 4
    tp = torch.from_numpy(_session_tapers(N, 4.0, K)).to(dev)
    h = torch.from_numpy(pfb_prototype(N, P).reshape(P, N)).to(dev)
    for S, F in BL_EST_TIMED:
        chunk = adapt_batch(F)[1]
        raw = torch.from_numpy(rng.integers(0, 256, (S, F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        nv = torch.full((S,), F, dtype=torch.int32, device=dev)
        z = torch.complex(raw[..., 0::2].float() - 127.0,
                          raw[..., 1::2].float() - 127.0).reshape(S * F, N)
        hist = [torch.full((S, P - 1, 2 * N), 127, dtype=torch.uint8,
                           device=dev) for _ in range(2)]
        one_hist = [torch.full((P - 1, 2 * N), 127, dtype=torch.uint8,
                               device=dev) for _ in range(2)]
        if S == 1:
            forms = {
                "SK": (lambda: be.fused_psd_sk_chirp_large(raw[0], F, chunk),
                       lambda: be.sk_chirp_large_reference(raw[0], F, chunk),
                       z, estimator_bound_ms("SK", F, N)),
                "MT": (lambda: be.fused_psd_tapers_chirp_large(
                    raw[0], F, chunk, tp),
                       lambda: be.tapers_chirp_large_reference(
                           raw[0], F, chunk, tp),
                       (z[:, None, :] * tp[None]).reshape(F * K, N),
                       estimator_bound_ms("MT", F, N, K=K)),
                "PFB": (lambda: be.fused_psd_pfb_chirp_large(
                    raw[0], one_hist[0], F, chunk, h, one_hist[1]),
                        lambda: be.pfb_chirp_large_reference(
                            raw[0], one_hist[0], F, chunk, h, one_hist[1]),
                        fpf.pfb_sums_reference(
                            torch.cat([one_hist[0], raw[0]]), h, F),
                        estimator_bound_ms("PFB", F, N, P=P))}

            def psd_call(raw=raw, F=F, chunk=chunk):
                return fbl.fused_psd_chirp_large(raw[0], F, chunk)
            singles = {}
        else:
            forms = {
                "SK": (lambda: be.fused_psd_sk_chirp_large_streams(
                    raw, nv, chunk),
                       lambda: be.sk_chirp_large_streams_reference(
                           raw, nv, chunk),
                       z, estimator_bound_ms("SK", S * F, N)),
                "MT": (lambda: be.fused_psd_tapers_chirp_large_streams(
                    raw, nv, chunk, tp),
                       lambda: be.tapers_chirp_large_streams_reference(
                           raw, nv, chunk, tp),
                       (z[:, None, :] * tp[None]).reshape(S * F * K, N),
                       estimator_bound_ms("MT", S * F, N, K=K)),
                "PFB": (lambda: be.fused_psd_pfb_chirp_large_streams(
                    raw, hist[0], nv, chunk, h, hist[1]),
                        lambda: be.pfb_chirp_large_streams_reference(
                            raw, hist[0], nv, chunk, h, hist[1]),
                        torch.cat([fpf.pfb_sums_reference(
                            torch.cat([hist[0][s], raw[s]]), h, F)
                            for s in range(S)]),
                        estimator_bound_ms("PFB", S * F, N, P=P))}

            def psd_call(raw=raw, nv=nv, chunk=chunk):
                return fbl.fused_psd_chirp_large_streams(raw, nv, chunk)
            singles = {
                "SK": lambda: [be.fused_psd_sk_chirp_large(raw[s], F, chunk)
                               for s in range(S)],
                "MT": lambda: [be.fused_psd_tapers_chirp_large(
                    raw[s], F, chunk, tp) for s in range(S)],
                "PFB": lambda: [be.fused_psd_pfb_chirp_large(
                    raw[s], one_hist[0], F, chunk, h, one_hist[1])
                    for s in range(S)]}
        for kind, (kernel, plain_fn, zz, bound) in forms.items():
            got = kernel().double()
            ref = plain_fn().double()
            rel = max_rel(got.cpu().numpy(), ref.cpu().numpy())
            label = f"{kind}-BL{'-S' * (S > 1)}"
            check(rel <= UNIFORM_RTOL, f"{label} timed shape: {rel} vs "
                  "plain")
            kd, bd, sd = [], [], []
            for _ in range(2):
                kd.append(device_times_us(kernel))
                bd.append(device_times_us(psd_call))
                if singles:
                    sd.append(device_times_us(singles[kind], calls=10))
            t = {"max_abs": float((got - ref).abs().max()), "bound": bound,
                 "call": event_times_us(kernel),
                 "plain": event_times_us(plain_fn, iters=20, warmup=3),
                 # MT's 3 K + 1 launches a call: 20 calls keep the launch
                 # queue from filling, which would count device time.
                 "host": host_us(kernel, calls=20 if kind == "MT" else 100),
                 "lib": event_times_us(lambda: torch.fft.fft(zz, dim=-1)),
                 "lib_device": device_times_us(
                     lambda: torch.fft.fft(zz, dim=-1)),
                 "device": min(kd), "psd_device": min(bd)}
            pair = ""
            if singles:
                t["singles"] = event_times_us(singles[kind], iters=20,
                                              warmup=3)
                t["singles_device"] = min(sd)
                pair = (f"; two one-stream calls {t['singles']:.1f} us, "
                        f"device {sd[0]:.1f}/{sd[1]:.1f} (streams/two "
                        f"{t['device'] / t['singles_device']:.3f})")
            times[label] = t
            b_us = 1e3 * bound[0]
            psd = "BL-S" if S > 1 else "BL"
            print(f"time large chirp-Z estimator {label} S={S} N={N} F={F}"
                  f"{f' K={K}' if kind == 'MT' else ''}"
                  f"{f' P={P}' if kind == 'PFB' else ''} on {card}: a call "
                  f"{t['call']:.1f} us, device {kd[0]:.1f}/{kd[1]:.1f} us, "
                  f"host {t['host']:.1f} us "
                  f"({S * F * N / t['device'] / 1e3:.2f} GS/s on the "
                  f"device); {psd} on the same frames device "
                  f"{bd[0]:.1f}/{bd[1]:.1f} us, form/{psd} "
                  f"{t['device'] / t['psd_device']:.3f}{pair}; plain "
                  f"{t['plain']:.1f} us; torch.fft.fft of the "
                  f"{tuple(zz.shape)} complex64 transforms {t['lib']:.1f} us "
                  f"a call (device {t['lib_device']:.1f}); bound "
                  f"{b_us:.2f} us ({bound[1]}), device/bound "
                  f"{t['device'] / b_us:.1f}x; max abs vs plain "
                  f"{t['max_abs']:.4g}, max rel {rel:.3e}")
    for key, (N, S, F, _) in steps.items():
        chunk = adapt_batch(F)[1]
        raw = torch.from_numpy(rng.integers(0, 256, (S, F, 2 * N),
                                            dtype=np.uint8)).to(dev)
        nv = torch.full((S,), F, dtype=torch.int32, device=dev)
        sigma = 3.0 if key == "SK-BL excise" else 0.0
        tpk = torch.from_numpy(_session_tapers(N, 4.0, 7)).to(dev)
        hk = torch.from_numpy(pfb_prototype(N, 4).reshape(4, N)).to(dev)
        hist = [torch.full((S, 3, 2 * N), 127, dtype=torch.uint8,
                           device=dev) for _ in range(2)]
        if S == 1:
            kernel = {
                "SK": lambda: be.fused_psd_sk_chirp_large(raw[0], F, chunk,
                                                          None, sigma),
                "MT": lambda: be.fused_psd_tapers_chirp_large(raw[0], F,
                                                              chunk, tpk),
                "PFB": lambda: be.fused_psd_pfb_chirp_large(
                    raw[0], hist[0][0], F, chunk, hk, hist[1][0])}
            psd_call = (lambda: fbl.fused_psd_chirp_large(raw[0], F, chunk))
        else:
            kernel = {
                "SK": lambda: be.fused_psd_sk_chirp_large_streams(
                    raw, nv, chunk),
                "MT": lambda: be.fused_psd_tapers_chirp_large_streams(
                    raw, nv, chunk, tpk),
                "PFB": lambda: be.fused_psd_pfb_chirp_large_streams(
                    raw, hist[0], nv, chunk, hk, hist[1])}
            psd_call = (lambda: fbl.fused_psd_chirp_large_streams(
                raw, nv, chunk))
        fn = kernel[key.split("-")[0]]
        kd = device_times_us(fn)
        pd = device_times_us(psd_call)
        print(f"time large chirp-Z estimator at the drive step of {key} "
              f"(S={S} N={N} F={F}) on {card}: device {kd:.1f} us, "
              f"{'BL-S' if S > 1 else 'BL'} {pd:.1f} us, {kd / pd:.3f}x; a "
              f"call {event_times_us(fn, iters=20, warmup=3):.1f} us")
    print(f"wall: large chirp-Z estimator times in "
          f"{time.perf_counter() - t0:.1f} s")

    # The drives, each on its form alone.
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        launches["SK-BL"] = drive_sk_excise(cli, fp, ff, tmp, N=9998,
                                            key="SK-BL")
        for key, argv in (("SK-BL", BL_SK_ARGV), ("MT-BL", BL_MT_ARGV),
                          ("PFB-BL", BL_PFB_ARGV),
                          ("SK-BL", BL_SK_BLUESTEIN_ARGV)):
            N = int(argv[argv.index("-b") + 1])
            repeats = int(argv[argv.index("-n") + 1])
            tag = f"{key}_{N}"
            record = os.path.join(tmp, f"{tag}.iq")
            sk_path = os.path.join(tmp, f"{tag}.sk")
            sk = key == "SK-BL"
            extra = [f"--sk-file={sk_path}"] if sk else []

            def golden(key=key, record=record, N=N, repeats=repeats):
                raw_np = recorded_frames(record, N)[:repeats]
                if key == "MT-BL":
                    pwr = golden_tapers(raw_np, repeats,
                                        _session_tapers(N, 4.0, 7))
                elif key == "PFB-BL":
                    pwr = golden_pfb(np.concatenate([np.full(
                        (3, 2 * N), 127, np.uint8), raw_np]), repeats,
                        pfb_prototype(N, 4).reshape(4, N))
                else:
                    pwr = golden_moments(raw_np, repeats)[0]
                return golden_finalize_linear(np.fft.fftshift(pwr), repeats,
                                              RATE)

            # The tapers' spectral window is 2 NW = 8 bins wide: its peak
            # may fall NW bins from the tone.
            launches[key] = launches.get(key, 0) + drive(
                f"large chirp-Z estimator {key} "
                f"{' '.join(argv[argv.index('-b'):argv.index('--source')])}",
                argv + extra + ["--record", record], cli, fp, ff, key, N,
                golden, GOLDEN_RTOL, peak_bins=4 if key == "MT-BL" else 1)
            if sk:
                sk_file, sk_err = sk_file_error(
                    sk_path, recorded_frames(record, N)[:repeats], repeats)
                print(f"e2e large chirp-Z estimator SK-BL -b {N} SK file: "
                      f"{len(sk_file)} bins, max |SK - float64 golden| "
                      f"{sk_err:.3e} (<= 1e-4)")
                check(len(sk_file) == N and sk_err <= 1e-4,
                      f"SK-BL -b {N} drive: SK file")
        for key, kind, argv in (("SK-BL-S", "SK", BL_SK_S_ARGV),
                                ("MT-BL-S", "MT", BL_MT_S_ARGV),
                                ("PFB-BL-S", "PFB", BL_PFB_S_ARGV)):
            launches[key] = drive_awkward_streams(
                f"large chirp-Z estimator {key} "
                f"{' '.join(argv[argv.index('-b'):argv.index('--source')])}",
                argv, key, kind, cli, fp, ff, tmp)
    print(f"wall: large chirp-Z estimator phase in "
          f"{time.perf_counter() - t0:.1f} s")

    def entry(name, key, replaces):
        t = times[key]
        out = {"name": name, "route": "cuda",
               "source": CSRC + "fused_psd_chirp_large_est.cu",
               "replaces": replaces, "launches": launches[key],
               "max_abs_err": t["max_abs"], "ms": t["call"] / 1000.0,
               "plain_ms": t["plain"] / 1000.0, "bound_ms": t["bound"][0],
               "bound_by": t["bound"][1], "library_ms": t["lib"] / 1000.0,
               "device_ms": t["device"] / 1000.0,
               "host_ms": t["host"] / 1000.0,
               ("streams_psd_device_ms" if key.endswith("-S")
                else "chirp_large_device_ms"): t["psd_device"] / 1000.0}
        if "singles" in t:
            out["singles_ms"] = t["singles"] / 1000.0
            out["singles_device_ms"] = t["singles_device"] / 1000.0
        return out

    return [entry(f"fused_psd_{name}_chirp_large{'_streams' * s} "
                  f"({kind}-BL{'-S' * s})", f"{kind}-BL{'-S' * s}",
                  replaces[s])
            for kind, name, replaces in (
                ("SK", "sk", ("rtl_power_fftw_tpu/models/kurtosis.py:46",
                              "rtl_power_fftw_tpu/models/kurtosis.py:205")),
                ("MT", "tapers",
                 ("rtl_power_fftw_tpu/models/multitaper.py:60",
                  "rtl_power_fftw_tpu/models/multitaper.py:227")),
                ("PFB", "pfb", ("rtl_power_fftw_tpu/models/pfb.py:48",
                                "rtl_power_fftw_tpu/models/pfb.py:262")))
            for s in (0, 1)]


# Phase 23's CLI drives above 16384 bins (the line source: under SOURCE's
# stronger tone no float32 FFT holds 1e-5 of the golden at these N, see
# LINE_SOURCE; linear output), less their "--record <path>" and SK files;
# the burst drive is drive_sk_excise at 65536 bins with Hann.
EST23_ONE_ARGV = {
    "SK-L": ["-f", "100M", "-n", "64", "-b", "32768", "-l", "--source",
             LINE_SOURCE],
    "MT-L": ["-f", "100M", "-n", "8", "-b", "1048576", "-l",
             "--multitaper", "7", "--source", LINE_SOURCE],
    "PFB-L": ["-f", "100M", "-n", "8", "-b", "4194304", "-l",
              "--pfb-taps", "4", "--source", LINE_SOURCE],
    "SK-BL": ["-f", "100M", "-n", "64", "-b", "20002", "-l", "--source",
              LINE_SOURCE],
    "MT-BL": ["-f", "100M", "-n", "32", "-b", "99998", "-l",
              "--multitaper", "7", "--source", LINE_SOURCE],
    "PFB-BL": ["-f", "100M", "-n", "8", "-b", "2097150", "-l",
               "--pfb-taps", "4", "--source", LINE_SOURCE],
    "SK-BL bluestein": ["-f", "100M", "-n", "64", "-b", "32768", "-l",
                        "--fft-backend", "bluestein", "--source",
                        LINE_SOURCE],
}
# Phase 23's drives that write matrix output (-q -m), at 2^20 bins and
# above: their 1-4M lines of text would take longer to format and parse
# than the session to run.
EST23_MATRIX = ("MT-L", "PFB-L", "PFB-BL")
EST23_STREAMS_ARGV = {
    "SK-L-S": ["-f", "100M", "-n", "64", "-b", "65536", "-l", "--streams",
               "2", "--source", LINE_SOURCE],
    "MT-L-S": ["-f", "100M", "-n", "32", "-b", "65536", "-l", "--streams",
               "2", "--multitaper", "7", "--source", LINE_SOURCE],
    "PFB-L-S": ["-f", "100M", "-n", "64", "-b", "32768", "-l", "--streams",
                "2", "--pfb-taps", "4", "--source", LINE_SOURCE],
    "PFB-BL-S": ["-f", "100M", "-n", "32", "-b", "99998", "-l",
                 "--streams", "2", "--pfb-taps", "4", "--source",
                 LINE_SOURCE],
}
# Phase 23's cases, by family ("L": the large kernel's forms, "BL": BL's
# at M = 2^16 .. 2^22): (N, F, window, SK gates) on one stream, each at
# n_valid F, F - 1, 1 and 0 (at the largest N, 2^22 and M = 2^22, F and
# 1); (N, S, F, window, counts) over streams; the N of the other sizes
# (M) at which SK's s1 is held to the base kernel's bits, every frame
# valid.
EST23_ONE = {"L": ((32768, 16, None, (0.0, 3.0)), (65536, 16, "hann", (3.0,)),
                   (1 << 20, 8, None, (0.0,)), (1 << 22, 8, None, (0.0,))),
             "BL": ((20002, 16, None, (0.0, 3.0)),
                    (32770, 16, "hann", (3.0,)), (99998, 8, None, (0.0,)),
                    (2097150, 8, None, (0.0,)))}
EST23_LARGEST = (1 << 22, 2097150)
EST23_S1 = {"L": (1 << 17, 1 << 18, 1 << 19, 1 << 21),
            "BL": (262142, 524286, 1048574)}
EST23_STREAMS = {"L": ((65536, 2, 16, None, (16, 5)),
                       (1 << 20, 2, 8, "hann", (3, 8))),
                 "BL": ((99998, 2, 8, None, (8, 3)),
                        (20002, 4, 8, "hann", (8, 0, 3, 7)))}
# Phase 23's timed shapes by family: (N, F, window) of one stream beside
# the base kernel, and (N, F a stream, window) at S = 2 beside two
# one-stream calls and the base's streams entry.
# From this N phase 23 holds the PFB's few-frame steps by the FFTW-class
# budget as well (hold_streams' class_rel: max rel within 3x the scipy
# float32 FFT's on the same polyphase sums, as matrix_drive holds the
# large kernel): under random bytes (mean 127.5) the DC bin of the sums
# holds ~130x the mean power at 2^22, and a float32 rounding or two of it
# is ~1e-5 of the mean.
CLASS_FEW_N = 1 << 20
EST23_TIMED = {"L": ((65536, 16, "hann"), (1 << 20, 8, None)),
               "BL": ((99998, 64, None), (2097150, 8, None))}
EST23_TIMED_STREAMS = {"L": (65536, 16, "hann"), "BL": (99998, 32, None)}


def matrix_estimator_drive(label, argv, cli, fp, ff, kernel, N, golden_fn,
                           peak_bins, matrix_bin, class_fn=None) -> int:
    """drive()'s checks on a matrix-mode drive (``argv`` writes the
    float32 row ``matrix_bin``): exit 0, ``kernel``'s path alone, a finite
    N-bin linear row peaking at 100.2 MHz (within ``peak_bins`` bins),
    within 1e-5 of ``golden_fn()``, or, where ``class_fn()`` gives the
    scipy float32 class's row on the same frames, within 3x its error
    where that is larger (matrix_drive's budget). Returns the kernel's
    launches."""
    reset_counts(fp, ff)
    rc, _, err, wall = run_cli(argv, cli.main)
    counts = launch_counts(fp, ff)
    log(err[-1200:])
    check(rc == 0, f"{label} drive exited {rc}")
    path = {"SK": "cuda_sk", "MT": "cuda_multitaper",
            "PFB": "cuda_pfb"}[kernel.split("-")[0]]
    check(f"Transform path: {path} " in err, f"{label} drive off {kernel}")
    vals = np.fromfile(matrix_bin, dtype=np.float32)
    check(vals.size == N and np.all(np.isfinite(vals)),
          f"{label} drive: .bin holds {vals.size} values")
    peak = 100e6 + (int(np.argmax(vals)) - N // 2) * RATE / N
    check(abs(peak - 100.2e6) <= peak_bins * RATE / N,
          f"{label} drive: peak at {peak}")
    gold = golden_fn()
    err_gold = max_rel(vals, gold)
    budget, cls = GOLDEN_RTOL, ""
    if class_fn is not None:
        err_cls = max_rel(class_fn(), gold)
        budget = max(GOLDEN_RTOL, 3.0 * err_cls)
        cls = f", the scipy f32 class {err_cls:.3e}"
    print(f"e2e {label} ({' '.join(argv)}): exit 0 in {wall:.2f} s wall; "
          f"peak {peak / 1e6:.4f} MHz; .bin max rel vs float64 golden "
          f"{err_gold:.3e} (<= {budget:.3g}{cls}); launches {counts}")
    check(err_gold <= budget, f"{label} drive vs float64 golden")
    check_only(counts, kernel, f"{label} drive")
    return counts[kernel]


def golden_moments_dev(raw, n_valid, window=None):
    """golden_moments of (F, 2N) u8 frames on the card: float64 (s1, s2)
    as numpy rows (zeros for no frame)."""
    if n_valid == 0:
        zero = np.zeros(raw.shape[-1] // 2)
        return zero, zero.copy()
    p = power64_dev(raw[:n_valid], window)
    return p.sum(0).cpu().numpy(), (p * p).sum(0).cpu().numpy()


def golden_tapers_dev(raw, n_valid, tapers):
    """golden_tapers of (F, 2N) u8 frames on the card, a frame at a time:
    the float32 taper rows in float64."""
    t = torch.as_tensor(np.asarray(tapers)).to(raw.device).double()
    total = torch.zeros(raw.shape[-1] // 2, dtype=torch.float64,
                        device=raw.device)
    for f in range(n_valid):
        total += power64_dev(raw[f][None].expand(t.shape[0], -1),
                             t).mean(0)
    return total.cpu().numpy()


def golden_pfb_dev(virtual, n_valid, h):
    """golden_pfb of a (F + P - 1, 2N) u8 virtual row array on the card
    (zeros for no output frame)."""
    if n_valid == 0:
        return np.zeros(virtual.shape[-1] // 2)
    P = h.shape[0]
    z = torch.complex(virtual[:, 0::2].double() - 127.0,
                      virtual[:, 1::2].double() - 127.0)
    hh = torch.as_tensor(np.asarray(h)).to(virtual.device).double()
    s = sum(z[p:p + n_valid] * hh[p] for p in range(P))
    X = torch.fft.fft(s, dim=-1)
    return (X.real ** 2 + X.imag ** 2).sum(0).cpu().numpy()


def phase_estimators_above_16384(dev, rng, fp, adapt_batch, make_window,
                                 cli, ff, card):
    """23. The CLI estimators above 16384 bins: SK-L, MT-L, PFB-L of
    ``fused_psd_large_est`` (forms of the large kernel's two passes, every
    power of two from 32768 to 2^22) and SK-BL, MT-BL, PFB-BL of
    ``fused_psd_chirp_large_est`` at BL's M = 2^16 .. 2^22, each written
    once for S >= 1 streams: each pass's registers, spill and blocks per
    SM beside the base kernel's at every N1 x N2 (every M); each form
    against its plain version and the per-stream float64 golden
    (``hold_streams``), twice (the same bits), on one stream at n_valid F,
    F - 1, 1 and 0 (EST23_ONE; the PFB as four steps from a reset) and at
    S = 2 and 4 with uneven counts (EST23_STREAMS; the PFB over four steps
    and a reset); SK's s1 the base kernel's (its streams entry's) rows bit
    for bit at every N and M, each stream's rows (and PFB history) the S =
    1 form's on the same groups, the gate each stream's own ``sk_keep``;
    the same at each drive's own step, every frame valid and at its last
    step's count among uneven ones; yards (LARGE_EST_YARD_SEEDS seeds) of
    each form (32768 and 65536 Hann for the large kernel's, 20002 for
    BL's); a call, the
    device's time beside the base kernel on the same frames, in turns, the
    wrapper's host time, plain, ``torch.fft.fft`` and the bound at
    EST23_TIMED, and at S = 2 beside two one-stream calls and the base's
    streams entry; ten drives, each on its form alone. The float64 golden
    here is cuFFT's in float64 on the card (power64_dev). Returns the
    kernels-line entries of the large kernel's forms (BL's forms are
    phase 22's kernels, instantiated at more M)."""
    from rtl_power_fftw_tpu_torch.models.multitaper import \
        _session_tapers as _tapers
    from rtl_power_fftw_tpu_torch.models.pfb import \
        pfb_prototype as _prototype
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_chirp_large as fbl
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_chirp_large_est as be
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_large as fl
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_large_est as le
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_sk as fsk
    t0 = time.perf_counter()
    # The DPSS tapers take seconds at 2^20 and above: made once an N.
    _session_tapers = functools.lru_cache(maxsize=None)(_tapers)
    pfb_prototype = functools.lru_cache(maxsize=None)(_prototype)

    # Each family: its module, the name its functions carry, the base
    # kernel (one stream, streams), the index of the frames-a-block its
    # one-stream forms take as group= (pass B of the large kernel, pass C
    # of BL) and the launch-count keys of the base.
    fam = {
        "L": (le, "large", fl.fused_psd_large, fl.fused_psd_large_streams,
              1, "group_b", "L"),
        "BL": (be, "chirp_large", fbl.fused_psd_chirp_large,
               fbl.fused_psd_chirp_large_streams, 2, "group_c", "BL")}

    def fn(f, kind, streams=False):
        mod, name = fam[f][0], fam[f][1]
        return getattr(mod, f"fused_psd_{kind}_{name}"
                       + ("_streams" if streams else ""))

    def ref(f, kind, streams=False):
        mod, name = fam[f][0], fam[f][1]
        return getattr(mod, f"{kind}_{name}"
                       + ("_streams" if streams else "") + "_reference")

    # Registers, spill, shared memory and residency of each pass beside
    # the base kernel's (SK's pass beside the base's pass it changes, the
    # PFB's pass A beside pass A).
    for log2n in range(15, 23):
        N = 1 << log2n
        n1, n2 = fl.large_split(N)
        for which, (name, base) in enumerate((
                ("L-S pass A", fl.PASS_A),
                ("L-S pass A windowed", fl.PASS_A_WINDOWED),
                ("L-S pass B", fl.PASS_B), ("SK-L pass B", fl.PASS_B),
                ("PFB-L pass A", fl.PASS_A))):
            a = le.kernel_attributes(N, which, dev)
            b = fl.kernel_attributes(N, base, dev)
            print(f"occupancy {name} (fused_psd_large_est) N={N} ({n1} x "
                  f"{n2}) on {card}: {a['registers']} registers, "
                  f"{a['spill_bytes']} B spill, {a['static_smem']} + "
                  f"{a['dynamic_smem']} B shared, {a['threads']} threads, "
                  f"{a['blocks_per_sm']} blocks/SM; the large kernel's "
                  f"pass {b['registers']} registers, {b['spill_bytes']} B "
                  f"spill, {b['blocks_per_sm']} blocks/SM")
    for log2m in range(16, 23):
        N = (1 << (log2m - 1)) - 2    # an even N with M = 2^log2m
        for which, (name, base) in enumerate((
                ("BL-S pass A", 0), ("BL-S pass A windowed", 1),
                ("BL-S pass B", 2), ("BL-S pass C", 3), ("SK-BL pass C", 3),
                ("PFB-BL pass A", 0))):
            a = be.kernel_attributes(N, which, dev)
            b = fbl.kernel_attributes(N, base, dev)
            print(f"occupancy {name} (fused_psd_chirp_large_est) "
                  f"M={1 << log2m} on {card}: {a['registers']} registers, "
                  f"{a['spill_bytes']} B spill, {a['static_smem']} + "
                  f"{a['dynamic_smem']} B shared, {a['threads']} threads, "
                  f"{a['blocks_per_sm']} blocks/SM; BL's pass "
                  f"{b['registers']} registers, {b['spill_bytes']} B "
                  f"spill, {b['blocks_per_sm']} blocks/SM")

    # Each drive's step: (family, N, S, F, its last step's count).
    steps = {}
    for key, argv in list(EST23_ONE_ARGV.items()) + list(
            EST23_STREAMS_ARGV.items()):
        S = 2 if key.endswith("-S") else 1
        N = int(argv[argv.index("-b") + 1])
        repeats = int(argv[argv.index("-n") + 1])
        F = adapt_batch(drive_frames_per_step(argv, S))[0]
        steps[key] = ("BL" if "BL" in key else "L", N, S, F,
                      repeats - (-(-repeats // F) - 1) * F)
    steps["SK-L excise"] = ("L", 65536, 1, 256, 256)
    reset_counts(fp, ff)
    forms = [f"{k}-{f}{s}" for f in ("L", "BL") for k in ("SK", "MT", "PFB")
             for s in ("", "-S")]
    want = {k: 0 for k in forms + ["L", "L windowed", "L-S",
                                   "L-S windowed", "BL", "BL windowed",
                                   "BL-S", "BL-S windowed"]}

    def psd_key(f, S, w):
        return fam[f][6] + ("-S" if S > 1 else "") + (
            " windowed" if w is not None else "")

    def group_of(f, N, S, F, windowed):
        return fam[f][0].grid(N, S, F, windowed, dev.index)[fam[f][4]]

    def hold_sk(f, head, raw, counts, chunk, w, sigmas):
        """SK on (S, F, 2N) frames at ``counts``: the one-stream form at S =
        1, else the streams form, twice; against plain and the per-stream
        golden; s1 the base kernel's (its streams entry's) rows; each
        stream the S = 1 form's on the same groups; the gate each stream's
        sk_keep."""
        S, F, N = raw.shape[0], raw.shape[1], raw.shape[2] // 2
        nv = torch.from_numpy(counts).to(dev)
        grp = {fam[f][5]: group_of(f, N, S, F, w is not None)}
        gold = [golden_moments_dev(raw[s], int(c), w)
                for s, c in enumerate(counts)]
        tag = f"SK-{f}" + ("-S" if S > 1 else "")
        for sigma in sigmas:
            if S == 1:
                c = int(counts[0])

                def form():
                    return fn(f, "sk")(raw[0], c, chunk, w, sigma)[None]
                psd = fam[f][2](raw[0], c, chunk, w)[None]
                want_ = ref(f, "sk")(raw[0], c, chunk, w, sigma)[None]
            else:
                def form():
                    return fn(f, "sk", True)(raw, nv, chunk, w, sigma)
                psd = fam[f][3](raw, nv, chunk, w)
                want_ = ref(f, "sk", True)(raw, nv, chunk, w, sigma)
            got, again = form(), form()
            singles = [fn(f, "sk")(raw[s], int(c), chunk, w, sigma, **grp)
                       for s, c in enumerate(counts)]
            torch.cuda.synchronize()
            want[tag] += 2
            want[f"SK-{f}"] += S
            want[psd_key(f, S, w)] += 1
            label = f"{tag} {head} gate={sigma:g}"
            check(torch.equal(got, again), f"{label}: not deterministic")
            check(torch.equal(got[:, 0], psd), f"{label}: s1 is not "
                  f"{psd_key(f, S, w)}'s rows")
            check(all(torch.equal(got[s], singles[s]) for s in range(S)),
                  f"{label}: a stream is not the S = 1 form's")
            g_np, r_np = got.cpu().numpy(), want_.cpu().numpy()
            line = [f"s{i + 1}: " + hold_streams(
                f"{label} s{i + 1}", g_np[:, i], r_np[:, i],
                np.stack([g[i] for g in gold]), counts,
                (i + 1) * GOLDEN_RTOL, FEW_PLAIN) for i in range(2)]
            if sigma > 0.0:
                M = torch.from_numpy(counts.astype(np.float32))[:, None]
                keep = fsk.sk_keep(got[:, 0].cpu(), got[:, 1].cpu(), M,
                                   sigma).numpy()
                check(np.array_equal(g_np[:, 3], M.numpy() * keep)
                      and np.array_equal(g_np[:, 2], g_np[:, 0] * keep),
                      f"{label}: the gate is not each stream's sk_keep")
                line.append(f"gate {int(keep.sum())} of {S * N} "
                            "stream-bins kept, each stream's sk_keep")
            print(f"{label} ({grp}): the same bits twice, s1 "
                  f"{psd_key(f, S, w)}'s rows, each stream the S = 1 "
                  f"form's; " + "; ".join(line))

    def hold_mt(f, head, raw, counts, chunk, K=7):
        """MT on (S, F, 2N) frames at ``counts``, as hold_sk holds SK."""
        S, F, N = raw.shape[0], raw.shape[1], raw.shape[2] // 2
        nv = torch.from_numpy(counts).to(dev)
        grp = {fam[f][5]: group_of(f, N, S, F, True)}
        tp_np = _session_tapers(N, 4.0, K)
        tp = torch.from_numpy(tp_np).to(dev)
        if S == 1:
            def form():
                return fn(f, "tapers")(raw[0], int(counts[0]), chunk,
                                       tp)[None]
            want_ = ref(f, "tapers")(raw[0], int(counts[0]), chunk,
                                     tp)[None]
        else:
            def form():
                return fn(f, "tapers", True)(raw, nv, chunk, tp)
            want_ = ref(f, "tapers", True)(raw, nv, chunk, tp)
        got, again = form(), form()
        singles = [fn(f, "tapers")(raw[s], int(c), chunk, tp, **grp)
                   for s, c in enumerate(counts)]
        torch.cuda.synchronize()
        tag = f"MT-{f}" + ("-S" if S > 1 else "")
        want[tag] += 2
        want[f"MT-{f}"] += S
        label = f"{tag} {head} K={K}"
        check(torch.equal(got, again), f"{label}: not deterministic")
        check(all(torch.equal(got[s], singles[s]) for s in range(S)),
              f"{label}: a stream is not the S = 1 form's")
        gold = np.stack([golden_tapers_dev(raw[s], int(c), tp_np)
                         for s, c in enumerate(counts)])
        print(f"{label} ({grp}): the same bits twice, each stream the S = 1 "
              "form's; " + hold_streams(
                  label, got.cpu().numpy(), want_.cpu().numpy(), gold,
                  counts, plain_factor=FEW_PLAIN))

    def hold_pfb(f, head, N, S, F, chunk, schedule, resets, P=4):
        """PFB over the steps of ``schedule`` (each step's (S,) counts;
        fresh histories at the steps of ``resets``), new frames each step:
        twice, the histories on the card plain's and the virtual rows',
        each stream's rows and history the S = 1 form's on the same
        groups, against plain and the per-stream golden."""
        h_np = pfb_prototype(N, P).reshape(P, N)
        h = torch.from_numpy(h_np).to(dev)
        grp = {fam[f][5]: group_of(f, N, S, F, False)}
        shape = (S, P - 1, 2 * N)
        hist = [torch.empty(shape, dtype=torch.uint8, device=dev)
                for _ in range(3)]
        hist_p = [torch.empty(shape, dtype=torch.uint8, device=dev)
                  for _ in range(2)]
        hs = [[torch.empty(shape[1:], dtype=torch.uint8, device=dev)
               for _ in range(2)] for _ in range(S)]
        virtual = [None] * S
        tag = f"PFB-{f}" + ("-S" if S > 1 else "")
        for k, cnt in enumerate(schedule):
            fresh = k in resets
            step = torch.randint(0, 256, (S, F, 2 * N), dtype=torch.uint8,
                                 device=dev,
                                 generator=torch.Generator(device=dev)
                                 .manual_seed(int(rng.integers(1 << 30))))
            c_dev = torch.from_numpy(cnt).to(dev)
            if S == 1:
                c = int(cnt[0])
                got = fn(f, "pfb")(step[0], hist[0][0], c, chunk, h,
                                   hist[1][0], fresh=fresh)[None]
                again = fn(f, "pfb")(step[0], hist[0][0], c, chunk, h,
                                     hist[2][0])[None]
                want_ = ref(f, "pfb")(step[0], hist_p[0][0], c, chunk, h,
                                      hist_p[1][0], fresh=fresh)[None]
            else:
                got = fn(f, "pfb", True)(step, hist[0], c_dev, chunk, h,
                                         hist[1], fresh=fresh)
                again = fn(f, "pfb", True)(step, hist[0], c_dev, chunk, h,
                                           hist[2])
                want_ = ref(f, "pfb", True)(step, hist_p[0], c_dev, chunk,
                                            h, hist_p[1], fresh=fresh)
            singles = [fn(f, "pfb")(step[s], hs[s][0], int(c), chunk, h,
                                    hs[s][1], fresh=fresh, **grp)
                       for s, c in enumerate(cnt)]
            torch.cuda.synchronize()
            want[tag] += 2
            want[f"PFB-{f}"] += S
            gold, cls = [], np.ones(S)
            for s, c in enumerate(cnt):
                if fresh:
                    virtual[s] = torch.full((P - 1, 2 * N), 127,
                                            dtype=torch.uint8, device=dev)
                v = torch.cat([virtual[s], step[s]])
                gold.append(golden_pfb_dev(v, int(c), h_np))
                if N >= CLASS_FEW_N and c > 0:
                    # The scipy float32 class on the same polyphase sums.
                    sums = fpf.pfb_sums_reference(v, h, int(c)).cpu().numpy()
                    cls[s] = max_rel(f32_class_rows(
                        sums.astype(np.complex128)).sum(0), gold[-1])
                virtual[s] = v[int(c):int(c) + P - 1]
            same_hist = (torch.equal(hist[1], hist[2])
                         and torch.equal(hist[1], hist_p[1])
                         and torch.equal(hist[1], torch.stack(virtual)))
            same_one = all(torch.equal(got[s], singles[s])
                           and torch.equal(hist[1][s], hs[s][1])
                           for s in range(S))
            label = (f"{tag} {head} P={P} step {k}"
                     f"{' (a reset)' if fresh and k else ''}")
            check(torch.equal(got, again) and same_hist and same_one,
                  f"{label}: the same bits twice, histories {same_hist}, "
                  f"S = 1 bits {same_one}")
            print(f"{label} counts {cnt.tolist()} ({grp}): the same bits "
                  "twice, histories on the card plain's and the virtual "
                  "rows' bit for bit, each stream's rows and history the S "
                  "= 1 form's; " + hold_streams(
                      label, got.cpu().numpy(), want_.cpu().numpy(),
                      np.stack(gold), cnt, plain_factor=FEW_PLAIN,
                      class_rel=cls if N >= CLASS_FEW_N else None))
            hist[0], hist[1] = hist[1], hist[0]
            hist_p.reverse()
            for s in range(S):
                hs[s].reverse()

    def frames_dev(S, F, N):
        return torch.randint(0, 256, (S, F, 2 * N), dtype=torch.uint8,
                             device=dev, generator=torch.Generator(
                                 device=dev).manual_seed(
                                     int(rng.integers(1 << 30))))

    def window_dev(wname, N):
        return (None if wname is None else
                torch.from_numpy(make_window(wname, N)).to(dev))

    def case(f, N, S, F, wname, sigmas, schedule, resets):
        """SK, MT and the PFB at S streams of F frames over the counts of
        ``schedule`` (SK and MT at each; the PFB as the schedule's steps
        from a reset)."""
        chunk = adapt_batch(F)[1]
        w = window_dev(wname, N)
        raw = frames_dev(S, F, N)
        for counts in schedule:
            head = (f"N={N} S={S} F={F} chunk={chunk} window={wname} "
                    f"counts {counts.tolist()}")
            hold_sk(f, head, raw, counts, chunk, w, sigmas)
            hold_mt(f, head, raw, counts, chunk)
        hold_pfb(f, f"N={N} S={S} F={F} chunk={chunk}", N, S, F, chunk,
                 schedule, resets)
        print(f"wall: estimators above 16384 bins, {f} N={N} S={S} F={F} "
              f"held at {time.perf_counter() - t0:.1f} s")

    for f in ("L", "BL"):
        for N, F, wname, sigmas in EST23_ONE[f]:
            case(f, N, 1, F, wname, sigmas,
                 [np.array([c], np.int32) for c in (
                     (F, 1) if N in EST23_LARGEST else (F, F - 1, 1, 0))],
                 (0,))
        for N in EST23_S1[f]:
            hold_sk(f, f"N={N} S=1 F=8 chunk=8 window=None counts [8]",
                    frames_dev(1, 8, N), np.array([8], np.int32), 8, None,
                    (0.0,))
        for N, S, F, wname, counts in EST23_STREAMS[f]:
            counts = np.array(counts, np.int32)
            case(f, N, S, F, wname, (0.0, 3.0),
                 [counts, np.roll(counts, 1), np.roll(counts, 3), counts],
                 (0, 3))
    # SK under --fft-backend bluestein at a power of two: BL's form at M =
    # 2^16, its s1 BL's bits.
    raw = frames_dev(1, 16, 32768)
    for c in (16, 15, 1, 0):
        hold_sk("BL", f"N=32768 (bluestein) S=1 F=16 counts [{c}]", raw,
                np.array([c], np.int32), 16, None, (0.0, 3.0))
    # Each drive's own step, every frame valid, then its last step's count
    # beside uneven ones; the PFB over both steps from a reset history.
    for key, (f, N, S, F, last) in steps.items():
        chunk = adapt_batch(F)[1]
        head = (f"at the drive step of {key} (N={N} S={S} F={F} "
                f"chunk={chunk}, last step {last})")
        full = np.full(S, F, np.int32)
        uneven = np.resize(np.array([last, F - 1, 0, 1], np.int32), S)
        if key.startswith("PFB"):
            hold_pfb(f, head, N, S, F, chunk, [full, uneven], (0,))
            continue
        for counts in (full, uneven):
            raw = frames_dev(S, F, N)
            at = f"{head} counts {counts.tolist()}"
            if key.startswith("SK"):
                w = window_dev("hann" if key == "SK-L excise" else None, N)
                hold_sk(f, at, raw, counts, chunk, w,
                        (3.0 if key == "SK-L excise" else 0.0,))
            else:
                hold_mt(f, at, raw, counts, chunk)
    counts_now = launch_counts(fp, ff)
    check(all(counts_now[k] == v for k, v in want.items())
          and not any(v for k, v in counts_now.items() if k not in want),
          f"estimators above 16384 bins: launch counts {counts_now}, "
          f"expected {want}")
    print(f"wall: estimators above 16384 bins checks in "
          f"{time.perf_counter() - t0:.1f} s")

    # The yards: LARGE_EST_YARD_SEEDS seeds of 35 dB tones, each form
    # against the float64 golden and the scipy float32 class, one stream:
    # the large kernel's
    # forms at 32768 (8 frames a seed) and 65536 Hann (4), BL's at 20002
    # (8, M = 2^16).
    reset_counts(fp, ff)
    yards = (("L", 32768, 8, None), ("L", 65536, 4, "hann"),
             ("BL", 20002, 8, None))
    for f, N, Fy, wname in yards:
        w_np = None if wname is None else make_window(wname, N)
        w = window_dev(wname, N)
        wd = 1.0 if w_np is None else w_np.astype(np.float64)

        def on_card(r):
            return torch.from_numpy(r).to(dev)

        def z64(r, wd=wd):
            return dequant64(r) * wd

        tp_np = _session_tapers(N, 4.0, 7)
        tp = torch.from_numpy(tp_np).to(dev)
        P = 4
        h_np = pfb_prototype(N, P).reshape(P, N)
        h = torch.from_numpy(h_np).to(dev)
        hist = [torch.empty((P - 1, 2 * N), dtype=torch.uint8, device=dev)
                for _ in range(2)]
        warm = np.full((P - 1, 2 * N), 127, np.uint8)
        tail = f" {wname}" if wname else ""
        estimator_yard(
            f"SK-{f} s2{tail}",
            lambda r, f=f, w=w, Fy=Fy: fn(f, "sk")(on_card(r), Fy, Fy,
                                                   w)[1].cpu().numpy(),
            lambda r, w_np=w_np, Fy=Fy: golden_moments(r, Fy, w_np)[1],
            lambda r, z64=z64: (f32_class_rows(z64(r)) ** 2).sum(0),
            N, Fy, 23000 + N, LARGE_EST_YARD_SEEDS)
        estimator_yard(
            f"MT-{f} K=7",
            lambda r, f=f, tp=tp, Fy=Fy: fn(f, "tapers")(
                on_card(r), Fy, Fy, tp).cpu().numpy(),
            lambda r, tp_np=tp_np, Fy=Fy: golden_tapers(r, Fy, tp_np),
            lambda r, tp_np=tp_np: f32_class_rows(
                dequant64(r)[:, None, :] * tp_np.astype(np.float64)[None]
            ).mean(1).sum(0), N, Fy, 23100 + N, LARGE_EST_YARD_SEEDS)

        def pfb_class(r, h_np=h_np, warm=warm, Fy=Fy):
            sums = fpf.pfb_sums_reference(
                torch.from_numpy(np.concatenate([warm, r])),
                torch.from_numpy(h_np), Fy).numpy()
            return f32_class_rows(sums.astype(np.complex128)).sum(0)

        estimator_yard(
            f"PFB-{f} P=4",
            lambda r, f=f, h=h, hist=hist, Fy=Fy: fn(f, "pfb")(
                on_card(r), hist[0], Fy, Fy, h, hist[1],
                fresh=True).cpu().numpy(),
            lambda r, h_np=h_np, warm=warm, Fy=Fy: golden_pfb(
                np.concatenate([warm, r]), Fy, h_np),
            pfb_class, N, Fy, 23200 + N, LARGE_EST_YARD_SEEDS)
    counts_now = launch_counts(fp, ff)
    check(all(counts_now[k] == 2 * LARGE_EST_YARD_SEEDS
              for k in ("SK-L", "MT-L", "PFB-L"))
          and all(counts_now[k] == LARGE_EST_YARD_SEEDS
                  for k in ("SK-BL", "MT-BL", "PFB-BL"))
          and sum(counts_now.values()) == 9 * LARGE_EST_YARD_SEEDS,
          f"estimators above 16384 bins, the yards' launches: {counts_now}")
    print(f"wall: estimators above 16384 bins yards in "
          f"{time.perf_counter() - t0:.1f} s")

    # Times (PERF.md states their prediction), each form beside its base
    # kernel on the same frames, in turns: a call (median of 60 event-timed
    # calls), the device's part (twice), the wrapper's host part, the plain
    # version, torch.fft.fft on the same transforms (F frames; F K tapered
    # frames; F polyphase sums) and the bound; over S = 2 streams beside
    # two one-stream calls and the base's streams entry.
    times = {}
    K, P = 7, 4
    timed = [(f, N, 1, F, wname) for f in ("L", "BL")
             for N, F, wname in EST23_TIMED[f]] + [
        (f, *EST23_TIMED_STREAMS[f][:1], 2, *EST23_TIMED_STREAMS[f][1:])
        for f in ("L", "BL")]
    for f, N, S, F, wname in timed:
        chunk = adapt_batch(F)[1]
        w = window_dev(wname, N)
        raw = frames_dev(S, F, N)
        nv = torch.full((S,), F, dtype=torch.int32, device=dev)
        z = torch.complex(raw[..., 0::2].float() - 127.0,
                          raw[..., 1::2].float() - 127.0).reshape(S * F, N)
        if w is not None:
            z = z * w
        tp = torch.from_numpy(_session_tapers(N, 4.0, K)).to(dev)
        h = torch.from_numpy(pfb_prototype(N, P).reshape(P, N)).to(dev)
        hist = [torch.full((S, P - 1, 2 * N), 127, dtype=torch.uint8,
                           device=dev) for _ in range(2)]
        bound = {"SK": estimator_bound_ms("SK", S * F, N, w is not None),
                 "MT": estimator_bound_ms("MT", S * F, N, K=K),
                 "PFB": estimator_bound_ms("PFB", S * F, N, P=P)}
        zz = {"SK": z, "MT": (z[:, None, :] * tp[None]).reshape(-1, N),
              "PFB": torch.cat([fpf.pfb_sums_reference(
                  torch.cat([hist[0][s], raw[s]]), h, F)
                  for s in range(S)])}
        if S == 1:
            calls = {
                "SK": (lambda: fn(f, "sk")(raw[0], F, chunk, w),
                       lambda: ref(f, "sk")(raw[0], F, chunk, w)),
                "MT": (lambda: fn(f, "tapers")(raw[0], F, chunk, tp),
                       lambda: ref(f, "tapers")(raw[0], F, chunk, tp)),
                "PFB": (lambda: fn(f, "pfb")(raw[0], hist[0][0], F, chunk,
                                             h, hist[1][0]),
                        lambda: ref(f, "pfb")(raw[0], hist[0][0], F, chunk,
                                              h, hist[1][0]))}

            def psd_call(raw=raw, F=F, chunk=chunk, w=w, f=f):
                return fam[f][2](raw[0], F, chunk, w)
            singles = {}
        else:
            calls = {
                "SK": (lambda: fn(f, "sk", True)(raw, nv, chunk, w),
                       lambda: ref(f, "sk", True)(raw, nv, chunk, w)),
                "MT": (lambda: fn(f, "tapers", True)(raw, nv, chunk, tp),
                       lambda: ref(f, "tapers", True)(raw, nv, chunk, tp)),
                "PFB": (lambda: fn(f, "pfb", True)(raw, hist[0], nv, chunk,
                                                   h, hist[1]),
                        lambda: ref(f, "pfb", True)(raw, hist[0], nv, chunk,
                                                    h, hist[1]))}

            def psd_call(raw=raw, nv=nv, chunk=chunk, w=w, f=f):
                return fam[f][3](raw, nv, chunk, w)
            singles = {
                "SK": lambda: [fn(f, "sk")(raw[s], F, chunk, w)
                               for s in range(S)],
                "MT": lambda: [fn(f, "tapers")(raw[s], F, chunk, tp)
                               for s in range(S)],
                "PFB": lambda: [fn(f, "pfb")(raw[s], hist[0][s], F, chunk,
                                             h, hist[1][s])
                                for s in range(S)]}
        for kind, (kernel, plain_fn) in calls.items():
            got = kernel().double()
            plain = plain_fn().double()
            rel = max_rel(got.cpu().numpy(), plain.cpu().numpy())
            label = f"{kind}-{f}{'-S' * (S > 1)}"
            check(rel <= UNIFORM_RTOL, f"{label} timed shape N={N}: {rel} "
                  "vs plain")
            kd, bd, sd = [], [], []
            for _ in range(2):
                kd.append(device_times_us(kernel))
                bd.append(device_times_us(psd_call))
                if singles:
                    sd.append(device_times_us(singles[kind], calls=10))
            t = {"N": N, "S": S, "F": F, "window": wname,
                 "max_abs": float((got - plain).abs().max()),
                 "bound": bound[kind], "call": event_times_us(kernel),
                 "plain": event_times_us(plain_fn, iters=20, warmup=3),
                 # MT's 2 K + 1 launches a call: 20 calls keep the launch
                 # queue from filling, which would count device time.
                 "host": host_us(kernel, calls=20 if kind == "MT" else 100),
                 "lib": event_times_us(
                     lambda: torch.fft.fft(zz[kind], dim=-1)),
                 "lib_device": device_times_us(
                     lambda: torch.fft.fft(zz[kind], dim=-1)),
                 "device": min(kd), "psd_device": min(bd)}
            pair = ""
            if singles:
                t["singles"] = event_times_us(singles[kind], iters=20,
                                              warmup=3)
                t["singles_device"] = min(sd)
                pair = (f"; two one-stream calls {t['singles']:.1f} us, "
                        f"device {sd[0]:.1f}/{sd[1]:.1f} (streams/two "
                        f"{t['device'] / t['singles_device']:.3f})")
            times.setdefault(label, []).append(t)
            b_us = 1e3 * t["bound"][0]
            psd = psd_key(f, S, w)
            print(f"time estimator above 16384 bins {label} S={S} N={N} "
                  f"F={F} window={wname}"
                  f"{f' K={K}' if kind == 'MT' else ''}"
                  f"{f' P={P}' if kind == 'PFB' else ''} on {card}: a call "
                  f"{t['call']:.1f} us, device {kd[0]:.1f}/{kd[1]:.1f} us, "
                  f"host {t['host']:.1f} us "
                  f"({S * F * N / t['device'] / 1e3:.2f} GS/s on the "
                  f"device); {psd} on the same frames device "
                  f"{bd[0]:.1f}/{bd[1]:.1f} us, form/{psd.split()[0]} "
                  f"{t['device'] / t['psd_device']:.3f}{pair}; plain "
                  f"{t['plain']:.1f} us; torch.fft.fft of the "
                  f"{tuple(zz[kind].shape)} complex64 transforms "
                  f"{t['lib']:.1f} us a call (device {t['lib_device']:.1f});"
                  f" bound {b_us:.2f} us ({t['bound'][1]}), device/bound "
                  f"{t['device'] / b_us:.1f}x; max abs vs plain "
                  f"{t['max_abs']:.4g}, max rel {rel:.3e}")
    for key, (f, N, S, F, _) in steps.items():
        chunk = adapt_batch(F)[1]
        raw = frames_dev(S, F, N)
        nv = torch.full((S,), F, dtype=torch.int32, device=dev)
        excise = key == "SK-L excise"
        w = window_dev("hann" if excise else None, N)
        tpk = torch.from_numpy(_session_tapers(N, 4.0, 7)).to(dev)
        hk = torch.from_numpy(pfb_prototype(N, 4).reshape(4, N)).to(dev)
        hist = [torch.full((S, 3, 2 * N), 127, dtype=torch.uint8,
                           device=dev) for _ in range(2)]
        kind = key.split("-")[0]
        if S == 1:
            kernel = {
                "SK": lambda: fn(f, "sk")(raw[0], F, chunk, w,
                                          3.0 if excise else 0.0),
                "MT": lambda: fn(f, "tapers")(raw[0], F, chunk, tpk),
                "PFB": lambda: fn(f, "pfb")(raw[0], hist[0][0], F, chunk,
                                            hk, hist[1][0])}[kind]

            def psd_call(raw=raw, F=F, chunk=chunk, w=w, f=f):
                return fam[f][2](raw[0], F, chunk, w)
        else:
            kernel = {
                "SK": lambda: fn(f, "sk", True)(raw, nv, chunk),
                "MT": lambda: fn(f, "tapers", True)(raw, nv, chunk, tpk),
                "PFB": lambda: fn(f, "pfb", True)(raw, hist[0], nv, chunk,
                                                  hk, hist[1])}[kind]

            def psd_call(raw=raw, nv=nv, chunk=chunk, f=f):
                return fam[f][3](raw, nv, chunk)
        kd = device_times_us(kernel, calls=10)
        pd = device_times_us(psd_call, calls=10)
        print(f"time estimator above 16384 bins at the drive step of {key} "
              f"(S={S} N={N} F={F}) on {card}: device {kd:.1f} us, "
              f"{psd_key(f, S, w)} {pd:.1f} us, {kd / pd:.3f}x; a call "
              f"{event_times_us(kernel, iters=20, warmup=3):.1f} us")
    print(f"wall: estimators above 16384 bins times in "
          f"{time.perf_counter() - t0:.1f} s")

    # The drives, each on its form alone.
    launches = {k: 0 for k in forms}
    with tempfile.TemporaryDirectory() as tmp:
        launches["SK-L"] += drive_sk_excise(cli, fp, ff, tmp, N=65536,
                                            key="SK-L", window="hann")
        for key, argv in EST23_ONE_ARGV.items():
            form = key.split()[0]
            kind = form.split("-")[0]
            N = int(argv[argv.index("-b") + 1])
            repeats = int(argv[argv.index("-n") + 1])
            tag = re.sub(r"\W+", "_", f"{key}_{N}")
            record = os.path.join(tmp, f"{tag}.iq")
            sk_path = os.path.join(tmp, f"{tag}.sk")
            extra = [f"--sk-file={sk_path}"] if kind == "SK" else []

            def golden(kind=kind, record=record, N=N, repeats=repeats):
                raw_d = torch.from_numpy(
                    recorded_frames(record, N)[:repeats]).to(dev)
                if kind == "MT":
                    pwr = golden_tapers_dev(raw_d, repeats,
                                            _session_tapers(N, 4.0, 7))
                elif kind == "PFB":
                    pwr = golden_pfb_dev(torch.cat([torch.full(
                        (3, 2 * N), 127, dtype=torch.uint8, device=dev),
                        raw_d]), repeats, pfb_prototype(N, 4).reshape(4, N))
                else:
                    pwr = golden_moments_dev(raw_d, repeats)[0]
                return golden_finalize_linear(np.fft.fftshift(pwr), repeats,
                                              RATE)

            opts = " ".join(argv[argv.index("-b"):argv.index("--source")])
            label = f"estimator above 16384 bins {key} {opts}"
            # The tapers' spectral window is 2 NW = 8 bins wide: its peak
            # may fall NW bins from the tone.
            peak_bins = 4 if kind == "MT" else 1
            if key in EST23_MATRIX:
                launches[form] += matrix_estimator_drive(
                    label, argv + ["-q", "-m", os.path.join(tmp, tag),
                                   "--record", record], cli, fp, ff, form,
                    N, golden, peak_bins, os.path.join(tmp, tag) + ".bin")
                continue
            launches[form] += drive(
                label, argv + extra + ["--record", record], cli, fp, ff,
                form, N, golden, GOLDEN_RTOL, peak_bins=peak_bins)
            if kind == "SK":
                frames_np = recorded_frames(record, N)[:repeats]
                sk_file, sk_err = sk_file_error(sk_path, frames_np, repeats)
                print(f"e2e estimator above 16384 bins {key} -b {N} SK "
                      f"file: {len(sk_file)} bins, max |SK - float64 "
                      f"golden| {sk_err:.3e} (<= 1e-4)")
                check(len(sk_file) == N and sk_err <= 1e-4,
                      f"{key} -b {N} drive: SK file")
        for key, argv in EST23_STREAMS_ARGV.items():
            launches[key] += drive_awkward_streams(
                f"estimator above 16384 bins {key} "
                f"{' '.join(argv[argv.index('-b'):argv.index('--source')])}",
                argv, key, key.split("-")[0], cli, fp, ff, tmp)
    print(f"wall: estimators above 16384 bins phase in "
          f"{time.perf_counter() - t0:.1f} s")

    def entry(name, key, replaces):
        t = times[key][0]
        out = {"name": name, "route": "cuda",
               "source": CSRC + "fused_psd_large_est.cu",
               "replaces": replaces, "launches": launches[key],
               "max_abs_err": t["max_abs"], "ms": t["call"] / 1000.0,
               "plain_ms": t["plain"] / 1000.0, "bound_ms": t["bound"][0],
               "bound_by": t["bound"][1], "library_ms": t["lib"] / 1000.0,
               "device_ms": t["device"] / 1000.0,
               "host_ms": t["host"] / 1000.0,
               ("streams_psd_device_ms" if key.endswith("-S")
                else "large_device_ms"): t["psd_device"] / 1000.0}
        if "singles" in t:
            out["singles_ms"] = t["singles"] / 1000.0
            out["singles_device_ms"] = t["singles_device"] / 1000.0
        return out

    return [entry(f"fused_psd_{name}_large{'_streams' * s} "
                  f"({kind}-L{'-S' * s})", f"{kind}-L{'-S' * s}",
                  replaces[s])
            for kind, name, replaces in (
                ("SK", "sk", ("rtl_power_fftw_tpu/models/kurtosis.py:46",
                              "rtl_power_fftw_tpu/models/kurtosis.py:205")),
                ("MT", "tapers",
                 ("rtl_power_fftw_tpu/models/multitaper.py:60",
                  "rtl_power_fftw_tpu/models/multitaper.py:227")),
                ("PFB", "pfb", ("rtl_power_fftw_tpu/models/pfb.py:48",
                                "rtl_power_fftw_tpu/models/pfb.py:262")))
            for s in (0, 1)]


# Phase 24's CLI drives at ML's bin counts (the line source, linear output),
# less their "--record <path>" and SK files; the burst drive is
# drive_sk_excise at 20000 bins with Hann (the session refuses the
# estimators with --welch-overlap, as the JAX package's does). Those at
# 10^6 bins and above write matrix output (-q -m), as phase 23's largest.
EST24_ONE_ARGV = {
    "SK-ML": ["-f", "100M", "-n", "64", "-b", "100000", "-l", "--source",
              LINE_SOURCE],
    "MT-ML": ["-f", "100M", "-n", "8", "-b", "1000000", "-l",
              "--multitaper", "7", "--source", LINE_SOURCE],
    "PFB-ML": ["-f", "100M", "-n", "64", "-b", "100000", "-l",
               "--pfb-taps", "4", "--source", LINE_SOURCE],
    "PFB-ML 4167450": ["-f", "100M", "-n", "8", "-b", "4167450", "-l",
                       "--pfb-taps", "4", "--source", LINE_SOURCE],
    "SK-ML matrix": ["-f", "100M", "-n", "8", "-b", "1000000", "-l",
                     "--source", LINE_SOURCE],
}
EST24_MATRIX = ("MT-ML", "PFB-ML 4167450", "SK-ML matrix")
EST24_STREAMS_ARGV = {
    "SK-ML-S": ["-f", "100M", "-n", "32", "-b", "100000", "-l", "--streams",
                "2", "--source", LINE_SOURCE],
    "MT-ML-S": ["-f", "100M", "-n", "32", "-b", "20000", "-l", "--streams",
                "2", "--multitaper", "7", "--source", LINE_SOURCE],
    "PFB-ML-S": ["-f", "100M", "-n", "32", "-b", "49152", "-l", "--streams",
                 "2", "--pfb-taps", "4", "--source", LINE_SOURCE],
}
# Phase 24's cases: (N, F, window, SK gates) on one stream, each at n_valid
# F, F - 1, 1 and 0; (N, S, F, window, counts) over streams.
EST24_ONE = ((20000, 16, None, (0.0, 3.0)), (20000, 16, "hann", (3.0,)),
             (49152, 16, None, (0.0,)), (100000, 8, None, (0.0,)),
             (10 ** 6, 8, None, (0.0,)), (4167450, 2, None, (0.0,)))
EST24_STREAMS = ((100000, 2, 8, None, (8, 3)),
                 (20000, 4, 8, "hann", (8, 0, 3, 7)))
# Phase 24's timed shapes: (N, F, window) of one stream beside ML (the
# shapes PERF.md times ML at), and (N, F a stream, window) at S = 2 beside
# two one-stream calls and ML-S.
EST24_TIMED = ((10 ** 6, 8, None), (100000, 64, None))
EST24_TIMED_STREAMS = (100000, 32, None)
# From this N phase 24 holds few-frame steps by the FFTW-class budget as
# well (hold_streams' class_rel, phase 23's CLASS_FEW_N rule): under
# random bytes the DC bin holds ~50x the mean power at 10^6 bins.
EST24_CLASS_N = 10 ** 6
# The yards: (N, frames a seed, window).
EST24_YARDS = ((20000, 8, "hann"), (100000, 4, None), (10 ** 6, 2, None))


def phase_estimators_ml(dev, rng, fp, adapt_batch, make_window, cli, ff,
                        card):
    """24. The CLI estimators at the large even 7-smooth bin counts: SK-ML,
    MT-ML, PFB-ML of ``fused_psd_mixed_large_est`` (forms of ML's two
    passes at every even 7-smooth N from 16386 to 2^22 that is not a power
    of two), each written once for S >= 1 streams: each pass's registers,
    spill and blocks per SM beside ML's at each tested N; each form against
    its plain version and the per-stream float64 golden
    (``hold_streams``), twice (the same bits), on one stream at n_valid F,
    F - 1, 1 and 0 (EST24_ONE; the PFB as four steps from a reset) and at
    S = 2 and 4 with uneven counts (EST24_STREAMS; the PFB over four steps
    and a reset); SK's s1 ML's (ML-S's) rows bit for bit at every case and
    timed shape, each stream's rows (and PFB history) the S = 1 form's on
    the same groups, the gate each stream's own ``sk_keep``; the same at
    each drive's own step, every frame valid and at its last step's count
    among uneven ones; 60-seed yards of each form (EST24_YARDS); a call,
    the device's time beside ML on the same frames, in turns, the
    wrapper's host time, plain, ``torch.fft.fft`` and the bound at
    EST24_TIMED, and at S = 2 beside two one-stream calls and ML-S; each
    form's device time by pass from the profiler beside ML's; nine drives,
    each on its form alone. The float64 golden is cuFFT's in float64 on
    the card (power64_dev). Returns the kernels-line entries."""
    from rtl_power_fftw_tpu_torch.models.multitaper import \
        _session_tapers as _tapers
    from rtl_power_fftw_tpu_torch.models.pfb import \
        pfb_prototype as _prototype
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed_large \
        as fml
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_mixed_large_est as me
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_sk as fsk
    t0 = time.perf_counter()
    _session_tapers = functools.lru_cache(maxsize=None)(_tapers)
    pfb_prototype = functools.lru_cache(maxsize=None)(_prototype)

    def fn(kind, streams=False):
        return getattr(me, f"fused_psd_{kind}_mixed_large"
                       + ("_streams" if streams else ""))

    def ref(kind, streams=False):
        return getattr(me, f"{kind}_mixed_large"
                       + ("_streams" if streams else "") + "_reference")

    # Registers, spill, shared memory and residency of each pass beside
    # ML's (SK's pass B beside ML's pass B, the PFB's pass A beside pass A).
    ns = sorted({N for N, *_ in EST24_ONE} | {16464})
    for N in ns:
        t = fml.ml_layout(N)
        for which, (name, base) in enumerate((
                ("ML-S pass A", fml.PASS_A),
                ("ML-S pass A windowed", fml.PASS_A_WINDOWED),
                ("ML-S pass B", fml.PASS_B), ("SK-ML pass B", fml.PASS_B),
                ("PFB-ML pass A", fml.PASS_A))):
            a = me.kernel_attributes(N, which, dev)
            b = fml.kernel_attributes(N, base, dev)
            print(f"occupancy {name} (fused_psd_mixed_large_est) N={N} "
                  f"({t.N1} x {t.N2}, class "
                  f"{'large' if t.which_b == fml.PASS_B_LARGE else 'small'}"
                  f") on {card}: {a['registers']} registers, "
                  f"{a['spill_bytes']} B spill, {a['static_smem']} + "
                  f"{a['dynamic_smem']} B shared, {a['threads']} threads, "
                  f"{a['blocks_per_sm']} blocks/SM; ML's pass "
                  f"{b['registers']} registers, {b['spill_bytes']} B spill, "
                  f"{b['blocks_per_sm']} blocks/SM")

    # Each drive's step: (N, S, F, its last step's count).
    steps = {}
    for key, argv in list(EST24_ONE_ARGV.items()) + list(
            EST24_STREAMS_ARGV.items()):
        S = 2 if key.endswith("-S") else 1
        N = int(argv[argv.index("-b") + 1])
        repeats = int(argv[argv.index("-n") + 1])
        F = adapt_batch(drive_frames_per_step(argv, S))[0]
        steps[key] = (N, S, F, repeats - (-(-repeats // F) - 1) * F)
    steps["SK-ML excise"] = (20000, 1, 256, 256)
    reset_counts(fp, ff)
    forms = [f"{k}-ML{s}" for k in ("SK", "MT", "PFB") for s in ("", "-S")]
    want = {k: 0 for k in forms + ["ML", "ML windowed", "ML-S",
                                   "ML-S windowed"]}

    def psd_key(S, w):
        return "ML" + ("-S" if S > 1 else "") + (
            " windowed" if w is not None else "")

    def group_of(N, S, F, windowed):
        return me.grid(N, S, F, windowed, dev.index)[1]

    def hold_sk(head, raw, counts, chunk, w, sigmas):
        """SK on (S, F, 2N) frames at ``counts``: the one-stream form at S =
        1, else the streams form, twice; against plain and the per-stream
        golden; s1 ML's (ML-S's) rows; each stream the S = 1 form's on the
        same groups; the gate each stream's sk_keep."""
        S, F, N = raw.shape[0], raw.shape[1], raw.shape[2] // 2
        nv = torch.from_numpy(counts).to(dev)
        grp = {"group_b": group_of(N, S, F, w is not None)}
        gold = [golden_moments_dev(raw[s], int(c), w)
                for s, c in enumerate(counts)]
        cls = few_class(raw, counts, gold, lambda z: [
            p.sum(0) for p in (z, z * z)], w)
        tag = "SK-ML" + ("-S" if S > 1 else "")
        for sigma in sigmas:
            if S == 1:
                c = int(counts[0])

                def form():
                    return fn("sk")(raw[0], c, chunk, w, sigma)[None]
                psd = fml.fused_psd_mixed_large(raw[0], c, chunk, w)[None]
                want_ = ref("sk")(raw[0], c, chunk, w, sigma)[None]
            else:
                def form():
                    return fn("sk", True)(raw, nv, chunk, w, sigma)
                psd = fml.fused_psd_mixed_large_streams(raw, nv, chunk, w)
                want_ = ref("sk", True)(raw, nv, chunk, w, sigma)
            got, again = form(), form()
            singles = [fn("sk")(raw[s], int(c), chunk, w, sigma, **grp)
                       for s, c in enumerate(counts)]
            torch.cuda.synchronize()
            want[tag] += 2
            want["SK-ML"] += S
            want[psd_key(S, w)] += 1
            label = f"{tag} {head} gate={sigma:g}"
            check(torch.equal(got, again), f"{label}: not deterministic")
            check(torch.equal(got[:, 0], psd),
                  f"{label}: s1 is not {psd_key(S, w)}'s rows")
            check(all(torch.equal(got[s], singles[s]) for s in range(S)),
                  f"{label}: a stream is not the S = 1 form's")
            g_np, r_np = got.cpu().numpy(), want_.cpu().numpy()
            line = [f"s{i + 1}: " + hold_streams(
                f"{label} s{i + 1}", g_np[:, i], r_np[:, i],
                np.stack([g[i] for g in gold]), counts,
                (i + 1) * GOLDEN_RTOL, FEW_PLAIN,
                None if cls is None else cls[:, i]) for i in range(2)]
            if sigma > 0.0:
                M = torch.from_numpy(counts.astype(np.float32))[:, None]
                keep = fsk.sk_keep(got[:, 0].cpu(), got[:, 1].cpu(), M,
                                   sigma).numpy()
                check(np.array_equal(g_np[:, 3], M.numpy() * keep)
                      and np.array_equal(g_np[:, 2], g_np[:, 0] * keep),
                      f"{label}: the gate is not each stream's sk_keep")
                line.append(f"gate {int(keep.sum())} of {S * N} "
                            "stream-bins kept, each stream's sk_keep")
            print(f"{label} ({grp}): the same bits twice, s1 "
                  f"{psd_key(S, w)}'s rows, each stream the S = 1 form's; "
                  + "; ".join(line))

    def few_class(raw, counts, gold, moments, w=None, tapers=None):
        """From EST24_CLASS_N bins (else None), each stream's scipy float32
        class max rel against its float64 golden rows ``gold`` (S,
        rows): ``moments(|X|^2 of the stream's valid frames)`` of the
        class's transforms (times each taper row where given), as
        hold_pfb holds the PFB's few-frame steps: under random bytes the
        DC bin holds ~50x the mean power at 10^6 bins and its float32
        rounding is 1e-4 of a |X|^4 row's mean."""
        S, N = raw.shape[0], raw.shape[2] // 2
        if N < EST24_CLASS_N:
            return None
        wd = 1.0 if w is None else w.double().cpu().numpy()
        out = np.ones((S, len(gold[0]) if isinstance(gold[0], tuple)
                       else 1))
        for s, c in enumerate(counts):
            if c == 0:
                continue
            z = dequant64(raw[s, :int(c)].cpu().numpy()) * wd
            if tapers is not None:
                z = z[:, None, :] * tapers.astype(np.float64)[None]
            rows = moments(f32_class_rows(z))
            want_rows = gold[s] if isinstance(gold[s], tuple) else [gold[s]]
            out[s] = [max_rel(r, g) for r, g in zip(rows, want_rows)]
        return out

    def hold_mt(head, raw, counts, chunk, K=7):
        """MT on (S, F, 2N) frames at ``counts``, as hold_sk holds SK."""
        S, F, N = raw.shape[0], raw.shape[1], raw.shape[2] // 2
        nv = torch.from_numpy(counts).to(dev)
        grp = {"group_b": group_of(N, S, F, True)}
        tp_np = _session_tapers(N, 4.0, K)
        tp = torch.from_numpy(tp_np).to(dev)
        if S == 1:
            def form():
                return fn("tapers")(raw[0], int(counts[0]), chunk, tp)[None]
            want_ = ref("tapers")(raw[0], int(counts[0]), chunk, tp)[None]
        else:
            def form():
                return fn("tapers", True)(raw, nv, chunk, tp)
            want_ = ref("tapers", True)(raw, nv, chunk, tp)
        got, again = form(), form()
        singles = [fn("tapers")(raw[s], int(c), chunk, tp, **grp)
                   for s, c in enumerate(counts)]
        torch.cuda.synchronize()
        tag = "MT-ML" + ("-S" if S > 1 else "")
        want[tag] += 2
        want["MT-ML"] += S
        label = f"{tag} {head} K={K}"
        check(torch.equal(got, again), f"{label}: not deterministic")
        check(all(torch.equal(got[s], singles[s]) for s in range(S)),
              f"{label}: a stream is not the S = 1 form's")
        gold = np.stack([golden_tapers_dev(raw[s], int(c), tp_np)
                         for s, c in enumerate(counts)])
        cls = few_class(raw, counts, list(gold),
                        lambda p: [p.mean(1).sum(0)], tapers=tp_np)
        print(f"{label} ({grp}): the same bits twice, each stream the S = 1 "
              "form's; " + hold_streams(
                  label, got.cpu().numpy(), want_.cpu().numpy(), gold,
                  counts, plain_factor=FEW_PLAIN,
                  class_rel=None if cls is None else cls[:, 0]))

    def hold_pfb(head, N, S, F, chunk, schedule, resets, P=4):
        """PFB over the steps of ``schedule`` (each step's (S,) counts;
        fresh histories at the steps of ``resets``), new frames each step:
        twice, the histories on the card plain's and the virtual rows',
        each stream's rows and history the S = 1 form's on the same
        groups, against plain and the per-stream golden (from
        EST24_CLASS_N bins also by the scipy float32 class, as phase 23
        holds them from 2^20)."""
        h_np = pfb_prototype(N, P).reshape(P, N)
        h = torch.from_numpy(h_np).to(dev)
        grp = {"group_b": group_of(N, S, F, False)}
        shape = (S, P - 1, 2 * N)
        hist = [torch.empty(shape, dtype=torch.uint8, device=dev)
                for _ in range(3)]
        hist_p = [torch.empty(shape, dtype=torch.uint8, device=dev)
                  for _ in range(2)]
        hs = [[torch.empty(shape[1:], dtype=torch.uint8, device=dev)
               for _ in range(2)] for _ in range(S)]
        virtual = [None] * S
        tag = "PFB-ML" + ("-S" if S > 1 else "")
        for k, cnt in enumerate(schedule):
            fresh = k in resets
            step = frames_dev(S, F, N)
            c_dev = torch.from_numpy(cnt).to(dev)
            if S == 1:
                c = int(cnt[0])
                got = fn("pfb")(step[0], hist[0][0], c, chunk, h,
                                hist[1][0], fresh=fresh)[None]
                again = fn("pfb")(step[0], hist[0][0], c, chunk, h,
                                  hist[2][0])[None]
                want_ = ref("pfb")(step[0], hist_p[0][0], c, chunk, h,
                                   hist_p[1][0], fresh=fresh)[None]
            else:
                got = fn("pfb", True)(step, hist[0], c_dev, chunk, h,
                                      hist[1], fresh=fresh)
                again = fn("pfb", True)(step, hist[0], c_dev, chunk, h,
                                        hist[2])
                want_ = ref("pfb", True)(step, hist_p[0], c_dev, chunk, h,
                                         hist_p[1], fresh=fresh)
            singles = [fn("pfb")(step[s], hs[s][0], int(c), chunk, h,
                                 hs[s][1], fresh=fresh, **grp)
                       for s, c in enumerate(cnt)]
            torch.cuda.synchronize()
            want[tag] += 2
            want["PFB-ML"] += S
            gold, cls = [], np.ones(S)
            for s, c in enumerate(cnt):
                if fresh:
                    virtual[s] = torch.full((P - 1, 2 * N), 127,
                                            dtype=torch.uint8, device=dev)
                v = torch.cat([virtual[s], step[s]])
                gold.append(golden_pfb_dev(v, int(c), h_np))
                if N >= EST24_CLASS_N and c > 0:
                    sums = fpf.pfb_sums_reference(v, h, int(c)).cpu().numpy()
                    cls[s] = max_rel(f32_class_rows(
                        sums.astype(np.complex128)).sum(0), gold[-1])
                virtual[s] = v[int(c):int(c) + P - 1]
            same_hist = (torch.equal(hist[1], hist[2])
                         and torch.equal(hist[1], hist_p[1])
                         and torch.equal(hist[1], torch.stack(virtual)))
            same_one = all(torch.equal(got[s], singles[s])
                           and torch.equal(hist[1][s], hs[s][1])
                           for s in range(S))
            label = (f"{tag} {head} P={P} step {k}"
                     f"{' (a reset)' if fresh and k else ''}")
            check(torch.equal(got, again) and same_hist and same_one,
                  f"{label}: the same bits twice, histories {same_hist}, "
                  f"S = 1 bits {same_one}")
            print(f"{label} counts {cnt.tolist()} ({grp}): the same bits "
                  "twice, histories on the card plain's and the virtual "
                  "rows' bit for bit, each stream's rows and history the S "
                  "= 1 form's; " + hold_streams(
                      label, got.cpu().numpy(), want_.cpu().numpy(),
                      np.stack(gold), cnt, plain_factor=FEW_PLAIN,
                      class_rel=cls if N >= EST24_CLASS_N else None))
            hist[0], hist[1] = hist[1], hist[0]
            hist_p.reverse()
            for s in range(S):
                hs[s].reverse()

    def frames_dev(S, F, N):
        return torch.randint(0, 256, (S, F, 2 * N), dtype=torch.uint8,
                             device=dev, generator=torch.Generator(
                                 device=dev).manual_seed(
                                     int(rng.integers(1 << 30))))

    def window_dev(wname, N):
        return (None if wname is None else
                torch.from_numpy(make_window(wname, N)).to(dev))

    def case(N, S, F, wname, sigmas, schedule, resets):
        # A session's F is a multiple of 8 (adapt_batch); the largest N is
        # held at 2 frames, summed as one chunk.
        chunk = adapt_batch(F)[1] if F % 8 == 0 else F
        w = window_dev(wname, N)
        raw = frames_dev(S, F, N)
        for counts in schedule:
            head = (f"N={N} S={S} F={F} chunk={chunk} window={wname} "
                    f"counts {counts.tolist()}")
            hold_sk(head, raw, counts, chunk, w, sigmas)
            if wname is None or S > 1:
                hold_mt(head, raw, counts, chunk)
        if wname is None or S > 1:
            hold_pfb(f"N={N} S={S} F={F} chunk={chunk}", N, S, F, chunk,
                     schedule, resets)
        print(f"wall: estimators at ML's N, N={N} S={S} F={F} held at "
              f"{time.perf_counter() - t0:.1f} s")

    for N, F, wname, sigmas in EST24_ONE:
        case(N, 1, F, wname, sigmas,
             [np.array([c], np.int32) for c in sorted({F, F - 1, 1, 0},
                                                      reverse=True)], (0,))
    for N, S, F, wname, counts in EST24_STREAMS:
        counts = np.array(counts, np.int32)
        case(N, S, F, wname, (0.0, 3.0),
             [counts, np.roll(counts, 1), np.roll(counts, 3), counts],
             (0, 3))
    # Each drive's own step, every frame valid, then its last step's count
    # beside uneven ones; the PFB over both steps from a reset history.
    for key, (N, S, F, last) in steps.items():
        chunk = adapt_batch(F)[1]
        head = (f"at the drive step of {key} (N={N} S={S} F={F} "
                f"chunk={chunk}, last step {last})")
        full = np.full(S, F, np.int32)
        uneven = np.resize(np.array([last, F - 1, 0, 1], np.int32), S)
        if key.startswith("PFB"):
            hold_pfb(head, N, S, F, chunk, [full, uneven], (0,))
            continue
        for counts in (full, uneven):
            raw = frames_dev(S, F, N)
            at = f"{head} counts {counts.tolist()}"
            if key.startswith("SK"):
                excise = key == "SK-ML excise"
                hold_sk(at, raw, counts, chunk,
                        window_dev("hann" if excise else None, N),
                        (3.0 if excise else 0.0,))
            else:
                hold_mt(at, raw, counts, chunk)
    counts_now = launch_counts(fp, ff)
    check(all(counts_now[k] == v for k, v in want.items())
          and not any(v for k, v in counts_now.items() if k not in want),
          f"estimators at ML's N: launch counts {counts_now}, expected "
          f"{want}")
    print(f"wall: estimators at ML's N checks in "
          f"{time.perf_counter() - t0:.1f} s")

    # The yards: 60 seeds of 35 dB tones, each form against the float64
    # golden (cuFFT's on the card, as the checks above take it) and the
    # scipy float32 class, one stream.
    reset_counts(fp, ff)
    for N, Fy, wname in EST24_YARDS:
        w_np = None if wname is None else make_window(wname, N)
        w = window_dev(wname, N)
        wd = 1.0 if w_np is None else w_np.astype(np.float64)

        def on_card(r):
            return torch.from_numpy(r).to(dev)

        def z64(r, wd=wd):
            return dequant64(r) * wd

        tp_np = _session_tapers(N, 4.0, 7)
        tp = torch.from_numpy(tp_np).to(dev)
        P = 4
        h_np = pfb_prototype(N, P).reshape(P, N)
        h = torch.from_numpy(h_np).to(dev)
        hist = [torch.empty((P - 1, 2 * N), dtype=torch.uint8, device=dev)
                for _ in range(2)]
        warm = np.full((P - 1, 2 * N), 127, np.uint8)
        tail = f" {wname}" if wname else ""
        estimator_yard(
            f"SK-ML s2{tail}",
            lambda r, w=w, Fy=Fy: fn("sk")(on_card(r), Fy, Fy,
                                           w)[1].cpu().numpy(),
            lambda r, w=w, Fy=Fy: golden_moments_dev(on_card(r), Fy,
                                                     w)[1],
            lambda r, z64=z64: (f32_class_rows(z64(r)) ** 2).sum(0),
            N, Fy, 24000 + N)
        estimator_yard(
            "MT-ML K=7",
            lambda r, tp=tp, Fy=Fy: fn("tapers")(
                on_card(r), Fy, Fy, tp).cpu().numpy(),
            lambda r, tp_np=tp_np, Fy=Fy: golden_tapers_dev(
                on_card(r), Fy, tp_np),
            lambda r, tp_np=tp_np: f32_class_rows(
                dequant64(r)[:, None, :] * tp_np.astype(np.float64)[None]
            ).mean(1).sum(0), N, Fy, 24100 + N)

        def pfb_class(r, h_np=h_np, warm=warm, Fy=Fy):
            sums = fpf.pfb_sums_reference(
                torch.from_numpy(np.concatenate([warm, r])),
                torch.from_numpy(h_np), Fy).numpy()
            return f32_class_rows(sums.astype(np.complex128)).sum(0)

        estimator_yard(
            "PFB-ML P=4",
            lambda r, h=h, hist=hist, Fy=Fy: fn("pfb")(
                on_card(r), hist[0], Fy, Fy, h, hist[1],
                fresh=True).cpu().numpy(),
            lambda r, h_np=h_np, warm=warm, Fy=Fy: golden_pfb_dev(
                on_card(np.concatenate([warm, r])), Fy, h_np),
            pfb_class, N, Fy, 24200 + N)
    counts_now = launch_counts(fp, ff)
    check(all(counts_now[k] == 60 * len(EST24_YARDS)
              for k in ("SK-ML", "MT-ML", "PFB-ML"))
          and sum(counts_now.values()) == 180 * len(EST24_YARDS),
          f"estimators at ML's N, the yards' launches: {counts_now}")
    print(f"wall: estimators at ML's N yards in "
          f"{time.perf_counter() - t0:.1f} s")

    # Times (PERF.md states their prediction), each form beside ML on the
    # same frames, in turns: a call (median of 60 event-timed calls), the
    # device's part (twice), the wrapper's host part, the plain version,
    # torch.fft.fft on the same transforms (F frames; F K tapered frames;
    # F polyphase sums) and the bound; over S = 2 streams beside two
    # one-stream calls and ML-S; then each form's device time by pass.
    times = {}
    K, P = 7, 4
    timed = [(N, 1, F, wname) for N, F, wname in EST24_TIMED] + [
        (EST24_TIMED_STREAMS[0], 2, *EST24_TIMED_STREAMS[1:])]
    for N, S, F, wname in timed:
        chunk = adapt_batch(F)[1]
        w = window_dev(wname, N)
        raw = frames_dev(S, F, N)
        nv = torch.full((S,), F, dtype=torch.int32, device=dev)
        z = torch.complex(raw[..., 0::2].float() - 127.0,
                          raw[..., 1::2].float() - 127.0).reshape(S * F, N)
        if w is not None:
            z = z * w
        tp = torch.from_numpy(_session_tapers(N, 4.0, K)).to(dev)
        h = torch.from_numpy(pfb_prototype(N, P).reshape(P, N)).to(dev)
        hist = [torch.full((S, P - 1, 2 * N), 127, dtype=torch.uint8,
                           device=dev) for _ in range(2)]
        bound = {"SK": estimator_bound_ms("SK", S * F, N, w is not None),
                 "MT": estimator_bound_ms("MT", S * F, N, K=K),
                 "PFB": estimator_bound_ms("PFB", S * F, N, P=P)}
        zz = {"SK": z, "MT": (z[:, None, :] * tp[None]).reshape(-1, N),
              "PFB": torch.cat([fpf.pfb_sums_reference(
                  torch.cat([hist[0][s], raw[s]]), h, F)
                  for s in range(S)])}
        if S == 1:
            calls = {
                "SK": (lambda: fn("sk")(raw[0], F, chunk, w),
                       lambda: ref("sk")(raw[0], F, chunk, w)),
                "MT": (lambda: fn("tapers")(raw[0], F, chunk, tp),
                       lambda: ref("tapers")(raw[0], F, chunk, tp)),
                "PFB": (lambda: fn("pfb")(raw[0], hist[0][0], F, chunk, h,
                                          hist[1][0]),
                        lambda: ref("pfb")(raw[0], hist[0][0], F, chunk, h,
                                           hist[1][0]))}

            def psd_call(raw=raw, F=F, chunk=chunk, w=w):
                return fml.fused_psd_mixed_large(raw[0], F, chunk, w)
            singles = {}
            s1 = calls["SK"][0]()[0]
            check(torch.equal(s1, psd_call()),
                  f"SK-ML timed shape N={N} F={F}: s1 is not ML's output")
        else:
            calls = {
                "SK": (lambda: fn("sk", True)(raw, nv, chunk, w),
                       lambda: ref("sk", True)(raw, nv, chunk, w)),
                "MT": (lambda: fn("tapers", True)(raw, nv, chunk, tp),
                       lambda: ref("tapers", True)(raw, nv, chunk, tp)),
                "PFB": (lambda: fn("pfb", True)(raw, hist[0], nv, chunk, h,
                                                hist[1]),
                        lambda: ref("pfb", True)(raw, hist[0], nv, chunk, h,
                                                 hist[1]))}

            def psd_call(raw=raw, nv=nv, chunk=chunk, w=w):
                return fml.fused_psd_mixed_large_streams(raw, nv, chunk, w)
            singles = {
                "SK": lambda: [fn("sk")(raw[s], F, chunk, w)
                               for s in range(S)],
                "MT": lambda: [fn("tapers")(raw[s], F, chunk, tp)
                               for s in range(S)],
                "PFB": lambda: [fn("pfb")(raw[s], hist[0][s], F, chunk, h,
                                          hist[1][s]) for s in range(S)]}
            check(torch.equal(calls["SK"][0]()[:, 0], psd_call()),
                  f"SK-ML-S timed shape N={N}: s1 is not ML-S's rows")
        for kind, (kernel, plain_fn) in calls.items():
            got = kernel().double()
            plain = plain_fn().double()
            rel = max_rel(got.cpu().numpy(), plain.cpu().numpy())
            label = f"{kind}-ML{'-S' * (S > 1)}"
            check(rel <= UNIFORM_RTOL, f"{label} timed shape N={N}: {rel} "
                  "vs plain")
            kd, bd, sd = [], [], []
            for _ in range(2):
                kd.append(device_times_us(kernel))
                bd.append(device_times_us(psd_call))
                if singles:
                    sd.append(device_times_us(singles[kind], calls=10))
            t = {"N": N, "S": S, "F": F, "window": wname,
                 "max_abs": float((got - plain).abs().max()),
                 "bound": bound[kind], "call": event_times_us(kernel),
                 "plain": event_times_us(plain_fn, iters=20, warmup=3),
                 "host": host_us(kernel, calls=20 if kind == "MT" else 100),
                 "lib": event_times_us(
                     lambda: torch.fft.fft(zz[kind], dim=-1)),
                 "lib_device": device_times_us(
                     lambda: torch.fft.fft(zz[kind], dim=-1)),
                 "device": min(kd), "psd_device": min(bd)}
            pair = ""
            if singles:
                t["singles"] = event_times_us(singles[kind], iters=20,
                                              warmup=3)
                t["singles_device"] = min(sd)
                pair = (f"; two one-stream calls {t['singles']:.1f} us, "
                        f"device {sd[0]:.1f}/{sd[1]:.1f} (streams/two "
                        f"{t['device'] / t['singles_device']:.3f})")
            times.setdefault(label, []).append(t)
            b_us = 1e3 * t["bound"][0]
            psd = psd_key(S, w)
            print(f"time estimator at ML's N {label} S={S} N={N} F={F} "
                  f"window={wname}{f' K={K}' if kind == 'MT' else ''}"
                  f"{f' P={P}' if kind == 'PFB' else ''} on {card}: a call "
                  f"{t['call']:.1f} us, device {kd[0]:.1f}/{kd[1]:.1f} us, "
                  f"host {t['host']:.1f} us "
                  f"({S * F * N / t['device'] / 1e3:.2f} GS/s on the "
                  f"device); {psd} on the same frames device "
                  f"{bd[0]:.1f}/{bd[1]:.1f} us, form/{psd.split()[0]} "
                  f"{t['device'] / t['psd_device']:.3f}{pair}; plain "
                  f"{t['plain']:.1f} us; torch.fft.fft of the "
                  f"{tuple(zz[kind].shape)} complex64 transforms "
                  f"{t['lib']:.1f} us a call (device {t['lib_device']:.1f});"
                  f" bound {b_us:.2f} us ({t['bound'][1]}), device/bound "
                  f"{t['device'] / b_us:.1f}x; max abs vs plain "
                  f"{t['max_abs']:.4g}, max rel {rel:.3e}")
        if S == 1 and N == EST24_TIMED[0][0]:
            # By pass, beside ML's, until every pass shows every launch.
            profile_calls(f"ML N={N} F={F}", psd_call,
                          ["ml_cols_kernel", "ml_rows_kernel"],
                          whole=("ml_cols_kernel", "ml_rows_kernel"),
                          tries=4)
            profile_calls(f"SK-ML N={N} F={F}", calls["SK"][0],
                          ["ml_streams_cols", "ml_sk_rows",
                           "est_streams_kernel"],
                          whole=("ml_streams_cols", "ml_sk_rows"), tries=4)
            profile_calls(f"MT-ML N={N} F={F} K={K}", calls["MT"][0],
                          ["ml_streams_cols", "ml_streams_rows",
                           "est_streams_kernel"],
                          whole=("est_streams_kernel",), tries=4)
            profile_calls(f"PFB-ML N={N} F={F} P={P}", calls["PFB"][0],
                          ["ml_pfb_cols", "ml_streams_rows",
                           "streams_rows_sum", "pfb_history"],
                          whole=("ml_pfb_cols", "ml_streams_rows",
                                 "pfb_history"), tries=4)
    for key, (N, S, F, _) in steps.items():
        chunk = adapt_batch(F)[1]
        raw = frames_dev(S, F, N)
        nv = torch.full((S,), F, dtype=torch.int32, device=dev)
        excise = key == "SK-ML excise"
        w = window_dev("hann" if excise else None, N)
        kind = key.split("-")[0]
        if kind == "MT":
            tpk = torch.from_numpy(_session_tapers(N, 4.0, 7)).to(dev)
        if kind == "PFB":
            hk = torch.from_numpy(pfb_prototype(N, 4).reshape(4, N)).to(dev)
            hist = [torch.full((S, 3, 2 * N), 127, dtype=torch.uint8,
                               device=dev) for _ in range(2)]
        if S == 1:
            kernel = {
                "SK": lambda: fn("sk")(raw[0], F, chunk, w,
                                       3.0 if excise else 0.0),
                "MT": lambda: fn("tapers")(raw[0], F, chunk, tpk),
                "PFB": lambda: fn("pfb")(raw[0], hist[0][0], F, chunk, hk,
                                         hist[1][0])}[kind]

            def psd_call(raw=raw, F=F, chunk=chunk, w=w):
                return fml.fused_psd_mixed_large(raw[0], F, chunk, w)
        else:
            kernel = {
                "SK": lambda: fn("sk", True)(raw, nv, chunk),
                "MT": lambda: fn("tapers", True)(raw, nv, chunk, tpk),
                "PFB": lambda: fn("pfb", True)(raw, hist[0], nv, chunk, hk,
                                               hist[1])}[kind]

            def psd_call(raw=raw, nv=nv, chunk=chunk):
                return fml.fused_psd_mixed_large_streams(raw, nv, chunk)
        kd = device_times_us(kernel, calls=10)
        pd = device_times_us(psd_call, calls=10)
        print(f"time estimator at ML's N at the drive step of {key} (S={S} "
              f"N={N} F={F}) on {card}: device {kd:.1f} us, "
              f"{psd_key(S, w)} {pd:.1f} us, {kd / pd:.3f}x; a call "
              f"{event_times_us(kernel, iters=20, warmup=3):.1f} us")
    print(f"wall: estimators at ML's N times in "
          f"{time.perf_counter() - t0:.1f} s")

    # The drives, each on its form alone.
    launches = {k: 0 for k in forms}
    with tempfile.TemporaryDirectory() as tmp:
        launches["SK-ML"] += drive_sk_excise(cli, fp, ff, tmp, N=20000,
                                             key="SK-ML", window="hann")
        for key, argv in EST24_ONE_ARGV.items():
            form = key.split()[0]
            kind = form.split("-")[0]
            N = int(argv[argv.index("-b") + 1])
            repeats = int(argv[argv.index("-n") + 1])
            tag = re.sub(r"\W+", "_", f"{key}_{N}")
            record = os.path.join(tmp, f"{tag}.iq")
            sk_path = os.path.join(tmp, f"{tag}.sk")
            extra = [f"--sk-file={sk_path}"] if kind == "SK" else []

            def golden(kind=kind, record=record, N=N, repeats=repeats):
                raw_d = torch.from_numpy(
                    recorded_frames(record, N)[:repeats]).to(dev)
                if kind == "MT":
                    pwr = golden_tapers_dev(raw_d, repeats,
                                            _session_tapers(N, 4.0, 7))
                elif kind == "PFB":
                    pwr = golden_pfb_dev(torch.cat([torch.full(
                        (3, 2 * N), 127, dtype=torch.uint8, device=dev),
                        raw_d]), repeats, pfb_prototype(N, 4).reshape(4, N))
                else:
                    pwr = golden_moments_dev(raw_d, repeats)[0]
                return golden_finalize_linear(np.fft.fftshift(pwr), repeats,
                                              RATE)

            def pfb_class(record=record, N=N, repeats=repeats):
                # The scipy float32 class on the same polyphase sums: at
                # 4167450 bins the deepest of 8 spectra's bins take a float32
                # FFT past 1e-5 of the golden (matrix_drive's rule).
                virtual = np.concatenate([
                    np.full((3, 2 * N), 127, np.uint8),
                    recorded_frames(record, N)[:repeats]])
                sums = fpf.pfb_sums_reference(
                    torch.from_numpy(virtual),
                    torch.from_numpy(pfb_prototype(N, 4).reshape(4, N)),
                    repeats).numpy()
                return golden_finalize_linear(np.fft.fftshift(
                    f32_class_rows(sums.astype(np.complex128)).sum(0)),
                    repeats, RATE)

            opts = " ".join(argv[argv.index("-b"):argv.index("--source")])
            label = f"estimator at ML's N {key} {opts}"
            peak_bins = 4 if kind == "MT" else 1
            if key in EST24_MATRIX:
                launches[form] += matrix_estimator_drive(
                    label, argv + extra + ["-q", "-m", os.path.join(tmp, tag),
                                           "--record", record], cli, fp, ff,
                    form, N, golden, peak_bins,
                    os.path.join(tmp, tag) + ".bin",
                    pfb_class if kind == "PFB" else None)
            else:
                launches[form] += drive(
                    label, argv + extra + ["--record", record], cli, fp, ff,
                    form, N, golden, GOLDEN_RTOL, peak_bins=peak_bins)
            if kind == "SK":
                frames_np = recorded_frames(record, N)[:repeats]
                sk_file, sk_err = sk_file_error(sk_path, frames_np, repeats)
                print(f"e2e estimator at ML's N {key} -b {N} SK file: "
                      f"{len(sk_file)} bins, max |SK - float64 golden| "
                      f"{sk_err:.3e} (<= 1e-4)")
                check(len(sk_file) == N and sk_err <= 1e-4,
                      f"{key} -b {N} drive: SK file")
        for key, argv in EST24_STREAMS_ARGV.items():
            launches[key] += drive_awkward_streams(
                f"estimator at ML's N {key} "
                f"{' '.join(argv[argv.index('-b'):argv.index('--source')])}",
                argv, key, key.split("-")[0], cli, fp, ff, tmp)
    check(all(launches[k] > 0 for k in forms),
          f"estimators at ML's N: a form no drive launched: {launches}")
    print(f"wall: estimators at ML's N phase in "
          f"{time.perf_counter() - t0:.1f} s")

    def entry(name, key, replaces):
        t = times[key][0]
        out = {"name": name, "route": "cuda",
               "source": CSRC + "fused_psd_mixed_large_est.cu",
               "replaces": replaces, "launches": launches[key],
               "max_abs_err": t["max_abs"], "ms": t["call"] / 1000.0,
               "plain_ms": t["plain"] / 1000.0, "bound_ms": t["bound"][0],
               "bound_by": t["bound"][1], "library_ms": t["lib"] / 1000.0,
               "device_ms": t["device"] / 1000.0,
               "host_ms": t["host"] / 1000.0,
               ("streams_psd_device_ms" if key.endswith("-S")
                else "ml_device_ms"): t["psd_device"] / 1000.0}
        if "singles" in t:
            out["singles_ms"] = t["singles"] / 1000.0
            out["singles_device_ms"] = t["singles_device"] / 1000.0
        return out

    return [entry(f"fused_psd_{name}_mixed_large{'_streams' * s} "
                  f"({kind}-ML{'-S' * s})", f"{kind}-ML{'-S' * s}",
                  replaces[s])
            for kind, name, replaces in (
                ("SK", "sk", ("rtl_power_fftw_tpu/models/kurtosis.py:46",
                              "rtl_power_fftw_tpu/models/kurtosis.py:205")),
                ("MT", "tapers",
                 ("rtl_power_fftw_tpu/models/multitaper.py:60",
                  "rtl_power_fftw_tpu/models/multitaper.py:227")),
                ("PFB", "pfb", ("rtl_power_fftw_tpu/models/pfb.py:48",
                                "rtl_power_fftw_tpu/models/pfb.py:262")))
            for s in (0, 1)]


# Phase 25's shapes by family (one stream, P = 4: phases 22 and 23's timed
# shapes and each family's largest), its S = 2 cases (N, F a stream,
# uneven counts; each timed), its other tap counts (each tap class, and 6
# inside one, where the routes of the classes differ; PFB-L's P = 2 on the
# ring too) and n_valid cases (F - 1, 1 and 0 at one shape), and the
# shapes profiled by pass.
PFB25_ONE = {"L": ((65536, 16), (1 << 20, 8), (1 << 22, 8)),
             "BL": ((16382, 256), (99998, 64), (2097150, 8))}
PFB25_STREAMS = {"L": ((65536, 16, (16, 9)), (1 << 18, 8, (8, 5)),
                       (32768, 64, (64, 37))),
                 "BL": ((99998, 32, (32, 17)),)}
PFB25_TAPS = {"L": ((65536, 64, (2, 6, 8, 16, 32)), (1 << 18, 8, (2,))),
              "BL": ((16382, 16, (2, 6, 8, 16, 32)),)}
PFB25_COUNTS = {"L": (1 << 20, 8), "BL": (99998, 64)}
PFB25_PROFILED = {"L": ((1 << 20, 8), (1 << 22, 8)), "BL": ((2097150, 8),)}
# Phase 25's CLI drive: PFB-L at 2^20 bins, P = 4, where the route takes
# the ring.
PFB25_DRIVE_N = 1 << 20
# The yardsticks PERF.md's rows lacked at their timed shapes: (row, kind
# of estimator_bound_ms, N, F, the complex64 transforms torch.fft.fft
# takes: F frames, F K tapered frames at K = 7).
PFB25_YARDSTICKS = (("SK-L", "SK", 1 << 22, 8, 8),
                    ("MT-L", "MT", 1 << 22, 8, 56),
                    ("SK-BL", "SK", 99998, 64, 64),
                    ("SK-BL", "SK", 2097150, 8, 8),
                    ("MT-BL", "MT", 99998, 64, 448),
                    ("MT-BL", "MT", 2097150, 8, 56),
                    ("PFB-ML", "PFB", 4167450, 8, 8))


def phase_pfb_loads(dev, rng, fp, ff, card):
    """25. PFB-L and PFB-BL's polyphase load redesigned: the pre-pass of
    ``csrc/pfb_sums.cuh`` and pass A on its sums, routed by each wrapper's
    ``PFB_ROUTE``, one stream and over streams, beside their controls (the
    first forms, the sums in pass A's load): registers, spill, shared
    memory and blocks per SM of each new pass beside the control's pass A
    and the base kernel's; each form's output and next history the
    control's bit for bit, and within the budgets of phases 22 and 23 of
    its plain version and the per-stream float64 golden (``hold_streams``,
    the FFTW-class budget from CLASS_FEW_N) at PFB25_ONE, PFB25_STREAMS,
    PFB25_TAPS and PFB25_COUNTS; a call (median of 60 event-timed calls),
    the device's time (twice) of each form, its control, the base kernel
    and torch.fft.fft on the polyphase sums, in turns, with the plain
    version's and the bound, at PFB25_ONE and the S = 2 shapes (there also
    two one-stream calls and the base's streams entry); each form's device
    time by pass at PFB25_PROFILED. Returns {form: fields of its control}
    for the kernels line's entries of PFB-L, PFB-L-S, PFB-BL and
    PFB-BL-S."""
    from rtl_power_fftw_tpu_torch.models.pfb import pfb_prototype
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_chirp_large as fbl
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_chirp_large_est as be
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_large as fl
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_large_est as le
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_pfb as fpf
    t0 = time.perf_counter()
    # Each family: its module, the name its functions carry, the base
    # kernel (one stream, streams) and its attributes, the base's pass A.
    fam = {"L": (le, "large", fl.fused_psd_large,
                 fl.fused_psd_large_streams, fl.kernel_attributes,
                 fl.PASS_A),
           "BL": (be, "chirp_large", fbl.fused_psd_chirp_large,
                  fbl.fused_psd_chirp_large_streams, fbl.kernel_attributes,
                  fbl.PASS_A)}

    def form(f, streams=False, control=False):
        mod, name = fam[f][0], fam[f][1]
        return getattr(mod, f"fused_psd_pfb_{name}"
                       + ("_streams" if streams else "")
                       + ("_control" if control else ""))

    def plain(f, streams=False):
        mod, name = fam[f][0], fam[f][1]
        return getattr(mod, f"pfb_{name}" + ("_streams" if streams else "")
                       + "_reference")

    # 1. What each pass gets on the card.
    for f, shapes in PFB25_ONE.items():
        mod = fam[f][0]
        for N, F in shapes:
            base = fam[f][4](N, fam[f][5], dev)
            parts = []
            passes = [(mod.PFB_PASS_A, "pass A on the sums"),
                      (mod.PFB_SUMS, "pre-pass P <= 4"),
                      (mod.PFB_SUMS_32, "pre-pass P <= 32"),
                      (mod.PFB_CONTROL_A, "the control's pass A")]
            if f == "L" and N <= le.RING_MAX_N:
                passes += [(le.PFB_RING_A, "the ring's pass A P = 4"),
                           (le.PFB_RING_RES_A,
                            "the ring's pass A h resident P = 4")]
            for which, name in passes:
                a = mod.kernel_attributes(N, which, dev)
                parts.append(f"{name} {a['registers']} registers, "
                             f"{a['spill_bytes']} B spill, "
                             f"{a['static_smem']} + {a['dynamic_smem']} B "
                             f"shared, {a['threads']} threads, "
                             f"{a['blocks_per_sm']} blocks/SM")
            print(f"occupancy PFB-{f} N={N} on {card}: " + "; ".join(parts)
                  + f"; the base kernel's pass A {base['registers']} "
                  f"registers, {base['spill_bytes']} B spill, "
                  f"{base['blocks_per_sm']} blocks/SM; route "
                  f"{mod.pfb_route(N, 4, F)} at P = 4, F = {F}")

    def frames_dev(S, F, N):
        return torch.randint(0, 256, (S, F, 2 * N), dtype=torch.uint8,
                             device=dev, generator=torch.Generator(
                                 device=dev).manual_seed(
                                     int(rng.integers(1 << 30))))

    # 2. The control's bits, and plain's and the golden's budgets.
    def bits(f, N, F, P, counts, label, aligned=True):
        S = len(counts)
        raw = frames_dev(S, F, N)
        hist = frames_dev(S, P - 1, N)
        h_np = pfb_prototype(N, P).reshape(P, N)
        h = torch.from_numpy(h_np).to(dev)
        if not aligned:   # the history and h as views 4 bytes past 16
            hist = torch.cat([torch.zeros(4, dtype=torch.uint8, device=dev),
                              hist.reshape(-1)])[4:].view(hist.shape)
            h = torch.cat([torch.zeros(1, device=dev),
                           h.reshape(-1)])[1:].view(h.shape)
        outs = [torch.empty_like(hist) for _ in range(3)]
        c_dev = torch.tensor(counts, dtype=torch.int32, device=dev)
        if S == 1:
            got = form(f)(raw[0], hist[0], counts[0], F, h, outs[0][0])[None]
            ctl = form(f, control=True)(raw[0], hist[0], counts[0], F, h,
                                        outs[1][0])[None]
            want = plain(f)(raw[0], hist[0], counts[0], F, h,
                            outs[2][0])[None]
        else:
            got = form(f, True)(raw, hist, c_dev, F, h, outs[0])
            ctl = form(f, True, True)(raw, hist, c_dev, F, h, outs[1])
            want = plain(f, True)(raw, hist, c_dev, F, h, outs[2])
        torch.cuda.synchronize()
        gold, cls = [], np.ones(S)
        for s, c in enumerate(counts):
            v = torch.cat([hist[s], raw[s]])
            gold.append(golden_pfb_dev(v, c, h_np))
            if N >= CLASS_FEW_N and c > 0:
                sums = fpf.pfb_sums_reference(v, h, c).cpu().numpy()
                cls[s] = max_rel(f32_class_rows(
                    sums.astype(np.complex128)).sum(0), gold[-1])
        same = torch.equal(got, ctl) and torch.equal(outs[0], outs[1])
        check(same and torch.equal(outs[0], outs[2]),
              f"PFB-{f} {label}: not the control's bits ({same}) or not "
              "plain's history")
        print(f"bits PFB-{f}{'-S' * (S > 1)} {label} N={N} F={F} P={P} "
              f"counts {list(counts)} (route "
              f"{fam[f][0].pfb_route(N, P, S * F)}) "
              f"on {card}: output and next history the control's bit for "
              "bit, the history plain's; " + hold_streams(
                  f"PFB-{f} {label}", got.cpu().numpy(),
                  want.cpu().numpy(), np.stack(gold), counts,
                  plain_factor=FEW_PLAIN,
                  class_rel=cls if N >= CLASS_FEW_N else None))

    for f in fam:
        for N, F in PFB25_ONE[f]:
            bits(f, N, F, 4, (F,), "every frame")
        for N, F, counts in PFB25_STREAMS[f]:
            bits(f, N, F, 4, counts, "over streams")
        for N, F, taps in PFB25_TAPS[f]:
            for P in taps:
                bits(f, N, F, P, (F,), f"P={P}")
        N, F = PFB25_COUNTS[f]
        for c in (F - 1, 1, 0):
            bits(f, N, F, 4, (c,), f"n_valid {c}")
        bits(f, N, F, 4, (F,), "history and h 4-byte views", aligned=False)
    print(f"wall: PFB loads' bits in {time.perf_counter() - t0:.1f} s")

    # 3. Times, in turns on the same frames.
    times = {}
    P = 4
    timed = [(f, N, 1, F) for f in fam for N, F in PFB25_ONE[f]] + [
        (f, N, 2, F) for f in fam for N, F, _ in PFB25_STREAMS[f]]
    for f, N, S, F in timed:
        raw = frames_dev(S, F, N)
        h = torch.from_numpy(pfb_prototype(N, P).reshape(P, N)).to(dev)
        hist = [torch.full((S, P - 1, 2 * N), 127, dtype=torch.uint8,
                           device=dev) for _ in range(2)]
        nv = torch.full((S,), F, dtype=torch.int32, device=dev)
        z = torch.cat([fpf.pfb_sums_reference(torch.cat([hist[0][s],
                                                          raw[s]]), h, F)
                       for s in range(S)])
        if S == 1:
            calls = {
                "form": lambda: form(f)(raw[0], hist[0][0], F, F, h,
                                        hist[1][0]),
                "control": lambda: form(f, control=True)(
                    raw[0], hist[0][0], F, F, h, hist[1][0]),
                "base": lambda: fam[f][2](raw[0], F, F),
                "fft": lambda: torch.fft.fft(z, dim=-1)}
            plain_fn = lambda: plain(f)(raw[0], hist[0][0], F, F, h,
                                        hist[1][0])
        else:
            calls = {
                "form": lambda: form(f, True)(raw, hist[0], nv, F, h,
                                              hist[1]),
                "control": lambda: form(f, True, True)(raw, hist[0], nv, F,
                                                       h, hist[1]),
                "base": lambda: fam[f][3](raw, nv, F),
                "fft": lambda: torch.fft.fft(z, dim=-1),
                "two": lambda: [form(f)(raw[s], hist[0][s], F, F, h,
                                        hist[1][s]) for s in range(S)]}
            plain_fn = lambda: plain(f, True)(raw, hist[0], nv, F, h,
                                              hist[1])
        got = calls["form"]().double()
        want = plain_fn().double()
        rel = max_rel(got.cpu().numpy(), want.cpu().numpy())
        check(rel <= UNIFORM_RTOL, f"PFB-{f} S={S} N={N}: {rel} vs plain")
        dev_us = {k: [] for k in calls}
        for order in (list(calls), list(calls)[::-1]):
            for k in order:
                dev_us[k].append(device_times_us(
                    calls[k], calls=10 if k == "two" else 20))
        t = {"N": N, "S": S, "F": F,
             "max_abs": float((got - want).abs().max()),
             "bound": estimator_bound_ms("PFB", S * F, N, P=P),
             "call": event_times_us(calls["form"]),
             "control_call": event_times_us(calls["control"]),
             "plain": event_times_us(plain_fn, iters=20, warmup=3),
             "lib": event_times_us(calls["fft"]),
             **{f"{k}_device": min(v) for k, v in dev_us.items()}}
        label = f"PFB-{f}{'-S' * (S > 1)}"
        t["route"] = fam[f][0].pfb_route(N, P, S * F)
        times.setdefault(label, []).append(t)
        b_us = 1e3 * t["bound"][0]
        two = (f"; two one-stream calls {t['two_device']:.1f} us "
               f"({'/'.join(f'{x:.1f}' for x in dev_us['two'])}), "
               f"streams/two {t['form_device'] / t['two_device']:.3f}"
               if S > 1 else "")
        print(f"time {label} N={N} S={S} F={F} P={P} (route "
              f"{t['route']}) on {card}: a call "
              f"{t['call']:.1f} us, device {t['form_device']:.1f} us "
              f"({'/'.join(f'{x:.1f}' for x in dev_us['form'])}); the "
              f"control a call {t['control_call']:.1f} us, device "
              f"{t['control_device']:.1f} us "
              f"({'/'.join(f'{x:.1f}' for x in dev_us['control'])}), "
              f"form/control {t['form_device'] / t['control_device']:.3f}; "
              f"the base kernel {t['base_device']:.1f} us "
              f"({'/'.join(f'{x:.1f}' for x in dev_us['base'])}), "
              f"form/base {t['form_device'] / t['base_device']:.3f}, "
              f"control/base {t['control_device'] / t['base_device']:.3f}"
              f"{two}; torch.fft.fft of the {tuple(z.shape)} complex64 "
              f"sums {t['lib']:.1f} us a call (device "
              f"{t['fft_device']:.1f}), form/fft "
              f"{t['form_device'] / t['fft_device']:.3f}; plain "
              f"{t['plain']:.1f} us; bound {b_us:.2f} us ({t['bound'][1]}),"
              f" device/bound {t['form_device'] / b_us:.1f}x; max abs vs "
              f"plain {t['max_abs']:.4g}, max rel {rel:.3e}")
    # The other rows' bounds and torch.fft.fft times at their timed shapes.
    for row, kind, N, F, frames in PFB25_YARDSTICKS:
        z = torch.complex(*(torch.randn((frames, N), device=dev)
                            for _ in range(2)))
        lib_us = device_times_us(lambda: torch.fft.fft(z, dim=-1), calls=5)
        b_ms, b_by = estimator_bound_ms(kind, F, N, K=7, P=4)
        print(f"yardstick {row} N={N} F={F} on {card}: torch.fft.fft of "
              f"the ({frames}, {N}) complex64 transforms device "
              f"{lib_us:.1f} us; bound {1e3 * b_ms:.2f} us ({b_by})")
        del z
    # The CLI on PFB-L's ring route (no drive of phases 22 and 23 takes
    # it): matrix output, on PFB-L alone, against the float64 golden.
    from rtl_power_fftw_tpu_torch import cli
    N = PFB25_DRIVE_N
    with tempfile.TemporaryDirectory() as tmp:
        record = os.path.join(tmp, "pfb25.iq")

        def golden():
            raw_d = torch.from_numpy(recorded_frames(record, N)[:8]).to(dev)
            pwr = golden_pfb_dev(torch.cat([torch.full(
                (3, 2 * N), 127, dtype=torch.uint8, device=dev), raw_d]), 8,
                pfb_prototype(N, 4).reshape(4, N))
            return golden_finalize_linear(np.fft.fftshift(pwr), 8, RATE)

        ring_drive = matrix_estimator_drive(
            f"PFB-L -b {N} --pfb-taps 4 (route {le.pfb_route(N, 4, 8)})",
            ["-f", "100M", "-n", "8", "-b", str(N), "-l", "--pfb-taps", "4",
             "--source", LINE_SOURCE, "-q", "-m", os.path.join(tmp, "pfb25"),
             "--record", record], cli, fp, ff, "PFB-L", N, golden, 1,
            os.path.join(tmp, "pfb25") + ".bin")

    # 4. By pass.
    markers = {"L": ["pfb_sums_kernel", "large_pfb_sums_a", "large_pfb_a",
                     "large_pfb_ring_a", "large_streams_b", "pfb_history"],
               "BL": ["pfb_sums_kernel", "chirp_pfb_sums_a", "chirp_pfb_a",
                      "chirp_streams_b", "chirp_streams_c", "pfb_history"]}
    for f, shapes in PFB25_PROFILED.items():
        for N, F in shapes:
            raw = frames_dev(1, F, N)[0]
            h = torch.from_numpy(pfb_prototype(N, P).reshape(P, N)).to(dev)
            hist = [torch.full((P - 1, 2 * N), 127, dtype=torch.uint8,
                               device=dev) for _ in range(2)]
            for control in (False, True):
                profile_calls(
                    f"PFB-{f}{' control' * control} N={N} F={F} P={P}",
                    lambda: form(f, control=control)(raw, hist[0], F, F, h,
                                                     hist[1]),
                    markers[f], whole=["pfb_history"], tries=4)
    print(f"wall: PFB loads phase in {time.perf_counter() - t0:.1f} s")
    control_names = {"L": "large_pfb_a", "BL": "chirp_pfb_a"}

    # Each form's headline fields, its control's beside them, at its first
    # timed shape whose route is not the first form (the kernels line's
    # entry then times the redesigned passes, not the control's kernel
    # twice), and every timed shape's device times.
    def headline(ts):
        t = next(t for t in ts if t["route"] != "load")
        return {"ms": t["call"] / 1000.0, "device_ms": t["form_device"]
                / 1000.0, "plain_ms": t["plain"] / 1000.0,
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": t["lib"] / 1000.0, "max_abs_err": t["max_abs"],
                "timed_shape": [t["N"], t["S"], t["F"], P],
                "timed_route": t["route"],
                "control_ms": t["control_call"] / 1000.0,
                "control_device_ms": t["control_device"] / 1000.0,
                "base_device_ms": t["base_device"] / 1000.0,
                **({"singles_device_ms": t["two_device"] / 1000.0}
                   if "two_device" in t else {})}

    return {label: {
        "control": control_names[label.split("-")[1]] + " (the first form)",
        **headline(ts),
        **({"pfb25_drive": {"N": PFB25_DRIVE_N, "launches": ring_drive,
                            "route": le.pfb_route(PFB25_DRIVE_N, P, 8)}}
           if label == "PFB-L" else {}),
        "pfb25_shapes": [[t["N"], t["S"], t["F"], P] for t in ts],
        "pfb25_routes": [t["route"] for t in ts],
        "pfb25_device_ms": [t["form_device"] / 1000.0 for t in ts],
        "pfb25_control_device_ms": [t["control_device"] / 1000.0
                                    for t in ts],
        "pfb25_base_device_ms": [t["base_device"] / 1000.0 for t in ts],
        "pfb25_fft_device_ms": [t["fft_device"] / 1000.0 for t in ts],
        "pfb25_bound_ms": [t["bound"][0] for t in ts]}
        for label, ts in times.items()}


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing was run.")
        return 1

    from rtl_power_fftw_tpu_torch.auxdata import make_window
    from rtl_power_fftw_tpu_torch import cli
    from rtl_power_fftw_tpu_torch.ops.kernels import _build
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd as fp
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_fast as ff
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_bluestein as fb
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_chirp_large as fbl
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_large as fl
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_mixed as fm
    from rtl_power_fftw_tpu_torch.ops.kernels import \
        fused_psd_mixed_large as fml
    from rtl_power_fftw_tpu_torch.ops.kernels import fused_psd_probe as fpp
    from rtl_power_fftw_tpu_torch.ops.spectral import adapt_batch
    from rtl_power_fftw_tpu_torch.parallel import ShardedPsdStep
    COUNTS, fused_psd, fused_psd_reference = (fp.COUNTS, fp.fused_psd,
                                              fp.fused_psd_reference)
    t_start = time.perf_counter()

    def lap(phase: str) -> None:
        print(f"wall: {phase} done at {time.perf_counter() - t_start:.1f} s")

    # 1. Machine.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"machine: {kind}; torch {torch.__version__}; "
          f"CUDA {torch.version.cuda}; python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)

    # 2. Build.
    t0 = time.perf_counter()
    infos = _build.build()
    for name in _build.SIGNATURES:
        _build.load(name)
    for name, info in infos.items():
        log(info.log.strip())
        print(f"build: {info.path.name} by nvcc in {info.seconds:.1f} s")
    large_ptxas = [line for marker in ("large_pass_a", "large_pass_b")
                   for line in template_ptxas(infos["fused_psd_large"].log,
                                              marker)]
    check(len(large_ptxas) == 24 or not infos["fused_psd_large"].log,
          f"ptxas reported {len(large_ptxas)} large-N instantiations, not 24")
    regs_ptxas = [line for marker in ("large_regs_a", "large_regs_b")
                  for line in template_ptxas(infos["fused_psd_large"].log,
                                             marker)]
    check(len(regs_ptxas) == 24 or not infos["fused_psd_large"].log,
          f"ptxas reported {len(regs_ptxas)} register-pass instantiations, "
          "not 24")
    for lib, marker, first in (
            ("fused_psd_large", "large_pass_a", ""),
            ("fused_psd_large", "large_pass_b", ""),
            ("fused_psd_large", "large_regs_a", ""),
            ("fused_psd_large", "large_regs_b", ""),
            ("fused_psd", "psd_regs_kernel", ""),
            ("fused_psd_fast", "psd_smem_kernel", ""),
            ("fused_psd_fast", "psd_fast_group_kernel", "11"),
            ("fused_psd_probe", "psd_group_kernel", ""),
            ("fused_psd_probe", "psd_regs_kernel", ""),
            ("fused_psd_probe", "psd_fast_group_kernel", "11"),
            ("fused_psd_mixed", "psd_mixed_kernel", ""),
            ("fused_psd_mixed", "psd_ring_kernel", ""),
            ("fused_psd_mixed", "psd_chirp_kernel", ""),
            ("fused_psd_sk", "psd_regs_kernel", ""),
            ("fused_psd_tapers", "psd_regs_kernel", ""),
            ("fused_psd_tapers", "psd_tapers_batch_kernel", ""),
            ("fused_psd_pfb", "psd_pfb_kernel", ""),
            ("fused_psd_pfb", "psd_pfb_ring_kernel", ""),
            ("fused_psd_tapers", "psd_tapers_batch_streams_kernel", ""),
            ("fused_psd_pfb", "psd_pfb_streams_kernel", ""),
            ("fused_psd_pfb", "psd_pfb_ring_streams_kernel", ""),
            ("fused_psd_mixed_large", "tile_cols_kernel", ""),
            ("fused_psd_chirp_large", "tile_cols_kernel", ""),
            ("fused_psd_large", "large_streams_a", ""),
            ("fused_psd_large", "large_streams_b", ""),
            ("fused_psd_mixed_large", "ml_streams_cols", ""),
            ("fused_psd_mixed_large", "ml_streams_rows", ""),
            ("fused_psd_chirp_large", "chirp_streams_a", ""),
            ("fused_psd_chirp_large", "chirp_streams_b", ""),
            ("fused_psd_chirp_large", "chirp_streams_c", ""),
            ("fused_psd_frames", "psd_regs_kernel", ""),
            ("fused_psd_pfb", "pfb_channelize_kernel", ""),
            ("fused_psd_csd", "psd_csd_kernel", ""),
            ("fused_psd_mixed_est", "psd_ring_est_kernel", ""),
            ("fused_psd_chirp_est", "psd_chirp_est_kernel", ""),
            ("fused_psd_mixed_est", "psd_ring_est_streams_kernel", ""),
            ("fused_psd_chirp_est", "psd_chirp_est_streams_kernel", ""),
            ("fused_psd_chirp_large_est", "chirp_streams_a", ""),
            ("fused_psd_chirp_large_est", "chirp_streams_b", ""),
            ("fused_psd_chirp_large_est", "chirp_streams_c", ""),
            ("fused_psd_chirp_large_est", "chirp_sk_c", ""),
            ("fused_psd_chirp_large_est", "chirp_pfb_a", ""),
            ("fused_psd_large_est", "large_streams_a", ""),
            ("fused_psd_large_est", "large_streams_b", ""),
            ("fused_psd_large_est", "large_sk_b", ""),
            ("fused_psd_large_est", "large_pfb_a", ""),
            ("fused_psd_mixed_large_est", "ml_streams_cols", ""),
            ("fused_psd_mixed_large_est", "ml_streams_rows", ""),
            ("fused_psd_mixed_large_est", "ml_sk_rows", "")):
        for entry_name, summary in template_ptxas(infos[lib].log, marker,
                                                  first):
            print(f"ptxas {lib} {entry_name}: {summary}")
    print(f"build: all sources in {time.perf_counter() - t0:.1f} s wall "
          f"(PR 26's run: 80.7 s); the longest nvcc "
          f"{max(i.seconds for i in infos.values()):.1f} s")
    # Every kernel of the digest (sass_diff --write-digest: the parent
    # tree's kernels and the instantiations its PR added) unchanged here.
    from rtl_power_fftw_tpu_torch.ops.kernels import sass_diff
    want_nvcc, have_nvcc, diffs = sass_diff.check_digest(
        {name: infos[name].path for name in sass_diff.SOURCES})
    for name, (n_old, other, n_new) in diffs.items():
        print(f"sass_diff {name} against the digest (built "
              f"by nvcc {want_nvcc}; here {have_nvcc}): {n_old} earlier "
              f"kernels, {n_old - len(other)} identical here, {len(other)} "
              f"missing or different; {n_new} new")
        for k in other:
            print(f"  differs: {k}")
    check(want_nvcc == have_nvcc, "sass_diff: the digest was built by "
          f"another nvcc ({want_nvcc}, here {have_nvcc})")
    check(not any(other for _, other, _ in diffs.values()),
          "sass_diff: an earlier kernel changed")
    for log2n in range(15, 23):
        N = 1 << log2n
        for which, pname in ((fl.PASS_A, "pass A"),
                             (fl.PASS_A_WINDOWED, "pass A windowed"),
                             (fl.PASS_B, "pass B")):
            a = fl.kernel_attributes(N, which)
            print(f"occupancy fused_psd_large N={N} {pname} on {card}: "
                  f"{a['registers']} registers, {a['spill_bytes']} B spill, "
                  f"{a['static_smem']} + {a['dynamic_smem']} B shared, "
                  f"{a['threads']} threads, {a['blocks_per_sm']} blocks/SM; "
                  f"large_group's grid aims at "
                  f"{fl.resident_blocks(N, which, dev.index)} blocks")
    for N in sorted(fp.PASS_PLAN):
        for windowed in (False, True):
            a = fp.kernel_attributes(N, windowed)
            print(f"occupancy fused_psd N={N} "
                  f"{'windowed' if windowed else 'unwindowed'} on {card}: "
                  f"{a['registers']} registers, {a['spill_bytes']} B spill, "
                  f"{a['static_smem']} + {a['dynamic_smem']} B shared, "
                  f"{a['threads']} threads, {a['blocks_per_sm']} blocks/SM; "
                  f"k1_group's grid aims at "
                  f"{fp.resident_blocks(N, windowed, dev.index)} blocks")
    for N in (500, 2400, 6000, 12000, 16200, 16384):
        shape = fm.ring_launch(N)
        for w in (False, True):
            a = fm.ring_attributes(shape, w)
            print(f"occupancy fused_psd_mixed N={N} "
                  f"{'windowed' if w else 'unwindowed'} plan {shape.plan} "
                  f"on {card}: {a['registers']} registers, "
                  f"{a['spill_bytes']} B spill, {a['static_smem']} + "
                  f"{a['dynamic_smem']} B shared, {a['threads']} threads "
                  f"({shape.lanes} lanes of {shape.tf}), last-pass sums "
                  f"{shape.acc} of {shape.acc_class}, {a['blocks_per_sm']} "
                  f"blocks/SM")
    for N in (10, 200, 500, 998, 3000, 8182):
        shape = fb.chirp_launch(N)
        for w in (False, True):
            a = fb.chirp_attributes(N, w)
            print(f"occupancy fused_psd_bluestein N={N} M={shape.M} "
                  f"{'windowed' if w else 'unwindowed'} on {card}: "
                  f"{a['registers']} registers, {a['spill_bytes']} B spill, "
                  f"{a['static_smem']} + {a['dynamic_smem']} B shared, "
                  f"{a['threads']} threads ({shape.lanes} lanes of "
                  f"{shape.tf}), {a['blocks_per_sm']} blocks/SM")
    for label, N, shape in (
            [("fused_psd_mixed_control", N, fm.mixed_launch(N))
             for N in (500, 2400, 12000)]
            + [("fused_psd_bluestein_control", N, fb.bluestein_launch(N))
               for N in (998, 8182)]):
        a = fm.control_attributes(shape, "bluestein" in label)
        print(f"occupancy {label} N={N} plan {shape.plan} on {card}: "
              f"{a['registers']} registers, {a['spill_bytes']} B spill, "
              f"{a['threads']} threads ({shape.lanes} lanes of {shape.tf}), "
              f"{a['blocks_per_sm']} blocks/SM")

    # 11.-12. The stage-attribution probes, then their entry points.
    probe_times = phase_probes(dev, np.random.default_rng(0), fpp, ff, fp,
                               adapt_batch, card)
    lap("probe variants")
    probe_launches = drive_probes(fpp)
    lap("probe entry points")

    # 3. K1 against the plain version (and the float64 golden).
    rng = np.random.default_rng(20261016)
    cases = [  # (label, N, frames_per_step, n_valid or None for all)
        ("canonical drive step", 2048, 400, None),
        ("scan drive step", 256, 3200, 16),
        ("N=256", 256, 1024, None),
        ("N=2048 F=4096", 2048, 4096, None),
        ("N=2048 masked", 2048, 4096, 1000),
        ("N=16384", 16384, 64, None),
    ]
    COUNTS.reset()
    max_abs_2048 = None
    for label, N, fps, n_valid in cases:
        F, chunk = adapt_batch(fps)
        nv = F if n_valid is None else n_valid
        raw_np = rng.integers(0, 256, (F, 2 * N), dtype=np.uint8)
        raw = torch.from_numpy(raw_np).to(dev)
        got = fused_psd(raw, nv, chunk)
        again = fused_psd(raw, nv, chunk)
        want = fused_psd_reference(raw, nv, chunk)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"{label}: kernel not deterministic")
        got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
        err_plain = max_rel(got_np, want_np)
        gold = golden_partial(raw_np, nv)
        err_gold = max_rel(got_np, gold)
        err_plain_gold = max_rel(want_np, gold)
        print(f"kernel {label} (N={N} F={F} chunk={chunk} n_valid={nv}): "
              f"max rel vs plain {err_plain:.3e}, vs float64 golden "
              f"{err_gold:.3e} (plain vs golden {err_plain_gold:.3e})")
        check(np.all(np.isfinite(got_np)), f"{label}: non-finite output")
        check(err_plain <= UNIFORM_RTOL, f"{label}: {err_plain} vs plain")
        check(err_gold <= GOLDEN_RTOL, f"{label}: {err_gold} vs golden")
        if label == "N=2048 F=4096":
            max_abs_2048 = float(np.abs(got_np.astype(np.float64)
                                        - want_np).max())
    check(COUNTS.kernel == 2 * len(cases) and COUNTS.plain == 0,
          f"launch counter did not move as expected: {vars(COUNTS)}")

    # Admission yard of the register transform (ROADMAP North star): 60
    # seeds of 35 dB tones, unwindowed, against the scipy float32 class.
    tone_yard("K1", dev, fp, make_window, None,
              ((256, 64), (2048, 64), (16384, 32)), 500)

    # 4.-6. K2, K3 and K4.
    k2_abs = phase_k2(dev, rng, fp, adapt_batch, make_window)
    k3_abs = phase_k3(dev, rng, ff, adapt_batch, make_window, card)
    k4_abs = phase_k4(dev, rng, fp, adapt_batch, make_window, ShardedPsdStep)
    lap("K1 to K4 against plain")
    large_abs = phase_large(dev, rng, fp, fl, adapt_batch, make_window)
    lap("the large kernel against plain")

    # 7. Times (median of 60 event-timed calls after 10 warm-ups; device
    # times beside them).
    times, control = phase_times(dev, rng, fp, ff, fl, fpp, adapt_batch,
                                 make_window, card)
    # The redesign against the radix-2 kernel it replaced, in this run, at
    # the two shapes the ROADMAP ranks: a call (what a caller waits), and
    # the device's work, which must be at most half the control's.
    for key in (("K1", 2048, 4096, None), ("K2", 8192, 1024, "hann")):
        k_call, k_dev = min(times[key][0], times[key][2]), times[key][6]
        r_call = min(control[key][0], control[key][2])
        r_dev = min(control[key][1], control[key][3])
        print(f"redesign {key[0]} N={key[1]} F={key[2]} window={key[3]} on "
              f"{card}: a call {k_call:.1f} us against the radix-2 "
              f"control's {r_call:.1f} us, {k_call / r_call:.3f}; device "
              f"{k_dev:.1f} us against {r_dev:.1f} us, {k_dev / r_dev:.3f} "
              f"(<= 0.5)")
        check(k_dev <= 0.5 * r_dev, f"{key}: {k_dev} us of device time is "
              f"above half the radix-2 control's {r_dev} us")
    # The large kernel's register passes against its radix-2 passes: at
    # most half the control's device time at config 3's step, at most
    # the control's at every other large shape.
    for key in [k for k in times if k[0] == "L"]:
        k_call, k_dev = min(times[key][0], times[key][2]), times[key][6]
        r_call = min(control[key][0], control[key][2])
        r_dev = min(control[key][1], control[key][3])
        limit = 0.5 if key == ("L", C3_N, 8, None) else 1.0
        print(f"redesign L N={key[1]} F={key[2]} window={key[3]} on {card}: "
              f"a call {k_call:.1f} us against the radix-2 control's "
              f"{r_call:.1f} us, {k_call / r_call:.3f}; device {k_dev:.1f} us "
              f"against {r_dev:.1f} us, {k_dev / r_dev:.3f} (<= {limit}); "
              f"host {control[key][5]:.1f} us against {control[key][4]:.1f} "
              f"us, {control[key][5] / control[key][4]:.3f}")
        check(k_dev <= limit * r_dev, f"{key}: {k_dev} us of device time is "
              f"above {limit} of the radix-2 control's {r_dev} us")
    # K3 against the kernel it replaced: at most 0.6 of its device time at
    # N = 2048, F = 4096 unwindowed, at most the control's at its other
    # shapes.
    for key in [k for k in times if k[0] == "K3"]:
        k_call, k_dev = min(times[key][0], times[key][2]), times[key][6]
        r_call = min(control[key][0], control[key][2])
        r_dev = min(control[key][1], control[key][3])
        limit = 0.6 if key == ("K3", 2048, 4096, None) else 1.0
        print(f"redesign K3 N={key[1]} F={key[2]} window={key[3]} on {card}: "
              f"a call {k_call:.1f} us against the control's {r_call:.1f} "
              f"us, {k_call / r_call:.3f}; device {k_dev:.1f} us against "
              f"{r_dev:.1f} us, {k_dev / r_dev:.3f} (<= {limit}); host "
              f"{control[key][5]:.1f} us against {control[key][4]:.1f} us, "
              f"{control[key][5] / control[key][4]:.3f}")
        check(k_dev <= limit * r_dev, f"{key}: {k_dev} us of device time is "
              f"above {limit} of the control's {r_dev} us")
    k3_split(dev, rng, ff, make_window, card)
    lap("times")

    # 8. End to end, in-process through the CLI.
    with tempfile.TemporaryDirectory() as tmp:
        record = os.path.join(tmp, "canonical.iq")
        N, repeats = 2048, 20000
        launches = drive(
            "canonical", ["-f", "100M", "-n", str(repeats), "-b", str(N),
                          "-l", "--record", record, "--source", SOURCE],
            cli, fp, ff, "K1", N,
            lambda: recorded_golden(record, N, repeats, N), GOLDEN_RTOL)

        scan = os.path.join(tmp, "scan")
        argv = ["-f", "100M:106M", "-n", "16", "-b", "256", "-q", "-m", scan,
                "--source", "synthetic:tone=104.9M/40,noise=5,seed=2,"
                "dead=103M"]
        reset_counts(fp, ff)
        rc, out, err, wall = run_cli(argv, cli.main)
        counts = launch_counts(fp, ff)
        log(err[-800:])
        check(rc == 0, f"scan drive exited {rc}")
        check("Unable to tune to 103000000. Dropping from frequency list."
              in err, "scan drive: dead hop not dropped")
        with open(scan + ".met") as f:
            meta = [line.split("#")[0].strip() for line in f]
        cols, nrows = int(meta[0]), int(meta[1])
        data = np.fromfile(scan + ".bin", dtype=np.float32)
        check(cols == 2 * 256 and nrows == 1 and data.size == cols,
              f"scan drive: .met says {cols}x{nrows}, .bin has {data.size}")
        hop = int(np.argmax(data)) // 256
        peak = 105e6 + (int(np.argmax(data)) % 256 - 128) * RATE / 256
        check(hop == 1 and abs(peak - 104.9e6) <= RATE / 256,
              f"scan drive: peak at {peak} Hz in hop {hop}")
        print(f"e2e scan drive: exit 0 in {wall:.2f} s wall; dead hop "
              f"dropped; .met {cols}x{nrows}, .bin {data.nbytes} bytes; "
              f"peak {peak / 1e6:.4f} MHz; launches {counts}")
        check_only(counts, "K1", "scan drive")

        k2_launches = drive_config2(cli, fp, ff, make_window, tmp)
        k3_launches = drive_precision_high(cli, fp, ff, make_window, tmp)
        k4_launches = drive_config5(cli, fp, ff, tmp)
        k4w_launches = drive_streams_scan(cli, fp, ff, tmp)
        large_launches, c3_argv = drive_config3(cli, fp, ff, tmp)
        large_w_launches = drive_large_windowed(cli, fp, ff, make_window,
                                                tmp)
        drive_large_sweep(cli, fp, ff, make_window, tmp)
        lap("drives")
        # 10. Where the config 3 drive's device time goes, and config 5's
        # consumer's host time.
        profile_drive("config 3", c3_argv, cli,
                      ["Memcpy HtoD", "large_regs_a", "large_regs_b",
                       "psd_rows_sum", "psd_sum_kernel", "Memcpy DtoH"])
        profile_consumer("config 5", config5_argv(
            os.path.join(tmp, "config5_profiled.iq")), cli)
        lap("profiles")

    # 13. The awkward-N kernels.
    awkward = phase_awkward(dev, np.random.default_rng(20261017), fp, fm, fb,
                            adapt_batch, make_window, cli, ff, card)
    lap("awkward N")

    # 14. The estimator kernels (SK, multitaper, PFB).
    estimators = phase_estimators(dev, np.random.default_rng(20261018), fp,
                                  adapt_batch, make_window, cli, ff, card)
    lap("estimators")

    # 15. The large awkward-N kernels (ML, BL).
    large_awkward = phase_large_awkward(
        dev, np.random.default_rng(20261019), fp, fml, fbl, adapt_batch,
        make_window, cli, ff, card)
    lap("large awkward N")

    # 16. The estimators' streams entries (SK-S, MT-S, PFB-S).
    estimator_streams = phase_estimator_streams(
        dev, np.random.default_rng(20261020), fp, adapt_batch, make_window,
        cli, ff, card)
    lap("estimators over streams")

    # 17. The streams entries of the large kernel, ML and BL.
    large_streams = phase_large_streams(
        dev, np.random.default_rng(20261021), fp, fl, fml, fbl, adapt_batch,
        make_window, cli, ff, card)
    lap("large N over streams")

    # 18. The library estimators' kernels (FR, PFB-C, CSD, SCF).
    library = phase_library_estimators(
        dev, np.random.default_rng(20261022), fp, adapt_batch, make_window,
        ff, card)
    lap("library estimators")

    # 19. The CLI estimators at the awkward bin counts (SK-M, MT-M, PFB-M).
    mixed_estimators = phase_mixed_estimators(
        dev, np.random.default_rng(20261023), fp, adapt_batch, make_window,
        cli, ff, card)
    lap("mixed estimators")

    # 20. The CLI estimators at the chirp-Z bin counts (SK-B, MT-B, PFB-B).
    chirp_estimators = phase_chirp_estimators(
        dev, np.random.default_rng(20261024), fp, adapt_batch, make_window,
        cli, ff, card)
    lap("chirp estimators")

    # 21. The CLI estimators over --streams at the awkward bin counts
    # (SK-M-S ... PFB-B-S).
    awkward_streams = phase_awkward_streams(
        dev, np.random.default_rng(20261025), fp, adapt_batch, make_window,
        cli, ff, card)
    lap("awkward streams estimators")

    # 22. The CLI estimators at the large chirp-Z bin counts (SK-BL ...
    # PFB-BL-S).
    large_estimators = phase_large_estimators(
        dev, np.random.default_rng(20261026), fp, adapt_batch, make_window,
        cli, ff, card)
    lap("large chirp-Z estimators")

    # 23. The CLI estimators above 16384 bins (SK-L ... PFB-L-S, and
    # SK-BL ... PFB-BL-S at M = 2^16 .. 2^22).
    estimators_above = phase_estimators_above_16384(
        dev, np.random.default_rng(20261027), fp, adapt_batch, make_window,
        cli, ff, card)
    lap("estimators above 16384 bins")

    # 24. The CLI estimators at ML's bin counts (SK-ML ... PFB-ML-S).
    estimators_ml = phase_estimators_ml(
        dev, np.random.default_rng(20261028), fp, adapt_batch, make_window,
        cli, ff, card)
    lap("estimators at ML's N")

    # 25. PFB-L and PFB-BL's polyphase load redesigned, beside their
    # controls.
    pfb_controls = phase_pfb_loads(dev, np.random.default_rng(20261029), fp,
                                   ff, card)
    lap("PFB loads")
    print(f"wall: the whole script to phase 25's end in "
          f"{time.perf_counter() - t_start:.1f} s of its 1200 s limit")
    for e in estimators_above + large_estimators:
        label = re.search(r"\((PFB-B?L(?:-S)?)\)", e["name"])
        if label and label.group(1) in pfb_controls:
            # The fields timed at phase 22 or 23's shape give way to phase
            # 25's, all at one shape.
            for k in ("host_ms", "large_device_ms", "chirp_large_device_ms",
                      "streams_psd_device_ms", "singles_ms",
                      "singles_device_ms"):
                e.pop(k, None)
            e.update(pfb_controls[label.group(1)])

    check(not any(m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes")
                  for m in sys.modules), "jax was imported")

    def entry(name, source, replaces, launches, max_abs, key):
        k_us, p_us, _, lib_us, b_ms, b_by, kd_us, _ = times[key]
        out = {"name": name, "route": "cuda", "source": CSRC + source,
               "replaces": (replaces if ".py:" in replaces
                            else TPU_KERNEL + replaces),
               "launches": launches, "max_abs_err": max_abs,
               "ms": k_us / 1000.0, "plain_ms": p_us / 1000.0,
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_us / 1000.0, "device_ms": kd_us / 1000.0}
        if key in control:   # the radix-2 control it was timed against
            c = control[key]
            out["control_ms"] = min(c[0], c[2]) / 1000.0
            out["control_device_ms"] = min(c[1], c[3]) / 1000.0
            if len(c) > 4:
                out["host_ms"] = c[5] / 1000.0
                out["control_host_ms"] = c[4] / 1000.0
        return out

    def probe_entry(name, tpu, key):
        ms, plain_ms, b_ms, b_by, max_abs, lib_ms = probe_times[key]
        source = ("probes/cast_test.py:16" if tpu == "P12"
                  else fpp.PROBES[tpu].source)
        return {"name": name, "route": "cuda",
                "source": CSRC + "fused_psd_probe.cu", "replaces": source,
                "launches": probe_launches[tpu], "max_abs_err": max_abs,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms, "device_ms": ms}

    print(json.dumps({"kernels": [
        entry("fused_psd", "fused_psd.cu", "435", launches, max_abs_2048,
              ("K1", 2048, 4096, None)),
        entry("fused_psd (windowed)", "fused_psd.cu", "261", k2_launches,
              k2_abs, ("K2", 2048, 4096, "hann")),
        entry("fused_psd_fast", "fused_psd_fast.cu", "298", k3_launches,
              k3_abs, ("K3", 2048, 4096, None)),
        entry("fused_psd_streams", "fused_psd.cu", "327", k4_launches,
              k4_abs[None], ("K4", 2048, 256, None)),
        entry("fused_psd_streams (windowed)", "fused_psd.cu", "327",
              k4w_launches, k4_abs["hann"], ("K4", 2048, 256, "hann")),
        entry("fused_psd_large", "fused_psd_large.cu",
              "probes/big_kernel.py:113", large_launches, large_abs[None],
              ("L", C3_N, 8, None)),
        entry("fused_psd_large (windowed)", "fused_psd_large.cu", "261",
              large_w_launches, large_abs["hann"],
              ("L", 65536, 16, "hann")),
    ] + awkward + estimators + large_awkward + estimator_streams
      + large_streams + library + mixed_estimators + chirp_estimators
      + awkward_streams + large_estimators + estimators_above
      + estimators_ml + [
        probe_entry(name, tpu, key)
         for name, tpu, key in (("fused_psd_probe P1 (profile_kernel: full)",
                                 "P1", "k3"),
                                ("fused_psd_probe P18 (s1_lanes: full)",
                                 "P18", "tpu6"),
                                ("fused_psd_probe P13 (s1_lanes2: i32tr)",
                                 "P13", "tpu6_wide32"),
                                ("relayout_probe P12 (cast_test: C control)",
                                 "P12", "C"),
                                ("fused_psd_probe P14 (s2_fourmult: v7)",
                                 "P14", "tpu6_4mult"),
                                ("fused_psd_probe P16 (s2_left: e2left)",
                                 "P16", "tpu6_e2left"),
                                ("fused_psd_probe P19 (s2_ilv: ilv)",
                                 "P19", "tpu6_ilv2"),
                                ("fused_psd_probe P11 (s2_pipe: pipe)",
                                 "P11", "tpu6_pipe"),
                                ("fused_psd_probe P17 (s2_u32t: u32t)",
                                 "P17", "tpu6_u32t"),
                                ("fused_psd_probe P2 (profile_kernel: pack8)",
                                 "P2", "k3_pack"),
                                ("fused_psd_probe P6 (profile_kernel: "
                                 "pack8c)", "P6", "k3_pack_pq"),
                                ("fused_psd_probe P5 (profile_kernel: "
                                 "s1wide)", "P5", "k3_s1wide"),
                                ("fused_psd_probe P3 (profile_kernel: "
                                 "dg3dall)", "P3", "k3_dg3dall"),
                                ("fused_psd_probe P4 (profile_kernel: "
                                 "s1cat)", "P4", "k3_s1cat"),
                                ("fused_psd_probe P7 (profile_kernel: "
                                 "s1k32)", "P7", "k3_s1k32"),
                                ("fused_psd_probe P8 (profile_kernel: "
                                 "best)", "P8", "k3_best"),
                                ("fused_psd_probe P9 (profile_kernel: "
                                 "v5left)", "P9", "k3_left"),
                                ("fused_psd_probe P10 (profile_kernel: "
                                 "v6k)", "P10", "tpu6_kstack"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
