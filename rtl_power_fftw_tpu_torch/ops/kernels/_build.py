"""Build the CUDA sources with nvcc and load them with ctypes, at first use.

Each ``csrc/*.cu`` has a plain C interface and is compiled by ``nvcc``
alone into its own shared library, without PyTorch's headers, and bound
with :mod:`ctypes`. :func:`load` builds the one library it is asked for,
if it has no build yet, so a session compiles only the kernels it runs
(never the stage-attribution probes of ``fused_psd_probe.cu``);
:func:`build` starts one ``nvcc`` per named source that has no library
yet, all at once, and waits for them. A library is keyed on a hash of its
source, every ``csrc/*.cuh``
header and the flags, so an edited source rebuilds. It is written under a
temporary name and renamed, so a concurrent process never loads a
half-written file. A failed build raises with nvcc's own message; there
is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).with_name("csrc")
#: Build outputs; listed in .gitignore.
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: Exported C functions of each library: name -> argtypes (all return int).
#: Every pointer and the stream are c_void_p, so ctypes does not cut them
#: to 32 bits.
SIGNATURES = {
    "fused_psd": {
        # raw, twiddle, window, partial, out, device, log2n, F, group,
        # n_valid, stream
        "rpf_fused_psd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # raw, twiddle, window, n_valid, partial, out, device, log2n, S, F,
        # group, stream
        "rpf_fused_psd_streams": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _P],
        # log2n, windowed, device, attrs (int[6])
        "rpf_fused_psd_attributes": [_I, _I, _I, _P],
    },
    "fused_psd_fast": {
        # raw, window, w1, twiddle, w2, partial, out, device, log2n, F,
        # group, n_valid, stream
        "rpf_fused_psd_fast": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _P],
        # log2n, windowed, device, attrs (int[6])
        "rpf_fused_psd_fast_attributes": [_I, _I, _I, _P],
        # a cut at N = 2048: cut, then rpf_fused_psd_fast's arguments
        "rpf_fused_psd_fast_cut": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _P],
        # the control: raw, window, w1r, w1i, twiddle, w2, partial, out,
        # device, log2n, F, group, n_valid, stream
        "rpf_fused_psd_fast_control": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                       _I, _I, _I, _I, _P],
    },
    "fused_psd_large": {
        # raw, twiddle, inter, window, scratch, partial, out, device, log2n,
        # F, group_a, group_b, n_valid, stream
        "rpf_fused_psd_large": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _P],
        # raw, twiddle, inter, window, counts, scratch, partial, out,
        # device, log2n, S, F, group_a, group_b, stream
        "rpf_fused_psd_large_streams": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                        _I, _I, _I, _I, _I, _P],
        # log2n, which (0 pass A, 1 pass A windowed, 2 pass B), device,
        # attrs (int[6])
        "rpf_fused_psd_large_attributes": [_I, _I, _I, _P],
        # the radix-2 control: raw, twiddle, inter, window, scratch,
        # partial, out, device, log2n, F, group, n_valid, stream
        "rpf_fused_psd_large_radix2": [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _I, _P],
    },
    "fused_psd_mixed": {
        # the mixed-radix kernel: raw, twiddle, order, window, partial, out,
        # plan (int[55]), device, F, group, n_valid, width, stream
        "rpf_fused_psd_mixed": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _P],
        # raw, twiddle, order, window, n_valid, partial, out, plan, device,
        # S, F, group, width, stream
        "rpf_fused_psd_mixed_streams": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                        _I, _I, _I, _I, _P],
        # plan, windowed, device, attrs (int[6])
        "rpf_fused_psd_mixed_attributes": [_P, _I, _I, _P],
        # the chirp-Z kernel: raw, twiddle, window, chirp, spectrum,
        # partial, out, device, log2m, bins, F, group, n_valid, width,
        # stream
        "rpf_fused_psd_chirp": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _I, _P],
        # raw, twiddle, window, chirp, spectrum, n_valid, partial, out,
        # device, log2m, bins, S, F, group, width, stream
        "rpf_fused_psd_chirp_streams": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                        _I, _I, _I, _I, _I, _I, _P],
        # log2m, bins, windowed, device, attrs (int[6])
        "rpf_fused_psd_chirp_attributes": [_I, _I, _I, _I, _P],
        # the control: raw, twiddle, window, chirp, spectrum, partial,
        # out, plan (int[17]), device, F, group, n_valid, stream
        "rpf_fused_psd_mixed_control": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                        _I, _I, _I, _P],
        # raw, twiddle, window, chirp, spectrum, n_valid, partial, out,
        # plan, device, S, F, group, stream
        "rpf_fused_psd_mixed_control_streams": [_P, _P, _P, _P, _P, _P, _P,
                                                _P, _P, _I, _I, _I, _I, _P],
        # plan, chirp, windowed, device, attrs (int[6])
        "rpf_fused_psd_mixed_control_attributes": [_P, _I, _I, _I, _P],
    },
    "fused_psd_mixed_est": {
        # SK-M: raw, twiddle, order, window, partial, out, plan (int[55]),
        # device, F, group, n_valid, two_sigma, width, stream
        "rpf_fused_psd_sk_mixed": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _F, _I, _P],
        # MT-M: raw, twiddle, order, tapers, partial, out, plan, device, F,
        # group, K, n_valid, width, stream
        "rpf_fused_psd_tapers_mixed": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                       _I, _I, _I, _P],
        # PFB-M: raw, history, twiddle, order, h, partial, out, history_out,
        # plan, device, F, group, n_valid, P, fresh, width, stream
        "rpf_fused_psd_pfb_mixed": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _I, _I, _P],
        # plan, cut (1 SK, 2 tapers, 3 PFB), windowed, device, attrs (int[6])
        "rpf_fused_psd_mixed_est_attributes": [_P, _I, _I, _I, _P],
        # SK-M-S: raw, twiddle, order, window, n_valid, partial, out, plan,
        # device, S, F, group, two_sigma, width, stream
        "rpf_fused_psd_sk_mixed_streams": [_P, _P, _P, _P, _P, _P, _P, _P,
                                           _I, _I, _I, _I, _F, _I, _P],
        # MT-M-S: raw, twiddle, order, tapers, n_valid, partial, out, plan,
        # device, S, F, group, K, width, stream
        "rpf_fused_psd_tapers_mixed_streams": [_P, _P, _P, _P, _P, _P, _P,
                                               _P, _I, _I, _I, _I, _I, _I,
                                               _P],
        # PFB-M-S: raw, history, twiddle, order, h, n_valid, partial, out,
        # history_out, plan, device, S, F, group, P, fresh, width, stream
        "rpf_fused_psd_pfb_mixed_streams": [_P, _P, _P, _P, _P, _P, _P, _P,
                                            _P, _P, _I, _I, _I, _I, _I, _I,
                                            _I, _P],
        # the streams forms' attributes, as above
        "rpf_fused_psd_mixed_est_streams_attributes": [_P, _I, _I, _I, _P],
    },
    "fused_psd_chirp_est": {
        # SK-B: raw, twiddle, window, chirp, spectrum, partial, out, device,
        # log2m, bins, F, group, n_valid, two_sigma, width, stream
        "rpf_fused_psd_sk_chirp": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _F, _I, _P],
        # MT-B: raw, twiddle, tapers, chirp, spectrum, partial, out, device,
        # log2m, bins, F, group, K, n_valid, width, stream
        "rpf_fused_psd_tapers_chirp": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                       _I, _I, _I, _I, _I, _P],
        # PFB-B: raw, history, twiddle, h, chirp, spectrum, partial, out,
        # history_out, device, log2m, bins, F, group, n_valid, P, fresh,
        # width, stream
        "rpf_fused_psd_pfb_chirp": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _P],
        # log2m, bins, cut (1 SK, 2 tapers, 3 PFB), windowed, device, attrs
        # (int[6])
        "rpf_fused_psd_chirp_est_attributes": [_I, _I, _I, _I, _I, _P],
        # SK-B-S: raw, twiddle, window, chirp, spectrum, n_valid, partial,
        # out, device, log2m, bins, S, F, group, two_sigma, width, stream
        "rpf_fused_psd_sk_chirp_streams": [_P, _P, _P, _P, _P, _P, _P, _P,
                                           _I, _I, _I, _I, _I, _I, _F, _I,
                                           _P],
        # MT-B-S: raw, twiddle, tapers, chirp, spectrum, n_valid, partial,
        # out, device, log2m, bins, S, F, group, K, width, stream
        "rpf_fused_psd_tapers_chirp_streams": [_P, _P, _P, _P, _P, _P, _P,
                                               _P, _I, _I, _I, _I, _I, _I,
                                               _I, _I, _P],
        # PFB-B-S: raw, history, twiddle, h, chirp, spectrum, n_valid,
        # partial, out, history_out, device, log2m, bins, S, F, group, P,
        # fresh, width, stream
        "rpf_fused_psd_pfb_chirp_streams": [_P, _P, _P, _P, _P, _P, _P, _P,
                                            _P, _P, _I, _I, _I, _I, _I, _I,
                                            _I, _I, _I, _P],
        # the streams forms' attributes, as above
        "rpf_fused_psd_chirp_est_streams_attributes": [_I, _I, _I, _I, _I,
                                                       _P],
    },
    "fused_psd_chirp_large_est": {
        # SK-BL: raw, twiddle, inter, window, chirp, spectrum, counts,
        # scratch, partial, out, device, log2m, bins, width, S, F, group_a,
        # group_b, group_c, two_sigma, stream
        "rpf_fused_psd_sk_chirp_large": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                         _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                         _I, _F, _P],
        # MT-BL: raw, twiddle, inter, tapers, chirp, spectrum, counts,
        # scratch, partial, out, device, log2m, bins, width, S, F, group_a,
        # group_b, group_c, K, stream
        "rpf_fused_psd_tapers_chirp_large": [_P, _P, _P, _P, _P, _P, _P, _P,
                                             _P, _P, _I, _I, _I, _I, _I, _I,
                                             _I, _I, _I, _I, _P],
        # PFB-BL: raw, history, twiddle, inter, h, chirp, spectrum, counts,
        # scratch, partial, out, history_out, device, log2m, bins, width,
        # S, F, group_a, group_b, group_c, P, fresh, stream
        "rpf_fused_psd_pfb_chirp_large": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                          _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                          _I, _I, _I, _I, _I, _P],
        # PFB-BL's control (its first form): PFB-BL's arguments
        "rpf_fused_psd_pfb_chirp_large_control": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
            _I, _I, _I, _I, _I, _I, _I, _P],
        # log2m, which (0..8: passes A, A windowed, B, C, SK's C, the
        # PFB's A, its pre-pass at P <= 4 and <= 32, the control's PFB A),
        # device, attrs (int[6])
        "rpf_fused_psd_chirp_large_est_attributes": [_I, _I, _I, _P],
    },
    "fused_psd_large_est": {
        # SK-L: raw, twiddle, inter, window, counts, scratch, partial, out,
        # device, log2n, S, F, group_a, group_b, two_sigma, stream
        "rpf_fused_psd_sk_large": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _I, _F, _P],
        # MT-L: raw, twiddle, inter, tapers, counts, scratch, partial, out,
        # device, log2n, S, F, group_a, group_b, K, stream
        "rpf_fused_psd_tapers_large": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                       _I, _I, _I, _I, _I, _I, _P],
        # PFB-L: raw, history, twiddle, inter, h, counts, scratch, partial,
        # out, history_out, device, log2n, S, F, group_a, group_b, P,
        # fresh, stream
        "rpf_fused_psd_pfb_large": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _I, _P],
        # PFB-L's control (its first form): PFB-L's arguments
        "rpf_fused_psd_pfb_large_control": [_P, _P, _P, _P, _P, _P, _P, _P,
                                            _P, _P, _I, _I, _I, _I, _I, _I,
                                            _I, _I, _P],
        # log2n, which (0..7: passes A, A windowed, B, SK's B, the PFB's
        # A, its pre-pass at P <= 4 and <= 32, the control's PFB A),
        # device, attrs (int[6])
        "rpf_fused_psd_large_est_attributes": [_I, _I, _I, _P],
    },
    "fused_psd_mixed_large_est": {
        # SK-ML: raw, tw1, bin1, inter, window, tw2, order2, counts,
        # scratch, partial, out, plan1 (int[55]), plan2, device, log2c, n2p,
        # width, S, F, group_a, group_b, two_sigma, stream
        "rpf_fused_psd_sk_mixed_large": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
            _I, _I, _I, _I, _I, _F, _P],
        # MT-ML: raw, tw1, bin1, inter, tapers, tw2, order2, counts,
        # scratch, partial, out, plan1, plan2, device, log2c, n2p, width,
        # S, F, group_a, group_b, K, stream
        "rpf_fused_psd_tapers_mixed_large": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
            _I, _I, _I, _I, _I, _I, _P],
        # PFB-ML: raw, history, tw1, bin1, inter, h, tw2, order2, counts,
        # scratch, partial, out, history_out, plan1, plan2, device, log2c,
        # n2p, width, S, F, group_a, group_b, P, fresh, stream
        "rpf_fused_psd_pfb_mixed_large": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
            _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        # which (0..6: passes A, A windowed, B small, B large, SK's B
        # small, large, the PFB's A), smem, threads, device, attrs (int[6])
        "rpf_fused_psd_mixed_large_est_attributes": [_I, _I, _I, _I, _P],
    },
    "fused_psd_mixed_large": {
        # raw, tw1, bin1, inter, window, tw2, order2, scratch, partial,
        # out, plan1 (int[55]), plan2, device, log2c, n2p, width, F,
        # group_a, group_b, n_valid, stream
        "rpf_fused_psd_mixed_large": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                      _P],
        # raw, tw1, bin1, inter, window, tw2, order2, counts, scratch,
        # partial, out, plan1, plan2, device, log2c, n2p, width, S, F,
        # group_a, group_b, stream
        "rpf_fused_psd_mixed_large_streams": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
            _I, _I, _I, _I, _I, _P],
        # which (0 pass A, 1 pass A windowed, 2 pass B small, 3 pass B
        # large), smem, threads, device, attrs (int[6])
        "rpf_fused_psd_mixed_large_attributes": [_I, _I, _I, _I, _P],
        # the control: raw, tw1, order1, inter, window, tw2, order2,
        # scratch, partial, out, plan1 (int[12]), plan2, device, F, cols,
        # xs1, group_a, rows, xs2, group_b, n_valid, stream
        "rpf_fused_psd_mixed_large_control": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
            _I, _I, _I, _I, _I, _P],
        # which (0 pass A, 1 pass A windowed, 2 pass B), smem, device,
        # attrs (int[6])
        "rpf_fused_psd_mixed_large_control_attributes": [_I, _I, _I, _P],
    },
    "fused_psd_chirp_large": {
        # raw, twiddle, inter, window, chirp, spectrum, scratch, partial,
        # out, device, log2m, bins, width, F, group_a, group_b, group_c,
        # n_valid, stream
        "rpf_fused_psd_chirp_large": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _P],
        # raw, twiddle, inter, window, chirp, spectrum, counts, scratch,
        # partial, out, device, log2m, bins, width, S, F, group_a,
        # group_b, group_c, stream
        "rpf_fused_psd_chirp_large_streams": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            _I, _I, _I, _P],
        # log2m, which (0 pass A, 1 pass A windowed, 2 pass B, 3 pass C),
        # device, attrs (int[6])
        "rpf_fused_psd_chirp_large_attributes": [_I, _I, _I, _P],
        # the control: raw, tw1, order1, inter, chirp, window, tw2,
        # order2, spectrum, scratch, partial, out, plan1 (int[12]), plan2,
        # device, bins, F, cols_a, xs1, group_a, rows_b, xs2, group_b,
        # cols_c, group_c, n_valid, stream
        "rpf_fused_psd_chirp_large_control": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
            _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
        # which (0 pass A, 1 pass A windowed, 2 pass B, 3 pass C), smem,
        # device, attrs (int[6])
        "rpf_fused_psd_chirp_large_control_attributes": [_I, _I, _I, _P],
    },
    "fused_psd_sk": {
        # raw, twiddle, window, partial, out, device, log2n, F, group,
        # n_valid, two_sigma, plane, stream
        "rpf_fused_psd_sk": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                             _P],
        # raw, twiddle, window, n_valid, partial, out, device, log2n, S, F,
        # group, two_sigma, plane, stream
        "rpf_fused_psd_sk_streams": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _I, _F, _I, _P],
        # log2n, windowed, plane, device, attrs (int[6])
        "rpf_fused_psd_sk_attributes": [_I, _I, _I, _I, _P],
    },
    "fused_psd_tapers": {
        # raw, twiddle, tapers, partial, out, device, log2n, F, group, K,
        # n_valid, batch, per_block, stream
        "rpf_fused_psd_tapers": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _P],
        # raw, twiddle, tapers, n_valid, partial, out, device, log2n, S, F,
        # group, K, batch, per_block, stream
        "rpf_fused_psd_tapers_streams": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                         _I, _I, _I, _I, _I, _P],
        # log2n, batch, device, attrs (int[6])
        "rpf_fused_psd_tapers_attributes": [_I, _I, _I, _P],
    },
    "fused_psd_pfb": {
        # raw, history, twiddle, h, partial, out, history_out, device,
        # log2n, F, group, n_valid, P, fresh, ring, stage_h, stream
        "rpf_fused_psd_pfb": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _P],
        # raw, history, twiddle, h, n_valid, partial, out, history_out,
        # device, log2n, S, F, group, P, fresh, ring, stage_h, stream
        "rpf_fused_psd_pfb_streams": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _I, _I, _I, _I, _I, _P],
        # log2n, P, ring, stage_h, device, attrs (int[6])
        "rpf_fused_psd_pfb_attributes": [_I, _I, _I, _I, _I, _P],
        # the channelizer: rows, twiddle, h, out, device, log2n, T, group,
        # P, ring, stage_h, stream
        "rpf_pfb_channelize": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _P],
        # log2n, P, ring, stage_h, device, attrs (int[6])
        "rpf_pfb_channelize_attributes": [_I, _I, _I, _I, _I, _P],
    },
    "fused_psd_frames": {
        # raw, twiddle, window, out, device, log2n, F, group, n_valid,
        # complex_out, stream
        "rpf_fused_psd_frames": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        # log2n, windowed, complex_out, device, attrs (int[6])
        "rpf_fused_psd_frames_attributes": [_I, _I, _I, _I, _P],
    },
    "fused_psd_csd": {
        # raw_x, raw_y, twiddle, window, partial, out, device, log2n, F,
        # group, n_valid, stream
        "rpf_fused_psd_csd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _P],
        # log2n, windowed, device, attrs (int[6])
        "rpf_fused_psd_csd_attributes": [_I, _I, _I, _P],
    },
    "fused_psd_scf": {
        # X, partial, out, device, N, F, K, k0, chunk, n_valid, stream
        "rpf_fused_psd_scf": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        # device, attrs (int[6])
        "rpf_fused_psd_scf_attributes": [_I, _P],
    },
    "fused_psd_probe": {
        # variant, raw, w1r, w1i, twiddle, w2, offsets, partial, out,
        # device, F, group, n_valid, blocks_per_sm, iters, stream
        "rpf_fused_psd_probe": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _P],
        # variant, blocks_per_sm, device, attrs (int[5])
        "rpf_probe_attributes": [_I, _I, _I, _P],
        # which, in, out, device, iters, stream
        "rpf_relayout_probe": [_I, _P, _P, _I, _I, _P],
        # raw, twiddle, window, partial, out, device, log2n, F, group,
        # n_valid, stream
        "rpf_radix2_psd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float        # its nvcc's wall; 0.0 when a build was reused
    log: str              # nvcc's output (ptxas register/smem report)


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    h = hashlib.sha256(source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, BuildInfo]:
    """Compile each library of ``names`` (default: every source) that has
    no build of its exact sources, one nvcc process per source, all
    started together."""
    outs = {name: library_path(name)
            for name in (SIGNATURES if names is None else names)}
    infos = {name: BuildInfo(out, 0.0, "") for name, out in outs.items()
             if out.is_file()}
    missing = [name for name in outs if name not in infos]
    if not missing:
        return infos
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = {}
    for name in missing:
        tmp = outs[name].with_name(f"{outs[name].name}.{os.getpid()}.tmp")
        running[name] = tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # Each process's output read on a thread of its own, so that its time
    # is its own nvcc's wall and not the wait for the ones before it.
    done = {}

    def collect(name, proc):
        stdout, stderr = proc.communicate()
        done[name] = (time.perf_counter() - t0, stdout, stderr)

    threads = [threading.Thread(target=collect, args=(name, proc))
               for name, (_, proc) in running.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failures = []
    for name, (tmp, proc) in running.items():
        seconds, stdout, stderr = done[name]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on {source(name).name} with exit "
                            f"code {proc.returncode}:\n{stderr}")
            continue
        os.replace(tmp, outs[name])
        infos[name] = BuildInfo(outs[name], seconds, stdout + stderr)
    if failures:
        raise KernelBuildError("\n".join(failures))
    return infos


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built on its first load in a process
    if it has no build of its exact sources."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build([name])[name].path))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.rpf_cuda_error_string.argtypes = [ctypes.c_int]
            lib.rpf_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]
