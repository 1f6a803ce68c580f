"""Per-frame spectra: raw u8 IQ frames -> each frame's |X|^2 or X ("FR").

The device step of the library estimators that need every frame's
spectrum: ``spectrogram`` (the fftshifted |X|^2 of each frame, the JAX
package's ``models/spectrogram.py:_spectrogram_step``) and
``spectral_correlation`` (each frame's X, which ``models/cyclo.py:_scf_step``
multiplies across lags); XLA there, no Pallas kernel. A CUDA C++ kernel
written for Hopper (``csrc/fused_psd_frames.cu``): K1's group kernel
(``csrc/fused_psd_regs.cuh``) with the cuts ``kRegsFrames`` and
``kRegsFramesComplex``, which store each valid frame's row, staged by bin
through the lane's exchange buffer and written coalesced, instead of
summing it. The computation:

1. dequantize: re = byte[2n] - 127, im = byte[2n+1] - 127; with a window,
   re·w[n] and im·w[n] in float32;
2. length-N DFT in float32;
3. for every frame f < ``n_valid``: ``out="power_shifted"``, |X|^2 in
   fftshifted bin order, row f of an (F, N) float32 output; or
   ``out="complex"``, X in natural bin order, row f of an (F, N)
   complex64 output. Rows at or past ``n_valid`` are not written.

:func:`fused_psd_frames` dispatches on the tensor's device: a CPU tensor
runs the plain PyTorch version (:func:`fused_psd_frames_reference`), a
CUDA tensor the kernel, or raises. ``COUNTS.kernel_frames`` and
``COUNTS.kernel_frames_windowed`` count the kernel's launches (both
stores), ``COUNTS.plain_frames`` the plain version's (each also in
``COUNTS.plain``).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import fused_psd as fp
from .fused_psd_large import _raw_stream

#: The two stores.
MODES = ("power_shifted", "complex")
#: Frames a block takes at most: K1's grid rule with this chunk.
GROUP_CHUNK = 64


def fused_psd_frames_reference(raw_u8: torch.Tensor, n_valid: int,
                               window: Optional[torch.Tensor] = None,
                               out: str = "power_shifted") -> torch.Tensor:
    """The plain PyTorch version: (F, 2N) uint8 -> (F, N) float32
    (fftshifted |X|^2) or complex64 (X), rows at or past ``n_valid``
    zero."""
    X = fp.frame_spectra(raw_u8, window)
    if out == "complex":
        res = X
    else:
        res = torch.fft.fftshift(X.real * X.real + X.imag * X.imag, dim=-1)
    res[n_valid:] = 0
    return res


def fused_psd_frames(raw_u8: torch.Tensor, n_valid: int,
                     window: Optional[torch.Tensor] = None,
                     out: str = "power_shifted") -> torch.Tensor:
    """(F, 2N) uint8 frames, ``n_valid`` real frames -> (F, N): float32
    fftshifted |X|^2 (``out="power_shifted"``) or complex64 X in natural
    bin order (``out="complex"``) of each frame f < n_valid, on the
    tensor's device (rows at or past n_valid unwritten on the card, zero
    on the CPU). ``window``: an (N,) float32 tensor on the same device, or
    None.

    A CUDA tensor runs the kernel on the current stream (asynchronously);
    a CPU tensor runs the plain version."""
    n_valid = int(n_valid)
    if out not in MODES:
        raise ValueError(f"out must be one of {MODES}, got {out!r}")
    fp.check_args("fused_psd_frames", fp.fused_psd_eligible, raw_u8, n_valid,
                  1, window)
    if not fp._on_cuda("fused_psd_frames", raw_u8):
        fp.COUNTS.plain += 1
        fp.COUNTS.plain_frames += 1
        return fused_psd_frames_reference(raw_u8, n_valid, window, out)
    fp.check_alignment("fused_psd_frames", raw_u8, fp.RAW_ALIGN, window,
                       fp.WINDOW_ALIGN)
    F, N = raw_u8.shape[0], raw_u8.shape[1] // 2
    device = raw_u8.device
    complex_out = out == "complex"
    plan = fp.library_plan("fused_psd_frames", N, F, GROUP_CHUNK,
                           device.index, int(window is not None),
                           int(complex_out))
    res = torch.empty((F, N), dtype=(torch.complex64 if complex_out
                                     else torch.float32), device=device)
    err = plan.lib.rpf_fused_psd_frames(
        raw_u8.data_ptr(), plan.twiddle,
        None if window is None else window.data_ptr(), res.data_ptr(),
        device.index, plan.log2n, F, plan.group, n_valid, int(complex_out),
        _raw_stream(device.index))
    if err != 0:
        raise fp.launch_error("fused_psd_frames", plan.lib, err)
    if window is None:
        fp.COUNTS.kernel_frames += 1
    else:
        fp.COUNTS.kernel_frames_windowed += 1
    return res


def kernel_attributes(N: int, windowed: bool = False, complex_out: bool =
                      False, device: Optional[torch.device] = None) -> dict:
    """What the kernel gets at N bins (windowed, complex store or not) on
    the card, as :func:`.fused_psd.kernel_attributes` gives K1's.
    Launches nothing."""
    return fp.library_attributes("fused_psd_frames", N, int(windowed),
                                 int(complex_out), device=device)

