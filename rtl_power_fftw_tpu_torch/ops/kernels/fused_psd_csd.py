"""Cross-spectral sums of two streams: raw u8 IQ frames -> (4, N) f32 ("CSD").

Replaces the device step of ``rtl_power_fftw_tpu/models/coherence.py``
(``_csd_step``, XLA there, no Pallas kernel) with a CUDA C++ kernel
written for Hopper (``csrc/fused_psd_csd.cu``). The computation, on two
(F, 2N) frame batches x and y:

1. dequantize both (u8 - 127); with a window, times w[n] in float32;
2. X = DFT(x_f), Y = DFT(y_f) in float32;
3. over the frames f < ``n_valid``, four sums in natural bin order:
   sum |X|^2, sum |Y|^2, sum Re(X conj Y) and sum Im(X conj Y), within
   groups that divide ``chunk`` and then over the groups (the JAX step's
   tree (g, chunk)), as a (4, N) float32 output.

The kernel is K1's group kernel with a second stream: a lane transforms
x's frame f and then y's frame f in the same threads, X parked in
registers while Y is transformed, and the four sums in registers; one
partial row a block in each of four planes, then psd_sum.cuh's float64
row sum of each plane.

:func:`fused_psd_csd` dispatches on the tensor's device: a CPU tensor
runs the plain PyTorch version (:func:`fused_psd_csd_reference`), a CUDA
tensor the kernel, or raises. ``COUNTS.kernel_csd`` and
``COUNTS.kernel_csd_windowed`` count its launches, ``COUNTS.plain_csd``
the plain version's (each also in ``COUNTS.plain``).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import fused_psd as fp
from .fused_psd import frame_spectra
from .fused_psd_large import _raw_stream

def fused_psd_csd_reference(raw_x: torch.Tensor, raw_y: torch.Tensor,
                            n_valid: int, chunk: int,
                            window: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The plain PyTorch version: two (F, 2N) uint8 batches -> (4, N)
    float32, the JAX step's masked products and tree sums."""
    F, two_n = raw_x.shape
    N = two_n // 2
    X = frame_spectra(raw_x, window)
    Y = frame_spectra(raw_y, window)
    mask = (torch.arange(F, device=raw_x.device) < n_valid).to(
        torch.float32)[:, None]
    cross = X * torch.conj(Y)
    planes = (X.real * X.real + X.imag * X.imag,
              Y.real * Y.real + Y.imag * Y.imag, cross.real, cross.imag)
    return torch.stack([(p * mask).reshape(F // chunk, chunk, N).sum(1)
                        .sum(0) for p in planes])


def fused_psd_csd(raw_x: torch.Tensor, raw_y: torch.Tensor, n_valid: int,
                  chunk: int, window: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Two (F, 2N) uint8 frame batches (streams x and y), ``n_valid`` real
    frames -> (4, N) float32: sum |X|^2, sum |Y|^2, sum Re(X conj Y), sum
    Im(X conj Y) over those frames, on the tensors' device. ``window``: an
    (N,) float32 tensor on the same device, or None.

    A CUDA tensor runs the kernel on the current stream (asynchronously);
    a CPU tensor runs the plain version."""
    n_valid = int(n_valid)
    fp.check_args("fused_psd_csd", fp.fused_psd_eligible, raw_x, n_valid,
                  chunk, window)
    if (not isinstance(raw_y, torch.Tensor) or raw_y.dtype != torch.uint8
            or raw_y.shape != raw_x.shape or raw_y.device != raw_x.device
            or not raw_y.is_contiguous()):
        raise ValueError(f"streams x {tuple(raw_x.shape)} on {raw_x.device} "
                         f"and y {tuple(getattr(raw_y, 'shape', ()))} on "
                         f"{getattr(raw_y, 'device', None)} differ: y must be "
                         "a contiguous uint8 tensor of x's shape on its "
                         "device")
    if not fp._on_cuda("fused_psd_csd", raw_x):
        fp.COUNTS.plain += 1
        fp.COUNTS.plain_csd += 1
        return fused_psd_csd_reference(raw_x, raw_y, n_valid, chunk, window)
    fp.check_alignment("fused_psd_csd", raw_x, fp.RAW_ALIGN, window,
                       fp.WINDOW_ALIGN)
    if raw_y.data_ptr() % fp.RAW_ALIGN:
        raise ValueError(f"fused_psd_csd: raw frames must be "
                         f"{fp.RAW_ALIGN}-byte aligned on the device")
    F, N = raw_x.shape[0], raw_x.shape[1] // 2
    device = raw_x.device
    plan = fp.library_plan("fused_psd_csd", N, F, chunk, device.index,
                           int(window is not None))
    # One allocation: the (4, G, N) partial rows, then the (4, N) output.
    buf = torch.empty(4 * (plan.blocks + 1) * N, dtype=torch.float32,
                      device=device)
    out = buf[4 * plan.blocks * N:].view(4, N)
    err = plan.lib.rpf_fused_psd_csd(
        raw_x.data_ptr(), raw_y.data_ptr(), plan.twiddle,
        None if window is None else window.data_ptr(), buf.data_ptr(),
        out.data_ptr(), device.index, plan.log2n, F, plan.group, n_valid,
        _raw_stream(device.index))
    if err != 0:
        raise fp.launch_error("fused_psd_csd", plan.lib, err)
    if window is None:
        fp.COUNTS.kernel_csd += 1
    else:
        fp.COUNTS.kernel_csd_windowed += 1
    return out


def kernel_attributes(N: int, windowed: bool = False,
                      device: Optional[torch.device] = None) -> dict:
    """What the kernel gets at N bins (windowed or not) on the card, as
    :func:`.fused_psd.kernel_attributes` gives K1's. Launches nothing."""
    return fp.library_attributes("fused_psd_csd", N, int(windowed),
                                 device=device)

