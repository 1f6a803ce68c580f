"""The compute device, and the device-side errors the CLI maps to exit 7."""

from __future__ import annotations

import torch

from .exceptions import ReturnValue, RPFexception

from .ops.kernels._build import KernelBuildError
from .ops.kernels.fused_psd import KernelLaunchError


def require_cuda() -> torch.device:
    """The first CUDA device, or RPFexception(HardwareError): the device
    step runs only on an NVIDIA GPU and never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise RPFexception(
            "No CUDA device available: the PyTorch/CUDA package runs its "
            "device step on an NVIDIA GPU. Exiting.",
            ReturnValue.HardwareError)
    return torch.device("cuda", 0)


def device_runtime_errors() -> tuple:
    """Exceptions that mean the device failed at run time (out of memory,
    a CUDA error, a refused kernel launch, a kernel that does not build)
    — this package's analogue of a librtlsdr hardware failure, which
    exits 7 in the reference (exceptions.h:25-34)."""
    errors = [torch.cuda.OutOfMemoryError, torch.cuda.CudaError,
              KernelLaunchError, KernelBuildError]
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None:
        errors.append(accelerator_error)
    return tuple(errors)
