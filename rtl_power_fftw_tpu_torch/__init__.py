"""rtl_power_fftw_tpu_torch — the averaged-PSD spectrum analyzer on PyTorch
and CUDA, for NVIDIA Hopper GPUs.

A port of ``rtl_power_fftw_tpu`` (JAX): 8-bit IQ streams → averaged power
spectral densities, with the same text, ``.bin``/``.met`` output and exit
codes. The device step is one of the CUDA kernels written by hand for
``sm_90a`` under ``ops/kernels/csrc/``. The host layers (exceptions,
config, planning, auxdata, interrupts, sources, output, utils and the
native loader) are this package's own copies of the JAX package's. This
package imports torch, and neither jax nor the JAX package.
"""

# The same version string as the JAX package, so --version prints the same
# bytes.
__version__ = "0.2.0"
