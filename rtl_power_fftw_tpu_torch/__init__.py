"""rtl_power_fftw_tpu_torch — the averaged-PSD spectrum analyzer on PyTorch
and CUDA, for NVIDIA Hopper GPUs.

A port of ``rtl_power_fftw_tpu`` (JAX): 8-bit IQ streams → averaged power
spectral densities, with the same text, ``.bin``/``.met`` output and exit
codes. The device step is a CUDA kernel written by hand for ``sm_90a``
(``ops/kernels/csrc/fused_psd.cu``). The host layers that import no jax
(config, planning, sources, output, auxdata) are used from
``rtl_power_fftw_tpu`` directly. This package imports torch and never jax.
"""
