"""Hand-written CUDA kernels (sources under ``csrc/``) and their wrappers."""
