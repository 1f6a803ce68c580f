"""Device steps of the PyTorch/CUDA package."""
