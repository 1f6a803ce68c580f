"""Long integration with the frame axis spread over the devices.

Port of ``rtl_power_fftw_tpu/parallel/longint.py`` (which imports jax).
The 1M-point long-integration mode (BASELINE config 3) accumulates few,
enormous spectra. Power accumulation commutes with any partition of the
frame axis, so one stream's frames can be split over the devices as if
they were independent streams: each device transforms its share and the
cross-stream sum adds the shares. The port's device list is one card
(``mesh.make_mesh``), so its step is ``ShardedPsdStep`` over one stream:
at 2^20 bins the large kernel's streams entry at S = 1, whose row is the
one-stream kernel's on the same frames.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.spectral import pad_frames
from .mesh import make_mesh
from .sharded import ShardedPsdStep

# Step cache: a step holds its window and its kernel's plan on the device,
# so one is kept for the last shape. Windowed steps key on the window
# BYTES, so a different window array rebuilds.
_step_cache: dict = {}


def _cached_step(devices: Sequence[torch.device], N: int, per_dev: int,
                 window, backend: str) -> ShardedPsdStep:
    wkey = None if window is None else np.asarray(window).tobytes()
    key = (tuple(devices), N, per_dev, wkey, backend)
    step = _step_cache.get(key)
    if step is None:
        step = ShardedPsdStep(devices, N, per_dev, streams=len(devices),
                              window=window, backend=backend)
        _step_cache.clear()  # keep at most one live step's constants
        _step_cache[key] = step
    return step


def sharded_accumulate(frames: np.ndarray, N: int,
                       window: Optional[np.ndarray] = None,
                       devices: Optional[Sequence[torch.device]] = None,
                       backend: str = "auto") -> Tuple[np.ndarray, int]:
    """Accumulate |FFT|^2 over all frames, the frame axis split over
    ``devices`` (default: ``make_mesh("cuda")``, the one card).

    frames: (M, 2N) u8. Returns (pwr (N,) float64 unshifted, M), the
    per-device partials summed with the step's two-stage float32 sums
    and added in float64 here."""
    if devices is None:
        devices = make_mesh("cuda")
    devices = [torch.device(d) for d in devices]
    D = len(devices)
    M = len(frames)
    if M == 0:
        raise ValueError("no frames to accumulate")
    # Rows per device, padded so the (D, F, 2N) batch is rectangular.
    per_dev = -(-M // D)
    step = _cached_step(devices, N, per_dev, window, backend)
    batch = np.zeros((D, step.F, 2 * N), dtype=np.uint8)
    n_valid = np.zeros(D, dtype=np.int32)
    for d in range(D):
        part = frames[d * per_dev:(d + 1) * per_dev]
        n_valid[d] = len(part)
        if len(part):
            batch[d] = pad_frames(part, step.F)
    _, combined = step(batch, n_valid)
    return combined.cpu().numpy().astype(np.float64), M
