"""Multi-stream PSD step: S streams of frames -> per-stream and combined
partial power sums, on one device.

Port of ``rtl_power_fftw_tpu/parallel/sharded.py:ShardedPsdStep``
(BASELINE config 5: 16 parallel IQ streams with one averaged spectrum).
The JAX step ran the fused Pallas kernel's streams variant on each mesh
shard and summed the shards' per-stream partials with one ``psum``. Here
the device list is one device (``mesh.make_mesh``), the per-stream step is
the CUDA kernel K4 (``fused_psd_streams``; its plain PyTorch version on
the CPU), and the cross-stream sum is a float32 sum of the (S, N) rows on
that device, as the JAX step's psum of float32 shard sums. The TPU's
transform-rung ladder, its compile fallback and its u16 host view have no
counterpart: the kernel takes the u8 frames as they are.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..exceptions import ReturnValue, RPFexception

from ..ops.kernels.fused_psd import (MAX_N, MIN_N, fused_psd_eligible,
                                     fused_psd_streams)
from ..ops.spectral import adapt_batch, check_step_ported


class ShardedPsdStep:
    """Step: (S, F, 2N) u8 -> per-stream (S, N) f32 partials plus their
    (N,) f32 sum, on ``devices[0]``.

    ``n_valid`` is (S,): per-stream valid-frame counts, so streams may
    progress unevenly (different drop rates, early end of stream) without
    a reshape.
    """

    def __init__(self, devices: Sequence[torch.device], N: int,
                 frames_per_step: int, streams: int, window=None,
                 backend: str = "auto"):
        if N % 2 != 0:
            raise ValueError("N must be even")
        if window is not None and len(np.asarray(window)) != N:
            raise ValueError("window must have shape (N,)")
        if len(devices) != 1:
            raise RPFexception(
                "Not yet ported to the PyTorch/CUDA package: streams split "
                f"over {len(devices)} devices. Exiting.",
                ReturnValue.InvalidArgument)
        check_step_ported(N, backend)
        if not fused_psd_eligible(N):
            raise RPFexception(
                "Not yet ported to the PyTorch/CUDA package: --streams at "
                f"{N} bins (the streams kernel takes powers of two from "
                f"{MIN_N} to {MAX_N}). Exiting.",
                ReturnValue.InvalidArgument)
        self.devices = list(devices)
        self.device = torch.device(devices[0])
        self.N = N
        self.S = streams
        self.F, self._chunk = adapt_batch(frames_per_step)
        self.window = None
        if window is not None:
            self.window = torch.from_numpy(
                np.asarray(window, dtype=np.float32).copy()).to(self.device)
        #: "cuda" (K4) on a card, "plain" (its PyTorch version) on the CPU.
        self.path = "cuda" if self.device.type == "cuda" else "plain"

    def __call__(self, raw, n_valid) -> Tuple[torch.Tensor, torch.Tensor]:
        """raw: (S, F, 2N) u8 and n_valid: (S,) counts in [0, F], each a
        numpy array (copied to the device here) or a tensor already on the
        step's device (int32 for the counts). Returns (per_stream (S, N)
        f32, combined (N,) f32), on the device; on CUDA computed
        asynchronously on the current stream."""
        shape = (self.S, self.F, 2 * self.N)
        if isinstance(raw, np.ndarray):
            raw = torch.from_numpy(np.ascontiguousarray(raw))
        if tuple(raw.shape) != shape or raw.dtype != torch.uint8:
            raise ValueError(f"raw frames must be {shape} uint8, got "
                             f"{tuple(raw.shape)} {raw.dtype}")
        if not isinstance(n_valid, torch.Tensor):
            counts = np.asarray(n_valid)
            if counts.shape != (self.S,) or not (
                    (counts >= 0) & (counts <= self.F)).all():
                raise ValueError(f"n_valid must be ({self.S},) counts in "
                                 f"[0, {self.F}], got {counts}")
            n_valid = torch.from_numpy(counts.astype(np.int32))
        per_stream = fused_psd_streams(raw.to(self.device),
                                       n_valid.to(self.device), self._chunk,
                                       self.window)
        return per_stream, per_stream.sum(dim=0)
