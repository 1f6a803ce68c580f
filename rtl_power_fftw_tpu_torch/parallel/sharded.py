"""Multi-stream PSD step: S streams of frames -> per-stream and combined
partial power sums, on one device.

Port of ``rtl_power_fftw_tpu/parallel/sharded.py:ShardedPsdStep``
(BASELINE config 5: 16 parallel IQ streams with one averaged spectrum).
The JAX step ran the fused Pallas kernel's streams variant on each mesh
shard and summed the shards' per-stream partials with one ``psum``. Here
the device list is one device (``mesh.make_mesh``), the per-stream step is
a CUDA kernel's streams entry by ``ops.spectral.transform_route``, at
every N the one-stream ``PsdStep`` takes at default precision: K4
(``fused_psd_streams``) for powers of two up to 16384 and the large
kernel's (``fused_psd_large_streams``, L-S) from 32768 to 2^22, the
mixed-radix kernel's (``fused_psd_mixed_streams``) at the other even
7-smooth N up to 16384 and ML's (``fused_psd_mixed_large_streams``,
ML-S) above, to 2^22, the chirp-Z kernel's
(``fused_psd_bluestein_streams``) at every other even N up to 8192 and
BL's (``fused_psd_chirp_large_streams``, BL-S) above, to 2^21 (their
plain PyTorch versions on the CPU); ``transform_route`` refuses the rest
(N above 2^22, or above 2^21 with a prime factor above 7) with exit 3.
The cross-stream sum is a float32 sum of the (S, N) rows on that device,
as the JAX step's psum of float32 shard sums. The TPU's transform-rung
ladder, its compile fallback and its u16 host view have no counterpart:
the kernel takes the u8 frames as they are.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..exceptions import ReturnValue, RPFexception

from ..ops.kernels.fused_psd import fused_psd_streams
from ..ops.kernels.fused_psd_bluestein import fused_psd_bluestein_streams
from ..ops.kernels.fused_psd_chirp_large import fused_psd_chirp_large_streams
from ..ops.kernels.fused_psd_large import fused_psd_large_streams
from ..ops.kernels.fused_psd_mixed import fused_psd_mixed_streams
from ..ops.kernels.fused_psd_mixed_large import fused_psd_mixed_large_streams
from ..ops.spectral import adapt_batch, transform_route

#: The streams entry of every route ``transform_route`` gives at default
#: precision, and its path's suffix.
STREAMS_ROUTES = {
    "regs": (fused_psd_streams, ""),
    "large": (fused_psd_large_streams, "_large"),
    "mixed": (fused_psd_mixed_streams, "_mixed"),
    "bluestein": (fused_psd_bluestein_streams, "_bluestein"),
    "mixed_large": (fused_psd_mixed_large_streams, "_mixed_large"),
    "chirp_large": (fused_psd_chirp_large_streams, "_chirp_large")}


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
        one_device(devices)
        self._kernel, suffix = STREAMS_ROUTES[transform_route(N, backend)]
        self.devices = list(devices)
        self.device = torch.device(devices[0])
        self.N = N
        self.S = streams
        self.F, self._chunk = adapt_batch(frames_per_step)
        self.window = None
        if window is not None:
            self.window = torch.from_numpy(
                np.asarray(window, dtype=np.float32).copy()).to(self.device)
        #: "cuda" + the route's suffix (K4's none, "_large", "_mixed",
        #: "_bluestein", "_mixed_large", "_chirp_large") on a card, "plain"
        #: + the same suffix (their PyTorch versions) on the CPU.
        self.path = ("cuda" if self.device.type == "cuda" else "plain") + \
            suffix

    def __call__(self, raw, n_valid) -> Tuple[torch.Tensor, torch.Tensor]:
        """raw: (S, F, 2N) u8 and n_valid: (S,) counts in [0, F], each a
        numpy array (copied to the device here) or a tensor already on the
        step's device (int32 for the counts). Returns (per_stream (S, N)
        f32, combined (N,) f32), on the device; on CUDA computed
        asynchronously on the current stream."""
        raw, n_valid = stream_batch(self, raw, n_valid)
        per_stream = self._kernel(raw, n_valid, self._chunk, self.window)
        return per_stream, per_stream.sum(dim=0)


def one_device(devices: Sequence[torch.device]) -> None:
    """Raise RPFexception(InvalidArgument) unless the streams run on one
    device (splitting them over cards is not ported)."""
    if len(devices) != 1:
        raise RPFexception(
            "Not yet ported to the PyTorch/CUDA package: streams split "
            f"over {len(devices)} devices. Exiting.",
            ReturnValue.InvalidArgument)


def stream_batch(step, raw, n_valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """A multi-stream step's inputs on ``step.device``: ``raw`` (S, F, 2N)
    uint8 and ``n_valid`` (S,) counts in [0, F] (int32 where it is already
    a tensor), each a numpy array (checked and copied to the device) or a
    tensor already on the step's device, as ``step``'s S, F and N take
    them."""
    shape = (step.S, step.F, 2 * step.N)
    if isinstance(raw, np.ndarray):
        raw = torch.from_numpy(np.ascontiguousarray(raw))
    if tuple(raw.shape) != shape or raw.dtype != torch.uint8:
        raise ValueError(f"raw frames must be {shape} uint8, got "
                         f"{tuple(raw.shape)} {raw.dtype}")
    if not isinstance(n_valid, torch.Tensor):
        counts = np.asarray(n_valid)
        if counts.shape != (step.S,) or not (
                (counts >= 0) & (counts <= step.F)).all():
            raise ValueError(f"n_valid must be ({step.S},) counts in "
                             f"[0, {step.F}], got {counts}")
        n_valid = torch.from_numpy(counts.astype(np.int32))
    return raw.to(step.device), n_valid.to(step.device)
