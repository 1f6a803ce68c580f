"""The devices a multi-stream step runs on.

Port of ``rtl_power_fftw_tpu/parallel/mesh.py:make_mesh``. On the TPU the
streams were laid out on a 1-D ``stream`` mesh axis and reduced with one
``psum``. On an H100 one card holds BASELINE config 5's whole step (16
streams of 256 frames at 2048 bins: 16.8 MB of IQ), and a streams step at
any N the one-stream step takes (4 streams of 8 frames at 2^20 bins: 64
MiB of IQ and 256 MiB of scratch), so the port's mesh is the one CUDA
device (or, for the Python API and the tests, the CPU device) the session
was given; ``longint.sharded_accumulate`` splits one stream's frames over
that list too. Splitting streams over several cards, with an NCCL
``all_reduce`` for the cross-stream sum, is not ported yet.
"""

from __future__ import annotations

from typing import List

import torch


def make_mesh(device) -> List[torch.device]:
    """The devices the multi-stream step uses: ``[device]``."""
    return [torch.device(device)]
