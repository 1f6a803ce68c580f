"""What the library estimators share around their device steps: the
window and the frame batches on the device, and the queue of steps in
flight before a read-back."""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Optional

import numpy as np
import torch

#: Device steps kept in flight before the oldest result is read back.
IN_FLIGHT = 4


def device_window(window: Optional[np.ndarray],
                  device: torch.device) -> Optional[torch.Tensor]:
    """A window as a float32 tensor on ``device``, or None."""
    if window is None:
        return None
    return torch.from_numpy(np.array(window, dtype=np.float32)).to(device)


def upload(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """A (n, 2N) u8 frame batch as a contiguous tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(batch)).to(device)


def read_back_in_order(launches: Iterable, consume: Callable) -> None:
    """Draw the steps' results from ``launches`` (each drawn item launches
    its step) and hand each to ``consume``, in order, once
    :data:`IN_FLIGHT` later steps are launched, and the last ones at the
    end: a read-back waits for its own step while the next ones run."""
    pending = collections.deque()
    for item in launches:
        pending.append(item)
        if len(pending) > IN_FLIGHT:
            consume(pending.popleft())
    while pending:
        consume(pending.popleft())
