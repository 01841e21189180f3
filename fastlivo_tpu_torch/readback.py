"""Deferred device-to-host reads.

The pipeline's deferred readback (`Pipeline.async_read`, the block
collector of replay.py) starts a frame's stats copy when the frame is
dispatched and reads it frames later. On the card the copy is a
`non_blocking` copy into pinned host memory on the current stream,
followed by an event; reading it waits on that event only. On the CPU
the copy is synchronous.
"""
from __future__ import annotations

import numpy as np
import torch


class DeferredRead:
    """A device tensor's copy to the host, started now, read later."""

    def __init__(self, t: torch.Tensor):
        t = t.detach()
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t.clone()
            self._event = None

    def result(self) -> np.ndarray:
        """The host copy (waits for the copy to land on the card)."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()
