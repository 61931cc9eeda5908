"""Depth-N pipelined device -> host readbacks.

Counterpart of ``substrata_tpu/runtime/readback.py``.  A tick that reads a
result back synchronously waits for the card to finish everything queued
before it.  Consuming instead the value dispatched ``depth`` ticks ago lets
the host prepare the next ticks while the card works: by then its copy has
landed, and the wait is a no-op.

``PipelinedReadback`` keeps a ring of ``depth + 1`` pinned host buffers.
``push(x)`` starts a ``non_blocking`` copy of the device tensor ``x`` into
the next buffer on the current stream and records a CUDA event after it;
once the ring holds more than ``depth`` entries it waits for the oldest
entry's event and returns a numpy copy of that entry, else None (the ring
is filling; ``waits`` counts the pops that found the copy still in
flight).  ``depth=0`` reads every pushed value synchronously, as the
reference's does, so callers keep one code path.  A tensor on the CPU is
copied at once.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch


class PipelinedReadback:
    """Ring of in-flight device -> host copies; push the newest, pop the
    oldest."""

    def __init__(self, depth: int = 3):
        self.depth = int(depth)
        self._ring: deque = deque()            # (host buffer, event or None)
        self._buffers: list = [None] * (self.depth + 1)
        self._next = 0
        self.waits = 0          # pops whose copy had not landed yet

    def push(self, value: torch.Tensor):
        self._ring.append(self._start_copy(value))
        if len(self._ring) > self.depth:
            return self._to_host(self._ring.popleft())
        return None

    def __len__(self):
        return len(self._ring)

    def _start_copy(self, value: torch.Tensor):
        if value.device.type == "cpu":
            return value.clone(), None
        i = self._next
        self._next = (i + 1) % len(self._buffers)
        buf = self._buffers[i]
        if buf is None or buf.shape != value.shape or buf.dtype != value.dtype:
            buf = self._buffers[i] = torch.empty(value.shape, dtype=value.dtype,
                                                 pin_memory=True)
        buf.copy_(value, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return buf, event

    def _to_host(self, entry) -> np.ndarray:
        buf, event = entry
        if event is not None:
            if not event.query():
                self.waits += 1
                event.synchronize()
        return buf.numpy().copy()
