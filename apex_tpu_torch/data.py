"""Host -> device input pipeline (port of ``apex_tpu.data.DevicePrefetcher``,
itself the reference's ``data_prefetcher`` of its ImageNet example).

Each host batch (a tree of numpy arrays or CPU tensors) is copied into
pinned host memory and sent to the card with ``non_blocking`` copies on
a side CUDA stream, ``depth`` batches ahead of the one being consumed.
The consumer's stream waits on the batch's copy event (no host sync)
and the batch's tensors are recorded on it, so the caching allocator
never hands their memory out while the step still reads it.  On the CPU
the batches are plain tensors.
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch._tree import tree_leaves, tree_map


class DevicePrefetcher:
    """Iterate device-resident batches, ``depth`` copies in flight.

    >>> for x, y in DevicePrefetcher(loader, depth=2):
    ...     step(x, y)        # the next batches' copies already issued
    """

    def __init__(self, it: Iterable[Any], depth: int = 2, device=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.device = resolve_device(device)
        self._src = iter(it)
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self.device) if self._cuda
                        else None)
        self._ready = collections.deque()
        for _ in range(depth):
            if not self._issue():
                break

    @staticmethod
    def _host(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)) \
            if isinstance(a, np.ndarray) else a

    def _issue(self) -> bool:
        """Start the copy of the next host batch; False at exhaustion."""
        try:
            batch = next(self._src)
        except StopIteration:
            return False
        host = tree_map(self._host, batch)
        if not self._cuda:
            self._ready.append((tree_map(lambda t: t.to(self.device), host),
                                None))
            return True
        pinned = tree_map(lambda t: t.pin_memory(), host)
        with torch.cuda.stream(self._stream):
            dev = tree_map(lambda t: t.to(self.device, non_blocking=True),
                           pinned)
            done = torch.cuda.Event()
            done.record(self._stream)
        # the pinned buffers must outlive their copies
        self._ready.append((dev, (done, pinned)))
        return True

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self):
        if not self._ready:
            raise StopIteration
        batch, pending = self._ready.popleft()
        if pending is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(pending[0])
            for t in tree_leaves(batch):
                t.record_stream(stream)
        self._issue()
        return batch
