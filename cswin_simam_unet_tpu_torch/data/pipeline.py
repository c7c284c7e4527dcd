"""Host-to-device prefetch.

Counterpart of ``device_prefetch`` in ``cswin_simam_unet_tpu/data/pipeline.py``
without its ``sharding`` argument (data parallelism is ROADMAP queue A item
9): batches of host arrays go to the device through pinned memory with
non-blocking copies, ``size`` batches ahead of the consumer, so each copy
overlaps the work on the batch before it.
"""

from __future__ import annotations

import collections

import numpy as np
import torch


def _put(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor) and x.device == device:
        return x
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def device_prefetch(iterator, device, size: int = 2):
    """Yield the batches of ``iterator`` (tuples of numpy arrays or tensors)
    on ``device``, in order, with up to ``size`` copies in flight.  Tensors
    already on ``device`` pass through."""
    device = torch.device(device)
    queue: collections.deque = collections.deque()
    it = iter(iterator)
    for batch in it:
        queue.append(tuple(_put(x, device) for x in batch))
        if len(queue) > size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
