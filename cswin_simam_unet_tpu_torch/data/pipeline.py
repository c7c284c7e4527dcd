"""The host input pipeline: threaded decode and batching, and the
host-to-device prefetch.

Counterpart of ``cswin_simam_unet_tpu/data/pipeline.py``.  ``DataLoader``
decodes and resizes in a thread pool (libjpeg, cv2 and PIL release the GIL)
and yields uint8 numpy batches; ``device_prefetch`` (without JAX's
``sharding`` argument: data parallelism is ROADMAP queue A item 9) moves
them to the device through pinned memory with non-blocking copies, ``size``
batches ahead of the consumer, so each copy overlaps the work on the batch
before it.  Scaling and augmentation happen on the device, in the step.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch


class DataLoader:
    """Iterates (images uint8 (B, H, W, 3), masks uint8 (B, H, W, 1)) numpy
    batches of a source with ``__len__``, ``load(i)`` and
    ``load_batch(indices)`` (None where it has no batch path), such as
    :class:`~.dataset.SegmentationDataSource`.

    The reference's semantics: a shuffle each epoch by
    ``RandomState(seed + epoch)`` (the epoch set by :meth:`set_epoch`, which
    ``fit`` calls, so a resumed run sees the unbroken run's order), the
    partial last batch kept unless ``drop_last``.  ``cache_decoded`` keeps
    the decoded samples in host memory after their first load (the same
    values; later epochs skip the decode)."""

    def __init__(self, source, indices: Optional[Sequence[int]] = None, batch_size: int = 4,
                 shuffle: bool = False, num_workers: int = 4, seed: int = 0,
                 drop_last: bool = False, prefetch: int = 2, use_native: bool = True,
                 cache_decoded: bool = False):
        self.source = source
        self.indices = np.asarray(indices if indices is not None else np.arange(len(source)))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.use_native = use_native
        self._cache: Optional[dict] = {} if cache_decoded else None
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """The epoch whose shuffle the next iteration uses."""
        self._epoch = int(epoch)

    def _epoch_order(self) -> np.ndarray:
        order = self.indices.copy()
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        return order

    def _load_many(self, idx, decode_pool) -> list:
        """Samples of ``idx``: the source's batch path where it has one and
        ``use_native``, else one load a sample in the decode pool."""
        loaded = self.source.load_batch(idx) if self.use_native else None
        if loaded is not None:
            return list(zip(loaded[0], loaded[1]))
        return list(decode_pool.map(self.source.load, idx))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self._epoch_order()
        self._epoch += 1
        batches = [order[i:i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        # Two pools: the decode workers load samples, a small batch pool
        # assembles whole batches ahead of the consumer.  One shared pool
        # would deadlock: assemble tasks waiting on load tasks that no free
        # worker is left to run.
        with ThreadPoolExecutor(max_workers=self.num_workers) as decode_pool, \
                ThreadPoolExecutor(max_workers=max(1, self.prefetch)) as batch_pool:

            def assemble(idx_batch):
                idx = [int(i) for i in idx_batch]
                if self._cache is None:
                    samples = self._load_many(idx, decode_pool)
                else:
                    miss = [i for i in idx if i not in self._cache]
                    if miss:
                        self._cache.update(zip(miss, self._load_many(miss, decode_pool)))
                    samples = [self._cache[i] for i in idx]
                return (np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples]))

            pending: collections.deque = collections.deque()
            it = iter(batches)
            for _ in range(max(1, self.prefetch)):
                b = next(it, None)
                if b is not None:
                    pending.append(batch_pool.submit(assemble, b))
            while pending:
                fut = pending.popleft()
                b = next(it, None)
                if b is not None:
                    pending.append(batch_pool.submit(assemble, b))
                yield fut.result()


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
