"""Host input pipeline: sampling, collation, threaded prefetch, per-rank
sharding (port of ``latentpose_tpu/data/pipeline.py``).

- the epoch's order is ``np.random.RandomState(seed + epoch)``'s shuffle,
  then the rank's slice ``[rank::world]`` (``torch.distributed``'s when it
  is initialised, else 0 of 1);
- ``batch_size`` is the global batch (``--batch_size``): each of the world's
  ranks loads ``batch_size / world`` rows of its slice a batch, and a world
  that does not divide it is refused;
- the batch shrinks to the slice's size for tiny fine-tune sets;
- ``prefetch_size // batch_size`` batches in flight, their samples loaded by
  a pool of ``num_workers`` threads (the C++ decoder releases the GIL).

Every hand-over between the producer thread and the consumer (each batch,
the end of the epoch and any exception) goes through one stop-aware put, so
a consumer that leaves early never leaves the producer blocked on a full
queue; the consumer's ``finally`` stops and joins it.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from latentpose_tpu_torch.data.common.voxceleb import rank, world_size

logger = logging.getLogger("latentpose_tpu_torch.data.pipeline")


def default_collate(samples):
    """List of (data_dict, target_dict) -> stacked numpy batch dicts."""
    data = {k: np.stack([s[0][k] for s in samples]) for k in samples[0][0]}
    target = {}
    for k in samples[0][1]:
        vals = [s[1][k] for s in samples]
        if np.isscalar(vals[0]) or np.ndim(vals[0]) == 0:
            target[k] = np.asarray(vals,
                                   np.int32 if k == "label" else np.float32)
        else:
            target[k] = np.stack(vals)
    return data, target


class Handoff:
    """A bounded queue between one producer thread and its consumer, with a
    stop flag: :meth:`put` gives up once the consumer has stopped."""

    END = object()

    def __init__(self, depth):
        self.queue = queue.Queue(max(1, depth))
        self.stopped = threading.Event()

    def put(self, item):
        while not self.stopped.is_set():
            try:
                self.queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def run(self, produce):
        """Start a daemon thread that puts what the generator ``produce()``
        yields, then any exception it raised, then :attr:`END`."""
        def target():
            items = produce()
            try:
                for item in items:
                    if self.stopped.is_set():
                        return
                    self.put(item)
            except Exception as exc:  # handed to the consumer
                self.put(exc)
            finally:
                items.close()    # and with it whatever it iterates
                self.put(self.END)

        self.thread = threading.Thread(target=target, daemon=True)
        self.thread.start()

    def __iter__(self):
        """The producer's items, in order; raises its exception."""
        try:
            while True:
                item = self.queue.get()
                if item is self.END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self.stopped.set()
            try:          # unblock a producer waiting on a full queue
                while True:
                    self.queue.get_nowait()
            except queue.Empty:
                pass
            self.thread.join()


class BatchLoader:
    """Iterable over (data_dict, target_dict) batches with prefetch."""

    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 num_workers=4, prefetch_size=16, drop_last=True):
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.rank = rank()
        self.world = world_size()
        if batch_size % self.world:
            raise ValueError(f"a batch of {batch_size} does not split over "
                             f"{self.world} ranks")
        batch_size //= self.world
        shard = len(self._epoch_indices())
        if batch_size > shard:
            logger.warning("Decreasing batch size %d -> dataset size %d",
                           batch_size, shard)
            batch_size = shard
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = max(1, prefetch_size // batch_size)
        self.drop_last = drop_last

    @property
    def num_labels(self):
        return getattr(self.dataset, "num_labels", len(self.dataset.dirlist))

    def _epoch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx[self.rank::self.world]

    def __len__(self):
        n = len(self._epoch_indices())
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def batches(self):
        """This epoch's batches of dataset indices."""
        indices = self._epoch_indices()
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def __iter__(self):
        batches = self.batches()
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = self.epoch   # keys the samples' frame draws
        self.epoch += 1
        handoff = Handoff(self.prefetch_batches)

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for batch in batches:
                    if handoff.stopped.is_set():
                        return
                    yield default_collate(list(pool.map(
                        self.dataset.__getitem__, batch)))

        handoff.run(produce)
        yield from handoff
