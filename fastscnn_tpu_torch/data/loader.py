"""Threaded prefetching data loader.

Counterpart of ``fastscnn_tpu/data/loader.py``: a thread pool decodes and
augments samples (zlib, numpy and the JPEG codec release the GIL in
their inner loops) while the card trains on the previous batch. Batches are numpy
``(images u8 NHWC, targets i32 NHW)``; the trainer moves them to the
device. Samples of different sizes are padded to the batch's largest
(images with 0, targets with the ignore label).

The batch order comes from ``np.random.default_rng(seed + epoch)``, as
in the JAX package. The datasets draw their host augmentation from the
module-global ``random``, so with more than one worker the draws
interleave in no fixed order: use ``num_workers=1`` to reproduce a
host-augmented run exactly (``--device-aug`` draws on the device).

``shard=(index, count)``: one rank of a multi-process run. Each batch is
then that rank's contiguous ``1/count`` of the global batch of
``batch_size`` (``parallel.multihost.host_shard``'s rows), cut from the
global batch's indices before anything is decoded.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ["DataLoader", "narrow_labels", "shard_rows"]


def shard_rows(idx, shard):
    """Rank ``index``'s contiguous rows of a global batch's indices (``shard
    = (index, count)``, None: every row)."""
    if shard is None:
        return idx
    index, count = shard
    per = len(idx) // count
    return idx[index * per:(index + 1) * per]


def narrow_labels(targets: np.ndarray) -> np.ndarray:
    """int8 labels where their range fits (a quarter of the bytes to the
    device), else the labels as they are. The range is read from the
    labels, not from the class count: ids beyond it need the wider type."""
    if targets.size and targets.min() >= -128 and targets.max() <= 127:
        return targets.astype(np.int8)
    return targets


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 4, prefetch: int = 2,
                 seed: int = 0, narrow_targets: bool = False, first_epoch: int = 0,
                 shard: tuple[int, int] | None = None):
        """``narrow_targets``: each worker passes its sample's labels
        through :func:`narrow_labels`, so the batch is int8 where every
        sample's range fits (else the collate widens it). ``first_epoch``:
        the epoch whose order the first pass takes (a resumed run's).
        ``shard``: see the module docstring."""
        self.dataset = dataset
        self.narrow_targets = narrow_targets
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._epoch = first_epoch
        self._seed = seed
        self.shard = shard

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self._seed + self._epoch).shuffle(order)
        self._epoch += 1
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield shard_rows(idx, self.shard)

    @staticmethod
    def _collate(samples, ignore_label: int = -1):
        images = [np.asarray(s[0]) for s in samples]
        targets = [np.asarray(s[1]) for s in samples]
        if len({im.shape for im in images}) > 1:
            # mixed native resolutions (testval): zero-pad images and
            # ignore-pad targets to the batch's largest
            h = max(im.shape[0] for im in images)
            w = max(im.shape[1] for im in images)
            images = [np.pad(im, ((0, h - im.shape[0]), (0, w - im.shape[1]), (0, 0)))
                      for im in images]
            targets = [np.pad(t, ((0, h - t.shape[0]), (0, w - t.shape[1])),
                              constant_values=ignore_label) for t in targets]
        return np.stack(images), np.stack(targets)

    def __iter__(self):
        batch_iter = self._batches()
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # a bounded put that gives up once the consumer has gone
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def load(i):
            image, target = self.dataset[i]
            if self.narrow_targets:
                target = narrow_labels(np.asarray(target))
            return image, target

        def producer():
            # every failure reaches the consumer: a producer that dies with
            # no sentinel would leave the training loop waiting for ever
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idx in batch_iter:
                        if stop.is_set():
                            break
                        samples = list(pool.map(load, idx))
                        if not put_or_stop(self._collate(samples)):
                            return
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                put_or_stop(("__error__", e))
                return
            put_or_stop(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                if isinstance(batch[0], str) and batch[0] == "__error__":
                    raise batch[1]
                yield batch
        finally:
            stop.set()
            while thread.is_alive():  # drain so that the producer can end
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
