"""Worker-process data loader: the port's ``--loader grain``.

Counterpart of ``fastscnn_tpu/data/grain_loader.py``, without grain. It
computes what the JAX loader computes:

- every record's host augmentation draws from its own
  ``random.Random((seed + epoch) * 1_000_003 + index)``, swapped in for
  the dataset's ``tf.rng`` and, where present, its ``_rng`` for the call,
  so a record is the same whichever process makes it;
- ``num_epochs`` epochs run back to back in one stream, from
  ``first_epoch`` (0 but in a resumed run);
- batches are assembled in the consuming process from the records in
  order, ``drop_last`` as given, targets int32 (or, with
  ``narrow_targets``, int8 where every record's labels fit, as the
  threaded loader's workers narrow them).

The record ORDER is not grain's: grain shuffles with a compiled index
shuffle that its Python source does not reproduce. Each epoch is ordered
by ``np.random.default_rng(seed + epoch)``, as the threaded loader orders
its batches; an epoch holds the same set of records as the JAX loader's.

Workers are processes of a ``spawn`` context (the trainer has CUDA and
threads running, so fork is unsafe), started at the first iteration and
kept for the loader's life. They import ``fastscnn_tpu_torch.data`` only,
which imports no torch. Records come back through shared memory: the
consumer keeps one slot a record in flight (``prefetch`` batches' worth),
each task names its slot, and a worker writes its record into that slot's
block (creating a larger one when the record does not fit) and sends the
arrays' layout. Both sides keep their mappings of a slot, so a record
costs one copy in and one copy out, and no page is mapped anew once the
slots are warm. A thread of the consumer assembles the batches ahead of
the training loop. The decoded cache's directory is passed to each
worker, and each record carries the worker's cache hits and misses back
into the consumer's counts. A worker's exception is raised in the
consumer; a worker that dies raises there too, within a second. An
iteration that ends early (an error, or a consumer that stops) stops the
workers; the next starts new ones. ``num_workers=0`` makes the records in
the consuming process.
"""

from __future__ import annotations

import collections
import contextlib
import multiprocessing
import pickle
import queue
import random as _random
import threading
import time
import traceback
import weakref
from multiprocessing import shared_memory

import numpy as np

from fastscnn_tpu_torch.data import decoded_cache
from fastscnn_tpu_torch.data.loader import narrow_labels, shard_rows

__all__ = ["GrainDataLoader", "WorkerError", "make_grain_loader"]

# One augmentation lock per dataset object: the RNG swap of one record
# must not interleave with another's in the same process.
_AUG_LOCKS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_AUG_LOCKS_GUARD = threading.Lock()


class WorkerError(RuntimeError):
    """A record failed in a worker process, or a worker died."""


def _aug_lock(dataset) -> threading.Lock:
    with _AUG_LOCKS_GUARD:
        return _AUG_LOCKS.setdefault(dataset, threading.Lock())


@contextlib.contextmanager
def _rngs(dataset, rng):
    """The dataset's ``tf.rng`` and ``_rng`` (where it has them) set to
    ``rng`` for the block."""
    tf = getattr(dataset, "tf", None)
    inner = getattr(dataset, "_rng", None)
    old = tf.rng if tf is not None else None
    if tf is not None:
        tf.rng = rng
    if inner is not None:
        dataset._rng = rng
    try:
        yield
    finally:
        if tf is not None:
            tf.rng = old
        if inner is not None:
            dataset._rng = inner


def make_record(dataset, seed: int, epoch: int, index: int, narrow: bool = False):
    """Record ``index`` of ``epoch``: ``(image, target)`` arrays, its
    augmentation drawn from the record's own RNG."""
    rng = _random.Random((seed + epoch) * 1_000_003 + index)
    with _aug_lock(dataset), _rngs(dataset, rng):
        image, target = dataset[index]
    image, target = np.asarray(image), np.asarray(target)
    return image, (narrow_labels(target) if narrow else target)


def write_arrays(block, arrays) -> list:
    """Copy ``arrays`` into ``block`` back to back: their (shape, dtype,
    offset) layout."""
    layout, offset = [], 0
    for a in arrays:
        view = np.ndarray(a.shape, a.dtype, buffer=block.buf, offset=offset)
        view[...] = a
        del view
        layout.append((a.shape, a.dtype.str, offset))
        offset += a.nbytes
    return layout


def read_arrays(block, layout) -> list:
    """Views of ``block`` in a :func:`write_arrays` layout (drop them before
    the block is closed)."""
    return [np.ndarray(shape, np.dtype(dt), buffer=block.buf, offset=off)
            for shape, dt, off in layout]


def _release(block) -> None:
    block.close()
    block.unlink()


def _worker_main(dataset_bytes, seed, cache_dir, narrow, tasks, results):
    """A worker process: records for ``(slot, block name, block size,
    epoch, index)`` tasks until None."""
    if cache_dir:
        decoded_cache.set_cache_dir(cache_dir)
    dataset = pickle.loads(dataset_bytes)
    mapped: dict[str, shared_memory.SharedMemory] = {}  # this process's mappings
    while True:
        task = tasks.get()
        if task is None:
            return
        _, name, size, epoch, index = task
        before = decoded_cache.stats()
        try:
            arrays = make_record(dataset, seed, epoch, index, narrow)
            need = sum(a.nbytes for a in arrays)
            if name is None or size < need:  # the slot's block is missing or small
                block = shared_memory.SharedMemory(create=True, size=max(need, 1))
                name = block.name
                mapped[name] = block
            elif name not in mapped:
                mapped[name] = shared_memory.SharedMemory(name=name)
            layout = write_arrays(mapped[name], arrays)
        except Exception:  # noqa: BLE001 — raised in the consumer
            results.put(("error", task, traceback.format_exc()))
            continue
        after = decoded_cache.stats()
        results.put(("ok", task, (name, layout),
                     (after["hits"] - before["hits"], after["misses"] - before["misses"])))


class _Workers:
    """The worker processes, their queues, and the consumer's record slots."""

    def __init__(self, dataset, seed, narrow, num_workers, slots):
        ctx = multiprocessing.get_context("spawn")
        # the RNGs are swapped per record: a placeholder travels in their
        # place (the module-global ``random`` the datasets default to does
        # not pickle)
        with _aug_lock(dataset), _rngs(dataset, _random.Random(0)):
            payload = pickle.dumps(dataset)
        self.tasks = ctx.Queue()
        self.results = ctx.Queue()
        self.blocks: list = [None] * slots  # slot -> this process's mapping of its block
        self.free = collections.deque(range(slots))
        self.procs = [ctx.Process(target=_worker_main, daemon=True,
                                  args=(payload, seed, decoded_cache.get_cache_dir(), narrow,
                                        self.tasks, self.results))
                      for _ in range(num_workers)]
        for p in self.procs:
            p.start()

    def send(self, epoch, index) -> None:
        """Task a worker with a record, into the next free slot."""
        slot = self.free.popleft()
        block = self.blocks[slot]
        self.tasks.put((slot, block and block.name, block.size if block else 0, epoch, index))

    def receive(self):
        """The next result: ``((epoch, index), (slot, arrays))``. Raises a
        worker's error, or when a worker has died."""
        while True:
            try:
                msg = self.results.get(timeout=1.0)
                break
            except queue.Empty:
                dead = [p for p in self.procs if not p.is_alive()]
                if dead:
                    raise WorkerError(f"loader worker pid {dead[0].pid} died (exit code "
                                      f"{dead[0].exitcode}) with records outstanding") from None
        slot, _, _, epoch, index = msg[1]
        if msg[0] == "error":
            raise WorkerError(f"record {index} of epoch {epoch} failed in a loader "
                              f"worker:\n{msg[2]}")
        name, layout = msg[2]
        block = self.blocks[slot]
        if block is None or block.name != name:  # the worker gave the slot a new block
            if block is not None:
                _release(block)
            block = self.blocks[slot] = shared_memory.SharedMemory(name=name)
        decoded_cache.add_stats(*msg[3])
        return (epoch, index), (slot, read_arrays(block, layout))

    def _drain(self, known) -> None:
        """Read the results nobody will collect, unlinking the blocks a
        worker made for them."""
        while True:
            try:
                msg = self.results.get(timeout=0.05)
            except (queue.Empty, OSError, EOFError, ValueError):
                return
            if msg[0] == "ok" and msg[2][0] not in known:
                with contextlib.suppress(FileNotFoundError):
                    _release(shared_memory.SharedMemory(name=msg[2][0]))

    def close(self):
        known = {b.name for b in self.blocks if b is not None}
        for _ in self.procs:
            self.tasks.put(None)
        # the results are drained while the workers end: a worker whose
        # results sit unread in the pipe cannot exit
        deadline = time.monotonic() + 5
        while any(p.is_alive() for p in self.procs) and time.monotonic() < deadline:
            self._drain(known)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=5)
        self._drain(known)
        for block in self.blocks:
            if block is not None:
                with contextlib.suppress(FileNotFoundError):
                    _release(block)
        self.blocks = []
        self.tasks.close()
        self.results.close()


class GrainDataLoader:
    """Iterable of (images u8 NHWC, targets NHW) numpy batches over
    ``num_epochs`` epochs (see the module docstring)."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = True, num_workers: int = 0, seed: int = 0,
                 num_epochs: int = 1, narrow_targets: bool = False, prefetch: int = 2,
                 first_epoch: int = 0, shard: tuple[int, int] | None = None):
        """``prefetch``: batches' worth of records in flight in the workers,
        and of batches assembled ahead of the consumer. ``first_epoch``: the
        stream's first epoch (a resumed run's), whose order and record
        seeds it takes. ``shard=(index, count)``: each batch is this rank's
        contiguous part of the global batch of ``batch_size``, its records
        the only ones made (``data/loader.py``'s ``shard``)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.num_epochs = num_epochs
        self.first_epoch = first_epoch
        self.narrow_targets = narrow_targets
        self.prefetch = max(1, prefetch)
        self.shard = shard
        self._workers: _Workers | None = None
        self.first_record_s = None  # workers' start to their first record, in s
        n = len(dataset)
        self._len = (n // batch_size if drop_last else -(-n // batch_size)) * num_epochs

    def __len__(self):
        return self._len

    def order(self, epoch: int) -> np.ndarray:
        """The record indices of ``epoch`` in the order they are batched."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        return order

    def _batch_tasks(self):
        """Each batch's ``(epoch, index)`` records, every epoch in turn."""
        out = []
        for epoch in range(self.first_epoch, self.first_epoch + self.num_epochs):
            order = self.order(epoch).tolist()
            stop = len(order) // self.batch_size * self.batch_size if self.drop_last else len(order)
            out += [[(epoch, i) for i in shard_rows(order[s:s + self.batch_size], self.shard)]
                    for s in range(0, stop, self.batch_size)]
        return out

    def __iter__(self):
        batches = self._batch_tasks()
        if self.num_workers <= 0:
            for tasks in batches:
                yield self._collate([make_record(self.dataset, self.seed, e, i,
                                                 self.narrow_targets) for e, i in tasks])
            return
        out: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        thread = threading.Thread(target=self._assemble, args=(batches, out, stop), daemon=True)
        thread.start()
        finished = False
        try:
            for _ in batches:
                kind, item = out.get()
                if kind == "error":
                    raise item
                yield item
            finished = True
        finally:
            stop.set()
            thread.join()
            if not finished:  # records still in flight: the workers go with them
                self.close()

    def _assemble(self, batches, out, stop) -> None:
        """The consumer's thread: task the workers into free slots, take
        each batch's records in order, and put the stacked batch in ``out``;
        a failure goes to ``out`` as well."""

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        try:
            started = None
            if self._workers is None:
                started = time.perf_counter()
                self._workers = _Workers(self.dataset, self.seed, self.narrow_targets,
                                         self.num_workers, self.prefetch * self.batch_size)
                self._finalizer = weakref.finalize(self, self._workers.close)
            workers = self._workers
            pending = collections.deque(t for tasks in batches for t in tasks)
            ready = {}
            for tasks in batches:
                held = []
                try:
                    for task in tasks:
                        while task not in ready:
                            while pending and workers.free:
                                workers.send(*pending.popleft())
                            key, record = workers.receive()
                            ready[key] = record
                            if started is not None:
                                self.first_record_s = time.perf_counter() - started
                                started = None
                        held.append(ready.pop(task))
                    batch = self._collate([arrays for _, arrays in held])
                finally:
                    for slot, arrays in held:
                        arrays.clear()  # no view may outlive its slot's next record
                        workers.free.append(slot)
                if not put(("batch", batch)):
                    return
        except BaseException as e:  # noqa: BLE001 — raised in the consumer
            put(("error", e))

    def _collate(self, records):
        """One batch, copied out of its records."""
        images = np.stack([r[0] for r in records])
        targets = np.stack([r[1] for r in records])
        if not (self.narrow_targets and targets.dtype == np.int8):
            targets = targets.astype(np.int32)
        return images, targets

    def close(self) -> None:
        """Stop the workers and free their slots (a later iteration starts
        new ones); also done when the loader is collected or the
        interpreter exits."""
        if self._workers is not None:
            self._finalizer()
            self._workers = None


def make_grain_loader(dataset, **kwargs) -> GrainDataLoader:
    """A :class:`GrainDataLoader` of ``dataset`` (``kwargs`` as its
    constructor's). The JAX function returns None where grain is not
    installed; this loader needs no grain, so it never does."""
    return GrainDataLoader(dataset, **kwargs)
