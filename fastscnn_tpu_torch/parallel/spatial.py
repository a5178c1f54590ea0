"""The transports of the mesh's ``space`` axis, and a rank's place on it.

The exchanges (``ops/halo.py``: ``halo_rows``, ``gather_rows_h``) move
their rows over a transport, one interface for two kinds of space group:

- :class:`GroupTransport`: a ``torch.distributed`` group, one process a
  rank (the train and eval steps): gloo on the CPU, NCCL on cards, where
  the exchanges are captured in a step's CUDA graph. The halo rows move in
  an ``all_gather`` of each rank's boundary rows, padded to one size,
  which both backends run on CUDA tensors (gloo's point-to-point ops may
  refuse them, and both need equal sizes);
- :class:`LocalTransport`: the devices of one process (the engine), one
  thread a rank (:func:`run_spmd`), meeting at a barrier and copying from
  device to device. Each thread puts its tensor at the rendezvous with the
  stream that wrote it (its current stream on the tensor's device), and a
  peer copies it on that stream (:func:`copy_after`): the copy is ordered
  after the kernels that wrote the tensor and before any later use of its
  memory, whichever stream each thread runs on. Its backward runs in the
  thread that calls ``backward``, which autograd does on the CPU and for
  distinct cards; the engine needs no backward.

A :class:`Space` is one rank's view: its transport, its index, the axis's
size, for the train step the group over which a tensor replicated across
``space`` takes its batch statistics (``data_group``), and the rows every
rank holds of the level it describes (``rows``, ``ops/halo.space_rows``).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable

import torch

__all__ = [
    "Space",
    "GroupTransport",
    "LocalTransport",
    "local_spaces",
    "run_spmd",
    "copy_after",
    "LOCAL_TIMEOUT_S",
]

# how long a thread of a local space group waits for its peers at an
# exchange before the group fails (a peer that raised aborts it at once)
LOCAL_TIMEOUT_S = 600.0


class GroupTransport:
    """The space axis as a ``torch.distributed`` group."""

    def __init__(self, group):
        self.group = group

    def all_gather(self, t: torch.Tensor) -> list:
        import torch.distributed as dist

        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, t, group=self.group)
        return parts

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        out = t.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out


def _writer(t: torch.Tensor):
    """The stream that the calling thread's kernels on ``t``'s device run
    on (None for a CPU tensor)."""
    return torch.cuda.current_stream(t.device) if t.device.type == "cuda" else None


def copy_after(t: torch.Tensor, stream, device) -> torch.Tensor:
    """A copy of ``t`` on ``device``, for the calling thread, where ``t``
    was written on ``stream`` (its device's; None for a CPU tensor),
    possibly by another thread. The copy runs on ``stream``, after the
    kernels that wrote ``t``, and so before any later kernel there that
    reuses ``t``'s memory; the calling thread's current stream on
    ``device`` waits for it (PyTorch's cross-device copy orders that
    itself), and the copy's memory is marked as used there."""
    if stream is None:
        return t.to(device, copy=True)
    with torch.cuda.stream(stream):
        out = t.to(device, copy=True)
    mine = torch.cuda.current_stream(out.device)
    if out.device == stream.device and mine != stream:
        mine.wait_stream(stream)
        out.record_stream(mine)
    return out


class _Rendezvous:
    """Where the threads of a local space group meet: each puts its value in
    its slot, all wait, each reads every slot, all wait again (so that no
    slot is overwritten, and no tensor left, before every thread has
    queued its copies)."""

    def __init__(self, n: int, timeout: float):
        self.slots: list = [None] * n
        self.barrier = threading.Barrier(n, timeout=timeout)

    def exchange(self, index: int, value, read: Callable) -> list:
        self.slots[index] = value
        self.barrier.wait()
        out = [read(v) for v in self.slots]
        self.barrier.wait()
        return out


class LocalTransport:
    """One thread's end of a local space group: the others' tensors copied
    to this thread's device (:func:`copy_after`), each sum taken in rank
    order (so every thread gets the same bits)."""

    def __init__(self, rendezvous: _Rendezvous, index: int, device):
        self._rv, self.index, self.device = rendezvous, index, torch.device(device)

    def all_gather(self, t: torch.Tensor) -> list:
        return self._rv.exchange(self.index, (t, _writer(t)),
                                 lambda v: copy_after(v[0], v[1], self.device))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        parts = self.all_gather(t)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def abort(self) -> None:
        self._rv.barrier.abort()


@dataclasses.dataclass(frozen=True, eq=False)
class Space:
    """One rank's place on the ``space`` axis: ``transport`` (above),
    ``index`` and ``size``; ``data_group``: the ``torch.distributed`` group
    of the ranks at this space index (one a data place), over which a
    tensor replicated across ``space`` takes its batch statistics (None:
    one data place); ``rows``: the global rows ``(start, stop)`` that each
    rank holds of one level of the network (``ops/halo.space_rows``), which
    the exchanges require (None: no level yet; :meth:`at` attaches one)."""

    transport: Any
    index: int
    size: int
    data_group: Any = None
    rows: tuple | None = None

    def at(self, rows: tuple) -> "Space":
        """This rank's place at the level of ``rows``."""
        return dataclasses.replace(self, rows=rows)


def local_spaces(devices) -> list:
    """A :class:`Space` for each of ``devices`` (a local space group, one
    thread a device, :func:`run_spmd`)."""
    rv = _Rendezvous(len(devices), LOCAL_TIMEOUT_S)
    return [Space(LocalTransport(rv, k, d), k, len(devices)) for k, d in enumerate(devices)]


def run_spmd(spaces: list, fn: Callable) -> list:
    """``fn(k)`` for each rank k of a local space group, in one thread a rank,
    and their results in rank order. A rank that raises aborts the group's
    barrier, so that its peers raise too instead of waiting; the first
    exception is raised here."""
    out, errors = [None] * len(spaces), []

    def run(k):
        try:
            out[k] = fn(k)
        except BaseException as e:  # noqa: BLE001 - re-raised below, in the caller's thread
            errors.append(e)
            spaces[k].transport.abort()

    threads = [threading.Thread(target=run, args=(k,), daemon=True) for k in range(len(spaces))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        first = next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                     errors[0])
        raise first
    return out
