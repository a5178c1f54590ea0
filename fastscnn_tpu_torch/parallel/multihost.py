"""Multi-process (multi-host) runs over ``torch.distributed``.

Counterpart of ``fastscnn_tpu/parallel/multihost.py``. Where JAX runs one
controller per host over all of that host's chips, PyTorch's idiom is one
process per device: every process runs the same program,
:func:`initialize_multihost` joins them into one process group, and the
steps of ``parallel/train.py`` under a mesh of ``parallel/mesh.py`` reduce
over that group (sync-BN moments, the losses' sums, OHEM's threshold, the
gradients).

Usage (the same script in every process)::

    from fastscnn_tpu_torch.parallel import host_shard, initialize_multihost, make_mesh
    initialize_multihost()                      # False in a single process
    mesh = make_mesh()                          # spans every rank
    for images, targets in loader:
        images, targets = host_shard(images, targets)   # this rank's rows
        state, metrics = train_step(state, images, targets)

Data convention, as in the JAX package: every process derives the whole
global batch's index list from the same seed and keeps its
``process_index``-th contiguous slice (:func:`host_shard`); the data
loaders take that slice before they decode (their ``shard`` argument).

:func:`run_local_group` starts N processes of one command on this machine
with the variables set, each with a deadline, and kills the group when one
fails: the tests, ``tools/multihost_smoke.py`` and
``entry.dryrun_multichip`` use it.
"""

from __future__ import annotations

import datetime
import os
import signal
import socket
import subprocess
import sys
import time

__all__ = [
    "initialize_multihost",
    "host_shard",
    "is_primary_host",
    "global_device_count",
    "process_count",
    "process_index",
    "local_device",
    "backend_for",
    "backend_of",
    "free_port",
    "run_local_group",
    "INIT_TIMEOUT_S",
]

# every process group's timeout: a collective (the join included) that a
# dead or missing rank leaves open raises after this many seconds
INIT_TIMEOUT_S = 300.0


def _int_env(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def backend_for(device) -> str:
    """The process group's backend for tensors on ``device``: NCCL for a
    CUDA device, gloo on the CPU."""
    import torch

    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def backend_of(group) -> str:
    """The backend of a process group: 'nccl' or 'gloo'."""
    import torch.distributed as dist

    return str(dist.get_backend(group))


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *, device=None,
                         backend: str | None = None,
                         timeout_s: float = INIT_TIMEOUT_S) -> bool:
    """Join this process to the process group that ``coordinator_address``
    (``host:port`` of process 0), ``num_processes`` and ``process_id``
    describe, or the variables ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``
    and ``PROCESS_ID`` where an argument is None. Explicit arguments win,
    and ``process_id=0`` is kept. Returns True once joined; with neither an
    address nor a count it returns False and joins nothing (one process).

    The JAX package's branch for Cloud TPU pods (``TPU_WORKER_HOSTNAMES``,
    where ``jax.distributed`` finds its peers itself) has no GPU
    counterpart: nothing on a GPU machine names the other hosts, so that
    variable alone returns False here too.

    ``backend``: None means NCCL for a CUDA ``device`` (None: the CUDA card
    when there is one) and gloo on the CPU. ``backend='gloo'`` with a CUDA
    device exists for a machine with one card, where two NCCL ranks cannot
    share the card: gloo runs the collectives of several ranks on one card
    (through the host), so the multi-process paths run there too.

    Where a card is visible, a CUDA ``device`` (``'cuda'`` alone: the card
    ``process_id % cards``) becomes this process's current device before
    the join, and an NCCL group is bound to it (``device_id``): NCCL puts a
    collective's own tensors (``all_gather_object``'s, a barrier's) on the
    current device, which would otherwise be card 0 in every rank (and NCCL
    refuses two ranks on one card). A failed join raises;
    ``timeout_s`` bounds it and every later collective."""
    import torch
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    num_processes = num_processes or _int_env("NUM_PROCESSES")
    process_id = process_id if process_id is not None else _int_env("PROCESS_ID")
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator's address, the number of "
                         "processes and this process's id (COORDINATOR_ADDRESS, NUM_PROCESSES, "
                         f"PROCESS_ID); got {coordinator_address!r}, {num_processes!r}, "
                         f"{process_id!r}")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    backend = backend or backend_for(device)
    bind = {}
    if device.type == "cuda" and torch.cuda.is_available():
        if device.index is None:
            device = torch.device("cuda", int(process_id) % torch.cuda.device_count())
        torch.cuda.set_device(device)
        if backend == "nccl":
            bind["device_id"] = device
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s), **bind,
    )
    return True


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def process_count() -> int:
    """The processes of the run (1 without a process group)."""
    return _world()[0]


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return _world()[1]


def is_primary_host() -> bool:
    return process_index() == 0


def global_device_count() -> int:
    """The devices of the run: one a process under a process group, else
    this machine's CUDA cards (1 without a card: the CPU)."""
    import torch

    n, _ = _world()
    if n > 1:
        return n
    return max(torch.cuda.device_count(), 1) if torch.cuda.is_available() else 1


def local_device(device=None):
    """The device this process runs on: ``device`` when given, else the
    card ``rank % cards`` (so ranks on a machine spread over its cards, and
    share them when there are more ranks than cards), else the CPU."""
    import torch

    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", process_index() % torch.cuda.device_count())
    return torch.device("cpu")


def host_shard(*arrays):
    """Slice a globally indexed batch down to this process's part (batch
    axis 0 split evenly across the processes, contiguous)."""
    n, i = _world()
    if n == 1:
        return arrays if len(arrays) > 1 else arrays[0]
    out = []
    for a in arrays:
        per = a.shape[0] // n
        out.append(a[i * per:(i + 1) * per])
    return tuple(out) if len(out) > 1 else out[0]


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kill(procs) -> None:
    """SIGKILL each process's session (its children too, also where the
    leader has exited) and reap the leaders."""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            if p.poll() is None:
                p.kill()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass


def run_local_group(argv_of, n: int, deadline_s: float, env: dict | None = None,
                    cwd: str | None = None, join: bool = True) -> list[str]:
    """Run ``n`` processes of ``[python, *argv_of(k)]`` on this machine and
    return their outputs (stdout and stderr together), rank order.

    With ``join``, process k gets ``COORDINATOR_ADDRESS`` (127.0.0.1 and a
    free port), ``NUM_PROCESSES=n`` and ``PROCESS_ID=k``, so that
    :func:`initialize_multihost` joins them; without, none of the three
    (each runs alone). Each process leads a session of its own. The first
    that exits non-zero, or the deadline, kills the whole group (children
    included) and raises ``RuntimeError`` with every output; so does any
    exception here. Nothing outlives the call."""
    base = dict(os.environ if env is None else env)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    base["PYTHONPATH"] = os.pathsep.join(p for p in (root, base.get("PYTHONPATH")) if p)
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        base.pop(k, None)
    port = free_port()
    procs, logs = [], []
    try:
        for k in range(n):
            e = dict(base)
            if join:
                e.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES=str(n),
                         PROCESS_ID=str(k))
            log = open(_log_path(k), "w+b")  # noqa: SIM115 — closed below
            logs.append(log)
            procs.append(subprocess.Popen([sys.executable, *argv_of(k)], env=e, cwd=cwd,
                                          stdout=log, stderr=subprocess.STDOUT,
                                          start_new_session=True))
        end = time.monotonic() + deadline_s
        failed = None
        while True:
            codes = [p.poll() for p in procs]
            bad = [k for k, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"process {bad[0]} exited with code {codes[bad[0]]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > end:
                failed = f"deadline of {deadline_s:.0f} s passed"
                break
            time.sleep(0.05)
    finally:
        _kill(procs)
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read().decode(errors="replace"))
            log.close()
            os.unlink(log.name)
    if failed is not None:
        raise RuntimeError(f"local group of {n}: {failed}\n" + "\n".join(
            f"--- process {k}:\n{out}" for k, out in enumerate(outputs)))
    return outputs


def _log_path(k: int) -> str:
    import tempfile

    fd, path = tempfile.mkstemp(prefix=f"group{k}-", suffix=".log")
    os.close(fd)
    return path

