"""Device meshes for data and spatial parallelism.

Counterpart of ``fastscnn_tpu/parallel/mesh.py``. The JAX mesh is one
controller's ``('data', 'space')`` grid of chips, the devices reshaped
``(n_data, n_space)``: the place of the k-th device is ``(k // n_space,
k % n_space)``. Here a :class:`Mesh` is one of two kinds:

- a process-group mesh: when a process group of more than one rank is
  initialised (``parallel/multihost.py``) and no ``devices`` are passed,
  the mesh spans the group's ranks, one device each, and carries the
  ``torch.distributed`` groups of its ranks: the whole mesh, this rank's
  ``space`` row (the ranks of its data place) and its ``data`` column (the
  ranks of its space index). The train and eval steps run under it SPMD:
  each rank passes its own block (:func:`host_block`) and gets back what
  the JAX step returns for the global batch (its BN moments, loss sums and
  gradients reduce over the groups — the JAX mesh's "free sync-BN");
- a local mesh: the devices of this process (the CUDA cards, or the
  ``devices`` passed, which may repeat a device). ``InferenceEngine``
  serves under it with one folded-weight replica a device: a batch splits
  over ``data``, and with a ``space`` axis each data place's image rows
  split over its space devices (``parallel/spatial.py``).

On the ``space`` axis the input's H is split in equal blocks
(:func:`block_sharding`, JAX's ``P('data', 'space')``), so H must be
divisible by ``n_space`` (:func:`check_spatial_height`), as in JAX. The
levels below need not split evenly: ``ops/halo.py::space_rows`` says which
rows each rank holds of each, as GSPMD pads them.
"""

from __future__ import annotations

import dataclasses
import warnings

__all__ = [
    "Mesh",
    "make_mesh",
    "make_mesh_for_batch",
    "batch_sharding",
    "replicate_sharding",
    "block_sharding",
    "host_block",
    "check_spatial_height",
]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``('data', 'space')`` grid of devices.

    ``devices``: the grid's devices, data-major (a process-group mesh lists
    its ranks' devices, in rank order). ``shape``: ``{'data': n, 'space':
    m}``. ``group``: the ``torch.distributed`` group of the mesh's ranks
    (None for a local mesh). ``ranks``: their global ranks, data-major
    (None for a local mesh). ``index``: this process's place on ``data``
    (None when this rank is not in the mesh; 0 in a local mesh).
    ``space_index``: its place on ``space`` (0 in a local mesh).
    ``space_group``: the group of the ranks of this rank's data place, and
    ``data_group`` that of the ranks of its space index (each None where it
    would hold one rank, and for a local mesh)."""

    devices: tuple
    shape: dict
    group: object = None
    ranks: tuple | None = None
    index: int | None = 0
    space_index: int | None = 0
    space_group: object = None
    data_group: object = None

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["space"]

    @property
    def is_member(self) -> bool:
        return self.index is not None

    @property
    def position(self) -> int:
        """This process's place in the data-major device list (0 in a local
        mesh)."""
        return (self.index or 0) * self.shape["space"] + (self.space_index or 0)

    @property
    def local_device(self):
        """The device this process runs on in the mesh (a process-group mesh)
        or the first device (a local mesh)."""
        return self.devices[self.position]


def _world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_world_size(), dist.get_rank()
    return None


def _local_devices():
    import torch

    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _check(n_data, n_space, count):
    if n_data is None:
        if count % n_space:
            raise ValueError(f"{count} devices not divisible by n_space={n_space}")
        n_data = count // n_space
    if n_data * n_space == 0:
        raise ValueError(f"empty mesh: n_data={n_data}, n_space={n_space}")
    if n_data * n_space > count:
        raise ValueError(f"mesh needs {n_data * n_space} devices, only {count} visible")
    if n_data * n_space < count:
        # an explicit subset is fine when the caller passed n_data, but say so
        warnings.warn(f"mesh uses {n_data * n_space} of {count} visible devices", stacklevel=3)
    return n_data


def make_mesh(n_data: int | None = None, n_space: int = 1, devices=None) -> Mesh:
    """A ``('data', 'space')`` mesh; by default every device on ``data``.

    With a process group of more than one rank and no ``devices``: a
    process-group mesh over the first ``n_data * n_space`` ranks, rank r at
    ``(r // n_space, r % n_space)`` (every rank must call this, as every
    rank must call ``torch.distributed.new_group`` for every group, its own
    or not, in one order; a rank left out gets a mesh whose ``index`` is
    None). Otherwise a local
    mesh over ``devices`` (any list of devices, repeats allowed) or this
    machine's CUDA cards (the CPU without one). The JAX function's errors
    and warning."""
    import torch

    world = _world() if devices is None else None
    if world is None:
        devs = [torch.device(d) for d in (_local_devices() if devices is None else devices)]
        n_data = _check(n_data, n_space, len(devs))
        return Mesh(tuple(devs[:n_data * n_space]), {"data": n_data, "space": n_space})
    import torch.distributed as dist

    from fastscnn_tpu_torch.parallel.multihost import local_device

    count, rank = world
    n_data = _check(n_data, n_space, count)
    names = [None] * count
    dist.all_gather_object(names, str(local_device()))
    ranks = tuple(range(n_data * n_space))
    group = dist.group.WORLD if len(ranks) == count else dist.new_group(list(ranks))

    def groups_of(rows):
        # every rank makes every group, in one order; a group of one rank is None
        made = [group if len(r) == len(ranks) else dist.new_group(r) if len(r) > 1 else None
                for r in rows]
        return next((g for g, r in zip(made, rows) if rank in r), None)

    space_group = groups_of([[d * n_space + s for s in range(n_space)] for d in range(n_data)])
    data_group = groups_of([[d * n_space + s for d in range(n_data)] for s in range(n_space)])
    member = rank in ranks
    return Mesh(tuple(torch.device(names[r]) for r in ranks), {"data": n_data, "space": n_space},
                group=group if member else None, ranks=ranks,
                index=rank // n_space if member else None,
                space_index=rank % n_space if member else None,
                space_group=space_group, data_group=data_group)


def make_mesh_for_batch(batch_size: int, devices=None) -> Mesh:
    """A data-parallel mesh over the most devices (or ranks) that divide the
    global batch (a 2-image batch on 8 devices uses 2)."""
    from fastscnn_tpu_torch.parallel.multihost import global_device_count

    world = _world() if devices is None else None
    n = global_device_count() if devices is None else len(devices)
    while n > 1 and batch_size % n:
        n -= 1
    if world is not None:
        with warnings.catch_warnings():
            # the subset is the point here, as in JAX's devices[:n]
            warnings.simplefilter("ignore")
            return make_mesh(n_data=n)
    devs = _local_devices() if devices is None else list(devices)
    return make_mesh(n_data=n, devices=devs[:n])


def batch_sharding(mesh: Mesh, batch: int) -> list:
    """The rows of a batch of ``batch`` that each place on ``mesh``'s
    ``data`` axis holds, in order: even contiguous slices (the JAX
    ``P('data')`` on the batch axis). Raises ``ValueError`` when ``batch``
    does not divide the axis."""
    n = mesh.shape["data"]
    if batch % n:
        raise ValueError(f"batch {batch} must divide the data axis ({n})")
    per = batch // n
    return [slice(k * per, (k + 1) * per) for k in range(n)]


def replicate_sharding(mesh: Mesh) -> tuple:
    """The devices that each hold a whole copy of a value replicated over
    ``mesh``'s ``data`` axis (the JAX ``P()``; the engine's folded
    weights): one a place on ``data``, the first of its row."""
    m = mesh.shape["space"]
    return tuple(mesh.devices[i * m] for i in range(mesh.shape["data"]))


def check_spatial_height(height: int, n_space: int) -> None:
    """Raise ``ValueError`` unless an input of ``height`` rows splits over a
    ``space`` axis of ``n_space`` in equal blocks: H divisible by
    ``n_space``, JAX's condition (pjit's on the ``P('data', 'space')``
    input of the spatial step and the engine). Every level below may split
    unevenly (``ops/halo.py::space_rows``)."""
    if n_space > 1 and height % n_space:
        raise ValueError(f"spatial sharding over a 'space' axis of {n_space} splits the input's "
                         f"H in {n_space} equal blocks: H must be divisible by n_space = "
                         f"{n_space}, got H={height}")


def block_sharding(mesh: Mesh, batch: int, height: int) -> list:
    """The block of an (N, H, ...) batch that each place of ``mesh`` holds,
    data-major: ``(batch rows, H rows)`` slices, the batch split over
    ``data`` and H over ``space`` (JAX's ``batch_sharding(mesh,
    spatial_axis=1)``, ``P('data', 'space')``). ``ValueError`` when either
    does not divide its axis (:func:`check_spatial_height` for H)."""
    from fastscnn_tpu_torch.ops.halo import space_rows

    m = mesh.shape["space"]
    check_spatial_height(height, m)
    return [(rows, slice(*block)) for rows in batch_sharding(mesh, batch)
            for block in space_rows(m, height)]


def host_block(mesh: Mesh, *arrays, spatial: bool = True):
    """This process's block of each globally indexed (N, H, ...) array under
    a process-group ``mesh``: its data place's batch rows and, with
    ``spatial``, its space index's H rows (without, every H row: the batch
    replicated across ``space``, JAX's ``P('data')``). The spatial
    counterpart of ``multihost.host_shard``; a local mesh or a rank the
    mesh left out gets the arrays whole."""
    if mesh.ranks is None or not mesh.is_member:
        return arrays if len(arrays) > 1 else arrays[0]
    out = []
    for a in arrays:
        rows, hrows = block_sharding(mesh, a.shape[0], a.shape[1])[mesh.position]
        out.append(a[rows, hrows] if spatial else a[rows])
    return tuple(out) if len(out) > 1 else out[0]
