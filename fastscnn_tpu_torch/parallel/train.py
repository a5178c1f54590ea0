"""The train and eval steps on one card or a mesh.

Counterpart of ``fastscnn_tpu/parallel/train.py``. One train step:

  uint8 NHWC images → normalise in the compute dtype → forward of
  ``FastSCNN.apply_params`` in training mode on params cast to the
  compute dtype (batch-stat BN, new running statistics) → loss on the
  1/8 logits (the loss upsamples) → gradients on the f32 master params
  → SGD with momentum or AdamW, at the schedule's learning rate.

bf16 compute over f32 masters needs no loss scaling (bf16 has f32's
exponent range). The cast is a differentiable ``.to(dtype)`` of each
master, so gradients arrive on the masters in f32, as the JAX step's
``grads.astype(f32)``.

Unlike the pure JAX step, this one updates in place, and every tensor
of the state keeps its storage from step to step: the optimizer steps
the master tensors of ``state.params``, each gradient lives in one
buffer (``p.grad``, zeroed at the start of a step, the backward adding
into it), the new BN statistics are copied into ``state.model_state``'s
own tensors, and ``state`` (with its step count) is returned. On the
card the learning rate is a 0-dim device tensor in each param group,
refilled before each update, and the update is one that reads it there:
fused SGD, or AdamW with ``capturable=True`` (``torch.optim``'s other
paths turn a tensor rate into a host float, a sync). With
``device_aug`` the step takes native-resolution uint8 batches and runs
an augmentation chain of ``data/device_aug.py`` on the device before
normalising; :func:`make_split_aug_train_step` runs the chain once for
the batch and then the crop-fed step.

``mesh`` (``parallel/mesh.py``): a process-group mesh runs the steps SPMD,
one process per device, as the JAX steps run over the mesh's chips. Each
rank passes its own rows (``host_shard`` of the global batch) and gets back
what the JAX step returns for the global batch: BN takes the moments of the
global batch (sync-BN), the loss is the global batch's (equal on every
rank), the dropout masks and the augmentation's draws are the global
batch's rows, and after the microbatches the gradients are summed across
the ranks by one all-reduce of a flat f32 buffer (JAX's psum), so the
parameters stay equal on every rank. With ``grad_accum`` > 1, microbatch i
is the global batch's rows ``[i·mb, (i+1)·mb)`` split over the ranks, as in
JAX: the step gathers the ranks' uint8 rows and takes its part of each
microbatch, so the caller keeps ``host_shard``'s convention. The eval step
sums the statistics across the ranks and returns this rank's mask rows.

A mesh with a ``space`` axis: with ``spatial_shard`` each rank passes its
block, its data place's rows and its space index's rows of H
(``mesh.host_block``: JAX's equal blocks, H divisible by the axis, which
the step checks), and the forward and the loss run on blocks of every
level, equal or not (``models/fast_scnn.py``, ``ops/halo.py``): the
sums of the global batch reduce over the whole mesh, and the parameter
gradients of the branches that run replicated across ``space`` (the
pyramid pooling's), partial on each rank, are completed by the gradients'
all-reduce. Without ``spatial_shard`` (and in the eval step) the batch is
replicated across ``space``, as JAX's ``P('data')`` places it: each rank
passes its data place's rows, whole, and the global batch's sums reduce
over the ranks of its space index. In both forms the gradients are
summed over the whole mesh and divided by its size (the n_space copies of
each data place's gradient in the replicated form), so that every rank
applies the same bits; in the replicated form each data place's first
rank then broadcasts its running statistics across ``space``, so that a
card's rounding cannot set its replicas apart. ``device_aug`` with
``spatial_shard``, and the split step under a ``space`` axis, raise JAX's
``ValueError``.

``graph=True`` is the counterpart of the JAX step's ``jit``: on the
card the whole step (the chain, forward, loss, backward and update) is
captured once per input shape as a CUDA graph and replayed, with no
launch from Python (:class:`_GraphedStep`); the eval step likewise, one
graph per input shape (:class:`_GraphedEval`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from fastscnn_tpu_torch import resolve_device
from fastscnn_tpu_torch.engine.infer import IMAGENET_MEAN, IMAGENET_STD
from fastscnn_tpu_torch.models.convert import to_param_trees
from fastscnn_tpu_torch.models.fast_scnn import FastSCNN, space_levels
from fastscnn_tpu_torch.ops.collectives import broadcast_, gather_rows, group_size, sum_
from fastscnn_tpu_torch.ops.halo import space_rows
from fastscnn_tpu_torch.ops.resize import resize_bilinear_matmul
from fastscnn_tpu_torch.parallel.mesh import Mesh, check_spatial_height
from fastscnn_tpu_torch.parallel.multihost import backend_of
from fastscnn_tpu_torch.parallel.spatial import GroupTransport, Space
from fastscnn_tpu_torch.utils.cuda_graph import Captured, capture
from fastscnn_tpu_torch.utils.metric import seg_hist_update
from fastscnn_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = [
    "Optimizer",
    "TrainState",
    "create_train_state",
    "make_optimizer",
    "make_train_step",
    "make_split_aug_train_step",
    "make_eval_step",
]

# eager steps on a side stream before a capture: the first makes the
# optimizer's lazy state and the cuDNN plans, the second runs the update
# path the captured steps take
WARMUP_STEPS = 2


@dataclasses.dataclass
class TrainState:
    """Carried training state: f32 master params (a tree of leaf tensors
    that require grad), BN running statistics (f32 tree), the optimizer
    bound to the masters, and the number of steps taken."""

    params: Any
    model_state: Any
    opt_state: torch.optim.Optimizer
    step: int


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """What :func:`make_optimizer` returns: the update rule and the
    schedule. ``init(params)`` binds a ``torch.optim`` optimizer to the
    leaves of a params tree; ``learning_rate(k)`` is the rate of update k,
    counted from 0 as optax counts."""

    name: str
    schedule: Callable[[int], float] | float
    momentum: float
    weight_decay: float

    def learning_rate(self, step: int) -> float:
        return float(self.schedule(step)) if callable(self.schedule) else float(self.schedule)

    def init(self, params) -> torch.optim.Optimizer:
        """The ``torch.optim`` optimizer over the leaves of ``params``. Its
        ``schedule_count`` says whether the JAX package's optimizer state
        carries a ``ScaleByScheduleState`` count (a callable schedule) or an
        ``EmptyState`` (a constant rate), which an Orbax checkpoint's tree
        must match (``utils/checkpoint.save_train_state_orbax``)."""
        leaves = tree_leaves(params)
        lr = self.learning_rate(0)
        on_card = leaves[0].device.type == "cuda"
        if on_card:  # the rate as a device tensor (module docstring)
            lr = torch.tensor(lr, dtype=torch.float32, device=leaves[0].device)
        if self.name == "sgd":
            # decayed weights added to the gradient, then momentum (the
            # first step's buffer is the gradient): optax's
            # add_decayed_weights + sgd(momentum)
            opt = torch.optim.SGD(leaves, lr=lr, momentum=self.momentum,
                                  weight_decay=self.weight_decay, fused=True if on_card else None)
        else:
            # optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8, decoupled
            # decay lr · wd · p
            opt = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=self.weight_decay, capturable=on_card)
        opt.schedule_count = callable(self.schedule)
        return opt


def make_optimizer(name: str = "sgd", schedule: Callable | float = 1e-2, momentum: float = 0.9,
                   weight_decay: float = 1e-4) -> Optimizer:
    """'sgd': SGD with momentum and coupled weight decay (the reference
    trainer); 'adamw': AdamW (the BDD100K trainer's choice)."""
    if name not in ("sgd", "adamw"):
        raise ValueError(f"unknown optimizer {name!r}")
    return Optimizer(name, schedule, momentum, weight_decay)


def _as_tensor(v, device, dtype=None):
    t = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return t.to(device=device, dtype=dtype).clone().contiguous()


def create_train_state(model: FastSCNN, optimizer: Optimizer, params=None, model_state=None,
                       device=None) -> TrainState:
    """A fresh :class:`TrainState` on ``device`` (None: the CUDA card).
    The weights are ``params``/``model_state`` (trees of tensors or numpy
    arrays, as the JAX package's) or, when those are None, the model's own
    (:func:`~fastscnn_tpu_torch.models.convert.to_param_trees`), copied to
    f32."""
    device = resolve_device(device)
    if params is None:
        params, model_state = to_param_trees(model)
    params = tree_map(lambda v: _as_tensor(v, device, torch.float32).requires_grad_(), params)
    model_state = tree_map(lambda v: _as_tensor(v, device, torch.float32), model_state)
    return TrainState(params, model_state, optimizer.init(params), 0)


class _Normalize:
    """uint8 [0, 255] → ``dtype``: cast, × (1/255) rounded to ``dtype``,
    then (x − mean) / std — the JAX step's rounding order. The constants
    are copied to a device once per device and dtype (as the engine's
    ``_preprocess`` keeps them), so a call after the first copies nothing
    from the host and a CUDA graph can capture it."""

    def __init__(self, mean, std):
        self.mean, self.std = mean, std
        self._consts: dict = {}

    def __call__(self, images: torch.Tensor, dtype) -> torch.Tensor:
        key = (images.device, dtype)
        if key not in self._consts:
            def const(v):
                return torch.tensor(v, dtype=dtype, device=images.device)

            self._consts[key] = (const(1.0 / 255.0), *(
                (None, None) if self.mean is None else (const(self.mean), const(self.std))))
        inv255, mean, std = self._consts[key]
        x = images.to(dtype) * inv255
        if mean is not None:
            x = (x - mean) / std
        return x


def _set_lr(opt: torch.optim.Optimizer, value: float) -> None:
    """The rate of this update into every param group: on the card the
    group's 0-dim device tensor, refilled in place (one made where a
    ``load_state_dict`` left a float or a host tensor), on the CPU a float."""
    for group in opt.param_groups:
        device = group["params"][0].device
        if device.type != "cuda":
            group["lr"] = value
            continue
        lr = group["lr"]
        if not isinstance(lr, torch.Tensor) or lr.device != device:
            group["lr"] = lr = torch.zeros((), dtype=torch.float32, device=device)
        lr.fill_(value)


def _state_tensors(state: TrainState) -> list:
    """Every tensor a step reads or writes in place: the masters, their
    gradient buffers, the BN statistics, the optimizer's state and its
    tensor rates (None where a buffer is not made yet)."""
    params = tree_leaves(state.params)
    opt = state.opt_state
    slots = [v for p in params for _, v in sorted(opt.state.get(p, {}).items())
             if isinstance(v, torch.Tensor)]
    rates = [g["lr"] for g in opt.param_groups if isinstance(g["lr"], torch.Tensor)]
    return params + [p.grad for p in params] + tree_leaves(state.model_state) + slots + rates


def make_train_step(
    model: FastSCNN,
    loss_fn: Callable,
    optimizer: Optimizer,
    mesh=None,
    compute_dtype: torch.dtype = torch.bfloat16,
    mean=IMAGENET_MEAN,
    std=IMAGENET_STD,
    spatial_shard: bool = False,
    grad_accum: int = 1,
    device_aug=None,
    donate_batch: bool = False,
    device=None,
    graph: bool = False,
):
    """Build ``step(state, images_u8, targets, generator=None,
    aug_generator=None) -> (state, {'loss': f32 scalar tensor})`` on
    ``device`` (None: the CUDA card).

    ``generator`` (a ``torch.Generator`` on the device) draws the dropout
    masks; without one dropout is off. ``grad_accum`` > 1 splits the batch
    into that many microbatches run in sequence: the BN statistics thread
    through them, the optimizer applies the mean of their gradients, and
    the loss is the mean of theirs — torch-style gradient accumulation,
    activation memory of one microbatch.

    ``device_aug``: an ``augment(images, masks, generator)`` of
    :mod:`~fastscnn_tpu_torch.data.device_aug`. The step then takes
    native-resolution uint8 images and remapped labels (int8 or wider),
    and augments each microbatch with parameters drawn from
    ``aug_generator`` before normalising it, as the JAX step draws a key
    per microbatch.

    ``donate_batch``: the step drops its references to the input batch
    once it has read it (augmented, or normalised), so that the caching
    allocator can reuse that memory within the step. The memory is freed
    only if the caller holds no reference to a device tensor it passed.

    ``graph``: the counterpart of the JAX step's ``jit``, on the card
    only (``ValueError`` elsewhere): the step is a :class:`_GraphedStep`,
    each input shape captured once as a CUDA graph and replayed.
    ``donate_batch`` has no effect there (the graph copies each batch into
    its own input buffers).

    ``mesh``: a process-group mesh (module docstring); ``device`` defaults
    to this rank's device in it. ``loss_fn`` then takes ``group=`` (every
    loss of ``losses/`` does), and ``space=`` with ``spatial_shard``.
    ``graph=True`` under a mesh captures the collectives too (the spatial
    exchanges included), which NCCL allows and gloo does not
    (``ValueError``)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if device_aug is not None and spatial_shard:
        raise ValueError("device_aug is incompatible with spatial_shard")
    dp = _data_parallel(mesh, spatial_shard, graph)
    device = _step_device(_rank_device(device, mesh), graph)
    compute = _make_compute(model, loss_fn, compute_dtype, mean, std, grad_accum, device_aug,
                            donate_batch, dp)
    if graph:
        return _GraphedStep(compute, optimizer, device)

    def step(state: TrainState, images, targets, generator: torch.Generator | None = None,
             aug_generator: torch.Generator | None = None):
        batch = [torch.as_tensor(images).to(device), torch.as_tensor(targets).to(device)]
        del images, targets
        return _eager_update(compute, optimizer, state, batch, generator, aug_generator)

    return step


@dataclasses.dataclass(frozen=True)
class _DataParallel:
    """What a step under a process-group mesh reduces over: ``group``, over
    which the global batch's sums reduce (the whole mesh under spatial
    sharding, else the ranks of this rank's space index; None for one data
    place); this rank's place on ``data`` and the number of places;
    ``mesh_group``, the whole mesh's, over which the gradients reduce;
    ``data_group``, the ranks that hold this rank's H rows, one a data
    place (the microbatches regroup over it); ``space``, this rank's
    :class:`~fastscnn_tpu_torch.parallel.spatial.Space` under spatial
    sharding; ``replicas``, under a ``space`` axis without it, the group of
    this rank's data place and the global rank of its first, whose running
    statistics the others take."""

    group: Any
    index: int
    size: int
    mesh_group: Any
    data_group: Any = None
    space: Space | None = None
    replicas: tuple | None = None

    @property
    def shard(self) -> tuple[int, int]:
        return self.index, self.size


def _data_parallel(mesh, spatial_shard: bool, graph: bool) -> _DataParallel | None:
    """The step's parallelism under ``mesh``; None for no mesh or a mesh of
    one device. Raises for a local mesh of several devices (a step runs one
    process a device), for a rank the mesh left out and for a graph over
    gloo."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, not {type(mesh).__name__}")
    if mesh is None:
        return None
    if mesh.ranks is not None and not mesh.is_member:
        raise ValueError("this rank is not in the mesh (make_mesh_for_batch left it out): it "
                         "has no rows to step on")
    if mesh.group is None:
        if mesh.size > 1:
            raise ValueError(
                f"a step under a mesh of {mesh.size} devices runs one process a device: join "
                "the processes with initialize_multihost and build the mesh there (a local "
                "mesh of several devices is for InferenceEngine)")
        return None  # one device: the single-process step
    n_space = mesh.shape["space"]
    spatial = spatial_shard and n_space > 1
    data_group = mesh.group if n_space == 1 else mesh.data_group
    backend = backend_of(mesh.group)
    if graph and backend != "nccl":
        raise ValueError(f"graph=True captures the step's collectives, which the {backend} "
                         "backend cannot run in a CUDA graph: use NCCL, or graph=False")
    if spatial:
        space = Space(GroupTransport(mesh.space_group), mesh.space_index, n_space, data_group)
        return _DataParallel(mesh.group, mesh.index, mesh.shape["data"], mesh.group, data_group,
                             space)
    replicas = None if n_space == 1 else (mesh.space_group, mesh.ranks[mesh.index * n_space])
    return _DataParallel(data_group, mesh.index, mesh.shape["data"], mesh.group, data_group,
                         replicas=replicas)


def _rank_device(device, mesh):
    """``device``; None under a process-group mesh: this rank's device in it."""
    if device is None and isinstance(mesh, Mesh) and mesh.group is not None and mesh.is_member:
        return mesh.local_device
    return device


def _step_device(device, graph: bool) -> torch.device:
    device = resolve_device(device)
    if graph and device.type != "cuda":
        raise ValueError(f"graph=True captures a CUDA graph: it needs a CUDA device, not {device}")
    return device


def _eager_update(compute, optimizer: Optimizer, state: TrainState, batch: list, generator,
                  aug_generator):
    """One eager step: the rate of update ``state.step``, the step's device
    work, the count."""
    _set_lr(state.opt_state, optimizer.learning_rate(state.step))
    loss = compute(state, batch, generator, aug_generator)
    state.step += 1
    return state, {"loss": loss}


def _grad_buffers(leaves: list, flat: bool) -> torch.Tensor | None:
    """Each master's gradient buffer, made once: a tensor of zeros each, or
    with ``flat`` views of one flat f32 buffer (one all-reduce sums them
    all), which is returned."""
    if not flat:
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return None
    total = sum(p.numel() for p in leaves)
    base = leaves[0].grad._base if leaves[0].grad is not None else None
    if (base is None or base.numel() != total
            or any(p.grad is None or p.grad._base is not base for p in leaves)):
        base = torch.zeros(total, dtype=torch.float32, device=leaves[0].device)
        offset = 0
        for p in leaves:
            p.grad = base[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
    return base


def _microbatch_rows(t: torch.Tensor, grad_accum: int, dp: _DataParallel) -> torch.Tensor:
    """This rank's rows of each microbatch of the global batch, in microbatch
    order: the ranks' rows gathered (the global batch), microbatch i its
    rows ``[i·mb, (i+1)·mb)``, split over the ranks as the JAX step reshards
    it. A batch of b rows a rank gives b rows back, b / grad_accum a
    microbatch."""
    full = gather_rows(t, dp.data_group)
    per = t.shape[0] // grad_accum
    return full.reshape(grad_accum, dp.size, per, *t.shape[1:])[:, dp.index].reshape(t.shape)


def _check_blocks(images: torch.Tensor, space: Space, checked: set) -> None:
    """JAX's refusal of an input whose H does not split in equal blocks over
    ``space`` (``mesh.check_spatial_height``): the ranks' block heights,
    gathered over the space group in one small exchange, must be equal,
    their sum divisible by the axis. Each block height is checked once, the
    first time the step sees it (in a graphed step's warm-up, not in its
    capture), and added to ``checked``; every rank
    passes its block of ``mesh.host_block``, so the ranks see a new height
    together."""
    h = images.shape[1]
    if h in checked or (images.device.type == "cuda"
                        and torch.cuda.is_current_stream_capturing()):
        return
    heights = [int(t) for t in space.transport.all_gather(
        torch.tensor([h], dtype=torch.int64, device=images.device))]
    check_spatial_height(sum(heights), space.size)
    if len(set(heights)) > 1:
        raise ValueError(f"the ranks' blocks of H differ ({heights} rows): each passes its "
                         "block of mesh.host_block, JAX's equal blocks")
    checked.add(h)


def _make_compute(model, loss_fn, compute_dtype, mean, std, grad_accum, device_aug,
                  donate_batch, dp: _DataParallel | None = None):
    """The device work of a train step, on a batch already on the device
    passed as the list ``[images, targets]`` (emptied once read when
    ``donate_batch``), at the rate already in the optimizer's groups: it
    reads and writes only the state's own tensors and returns the loss, so
    a CUDA graph can capture it. Under ``dp`` the batch is this rank's rows
    (module docstring). ``compute.grad_buffers(state)`` makes the
    gradients' buffers as the step uses them."""
    normalize = _Normalize(mean, std)
    group = None if dp is None else dp.group
    space = None if dp is None else dp.space
    loss_kwargs = {} if dp is None else {"group": group}

    def grads_of(params, model_state, x, targets, generator):
        cast = tree_map(lambda p: p.to(compute_dtype), params)
        # under space the input's level: JAX's equal blocks (_check_blocks)
        sp = None if space is None else space.at(space_rows(space.size, x.shape[1] * space.size))
        outputs, new_model_state = model.apply_params(
            cast, model_state, x, training=True, generator=generator, upsample_outputs=False,
            group=group, space=sp)
        if sp is not None:  # the loss's blocks of the 1/8 logits
            loss_kwargs["space"] = space_levels(x, sp)[3]
        loss = loss_fn(outputs, targets, **loss_kwargs).float()
        loss.backward()  # accumulates f32 gradients on the masters
        return loss.detach(), new_model_state

    def prepared(images, targets, aug_generator):
        if device_aug is not None:
            if dp is None:
                images, targets = device_aug(images, targets, aug_generator)
            else:
                images, targets = device_aug(images, targets, aug_generator, shard=dp.shard)
        return normalize(images, compute_dtype), targets

    def grad_buffers(state: TrainState):
        return _grad_buffers(tree_leaves(state.params), dp is not None)

    checked_heights = set()

    def compute(state: TrainState, batch: list, generator, aug_generator) -> torch.Tensor:
        if device_aug is not None and aug_generator is None:
            raise ValueError("a step with device_aug needs an aug_generator")
        n = batch[0].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} not divisible by grad_accum {grad_accum}")
        if space is not None:
            _check_blocks(batch[0], space, checked_heights)
        if dp is not None and grad_accum > 1 and dp.size > 1:
            batch[:] = [_microbatch_rows(t, grad_accum, dp) for t in batch]
        flat = grad_buffers(state)
        grads = [p.grad for p in tree_leaves(state.params)]
        # a param the loss does not reach keeps a zero gradient, as in JAX
        torch._foreach_zero_(grads)
        mb = n // grad_accum
        new_model_state, loss = state.model_state, 0.0
        for i in range(grad_accum):
            x, t = prepared(batch[0][i * mb:(i + 1) * mb], batch[1][i * mb:(i + 1) * mb],
                            aug_generator)
            if donate_batch and i == grad_accum - 1:
                batch.clear()
            loss_i, new_model_state = grads_of(state.params, new_model_state, x, t, generator)
            del x, t
            loss = loss + loss_i
        if grad_accum > 1:
            loss = loss / grad_accum
        if flat is not None:
            # the ranks' gradients summed (JAX's psum); autograd through the
            # loss's all-reduces differentiated N copies of the global loss
            # (times n_space in the replicated form). Under space that holds
            # whatever the blocks' heights: each rank's backward is the
            # derivative through its own rows, the exchanges send each
            # fetched row's gradient to its owner, the rows of a level
            # partition it (an empty block adds zero), and the sum over the
            # ranks is the derivative of the N copies
            # (test_torch_spatial.py's f64 cases hold it to one process)
            sum_(flat, dp.mesh_group).div_(group_size(dp.mesh_group) * grad_accum)
        elif grad_accum > 1:
            torch._foreach_div_(grads, grad_accum)
        state.opt_state.step()
        with torch.no_grad():
            torch._foreach_copy_(tree_leaves(state.model_state), tree_leaves(new_model_state))
            if dp is not None and dp.replicas is not None:
                broadcast_(tree_leaves(state.model_state), *dp.replicas)
        return loss

    compute.grad_buffers = grad_buffers
    return compute


def make_split_aug_train_step(
    model: FastSCNN,
    loss_fn: Callable,
    optimizer: Optimizer,
    device_aug: Callable,
    mesh=None,
    compute_dtype: torch.dtype = torch.bfloat16,
    mean=IMAGENET_MEAN,
    std=IMAGENET_STD,
    grad_accum: int = 1,
    device=None,
    graph: bool = False,
):
    """Two-stage form of ``make_train_step(device_aug=...)``: the chain
    augments the whole batch once, then the crop-fed step runs (with
    ``grad_accum`` microbatches of the crops). Same
    signature as that step's. At ``grad_accum=1`` it draws what the fused
    step draws from the same ``aug_generator``; with ``grad_accum > 1``
    the fused step draws per microbatch and this one once for the batch
    (the same distribution, another stream). The step always drops its
    references to the native-resolution batch once the chain has read it;
    eager PyTorch has no buffer donation, so the JAX step's ``donate``
    argument has no counterpart here. ``graph=True``: each stage is a
    CUDA graph of its own, as the JAX split path compiles two programs.
    ``mesh``: as :func:`make_train_step`'s; the chain draws the global
    batch's parameters and augments this rank's rows. A ``space`` axis
    above 1 raises JAX's ``ValueError``."""
    if mesh is not None and mesh.shape.get("space", 1) > 1:
        raise ValueError("device_aug is incompatible with spatial sharding")
    dp = _data_parallel(mesh, False, graph)
    device = _step_device(_rank_device(device, mesh), graph)
    compute = _make_compute(model, loss_fn, compute_dtype, mean, std, grad_accum, None, True, dp)
    if dp is not None:
        chain = device_aug

        def device_aug(images, targets, generator):
            return chain(images, targets, generator, shard=dp.shard)
    if graph:
        return _GraphedStep(compute, optimizer, device, chain=device_aug)

    def split_step(state: TrainState, images, targets, generator: torch.Generator | None = None,
                   aug_generator: torch.Generator | None = None):
        if aug_generator is None:
            raise ValueError("a step with device_aug needs an aug_generator")
        batch = [torch.as_tensor(images).to(device), torch.as_tensor(targets).to(device)]
        del images, targets
        crops = list(device_aug(batch[0], batch[1], aug_generator))
        batch.clear()
        return _eager_update(compute, optimizer, state, crops, generator, None)

    return split_step


@dataclasses.dataclass
class _ShapeGraphs:
    """The graphs of one input shape and what their capture fixed: the
    input buffers, the loss output, the optimizer and generators, and the
    addresses of the state's tensors."""

    inputs: list
    graphs: list
    loss: torch.Tensor
    opt: torch.optim.Optimizer
    generators: tuple
    addresses: list


def _addresses(tensors) -> list:
    return [0 if t is None else t.data_ptr() for t in tensors]


def _input_key(images: torch.Tensor, targets: torch.Tensor) -> tuple:
    return (tuple(images.shape), images.dtype, tuple(targets.shape), targets.dtype)


def _input_buffers(images: torch.Tensor, targets: torch.Tensor, device) -> list:
    """A graph's static inputs, each holding a first copy of the batch."""
    buffers = [torch.empty(t.shape, dtype=t.dtype, device=device) for t in (images, targets)]
    for buf, t in zip(buffers, (images, targets)):
        buf.copy_(t)
    return buffers


class _Graphed:
    """What the graphed steps share: one memory pool and side stream for
    their captures, ``_shapes`` (input key → an object whose ``graphs``
    lists that shape's captures, the last one replayed once a call), and
    the counts the engine's graphed callables report: ``graphs`` (every
    :class:`~fastscnn_tpu_torch.utils.cuda_graph.Captured`), ``launches``
    (the kernel wrappers' launches one replay of each repeats), ``replays``
    and ``pool_bytes``."""

    def __init__(self, device: torch.device):
        self.device = device
        self._pool = self._stream = None
        self._shapes: dict = {}

    def release(self) -> None:
        """Drop every capture (a later call captures again). NCCL destroys
        no communicator while a graph that captured its collectives lives,
        so a run under a mesh releases its graphs before it leaves the
        process group."""
        self._shapes.clear()
        self._pool = self._stream = None

    @property
    def graphs(self) -> list:
        return [g for shape in self._shapes.values() for g in shape.graphs]

    @property
    def launches(self) -> dict:
        out: dict = {}
        for g in self.graphs:
            for name, n in g.launches.items():
                out[name] = out.get(name, 0) + n
        return out

    @property
    def replays(self) -> int:
        return sum(shape.graphs[-1].replays for shape in self._shapes.values())

    @property
    def pool_bytes(self) -> int:
        return sum(g.pool_bytes for g in self.graphs)

    def _warm_and_capture(self, body: Callable, generators=()) -> Captured:
        """:data:`WARMUP_STEPS` eager passes of ``body`` on the side stream,
        then its capture; each generator's state is put back after the
        warm-up, so the capture's own draws start where the call found it."""
        dev = self.device
        if self._pool is None:
            self._pool, self._stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev)
        stream = self._stream
        drawn = [g.get_state() for g in generators]
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_STEPS):
                body()
        torch.cuda.current_stream(dev).wait_stream(stream)
        for g, s in zip(generators, drawn):
            g.set_state(s)
        return capture(body, dev, self._pool, stream, generators)


class _GraphedStep(_Graphed):
    """A train step with the eager step's signature and results, run as
    CUDA graphs (``graph=True``). The first call for an input shape and
    dtype captures the step on a side stream into the step's memory pool,
    after :data:`WARMUP_STEPS` eager steps that make every lazy buffer
    (gradients, the optimizer's state, cuDNN plans, device tables) and are
    then undone: the state's tensors get their values back (a buffer the
    warm-up made is zeroed, which is where a fresh optimizer starts) and
    each generator its state, so k graphed steps compute what k eager
    steps compute. Every call copies the batch into the graph's input
    buffers, refills the rate tensors, replays and returns a copy of the
    loss, with no sync.

    A call refuses (``ValueError``) a state whose optimizer or tensors
    are not the ones captured (a checkpoint load that rebinds them), or
    other generator objects than the ones captured: the graph reads and
    writes fixed addresses, and the generators are registered with it (a
    registered generator may be reseeded between calls: a replay draws
    from its seed and offset at the time). With ``chain`` (the split form)
    the chain is a graph of its own, whose crops are the step graph's
    input. Counts as :class:`_Graphed`."""

    def __init__(self, compute: Callable, optimizer: Optimizer, device: torch.device,
                 chain: Callable | None = None):
        super().__init__(device)
        self._compute, self._optimizer, self._chain = compute, optimizer, chain

    def __call__(self, state: TrainState, images, targets, generator=None, aug_generator=None):
        if self._chain is not None and aug_generator is None:
            raise ValueError("a step with device_aug needs an aug_generator")
        images, targets = torch.as_tensor(images), torch.as_tensor(targets)
        key = _input_key(images, targets)
        shape = self._shapes.get(key)
        if shape is None:
            shape = self._shapes[key] = self._capture(state, images, targets, generator,
                                                      aug_generator)
        if (state.opt_state is not shape.opt or shape.generators[0] is not generator
                or shape.generators[1] is not aug_generator):
            raise ValueError("graphed train step: called with another optimizer or generator "
                             "than the ones its graph captured")
        if _addresses(_state_tensors(state)) != shape.addresses:
            raise ValueError("graphed train step: the state's tensors are not the ones its "
                             "graph captured (a load that rebinds them?)")
        shape.inputs[0].copy_(images, non_blocking=True)
        shape.inputs[1].copy_(targets, non_blocking=True)
        _set_lr(state.opt_state, self._optimizer.learning_rate(state.step))
        for g in shape.graphs:
            g.replay()
        state.step += 1
        return state, {"loss": shape.loss.clone()}

    def _capture(self, state, images, targets, generator, aug_generator) -> _ShapeGraphs:
        _set_lr(state.opt_state, self._optimizer.learning_rate(state.step))
        for group in state.opt_state.param_groups:
            if not (group.get("fused") or group.get("capturable")):
                raise ValueError("graphed train step: the optimizer must read its rate on the "
                                 "card (fused SGD or capturable AdamW, as Optimizer.init makes "
                                 "them for params there)")
        inputs = _input_buffers(images, targets, self.device)
        generators = [g for g in (generator, aug_generator) if g is not None]
        drawn = [g.get_state() for g in generators]
        graphs, batch, step_aug = [], inputs, aug_generator
        if self._chain is not None:
            chain = self._warm_and_capture(lambda: tuple(self._chain(*inputs, aug_generator)),
                                           [aug_generator])
            chain.replay()  # the crops the step's warm-up trains on
            graphs.append(chain)
            batch, step_aug = list(chain.out), None
        self._compute.grad_buffers(state)  # the gradients' buffers, made on the caller's stream
        saved = {t.data_ptr(): (t, t.detach().clone()) for t in _state_tensors(state)}
        step_generators = [g for g in (generator, step_aug) if g is not None]
        graphs.append(self._warm_and_capture(
            lambda: self._compute(state, list(batch), generator, step_aug), step_generators))
        with torch.no_grad():  # undo the warm-up
            for t in _state_tensors(state):
                if t.data_ptr() in saved:
                    t.copy_(saved[t.data_ptr()][1])
                else:  # made by the warm-up: where a fresh optimizer's state starts
                    t.zero_()
        for g, s in zip(generators, drawn):
            g.set_state(s)
        return _ShapeGraphs(inputs, graphs, graphs[-1].out, state.opt_state,
                            (generator, aug_generator), _addresses(_state_tensors(state)))


@dataclasses.dataclass
class _EvalGraph:
    """The eval graph of one input shape: its input buffers, the capture
    (its ``out``: the mask and the four statistics) and the addresses of
    the params and BN statistics it read."""

    inputs: list
    graphs: list
    addresses: list


class _GraphedEval(_Graphed):
    """An eval step with the eager step's signature and results, run as
    CUDA graphs (``graph=True``): the first call for an input shape and
    dtype captures the whole step (normalisation, the cast of the params
    to the compute dtype, forward, upsample, argmax, statistics) after
    :data:`WARMUP_STEPS` eager passes; every call copies the batch into
    the graph's inputs, replays and returns copies of the mask and the
    statistics. It reads the params and BN statistics where the capture
    found them, so a call with other tensors (a load that rebinds them)
    raises ``ValueError``. Counts as :class:`_Graphed`."""

    def __init__(self, forward: Callable, device: torch.device):
        super().__init__(device)
        self._forward = forward

    def __call__(self, params, model_state, images, targets):
        images, targets = torch.as_tensor(images), torch.as_tensor(targets)
        key = _input_key(images, targets)
        shape = self._shapes.get(key)
        if shape is None:
            inputs = _input_buffers(images, targets, self.device)

            @torch.no_grad()
            def body():
                pred, stats = self._forward(params, model_state, *inputs)
                return (pred, *stats)

            shape = self._shapes[key] = _EvalGraph(
                inputs, [self._warm_and_capture(body)],
                _addresses(tree_leaves(params) + tree_leaves(model_state)))
        if _addresses(tree_leaves(params) + tree_leaves(model_state)) != shape.addresses:
            raise ValueError("graphed eval step: the params or BN statistics are not the "
                             "tensors its graph captured (a load that rebinds them?)")
        shape.inputs[0].copy_(images, non_blocking=True)
        shape.inputs[1].copy_(targets, non_blocking=True)
        pred, *stats = (t.clone() for t in shape.graphs[0].replay())
        return pred, tuple(stats)


def make_eval_step(
    model: FastSCNN,
    num_classes: int,
    mesh=None,
    compute_dtype: torch.dtype = torch.bfloat16,
    mean=IMAGENET_MEAN,
    std=IMAGENET_STD,
    per_sample_stats: bool = False,
    pred_dtype: torch.dtype = torch.int32,
    device=None,
    graph: bool = False,
):
    """Build ``step(params, model_state, images_u8, targets) -> (pred,
    (correct, labeled, inter, union))`` on ``device`` (None: the CUDA
    card): eval-mode forward on params cast to the compute dtype, the
    1/8 logits upsampled by interpolation matmuls, argmax, and the metric
    statistics of :func:`~fastscnn_tpu_torch.utils.metric.seg_hist_update`
    (per image with ``per_sample_stats``). ``pred_dtype``: the returned
    mask's dtype; the statistics come from the int32 mask.

    ``graph``: the counterpart of the JAX eval step's ``jit``, on the card
    only (``ValueError`` elsewhere): the step is a :class:`_GraphedEval`,
    each input shape captured once as a CUDA graph and replayed.

    ``mesh``: a process-group mesh (module docstring): each rank passes its
    rows and gets back its rows' mask and the statistics of the global
    batch (summed across the ranks; with ``per_sample_stats`` every rank's
    rows gathered, in the global batch's order). Under a ``space`` axis the
    batch is replicated across it, as in JAX: each rank passes its data
    place's rows and gets back their masks, the statistics summed over
    ``data``."""
    dp = _data_parallel(mesh, False, graph)
    device = _step_device(_rank_device(device, mesh), graph)
    normalize = _Normalize(mean, std)

    def forward(params, model_state, images, targets):
        x = normalize(images, compute_dtype)
        cast = tree_map(lambda p: p.to(compute_dtype), params)
        outputs, _ = model.apply_params(cast, model_state, x, training=False,
                                        upsample_outputs=False)
        logits = outputs[0]
        if logits.shape[1:3] != x.shape[1:3]:
            logits = resize_bilinear_matmul(logits, (x.shape[1], x.shape[2]), align_corners=True)
        pred = logits.argmax(dim=-1).to(torch.int32)
        stats = seg_hist_update(pred, targets, num_classes, per_sample=per_sample_stats)
        if dp is not None:
            reduce = gather_rows if per_sample_stats else sum_
            stats = tuple(reduce(s, dp.group) for s in stats)
        return pred.to(pred_dtype), stats

    if graph:
        return _GraphedEval(forward, device)

    @torch.no_grad()
    def step(params, model_state, images, targets):
        return forward(params, model_state, torch.as_tensor(images).to(device),
                       torch.as_tensor(targets).to(device))

    return step
