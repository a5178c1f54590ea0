"""The train and eval steps on one card.

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
the batch and then the crop-fed step. The JAX step's ``mesh`` and
``spatial_shard`` are not ported yet and raise ``NotImplementedError``
naming their ROADMAP.md item.

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
from fastscnn_tpu_torch.models.fast_scnn import FastSCNN
from fastscnn_tpu_torch.ops.resize import resize_bilinear_matmul
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

_MULTI_DEVICE = "ROADMAP.md, queue item 'multi-device'"
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
        leaves = tree_leaves(params)
        lr = self.learning_rate(0)
        on_card = leaves[0].device.type == "cuda"
        if on_card:  # the rate as a device tensor (module docstring)
            lr = torch.tensor(lr, dtype=torch.float32, device=leaves[0].device)
        if self.name == "sgd":
            # decayed weights added to the gradient, then momentum (the
            # first step's buffer is the gradient): optax's
            # add_decayed_weights + sgd(momentum)
            return torch.optim.SGD(leaves, lr=lr, momentum=self.momentum,
                                   weight_decay=self.weight_decay, fused=True if on_card else None)
        # optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8, decoupled
        # decay lr · wd · p
        return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.weight_decay, capturable=on_card)


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
    its own input buffers)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if mesh is not None or spatial_shard:
        raise NotImplementedError(f"mesh and spatial_shard are not ported yet ({_MULTI_DEVICE})")
    device = _step_device(device, graph)
    compute = _make_compute(model, loss_fn, compute_dtype, mean, std, grad_accum, device_aug,
                            donate_batch)
    if graph:
        return _GraphedStep(compute, optimizer, device)

    def step(state: TrainState, images, targets, generator: torch.Generator | None = None,
             aug_generator: torch.Generator | None = None):
        batch = [torch.as_tensor(images).to(device), torch.as_tensor(targets).to(device)]
        del images, targets
        return _eager_update(compute, optimizer, state, batch, generator, aug_generator)

    return step


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


def _make_compute(model, loss_fn, compute_dtype, mean, std, grad_accum, device_aug,
                  donate_batch):
    """The device work of a train step, on a batch already on the device
    passed as the list ``[images, targets]`` (emptied once read when
    ``donate_batch``), at the rate already in the optimizer's groups: it
    reads and writes only the state's own tensors and returns the loss, so
    a CUDA graph can capture it."""
    normalize = _Normalize(mean, std)

    def grads_of(params, model_state, x, targets, generator):
        cast = tree_map(lambda p: p.to(compute_dtype), params)
        outputs, new_model_state = model.apply_params(
            cast, model_state, x, training=True, generator=generator, upsample_outputs=False)
        loss = loss_fn(outputs, targets).float()
        loss.backward()  # accumulates f32 gradients on the masters
        return loss.detach(), new_model_state

    def prepared(images, targets, aug_generator):
        if device_aug is not None:
            images, targets = device_aug(images, targets, aug_generator)
        return normalize(images, compute_dtype), targets

    def compute(state: TrainState, batch: list, generator, aug_generator) -> torch.Tensor:
        if device_aug is not None and aug_generator is None:
            raise ValueError("a step with device_aug needs an aug_generator")
        n = batch[0].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} not divisible by grad_accum {grad_accum}")
        leaves = tree_leaves(state.params)
        for p in leaves:
            if p.grad is None:  # the gradient's buffer, made once
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in leaves]
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
            torch._foreach_div_(grads, grad_accum)
        state.opt_state.step()
        with torch.no_grad():
            torch._foreach_copy_(tree_leaves(state.model_state), tree_leaves(new_model_state))
        return loss

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
    CUDA graph of its own, as the JAX split path compiles two programs."""
    if mesh is not None:
        raise NotImplementedError(f"mesh is not ported yet ({_MULTI_DEVICE})")
    device = _step_device(device, graph)
    compute = _make_compute(model, loss_fn, compute_dtype, mean, std, grad_accum, None, True)
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
        for p in tree_leaves(state.params):
            if p.grad is None:  # the gradients' buffers, made on the caller's stream
                p.grad = torch.zeros_like(p)
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
    each input shape captured once as a CUDA graph and replayed."""
    if mesh is not None:
        raise NotImplementedError(f"mesh is not ported yet ({_MULTI_DEVICE})")
    device = _step_device(device, graph)
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
        return pred.to(pred_dtype), stats

    if graph:
        return _GraphedEval(forward, device)

    @torch.no_grad()
    def step(params, model_state, images, targets):
        return forward(params, model_state, torch.as_tensor(images).to(device),
                       torch.as_tensor(targets).to(device))

    return step
