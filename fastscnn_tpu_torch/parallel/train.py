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

Unlike the pure JAX step, this one updates in place: the optimizer
steps the master tensors of ``state.params``, and ``state`` (with its
new BN statistics and step count) is returned. With ``device_aug`` the
step takes native-resolution uint8 batches and runs an augmentation
chain of ``data/device_aug.py`` on the device before normalising;
:func:`make_split_aug_train_step` runs the chain once for the batch and
then the crop-fed step. The JAX step's ``mesh`` and ``spatial_shard``
are not ported yet and raise ``NotImplementedError`` naming their
ROADMAP.md item; its ``jit`` has no counterpart (PyTorch runs eagerly).
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
        if self.name == "sgd":
            # decayed weights added to the gradient, then momentum (the
            # first step's buffer is the gradient): optax's
            # add_decayed_weights + sgd(momentum)
            return torch.optim.SGD(leaves, lr=lr, momentum=self.momentum,
                                   weight_decay=self.weight_decay)
        # optax.adamw's defaults: b1 0.9, b2 0.999, eps 1e-8, decoupled
        # decay lr · wd · p
        return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.weight_decay)


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


def _normalize(images: torch.Tensor, mean, std, dtype) -> torch.Tensor:
    """uint8 [0, 255] → ``dtype``: cast, × (1/255) rounded to ``dtype``,
    then (x − mean) / std — the JAX step's rounding order."""
    x = images.to(dtype) * torch.tensor(1.0 / 255.0, dtype=dtype, device=images.device)
    if mean is not None:
        x = (x - torch.tensor(mean, dtype=dtype, device=x.device)) / torch.tensor(
            std, dtype=dtype, device=x.device)
    return x


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
    only if the caller holds no reference to a device tensor it passed."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if mesh is not None or spatial_shard:
        raise NotImplementedError(f"mesh and spatial_shard are not ported yet ({_MULTI_DEVICE})")
    run = _make_run(model, loss_fn, optimizer, compute_dtype, mean, std, grad_accum, device_aug,
                    donate_batch)
    device = resolve_device(device)

    def step(state: TrainState, images, targets, generator: torch.Generator | None = None,
             aug_generator: torch.Generator | None = None):
        batch = [torch.as_tensor(images).to(device), torch.as_tensor(targets).to(device)]
        del images, targets
        return run(state, batch, generator, aug_generator)

    return step


def _make_run(model, loss_fn, optimizer, compute_dtype, mean, std, grad_accum, device_aug,
              donate_batch):
    """The train step on a batch already on the device, passed as the list
    ``[images, targets]`` (emptied once read when ``donate_batch``)."""

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
        return _normalize(images, mean, std, compute_dtype), targets

    def run(state: TrainState, batch: list, generator, aug_generator):
        if device_aug is not None and aug_generator is None:
            raise ValueError("a step with device_aug needs an aug_generator")
        n = batch[0].shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} not divisible by grad_accum {grad_accum}")
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.grad = None
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
        for p in leaves:
            if p.grad is None:  # a param the loss does not reach: a zero gradient, as in JAX
                p.grad = torch.zeros_like(p)
            elif grad_accum > 1:
                p.grad.div_(grad_accum)
        lr = optimizer.learning_rate(state.step)
        for group in state.opt_state.param_groups:
            group["lr"] = lr
        state.opt_state.step()
        state.model_state = new_model_state
        state.step += 1
        return state, {"loss": loss}

    return run


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
    argument has no counterpart here."""
    if mesh is not None:
        raise NotImplementedError(f"mesh is not ported yet ({_MULTI_DEVICE})")
    device = resolve_device(device)
    run = _make_run(model, loss_fn, optimizer, compute_dtype, mean, std, grad_accum, None, True)

    def split_step(state: TrainState, images, targets, generator: torch.Generator | None = None,
                   aug_generator: torch.Generator | None = None):
        if aug_generator is None:
            raise ValueError("a step with device_aug needs an aug_generator")
        batch = [torch.as_tensor(images).to(device), torch.as_tensor(targets).to(device)]
        del images, targets
        crops = list(device_aug(batch[0], batch[1], aug_generator))
        batch.clear()
        return run(state, crops, generator, None)

    return split_step


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
):
    """Build ``step(params, model_state, images_u8, targets) -> (pred,
    (correct, labeled, inter, union))`` on ``device`` (None: the CUDA
    card): eval-mode forward on params cast to the compute dtype, the
    1/8 logits upsampled by interpolation matmuls, argmax, and the metric
    statistics of :func:`~fastscnn_tpu_torch.utils.metric.seg_hist_update`
    (per image with ``per_sample_stats``). ``pred_dtype``: the returned
    mask's dtype; the statistics come from the int32 mask."""
    if mesh is not None:
        raise NotImplementedError(f"mesh is not ported yet ({_MULTI_DEVICE})")
    device = resolve_device(device)

    @torch.no_grad()
    def step(params, model_state, images, targets):
        images = torch.as_tensor(images).to(device)
        targets = torch.as_tensor(targets).to(device)
        x = _normalize(images, mean, std, compute_dtype)
        cast = tree_map(lambda p: p.to(compute_dtype), params)
        outputs, _ = model.apply_params(cast, model_state, x, training=False,
                                        upsample_outputs=False)
        logits = outputs[0]
        if logits.shape[1:3] != x.shape[1:3]:
            logits = resize_bilinear_matmul(logits, (x.shape[1], x.shape[2]), align_corners=True)
        pred = logits.argmax(dim=-1).to(torch.int32)
        stats = seg_hist_update(pred, targets, num_classes, per_sample=per_sample_stats)
        return pred.to(pred_dtype), stats

    return step
