"""Checkpoints: reference-dialect ``.pth`` weights and the full train state.

Counterpart of ``fastscnn_tpu/utils/checkpoint.py``:

1. ``fast_scnn_<dataset>.pth`` (and a ``*_best_model.pth`` copy): the
   reference's raw state dict, so reference tooling, the JAX package and
   this one read each other's weights. :func:`load_pth_checkpoint` does the
   JAX loader's shape-filtered partial load (transfer learning across
   class counts), also of the ``.pth.npz`` the JAX package writes where
   torch is missing (the same state dict as numpy arrays).
2. ``train_state_<dataset>.pt``: the full state for a resume — f32
   masters, BN statistics, the optimizer's ``state_dict`` and the step —
   as ``torch.save`` of tensors and numbers, loadable with
   ``weights_only=True``. Its name differs from the JAX trainer's
   ``train_state_<dataset>.npz``, so a run that auto-resumes in a folder
   the JAX trainer also wrote never takes that file for its own.

:func:`load_train_state` also reads the JAX trainer's ``.npz``: the
leaves ``leaf_0 …`` of ``TrainState(params, model_state, opt_state,
step)`` in JAX's tree order (dict keys sorted, :func:`tree_leaves`), with
optax's states as the JAX package builds them — SGD ``(EmptyState,
(TraceState(trace), ScaleByScheduleState(count)))``, AdamW
``(ScaleByAdamState(count, mu, nu), EmptyState,
ScaleByScheduleState(count))``. ``trace`` becomes torch SGD's
``momentum_buffer``, ``mu``/``nu``/``count`` AdamW's
``exp_avg``/``exp_avg_sq``/``step``. The JAX Orbax backend has no
counterpart (it cannot be read without its package).
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from fastscnn_tpu_torch.models.convert import (
    build_key_map,
    from_jax_params,
    load_checkpoint,
    to_param_trees,
)
from fastscnn_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = [
    "save_pth_checkpoint",
    "load_pth_checkpoint",
    "save_train_state",
    "load_train_state",
]


def _node(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def save_pth_checkpoint(params, state, directory, dataset="citys", is_best=False, aux=None):
    """Write ``params``/``state`` trees (tensors or arrays) as
    ``<directory>/fast_scnn_<dataset>.pth`` in the reference dialect, and
    copy it to ``fast_scnn_<dataset>_best_model.pth`` when ``is_best``.
    ``aux=False`` leaves the aux head out. Returns the path."""
    os.makedirs(directory, exist_ok=True)
    if aux is False and "auxlayer" in params:
        params = {k: v for k, v in params.items() if k != "auxlayer"}
        state = {k: v for k, v in state.items() if k != "auxlayer"}
    filename = os.path.join(directory, f"fast_scnn_{dataset}.pth")
    torch.save(from_jax_params(params, state), filename)
    if is_best:
        shutil.copyfile(filename, os.path.join(directory, f"fast_scnn_{dataset}_best_model.pth"))
    return filename


def load_pth_checkpoint(path, num_classes, aux=None, allow_shape_mismatch=False):
    """A ``.pth`` in any of the three dialects, or a ``.npz`` of the same
    state dict → ``(params, state)`` trees of f32 CPU tensors (HWIO),
    shaped as a fresh ``num_classes``-class model's. ``aux=None`` follows
    the checkpoint. Leaves the checkpoint lacks (the aux head, or with
    ``allow_shape_mismatch`` those of another shape, such as the
    classifier of another class count) keep the values of a model
    initialised from seed 0; otherwise a mismatch raises."""
    if str(path).endswith(".npz"):
        with np.load(path, allow_pickle=False) as npz:
            sd = {k: torch.from_numpy(np.array(npz[k])) for k in npz.files}
    else:
        sd = load_checkpoint(path)
    has_aux = any(k.startswith("auxlayer.") for k in sd)
    if aux is None:
        aux = has_aux
    from fastscnn_tpu_torch.models.fast_scnn import init_fast_scnn

    model = init_fast_scnn(num_classes, aux=aux, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    params, state = (tree_map(torch.clone, t) for t in to_param_trees(model))
    missing = []
    for key, path_, kind in build_key_map(aux=aux and has_aux):
        if key not in sd:
            missing.append(key)
            continue
        value = sd[key].detach().to("cpu", torch.float32)
        if kind == "conv":
            value = value.permute(2, 3, 1, 0)
        target = state if kind.endswith(":state") else params
        node = _node(target, path_[:-1])
        current = node[path_[-1]]
        if tuple(current.shape) != tuple(value.shape):
            if allow_shape_mismatch:
                continue
            raise ValueError(
                f"shape mismatch for {key}: checkpoint {tuple(value.shape)} vs model "
                f"{tuple(current.shape)} (pass allow_shape_mismatch=True for a partial load)")
        node[path_[-1]] = value.contiguous()
    hard_missing = [k for k in missing if not k.startswith("auxlayer.")]
    if hard_missing and not allow_shape_mismatch:
        raise KeyError(f"checkpoint is missing {len(hard_missing)} keys, e.g. {hard_missing[:5]}")
    return params, state


def save_train_state(train_state, path):
    """Write a :class:`~fastscnn_tpu_torch.parallel.train.TrainState` (masters,
    BN statistics, optimizer state, step) to ``path`` with ``torch.save``.
    Returns the path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({
        "params": tree_map(lambda t: t.detach().cpu(), train_state.params),
        "model_state": tree_map(lambda t: t.detach().cpu(), train_state.model_state),
        "opt_state": train_state.opt_state.state_dict(),
        "step": int(train_state.step),
    }, path)
    return path


def load_train_state(path, template_state):
    """Restore ``path`` — the port's ``.pt`` or the JAX trainer's ``.npz`` —
    into ``template_state`` (same model and optimizer): the masters and BN
    statistics are copied into its tensors, on their device, the
    optimizer's state is loaded, and the step set. Returns the state."""
    if str(path).endswith(".npz"):
        return _load_jax_train_state(path, template_state)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    for name in ("params", "model_state"):
        dst, src = tree_leaves(getattr(template_state, name)), tree_leaves(saved[name])
        if len(dst) != len(src):
            raise ValueError(f"{path}: {len(src)} {name} leaves, the model has {len(dst)}")
        _copy_leaves(dst, src, path, name)
    template_state.opt_state.load_state_dict(saved["opt_state"])
    template_state.step = int(saved["step"])
    return template_state


def _check_shapes(dst, src, path, name):
    for i, (d, s) in enumerate(zip(dst, src)):
        if tuple(d.shape) != tuple(s.shape):
            raise ValueError(f"{path}: shape mismatch restoring train state, {name} leaf {i}: "
                             f"{tuple(s.shape)} in the file vs {tuple(d.shape)}")


def _copy_leaves(dst, src, path, name):
    _check_shapes(dst, src, path, name)
    with torch.no_grad():
        for d, s in zip(dst, src):
            d.copy_(torch.as_tensor(s))


def _load_jax_train_state(path, template_state):
    """The JAX trainer's ``train_state_<dataset>.npz`` (module docstring)."""
    params = tree_leaves(template_state.params)
    model_state = tree_leaves(template_state.model_state)
    opt = template_state.opt_state
    n_p = len(params)
    if isinstance(opt, torch.optim.AdamW):
        # ScaleByAdamState(count, mu, nu), EmptyState, ScaleByScheduleState(count)
        slots = [("count", 1), ("exp_avg", n_p), ("exp_avg_sq", n_p)]
    elif isinstance(opt, torch.optim.SGD):
        # EmptyState, (TraceState(trace), ScaleByScheduleState(count))
        slots = [("momentum_buffer", n_p)]
    else:
        raise TypeError(f"no JAX optimizer state maps to {type(opt).__name__}")
    layout = ([("params", n_p), ("model_state", len(model_state))] + slots
              + [("schedule", 1), ("step", 1)])
    with np.load(path, allow_pickle=False) as npz:
        count = sum(1 for k in npz.files if k.startswith("leaf_"))
        if count != sum(n for _, n in layout):
            raise ValueError(f"{path}: {count} leaves, but a {type(opt).__name__} train state of "
                             f"this model has {sum(n for _, n in layout)}")
        leaves, pos = {}, 0
        for name, n in layout:
            leaves[name] = [np.asarray(npz[f"leaf_{pos + i}"]) for i in range(n)]
            pos += n
    slots = [k for k, _ in slots if k != "count"]
    # every shape first, so that a mismatch leaves the template as it was
    for name, dst in [("params", params), ("model_state", model_state)] + [
            (k, params) for k in slots]:
        _check_shapes(dst, leaves[name], path, name)
    for name, dst in (("params", params), ("model_state", model_state)):
        _copy_leaves(dst, leaves[name], path, name)
    sd = opt.state_dict()
    state = {}
    for i in range(n_p):
        entry = {k: torch.from_numpy(np.array(leaves[k][i], np.float32)) for k in slots}
        if "count" in leaves:
            entry["step"] = torch.tensor(float(leaves["count"][0]), dtype=torch.float32)
        state[i] = entry
    sd["state"] = state
    opt.load_state_dict(sd)
    template_state.step = int(leaves["step"][0])
    return template_state
