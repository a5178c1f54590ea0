"""Weights across packages and checkpoint dialects.

The port's :class:`~fastscnn_tpu_torch.models.fast_scnn.FastSCNN` uses
exactly the reference ``state_dict`` key names, so one key map serves
three purposes:

- :func:`from_jax_params`: the JAX package's ``(params, state)`` trees
  (nested dicts of numpy arrays, HWIO) → a reference-layout state dict
  (OIHW) that ``FastSCNN.load_state_dict(strict=True)`` takes;
- :func:`to_param_trees`: a module → ``(params, state)`` trees in the JAX
  layout (HWIO tensors), which BN folding and the folded graph consume;
- :func:`load_checkpoint`: the three ``.pth`` dialects — raw,
  ``module.``-prefixed (DataParallel) and ``{'model': state_dict, ...}``.

The key map is this package's own copy of
``fastscnn_tpu/models/import_torch.py::_build_key_map``.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["from_jax_params", "to_param_trees", "load_checkpoint", "build_key_map"]


def _cbr_map(torch_prefix: str, path: tuple, conv_idx: int = 0, bn_idx: int = 1):
    """Key map for a _ConvBNReLU-style Sequential(conv, bn, relu)."""
    return [
        (f"{torch_prefix}.{conv_idx}.weight", path + ("w",), "conv"),
        (f"{torch_prefix}.{bn_idx}.weight", path + ("bn", "scale"), "vec"),
        (f"{torch_prefix}.{bn_idx}.bias", path + ("bn", "bias"), "vec"),
        (f"{torch_prefix}.{bn_idx}.running_mean", path + ("bn", "mean"), "vec:state"),
        (f"{torch_prefix}.{bn_idx}.running_var", path + ("bn", "var"), "vec:state"),
    ]


def _ds_map(torch_prefix: str, path: tuple):
    """_DSConv: Sequential(dwconv, bn, relu, pwconv, bn, relu)."""
    return _cbr_map(f"{torch_prefix}.conv", path + ("dw",), 0, 1) + _cbr_map(
        f"{torch_prefix}.conv", path + ("pw",), 3, 4
    )


def _bottleneck_map(torch_prefix: str, path: tuple):
    """LinearBottleneck.block = Sequential(_ConvBNReLU, _DWConv, conv, bn)."""
    return (
        _cbr_map(f"{torch_prefix}.block.0.conv", path + ("expand",))
        + _cbr_map(f"{torch_prefix}.block.1.conv", path + ("dw",))
        + [
            (f"{torch_prefix}.block.2.weight", path + ("project", "w"), "conv"),
            (f"{torch_prefix}.block.3.weight", path + ("project", "bn", "scale"), "vec"),
            (f"{torch_prefix}.block.3.bias", path + ("project", "bn", "bias"), "vec"),
            (f"{torch_prefix}.block.3.running_mean", path + ("project", "bn", "mean"), "vec:state"),
            (f"{torch_prefix}.block.3.running_var", path + ("project", "bn", "var"), "vec:state"),
        ]
    )


def build_key_map(aux: bool = True):
    """[(state_dict key, tree path, kind)], kind ∈ {'conv', 'vec', 'vec:state'}."""
    m: list[tuple[str, tuple, str]] = []
    m += _cbr_map("learning_to_downsample.conv.conv", ("learning_to_downsample", "conv"))
    m += _ds_map("learning_to_downsample.dsconv1", ("learning_to_downsample", "dsconv1"))
    m += _ds_map("learning_to_downsample.dsconv2", ("learning_to_downsample", "dsconv2"))
    for stage, n in enumerate((3, 3, 3), start=1):  # bottlenecks per GFE stage
        for i in range(n):
            m += _bottleneck_map(
                f"global_feature_extractor.bottleneck{stage}.{i}",
                ("global_feature_extractor", f"bottleneck{stage}", i),
            )
    for name in ("conv1", "conv2", "conv3", "conv4", "out"):
        m += _cbr_map(
            f"global_feature_extractor.ppm.{name}.conv", ("global_feature_extractor", "ppm", name)
        )
    m += _cbr_map("feature_fusion.dwconv.conv", ("feature_fusion", "dwconv"))
    for name in ("conv_lower_res", "conv_higher_res"):
        path = ("feature_fusion", name)
        m += [
            (f"feature_fusion.{name}.0.weight", path + ("w",), "conv"),
            (f"feature_fusion.{name}.0.bias", path + ("b",), "vec"),
            (f"feature_fusion.{name}.1.weight", path + ("bn", "scale"), "vec"),
            (f"feature_fusion.{name}.1.bias", path + ("bn", "bias"), "vec"),
            (f"feature_fusion.{name}.1.running_mean", path + ("bn", "mean"), "vec:state"),
            (f"feature_fusion.{name}.1.running_var", path + ("bn", "var"), "vec:state"),
        ]
    m += _ds_map("classifier.dsconv1", ("classifier", "dsconv1"))
    m += _ds_map("classifier.dsconv2", ("classifier", "dsconv2"))
    m += [
        ("classifier.conv.1.weight", ("classifier", "conv", "w"), "conv"),
        ("classifier.conv.1.bias", ("classifier", "conv", "b"), "vec"),
    ]
    if aux:
        m += [
            ("auxlayer.0.weight", ("auxlayer", "conv1", "w"), "conv"),
            ("auxlayer.1.weight", ("auxlayer", "conv1", "bn", "scale"), "vec"),
            ("auxlayer.1.bias", ("auxlayer", "conv1", "bn", "bias"), "vec"),
            ("auxlayer.1.running_mean", ("auxlayer", "conv1", "bn", "mean"), "vec:state"),
            ("auxlayer.1.running_var", ("auxlayer", "conv1", "bn", "var"), "vec:state"),
            ("auxlayer.4.weight", ("auxlayer", "conv2", "w"), "conv"),
            ("auxlayer.4.bias", ("auxlayer", "conv2", "b"), "vec"),
        ]
    return m


def _get_path(tree, path: tuple):
    for p in path:
        tree = tree[p]
    return tree


def _set_path(tree: dict, path: tuple, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _listify(tree):
    """Turn dicts keyed 0..n-1 (the bottleneck stages) into lists."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(isinstance(k, int) for k in tree):
        return [_listify(tree[i]) for i in range(len(tree))]
    return {k: _listify(v) for k, v in tree.items()}


def from_jax_params(params, state) -> dict[str, torch.Tensor]:
    """JAX ``(params, state)`` trees of numpy arrays → reference state dict.
    The leaves may also be tensors on any device (a ``TrainState``'s
    masters and statistics): the state dict holds CPU copies.

    Conv weights go HWIO → OIHW; a depthwise (3,3,1,C) weight becomes
    (C,1,3,3) by the same transpose."""
    out: dict[str, torch.Tensor] = {}
    for key, path, kind in build_key_map(aux="auxlayer" in params):
        value = _get_path(state if kind.endswith(":state") else params, path)
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        value = np.asarray(value)
        if kind == "conv":
            value = value.transpose(3, 2, 0, 1)
        out[key] = torch.from_numpy(np.array(value))  # a writable, contiguous copy
    return out


def to_param_trees(module: torch.nn.Module):
    """A FastSCNN module → ``(params, state)`` trees in the JAX layout
    (HWIO conv weights), holding the module's tensors (detached)."""
    sd = module.state_dict()
    params: dict = {}
    state: dict = {}
    for key, path, kind in build_key_map(aux=getattr(module, "aux", False)):
        value = sd[key].detach()
        if kind == "conv":
            value = value.permute(2, 3, 1, 0)
        _set_path(state if kind.endswith(":state") else params, path, value)
    return _listify(params), _listify(state)


def load_checkpoint(obj: Any) -> dict[str, torch.Tensor]:
    """A reference state dict from any of the three ``.pth`` dialects.

    ``obj`` is a path to a ``.pth`` file (loaded on the CPU with
    ``weights_only=True``) or an already loaded object: a raw state dict,
    a ``module.``-prefixed one, or ``{'model': state_dict, ...}``."""
    if isinstance(obj, (str, os.PathLike)):
        obj = torch.load(obj, map_location="cpu", weights_only=True)
    if not isinstance(obj, Mapping):
        raise TypeError(f"checkpoint must be a mapping, got {type(obj).__name__}")
    sd = dict(obj)
    if "model" in sd and isinstance(sd["model"], Mapping):
        sd = dict(sd["model"])
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
