"""Pooling with PyTorch's bin math, NHWC by default.

Counterpart of ``fastscnn_tpu/ops/pool.py``:

- :func:`adaptive_avg_pool`: output cell ``i`` averages the bin
  ``[floor(i*In/Out), ceil((i+1)*In/Out))``, which for ``In`` not
  divisible by ``Out`` differs from any fixed-stride pool. Output sizes on
  the model's path are tiny (the pyramid pooling's 1/2/3/6), so the bins
  unroll in Python.
- :func:`avg_pool` and :func:`max_pool`: fixed square windows with a
  stride (the window by default) and a symmetric padding, as the JAX
  package's ``lax.reduce_window`` defines them: the average divides every
  window's sum by ``window²``, the zero padding counted; the maximum pads
  with −inf.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["adaptive_avg_pool", "avg_pool", "max_pool"]


def _adaptive_bins(in_size: int, out_size: int):
    return [
        ((i * in_size) // out_size, -((-(i + 1) * in_size) // out_size))
        for i in range(out_size)
    ]


def _adaptive_pool_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    pieces = [
        x.narrow(axis, start, stop - start).mean(dim=axis, keepdim=True)
        for start, stop in _adaptive_bins(in_size, out_size)
    ]
    return torch.cat(pieces, dim=axis)


def adaptive_avg_pool(x: torch.Tensor, output_size, h_axis: int = 1, w_axis: int = 2) -> torch.Tensor:
    """``AdaptiveAvgPool2d(output_size)``; H and W bins are independent,
    so the pool is separable: H, then W."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    out_h, out_w = output_size
    x = _adaptive_pool_axis(x, h_axis, int(out_h))
    return _adaptive_pool_axis(x, w_axis, int(out_w))


def _fixed_pool(pool, x: torch.Tensor, window: int, stride, padding: int, fill: float):
    """``pool`` (``F.avg_pool2d`` or ``F.max_pool2d``) over NHWC ``x`` after
    an explicit pad with ``fill``: the padding is any size, as in
    ``lax.reduce_window``, and is never PyTorch's implicit one."""
    stride = window if stride is None else stride
    y = x.permute(0, 3, 1, 2)
    if padding:
        y = F.pad(y, (padding, padding, padding, padding), value=fill)
    return pool(y, window, stride).permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, window: int, stride: int | None = None,
             padding: int = 0) -> torch.Tensor:
    """Fixed ``AvgPool2d`` (NHWC): every window's sum over ``window²``, the
    zero padding counted (``count_include_pad=True``). The ONNX-compatible
    pyramid pooling of the reference's deploy graph uses windows 32/16/8/4
    (reference:export_onnx_fixed.py:106-118)."""
    return _fixed_pool(F.avg_pool2d, x, window, stride, padding, 0.0)


def max_pool(x: torch.Tensor, window: int, stride: int | None = None,
             padding: int = 0) -> torch.Tensor:
    """Fixed ``MaxPool2d`` (NHWC), the padding −inf."""
    return _fixed_pool(F.max_pool2d, x, window, stride, padding, float("-inf"))
