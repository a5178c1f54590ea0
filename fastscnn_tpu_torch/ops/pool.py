"""Adaptive average pooling with PyTorch's bin math, NHWC by default.

Counterpart of ``fastscnn_tpu/ops/pool.py::adaptive_avg_pool``: output
cell ``i`` averages the bin ``[floor(i*In/Out), ceil((i+1)*In/Out))``,
which for ``In`` not divisible by ``Out`` differs from any fixed-stride
pool. Output sizes on the model's path are tiny (the pyramid pooling's
1/2/3/6), so the bins unroll in Python.
"""

from __future__ import annotations

import torch

__all__ = ["adaptive_avg_pool"]


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
