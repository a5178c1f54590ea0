"""Bilinear / nearest resizing with exact PyTorch sampling semantics.

Counterpart of ``fastscnn_tpu/ops/resize.py``; the functions that make
the lerp coefficients are this package's own copies of that module's
numpy code, so both packages sample the same source pixels with the
same weights.

- ``resize_bilinear``: separable two-tap lerp, ``lo + (hi - lo) * w``
  per axis, H then W. Matches ``F.interpolate(mode='bilinear')`` in f32
  for both ``align_corners`` conventions.
- ``resize_bilinear_matmul``: the same weights as one dense
  interpolation matrix per axis, contracted with ``torch.tensordot``;
  the cheaper contraction order is chosen from the shapes, which also
  decides where a bf16 result rounds.
- ``resize_nearest``: the legacy ``floor(i * in / out)`` rule.

Every function takes the H and W axes, so NHWC, NCHW and channel-free
(N, H, W) tensors all work.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["resize_bilinear", "resize_bilinear_matmul", "resize_nearest"]


@functools.lru_cache(maxsize=None)
def _axis_lerp_coeffs(in_size: int, out_size: int, align_corners: bool):
    """Source indices (lo, hi) and hi-weights for 1-D linear resampling.

    align_corners=True:  src = i * (in-1) / (out-1)          (PyTorch)
    align_corners=False: src = (i + 0.5) * in/out - 0.5, clamped at 0
    """
    if out_size == 1:
        if align_corners:
            src = np.zeros(1, dtype=np.float64)
        else:
            src = np.asarray([0.5 * in_size / out_size - 0.5], dtype=np.float64)
    elif align_corners:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    else:
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * in_size / out_size - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int32)
    lo = np.clip(lo, 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1).astype(np.int32)
    w = (src - lo).astype(np.float32)
    return lo, hi, w


@functools.lru_cache(maxsize=64)
def lerp_tables(in_size: int, out_size: int, align_corners: bool, device: torch.device):
    """``_axis_lerp_coeffs`` as tensors on ``device``: (lo int64, hi
    int64, w f32). Cached per device so the serving path uploads them
    once; made outside inference mode, so that a table first built by the
    serving path can still enter autograd in a train step."""
    lo, hi, w = _axis_lerp_coeffs(in_size, out_size, align_corners)
    with torch.inference_mode(False):
        return (
            torch.from_numpy(lo.astype(np.int64)).to(device),
            torch.from_numpy(hi.astype(np.int64)).to(device),
            torch.from_numpy(w).to(device),
        )


def _lerp_axis(x: torch.Tensor, axis: int, out_size: int, align_corners: bool):
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    lo, hi, w = lerp_tables(in_size, out_size, align_corners, x.device)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w = w.to(x.dtype).reshape(shape)
    x_lo = x.index_select(axis, lo)
    x_hi = x.index_select(axis, hi)
    return x_lo + (x_hi - x_lo) * w


def resize_bilinear(
    x: torch.Tensor,
    size: tuple[int, int],
    align_corners: bool = True,
    h_axis: int = 1,
    w_axis: int = 2,
) -> torch.Tensor:
    """Bilinear resize to ``size=(H, W)`` along the given axes, H first."""
    out_h, out_w = size
    x = _lerp_axis(x, h_axis, int(out_h), align_corners)
    return _lerp_axis(x, w_axis, int(out_w), align_corners)


@functools.lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool):
    """Dense (in_size, out_size) 1-D interpolation matrix with exactly the
    same two-tap weights as ``_axis_lerp_coeffs`` (two nonzeros per
    column; a clamped edge collapses to a single 1.0)."""
    lo, hi, w = _axis_lerp_coeffs(in_size, out_size, align_corners)
    a = np.zeros((in_size, out_size), np.float32)
    cols = np.arange(out_size)
    np.add.at(a, (lo, cols), 1.0 - w)
    np.add.at(a, (hi, cols), w)
    return a


@functools.lru_cache(maxsize=64)
def interp_matrix(
    in_size: int, out_size: int, align_corners: bool, dtype: torch.dtype, device: torch.device
) -> torch.Tensor:
    """``_interp_matrix`` as a (in, out) tensor, cached per dtype and device
    (made outside inference mode, as :func:`lerp_tables`)."""
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_matrix(in_size, out_size, align_corners)).to(
            device=device, dtype=dtype
        )


def _matmul_axis(x: torch.Tensor, axis: int, out_size: int, align_corners: bool):
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    a = interp_matrix(in_size, int(out_size), align_corners, x.dtype, x.device)
    y = torch.tensordot(x, a, dims=([axis], [0]))
    return torch.movedim(y, -1, axis)


def resize_bilinear_matmul(
    x: torch.Tensor,
    size: tuple[int, int],
    align_corners: bool = True,
    h_axis: int = 1,
    w_axis: int = 2,
) -> torch.Tensor:
    """Bilinear resize as dense interpolation-matrix contractions.

    Same sampling weights as :func:`resize_bilinear`; numerics differ only
    in summation order (``lo*(1-w) + hi*w``), so argmax masks can flip only
    at near-ties."""
    out_h, out_w = int(size[0]), int(size[1])
    numel = x.numel()
    n_other_h = numel // x.shape[h_axis]
    n_other_w = numel // x.shape[w_axis]
    rest = numel // x.shape[h_axis] // x.shape[w_axis]
    # Contract the axis whose expansion is cheaper first, so the larger
    # contraction runs on the smaller intermediate.
    cost_h_first = n_other_h * out_h * x.shape[h_axis] + rest * out_h * out_w * x.shape[w_axis]
    cost_w_first = n_other_w * out_w * x.shape[w_axis] + rest * out_w * out_h * x.shape[h_axis]
    if cost_w_first <= cost_h_first:
        x = _matmul_axis(x, w_axis, out_w, align_corners)
        return _matmul_axis(x, h_axis, out_h, align_corners)
    x = _matmul_axis(x, h_axis, out_h, align_corners)
    return _matmul_axis(x, w_axis, out_w, align_corners)


@functools.lru_cache(maxsize=None)
def _axis_nearest_index(in_size: int, out_size: int):
    # PyTorch 'nearest' (legacy, what cv2.resize INTER_NEAREST uses):
    # src = floor(i * in/out).
    src = np.floor(np.arange(out_size, dtype=np.float64) * in_size / out_size)
    return np.clip(src.astype(np.int64), 0, in_size - 1)


def resize_nearest(
    x: torch.Tensor,
    size: tuple[int, int],
    h_axis: int = 1,
    w_axis: int = 2,
) -> torch.Tensor:
    """Nearest-neighbour resize (PyTorch legacy / OpenCV convention)."""
    out_h, out_w = size
    for axis, out in ((h_axis, int(out_h)), (w_axis, int(out_w))):
        if x.shape[axis] != out:
            idx = torch.from_numpy(_axis_nearest_index(x.shape[axis], out)).to(x.device)
            x = x.index_select(axis, idx)
    return x
