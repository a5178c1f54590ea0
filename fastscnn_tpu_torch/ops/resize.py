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
- ``resize_rows``, ``resize_rows_matmul``: under the mesh's ``space`` axis
  (``ops/halo.py``), this rank's rows of ``resize_bilinear`` or
  ``resize_bilinear_matmul`` (align_corners=True) of the global tensor,
  from the window of source rows its output rows read, wherever they are
  held: the global resize's weights, so the global resize's bits. Every caller's
  resize across the cut is an align-corners one; the pyramid pooling's,
  which may not be, runs on the gathered whole map.

Every function takes the H and W axes, so NHWC, NCHW and channel-free
(N, H, W) tensors all work.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from fastscnn_tpu_torch.ops.halo import layout, window_rows

__all__ = ["resize_bilinear", "resize_bilinear_matmul", "resize_nearest", "nearest_index",
           "resize_rows", "resize_rows_matmul", "device_table_cache", "holding_tables",
           "recording_tables", "substituted_tables"]

# the lists of the active ``holding_tables`` blocks, innermost last
_HOLDERS: list[list] = []
# the dicts of the active ``recording_tables`` and ``substituted_tables`` blocks
_RECORDS: list[dict] = []
_SUBSTITUTES: list[dict] = []


def device_table_cache(build):
    """``functools.lru_cache(maxsize=64)`` for a function whose last
    argument is a device and whose result lives there (a table). The
    first call for a key builds the table, with a host→device copy; later
    calls copy nothing, so a CUDA graph can capture them. A build inside a
    capture raises: the warm-up before it should have built every table
    the capture reads. Each table returned is also appended to the list of
    every active :func:`holding_tables` block and recorded under its key
    ``(function name, args)`` in every active :func:`recording_tables`
    block; inside a :func:`substituted_tables` block whose dict has the
    key, the lookup returns that dict's value instead of the cache's.
    ``cache_info`` and ``cache_clear`` are the cache's."""

    @functools.lru_cache(maxsize=64)
    def cached(*args):
        device = torch.device(args[-1])
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{build.__name__}{args} first built inside a CUDA graph capture")
        return build(*args)

    @functools.wraps(build)
    def lookup(*args):
        key = (build.__name__, args)
        for tables in reversed(_SUBSTITUTES):
            if key in tables:
                return tables[key]
        table = cached(*args)
        for holder in _HOLDERS:
            holder.append(table)
        for record in _RECORDS:
            record[key] = table
        return table

    lookup.cache_info, lookup.cache_clear = cached.cache_info, cached.cache_clear
    return lookup


@contextlib.contextmanager
def holding_tables(holder: list):
    """Append to ``holder`` every table that a :func:`device_table_cache`
    returns inside the block. A CUDA graph captured in the block reads
    those tables' memory; the graph's owner keeps ``holder`` for as long
    as it replays, so that the caches' eviction cannot free that memory."""
    _HOLDERS.append(holder)
    try:
        yield holder
    finally:
        _HOLDERS.remove(holder)


@contextlib.contextmanager
def recording_tables(record: dict):
    """Set ``record[(function name, args)]`` to every table that a
    :func:`device_table_cache` returns inside the block (a tensor, or a
    tuple of tensors)."""
    _RECORDS.append(record)
    try:
        yield record
    finally:
        _RECORDS.remove(record)


@contextlib.contextmanager
def substituted_tables(tables: dict):
    """Inside the block a :func:`device_table_cache` lookup whose key
    (as :func:`recording_tables` records it) is in ``tables`` returns
    ``tables[key]``: an exported module passes its own buffers this way,
    so that the tables are part of its state instead of constants."""
    _SUBSTITUTES.append(tables)
    try:
        yield tables
    finally:
        _SUBSTITUTES.remove(tables)


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


@device_table_cache
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


@device_table_cache
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


def _matmul_order(shape, h_axis, w_axis, out_h, out_w) -> bool:
    """Whether contracting W first is no dearer than H first, for a tensor
    of ``shape``: the larger contraction runs on the smaller intermediate."""
    numel = math.prod(shape)
    in_h, in_w = shape[h_axis], shape[w_axis]
    rest = numel // in_h // in_w
    cost_h_first = numel // in_h * out_h * in_h + rest * out_h * out_w * in_w
    cost_w_first = numel // in_w * out_w * in_w + rest * out_w * out_h * in_h
    return cost_w_first <= cost_h_first


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
    at near-ties. The cheaper contraction order is taken first."""
    out_h, out_w = int(size[0]), int(size[1])
    if _matmul_order(x.shape, h_axis, w_axis, out_h, out_w):
        x = _matmul_axis(x, w_axis, out_w, align_corners)
        return _matmul_axis(x, h_axis, out_h, align_corners)
    x = _matmul_axis(x, h_axis, out_h, align_corners)
    return _matmul_axis(x, w_axis, out_w, align_corners)


@functools.lru_cache(maxsize=None)
def _row_windows(rows_in: tuple, rows_out: tuple) -> tuple:
    """For each rank, the window of input rows that its output rows of a
    global align-corners H resize from the level of ``rows_in`` to that of
    ``rows_out`` read (``halo.window_rows``; an empty one at its block's
    start for a rank with no output row)."""
    lo, hi, _ = _axis_lerp_coeffs(rows_in[-1][1], rows_out[-1][1], True)
    return tuple((int(lo[c:d].min()), int(hi[c:d].max()) + 1) if d > c else (a, a)
                 for (a, _), (c, d) in zip(rows_in, rows_out))


@device_table_cache
def row_lerp_tables(rows_in: tuple, rows_out: tuple, s: int, device: torch.device):
    """Rank ``s``'s rows of :func:`lerp_tables` (align_corners=True) of the
    resize from the level of ``rows_in`` to that of ``rows_out``: (lo, hi)
    as indices into its window (:func:`_row_windows`) and the weights, the
    global resize's own."""
    lo, hi, w = _axis_lerp_coeffs(rows_in[-1][1], rows_out[-1][1], True)
    c, d = rows_out[s]
    base = _row_windows(rows_in, rows_out)[s][0]
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(np.ascontiguousarray(v)).to(device) for v in (
            (lo[c:d] - base).astype(np.int64), (hi[c:d] - base).astype(np.int64), w[c:d]))


@device_table_cache
def row_interp_matrix(rows_in: tuple, rows_out: tuple, s: int, dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    """Rank ``s``'s part of :func:`interp_matrix` (align_corners=True) of the
    resize from the level of ``rows_in`` to that of ``rows_out``: the rows
    of its window by its output rows."""
    a = _interp_matrix(rows_in[-1][1], rows_out[-1][1], True)
    (c, d), (w0, w1) = rows_out[s], _row_windows(rows_in, rows_out)[s]
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(a[w0:w1, c:d])).to(device=device,
                                                                         dtype=dtype)


def _row_levels(x: torch.Tensor, size, space, out) -> tuple:
    """The rows of the input's and the output's levels of a row resize:
    ``space``'s and ``out``'s."""
    rows_out = None if out is None else out.rows
    if rows_out is None:
        raise ValueError("a row resize under space needs the rows of its output's level")
    c, d = rows_out[space.index]
    if d - c != int(size[0]):
        raise ValueError(f"a block of {size[0]} output rows where the level's is {d - c}")
    return layout(x, space), rows_out


def resize_rows(x: torch.Tensor, size, space=None, out=None) -> torch.Tensor:
    """``resize_bilinear(x, size)`` (align_corners=True, NHWC or (N, H, W)).
    Under ``space`` (``ops/halo.py``), ``x`` is this rank's block of rows of
    ``space``'s level, ``out`` the Space of the output's level and
    ``size`` its block's output size: this rank's
    output rows of the global resize, from the window of source rows they
    read, with the global resize's weights in its order (the same bits)."""
    if space is None:
        return resize_bilinear(x, size, align_corners=True)
    rows_in, rows_out = _row_levels(x, size, space, out)
    if rows_in != rows_out:
        ext = window_rows(x, _row_windows(rows_in, rows_out), space)
        lo, hi, w = row_lerp_tables(rows_in, rows_out, space.index, x.device)
        shape = [1] * x.ndim
        shape[1] = int(size[0])
        w = w.to(ext.dtype).reshape(shape)
        x_lo = ext.index_select(1, lo)
        x = x_lo + (ext.index_select(1, hi) - x_lo) * w
    return _lerp_axis(x, 2, int(size[1]), True)


def resize_rows_matmul(x: torch.Tensor, size, space=None, out=None) -> torch.Tensor:
    """``resize_bilinear_matmul(x, size)`` (align_corners=True). Under
    ``space``, as :func:`resize_rows`: this rank's output rows of the
    global resize, its weights contracted in the order that the global
    shapes choose (which decides where a bf16 result rounds)."""
    if space is None:
        return resize_bilinear_matmul(x, size, align_corners=True)
    rows_in, rows_out = _row_levels(x, size, space, out)
    in_h, out_h, out_w = rows_in[-1][1], rows_out[-1][1], int(size[1])

    def rows(y):
        if rows_in == rows_out:
            return y
        ext = window_rows(y, _row_windows(rows_in, rows_out), space)
        a = row_interp_matrix(rows_in, rows_out, space.index, ext.dtype, ext.device)
        return torch.movedim(torch.tensordot(ext, a, dims=([1], [0])), -1, 1)

    if _matmul_order((x.shape[0], in_h, *x.shape[2:]), 1, 2, out_h, out_w):
        return rows(_matmul_axis(x, 2, out_w, True))
    return _matmul_axis(rows(x), 2, out_w, True)


@functools.lru_cache(maxsize=None)
def _axis_nearest_index(in_size: int, out_size: int):
    # PyTorch 'nearest' (legacy, what cv2.resize INTER_NEAREST uses):
    # src = floor(i * in/out).
    src = np.floor(np.arange(out_size, dtype=np.float64) * in_size / out_size)
    return np.clip(src.astype(np.int64), 0, in_size - 1)


@device_table_cache
def nearest_index(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """``_axis_nearest_index`` as an int64 tensor on ``device``, cached
    (made outside inference mode, as :func:`lerp_tables`): a call after
    the first copies nothing from the host, so a CUDA graph can capture
    :func:`resize_nearest`."""
    with torch.inference_mode(False):
        return torch.from_numpy(_axis_nearest_index(in_size, out_size)).to(device)


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
            x = x.index_select(axis, nearest_index(x.shape[axis], out, x.device))
    return x
