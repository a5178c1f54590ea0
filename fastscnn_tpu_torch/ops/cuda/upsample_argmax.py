"""Bilinear-upsample + argmax mask heads: kernels B1 and B2.

Counterpart of ``fastscnn_tpu/ops/pallas/upsample_argmax.py``:

- :func:`upsample_argmax` (B1) replaces ``upsample_argmax``: the int32
  mask argmax_C(bilinear(logits)) from NHWC logits, with the
  full-resolution logits never written;
- :func:`h_lerp_argmax` (B2) replaces the Pallas H-lerp/argmax kernel of
  ``w_matmul_h_lerp_argmax``: the H pass of the W-upsampled (N, h, C, W)
  tensor, then argmax_C.

Both are bound by bytes on an H100 (the int32 mask write dominates); see
``csrc/upsample_argmax.cu`` for the design. B2 stages the source rows of a
strip of output rows in shared memory once; :func:`h_lerp_plan` picks the
column tile and the rows a strip from the shape. The kernels lerp in f32 from
bf16 or f32 inputs with the lerp tables of ``ops/resize.py`` and break
ties toward the lowest class. That differs from the TPU kernels, which
interpolate with bf16 matrices on the MXU (B1 also rounds its H pass to
bf16), and from the 'hybrid' matmul plan, which argmaxes bf16 values: the
formulations agree except in a near-tie band.

Besides the wrappers this module carries the non-kernel parts of the JAX
module that the engine's mask modes need: the W-first interp-matmul of
:func:`w_matmul_h_lerp_argmax` and its H-matmul fallback :func:`_matmul_h`
(plain ``torch.tensordot``, as the JAX package left them to XLA).

Each wrapper takes its plain PyTorch version (``*_reference``) for a CPU
tensor and launches its kernel for a CUDA tensor, raising on what the
kernel does not take; it never falls back. Each counts its launches in a
``launches`` attribute.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from fastscnn_tpu_torch.ops.cuda._build import check, library
from fastscnn_tpu_torch.ops.cuda.dw_conv import _kernel_input
from fastscnn_tpu_torch.ops.resize import (
    _axis_lerp_coeffs,
    _lerp_axis,
    interp_matrix,
    lerp_tables,
    resize_bilinear,
)

__all__ = [
    "upsample_argmax",
    "h_lerp_argmax",
    "upsample_argmax_reference",
    "h_lerp_argmax_reference",
    "w_matmul_h_lerp_argmax",
    "h_lerp_plan",
]


def upsample_argmax_reference(logits, out_size, align_corners=True):
    """Plain PyTorch version of B1: f32 two-tap lerp (H, then W), argmax."""
    up = resize_bilinear(logits.float(), out_size, align_corners=align_corners)
    return up.argmax(dim=-1).to(torch.int32)


def h_lerp_argmax_reference(xw, out_h, align_corners=True):
    """Plain PyTorch version of B2: f32 lerp of (N, h, C, W) along h, argmax over C."""
    y = _lerp_axis(xw.float(), 1, int(out_h), align_corners)
    return y.argmax(dim=2).to(torch.int32)


def upsample_argmax(logits, out_size, align_corners=True):
    """``argmax_C(bilinear_resize(logits, out_size))`` for NHWC logits,
    an (N, H_out, W_out) int32 mask (kernel B1)."""
    if logits.ndim != 4:
        raise ValueError(f"upsample_argmax needs NHWC logits, got {tuple(logits.shape)}")
    if logits.device.type == "cpu":
        return upsample_argmax_reference(logits, out_size, align_corners)
    code = _kernel_input(logits, "upsample_argmax")
    n, h, w, c = logits.shape
    out_h, out_w = int(out_size[0]), int(out_size[1])
    if min(n, h, w, c, out_h, out_w) < 1 or n > 65535 or 4 * w * c > 227 * 1024:
        raise ValueError(f"upsample_argmax: unsupported shape {tuple(logits.shape)} -> {out_size}")
    hlo, hhi, hw = lerp_tables(h, out_h, align_corners, logits.device)
    wlo, whi, ww = lerp_tables(w, out_w, align_corners, logits.device)
    out = torch.empty((n, out_h, out_w), dtype=torch.int32, device=logits.device)
    rc = library("upsample_argmax").fastscnn_upsample_argmax(
        code, logits.data_ptr(), hlo.data_ptr(), hhi.data_ptr(), hw.data_ptr(),
        wlo.data_ptr(), whi.data_ptr(), ww.data_ptr(), out.data_ptr(),
        n, h, w, c, out_h, out_w, torch.cuda.current_stream(logits.device).cuda_stream,
    )
    check(rc, "upsample_argmax")
    upsample_argmax.launches += 1
    return out


upsample_argmax.launches = 0


# -- B2's launch plan (csrc/upsample_argmax.cu, h_lerp_argmax_kernel) ---------
H_LERP_TILES = (128, 256)  # the column tiles the kernel is built for
# rows a strip the plan tries, most first: at most 32, one pass of the
# block's 8 warps x 4 rows (at 128 columns), whose staging no later pass
# would overlap
H_LERP_ROWS = (32, 16, 8, 4, 2, 1)
_H_SMEM_AIM = 48 * 1024  # a block's staged rows, so that 4 blocks share an SM
_H_SMEM_MAX = 227 * 1024  # the most shared memory a block can have on an H100
_H_MIN_BLOCKS = 2 * 132  # two blocks for each of the H100's SMs


class HLerpPlan(NamedTuple):
    """Launch plan of B2's kernel (see :func:`h_lerp_plan`)."""
    tile: int                   # columns a block
    rows: int                   # output rows a strip
    staged: int                 # the most source rows a strip stages
    smem: int                   # bytes of shared memory a block: staged · C · tile · itemsize
    grid: tuple[int, int, int]  # (column tiles, strips, N)


def h_lerp_strips(h: int, out_h: int, align_corners: bool, rows: int):
    """The strips of ``rows`` output rows, as (first row, end row, first
    source row, end source row): the source rows ``hlo[first] ..
    hhi[end - 1]`` that B2 stages for the strip (the lerp tables are
    non-decreasing, so they hold every row's two taps)."""
    lo, hi, _ = _axis_lerp_coeffs(h, out_h, align_corners)
    starts = np.arange(0, out_h, rows)
    ends = np.minimum(starts + rows, out_h)
    return [(int(y0), int(y1), int(lo[y0]), int(hi[y1 - 1]) + 1) for y0, y1 in zip(starts, ends)]


@functools.lru_cache(maxsize=256)
def h_lerp_plan(n: int, h: int, c: int, out_h: int, w: int, itemsize: int,
                align_corners: bool = True, tile: int | None = None,
                rows: int | None = None) -> HLerpPlan:
    """Launch plan of B2's kernel for (N, h, C, W) input of ``itemsize``
    bytes an element and ``out_h`` output rows: the column tile (128
    unless ``tile`` says 256), and the most rows a strip of
    :data:`H_LERP_ROWS` (or ``rows``) whose staged source rows fit 48 KB
    and whose grid holds at least two blocks for each of the H100's 132
    SMs; where none does, the most rows whose strip fits 48 KB, else 227
    KB (one row a strip stages at most two source rows). At the serving
    shape, (N, 128, 19, 2048) bf16 to 1,024 rows, that is 32 rows a strip
    staging at most 6 source rows (29 KB), 16 × 32 × N blocks
    (``chip_smoke.py --tune-mask`` times the alternatives). Raises on a
    shape it cannot take. A pure function of the shape."""
    if min(n, h, c, out_h, w, itemsize) < 1:
        raise ValueError(f"h_lerp_plan: empty shape ({n}, {h}, {c}, {w}) -> {out_h} rows")
    if n > 65535:
        raise ValueError(f"h_lerp_plan: N={n} is more than 65,535 images")
    tile = H_LERP_TILES[0] if tile is None else tile
    if tile not in H_LERP_TILES:
        raise ValueError(f"h_lerp_plan: no tile of {tile} columns")
    tiles = -(-w // tile)

    def plan(r):
        staged = max(s1 - s0 for _, _, s0, s1 in h_lerp_strips(h, out_h, align_corners, r))
        return HLerpPlan(tile, r, staged, staged * c * tile * itemsize,
                         (tiles, -(-out_h // r), n))

    if rows is not None:
        if rows < 1:
            raise ValueError(f"h_lerp_plan: {rows} rows a strip")
        chosen = plan(rows)
    else:
        cands = [plan(r) for r in H_LERP_ROWS if r == 1 or r < out_h]
        fits = [p for p in cands if p.smem <= _H_SMEM_AIM]
        full = [p for p in fits if p.grid[0] * p.grid[1] * p.grid[2] >= _H_MIN_BLOCKS]
        chosen = (full or fits or cands[-1:])[0]
    if chosen.smem > _H_SMEM_MAX:
        raise ValueError(f"h_lerp_plan: {chosen.staged} staged rows of {c} classes x {tile} "
                         f"columns need {chosen.smem} bytes of shared memory, more than "
                         f"{_H_SMEM_MAX}")
    if chosen.grid[1] > 65535:
        raise ValueError(f"h_lerp_plan: {out_h} rows need more than 65,535 strips")
    return chosen


def h_lerp_argmax(xw, out_h, align_corners=True, tile=None, rows=None):
    """H-upsample of the W-upsampled (N, h, C, W) logits to ``out_h`` rows,
    then argmax over C: an (N, out_h, W) int32 mask (kernel B2). ``tile``
    and ``rows`` override the launch plan's column tile and rows a strip
    (:func:`h_lerp_plan`)."""
    if xw.ndim != 4:
        raise ValueError(f"h_lerp_argmax needs (N, h, C, W), got {tuple(xw.shape)}")
    if xw.device.type == "cpu":
        return h_lerp_argmax_reference(xw, out_h, align_corners)
    code = _kernel_input(xw, "h_lerp_argmax")
    n, h, c, w = xw.shape
    out_h = int(out_h)
    plan = h_lerp_plan(n, h, c, out_h, w, xw.element_size(), bool(align_corners), tile, rows)
    hlo, hhi, hw = lerp_tables(h, out_h, align_corners, xw.device)
    out = torch.empty((n, out_h, w), dtype=torch.int32, device=xw.device)
    vcopy = (w * xw.element_size()) % 16 == 0 and xw.data_ptr() % 16 == 0
    vec_out = w % 4 == 0 and out.data_ptr() % 16 == 0
    rc = library("upsample_argmax").fastscnn_h_lerp_argmax(
        code, xw.data_ptr(), hlo.data_ptr(), hhi.data_ptr(), hw.data_ptr(), out.data_ptr(),
        n, h, c, out_h, w, plan.tile, plan.rows, plan.smem, int(vcopy), int(vec_out),
        torch.cuda.current_stream(xw.device).cuda_stream,
    )
    check(rc, "h_lerp_argmax")
    h_lerp_argmax.launches += 1
    return out


h_lerp_argmax.launches = 0


def _matmul_h(xw: torch.Tensor, out_h: int, align_corners: bool) -> torch.Tensor:
    """H-upsample of an (N, h, C, W) tensor via interp-matmul → (N, H, C, W)."""
    a = interp_matrix(xw.shape[1], int(out_h), align_corners, xw.dtype, xw.device)
    y = torch.tensordot(xw, a, dims=([1], [0]))
    return torch.movedim(y, -1, 1)


def w_matmul_h_lerp_argmax(
    logits, out_size, align_corners=True, use_kernel=False, out_dtype=torch.int32
):
    """The hybrid mask path: W-upsample by interp-matmul in the logits'
    dtype, laid out (N, h, C, W) so W stays minor; then the H pass and
    argmax — by the H interp-matmul and ``argmax`` of its result
    (default; JAX's ``use_pallas=False``), or by kernel B2
    (``use_kernel=True``, JAX's ``use_pallas=True``)."""
    n, h, w, c = logits.shape
    out_h, out_w = int(out_size[0]), int(out_size[1])
    a_w = interp_matrix(w, out_w, align_corners, logits.dtype, logits.device)
    xw = torch.tensordot(logits, a_w, dims=([2], [0]))  # (N, h, C, W_out)
    if use_kernel:
        return h_lerp_argmax(xw.contiguous(), out_h, align_corners).to(out_dtype)
    y = _matmul_h(xw, out_h, align_corners)
    return y.argmax(dim=2).to(out_dtype)
