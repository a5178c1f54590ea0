"""Bilinear-upsample + argmax mask heads: kernels B1 and B2.

Counterpart of ``fastscnn_tpu/ops/pallas/upsample_argmax.py``:

- :func:`upsample_argmax` (B1) replaces ``upsample_argmax``: the int32
  mask argmax_C(bilinear(logits)) from NHWC logits, with the
  full-resolution logits never written;
- :func:`h_lerp_argmax` (B2) replaces the Pallas H-lerp/argmax kernel of
  ``w_matmul_h_lerp_argmax``: the H pass of the W-upsampled (N, h, C, W)
  tensor, then argmax_C.

Both are bound by instruction issue on an H100, not by bytes: a pixel and
class cost at least a multiply, an add and the argmax's compare and two
selects, each rounded on its own, about 200 M instructions a 1024x2048
frame at 19 classes, against 9-18 MB moved; see ``csrc/upsample_argmax.cu``
for the designs, which keep every other instruction out of the class
loop. B1 stages the two source rows of a run of output rows for a tile of
output columns in shared memory once and shares each H-lerp and
W-difference across the pixels that use them; :func:`upsample_plan` picks
its column tiles (lane runs of one source pair,
:func:`upsample_column_tiles`) and row runs (:func:`upsample_row_runs`).
B2 stages the source rows of a strip of output rows in shared memory once;
:func:`h_lerp_plan` picks the column tile and the rows a strip from the
shape. The kernels lerp in f32 from bf16 or f32 inputs with the lerp
tables of ``ops/resize.py`` and break ties toward the lowest class. That differs from the TPU kernels, which
interpolate with bf16 matrices on the MXU (B1 also rounds its H pass to
bf16), and from the 'hybrid' matmul plan, which argmaxes bf16 values: the
formulations agree except in a near-tie band.

Besides the wrappers this module carries the non-kernel parts of the JAX
module that the engine's mask modes need: the W-first interp-matmul of
:func:`w_matmul_h_lerp_argmax` and its H-matmul fallback :func:`_matmul_h`
(plain ``torch.tensordot``, as the JAX package left them to XLA), the
``'nbr-exact'`` mask :func:`neighborhood_agreement_mask`, and
:func:`packed_argmax`, a formulation of ``argmax`` that the JAX package
measured and rejected and keeps tested; nothing on the serving path uses it.

Each wrapper calls its operator ``fastscnn::<name>`` (:mod:`.library`),
whose CPU implementation is the plain PyTorch version (``*_reference``)
and whose CUDA implementation launches the kernel, raising on what the
kernel does not take; it never falls back. The kernel's launches count in
the wrapper's ``launches`` attribute. The plan and the tables a launch
reads (:func:`_launch_inputs`, :func:`lerp_tables`) are looked up inside
the CUDA implementation, so a traced program holds the operator alone.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from fastscnn_tpu_torch.ops.cuda._build import check, launch
from fastscnn_tpu_torch.ops.cuda.dw_conv import _kernel_input
from fastscnn_tpu_torch.ops.resize import (
    _axis_lerp_coeffs,
    _lerp_axis,
    interp_matrix,
    lerp_tables,
    resize_bilinear,
)

_OPS = torch.ops.fastscnn  # the operators of .library, registered when the package loads

__all__ = [
    "neighborhood_agreement_mask",
    "packed_argmax",
    "upsample_argmax",
    "h_lerp_argmax",
    "upsample_argmax_reference",
    "h_lerp_argmax_reference",
    "w_matmul_h_lerp_argmax",
    "h_lerp_plan",
    "upsample_plan",
    "upsample_column_tiles",
    "upsample_row_runs",
]


def upsample_argmax_reference(logits, out_size, align_corners=True):
    """Plain PyTorch version of B1: f32 two-tap lerp (H, then W), argmax."""
    up = resize_bilinear(logits.float(), out_size, align_corners=align_corners)
    return up.argmax(dim=-1).to(torch.int32)


def h_lerp_argmax_reference(xw, out_h, align_corners=True):
    """Plain PyTorch version of B2: f32 lerp of (N, h, C, W) along h, argmax over C."""
    y = _lerp_axis(xw.float(), 1, int(out_h), align_corners)
    return y.argmax(dim=2).to(torch.int32)


def upsample_argmax(logits, out_size, align_corners=True, tile=None, rows=None):
    """``argmax_C(bilinear_resize(logits, out_size))`` for NHWC logits,
    an (N, H_out, W_out) int32 mask (kernel B1, the operator
    ``fastscnn::upsample_argmax``). ``tile`` and ``rows`` override the
    launch plan's column tile and rows a run (:func:`upsample_plan`).
    Where an axis keeps its size, the plain version copies it and the
    kernel lerps with weight 0: the same values for finite logits."""
    return _OPS.upsample_argmax.default(logits, [int(out_size[0]), int(out_size[1])],
                                        align_corners, tile, rows)


def _check_logits(logits):
    if logits.ndim != 4:
        raise ValueError(f"upsample_argmax needs NHWC logits, got {tuple(logits.shape)}")


def _upsample_argmax_cpu(logits, out_size, align_corners, tile, rows):
    _check_logits(logits)
    return upsample_argmax_reference(logits, out_size, align_corners)


def _upsample_argmax_fake(logits, out_size, align_corners, tile, rows):
    _check_logits(logits)
    return logits.new_empty((logits.shape[0], out_size[0], out_size[1]), dtype=torch.int32)


def _upsample_argmax_cuda(logits, out_size, align_corners, tile, rows):
    _check_logits(logits)
    code = _kernel_input(logits, "upsample_argmax")
    n, h, w, c = logits.shape
    out_h, out_w = out_size
    size = logits.element_size()
    plan, hw, ww, table = _launch_inputs(n, h, w, c, out_h, out_w, size, align_corners, tile, rows,
                                         logits.device)
    out = torch.empty((n, out_h, out_w), dtype=torch.int32, device=logits.device)
    vcopy = (w * c * size) % 16 == 0 and logits.data_ptr() % 16 == 0
    vec_out = out_w % 4 == 0 and out.data_ptr() % 16 == 0
    rc = launch("upsample_argmax", "fastscnn_upsample_argmax", logits.device,
        code, logits.data_ptr(), hw.data_ptr(), ww.data_ptr(), table.data_ptr(), out.data_ptr(),
        n, h, w, c, out_h, out_w, plan.tile, plan.rows, plan.smem, plan.grid[0], plan.runs,
        plan.grid[1], int(vcopy), int(vec_out),
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


# -- B1's launch plan (csrc/upsample_argmax.cu, upsample_argmax_kernel) -------
# the most output columns a tile: 32 lanes, each a run of at most 8 or 4
# columns that share one source pair (the kernel's template parameter)
UPSAMPLE_TILES = (256, 128)
UPSAMPLE_ROWS = (4, 3, 2, 1)  # the most output rows a row run, the plan's first


class UpsamplePlan(NamedTuple):
    """Launch plan of B1's kernel (see :func:`upsample_plan`)."""
    tile: int                   # most output columns a tile: 32 runs of tile // 32
    rows: int                   # most output rows a row run
    staged_cols: int            # the most source columns a tile stages
    runs: int                   # column runs over all tiles
    align: int                  # a tile's staging starts at a multiple of this column
    smem: int                   # bytes of shared memory a block
    grid: tuple[int, int, int]  # (column tiles, row runs, N): the tasks, one block each


def _runs(lo, start: int, end: int, per: int):
    """(first, count) of the runs of ``start .. end - 1``: at most ``per``
    consecutive indices of equal ``lo``, so one source pair."""
    out, i = [], start
    while i < end:
        e = i + 1
        while e < end and e - i < per and lo[e] == lo[i]:
            e += 1
        out.append((i, e - i))
        i = e
    return out


@functools.lru_cache(maxsize=64)
def upsample_row_runs(h: int, out_h: int, align_corners: bool, rows: int):
    """B1's row runs for ``h`` source rows upsampled to ``out_h``: (first
    row, count) of each run of at most ``rows`` output rows that share one
    source row pair (the same ``hlo``). A block takes one run, so it stages
    two source rows and forms their H differences once for all of its
    rows. A pure function of its arguments."""
    return tuple(_runs(_axis_lerp_coeffs(h, out_h, align_corners)[0], 0, out_h, rows))


@functools.lru_cache(maxsize=64)
def upsample_column_tiles(w: int, out_w: int, align_corners: bool, tile: int):
    """B1's column tiles for ``w`` source columns upsampled to ``out_w``:
    ``(tiles, runs, starts)``. Each lane of a tile takes a run, at most
    ``tile // 32`` consecutive output columns that share one source pair
    (the same ``wlo``), so that it forms each H-lerp and W-difference once
    for all of them. A tile is the next 32 runs, ended at a multiple of 4
    columns (cutting its last run) unless it ends the row, so that every
    tile starts on a 16-byte boundary of the mask row. ``tiles[t]`` is
    tile t's (first, end) column, ``runs`` every run's (first column,
    count) tile by tile, and ``starts[t] .. starts[t + 1]`` tile t's runs.
    A pure function of its arguments."""
    lo = _axis_lerp_coeffs(w, out_w, align_corners)[0]
    tiles, runs, starts = [], [], [0]
    x0 = 0
    while x0 < out_w:
        cut = _runs(lo, x0, out_w, tile // 32)[:32]
        x = cut[-1][0] + cut[-1][1]
        x1 = x if x == out_w else x - x % 4  # 32 runs hold >= 32 columns: x1 > x0
        runs.extend((s, min(k, x1 - s)) for s, k in cut if s < x1)
        tiles.append((x0, x1))
        starts.append(len(runs))
        x0 = x1
    return tuple(tiles), tuple(runs), tuple(starts)


@functools.lru_cache(maxsize=64)
def _run_table(h: int, w: int, out_h: int, out_w: int, align_corners: bool, tile: int,
               rows: int, align: int, device: torch.device):
    """The column tiles and runs and the row runs as the kernel reads them
    (``csrc/upsample_argmax.cu``, ``RunTable``), one int32 tensor: the
    tiles' bounds (T + 1), first column runs (T + 1), first and last staged
    source columns (T each, the first a multiple of ``align``); the column
    runs' first columns, counts, source columns from the tile's first
    staged one, and ``whi - wlo`` (R each); the row runs' first rows,
    counts, ``hlo`` and ``hhi`` (Y each). Cached per device, as the lerp
    tables."""
    wlo, whi, _ = _axis_lerp_coeffs(w, out_w, align_corners)
    hlo, hhi, _ = _axis_lerp_coeffs(h, out_h, align_corners)
    tiles, runs, starts = upsample_column_tiles(w, out_w, align_corners, tile)
    j0 = [int(wlo[x0]) // align * align for x0, _ in tiles]
    run_j0 = [j0[t] for t in range(len(tiles)) for _ in range(starts[t], starts[t + 1])]
    row_runs = upsample_row_runs(h, out_h, align_corners, rows)
    table = ([x0 for x0, _ in tiles] + [out_w] + list(starts) + j0
             + [int(whi[x1 - 1]) for _, x1 in tiles]
             + [s for s, _ in runs] + [k for _, k in runs]
             + [int(wlo[s]) - j for (s, _), j in zip(runs, run_j0)]
             + [int(whi[s] - wlo[s]) for s, _ in runs]
             + [y for y, _ in row_runs] + [k for _, k in row_runs]
             + [int(hlo[y]) for y, _ in row_runs] + [int(hhi[y]) for y, _ in row_runs])
    with torch.inference_mode(False):
        return torch.from_numpy(np.asarray(table, np.int32)).to(device)


@functools.lru_cache(maxsize=64)
def _launch_inputs(n, h, w, c, out_h, out_w, itemsize, align_corners, tile, rows, device):
    """What a launch of B1 takes besides its tensors, looked up once a call:
    the plan, the H and W lerp weights and the run table on ``device``."""
    plan = upsample_plan(n, h, w, c, out_h, out_w, itemsize, align_corners, tile, rows)
    return (plan, lerp_tables(h, out_h, align_corners, device)[2],
            lerp_tables(w, out_w, align_corners, device)[2],
            _run_table(h, w, out_h, out_w, align_corners, plan.tile, plan.rows, plan.align, device))


@functools.lru_cache(maxsize=256)
def upsample_plan(n: int, h: int, w: int, c: int, out_h: int, out_w: int, itemsize: int,
                  align_corners: bool = True, tile: int | None = None,
                  rows: int | None = None) -> UpsamplePlan:
    """Launch plan of B1's kernel for (N, h, w, C) logits of ``itemsize``
    bytes an element to an (N, out_h, out_w) mask: the column tile (256
    unless ``tile`` says 128) and the most rows a row run (4 unless
    ``rows`` says fewer). A block, one warp, takes a tile
    (:func:`upsample_column_tiles`) by a row run
    (:func:`upsample_row_runs`) of one image, tile by tile, the tile with
    the fewest column runs last: it stages the run's two
    source rows, source columns ``wlo[first column] .. whi[last column]``
    of the tile from a multiple of ``align`` columns (a 16-byte boundary of
    the NHWC row), beside a mask buffer of the run's rows by the tile. At
    the serving shape, (N, 128, 256, 19) bf16 to (1,024, 2,048), that is 9
    tiles by 262 row runs by N blocks of 7.5 KB (``chip_smoke.py
    --tune-mask`` times the alternatives). Raises on a shape it cannot
    take. A pure function of the shape."""
    if min(n, h, w, c, out_h, out_w, itemsize) < 1:
        raise ValueError(f"upsample_plan: empty shape ({n}, {h}, {w}, {c}) -> ({out_h}, {out_w})")
    tile = UPSAMPLE_TILES[0] if tile is None else tile
    if tile not in UPSAMPLE_TILES:
        raise ValueError(f"upsample_plan: no tile of {tile} columns")
    rows = UPSAMPLE_ROWS[0] if rows is None else rows
    if rows not in UPSAMPLE_ROWS:
        raise ValueError(f"upsample_plan: {rows} rows a run, not one of {UPSAMPLE_ROWS}")
    align = 16 // math.gcd(16, c * itemsize)
    wlo, whi, _ = _axis_lerp_coeffs(w, out_w, align_corners)
    tiles, runs, _ = upsample_column_tiles(w, out_w, align_corners, tile)
    cols = max(int(whi[x1 - 1]) - int(wlo[x0]) // align * align + 1 for x0, x1 in tiles)
    row_bytes = -(-cols * c * itemsize // 16) * 16
    mask_rows = 4 if rows > 2 else 2  # the kernel's R
    smem = 4 * mask_rows * (tile + tile // 8) + 2 * row_bytes  # padded mask rows; 2 staged rows
    if smem > _H_SMEM_MAX:
        raise ValueError(f"upsample_plan: two staged rows of {cols} columns x {c} classes and "
                         f"the mask buffer need {smem} bytes of shared memory, more than "
                         f"{_H_SMEM_MAX}")
    nrows = len(upsample_row_runs(h, out_h, align_corners, rows))
    if len(tiles) * nrows * n > 2**31 - 1:
        raise ValueError(f"upsample_plan: {len(tiles)} x {nrows} x {n} blocks, more than a "
                         "grid holds")
    return UpsamplePlan(tile, rows, cols, len(runs), align, smem, (len(tiles), nrows, n))


def h_lerp_argmax(xw, out_h, align_corners=True, tile=None, rows=None):
    """H-upsample of the W-upsampled (N, h, C, W) logits to ``out_h`` rows,
    then argmax over C: an (N, out_h, W) int32 mask (kernel B2, the
    operator ``fastscnn::h_lerp_argmax``). ``tile`` and ``rows`` override
    the launch plan's column tile and rows a strip (:func:`h_lerp_plan`)."""
    return _OPS.h_lerp_argmax.default(xw, int(out_h), align_corners, tile, rows)


def _check_xw(xw):
    if xw.ndim != 4:
        raise ValueError(f"h_lerp_argmax needs (N, h, C, W), got {tuple(xw.shape)}")


def _h_lerp_argmax_cpu(xw, out_h, align_corners, tile, rows):
    _check_xw(xw)
    return h_lerp_argmax_reference(xw, out_h, align_corners)


def _h_lerp_argmax_fake(xw, out_h, align_corners, tile, rows):
    _check_xw(xw)
    return xw.new_empty((xw.shape[0], out_h, xw.shape[3]), dtype=torch.int32)


def _h_lerp_argmax_cuda(xw, out_h, align_corners, tile, rows):
    _check_xw(xw)
    code = _kernel_input(xw, "h_lerp_argmax")
    n, h, c, w = xw.shape
    plan = h_lerp_plan(n, h, c, out_h, w, xw.element_size(), align_corners, tile, rows)
    hlo, hhi, hw = lerp_tables(h, out_h, align_corners, xw.device)
    out = torch.empty((n, out_h, w), dtype=torch.int32, device=xw.device)
    vcopy = (w * xw.element_size()) % 16 == 0 and xw.data_ptr() % 16 == 0
    vec_out = w % 4 == 0 and out.data_ptr() % 16 == 0
    rc = launch("upsample_argmax", "fastscnn_h_lerp_argmax", xw.device,
        code, xw.data_ptr(), hlo.data_ptr(), hhi.data_ptr(), hw.data_ptr(), out.data_ptr(),
        n, h, c, out_h, w, plan.tile, plan.rows, plan.smem, int(vcopy), int(vec_out),
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


def packed_argmax(y: torch.Tensor, dim: int, out_dtype=torch.int32) -> torch.Tensor:
    """``argmax`` over ``dim`` as one max-reduce of packed int32 keys (the
    JAX ``packed_argmax``, a rejected serving experiment kept with its
    test): each bf16 value's bits map to an order-preserving 16-bit key
    (negatives: all bits flipped; the rest: the sign bit set), the key goes
    above ``C - 1 - class`` in one int32, and the class is decoded from the
    low byte of the max. Ties go to the lowest class, as ``torch.argmax``.
    Non-bf16 input or C > 256 takes ``torch.argmax``."""
    dim = dim % y.ndim
    c = y.shape[dim]
    if y.dtype != torch.bfloat16 or c > 256:
        return y.argmax(dim=dim).to(out_dtype)
    u = y.view(torch.int16).to(torch.int32) & 0xFFFF
    ordered = torch.where(u & 0x8000 != 0, ~u & 0xFFFF, u | 0x8000)
    shape = [1] * y.ndim
    shape[dim] = c
    cls = torch.arange(c, dtype=torch.int32, device=y.device).reshape(shape)
    m = ((ordered << 8) | (c - 1 - cls)).amax(dim=dim)
    return ((c - 1) - (m & 0xFF)).to(out_dtype)


def neighborhood_agreement_mask(logits, out_size, align_corners=True, out_dtype=torch.int32):
    """The ``'nbr-exact'`` mask: where the four source pixels of an output
    pixel's 2x2 bilinear footprint share one argmax class, that class (a
    convex combination keeps it on top, and ties go to the lowest class
    at every corner as in the full argmax); elsewhere the ``'hybrid'``
    matmul plan, ``w_matmul_h_lerp_argmax(use_kernel=False)``.

    As the JAX function: the low-resolution argmax, cell unanimity from
    the right, lower and diagonal neighbours (edge-clamped, so border
    cells compare with themselves), each output pixel's cell taken at
    ⌊src⌋ of the lerp tables, then a select. JAX expands the cell by a
    one-hot matmul (``_lo_onehot``) of ``class + 32 · unanimous``; the
    expansion is an exact selection, so here it is an index gather of the
    class and the flag, which also holds for C > 32."""
    n, h, w, c = logits.shape
    out_h, out_w = int(out_size[0]), int(out_size[1])
    am = logits.argmax(dim=-1).to(torch.int32)
    am_r = torch.cat([am[:, :, 1:], am[:, :, -1:]], dim=2)
    am_d = torch.cat([am[:, 1:], am[:, -1:]], dim=1)
    am_dr = torch.cat([am_d[:, :, 1:], am_d[:, :, -1:]], dim=2)
    unanimous = (am == am_r) & (am == am_d) & (am == am_dr)
    hlo = lerp_tables(h, out_h, align_corners, logits.device)[0]
    wlo = lerp_tables(w, out_w, align_corners, logits.device)[0]
    near_cls = am.index_select(1, hlo).index_select(2, wlo)
    near_ok = unanimous.index_select(1, hlo).index_select(2, wlo)
    interp = w_matmul_h_lerp_argmax(logits, out_size, align_corners, use_kernel=False)
    return torch.where(near_ok, near_cls, interp).to(out_dtype)
