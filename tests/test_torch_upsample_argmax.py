"""Kernels B1 and B2 (``fastscnn_tpu_torch/ops/cuda/upsample_argmax.py``):
their plain PyTorch versions, which the wrappers run for CPU tensors,
against the JAX package's functions as they run on the CPU —
``upsample_argmax`` takes its XLA reference there (f32 lerp + argmax),
and ``w_matmul_h_lerp_argmax(use_pallas=False)`` its matmul plan.

Tolerance: masks are equal except at near-ties, pixels where the two
best classes' f32 interpolated logits differ by less than 1e-5 (the JAX
matmul plan sums in another order than the two-tap lerp). Exact ties go
to the lowest class in both packages.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastscnn_tpu_torch.ops.cuda import h_lerp_argmax, upsample_argmax, w_matmul_h_lerp_argmax
from fastscnn_tpu_torch.ops.cuda.upsample_argmax import (
    H_LERP_TILES,
    UPSAMPLE_ROWS,
    UPSAMPLE_TILES,
    _matmul_h,
    h_lerp_plan,
    h_lerp_strips,
    upsample_column_tiles,
    upsample_plan,
    upsample_row_runs,
)
from fastscnn_tpu_torch.ops.resize import lerp_tables
from fastscnn_tpu_torch.ops.resize import resize_bilinear

NEAR_TIE = 1e-5
# the module, not the function of the same name that fastscnn_tpu.ops.pallas re-exports
jua = importlib.import_module("fastscnn_tpu.ops.pallas.upsample_argmax")


def _assert_masks_near(got, ref, up):
    """``up``: f32 full-resolution logits (N, H, W, C) deciding near-ties."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    diff = got != ref
    if diff.any():
        vals = np.take_along_axis(up, got[..., None].astype(np.int64), -1)[..., 0]
        refv = np.take_along_axis(up, ref[..., None].astype(np.int64), -1)[..., 0]
        gaps = np.abs(vals - refv)[diff]
        assert gaps.max() < NEAR_TIE, (diff.sum(), gaps.max())
    assert diff.mean() <= 1e-3


def _full_res(logits, size, align_corners):
    return resize_bilinear(torch.from_numpy(logits).float(), size, align_corners).numpy()


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,size", [((2, 8, 16, 19), (64, 128)), ((1, 7, 9, 4), (30, 50))])
def test_upsample_argmax_plain_matches_jax(rng, align_corners, dtype, shape, size):
    logits = rng.standard_normal(shape).astype(np.float32)
    x = torch.from_numpy(logits).to(getattr(torch, dtype))
    ref = jua.upsample_argmax(jnp.asarray(x.float().numpy(), getattr(jnp, dtype)), size,
                              align_corners=align_corners)
    before = upsample_argmax.launches
    got = upsample_argmax(x, size, align_corners=align_corners)
    assert upsample_argmax.launches == before
    assert got.dtype == torch.int32
    _assert_masks_near(got.numpy(), ref, _full_res(x.float().numpy(), size, align_corners))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("align_corners", [True, False])
def test_w_matmul_h_lerp_argmax_matches_jax(rng, use_kernel, align_corners):
    """The hybrid path in f32: W-first matmul then the H-matmul plan
    (``use_kernel=False``) or B2's plain version (``use_kernel=True``),
    against JAX's matmul plan."""
    logits = rng.standard_normal((2, 8, 16, 19)).astype(np.float32)
    size = (64, 128)
    ref = jua.w_matmul_h_lerp_argmax(jnp.asarray(logits), size, align_corners, use_pallas=False)
    got = w_matmul_h_lerp_argmax(torch.from_numpy(logits), size, align_corners,
                                 use_kernel=use_kernel, out_dtype=torch.uint8)
    assert got.dtype == torch.uint8
    _assert_masks_near(got.numpy(), ref, _full_res(logits, size, align_corners))


def test_h_lerp_argmax_plain_matches_jax_h_matmul(rng):
    """B2's own input: an (N, h, C, W) tensor, H pass + argmax over C."""
    xw = rng.standard_normal((2, 8, 5, 40)).astype(np.float32)
    ref = jnp.argmax(jua._matmul_h(jnp.asarray(xw), 64, True), axis=2)
    got = h_lerp_argmax(torch.from_numpy(xw), 64)
    up = np.moveaxis(
        resize_bilinear(torch.from_numpy(xw), (64, 40), True, h_axis=1, w_axis=3).numpy(), 2, 3
    )
    _assert_masks_near(got.numpy(), ref, up)


def test_matmul_h_matches_jax(rng):
    xw = rng.standard_normal((2, 8, 5, 40)).astype(np.float32)
    ref = np.asarray(jua._matmul_h(jnp.asarray(xw), 64, True))
    np.testing.assert_allclose(_matmul_h(torch.from_numpy(xw), 64, True).numpy(), ref,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("head", ["upsample", "hybrid", "h_lerp"])
def test_exact_ties_go_to_the_lowest_class(head):
    """Equal logits give the lowest class; classes 2 and 4 tied for the
    maximum everywhere give 2 — in the port and in JAX alike."""
    for tied, want in (((0, 1, 2, 3, 4), 0), ((2, 4), 2)):
        logits = np.zeros((1, 4, 6, 5), np.float32)
        logits[..., list(tied)] = 1.0
        x = torch.from_numpy(logits)
        if head == "upsample":
            got = upsample_argmax(x, (16, 24))
            ref = jua.upsample_argmax(jnp.asarray(logits), (16, 24))
        elif head == "hybrid":
            got = w_matmul_h_lerp_argmax(x, (16, 24), use_kernel=True)
            ref = jua.w_matmul_h_lerp_argmax(jnp.asarray(logits), (16, 24), use_pallas=False)
        else:
            xw = np.ascontiguousarray(np.transpose(logits, (0, 1, 3, 2)))  # (N, h, C, W)
            got = h_lerp_argmax(torch.from_numpy(xw), 16)
            ref = jnp.argmax(jua._matmul_h(jnp.asarray(xw), 16, True), axis=2)
        assert np.all(got.numpy() == want)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_mask_head_wrappers_refuse_other_devices():
    """The operators' CUDA implementations raise for a tensor that is not on
    CUDA (no fallback to the plain version); a ``meta`` tensor takes the
    fake implementation: the mask's shape and dtype, nothing launched."""
    ua = importlib.import_module("fastscnn_tpu_torch.ops.cuda.upsample_argmax")
    logits, xw = torch.empty((1, 4, 4, 3), device="meta"), torch.empty((1, 4, 3, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        ua._upsample_argmax_cuda(logits, [8, 8], True, None, None)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        ua._h_lerp_argmax_cuda(xw, 8, True, None, None)
    before = (upsample_argmax.launches, h_lerp_argmax.launches)
    for out in (upsample_argmax(logits, (8, 8)), h_lerp_argmax(xw, 8)):
        assert out.device.type == "meta" and out.shape == (1, 8, 8) and out.dtype == torch.int32
    assert (upsample_argmax.launches, h_lerp_argmax.launches) == before


# -- B2's launch plan ------------------------------------------------------------
def _check_h_lerp_plan(plan, n, h, c, out_h, w, itemsize, align_corners):
    """Every output row in exactly one strip; each strip's staged source rows
    hold [hlo, hhi] of each of its rows, at most ``plan.staged`` of them;
    the staged planes fit the block's shared memory; the grid covers W."""
    lo, hi, _ = (t.numpy() for t in lerp_tables(h, out_h, align_corners, torch.device("cpu")))
    strips = h_lerp_strips(h, out_h, align_corners, plan.rows)
    assert len(strips) == plan.grid[1] and plan.grid[2] == n
    covered = np.zeros(out_h, np.int64)
    for y0, y1, s0, s1 in strips:
        covered[y0:y1] += 1
        assert 1 <= y1 - y0 <= plan.rows
        assert s1 - s0 <= plan.staged
        assert np.all(lo[y0:y1] >= s0) and np.all(hi[y0:y1] < s1)
    assert np.all(covered == 1)
    assert plan.smem == plan.staged * c * plan.tile * itemsize <= 227 * 1024
    assert plan.tile in H_LERP_TILES
    assert (plan.grid[0] - 1) * plan.tile < w <= plan.grid[0] * plan.tile


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("c", [2, 3, 19])
@pytest.mark.parametrize("w", [2048, 2000])
def test_h_lerp_plan_at_the_serving_shape(n, align_corners, c, w):
    """(N, 128, C, W) bf16 to 1,024 rows, the serving path's B2 input, at
    N = 1 and 2 and a ragged W: the strips cover the rows once, the staged
    rows cover each row's taps, the grid holds at least one block for
    each of the H100's 132 SMs, and the plan is a function of the shape."""
    plan = h_lerp_plan(n, 128, c, 1024, w, 2, align_corners)
    assert plan == h_lerp_plan.__wrapped__(n, 128, c, 1024, w, 2, align_corners)
    _check_h_lerp_plan(plan, n, 128, c, 1024, w, 2, align_corners)
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= 132
    assert plan.smem <= 48 * 1024


@pytest.mark.parametrize("shape,out_h,itemsize", [
    ((1, 17, 3, 1000), 136, 4), ((2, 9, 2, 1001), 72, 2), ((1, 5, 19, 384), 11, 4),
    ((1, 64, 2, 33), 30, 4), ((3, 1, 4, 8), 1, 2)])
@pytest.mark.parametrize("align_corners", [True, False])
def test_h_lerp_plan_odd_shapes_and_forced_strips(shape, out_h, itemsize, align_corners):
    """Odd h, ragged W, down-sampling (64 -> 30 rows) and a single row, with
    the plan's strips and with forced ones: one row a strip, every row in
    one strip where it fits, and the wide column tile."""
    n, h, c, w = shape
    plans = [h_lerp_plan(n, h, c, out_h, w, itemsize, align_corners),
             h_lerp_plan(n, h, c, out_h, w, itemsize, align_corners, tile=256, rows=1),
             h_lerp_plan(n, h, c, out_h, w, itemsize, align_corners, rows=out_h + 3)]
    for plan in plans:
        _check_h_lerp_plan(plan, n, h, c, out_h, w, itemsize, align_corners)
    assert plans[1].staged <= 2 and plans[2].grid[1] == 1


def test_h_lerp_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="empty"):
        h_lerp_plan(1, 0, 19, 1024, 2048, 2)
    with pytest.raises(ValueError, match="no tile"):
        h_lerp_plan(1, 128, 19, 1024, 2048, 2, tile=64)
    with pytest.raises(ValueError, match="shared memory"):
        h_lerp_plan(1, 128, 300, 1024, 2048, 4)  # two rows of 300 f32 planes: 300 KB
    with pytest.raises(ValueError, match="shared memory"):
        h_lerp_plan(1, 128, 19, 1024, 2048, 2, rows=1024)  # all 128 rows staged at once
    with pytest.raises(ValueError, match="images"):
        h_lerp_plan(65536, 4, 2, 8, 16, 2)


def test_h_lerp_argmax_cpu_ignores_the_launch_plan(rng):
    """On a CPU tensor the wrapper takes the plain version whatever tile or
    strip it is given, and launches nothing."""
    xw = torch.from_numpy(rng.standard_normal((2, 9, 3, 40)).astype(np.float32))
    before = h_lerp_argmax.launches
    ref = h_lerp_argmax(xw, 70, False)
    np.testing.assert_array_equal(h_lerp_argmax(xw, 70, False, tile=256, rows=1).numpy(),
                                  ref.numpy())
    assert h_lerp_argmax.launches == before


# -- B1's launch plan ------------------------------------------------------------
def _check_upsample_plan(plan, n, h, w, c, out_h, out_w, itemsize, align_corners):
    """Every output pixel in exactly one (tile, row run) and one lane's
    column run; each run's rows and each lane's columns share one source
    pair, so a run's two staged rows hold [hlo, hhi] of its rows; each
    tile's staged source columns hold [wlo, whi] of its columns, from a
    16-byte boundary of the NHWC row; the staging and the mask buffer fit
    the block's shared memory."""
    cpu = torch.device("cpu")
    hlo, hhi, _ = (t.numpy() for t in lerp_tables(h, out_h, align_corners, cpu))
    wlo, whi, _ = (t.numpy() for t in lerp_tables(w, out_w, align_corners, cpu))
    row_runs = upsample_row_runs(h, out_h, align_corners, plan.rows)
    assert len(row_runs) == plan.grid[1] and plan.grid[2] == n
    rows_seen = np.zeros(out_h, np.int64)
    for y, k in row_runs:
        assert 1 <= k <= plan.rows
        assert np.all(hlo[y:y + k] == hlo[y]) and np.all(hhi[y:y + k] == hhi[y])
        rows_seen[y:y + k] += 1
    assert np.all(rows_seen == 1)
    tiles, runs, starts = upsample_column_tiles(w, out_w, align_corners, plan.tile)
    assert len(tiles) == plan.grid[0] and len(starts) == len(tiles) + 1
    assert starts[-1] == len(runs)
    cols_seen = np.zeros(out_w, np.int64)
    for t, (x0, x1) in enumerate(tiles):
        assert x0 % 4 == 0 and 0 < x1 - x0 <= plan.tile
        mine = runs[starts[t]:starts[t + 1]]
        assert 1 <= len(mine) <= 32
        for s, k in mine:
            assert x0 <= s and s + k <= x1 and 1 <= k <= plan.tile // 32
            assert np.all(wlo[s:s + k] == wlo[s])  # one source pair a run
            cols_seen[s:s + k] += 1
        j0 = wlo[x0] // plan.align * plan.align
        assert (j0 * c * itemsize) % 16 == 0
        assert np.all(wlo[x0:x1] >= j0) and whi[x1 - 1] - j0 + 1 <= plan.staged_cols
        assert np.all(whi[x0:x1] <= whi[x1 - 1])
    assert np.all(cols_seen == 1)
    row_bytes = -(-plan.staged_cols * c * itemsize // 16) * 16
    mask_rows = 4 if plan.rows > 2 else 2
    assert plan.smem == 4 * mask_rows * plan.tile * 9 // 8 + 2 * row_bytes <= 227 * 1024
    assert plan.runs == len(runs)
    assert plan.tile in UPSAMPLE_TILES and plan.rows in UPSAMPLE_ROWS


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("c", [2, 3, 19])
@pytest.mark.parametrize("out_w", [2048, 2000])
def test_upsample_plan_at_the_serving_shape(n, align_corners, c, out_w):
    """(N, 128, 256, C) bf16 logits to (1,024, W), the serving path's B1
    input, at N = 1 and 2 and a ragged W: every pixel in one tile, row run
    and column run, the staging covers every pixel's taps, the grid holds
    at least two blocks for each of the H100's 132 SMs, the block fits,
    and the plan is a function of the shape."""
    plan = upsample_plan(n, 128, 256, c, 1024, out_w, 2, align_corners)
    assert plan == upsample_plan.__wrapped__(n, 128, 256, c, 1024, out_w, 2, align_corners)
    _check_upsample_plan(plan, n, 128, 256, c, 1024, out_w, 2, align_corners)
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= 264
    assert plan.smem <= 16 * 1024


@pytest.mark.parametrize("shape,out,itemsize", [
    ((1, 1, 7, 19), (8, 56), 2),        # h of 1
    ((2, 9, 1, 3), (72, 5), 4),         # w of 1
    ((1, 16, 40, 19), (16, 321), 2),    # in == out along H
    ((1, 17, 64, 5), (136, 64), 4),     # in == out along W
    ((1, 64, 90, 5), (30, 33), 4),      # a downsample on both axes
    ((1, 8, 4096, 19), (16, 8192), 4),  # w * C * 4 beyond the old 227 KB whole-row limit
    ((3, 5, 33, 2), (41, 262), 2),      # odd sizes, W % 4 != 0
])
@pytest.mark.parametrize("align_corners", [True, False])
def test_upsample_plan_odd_shapes_and_forced_runs(shape, out, itemsize, align_corners):
    """Odd shapes with the plan's tiles and row runs and with forced ones:
    every tile at every count of rows a run."""
    n, h, w, c = shape
    args = (n, h, w, c, *out, itemsize, align_corners)
    _check_upsample_plan(upsample_plan(*args), *args)
    for tile in UPSAMPLE_TILES:
        for rows in UPSAMPLE_ROWS:
            _check_upsample_plan(upsample_plan(*args, tile=tile, rows=rows), *args)


def test_upsample_runs_at_x8():
    """At the serving path's x8 the runs fill the lanes and the rows: 256
    source columns to 2,048 take 9 tiles of at most 32 runs, most of them
    8 columns of one source pair, and 128 source rows to 1,024 take at
    most 264 row runs, most of them 4 rows of one source row pair."""
    for align_corners in (True, False):
        tiles, runs, _ = upsample_column_tiles(256, 2048, align_corners, 256)
        assert len(tiles) == 9 and len(runs) <= 9 * 32
        assert sum(k == 8 for _, k in runs) >= 240
        row_runs = upsample_row_runs(128, 1024, align_corners, 4)
        assert len(row_runs) <= 264 and sum(k == 4 for _, k in row_runs) >= 250


def test_upsample_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="empty"):
        upsample_plan(1, 128, 0, 19, 1024, 2048, 2)
    with pytest.raises(ValueError, match="no tile"):
        upsample_plan(1, 128, 256, 19, 1024, 2048, 2, tile=64)
    with pytest.raises(ValueError, match="rows a run"):
        upsample_plan(1, 128, 256, 19, 1024, 2048, 2, rows=8)
    with pytest.raises(ValueError, match="shared memory"):
        upsample_plan(1, 4, 4096, 19, 8, 64, 4)  # a tile of 32 columns spans 2,048 source columns
    with pytest.raises(ValueError, match="grid"):
        upsample_plan(2**20, 4, 4, 2, 65536, 8, 2)  # 16,384 row runs of 2**20 images


def test_upsample_argmax_cpu_ignores_the_launch_plan(rng):
    """On a CPU tensor the wrapper takes the plain version whatever tile or
    run it is given, and launches nothing."""
    x = torch.from_numpy(rng.standard_normal((2, 9, 13, 3)).astype(np.float32))
    before = upsample_argmax.launches
    ref = upsample_argmax(x, (70, 99), False)
    np.testing.assert_array_equal(upsample_argmax(x, (70, 99), False, tile=128, rows=1).numpy(),
                                  ref.numpy())
    assert upsample_argmax.launches == before
