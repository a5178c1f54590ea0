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
from fastscnn_tpu_torch.ops.cuda.upsample_argmax import _matmul_h
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
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        upsample_argmax(torch.empty((1, 4, 4, 3), device="meta"), (8, 8))
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        h_lerp_argmax(torch.empty((1, 4, 3, 8), device="meta"), 8)
