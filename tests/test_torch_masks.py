"""The engine's last two mask modes and ``packed_argmax``
(``fastscnn_tpu_torch/ops/cuda/upsample_argmax.py``) against the JAX
package's functions (``fastscnn_tpu/ops/pallas/upsample_argmax.py``) on
identical f32 logits, and the cached index of ``resize_nearest``.

Tolerances: ``'nbr-exact'`` equals JAX on every pixel whose 2x2 footprint
is unanimous (both take the footprint's class); elsewhere both run the
'hybrid' matmul plan, which sums in another order in each package, so the
masks are equal except at near-ties (the two best classes' f32
interpolated logits within 1e-5, as ``test_torch_upsample_argmax.py``).
``'argmax-first'`` and ``packed_argmax`` do the same integer work in both
packages: equal on every element.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastscnn_tpu.ops.resize import resize_nearest as jax_resize_nearest
from fastscnn_tpu_torch.ops.cuda.upsample_argmax import (
    neighborhood_agreement_mask,
    packed_argmax,
    upsample_argmax_reference,
)
from fastscnn_tpu_torch.ops.resize import (
    _axis_lerp_coeffs,
    nearest_index,
    resize_bilinear,
    resize_nearest,
)

NEAR_TIE = 1e-5
# the module, not the function of the same name that fastscnn_tpu.ops.pallas re-exports
jua = importlib.import_module("fastscnn_tpu.ops.pallas.upsample_argmax")


def _assert_masks_near(got, ref, up):
    """Equal but at near-ties of the f32 full-resolution logits ``up``."""
    diff = got != ref
    if diff.any():
        a = np.take_along_axis(up, got[..., None].astype(np.int64), -1)[..., 0]
        b = np.take_along_axis(up, ref[..., None].astype(np.int64), -1)[..., 0]
        assert np.abs(a - b)[diff].max() < NEAR_TIE, (diff.sum(), np.abs(a - b)[diff].max())
    assert diff.mean() <= 1e-3


def _regions(rng, n, h, w, c, regions=None):
    """Piecewise-constant class regions (4x4 of them, random unless given)
    plus noise that cannot flip the argmax (margin 3, noise ~0.3):
    unanimous cells are common, region boundaries exercise the
    interpolated branch."""
    if regions is None:
        regions = rng.integers(0, c, (4, 4))
    base = np.kron(regions, np.ones((h // 4 + 1, w // 4 + 1)))[:h, :w].astype(int)
    return (rng.normal(0, 0.3, (n, h, w, c)) + 3.0 * np.eye(c)[base][None]).astype(np.float32)


def _unanimous_at_full_res(logits, size, align_corners):
    """Where the 2x2 footprint of each output pixel agrees (edge-clamped)."""
    am = logits.argmax(-1)
    r = np.concatenate([am[:, :, 1:], am[:, :, -1:]], 2)
    d = np.concatenate([am[:, 1:], am[:, -1:]], 1)
    dr = np.concatenate([d[:, :, 1:], d[:, :, -1:]], 2)
    ok = (am == r) & (am == d) & (am == dr)
    hlo = _axis_lerp_coeffs(logits.shape[1], size[0], align_corners)[0]
    wlo = _axis_lerp_coeffs(logits.shape[2], size[1], align_corners)[0]
    return ok[:, hlo][:, :, wlo]


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("kind", ["regions", "random"])
@pytest.mark.parametrize("shape,size", [((2, 16, 24, 19), (128, 192)),
                                        ((1, 13, 17, 5), (97, 131))])
def test_neighborhood_agreement_mask_matches_jax(rng, align_corners, kind, shape, size):
    if kind == "regions":
        logits = _regions(rng, *shape)
    else:
        logits = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(jua.neighborhood_agreement_mask(jnp.asarray(logits), size, align_corners))
    got = neighborhood_agreement_mask(torch.from_numpy(logits), size, align_corners)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    got = got.numpy()
    unanimous = _unanimous_at_full_res(logits, size, align_corners)
    assert unanimous.any()
    np.testing.assert_array_equal(got[unanimous], ref[unanimous])
    up = resize_bilinear(torch.from_numpy(logits), size, align_corners).numpy()
    _assert_masks_near(got, ref, up)


def test_neighborhood_agreement_mask_out_dtype_and_many_classes(rng):
    """``out_dtype`` as the engine passes it, and C = 40: the index gather
    holds past the 32 classes that JAX's packed one-hot expansion can
    carry, so the mask is held against the plain bilinear argmax."""
    logits = _regions(rng, 1, 12, 20, 40, regions=np.arange(24, 40).reshape(4, 4))
    size = (90, 150)
    got = neighborhood_agreement_mask(torch.from_numpy(logits), size, True, torch.uint8)
    assert got.dtype == torch.uint8
    ref = upsample_argmax_reference(torch.from_numpy(logits), size, True).numpy()
    up = resize_bilinear(torch.from_numpy(logits), size, True).numpy()
    _assert_masks_near(got.numpy(), ref, up)
    assert got.numpy().max() >= 32


@pytest.mark.parametrize("size", [(64, 128), (61, 97), (8, 16)])
def test_argmax_first_matches_jax(rng, size):
    """'argmax-first': argmax of the 1/8 logits, then ``resize_nearest``;
    the same integers in both packages."""
    logits = rng.standard_normal((2, 8, 16, 19)).astype(np.float32)
    ref = np.asarray(jax_resize_nearest(jnp.argmax(jnp.asarray(logits), -1).astype(jnp.int32),
                                        size))
    got = resize_nearest(torch.from_numpy(logits).argmax(-1).to(torch.int32), size)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_packed_argmax_matches_argmax_and_jax_including_ties(rng):
    """Exact, first-occurrence ties included, on every axis (the JAX
    package's ``test_packed_argmax_exact_including_ties``); the uint8
    ``out_dtype``; the f32 and C > 256 fallbacks."""
    y = torch.from_numpy(rng.standard_normal((3, 11, 7, 19)).astype(np.float32)).bfloat16()
    y[..., 9] = y[..., 4]
    y[..., 14] = y[..., 4]
    yj = jnp.asarray(y.float().numpy(), jnp.bfloat16)
    for axis in range(4):
        got = packed_argmax(y, axis)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), y.argmax(dim=axis).numpy())
        np.testing.assert_array_equal(got.numpy(), np.asarray(jua.packed_argmax(yj, axis=axis)))
    assert (packed_argmax(y, -1)[..., None] != 9).all()  # a tie goes to the lowest class, 4
    assert packed_argmax(y, -1, out_dtype=torch.uint8).dtype == torch.uint8
    yf = y.float()
    np.testing.assert_array_equal(packed_argmax(yf, -1).numpy(), yf.argmax(-1).numpy())
    wide = torch.from_numpy(rng.standard_normal((2, 300)).astype(np.float32)).bfloat16()
    np.testing.assert_array_equal(packed_argmax(wide, 1).numpy(), wide.argmax(1).numpy())


def test_packed_argmax_orders_signs_and_zero():
    """The key order of the bit packing across negatives, zero and
    positives (a negative's bits are flipped, a positive's sign bit set)."""
    y = torch.tensor([[-3.0, -0.5, 0.0, 0.25, 7.0], [7.0, -1.0, 7.0, -9.0, 6.5],
                      [-2.0, -1.0, -4.0, -1.0, -8.0]]).bfloat16()
    np.testing.assert_array_equal(packed_argmax(y, 1).numpy(), [4, 0, 1])


def test_resize_nearest_builds_its_index_once_per_sizes_and_device():
    """The index is made once per (in, out, device) and then reused, so a
    later call copies nothing from the host (a CUDA graph can capture it)."""
    nearest_index.cache_clear()
    x = torch.arange(2 * 16 * 32, dtype=torch.int32).reshape(2, 16, 32)
    first = resize_nearest(x, (64, 128))
    assert nearest_index.cache_info().misses == 2 and nearest_index.cache_info().hits == 0
    again = resize_nearest(x + 1, (64, 128))
    assert nearest_index.cache_info().misses == 2 and nearest_index.cache_info().hits == 2
    assert torch.equal(again, first + 1)
    with torch.inference_mode():
        resize_nearest(x, (64, 64))  # the 16 -> 64 axis is cached; 32 -> 64 is new
    info = nearest_index.cache_info()
    assert (info.misses, info.hits) == (3, 3)
    idx = nearest_index(32, 64, torch.device("cpu"))
    assert idx.dtype == torch.int64 and not idx.is_inference()
