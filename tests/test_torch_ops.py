"""The port's plain ops against the JAX package's, on the same numpy inputs.

All in f32. Tolerances: the lerp resizes, nearest resize and pooling do
the same operations in the same order, so they must agree to f32
rounding (1e-6); matmul resizes, convolutions and BN folding sum in a
different order or use another rsqrt, so they get 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastscnn_tpu.ops import conv as jconv
from fastscnn_tpu.ops import pool as jpool
from fastscnn_tpu.ops import resize as jresize
from fastscnn_tpu_torch.ops import (
    adaptive_avg_pool,
    conv2d,
    conv_out_len,
    fold_conv_bn,
    resize_bilinear,
    resize_bilinear_matmul,
    resize_nearest,
)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("shape,size", [((2, 8, 16, 5), (64, 128)), ((2, 13, 9, 3), (5, 20))])
def test_resize_bilinear_matches_jax(rng, align_corners, shape, size):
    x = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(jresize.resize_bilinear(jnp.asarray(x), size, align_corners=align_corners))
    got = resize_bilinear(_t(x), size, align_corners=align_corners).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize(
    # W-first (wide output) and H-first (tall output) contraction orders
    "shape,size", [((2, 8, 16, 5), (64, 128)), ((1, 4, 24, 3), (40, 30))],
)
def test_resize_bilinear_matmul_matches_jax(rng, align_corners, shape, size):
    x = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(
        jresize.resize_bilinear_matmul(jnp.asarray(x), size, align_corners=align_corners)
    )
    got = resize_bilinear_matmul(_t(x), size, align_corners=align_corners).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_resize_nearest_matches_jax(rng):
    x = rng.integers(0, 19, (2, 16, 32)).astype(np.int32)
    for size in ((64, 128), (7, 45)):
        ref = np.asarray(jresize.resize_nearest(jnp.asarray(x), size))
        np.testing.assert_array_equal(resize_nearest(_t(x), size).numpy(), ref)


@pytest.mark.parametrize("out", [1, 2, 3, 6, (4, 5)])
def test_adaptive_avg_pool_matches_jax(rng, out):
    x = rng.standard_normal((2, 7, 10, 4)).astype(np.float32)
    ref = np.asarray(jpool.adaptive_avg_pool(jnp.asarray(x), out))
    np.testing.assert_allclose(adaptive_avg_pool(_t(x), out).numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "k,stride,padding,groups,bias",
    [(3, 2, 0, 1, False), (1, 1, 0, 1, True), (3, 1, 1, 8, False), (3, 2, 1, 8, True)],
)
def test_conv2d_matches_jax(rng, k, stride, padding, groups, bias):
    c, cout = 8, (8 if groups > 1 else 12)
    x = rng.standard_normal((2, 11, 13, c)).astype(np.float32)
    w = (rng.standard_normal((k, k, c // groups, cout)) * 0.3).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32) if bias else None
    ref = np.asarray(jconv.conv2d(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        stride=stride, padding=padding, groups=groups,
    ))
    got = conv2d(_t(x), _t(w), None if b is None else _t(b), stride=stride, padding=padding,
                 groups=groups).numpy()
    assert got.shape == (2, conv_out_len(11, k, stride, padding),
                         conv_out_len(13, k, stride, padding), cout)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_bias", [False, True])
def test_fold_conv_bn_matches_jax(rng, with_bias):
    cout = 6
    w = rng.standard_normal((3, 3, 4, cout)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32) if with_bias else None
    scale, bias, mean = (rng.standard_normal(cout).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.1, 2.0, cout).astype(np.float32)
    ref_w, ref_b = jconv.fold_conv_bn(
        jnp.asarray(w), None if b is None else jnp.asarray(b),
        *(jnp.asarray(a) for a in (scale, bias, mean, var)),
    )
    got_w, got_b = fold_conv_bn(
        _t(w), None if b is None else _t(b), *(_t(a) for a in (scale, bias, mean, var))
    )
    np.testing.assert_allclose(got_w.numpy(), np.asarray(ref_w), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(ref_b), rtol=1e-5, atol=1e-6)
