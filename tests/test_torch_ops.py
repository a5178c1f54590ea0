"""The port's plain ops against the JAX package's, on the same numpy inputs.

All in f32. Tolerances: the lerp resizes, nearest resize and pooling do
the same operations in the same order, so they must agree to f32
rounding (1e-6; the fixed max pool exactly, the fixed average pool's
window sums in another order, 1e-6); matmul resizes, convolutions and BN
folding sum in a different order or use another rsqrt, so they get 1e-5.
``dw_conv2d_taps`` adds the same f32 products in the same tap order as
JAX, so its forward agrees to 1e-6 and its gradients (autograd of the
slices against JAX's AD) to 1e-5.
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
    avg_pool,
    conv2d,
    conv_out_len,
    dw_conv2d_taps,
    fold_conv_bn,
    max_pool,
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


@pytest.mark.parametrize("pool", ["avg", "max"])
@pytest.mark.parametrize("window,stride,padding", [(2, None, 0), (3, 1, 1), (3, 2, 1), (4, 2, 2),
                                                    (5, 3, 0), (2, 1, 3)])
def test_fixed_pools_match_jax(rng, pool, window, stride, padding):
    """``avg_pool`` divides by window² with the zero padding counted;
    ``max_pool`` pads with −inf (a padding past half the window included)."""
    x = rng.standard_normal((2, 11, 14, 3)).astype(np.float32)
    jfn, fn = (jpool.avg_pool, avg_pool) if pool == "avg" else (jpool.max_pool, max_pool)
    ref = np.asarray(jfn(jnp.asarray(x), window, stride, padding))
    got = fn(_t(x), window, stride, padding).numpy()
    assert got.shape == ref.shape
    if pool == "max":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("c", [1, 3, 64])
def test_dw_conv2d_taps_matches_jax_with_its_gradient(rng, stride, c):
    import jax

    x = rng.standard_normal((2, 9, 12, c)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 1, c)) * 0.3).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    g = rng.standard_normal((2, conv_out_len(9, 3, stride, 1), conv_out_len(12, 3, stride, 1),
                             c)).astype(np.float32)
    ref, vjp = jax.vjp(lambda x, w, b: jconv.dw_conv2d_taps(x, w, b, stride=stride, padding=1),
                       jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ref_grads = vjp(jnp.asarray(g))
    tx, tw, tb = (_t(a).requires_grad_() for a in (x, w, b))
    got = dw_conv2d_taps(tx, tw, tb, stride=stride, padding=1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    got.backward(_t(g))
    for t, r in zip((tx, tw, tb), ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    # the conv it reformulates, and the JAX function's two refusals
    np.testing.assert_allclose(got.detach().numpy(), conv2d(_t(x), _t(w), _t(b), stride=stride,
                                                            padding=1, groups=c).numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="depthwise-only"):
        dw_conv2d_taps(_t(x), _t(w), groups=1 if c > 1 else 2)
    with pytest.raises(ValueError, match="multiplier-1"):
        dw_conv2d_taps(_t(x), _t(np.concatenate([w, w], axis=-1)))


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
