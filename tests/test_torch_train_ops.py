"""Training ops of the port against the JAX package's: kernel B6
(``dw_conv3x3_vjp``: forward, dX and dW, and its plain dX and dW versions),
``conv2d_tapbwd`` and ``batch_norm_train``/``batch_norm_apply``.

On the CPU the B6 wrapper runs its plain versions; the JAX B6 runs its
Pallas forward in the interpreter, as the JAX package's own tests run it.
The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``.

Tolerances (f32): outputs and dX rtol 1e-5, atol 1e-5 — the two sum the
same few taps in another order. dW rtol 1e-5 and atol 1e-5 of the largest
|dW|: each element sums N·Ho·Wo products (hundreds here) in another
order, so its rounding error scales with the sum's terms, not its value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastscnn_tpu.ops.conv import _conv_dw_taps, _conv_dx
from fastscnn_tpu.ops.conv import batch_norm_apply as jax_bn_apply
from fastscnn_tpu.ops.conv import batch_norm_train as jax_bn_train
from fastscnn_tpu.ops.conv import conv2d as jax_conv2d
from fastscnn_tpu.ops.conv import conv2d_tapbwd as jax_conv2d_tapbwd
from fastscnn_tpu.ops.pallas.dw_conv import dw_conv3x3_pallas_vjp
from fastscnn_tpu_torch.ops.conv import batch_norm_apply, batch_norm_train, conv2d_tapbwd
from fastscnn_tpu_torch.ops.cuda import (
    KERNELS,
    dw_conv3x3,
    dw_conv3x3_dw,
    dw_conv3x3_dw_reference,
    dw_conv3x3_dx,
    dw_conv3x3_dx_reference,
    dw_conv3x3_reference,
    dw_conv3x3_vjp,
    launch_counts,
)
from fastscnn_tpu_torch.ops.cuda.dw_conv import dw_plan, vec_width


def _close_dw(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


_B6_CASES = [
    ((2, 17, 23, 32), 2),  # odd H and W at stride 2 (the stem's 383 -> 192 case)
    ((1, 9, 11, 48), 2),
    ((2, 16, 22, 32), 2),  # even sizes: the remainder row and column
    ((2, 17, 23, 32), 1),
    ((1, 9, 11, 48), 1),
]


@pytest.mark.parametrize("shape,stride", _B6_CASES)
def test_b6_vjp_matches_jax_vjp(rng, shape, stride):
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 1, c)) * 0.3).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda a, b: dw_conv3x3_pallas_vjp(a, b, stride, 1, None, True),
                         jnp.asarray(x), jnp.asarray(w))
    g = rng.standard_normal(y_ref.shape).astype(np.float32)
    dx_ref, dw_ref = vjp(jnp.asarray(g))

    before = launch_counts()
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = dw_conv3x3_vjp(xt, wt, stride, 1)
    y.backward(torch.from_numpy(g))
    assert launch_counts() == before  # the CPU runs the plain versions, no kernel
    assert y.dtype == xt.grad.dtype == wt.grad.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref), rtol=1e-5, atol=1e-5)
    _close_dw(wt.grad.numpy(), dw_ref)


@pytest.mark.parametrize("shape,stride", _B6_CASES)
def test_b6_plain_dx_and_dw_match_conv_dx_and_conv_dw_taps(rng, shape, stride):
    c = shape[-1]
    ho, wo = (shape[1] - 1) // stride + 1, (shape[2] - 1) // stride + 1
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 1, c)) * 0.3).astype(np.float32)
    g = rng.standard_normal((shape[0], ho, wo, c)).astype(np.float32)
    dx_ref = _conv_dx(jnp.asarray(g), jnp.asarray(w), stride, 1, c, shape, None)
    dw_ref = _conv_dw_taps(jnp.asarray(x), jnp.asarray(g), 3, 3, stride, 1, c, None)
    dx = dw_conv3x3_dx_reference(torch.from_numpy(g), torch.from_numpy(w), stride, 1, shape)
    dw = dw_conv3x3_dw_reference(torch.from_numpy(x), torch.from_numpy(g), stride, 1)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), rtol=1e-5, atol=1e-5)
    _close_dw(dw.numpy(), dw_ref)
    # the wrappers take the plain versions for CPU tensors
    assert torch.equal(dw_conv3x3_dx(torch.from_numpy(g), torch.from_numpy(w), stride, 1, shape), dx)
    assert torch.equal(dw_conv3x3_dw(torch.from_numpy(x), torch.from_numpy(g), stride, 1), dw)


def test_b6_bf16_keeps_dtypes_and_rounds_once(rng):
    """bf16 x and w (the training step's casts): y and dX come back in bf16
    from f32 sums rounded once, dW in w's dtype — within one bf16 ulp of
    the f32 computation on the same bf16 values."""
    x = torch.from_numpy(rng.standard_normal((2, 11, 13, 32)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.standard_normal((3, 3, 1, 32)) * 0.3).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((2, 6, 7, 32)).astype(np.float32)).bfloat16()
    xt, wt = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = dw_conv3x3_vjp(xt, wt, 2, 1)
    y.backward(g)
    assert y.dtype == xt.grad.dtype == wt.grad.dtype == torch.bfloat16
    xf, wf = x.float().requires_grad_(), w.float().requires_grad_()
    yf = dw_conv3x3_vjp(xf, wf, 2, 1)
    yf.backward(g.float())
    for got, ref in ((y, yf), (xt.grad, xf.grad), (wt.grad, wf.grad)):
        err = (got.float() - ref.detach()).abs()
        assert bool((err <= 2.0**-8 * ref.detach().abs() + 1e-30).all()), err.max()


def test_b6_gradient_in_another_layout_is_copied_and_counted(rng):
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 16)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((3, 3, 1, 16)).astype(np.float32)).requires_grad_()
    y = dw_conv3x3_vjp(x, w, 2, 1)
    g = torch.from_numpy(rng.standard_normal((1, 16, 4, 4)).astype(np.float32)).permute(0, 2, 3, 1)
    before = dw_conv3x3_vjp.g_copies
    y.backward(g)
    assert dw_conv3x3_vjp.g_copies == before + 1
    y2 = dw_conv3x3_vjp(x.detach(), w, 2, 1)
    y2.backward(g.contiguous())
    assert dw_conv3x3_vjp.g_copies == before + 1
    assert set(KERNELS) >= {"dw_conv3x3", "dw_conv3x3_dx", "dw_conv3x3_dw"}


def test_b6_wrappers_refuse_other_devices_and_bad_shapes():
    x = torch.empty((1, 9, 9, 4), device="meta")
    g = torch.empty((1, 5, 5, 4), device="meta")
    w = torch.empty((3, 3, 1, 4), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        dw_conv3x3_dx(g, w, 2, 1, x.shape)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        dw_conv3x3_dw(x, g, 2, 1)
    with pytest.raises(ValueError, match="gradient shape"):
        dw_conv3x3_dw(torch.zeros((1, 9, 9, 4)), torch.zeros((1, 4, 5, 4)), 2, 1)
    with pytest.raises(ValueError, match="stride"):
        dw_conv3x3_dx(torch.zeros((1, 3, 3, 4)), torch.zeros((3, 3, 1, 4)), 3, 1, (1, 9, 9, 4))


@pytest.mark.parametrize("n_rows,c", [(3072, 32), (1536, 48), (5, 8), (1, 1024)])
def test_dw_plan_covers_every_row_once(n_rows, c):
    """The dW pass-1 plan: block b takes (n, ho) rows [b * rows, (b + 1) *
    rows), so every row lies in exactly one block; the grid (blocks,
    channel groups of 32 vectors) is within CUDA's limits and covers every
    channel; the plan is a function of the shape alone. The training
    stem's two sites (16 x 192 and 16 x 96 rows) fill 132 SMs several times."""
    vec = vec_width(c, 2, (1 << 20,) * 2)
    rows, blocks, groups = dw_plan(n_rows, c, vec)
    covered = [r for b in range(blocks) for r in range(b * rows, min((b + 1) * rows, n_rows))]
    assert covered == list(range(n_rows))
    assert 1 <= blocks < 2**31 and 1 <= groups <= 65535
    assert (groups - 1) * 32 * vec < c <= groups * 32 * vec
    assert dw_plan(n_rows, c, vec) == (rows, blocks, groups)
    if n_rows >= 1536:
        assert blocks >= 3 * 132


@pytest.mark.parametrize("target", [528, 792, 1056, 1584])
def test_dw_plan_block_targets(target):
    """Every number of pass-1 blocks ``chip_smoke.py --tune-dw`` times
    still covers each (n, ho) row of the training stem's dsconv1 exactly
    once, in at most ``target`` blocks."""
    n_rows = 16 * 192
    rows, blocks, groups = dw_plan(n_rows, 32, 8, target)
    covered = [r for b in range(blocks) for r in range(b * rows, min((b + 1) * rows, n_rows))]
    assert covered == list(range(n_rows)) and blocks <= target and groups == 1


def test_dw_wrappers_take_plan_overrides_on_the_cpu(rng):
    """The launch-plan arguments (``rows``, ``cols``, ``blocks``) leave the
    function alone: on the CPU the wrappers return their plain versions."""
    x = torch.from_numpy(rng.standard_normal((2, 9, 10, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 1, 8)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 5, 5, 8)).astype(np.float32))
    assert torch.equal(dw_conv3x3(x, w, None, 2, 1, False, rows=1, cols=4),
                       dw_conv3x3_reference(x, w, None, 2, 1))
    assert torch.equal(dw_conv3x3_dw(x, g, 2, 1, blocks=528), dw_conv3x3_dw_reference(x, g, 2, 1))


@pytest.mark.parametrize(
    "shape,cout,k,stride,padding,groups",
    [
        ((2, 11, 13, 3), 8, 3, 2, 0, 1),  # the stem conv: odd size, stride 2, no padding
        ((2, 10, 12, 3), 8, 3, 2, 0, 1),
        ((2, 9, 10, 8), 8, 3, 2, 1, 8),  # depthwise
        ((2, 8, 8, 6), 5, 1, 1, 0, 1),  # 1x1
    ],
)
def test_conv2d_tapbwd_matches_jax(rng, shape, cout, k, stride, padding, groups):
    cin = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((k, k, cin // groups, cout)) * 0.3).astype(np.float32)
    y_ref, vjp = jax.vjp(
        lambda a, b: jax_conv2d_tapbwd(a, b, stride=stride, padding=padding, groups=groups),
        jnp.asarray(x), jnp.asarray(w))
    g = rng.standard_normal(y_ref.shape).astype(np.float32)
    dx_ref, dw_ref = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = conv2d_tapbwd(xt, wt, stride=stride, padding=padding, groups=groups)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref), rtol=1e-5, atol=1e-5)
    _close_dw(wt.grad.numpy(), dw_ref)
    # and the same gradients as plain autograd of the conv
    ref_dx, ref_dw = jax.vjp(
        lambda a, b: jax_conv2d(a, b, stride=stride, padding=padding, groups=groups),
        jnp.asarray(x), jnp.asarray(w))[1](jnp.asarray(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), rtol=1e-5, atol=1e-5)
    _close_dw(wt.grad.numpy(), ref_dw)


def _bn_inputs(rng, shape):
    c = shape[-1]
    return (
        (rng.standard_normal(shape) * 3 + 1).astype(np.float32),
        rng.standard_normal(c).astype(np.float32),
        rng.standard_normal(c).astype(np.float32),
        rng.standard_normal(c).astype(np.float32),
        rng.uniform(0.5, 2.0, c).astype(np.float32),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True])
def test_batch_norm_train_matches_jax(rng, dtype, packed):
    """y, the new running mean and variance, and the gradients of a
    weighted sum of y. f32: 1e-5. bf16: y within one bf16 ulp (both take
    moments in f32 and round inv and shift to bf16); the statistics stay
    f32 (1e-5)."""
    x, scale, bias, mean, var = _bn_inputs(rng, (2, 5, 6, 64))
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_fn(xx, s, b):
        y, m, v = jax_bn_train(xx, s, b, jnp.asarray(mean), jnp.asarray(var), packed=packed)
        return jnp.sum(y.astype(jnp.float32) * cot), (y, m, v)

    (_, (y_ref, m_ref, v_ref)), grads_ref = jax.value_and_grad(jax_fn, argnums=(0, 1, 2),
                                                               has_aux=True)(
        jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y, m, v = batch_norm_train(xt, st, bt, torch.from_numpy(mean), torch.from_numpy(var),
                               packed=packed)
    (y.float() * torch.from_numpy(cot)).sum().backward()
    assert y.dtype == tdt and m.dtype == v.dtype == torch.float32
    assert not m.requires_grad and not v.requires_grad
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5, atol=1e-5)
    yr = np.asarray(y_ref, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(y.detach().numpy(), yr, rtol=1e-5, atol=1e-5)
        for got, ref in zip((xt.grad, st.grad, bt.grad), grads_ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    else:
        err = np.abs(y.detach().float().numpy() - yr)
        assert np.all(err <= 2.0**-7 * np.abs(yr) + 1e-6), err.max()


def test_batch_norm_apply_matches_jax(rng):
    x, scale, bias, mean, var = _bn_inputs(rng, (2, 5, 6, 16))
    ref = jax_bn_apply(*(jnp.asarray(a) for a in (x, scale, bias, mean, var)))
    got = batch_norm_apply(*(torch.from_numpy(a) for a in (x, scale, bias, mean, var)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
