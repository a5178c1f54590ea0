"""The int8 serving configuration of the port against the JAX package's.

Kernels B7 and B8 (``fastscnn_tpu_torch/ops/cuda/int8_pw.py``) through
their plain PyTorch versions, which the wrappers run for CPU tensors,
against ``fastscnn_tpu/ops/pallas/int8_pw.py`` run in the Pallas
interpreter and through its XLA path; ``quantize_act``; and
``models/quantize.py`` with the model's int8 sites and ``act_fake_quant``
hook against the JAX model on shared weights.

Tolerances: ``quantize_act`` and B8 are bit-equal (B8's integer sums are
exact, and both sides do the same f32 multiply and add after them). B7's
products are exact in f32 but the JAX dot sums them in an order of its own,
so one bf16 ulp (2^-7 relative), or one int8 level with ``quantize_out``.
B7's kernel also sums in an order of its own (the tensor cores'): its
stated bound, ``pw_conv_a8_tolerance``, is tested here against sums of the
same products in other orders, and its launch plan at a frame's sites.
Whole-model comparisons use JAX's own tolerance for its int8 model
(``tests/test_int8_pw.py``): logits within 0.08 of max |logit| and argmax
agreement ≥ 0.98; each test states what it measured. The CUDA kernels are
held against these plain versions on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastscnn_tpu.models import FastSCNN as JaxFastSCNN
from fastscnn_tpu.models import PW_INT8_SITES as JAX_SITES
from fastscnn_tpu.models import calibrate_pw_scales as jax_calibrate
from fastscnn_tpu.models import fold_inference_params as jax_fold
from fastscnn_tpu.models import init_fast_scnn as jax_init
from fastscnn_tpu.models import quantized_model as jax_quantized
from fastscnn_tpu.ops.pallas import int8_pw as jax_int8
from fastscnn_tpu_torch.models import (
    PW_INT8_SITES,
    FastSCNN,
    calibrate_pw_scales,
    fold_inference_params,
    from_jax_params,
    quantized_model,
)
from fastscnn_tpu_torch.models import fast_scnn as port_model_module
from fastscnn_tpu_torch.ops.cuda import (
    launch_counts,
    pw_conv_a8,
    pw_conv_a8_reference,
    pw_conv_a8_tolerance,
    pw_conv_w8a8,
    quantize_act,
)
from fastscnn_tpu_torch.ops.cuda.int8_pw import (
    PW_A8_TILES,
    PW_W8A8_TILES,
    pw_a8_plan,
    pw_w8a8_plan,
)

_ULP_BF16 = 2.0**-7


def _np(a):
    """A torch tensor or a JAX array as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


# -- quantize_act --------------------------------------------------------------
@pytest.mark.parametrize("scale", [0.1234567891234, 1.0 / 3.0, 2.0**-5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_bit_equal_to_jax(rng, scale, dtype):
    """Python-float scales (the first two are not f32 values), normal values
    plus exact half-way points k + 1/2 of the f32 scale, and values beyond
    the ±127 clip: the same int8 as the JAX function."""
    s32 = np.float32(scale)
    x = np.concatenate([
        rng.standard_normal(20000) * 40 * s32,
        (np.arange(-130, 130) + 0.5) * s32,
        np.array([300.0, -300.0, 0.0]) * s32,
    ]).astype(np.float32)
    ref = np.asarray(jax_int8.quantize_act(jnp.asarray(x, getattr(jnp, dtype)), scale))
    got = quantize_act(torch.from_numpy(x).to(getattr(torch, dtype)), scale)
    assert got.dtype == torch.int8 and ref.dtype == np.int8
    np.testing.assert_array_equal(got.numpy(), ref)
    # the scale may also come as an f32 tensor (the model's cached form)
    got_t = quantize_act(torch.from_numpy(x).to(getattr(torch, dtype)),
                         torch.tensor(scale, dtype=torch.float32))
    np.testing.assert_array_equal(got_t.numpy(), ref)


def test_quantize_act_divides_where_jitted_jax_multiplies(rng):
    """Under ``jit`` XLA rewrites the JAX function's division by a constant
    scale into a multiply by the f32 reciprocal, which moves some values at
    a level's edge to the next level. The port keeps the division the
    function is written with (and runs eagerly)."""
    s = 0.1234567891234
    x = (rng.standard_normal(200000) * 5).astype(np.float32)
    eager = np.asarray(jax_int8.quantize_act(jnp.asarray(x), s))
    jitted = np.asarray(jax.jit(lambda v: jax_int8.quantize_act(v, s))(jnp.asarray(x)))
    recip = np.clip(np.round(x * np.float32(1.0 / s)), -127, 127).astype(np.int8)
    got = quantize_act(torch.from_numpy(x), s).numpy()
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_array_equal(jitted, recip)
    assert (got != jitted).any()


# -- B8 ------------------------------------------------------------------------
def _w8a8_inputs(rng, m_shape, k, n):
    x_q = rng.integers(-127, 128, (*m_shape, k)).astype(np.int8)
    w_q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    cs = (rng.random(n) * 2e-3 + 1e-5).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return x_q, w_q, cs, b


# (M shape, K, N): 2-D and NHWC with M = 96 (the Pallas grid runs), 2-D and
# NHWC with a ragged M of 100 and 35 (JAX takes its XLA path there)
_W8A8_SHAPES = [((96,), 64, 48), ((2, 4, 12), 32, 40), ((100,), 48, 24), ((1, 5, 7), 96, 64)]


@pytest.mark.parametrize("quantize_out", [False, True])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m_shape,k,n", _W8A8_SHAPES)
def test_pw_conv_w8a8_bit_equal_to_jax(rng, m_shape, k, n, relu, quantize_out):
    x_q, w_q, cs, b = _w8a8_inputs(rng, m_shape, k, n)
    before = launch_counts()
    got = pw_conv_w8a8(*(torch.from_numpy(a) for a in (x_q, w_q, cs, b)), relu=relu,
                       quantize_out=quantize_out)
    assert launch_counts() == before  # the CPU path runs the plain version, no kernel
    assert got.dtype == (torch.int8 if quantize_out else torch.bfloat16)
    assert tuple(got.shape) == (*m_shape, n)
    args = tuple(jnp.asarray(a) for a in (x_q, w_q, cs, b))
    for interpret in (False, True):  # XLA path, then the Pallas kernel body interpreted
        ref = jax_int8.pw_conv_w8a8(*args, relu=relu, quantize_out=quantize_out,
                                    interpret=interpret)
        np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("quantize_out", [False, True])
@pytest.mark.parametrize("m_shape,k,n", _W8A8_SHAPES)
def test_pw_conv_w8a8_bf16_bias_bit_equal_to_jax(rng, m_shape, k, n, quantize_out):
    """A bias stored in bf16, as the kernel reads it without a cast: the
    plain version's ``acc · cs + b`` in f32 with b widened exactly, the JAX
    function's likewise, through its XLA path and its Pallas kernel."""
    x_q, w_q, cs, b = _w8a8_inputs(rng, m_shape, k, n)
    b16 = torch.from_numpy(b * 8).to(torch.bfloat16)
    got = pw_conv_w8a8(*(torch.from_numpy(a) for a in (x_q, w_q, cs)), b16,
                       relu=not quantize_out, quantize_out=quantize_out)
    args = tuple(jnp.asarray(a) for a in (x_q, w_q, cs)) + (jnp.asarray(b16.float().numpy(),
                                                                        jnp.bfloat16),)
    for interpret in (False, True):
        ref = jax_int8.pw_conv_w8a8(*args, relu=not quantize_out, quantize_out=quantize_out,
                                    interpret=interpret)
        np.testing.assert_array_equal(_np(got), _np(ref))


# -- B7 ------------------------------------------------------------------------
@pytest.mark.parametrize("quantize_out", [False, True])
@pytest.mark.parametrize("m_shape,k,n", [((96,), 64, 48), ((2, 4, 12), 128, 40),
                                         ((100,), 32, 24)])
def test_pw_conv_a8_within_one_ulp_of_jax(rng, m_shape, k, n, quantize_out):
    x_q = rng.integers(-127, 128, (*m_shape, k)).astype(np.int8)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * (20.0 if quantize_out else 0.5)).astype(np.float32)
    if quantize_out:
        w *= 4.0  # outputs spread over many int8 levels
    before = launch_counts()
    got = pw_conv_a8(*(torch.from_numpy(a) for a in (x_q, w, b)), quantize_out=quantize_out)
    assert launch_counts() == before
    ref = jax_int8.pw_conv_a8(*(jnp.asarray(a) for a in (x_q, w, b)), quantize_out=quantize_out,
                              interpret=True)
    assert got.dtype == (torch.int8 if quantize_out else torch.bfloat16)
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape == (*m_shape, n)
    if quantize_out:
        assert np.abs(g - r).max() <= 1.0
        assert len(np.unique(r)) > 20
    else:
        limit = _ULP_BF16 * np.maximum(np.abs(g), np.abs(r)) + 1e-30
        assert np.all(np.abs(g - r) <= limit), np.max(np.abs(g - r) - limit)


def test_pw_conv_a8_plain_sums_in_order(rng):
    """The plain version's sum is the in-order f32 sum of exact products,
    checked against a numpy loop in f32."""
    x_q = rng.integers(-127, 128, (37, 48)).astype(np.int8)
    w = (rng.standard_normal((48, 16)) * 0.05).astype(np.float32)
    wb = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    acc = np.zeros((37, 16), np.float32)
    for kk in range(48):
        acc = (acc + x_q[:, kk : kk + 1].astype(np.float32) * wb[kk]).astype(np.float32)
    b = np.zeros(16, np.float32)
    got = pw_conv_a8_reference(torch.from_numpy(x_q), torch.from_numpy(w), torch.from_numpy(b),
                               relu=False)
    np.testing.assert_array_equal(got.float().numpy(),
                                  torch.from_numpy(acc).to(torch.bfloat16).float().numpy())


def _f32_sums(prod, blocks):
    """f32 sums over axis 1 of ``prod`` (M, K, N), one rounding an
    addition: each block of k (a list of index lists) summed in its order,
    then the blocks' sums added in order."""
    acc = np.zeros((prod.shape[0], prod.shape[2]), np.float32)
    for block in blocks:
        part = np.zeros_like(acc)
        for kk in block:
            part = (part + prod[:, kk]).astype(np.float32)
        acc = (acc + part).astype(np.float32)
    return acc


def _a8_products(x_q, w):
    """The exact f32 products x[m, k] * bf16(w)[k, n], as (M, K, N)."""
    wb = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    return x_q.astype(np.float32)[:, :, None] * wb[None, :, :]


@pytest.mark.parametrize("inputs", ["random", "cancelling"])
def test_pw_conv_a8_tolerance_holds_other_summation_orders(rng, inputs):
    """The in-order f32 sum (the plain version's) and the same exact
    products summed k reversed, and in blocks of 16 (as an mma groups them)
    in both block orders, all lie within ``pw_conv_a8_tolerance`` of each
    other; with cancelling inputs (the second half of k is the first with
    the weights negated, so every exact sum is 0 while the partial sums
    are not) as with random ones. The bound is K · 2^-22 · (|x| @ |w|)."""
    m, k, n = 24, 768, 16
    x_q = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    if inputs == "cancelling":
        x_q[:, k // 2:] = x_q[:, : k // 2]
        w[k // 2:] = -w[: k // 2]
    prod = _a8_products(x_q, w)
    tol = pw_conv_a8_tolerance(torch.from_numpy(x_q), torch.from_numpy(w)).numpy()
    assert tol.dtype == np.float64 and tol.shape == (m, n)
    wb = np.abs(torch.from_numpy(w).to(torch.bfloat16).double().numpy())
    np.testing.assert_allclose(tol, (np.abs(x_q.astype(np.float64)) @ wb) * k * 2.0**-22,
                               rtol=1e-12)
    in_order = _f32_sums(prod, [range(k)])
    blocks16 = [range(b, b + 16) for b in range(0, k, 16)]
    others = [_f32_sums(prod, [range(k - 1, -1, -1)]), _f32_sums(prod, blocks16),
              _f32_sums(prod, blocks16[::-1])]
    for other in others:
        diff = np.abs(other.astype(np.float64) - in_order)
        assert np.all(diff <= tol), np.max(diff / tol)
    assert any(np.any(other != in_order) for other in others)  # the orders do differ
    if inputs == "cancelling":
        assert np.abs(prod.sum(axis=1, dtype=np.float64)).max() == 0.0


def test_pw_conv_a8_tolerance_catches_a_sum_beyond_it(rng):
    """An output moved a few f32 ulps beyond the bound from the in-order
    sum is outside it, at every output."""
    m, k, n = 16, 384, 8
    x_q = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    in_order = _f32_sums(_a8_products(x_q, w), [range(k)])
    tol = pw_conv_a8_tolerance(torch.from_numpy(x_q), torch.from_numpy(w)).numpy()
    for sign in (1.0, -1.0):
        moved = (in_order.astype(np.float64) + sign * tol).astype(np.float32)
        for _ in range(3):
            moved = np.nextafter(moved, np.float32(sign * np.inf))
        assert np.all(np.abs(moved.astype(np.float64) - in_order) > tol)


# config C's 23 int8 sites of a 1024x2048 frame, (M, K, N), as
# chip_smoke.py::int8_sites reads them from the serving graph
_FRAME_SITES = {
    **{f"bottleneck1/{i}/expand": (32768 if i == 0 else 8192, 64, 384) for i in range(3)},
    **{f"bottleneck1/{i}/project": (8192, 384, 64) for i in range(3)},
    "bottleneck2/0/expand": (8192, 64, 384), "bottleneck2/0/project": (2048, 384, 96),
    **{f"bottleneck2/{i}/expand": (2048, 96, 576) for i in (1, 2)},
    **{f"bottleneck2/{i}/project": (2048, 576, 96) for i in (1, 2)},
    "bottleneck3/0/expand": (2048, 96, 576), "bottleneck3/0/project": (2048, 576, 128),
    **{f"bottleneck3/{i}/expand": (2048, 128, 768) for i in (1, 2)},
    **{f"bottleneck3/{i}/project": (2048, 768, 128) for i in (1, 2)},
    "ppm/out": (2048, 256, 128),
    "ffm/conv_lower_res": (32768, 128, 128), "ffm/conv_higher_res": (32768, 64, 128),
    "cls/dsconv1/pw": (32768, 128, 128), "cls/dsconv2/pw": (32768, 128, 128),
}


def test_frame_sites_are_config_cs_23():
    assert len(_FRAME_SITES) == 23


@pytest.mark.parametrize("site", sorted(_FRAME_SITES))
def test_pw_a8_plan_at_a_frames_sites(site):
    """B7's plan: a block tile the kernel is built for, a grid whose tiles
    cover M and N once, at least 100 blocks (128 at the smallest), the
    128 × 128 tile at the M = 32,768 sites and at M = 8,192 with N = 384,
    64 × 64 at M = 2,048 with N of 576 or more, 32 × 64 elsewhere. A
    function of the shape alone."""
    m, k, n = _FRAME_SITES[site]
    plan = pw_a8_plan(m, k, n)
    assert plan == pw_a8_plan.__wrapped__(m, k, n)
    assert (plan.bm, plan.bn, plan.threads) == PW_A8_TILES[plan.tile]
    gx, gy = plan.grid
    assert (gx - 1) * plan.bn < n <= gx * plan.bn and (gy - 1) * plan.bm < m <= gy * plan.bm
    assert gx * gy >= 128 and gy <= 65535
    want = {32768: 0, 8192: 0 if n == 384 else 2, 2048: 1 if n >= 576 else 2}[m]
    assert plan.tile == want
    assert pw_a8_plan(m, k, n, tile=2).grid == (-(-n // 64), -(-m // 32))


def test_pw_a8_plan_refuses_what_the_kernel_does_not_build():
    """Only the three block tiles are built, and an empty product has no
    plan."""
    with pytest.raises(ValueError, match="no tile"):
        pw_a8_plan(64, 32, 64, tile=3)
    with pytest.raises(ValueError, match="empty"):
        pw_a8_plan(0, 32, 64)
    with pytest.raises(ValueError, match="row tiles"):
        pw_a8_plan(32 * 65536, 32, 64, tile=2)


# config D's 25 int8 sites: config C's 23 and the LTD's two 1x1s, which C
# runs inside B5
_D_SITES = {**_FRAME_SITES, "ltd/dsconv1/pw": (131072, 32, 48),
            "ltd/dsconv2/pw": (32768, 48, 64)}


def test_config_d_has_25_sites():
    assert len(_D_SITES) == 25 and set(_D_SITES) >= set(_FRAME_SITES)


@pytest.mark.parametrize("site", sorted(_D_SITES))
def test_pw_w8a8_plan_at_config_ds_sites(site):
    """B8's plan: a block tile the kernel is built for, a grid whose tiles
    cover M and N once, the streaming 128 × 64 tile at the LTD's short-K
    sites and B7's tile by B7's rule elsewhere, so at least 128 blocks (a
    block for 128 of the H100's 132 SMs at M = 2,048 with N of 96 or 128,
    where that measured fastest; 192 or more elsewhere). A function of the
    shape alone."""
    m, k, n = _D_SITES[site]
    plan = pw_w8a8_plan(m, k, n)
    assert plan == pw_w8a8_plan.__wrapped__(m, k, n)
    assert (plan.bm, plan.bn, plan.threads) == PW_W8A8_TILES[plan.tile]
    gx, gy = plan.grid
    assert (gx - 1) * plan.bn < n <= gx * plan.bn and (gy - 1) * plan.bm < m <= gy * plan.bm
    assert gx * gy >= (128 if m == 2048 and n <= 128 else 192) and gy <= 65535
    if site.startswith("ltd/"):
        assert plan.tile == 3 and (plan.bm, plan.bn) == (128, 64)
    else:
        assert plan.tile == pw_a8_plan(m, k, n).tile
        assert PW_W8A8_TILES[plan.tile] == PW_A8_TILES[plan.tile]
    assert pw_w8a8_plan(m, k, n, tile=2).grid == (-(-n // 64), -(-m // 32))


def test_pw_w8a8_plan_refuses_what_the_kernel_does_not_build():
    """Only the four block tiles are built, and an empty product has no
    plan."""
    with pytest.raises(ValueError, match="no tile"):
        pw_w8a8_plan(64, 32, 64, tile=4)
    with pytest.raises(ValueError, match="no tile"):
        pw_w8a8_plan(64, 32, 64, tile=-1)
    with pytest.raises(ValueError, match="empty"):
        pw_w8a8_plan(64, 0, 64)
    with pytest.raises(ValueError, match="row tiles"):
        pw_w8a8_plan(128 * 65536, 32, 48)


def test_int8_wrappers_refuse_other_devices_and_bad_args():
    """The operators' CUDA implementations raise for a tensor that is not
    on CUDA (no fallback); a ``meta`` tensor takes the fake implementation
    (the output's shape and dtype, nothing launched); bad arguments raise
    on the CPU."""
    from fastscnn_tpu_torch.ops.cuda.int8_pw import _pw_conv_a8_cuda, _pw_conv_w8a8_cuda

    x = torch.zeros((1, 2, 3, 8), dtype=torch.int8, device="meta")
    a8 = (x, torch.zeros((8, 4), device="meta"), torch.zeros(4, device="meta"))
    w8a8 = (x, torch.zeros((8, 4), dtype=torch.int8, device="meta"),
            torch.zeros(4, device="meta"), torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        _pw_conv_a8_cuda(*a8, True, False, None)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        _pw_conv_w8a8_cuda(*w8a8, True, False, None)
    before = (pw_conv_a8.launches, pw_conv_w8a8.launches)
    for out, dtype in ((pw_conv_a8(*a8), torch.bfloat16),
                       (pw_conv_w8a8(*w8a8, quantize_out=True), torch.int8)):
        assert out.device.type == "meta" and out.shape == (1, 2, 3, 4) and out.dtype == dtype
    assert (pw_conv_a8.launches, pw_conv_w8a8.launches) == before
    xc = torch.zeros((5, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 activations"):
        pw_conv_a8(xc.float(), torch.zeros((8, 4)), torch.zeros(4))
    with pytest.raises(ValueError, match="channels"):
        pw_conv_a8(xc, torch.zeros((6, 4)), torch.zeros(4))
    with pytest.raises(ValueError, match="int8 weights"):
        pw_conv_w8a8(xc, torch.zeros((8, 4)), torch.zeros(4), torch.zeros(4))


# -- calibration, the int8 model, the hook ---------------------------------------
@pytest.fixture(scope="module")
def shared():
    """JAX (params, state) with perturbed BN statistics, the port model
    loaded from them, a calibration batch and a test batch (f32 NHWC)."""
    params, state = jax_init(jax.random.PRNGKey(3), 19, aux=False)
    rng = np.random.default_rng(3)

    def perturb(path, v):
        name = jax.tree_util.keystr(path)
        if "mean" in name:
            return jnp.asarray(rng.uniform(-0.1, 0.1, v.shape), v.dtype)
        if "var" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5, v.shape), v.dtype)
        return v

    state = jax.tree_util.tree_map_with_path(perturb, state)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    model = FastSCNN(19)
    model.load_state_dict(from_jax_params(np_tree(params), np_tree(state)), strict=True)
    calib = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    x = rng.standard_normal((1, 64, 96, 3)).astype(np.float32)
    return params, state, model.eval(), calib, x


@pytest.fixture(scope="module")
def scales(shared):
    params, state, model, calib, _ = shared
    jscales = jax_calibrate(JaxFastSCNN(19), jax_fold(params, state, jnp.float32), [calib])
    pscales = calibrate_pw_scales(model, fold_inference_params(model, torch.float32),
                                  [torch.from_numpy(calib)])
    return jscales, pscales


def test_calibrate_pw_scales_matches_jax(scales):
    """The same 25 sites as JAX; scales within 1e-6 relative (the two
    graphs' f32 convs sum in different orders; measured ≤ 3e-7)."""
    jscales, pscales = scales
    assert PW_INT8_SITES == JAX_SITES
    assert [k for k, _ in pscales] == [k for k, _ in jscales] == sorted(PW_INT8_SITES)
    j, p = np.array([v for _, v in jscales]), np.array([v for _, v in pscales])
    assert np.all(p > 0)
    np.testing.assert_allclose(p, j, rtol=1e-6)
    hash(pscales)


@pytest.mark.parametrize("impl", ["fused-ds", "fused-ds-mr"])
def test_calibrate_rejects_unreached_sites(shared, impl):
    """With a fused DSConv the LTD's 1×1s run inside the kernel, so
    calibration never reaches them — as in JAX."""
    params, state, model, calib, _ = shared
    with pytest.raises(ValueError, match="ltd/dsconv1/pw"):
        jax_calibrate(JaxFastSCNN(19, folded_dw_impl=impl), jax_fold(params, state, jnp.float32),
                      [calib])
    m = model.with_options(folded_dw_impl=impl)
    with pytest.raises(ValueError, match="ltd/dsconv1/pw"):
        calibrate_pw_scales(m, fold_inference_params(m, torch.float32), [calib])


def test_quantized_model_rejects_unknown_impl(shared):
    with pytest.raises(ValueError, match="unknown int8 pw impl"):
        quantized_model(shared[2], (), "int4")
    with pytest.raises(ValueError, match="folded_pw_impl"):
        FastSCNN(19, folded_pw_impl="int4")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["int8-a8", "int8-w8a8"])
def test_quantized_model_matches_jax(shared, scales, impl, dtype):
    """The int8 model (folded_dw_impl 'conv', every site int8) against the
    JAX int8 model on the same weights, scales and input, in f32 and bf16
    folds, logits at the input size. Both return bf16 logits, even from
    the f32 fold (the int8 sites emit bf16, and later ops promote as the
    JAX graph does). Measured: max |diff| 7.8e-3 of max |logit| (1.2e-2 for
    w8a8 in bf16: one or two bf16 ulps near the largest logit) and argmax
    agreement 1.0; the graphs
    differ by the rounding order of their convs, which may move an
    activation across an int8 level."""
    params, state, model, _, x = shared
    jscales, _ = scales
    jfolded = jax_fold(params, state, getattr(jnp, dtype))
    ref = jax_quantized(JaxFastSCNN(19), jscales, impl).apply_folded(
        jfolded, jnp.asarray(x, getattr(jnp, dtype)))[0]
    qm = quantized_model(model, jscales, impl)
    with torch.no_grad():
        got = qm.apply_folded(fold_inference_params(model, getattr(torch, dtype)),
                              torch.from_numpy(x).to(getattr(torch, dtype)))[0]
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape == (*x.shape[:3], 19)
    assert np.abs(g - r).max() <= 0.08 * np.abs(r).max()
    agree = (g.argmax(-1) == r.argmax(-1)).mean()
    assert agree >= 0.98, f"mask agreement {agree:.4f}"


class _SiteFakeQuant:
    """Quant-dequant at the given sites (the value grid the int8 kernels
    see); written once for both frameworks' arrays."""

    def __init__(self, scales, xp):
        self.scales, self.xp = dict(scales), xp

    def __call__(self, y, site=None):
        s = self.scales.get(site)
        if s is None:
            return y
        if self.xp is torch:
            q = torch.clamp(torch.round(y.float() / torch.tensor(s, dtype=torch.float32)), -127, 127)
            return (q * torch.tensor(s, dtype=torch.float32)).to(y.dtype)
        q = jnp.clip(jnp.round(y.astype(jnp.float32) / s), -127, 127)
        return (q * s).astype(y.dtype)


def test_act_fake_quant_sites_and_simulation_match_jax(shared, scales):
    """The hook sees the JAX site names, in the JAX order, and the
    site-keyed fake-quant simulation agrees with JAX's (f32, within 1e-5
    of max |logit|: measured 2.4e-7)."""
    params, state, model, _, x = shared
    jscales, _ = scales
    jfolded = jax_fold(params, state, jnp.float32)
    pfolded = fold_inference_params(model, torch.float32)
    seen = {"jax": [], "port": []}

    def recorder(key):
        def hook(y, site=None):
            seen[key].append(site)
            return y
        return hook

    jm = dataclasses.replace(JaxFastSCNN(19), act_fake_quant=recorder("jax"))
    jm.apply_folded(jfolded, jnp.asarray(x), upsample_outputs=False)
    with torch.no_grad():
        model.with_options(act_fake_quant=recorder("port")).apply_folded(
            pfolded, torch.from_numpy(x), upsample_outputs=False)
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 45
    assert set(PW_INT8_SITES) <= set(seen["port"])

    ref = dataclasses.replace(JaxFastSCNN(19), act_fake_quant=_SiteFakeQuant(jscales, jnp)) \
        .apply_folded(jfolded, jnp.asarray(x), upsample_outputs=False)[0]
    with torch.no_grad():
        got = model.with_options(act_fake_quant=_SiteFakeQuant(jscales, torch)).apply_folded(
            pfolded, torch.from_numpy(x), upsample_outputs=False)[0]
    g, r = _np(got), _np(ref)
    assert np.abs(g - r).max() / np.abs(r).max() < 1e-5


def test_site_less_hook_and_with_options_share_weights(shared):
    """A ``y -> y`` hook without a site argument is called at every conv
    input; ``with_options`` shares the weights and leaves the original's
    options alone."""
    _, _, model, _, x = shared
    calls = []
    hooked = model.with_options(act_fake_quant=lambda y: calls.append(1) or y)
    assert model.act_fake_quant is None and hooked.act_fake_quant is not None
    assert hooked.learning_to_downsample is model.learning_to_downsample
    folded = fold_inference_params(model, torch.float32)
    with torch.no_grad():
        a = hooked.apply_folded(folded, torch.from_numpy(x))[0]
        b = model.apply_folded(folded, torch.from_numpy(x))[0]
    assert len(calls) == 45
    assert torch.equal(a, b)
    with pytest.raises(TypeError, match="not an option"):
        model.with_options(num_classes=3)


@pytest.mark.parametrize("config", ["C", "D"])
def test_serving_configs_route_their_sites(shared, scales, monkeypatch, config):
    """Config C (fused-ds-mr + int8-a8) calls B5 twice and B7 at 23 sites:
    its LTD 1×1s run inside B5. Config D (pallas + int8-w8a8) calls B4
    twice and B8 at 25 sites. Counted by wrapping the model's kernel
    calls (on the CPU no kernel launches)."""
    _, _, model, _, x = shared
    _, pscales = scales
    calls = {}

    def counting(name):
        fn = getattr(port_model_module, name)

        def wrapped(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapped

    for name in ("ds_conv3x3_pw", "ds_conv3x3_pw_multirow", "dw_conv3x3", "pw_conv_a8",
                 "pw_conv_w8a8", "quantize_act"):
        monkeypatch.setattr(port_model_module, name, counting(name))
    dw_impl, pw_impl, want = {
        "C": ("fused-ds-mr", "int8-a8", {"ds_conv3x3_pw_multirow": 2, "pw_conv_a8": 23,
                                         "quantize_act": 23}),
        "D": ("pallas", "int8-w8a8", {"dw_conv3x3": 2, "pw_conv_w8a8": 25, "quantize_act": 25}),
    }[config]
    qm = quantized_model(model.with_options(folded_dw_impl=dw_impl), pscales, pw_impl)
    folded = fold_inference_params(model, torch.bfloat16)
    with torch.no_grad():
        out = qm.apply_folded(folded, torch.from_numpy(x).to(torch.bfloat16))[0]
    assert calls == want
    assert out.shape == (1, 64, 96, 19) and torch.isfinite(out.float()).all()
    # the weight folds are made once per site and reused on the next call
    cached = {site: hit[2] for site, hit in qm._int8_weights.items()}
    with torch.no_grad():
        qm.apply_folded(folded, torch.from_numpy(x).to(torch.bfloat16))
    assert len(cached) == want.get("pw_conv_a8", 0) + want.get("pw_conv_w8a8", 0)
    assert all(qm._int8_weights[site][2] is v for site, v in cached.items())
