"""Kernels B3, B4 and B5 (``fastscnn_tpu_torch/ops/cuda/dw_conv.py``): their
plain PyTorch versions, which the wrappers run for CPU tensors, against
the JAX package's Pallas kernels run in the Pallas interpreter. B5's plain
version is B3's, so their CPU results are bit-equal by construction.

Tolerances: in f32 the two sum the 9 taps (and the 1×1's channels) in a
different order, so 1e-5. In bf16 both accumulate in f32 and round once
at the end, so B4 may differ by one bf16 ulp (2^-7 relative); B3 rounds
twice (the dw activation, then the output), so two ulps. The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``: a CUDA kernel has no interpreter on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastscnn_tpu.ops.pallas.dw_conv import (
    ds_conv3x3_pw_pallas,
    ds_conv3x3_pw_pallas_multirow,
    dw_conv3x3_pallas,
)
from fastscnn_tpu_torch.ops.conv import conv2d
from fastscnn_tpu_torch.ops.cuda import ds_conv3x3_pw, ds_conv3x3_pw_multirow, dw_conv3x3
from fastscnn_tpu_torch.ops.cuda.dw_conv import _mr_smem_bytes, dw_fwd_plan, vec_width

_ULP_BF16 = 2.0 ** -7


def _close(got: torch.Tensor, ref, dtype, ulps):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        limit = ulps * _ULP_BF16 * np.maximum(np.abs(got), np.abs(ref)) + 1e-6
        assert np.all(np.abs(got - ref) <= limit), np.max(np.abs(got - ref) - limit)


def _inputs(rng, shape, cout=None):
    c = shape[-1]
    arrs = {
        "x": rng.standard_normal(shape),
        "w": rng.standard_normal((3, 3, 1, c)) * 0.3,
        "b": rng.standard_normal(c) * 0.1,
    }
    if cout:
        arrs["w_pw"] = rng.standard_normal((1, 1, c, cout)) * 0.3
        arrs["b_pw"] = rng.standard_normal(cout) * 0.1
    return {k: v.astype(np.float32) for k, v in arrs.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias,relu", [(True, True), (False, False), (True, False)])
@pytest.mark.parametrize("stride,shape", [(2, (2, 11, 13, 8)), (1, (2, 9, 7, 8)), (2, (1, 12, 10, 16))])
def test_dw_conv3x3_plain_matches_pallas_interpret(rng, dtype, bias, relu, stride, shape):
    a = _inputs(rng, shape)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x = torch.from_numpy(a["x"]).to(tdt)
    ref = dw_conv3x3_pallas(
        jnp.asarray(a["x"], jdt), jnp.asarray(a["w"]), jnp.asarray(a["b"]) if bias else None,
        stride=stride, padding=1, relu=relu, interpret=True,
    )
    before = dw_conv3x3.launches
    got = dw_conv3x3(x, torch.from_numpy(a["w"]), torch.from_numpy(a["b"]) if bias else None,
                     stride=stride, padding=1, relu=relu)
    assert dw_conv3x3.launches == before  # the CPU path runs the plain version, no kernel
    assert got.dtype == tdt and tuple(got.shape) == tuple(ref.shape)
    _close(got, ref, dtype, ulps=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "stride,shape,cout", [(2, (2, 11, 13, 8), 12), (1, (2, 9, 7, 8), 8), (2, (1, 12, 10, 16), 24)]
)
def test_ds_conv3x3_pw_plain_matches_pallas_interpret(rng, dtype, stride, shape, cout):
    a = _inputs(rng, shape, cout)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ref = ds_conv3x3_pw_pallas(
        jnp.asarray(a["x"], jdt), jnp.asarray(a["w"]), jnp.asarray(a["b"]),
        jnp.asarray(a["w_pw"]), jnp.asarray(a["b_pw"]), stride=stride, padding=1, interpret=True,
    )
    before = ds_conv3x3_pw.launches
    got = ds_conv3x3_pw(
        torch.from_numpy(a["x"]).to(tdt), *(torch.from_numpy(a[k]) for k in ("w", "b", "w_pw", "b_pw")),
        stride=stride, padding=1,
    )
    assert ds_conv3x3_pw.launches == before
    assert got.dtype == tdt and tuple(got.shape) == tuple(ref.shape)
    _close(got, ref, dtype, ulps=2)


def test_ds_conv3x3_pw_plain_matches_unfused_port_graph(rng):
    """f32: the fused DSConv equals the port's own unfolded composition
    (cuDNN-style conv2d + bias + ReLU twice), as the serving graph uses it."""
    a = _inputs(rng, (2, 11, 13, 8), 12)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    mid = torch.relu(conv2d(t["x"], t["w"], t["b"], stride=2, padding=1, groups=8))
    ref = torch.relu(conv2d(mid, t["w_pw"], t["b_pw"]))
    got = ds_conv3x3_pw(t["x"], t["w"], t["b"], t["w_pw"], t["b_pw"], stride=2, padding=1)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "stride,shape,cout,rows",
    [
        (2, (1, 31, 20, 32), 48, 4),   # Ho = 16: rows_per_step divides it (the multi-row kernel)
        (2, (2, 18, 12, 8), 12, 4),    # Ho = 9: it does not (JAX falls back to B3)
        (1, (1, 16, 12, 8), 16, 4),    # stride 1
        (2, (1, 13, 9, 16), 24, 8),    # Ho = 7 < rows_per_step
    ],
)
def test_ds_conv3x3_pw_multirow_plain_matches_pallas_interpret(rng, dtype, stride, shape, cout,
                                                               rows):
    """B5 on the CPU: bit-equal to B3's plain version, and within 1e-5 (f32)
    or two bf16 ulps of the JAX multi-row kernel, interpreted."""
    a = _inputs(rng, shape, cout)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ref = ds_conv3x3_pw_pallas_multirow(
        jnp.asarray(a["x"], jdt), jnp.asarray(a["w"]), jnp.asarray(a["b"]),
        jnp.asarray(a["w_pw"]), jnp.asarray(a["b_pw"]), stride=stride, padding=1,
        rows_per_step=rows, interpret=True,
    )
    args = (torch.from_numpy(a["x"]).to(tdt),
            *(torch.from_numpy(a[k]) for k in ("w", "b", "w_pw", "b_pw")))
    before = ds_conv3x3_pw_multirow.launches
    got = ds_conv3x3_pw_multirow(*args, stride=stride, padding=1, rows_per_step=rows)
    assert ds_conv3x3_pw_multirow.launches == before
    assert got.dtype == tdt and tuple(got.shape) == tuple(ref.shape)
    assert torch.equal(got, ds_conv3x3_pw(*args, stride=stride, padding=1))
    _close(got, ref, dtype, ulps=2)


def test_ds_conv3x3_pw_multirow_shared_memory_fits_the_serving_sites():
    """The staged tile of the LTD's two sites at rows_per_step 8 in bf16
    (58,944 and 91,232 bytes) fits two blocks on an SM's 227 KB; the
    wrapper refuses what does not fit one."""
    assert _mr_smem_bytes(32, 48, 2, 8, 2) == 58944
    assert _mr_smem_bytes(48, 64, 2, 8, 2) == 91232
    x = torch.zeros((1, 64, 64, 48), device="meta")
    with pytest.raises(ValueError, match="rows_per_step"):
        ds_conv3x3_pw_multirow(torch.zeros((1, 8, 8, 4)), torch.zeros((3, 3, 1, 4)),
                               torch.zeros(4), torch.zeros((1, 1, 4, 6)), torch.zeros(6),
                               rows_per_step=0)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        ds_conv3x3_pw_multirow(x, torch.zeros((3, 3, 1, 48)), torch.zeros(48),
                               torch.zeros((1, 1, 48, 64)), torch.zeros(64), stride=2)


# VEC of the forward and dW kernels by C: 16-byte accesses where C and
# the pointers allow, and with pointers 4 bytes off a 16-byte boundary
_VEC_ALIGNED = {"bfloat16": {3: 1, 8: 8, 12: 4, 32: 8, 48: 8},
                "float32": {3: 1, 8: 4, 12: 4, 32: 4, 48: 4}}
_VEC_OFFSET = {"bfloat16": {3: 1, 8: 2, 12: 2, 32: 2, 48: 2},
               "float32": {3: 1, 8: 1, 12: 1, 32: 1, 48: 1}}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("c", [3, 8, 12, 32, 48])
@pytest.mark.parametrize("offset", [0, 4])
def test_vec_width_is_a_function_of_c_dtype_and_alignment(dtype, c, offset):
    """The largest VEC (at most 16 bytes) dividing C for which the
    activations are aligned to VEC elements; a view 4 bytes off drops to
    4-byte accesses, one 8 bytes off to 8-byte ones."""
    itemsize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    base = 1 << 20  # a device allocation is 512-byte aligned
    vec = vec_width(c, itemsize, (base + offset, base))
    assert vec == (_VEC_OFFSET if offset else _VEC_ALIGNED)[dtype][c]
    assert c % vec == 0 and (base + offset) % (vec * itemsize) == 0
    assert vec_width(c, itemsize, (base, base + 8)) == min(_VEC_ALIGNED[dtype][c], 8 // itemsize)


def test_vec_width_of_views():
    """A batch slice starts a multiple of C elements in, so it keeps the
    VEC of its C; a contiguous view of a flat buffer one element in drops
    to VEC 1 (2-byte accesses)."""
    x = torch.zeros((3, 7, 9, 12), dtype=torch.bfloat16)
    flat = x.view(-1)[1:1 + 2 * 7 * 9 * 12].view(2, 7, 9, 12)
    for view, want in ((x[1:], 4), (flat, 1)):
        assert view.is_contiguous()
        offset = view.storage_offset() * view.element_size()
        assert vec_width(12, 2, (1024 + offset, 1024)) == want


# (N, H, W, C, stride): the main path's four sites, then the JAX tests' shapes
_FWD_SITES = [
    (1, 511, 1023, 32, 2), (1, 256, 512, 48, 2),    # serving dsconv1, dsconv2
    (16, 383, 383, 32, 2), (16, 192, 192, 48, 2),   # training dsconv1, dsconv2
]
_FWD_SMALL = [(2, 11, 13, 8, 2), (2, 9, 7, 8, 1), (1, 12, 10, 16, 2), (2, 17, 23, 32, 2),
              (1, 9, 11, 48, 1), (1, 5, 5, 3, 2), (1, 4, 4, 2056, 1)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("site", _FWD_SITES + _FWD_SMALL)
def test_dw_fwd_plan_grid(dtype, site):
    """The forward kernel's grid covers every output column group, row
    and channel vector once, within CUDA's limits (block <= 128 threads,
    grid y and z <= 65,535), and gives the main path's four sites more than
    one block per SM of the H100 (132). Its static shared memory, the
    block's 9 taps and bias in f32 (10 x 128 x VEC floats), stays within
    48 KB. The same holds for every column count the kernel is built for
    at the widest VEC and for rows given to the plan. The plan makes 4
    output columns a thread at the widest VEC, 2 at narrower ones."""
    n, h, w, c, stride = site
    itemsize = 2 if dtype == "bfloat16" else 4
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    vec = vec_width(c, itemsize, (1 << 20,) * 2)
    plans = [dw_fwd_plan(n, ho, wo, c, vec, itemsize)]
    if vec * itemsize == 16:
        plans += [dw_fwd_plan(n, ho, wo, c, vec, itemsize, rows, cols)
                  for cols in (2, 3, 4) for rows in (1, 3, 16)]
    for plan in plans:
        (bx, by), (gx, gy, gz), rows = plan.block, plan.grid, plan.rows
        assert 1 <= bx * by <= 128 and gy <= 65535 and gz == n <= 65535 and gx < 2**31
        assert gx == plan.tiles * plan.groups
        assert (plan.groups - 1) * bx < c // vec <= plan.groups * bx
        col_groups = -(-wo // plan.cols)  # each thread makes plan.cols output columns
        assert (plan.tiles - 1) * by < col_groups <= plan.tiles * by
        assert (gy - 1) * rows < ho <= gy * rows
        assert 10 * 128 * vec * 4 <= 48 * 1024
    assert plans[0].rows in (1, 2, 4, 8, 16) and plans[0].cols == (4 if vec * itemsize == 16 else 2)
    assert dw_fwd_plan(n, ho, wo, c, vec, itemsize) == plans[0]
    if site in _FWD_SITES:
        assert plans[0].grid[0] * plans[0].grid[1] * plans[0].grid[2] > 132


def test_dw_fwd_plan_refuses_columns_it_was_not_built_for():
    """3 and 4 output columns a thread exist at the widest VEC only."""
    assert dw_fwd_plan(1, 9, 9, 32, 8, 2, cols=3).cols == 3
    for vec, itemsize, cols in ((4, 2, 3), (2, 4, 4), (8, 2, 5), (8, 2, 1)):
        with pytest.raises(ValueError, match="columns"):
            dw_fwd_plan(1, 9, 9, 32, vec, itemsize, cols=cols)


@pytest.mark.parametrize("fn", ["dw", "ds"])
def test_wrappers_refuse_other_devices(fn):
    """A tensor that is neither on the CPU nor on CUDA raises: the wrappers
    never fall back to the plain version for a device tensor."""
    x = torch.empty((1, 5, 5, 4), device="meta")
    w = torch.empty((3, 3, 1, 4), device="meta")
    b = torch.empty((4,), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        if fn == "dw":
            dw_conv3x3(x, w, b, stride=2)
        else:
            ds_conv3x3_pw(x, w, b, torch.empty((1, 1, 4, 6), device="meta"),
                          torch.empty((6,), device="meta"), stride=2)


def test_dw_wrappers_reject_bad_weights():
    x = torch.zeros((1, 5, 5, 4))
    with pytest.raises(ValueError, match="3,3,1,C"):
        dw_conv3x3(x, torch.zeros((3, 3, 1, 5)))
    with pytest.raises(ValueError, match="stride"):
        dw_conv3x3(x, torch.zeros((3, 3, 1, 4)), stride=3)
    with pytest.raises(ValueError, match="pw weights"):
        ds_conv3x3_pw(x, torch.zeros((3, 3, 1, 4)), torch.zeros(4), torch.zeros((1, 1, 5, 6)),
                      torch.zeros(6))
