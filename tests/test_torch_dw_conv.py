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
from fastscnn_tpu_torch.ops.cuda.dw_conv import (
    _ds_conv3x3_pw_cuda,
    _ds_conv3x3_pw_multirow_cuda,
    _dw_conv3x3_cuda,
    _mr_args,
    _mr_smem_bytes,
    ds_plan,
    dw_fwd_plan,
    mr_plan,
    vec_width,
)

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
    """A block of the LTD's two sites in bf16, at the plan's 4 rows by 32
    columns, holds two input slots of 9 x 65 pixels, two strips' f32 dw
    activations and the f32 weights in 115,264 and 175,936 bytes: it fits
    an SM's 227 KB. Eight rows would not at dsconv2 (C = 48, 324,928
    bytes). The wrapper refuses a bad rows_per_step, and the operator's
    CUDA implementation a tensor that is not on CUDA (a ``meta`` tensor
    takes the operator's fake implementation: the output's shape)."""
    assert _mr_smem_bytes(32, 48, 4, 32, 2, 2) == 115264
    assert _mr_smem_bytes(48, 64, 4, 32, 2, 2) == 175936
    assert _mr_smem_bytes(48, 64, 8, 32, 2, 2) == 324928
    for smem in (115264, 175936):
        assert smem + 1024 <= 232448
    x = torch.zeros((1, 64, 64, 48), device="meta")
    with pytest.raises(ValueError, match="rows_per_step"):
        ds_conv3x3_pw_multirow(torch.zeros((1, 8, 8, 4)), torch.zeros((3, 3, 1, 4)),
                               torch.zeros(4), torch.zeros((1, 1, 4, 6)), torch.zeros(6),
                               rows_per_step=0)
    args = (x, torch.zeros((3, 3, 1, 48), device="meta"), torch.zeros(48, device="meta"),
            torch.zeros((1, 1, 48, 64), device="meta"), torch.zeros(64, device="meta"))
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        _ds_conv3x3_pw_multirow_cuda(*args, 2, 1, 8, None, None, None)
    out = ds_conv3x3_pw_multirow(*args, stride=2)
    assert out.device.type == "meta" and out.shape == (1, 32, 32, 64)


def _covered_once(spans, n):
    """Each of 0..n-1 lies in exactly one of the [lo, hi) spans."""
    hits = np.zeros(n, dtype=int)
    for lo, hi in spans:
        hits[max(lo, 0):min(hi, n)] += 1
    return bool((hits == 1).all())


# (N, H, W, C, Cout, stride): the serving sites, odd and even sizes at
# strides 1 and 2, a C that takes VEC 1 and a long image
_MR_SHAPES = [
    (1, 511, 1023, 32, 48, 2), (1, 256, 512, 48, 64, 2),
    (2, 17, 139, 3, 19, 2), (1, 9, 149, 129, 19, 1), (2, 16, 22, 12, 64, 2),
    (3, 15, 13, 8, 48, 1), (1, 1, 1, 32, 8, 2), (1, 2000, 40, 16, 16, 1),
]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", _MR_SHAPES)
def test_mr_plan_covers_every_output_once(shape, itemsize):
    """B5's plan: each output row lies in exactly one strip of one block's
    run and each output column in one tile; a block holds at most 256
    threads: one per 8 output channels (x) by a pixel-group stride that
    divides the strip's pixel groups (y); its shared memory is the
    kernel's and fits 227 KB; the grid stays within CUDA's limits. The
    same holds at rows_per_step 1 to 8 and at overrides of rows, tile and
    strips; the plan's rows never exceed rows_per_step. A function of the
    shape alone."""
    n, h, w, c, cout, stride = shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    plans = [mr_plan(n, ho, wo, c, cout, stride, itemsize, rps) for rps in (1, 2, 3, 8)]
    plans += [mr_plan(n, ho, wo, c, cout, stride, itemsize, rows=r, tile=t, strips=s)
              for r, t, s in ((1, 4, 1), (3, 8, 5), (2, 16, 2))]
    assert plans[-1] == mr_plan.__wrapped__(n, ho, wo, c, cout, stride, itemsize, rows=2,
                                            tile=16, strips=2)
    for rps, plan in zip((1, 2, 3, 8), plans):
        assert plan.rows <= rps
    for plan in plans:
        (bx, by), (gx, gy, gz) = plan.block, plan.grid
        assert (bx - 1) * 8 < cout <= bx * 8 and bx * by <= 256
        assert (plan.rows * plan.tile // 4) % by == 0 and by & (by - 1) == 0
        assert plan.smem == _mr_smem_bytes(c, cout, plan.rows, plan.tile, stride, itemsize)
        assert plan.smem <= 227 * 1024 and plan.tile % 4 == 0
        assert gz == n and gy <= 65535
        assert _covered_once([(t * plan.tile, (t + 1) * plan.tile) for t in range(gx)], wo)
        nstrips = -(-ho // plan.rows)
        strips = [s for y in range(gy)
                  for s in range(y * plan.strips, min((y + 1) * plan.strips, nstrips))]
        assert strips == list(range(nstrips))
        assert _covered_once([(s * plan.rows, (s + 1) * plan.rows) for s in strips], ho)


def test_mr_plan_at_the_serving_sites():
    """At the LTD's two sites in bf16 the plan takes 32-column tiles of 4
    rows (128 pixels a strip) and 4 and 2 strips a block: grids of 256
    and 128 blocks, at most one wave of two blocks on each of 132 SMs,
    and at least two strips a block. In f32 at dsconv2 the slots are twice
    as large and 4 rows do not fit; the plan takes 2."""
    p1 = mr_plan(1, 256, 512, 32, 48, 2, 2)
    p2 = mr_plan(1, 128, 256, 48, 64, 2, 2)
    assert (p1.tile, p1.rows, p1.strips, p1.grid, p1.block) == (32, 4, 4, (16, 16, 1), (6, 32))
    assert (p2.tile, p2.rows, p2.strips, p2.grid, p2.block) == (32, 4, 2, (8, 16, 1), (8, 32))
    f2 = mr_plan(1, 128, 256, 48, 64, 2, 4)
    assert (f2.tile, f2.rows) == (32, 2) and f2.smem <= 227 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        mr_plan(1, 64, 64, 2048, 2048, 2, 4)
    with pytest.raises(ValueError, match="output channels"):
        mr_plan(1, 8, 8, 4, 2049, 2, 2)
    with pytest.raises(ValueError, match="tile"):
        mr_plan(1, 8, 8, 4, 8, 2, 2, tile=6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ds_conv3x3_pw_multirow_rows_per_step_changes_no_result(rng, dtype):
    """rows_per_step bounds the rows a strip stages, and the plan
    overrides pick another launch; none of them changes the result."""
    a = _inputs(rng, (2, 19, 23, 16), 24)
    args = (torch.from_numpy(a["x"]).to(getattr(torch, dtype)),
            *(torch.from_numpy(a[k]) for k in ("w", "b", "w_pw", "b_pw")))
    ref = ds_conv3x3_pw_multirow(*args, stride=2, padding=1)
    for kw in ({"rows_per_step": 1}, {"rows_per_step": 3}, {"rows_per_step": 16},
               {"rows": 2, "tile": 8, "strips": 3}):
        assert torch.equal(ds_conv3x3_pw_multirow(*args, stride=2, padding=1, **kw), ref)


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_ds_conv3x3_pw_multirow_hands_the_kernel_weights_as_stored(rng, wdtype):
    """B5's `_mr_args` passes the weights and biases as they are
    stored, each with its own dtype code (0 f32, 1 bf16): the pointers are
    those of the caller's tensors, so the wrapper makes no cast and no
    copy. Only another dtype is widened to f32."""
    a = _inputs(rng, (1, 9, 11, 16), 24)
    x = torch.from_numpy(a["x"]).to(torch.bfloat16)
    ws = [torch.from_numpy(a[k]).to(getattr(torch, wdtype)) for k in ("w", "b", "w_pw", "b_pw")]
    plan = mr_plan(1, 5, 6, 16, 24, 2, 2)
    out = torch.empty((1, 5, 6, 24), dtype=torch.bfloat16)
    args, keep = _mr_args(x, *ws, out, 2, 1, plan)
    code = 1 if wdtype == "bfloat16" else 0
    assert args[:10] == (1, x.data_ptr(), code, ws[0].data_ptr(), code, ws[1].data_ptr(), code,
                         ws[2].data_ptr(), code, ws[3].data_ptr())
    assert args[10] == out.data_ptr() and args[11:20] == (1, 9, 11, 16, 24, 5, 6, 2, 1)
    assert args[20:] == (8, plan.rows, plan.tile, plan.strips, *plan.block, 1)
    assert [k.data_ptr() for k in keep] == [t.data_ptr() for t in ws]
    half = [t.half() for t in ws]
    args16, keep16 = _mr_args(x, *half, out, 2, 1, plan)
    assert all(k.dtype == torch.float32 for k in keep16) and args16[2] == 0


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
    """The wrappers never fall back to the plain version for a device
    tensor: their operators have implementations for the CPU (the plain
    version), CUDA (the kernel) and ``meta`` (the fake: the output's shape,
    nothing launched) and for no other device, and the CUDA implementation
    raises for a tensor that is not on CUDA."""
    x = torch.empty((1, 5, 5, 4), device="meta")
    w = torch.empty((3, 3, 1, 4), device="meta")
    b = torch.empty((4,), device="meta")
    name = "dw_conv3x3" if fn == "dw" else "ds_conv3x3_pw"
    keys = [k for k in ("CPU", "CUDA", "Meta", "XPU", "MPS", "CompositeImplicitAutograd")
            if torch._C._dispatch_has_kernel_for_dispatch_key(f"fastscnn::{name}", k)]
    assert keys == ["CPU", "CUDA", "Meta"]
    before = (dw_conv3x3.launches, ds_conv3x3_pw.launches)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        if fn == "dw":
            _dw_conv3x3_cuda(x, w, b, 2, 1, False, None, None)
        else:
            _ds_conv3x3_pw_cuda(x, w, b, torch.empty((1, 1, 4, 6), device="meta"),
                                torch.empty((6,), device="meta"), 2, 1, None)
    if fn == "dw":
        out = dw_conv3x3(x, w, b, stride=2)
    else:
        out = ds_conv3x3_pw(x, w, b, torch.empty((1, 1, 4, 6), device="meta"),
                            torch.empty((6,), device="meta"), stride=2)
    assert out.device.type == "meta" and out.shape == (1, 3, 3, 4 if fn == "dw" else 6)
    assert (dw_conv3x3.launches, ds_conv3x3_pw.launches) == before


def test_dw_wrappers_reject_bad_weights():
    x = torch.zeros((1, 5, 5, 4))
    with pytest.raises(ValueError, match="3,3,1,C"):
        dw_conv3x3(x, torch.zeros((3, 3, 1, 5)))
    with pytest.raises(ValueError, match="stride"):
        dw_conv3x3(x, torch.zeros((3, 3, 1, 4)), stride=3)
    with pytest.raises(ValueError, match="pw weights"):
        ds_conv3x3_pw(x, torch.zeros((3, 3, 1, 4)), torch.zeros(4), torch.zeros((1, 1, 5, 6)),
                      torch.zeros(6))


# B3's launch plan at the main path's four sites: (N, Ho, Wo, C, Cout), then
# the rows a block and the shared memory the plan gives them
_DS_SITES = {
    "serving dsconv1": ((1, 256, 512, 32, 48), 8, 73152),
    "serving dsconv2": ((1, 128, 256, 48, 64), 2, 39040),
    "training dsconv1": ((16, 192, 192, 32, 48), 8, 73152),
    "training dsconv2": ((16, 96, 96, 48, 64), 8, 112768),
}


@pytest.mark.parametrize("site", sorted(_DS_SITES))
def test_ds_plan_at_the_main_path_sites(site):
    """B3's plan: one thread column per 8 output channels, a pixel-group
    stride that is a power of two dividing the block's pixel groups (every
    thread makes as many), at most 256 threads; the grid covers every
    output row and column once and holds at least 256 blocks (0.9 of a
    wave of two blocks an SM); the shared memory is the 9 taps and bias,
    the 1×1 weights and bias padded to 8 channels and the block's dw
    activation, in f32, within 227 KB. A function of the shape alone."""
    (n, ho, wo, c, cout), rows, smem = _DS_SITES[site]
    plan = ds_plan(n, ho, wo, c, cout)
    assert plan == ds_plan.__wrapped__(n, ho, wo, c, cout)
    assert (plan.rows, plan.smem) == (rows, smem)
    (bx, by), (gx, gy, gz) = plan.block, plan.grid
    assert (bx - 1) * 8 < cout <= bx * 8 and bx * by <= 256
    pix_groups = rows * 64 // 4
    assert pix_groups % by == 0 and by & (by - 1) == 0
    assert by == pix_groups or bx * by * 2 > 256
    assert (gx - 1) * 64 < wo <= gx * 64 and (gy - 1) * rows < ho <= gy * rows and gz == n
    assert gx * gy * gz >= 256 and smem <= 227 * 1024
    assert smem == 4 * (10 * c + c * bx * 8 + bx * 8 + c * rows * 64)
    for r in (1, 3, 4):  # rows given to time alternatives
        alt = ds_plan(n, ho, wo, c, cout, rows=r)
        assert alt.rows == r and (alt.grid[1] - 1) * r < ho <= alt.grid[1] * r


def test_ds_conv3x3_pw_refuses_what_does_not_fit():
    """A shape whose block needs more than 227 KB of shared memory, or more
    output channels than 256 threads of 8 cover, is refused before any
    launch."""
    def meta(*shape):
        return torch.zeros(shape, device="meta")

    with pytest.raises(ValueError, match="shared memory"):  # the operator's CUDA implementation
        _ds_conv3x3_pw_cuda(meta(1, 64, 64, 512), meta(3, 3, 1, 512), meta(512),
                            meta(1, 1, 512, 512), meta(512), 2, 1, None)
    with pytest.raises(ValueError, match="output channels"):
        ds_plan(1, 8, 8, 4, 2049)
    with pytest.raises(ValueError, match="rows"):
        ds_plan(1, 8, 8, 4, 8, rows=0)
    assert ds_plan(1, 32, 32, 512, 512).smem > 227 * 1024
