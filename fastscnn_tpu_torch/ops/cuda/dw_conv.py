"""Depthwise 3×3 and fused DSConv for the LTD stem: kernels B3–B6.

Counterpart of ``fastscnn_tpu/ops/pallas/dw_conv.py``:

- :func:`ds_conv3x3_pw` (B3) replaces ``ds_conv3x3_pw_pallas``:
  relu(pw1×1(cast(relu(dw3×3(x) + b_dw))) + b_pw), the dw activation
  never leaving the chip;
- :func:`ds_conv3x3_pw_multirow` (B5) replaces
  ``ds_conv3x3_pw_pallas_multirow``: B3's function, ``rows_per_step``
  output rows a block, their input rows staged in shared memory once
  (``csrc/ds_conv_mr.cu``); its plain version is B3's;
- :func:`dw_conv3x3` (B4) replaces ``dw_conv3x3_pallas``: depthwise 3×3
  with optional bias and ReLU;
- :func:`dw_conv3x3_vjp` (B6) replaces ``dw_conv3x3_pallas_vjp``: the
  differentiable depthwise 3×3 (no bias, no ReLU) of the training stem.
  Its forward is the B4 kernel; its backward is two kernels of
  ``csrc/dw_conv_bwd.cu``, :func:`dw_conv3x3_dx` (the transposed conv,
  JAX ``_conv_dx``) and :func:`dw_conv3x3_dw` (the per-tap reductions,
  JAX ``_conv_dw_taps``), where the JAX package used XLA ops.

All are bound by bytes on an H100 (9 FMAs per dw output, C MACs per pw
output): forward, dX and dW each move about one activation-sized tensor
in and one out (dW writes only 9 × C values). The kernels read NHWC rows
straight from device memory with bounds-checked taps (no padded or
zero-dilated copy); B3 keeps the dw row tile in shared memory; dW sums
across blocks in two passes without atomics. The forward (B4, B6's
forward) and dW give a thread ``VEC`` channels moved by one load of up to
16 bytes, :func:`vec_width` of C, the dtype and the pointers' alignment,
and a block of outputs whose shared inputs stay in registers; their
launch plans (:func:`dw_fwd_plan`, :func:`dw_plan`) are functions of the
shape. See the sources for the designs.

Each wrapper takes its plain PyTorch version (``*_reference``) for a
tensor on the CPU and launches its kernel for a CUDA tensor, raising on
what the kernel does not take; it never falls back. Each counts its
launches in a ``launches`` attribute. The plain versions do the kernel's
f32 operations in the kernel's order, so the two agree bit for bit —
except dW, whose plain version sums in tensor-reduction order (the two
agree to f32 reassociation).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fastscnn_tpu_torch.ops.conv import conv_dw_taps, conv_out_len
from fastscnn_tpu_torch.ops.cuda._build import check, library

__all__ = [
    "dw_conv3x3",
    "ds_conv3x3_pw",
    "ds_conv3x3_pw_multirow",
    "dw_conv3x3_vjp",
    "dw_conv3x3_dx",
    "dw_conv3x3_dw",
    "dw_conv3x3_reference",
    "ds_conv3x3_pw_reference",
    "dw_conv3x3_dx_reference",
    "dw_conv3x3_dw_reference",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_dw_args(x: torch.Tensor, w: torch.Tensor, stride: int, name: str):
    if x.ndim != 4:
        raise ValueError(f"{name} needs NHWC input, got shape {tuple(x.shape)}")
    kh, kw, mult, c = w.shape
    if (kh, kw, mult) != (3, 3, 1) or c != x.shape[-1]:
        raise ValueError(f"{name} needs (3,3,1,C) weights, got {tuple(w.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")


def _check_pw_weights(x: torch.Tensor, w_pw: torch.Tensor):
    c = x.shape[-1]
    if w_pw.ndim != 4 or tuple(w_pw.shape[:3]) != (1, 1, c):
        raise ValueError(f"pw weights must be (1,1,{c},Cout), got {tuple(w_pw.shape)}")


def _kernel_input(x: torch.Tensor, name: str) -> int:
    """Validate a tensor for the CUDA kernels; return its dtype code."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA device, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous NHWC tensor")
    return _DTYPE_CODE[x.dtype]


def _out_hw(x: torch.Tensor, stride: int, padding: int, name: str):
    n, h, wd, _ = x.shape
    ho, wo = conv_out_len(h, 3, stride, padding), conv_out_len(wd, 3, stride, padding)
    if min(n, ho, wo) < 1 or ho > 65535 or n > 65535:
        raise ValueError(f"{name}: unsupported shape {tuple(x.shape)} (out {ho}x{wo})")
    return ho, wo


def vec_width(c: int, itemsize: int, ptrs) -> int:
    """Channels a thread of the forward and dW kernels owns (``VEC``): the
    largest power of two with ``VEC * itemsize <= 16`` bytes that divides
    ``c`` and to whose width, ``VEC * itemsize`` bytes, every activation
    pointer is aligned; down to 1. C = 32 and 48 get 8 in bf16 and 4 in
    f32."""
    vec = 16 // itemsize
    while vec > 1 and (c % vec or any(p % (vec * itemsize) for p in ptrs)):
        vec //= 2
    return vec


# -- the forward kernel's launch plan (csrc/dw_conv.cu, dw_conv3x3_kernel) ----
_FWD_THREADS = 128  # kFwdThreads: a block's threads at most; C / VEC beyond it
                    # takes channel groups
FWD_COLS = (2, 3, 4)  # output columns a thread the kernel is built for (3 and 4 at
                      # the widest VEC only)
# blocks of 128 threads an H100 SM holds by registers at 2, 3 and 4 columns
# (93, 127 and 164 a thread at bf16 VEC 8; chip_smoke.py --tune-dw prints them)
_FWD_RESIDENT = {2: 5, 3: 4, 4: 3}
_SMS = 132


class FwdPlan(NamedTuple):
    """Launch plan of the forward kernel (see :func:`dw_fwd_plan`)."""
    cols: int               # output columns a thread
    rows: int               # output rows a thread
    block: tuple[int, int]  # (channel vectors, column groups)
    tiles: int              # column tiles
    groups: int             # channel groups
    grid: tuple[int, int, int]


@functools.lru_cache(maxsize=256)
def dw_fwd_plan(n: int, ho: int, wo: int, c: int, vec: int, itemsize: int,
                rows: int | None = None, cols: int | None = None) -> FwdPlan:
    """Launch plan of the forward kernel: block ``(C / VEC, column groups)``
    of at most 128 threads (channel groups of at most 128 vectors), each
    thread ``cols`` output columns by ``rows`` output rows. ``cols`` is 4
    at the widest VEC (``VEC * itemsize == 16``), else 2 (the only count
    built for narrower VECs). ``rows`` is 16, halved while the grid fills
    less than 0.6 of one wave of the blocks the SMs hold at that column
    count (16, 8, 4 and 2 rows at the training and serving dsconv1 and
    dsconv2 at any column count). ``chip_smoke.py --tune-dw`` times every
    column count by 1 to 16 rows at those four sites: this rule picks the
    fastest rows (or one within 1 %) for each, and 4 columns is the
    fastest count or within 2 % of it at each, and the fastest over the
    sites of a step and of a frame. ``rows`` and ``cols`` may be given to
    time alternatives. ``grid = (tiles * groups, ceil(Ho / rows), N)``. A
    pure function of the shape."""
    if cols is None:
        cols = 4 if vec * itemsize == 16 else 2
    if cols not in FWD_COLS or (cols != 2 and vec * itemsize != 16):
        raise ValueError(f"dw_fwd_plan: {cols} columns a thread not built for VEC {vec}")
    cv = c // vec
    bx = min(cv, _FWD_THREADS)
    groups = -(-cv // bx)
    col_groups = -(-wo // cols)
    tiles = -(-col_groups // (_FWD_THREADS // bx))
    by = -(-col_groups // tiles)
    if rows is None:
        rows = 16
        min_blocks = 0.6 * _FWD_RESIDENT[cols] * _SMS
        while rows > 1 and tiles * groups * -(-ho // rows) * n < min_blocks:
            rows //= 2
    return FwdPlan(cols, rows, (bx, by), tiles, groups, (tiles * groups, -(-ho // rows), n))


def _as_kernel_weights(t: torch.Tensor) -> torch.Tensor:
    """Weights or bias as the forward kernel reads them: f32 or bf16 (it
    widens bf16 to f32 exactly, as ``.float()`` does) and contiguous;
    other dtypes become f32."""
    return (t if t.dtype in _DTYPE_CODE else t.float()).contiguous()


def _dw_taps_f32(x, w, b, stride, padding, relu):
    """The 9 taps in (di, dj) order in f32 from a zero-padded copy, then
    + bias and ReLU — the kernel's sequence of operations."""
    n, h, wd, c = x.shape
    ho, wo = conv_out_len(h, 3, stride, padding), conv_out_len(wd, 3, stride, padding)
    xp = F.pad(x.float(), (0, 0, padding, padding, padding, padding))
    w9 = w.float().reshape(9, c)
    acc = torch.zeros((n, ho, wo, c), dtype=torch.float32, device=x.device)
    for di in range(3):
        for dj in range(3):
            xv = xp[:, di : di + (ho - 1) * stride + 1 : stride, dj : dj + (wo - 1) * stride + 1 : stride]
            acc = acc + xv * w9[di * 3 + dj]
    if b is not None:
        acc = acc + b.float()
    return acc.clamp_min(0.0) if relu else acc


def dw_conv3x3_reference(x, w, b=None, stride=1, padding=1, relu=False):
    """Plain PyTorch version of B4."""
    _check_dw_args(x, w, stride, "dw_conv3x3")
    return _dw_taps_f32(x, w, b, stride, padding, relu).to(x.dtype)


def ds_conv3x3_pw_reference(x, w_dw, b_dw, w_pw, b_pw, stride=1, padding=1):
    """Plain PyTorch version of B3 and B5: the dw activation rounds to the input
    dtype before the 1×1 (as the unfused graph hands it over), and the
    1×1 accumulates over input channels in order, in f32."""
    _check_dw_args(x, w_dw, stride, "ds_conv3x3_pw")
    c, cout = w_pw.shape[2], w_pw.shape[3]
    mid = _dw_taps_f32(x, w_dw, b_dw, stride, padding, relu=True).to(x.dtype).float()
    wpw = w_pw.reshape(c, cout).to(x.dtype).float()
    acc = torch.zeros((*mid.shape[:3], cout), dtype=torch.float32, device=x.device)
    for ci in range(c):
        acc = acc + mid[..., ci : ci + 1] * wpw[ci]
    acc = acc + b_pw.float()
    return acc.clamp_min(0.0).to(x.dtype)


def dw_conv3x3(x, w, b=None, stride=1, padding=1, relu=False, rows=None, cols=None):
    """Depthwise 3×3 [+bias][+ReLU], NHWC x, (3,3,1,C) w, multiplier 1;
    output in the input dtype, f32 accumulation (kernel B4). ``rows`` and
    ``cols`` override the launch plan's (:func:`dw_fwd_plan`); the result
    is the same bits."""
    _check_dw_args(x, w, stride, "dw_conv3x3")
    if x.device.type == "cpu":
        return dw_conv3x3_reference(x, w, b, stride, padding, relu)
    code = _kernel_input(x, "dw_conv3x3")
    n, h, wd, c = x.shape
    ho, wo = _out_hw(x, stride, padding, "dw_conv3x3")
    w9 = _as_kernel_weights(w.reshape(9, c))
    bias = None if b is None else _as_kernel_weights(b)
    out = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
    itemsize = x.element_size()
    vec = vec_width(c, itemsize, (x.data_ptr(), out.data_ptr()))
    plan = dw_fwd_plan(n, ho, wo, c, vec, itemsize, rows, cols)
    rc = library("dw_conv").fastscnn_dw_conv3x3(
        code, x.data_ptr(), _DTYPE_CODE[w9.dtype], w9.data_ptr(),
        _DTYPE_CODE[w9.dtype if bias is None else bias.dtype],
        None if bias is None else bias.data_ptr(), out.data_ptr(), n, h, wd, c, ho, wo, stride,
        padding, int(relu), vec, plan.cols, plan.rows, *plan.block, plan.tiles, plan.groups,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(rc, "dw_conv3x3")
    dw_conv3x3.launches += 1
    return out


dw_conv3x3.launches = 0


def ds_conv3x3_pw(x, w_dw, b_dw, w_pw, b_pw, stride=1, padding=1):
    """The whole folded DSConv in one kernel (B3):
    relu(pw1×1(cast(relu(dw3×3(x) + b_dw))) + b_pw), NHWC, HWIO weights."""
    _check_dw_args(x, w_dw, stride, "ds_conv3x3_pw")
    _check_pw_weights(x, w_pw)
    if x.device.type == "cpu":
        return ds_conv3x3_pw_reference(x, w_dw, b_dw, w_pw, b_pw, stride, padding)
    code = _kernel_input(x, "ds_conv3x3_pw")
    n, h, wd, c = x.shape
    cout = w_pw.shape[3]
    ho, wo = _out_hw(x, stride, padding, "ds_conv3x3_pw")
    smem = 4 * (64 * c + c * cout)  # kDsTileW * C + C * Cout floats
    if smem > 227 * 1024:
        raise ValueError(f"ds_conv3x3_pw: C={c}, Cout={cout} exceed shared memory")
    w9 = w_dw.float().reshape(9, c).contiguous()
    bd = b_dw.float().contiguous()
    wpw = w_pw.reshape(c, cout).to(x.dtype).float().contiguous()
    bp = b_pw.float().contiguous()
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    rc = library("dw_conv").fastscnn_ds_conv3x3_pw(
        code, x.data_ptr(), w9.data_ptr(), bd.data_ptr(), wpw.data_ptr(), bp.data_ptr(),
        out.data_ptr(), n, h, wd, c, cout, ho, wo, stride, padding,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(rc, "ds_conv3x3_pw")
    ds_conv3x3_pw.launches += 1
    return out


ds_conv3x3_pw.launches = 0

_MR_TILE_W = 16  # output columns per B5 block (kTileW in csrc/ds_conv_mr.cu)


def _mr_smem_bytes(c: int, cout: int, stride: int, rows: int, elem: int) -> int:
    """Dynamic shared memory of one B5 block: pw weights, the dw tile (one
    padding float per pixel), the staged input rows."""
    rows_in, cols_in = (rows - 1) * stride + 3, (_MR_TILE_W - 1) * stride + 3
    return 4 * (c * cout + rows * _MR_TILE_W * (c + 1)) + elem * rows_in * cols_in * c


def ds_conv3x3_pw_multirow(x, w_dw, b_dw, w_pw, b_pw, stride=1, padding=1, rows_per_step=8):
    """B3's function in the multi-row kernel (B5): each block computes
    ``rows_per_step`` output rows of a 16-column tile from input rows
    staged in shared memory once. Any shape; a ragged last row block is
    masked. Its plain version is :func:`ds_conv3x3_pw_reference`, which
    it equals bit for bit."""
    _check_dw_args(x, w_dw, stride, "ds_conv3x3_pw_multirow")
    _check_pw_weights(x, w_pw)
    rows = int(rows_per_step)
    if rows < 1:
        raise ValueError(f"rows_per_step must be >= 1, got {rows_per_step}")
    if x.device.type == "cpu":
        return ds_conv3x3_pw_reference(x, w_dw, b_dw, w_pw, b_pw, stride, padding)
    code = _kernel_input(x, "ds_conv3x3_pw_multirow")
    n, h, wd, c = x.shape
    cout = w_pw.shape[3]
    ho, wo = _out_hw(x, stride, padding, "ds_conv3x3_pw_multirow")
    if -(-ho // rows) > 65535:
        raise ValueError(f"ds_conv3x3_pw_multirow: {ho} output rows need rows_per_step > {rows}")
    smem = _mr_smem_bytes(c, cout, stride, rows, x.element_size())
    if smem > 227 * 1024:
        raise ValueError(f"ds_conv3x3_pw_multirow: C={c}, Cout={cout}, rows_per_step={rows} "
                         f"need {smem} bytes of shared memory, more than 227 KB")
    w9 = w_dw.float().reshape(9, c).contiguous()
    bd = b_dw.float().contiguous()
    wpw = w_pw.reshape(c, cout).to(x.dtype).float().contiguous()
    bp = b_pw.float().contiguous()
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    rc = library("ds_conv_mr").fastscnn_ds_conv3x3_pw_mr(
        code, x.data_ptr(), w9.data_ptr(), bd.data_ptr(), wpw.data_ptr(), bp.data_ptr(),
        out.data_ptr(), n, h, wd, c, cout, ho, wo, stride, padding, rows,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(rc, "ds_conv3x3_pw_multirow")
    ds_conv3x3_pw_multirow.launches += 1
    return out


ds_conv3x3_pw_multirow.launches = 0


# -- B6: the differentiable depthwise 3×3 of the training stem ----------------
_DW_BLOCKS = 6 * 132  # pass-1 blocks to aim at: two waves of the three blocks an
                      # H100 SM holds at VEC 8 (chip_smoke.py --tune-dw prints the
                      # registers and times the alternatives)
_DW_GROUP = 32        # channel vectors a pass-1 block covers at most (one warp)


def _check_bwd_shapes(g, x_shape, stride, padding, name):
    n, h, wd, c = x_shape
    want = (n, conv_out_len(h, 3, stride, padding), conv_out_len(wd, 3, stride, padding), c)
    if tuple(g.shape) != want:
        raise ValueError(f"{name}: gradient shape {tuple(g.shape)}, expected {want}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")


def dw_conv3x3_dx_reference(g, w, stride, padding, x_shape):
    """Plain PyTorch version of the dX kernel: each tap's ``g · w[tap]``
    added, taps in (di, dj) order, into an f32 buffer with the input's
    padding, then cropped — per element the kernel's f32 operations in
    the kernel's order. Output in ``g``'s dtype."""
    _check_bwd_shapes(g, x_shape, stride, padding, "dw_conv3x3_dx")
    n, h, wd, c = x_shape
    ho, wo = g.shape[1], g.shape[2]
    gf = g.float()
    w9 = w.float().reshape(9, c)
    acc = torch.zeros((n, h + 2 * padding, wd + 2 * padding, c), dtype=torch.float32,
                      device=g.device)
    for di in range(3):
        for dj in range(3):
            acc[:, di : di + (ho - 1) * stride + 1 : stride,
                dj : dj + (wo - 1) * stride + 1 : stride] += gf * w9[di * 3 + dj]
    return acc[:, padding : padding + h, padding : padding + wd].to(g.dtype)


def dw_conv3x3_dw_reference(x, g, stride, padding, out_dtype=torch.float32):
    """Plain PyTorch version of the dW kernel: the JAX package's
    ``_conv_dw_taps`` (a multiply-reduce over (N, Ho, Wo) per tap, in f32),
    as (3, 3, 1, C) in ``out_dtype``."""
    _check_bwd_shapes(g, x.shape, stride, padding, "dw_conv3x3_dw")
    return conv_dw_taps(x, g, 3, 3, stride, padding, groups=x.shape[-1]).to(out_dtype)


def dw_conv3x3_dx(g, w, stride=1, padding=1, x_shape=None):
    """Input gradient of the depthwise 3×3 (kernel B6, dX): NHWC ``g`` of
    the output, (3, 3, 1, C) ``w`` → dX of shape ``x_shape`` in ``g``'s
    dtype, f32 accumulation."""
    _check_bwd_shapes(g, x_shape, stride, padding, "dw_conv3x3_dx")
    if g.device.type == "cpu":
        return dw_conv3x3_dx_reference(g, w, stride, padding, x_shape)
    code = _kernel_input(g, "dw_conv3x3_dx")
    n, h, wd, c = x_shape
    if h > 65535 or n > 65535:
        raise ValueError(f"dw_conv3x3_dx: unsupported shape {tuple(x_shape)}")
    w9 = w.float().reshape(9, c).contiguous()
    dx = torch.empty(tuple(x_shape), dtype=g.dtype, device=g.device)
    rc = library("dw_conv_bwd").fastscnn_dw_conv3x3_dx(
        code, g.data_ptr(), w9.data_ptr(), dx.data_ptr(), n, h, wd, c, g.shape[1], g.shape[2],
        stride, padding, torch.cuda.current_stream(g.device).cuda_stream,
    )
    check(rc, "dw_conv3x3_dx")
    dw_conv3x3_dx.launches += 1
    return dx


dw_conv3x3_dx.launches = 0


def dw_plan(n_rows: int, c: int, vec: int, target: int = _DW_BLOCKS):
    """Pass-1 launch plan of the dW kernel: (rows per block, blocks,
    channel groups). Each block takes a run of consecutive (n, ho) output
    rows, about ``target`` blocks in all (by default two whole waves), and
    at most 32 channel vectors (grid.y covers the rest). Depends on the
    shape only, so a given shape always sums in the same order."""
    rows = -(-n_rows // target)
    return rows, -(-n_rows // rows), -(-(c // vec) // _DW_GROUP)


def dw_conv3x3_dw(x, g, stride=1, padding=1, out_dtype=torch.float32, blocks=None):
    """Weight gradient of the depthwise 3×3 (kernel B6, dW): NHWC ``x`` and
    output gradient ``g`` → (3, 3, 1, C) in ``out_dtype`` (f32 or bf16),
    summed over (N, Ho, Wo) in f32 in two passes through an f32 scratch
    tensor of (9·C, blocks) partials. ``blocks`` overrides the pass-1
    blocks :func:`dw_plan` aims at (another summation order)."""
    _check_bwd_shapes(g, x.shape, stride, padding, "dw_conv3x3_dw")
    if x.device.type == "cpu":
        return dw_conv3x3_dw_reference(x, g, stride, padding, out_dtype)
    code = _kernel_input(x, "dw_conv3x3_dw")
    if _kernel_input(g, "dw_conv3x3_dw") != code:
        raise ValueError("dw_conv3x3_dw: x and g must have one dtype")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"dw_conv3x3_dw: out_dtype must be float32 or bfloat16, got {out_dtype}")
    n, h, wd, c = x.shape
    ho, wo = g.shape[1], g.shape[2]
    vec = vec_width(c, x.element_size(), (x.data_ptr(), g.data_ptr()))
    rows, blocks, groups = dw_plan(n * ho, c, vec, blocks or _DW_BLOCKS)
    if groups > 65535:
        raise ValueError(f"dw_conv3x3_dw: C={c} exceeds the grid")
    partial = torch.empty((9 * c, blocks), dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, 1, c), dtype=out_dtype, device=x.device)
    rc = library("dw_conv_bwd").fastscnn_dw_conv3x3_dw(
        code, _DTYPE_CODE[out_dtype], x.data_ptr(), g.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), n, h, wd, c, ho, wo, stride, padding, vec, rows, blocks, groups,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(rc, "dw_conv3x3_dw")
    dw_conv3x3_dw.launches += 1
    return dw


dw_conv3x3_dw.launches = 0


class _DwConv3x3Vjp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding)
        return dw_conv3x3(x, w, None, stride=stride, padding=padding, relu=False)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding = ctx.conf
        if not g.is_contiguous():
            # the layout the kernels read; a gradient arriving in another
            # layout costs one copy, counted here
            g = g.contiguous()
            dw_conv3x3_vjp.g_copies += 1
        dx = dw_ = None
        if ctx.needs_input_grad[0]:
            dx = dw_conv3x3_dx(g, w.to(x.dtype), stride, padding, x.shape)
        if ctx.needs_input_grad[1]:
            dw_ = dw_conv3x3_dw(x, g, stride, padding, w.dtype)
        return dx, dw_, None, None


def dw_conv3x3_vjp(x, w, stride=1, padding=1):
    """Differentiable depthwise 3×3, no bias or ReLU (kernel B6): forward
    through the B4 kernel, backward through the dX and dW kernels. dX in
    ``x``'s dtype, dW in ``w``'s, both accumulated in f32."""
    _check_dw_args(x, w, stride, "dw_conv3x3_vjp")
    return _DwConv3x3Vjp.apply(x, w, stride, padding)


dw_conv3x3_vjp.g_copies = 0
