"""Depthwise 3×3 and fused DSConv for the LTD stem: kernels B3, B4, B6.

Counterpart of ``fastscnn_tpu/ops/pallas/dw_conv.py``:

- :func:`ds_conv3x3_pw` (B3) replaces ``ds_conv3x3_pw_pallas``:
  relu(pw1×1(cast(relu(dw3×3(x) + b_dw))) + b_pw), the dw activation
  never leaving the chip;
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
across blocks in two passes without atomics. See the sources for the
designs.

Each wrapper takes its plain PyTorch version (``*_reference``) for a
tensor on the CPU and launches its kernel for a CUDA tensor, raising on
what the kernel does not take; it never falls back. Each counts its
launches in a ``launches`` attribute. The plain versions do the kernel's
f32 operations in the kernel's order, so the two agree bit for bit —
except dW, whose plain version sums in tensor-reduction order (the two
agree to f32 reassociation).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fastscnn_tpu_torch.ops.conv import conv_dw_taps, conv_out_len
from fastscnn_tpu_torch.ops.cuda._build import check, library

__all__ = [
    "dw_conv3x3",
    "ds_conv3x3_pw",
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
    """Plain PyTorch version of B3: the dw activation rounds to the input
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


def dw_conv3x3(x, w, b=None, stride=1, padding=1, relu=False):
    """Depthwise 3×3 [+bias][+ReLU], NHWC x, (3,3,1,C) w, multiplier 1;
    output in the input dtype, f32 accumulation (kernel B4)."""
    _check_dw_args(x, w, stride, "dw_conv3x3")
    if x.device.type == "cpu":
        return dw_conv3x3_reference(x, w, b, stride, padding, relu)
    code = _kernel_input(x, "dw_conv3x3")
    n, h, wd, c = x.shape
    ho, wo = _out_hw(x, stride, padding, "dw_conv3x3")
    w9 = w.float().reshape(9, c).contiguous()
    bias = None if b is None else b.float().contiguous()
    out = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
    rc = library("dw_conv").fastscnn_dw_conv3x3(
        code, x.data_ptr(), w9.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), n, h, wd, c, ho, wo, stride, padding, int(relu),
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
    c = x.shape[-1]
    if w_pw.ndim != 4 or tuple(w_pw.shape[:3]) != (1, 1, c):
        raise ValueError(f"pw weights must be (1,1,{c},Cout), got {tuple(w_pw.shape)}")
    if x.device.type == "cpu":
        return ds_conv3x3_pw_reference(x, w_dw, b_dw, w_pw, b_pw, stride, padding)
    code = _kernel_input(x, "ds_conv3x3_pw")
    n, h, wd, _ = x.shape
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


# -- B6: the differentiable depthwise 3×3 of the training stem ----------------
_DW_LANES_THREADS = 256  # pass-1 block: C channels × max(1, 256 // C) column lanes
_DW_MAX_BLOCKS = 1024    # pass-1 blocks, each a run of consecutive (n, ho) rows


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


def dw_plan(n_rows: int, c: int):
    """Pass-1 launch plan of the dW kernel: (rows per block, blocks,
    column lanes per block). Depends on the shape only, so a given shape
    always sums in the same order."""
    lanes = max(1, _DW_LANES_THREADS // c)
    blocks = min(n_rows, _DW_MAX_BLOCKS)
    rows = -(-n_rows // blocks)
    return rows, -(-n_rows // rows), lanes


def dw_conv3x3_dw(x, g, stride=1, padding=1, out_dtype=torch.float32):
    """Weight gradient of the depthwise 3×3 (kernel B6, dW): NHWC ``x`` and
    output gradient ``g`` → (3, 3, 1, C) in ``out_dtype`` (f32 or bf16),
    summed over (N, Ho, Wo) in f32 in two passes through an f32 scratch
    tensor of (9·C, blocks) partials."""
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
    if c > 1024:
        raise ValueError(f"dw_conv3x3_dw: C={c} exceeds one block")
    rows, blocks, lanes = dw_plan(n * ho, c)
    partial = torch.empty((9 * c, blocks), dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, 1, c), dtype=out_dtype, device=x.device)
    rc = library("dw_conv_bwd").fastscnn_dw_conv3x3_dw(
        code, _DTYPE_CODE[out_dtype], x.data_ptr(), g.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), n, h, wd, c, ho, wo, stride, padding, rows, blocks, lanes,
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
