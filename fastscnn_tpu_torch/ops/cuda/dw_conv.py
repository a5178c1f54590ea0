"""Depthwise 3×3 and fused DSConv for the LTD stem: kernels B3 and B4.

Counterpart of ``fastscnn_tpu/ops/pallas/dw_conv.py``:

- :func:`ds_conv3x3_pw` (B3) replaces ``ds_conv3x3_pw_pallas``:
  relu(pw1×1(cast(relu(dw3×3(x) + b_dw))) + b_pw), the dw activation
  never leaving the chip;
- :func:`dw_conv3x3` (B4) replaces ``dw_conv3x3_pallas``: depthwise 3×3
  with optional bias and ReLU.

Both are bound by bytes on an H100 (9 FMAs per dw output, C MACs per pw
output); the kernels in ``csrc/dw_conv.cu`` read NHWC rows straight from
device memory with bounds-checked taps (no padded copy), B3 keeps the dw
row tile in shared memory. See that file for the design.

Each wrapper takes its plain PyTorch version (``*_reference``) for a
tensor on the CPU and launches its kernel for a CUDA tensor, raising on
what the kernel does not take; it never falls back. Each counts its
launches in a ``launches`` attribute. The plain versions do the kernel's
f32 operations in the kernel's order, so the two agree bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fastscnn_tpu_torch.ops.conv import conv_out_len
from fastscnn_tpu_torch.ops.cuda._build import check, library

__all__ = ["dw_conv3x3", "ds_conv3x3_pw", "dw_conv3x3_reference", "ds_conv3x3_pw_reference"]

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
