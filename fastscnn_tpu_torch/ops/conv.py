"""NHWC/HWIO convolution, batch norm and BN folding.

Counterpart of ``fastscnn_tpu/ops/conv.py``. Plain convolutions stay with
cuDNN (the JAX package left them to XLA): an NHWC tensor viewed as NCHW
by ``permute(0, 3, 1, 2)`` is a ``channels_last`` NCHW tensor, which
cuDNN convolves without a layout copy.

- :func:`conv2d_tapbwd`: the same forward with a hand-written backward —
  dX as the transposed conv of :func:`conv_dx`, dW as the per-tap f32
  contractions of :func:`conv_dw_taps` (the JAX package computes both
  outside any Pallas kernel, so they stay plain PyTorch here).
- :func:`dw_conv2d_taps`: the depthwise conv as ``kh·kw`` strided-slice
  multiply-adds in f32 (the JAX package's formulation for the TPU's
  vector units); autograd's backward of the slices is the tap backward.
- :func:`batch_norm_train` / :func:`batch_norm_apply`: PyTorch BN
  semantics (momentum 0.1, eps 1e-5, unbiased running variance) with the
  JAX package's rounding: f32 moments for bf16 activations, ``inv`` and
  ``shift`` in f32, rounded to the activation dtype before the affine.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "conv2d",
    "conv2d_tapbwd",
    "conv_dx",
    "conv_dw_taps",
    "conv_out_len",
    "dw_conv2d_taps",
    "batch_norm_apply",
    "batch_norm_train",
    "fold_conv_bn",
    "BN_EPS",
    "BN_MOMENTUM",
]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def conv_out_len(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    stride: int = 1,
    padding: int = 0,
    groups: int = 1,
) -> torch.Tensor:
    """2-D convolution, NHWC activations / HWIO weights, output in the
    input dtype. ``groups == C`` with a (kh, kw, 1, C) weight is a
    depthwise conv (multiplier 1)."""
    y = F.conv2d(
        x.permute(0, 3, 1, 2),
        w.to(x.dtype).permute(3, 2, 0, 1),
        None if b is None else b.to(x.dtype),
        stride=stride,
        padding=padding,
        groups=groups,
    )
    return y.permute(0, 2, 3, 1)


def conv_dx(g, w, stride, padding, groups, x_shape):
    """Input cotangent of :func:`conv2d` (NHWC ``g``, HWIO ``w`` in the
    input dtype): the transposed convolution. ``output_padding`` is the
    JAX form's ``rh``/``rw`` remainder padding, which restores the rows and
    columns a stride-2 conv of an odd size never read."""
    kh, kw = w.shape[0], w.shape[1]
    rh = (x_shape[1] + 2 * padding - kh) % stride
    rw = (x_shape[2] + 2 * padding - kw) % stride
    dx = F.conv_transpose2d(
        g.permute(0, 3, 1, 2),
        w.permute(3, 2, 0, 1),  # OIHW is conv_transpose2d's (in, out/groups, kh, kw)
        stride=stride,
        padding=padding,
        output_padding=(rh, rw),
        groups=groups,
    )
    return dx.permute(0, 2, 3, 1)


def conv_dw_taps(x, g, kh, kw, stride, padding, groups):
    """Weight cotangent of :func:`conv2d` as per-tap contractions over
    (N, Ho, Wo) in f32 (f64 for f64 input): for each tap a strided window
    of ``x`` against ``g`` — (Cin, Cout) for a dense conv, (1, C) for a
    depthwise one. Returns HWIO in the accumulation dtype."""
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    ho, wo = g.shape[1], g.shape[2]
    acc = torch.promote_types(x.dtype, torch.float32)
    gf = g.to(acc)
    taps = []
    for di in range(kh):
        for dj in range(kw):
            xv = x[:, di : di + (ho - 1) * stride + 1 : stride, dj : dj + (wo - 1) * stride + 1 : stride]
            if groups == 1:
                taps.append(torch.tensordot(xv.to(acc), gf, dims=([0, 1, 2], [0, 1, 2])))
            else:
                taps.append((xv.to(acc) * gf).sum(dim=(0, 1, 2))[None, :])
    cin_w = x.shape[-1] if groups == 1 else 1
    return torch.stack(taps).reshape(kh, kw, cin_w, g.shape[-1])


class _Conv2dTapBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, groups)
        return conv2d(x, w, stride=stride, padding=padding, groups=groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, groups = ctx.conf
        kh, kw = w.shape[0], w.shape[1]
        dx = conv_dx(g, w.to(x.dtype), stride, padding, groups, x.shape)
        dw = conv_dw_taps(x, g, kh, kw, stride, padding, groups).to(w.dtype)
        return dx, dw, None, None, None


def conv2d_tapbwd(x, w, b=None, stride: int = 1, padding: int = 0, groups: int = 1):
    """:func:`conv2d` with the hand-written backward (the JAX package's
    ``conv2d_tapbwd``): dX is the transposed conv, dW the per-tap f32
    contractions cast to ``w``'s dtype."""
    y = _Conv2dTapBwd.apply(x, w, stride, padding, groups)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def dw_conv2d_taps(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                   stride: int = 1, padding: int = 1, groups: int | None = None) -> torch.Tensor:
    """Depthwise conv (NHWC ``x``, (kh, kw, 1, C) ``w``) as explicit tap
    accumulation: for each tap ``(di, dj)`` in order, a strided window of
    the padded ``x`` times the tap's weights, summed in f32 (f64 for f64
    input), cast once to ``x``'s dtype, then ``b`` added in that dtype.
    ``groups`` is accepted for a conv function's signature and must be C.
    Autograd of the slices gives the backward in the same taps (slice ↔
    pad, a multiply-reduce for dW), as JAX's AD does."""
    kh, kw, _, c = w.shape
    if groups is not None and groups != x.shape[-1]:
        raise ValueError("dw_conv2d_taps is depthwise-only (groups == C)")
    if c != x.shape[-1]:
        raise ValueError(f"weight C {c} != input C {x.shape[-1]} (multiplier-1 only)")
    ho = conv_out_len(x.shape[1], kh, stride, padding)
    wo = conv_out_len(x.shape[2], kw, stride, padding)
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    wf = w.to(acc_dtype)
    acc = None
    for di in range(kh):
        for dj in range(kw):
            xv = x[:, di:di + (ho - 1) * stride + 1:stride, dj:dj + (wo - 1) * stride + 1:stride]
            term = xv.to(acc_dtype) * wf[di, dj, 0]
            acc = term if acc is None else acc + term
    y = acc.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def batch_norm_apply(x, scale, bias, mean, var, eps: float = BN_EPS):
    """Inference-mode BN on running statistics, channels last."""
    inv = torch.rsqrt(var.float() + eps) * scale.float()
    shift = bias.float() - mean.float() * inv
    return x * inv.to(x.dtype) + shift.to(x.dtype)


def batch_norm_train(x, scale, bias, running_mean, running_var, momentum: float = BN_MOMENTUM,
                     eps: float = BN_EPS, packed: bool = False):
    """Training-mode BN, channels last: normalise with the batch moments
    and return ``(y, new_running_mean, new_running_var)``.

    Moments in f32 for bf16 input, two-pass variance (``E[(x-μ)²]``, which
    cannot go negative), the unbiased variance in the running statistics.
    The new statistics carry no gradient. ``packed`` is the JAX package's
    TPU lane layout of the same sums; here it is the plain computation (a
    pure reassociation)."""
    del packed
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    axes = tuple(range(x.ndim - 1))
    batch_mean = xf.mean(dim=axes)
    batch_var = (xf - batch_mean).square().mean(dim=axes)
    n = x.numel() // x.shape[-1]
    with torch.no_grad():
        unbiased = batch_var * (n / max(n - 1, 1))
        new_mean = (1 - momentum) * running_mean.to(acc) + momentum * batch_mean
        new_var = (1 - momentum) * running_var.to(acc) + momentum * unbiased
    inv = torch.rsqrt(batch_var + eps) * scale.to(acc)
    shift = bias.to(acc) - batch_mean * inv
    y = x * inv.to(x.dtype) + shift.to(x.dtype)
    return y, new_mean, new_var


def fold_conv_bn(
    w: torch.Tensor,
    b: torch.Tensor | None,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    eps: float = BN_EPS,
):
    """Fold inference-mode BN into the preceding HWIO conv.

    ``y = BN(conv(x) + b)`` becomes ``conv'(x) + b'`` with ``w' = w · s``,
    ``b' = (b − mean)·s + bias``, ``s = scale / sqrt(var + eps)``; all in f32.
    """
    w = w.float()
    s = scale.float() * torch.rsqrt(var.float() + eps)
    w_f = w * s.reshape(1, 1, 1, -1)
    b0 = torch.zeros_like(mean, dtype=torch.float32) if b is None else b.float()
    b_f = (b0 - mean.float()) * s + bias.float()
    return w_f, b_f
