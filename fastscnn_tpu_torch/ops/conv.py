"""NHWC/HWIO convolution and BN folding.

Counterpart of ``fastscnn_tpu/ops/conv.py`` for the serving path. Plain
convolutions stay with cuDNN (the JAX package left them to XLA): an NHWC
tensor viewed as NCHW by ``permute(0, 3, 1, 2)`` is a ``channels_last``
NCHW tensor, which cuDNN convolves without a layout copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["conv2d", "conv_out_len", "fold_conv_bn", "BN_EPS"]

BN_EPS = 1e-5


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
