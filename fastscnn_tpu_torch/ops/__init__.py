"""Tensor ops of the port: resizing, pooling, convolution (with the
tap-formulated backward, and the depthwise conv as taps), batch norm and BN folding (plain PyTorch), plus
the hand-written kernels in :mod:`.cuda`."""

from fastscnn_tpu_torch.ops.conv import (
    BN_EPS,
    BN_MOMENTUM,
    batch_norm_apply,
    batch_norm_train,
    conv2d,
    conv2d_tapbwd,
    conv_out_len,
    dw_conv2d_taps,
    fold_conv_bn,
)
from fastscnn_tpu_torch.ops.pool import adaptive_avg_pool, avg_pool, max_pool
from fastscnn_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_matmul, resize_nearest

__all__ = [
    "BN_EPS",
    "BN_MOMENTUM",
    "adaptive_avg_pool",
    "avg_pool",
    "batch_norm_apply",
    "batch_norm_train",
    "conv2d",
    "conv2d_tapbwd",
    "conv_out_len",
    "dw_conv2d_taps",
    "fold_conv_bn",
    "max_pool",
    "resize_bilinear",
    "resize_bilinear_matmul",
    "resize_nearest",
]
