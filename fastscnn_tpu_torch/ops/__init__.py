"""Tensor ops of the port: resizing, pooling, convolution and BN folding
(plain PyTorch), plus the hand-written kernels in :mod:`.cuda`."""

from fastscnn_tpu_torch.ops.conv import BN_EPS, conv2d, conv_out_len, fold_conv_bn
from fastscnn_tpu_torch.ops.pool import adaptive_avg_pool
from fastscnn_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_matmul, resize_nearest

__all__ = [
    "BN_EPS",
    "adaptive_avg_pool",
    "conv2d",
    "conv_out_len",
    "fold_conv_bn",
    "resize_bilinear",
    "resize_bilinear_matmul",
    "resize_nearest",
]
