"""Hand-written Hopper kernels of the port, with their plain versions.

``KERNELS`` names every kernel wrapper; each calls its ``torch.library``
operator ``fastscnn::<name>`` (:mod:`.library`, registered here: the CUDA
implementation launches the kernel, the CPU one is the plain version) and
counts the launches of its kernel in a ``launches`` attribute (launches
only — a call that takes the plain version on the CPU does not count).
"""

from __future__ import annotations

from fastscnn_tpu_torch.ops.cuda.dw_conv import (
    ds_conv3x3_pw,
    ds_conv3x3_pw_multirow,
    ds_conv3x3_pw_reference,
    dw_conv3x3,
    dw_conv3x3_dw,
    dw_conv3x3_dw_reference,
    dw_conv3x3_dx,
    dw_conv3x3_dx_reference,
    dw_conv3x3_reference,
    dw_conv3x3_vjp,
)
from fastscnn_tpu_torch.ops.cuda.int8_pw import (
    pw_conv_a8,
    pw_conv_a8_reference,
    pw_conv_a8_tolerance,
    pw_conv_w8a8,
    pw_conv_w8a8_reference,
    quantize_act,
)
from fastscnn_tpu_torch.ops.cuda.upsample_argmax import (
    h_lerp_argmax,
    h_lerp_argmax_reference,
    upsample_argmax,
    upsample_argmax_reference,
    w_matmul_h_lerp_argmax,
)

# last: it defines the operators the wrappers above call
from fastscnn_tpu_torch.ops.cuda import library  # noqa: E402,F401

__all__ = [
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
    "ds_conv3x3_pw",
    "ds_conv3x3_pw_multirow",
    "ds_conv3x3_pw_reference",
    "dw_conv3x3",
    "dw_conv3x3_reference",
    "dw_conv3x3_dw",
    "dw_conv3x3_dw_reference",
    "dw_conv3x3_dx",
    "dw_conv3x3_dx_reference",
    "dw_conv3x3_vjp",
    "h_lerp_argmax",
    "h_lerp_argmax_reference",
    "pw_conv_a8",
    "pw_conv_a8_reference",
    "pw_conv_a8_tolerance",
    "pw_conv_w8a8",
    "pw_conv_w8a8_reference",
    "quantize_act",
    "upsample_argmax",
    "upsample_argmax_reference",
    "w_matmul_h_lerp_argmax",
]

KERNELS = {
    "upsample_argmax": upsample_argmax,
    "h_lerp_argmax": h_lerp_argmax,
    "ds_conv3x3_pw": ds_conv3x3_pw,
    "dw_conv3x3": dw_conv3x3,
    "ds_conv3x3_pw_multirow": ds_conv3x3_pw_multirow,
    "dw_conv3x3_dx": dw_conv3x3_dx,
    "dw_conv3x3_dw": dw_conv3x3_dw,
    "pw_conv_a8": pw_conv_a8,
    "pw_conv_w8a8": pw_conv_w8a8,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
