"""Hand-written Hopper kernels of the port, with their plain versions.

``KERNELS`` names every kernel wrapper; each counts the launches of its
kernel in a ``launches`` attribute (launches only — a call that takes the
plain version on the CPU does not count).
"""

from __future__ import annotations

from fastscnn_tpu_torch.ops.cuda.dw_conv import (
    ds_conv3x3_pw,
    ds_conv3x3_pw_reference,
    dw_conv3x3,
    dw_conv3x3_dw,
    dw_conv3x3_dw_reference,
    dw_conv3x3_dx,
    dw_conv3x3_dx_reference,
    dw_conv3x3_reference,
    dw_conv3x3_vjp,
)
from fastscnn_tpu_torch.ops.cuda.upsample_argmax import (
    h_lerp_argmax,
    h_lerp_argmax_reference,
    upsample_argmax,
    upsample_argmax_reference,
    w_matmul_h_lerp_argmax,
)

__all__ = [
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
    "ds_conv3x3_pw",
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
    "upsample_argmax",
    "upsample_argmax_reference",
    "w_matmul_h_lerp_argmax",
]

KERNELS = {
    "upsample_argmax": upsample_argmax,
    "h_lerp_argmax": h_lerp_argmax,
    "ds_conv3x3_pw": ds_conv3x3_pw,
    "dw_conv3x3": dw_conv3x3,
    "dw_conv3x3_dx": dw_conv3x3_dx,
    "dw_conv3x3_dw": dw_conv3x3_dw,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
