"""The hand-written kernels as ``torch.library`` operators, namespace ``fastscnn``.

One operator for each entry of ``KERNELS`` (the package's ``__init__``),
defined with ``torch.library.Library.define`` and ``impl`` (a call passes
less Python than through the ``custom_op`` decorator), each with three
implementations:

- **CUDA**: the wrapper's launch code (``_<name>_cuda`` in the kernel's
  module): the argument checks, the launch plan, the ``ctypes`` launch
  and the wrapper's ``launches`` count. It raises on what the kernel does
  not take and never falls back to the plain version. The kernels build
  at their first CUDA launch (``_build.py``), not here;
- **CPU**: the plain PyTorch version (``*_reference``);
- **fake** (``register_fake``, which also serves the ``meta`` device): the
  output's shape, dtype and device, after the checks that need no data;
  it launches and counts nothing.

Every public wrapper calls its operator, so eager calls, CUDA graph
captures and ``torch.export`` tracing take one path: ``torch.export``
traces an operator as one node, ``torch.ops.fastscnn.<name>.default``,
through its fake implementation. Such a program loads only where the
operators are registered: importing this module, or any module of
``fastscnn_tpu_torch.ops.cuda``, registers all nine (the package imports
this module last). The tables an implementation looks up stay out of
:func:`~fastscnn_tpu_torch.ops.resize.recording_tables`, so that an
exported module does not take them as buffers of its graph.
"""

from __future__ import annotations

import functools
import importlib

import torch

from fastscnn_tpu_torch.ops import resize

# by import_module: the package re-exports a function named upsample_argmax,
# which hides the submodule of that name from a from-import
D, Q, U = (importlib.import_module(f"fastscnn_tpu_torch.ops.cuda.{m}")
           for m in ("dw_conv", "int8_pw", "upsample_argmax"))

__all__ = ["NAMESPACE", "SCHEMAS"]

NAMESPACE = "fastscnn"

#: each operator's schema, and the module that holds its implementations
SCHEMAS = {
    "upsample_argmax": (U, "Tensor logits, SymInt[] out_size, bool align_corners=True, "
                           "int? tile=None, int? rows=None"),
    "h_lerp_argmax": (U, "Tensor xw, SymInt out_h, bool align_corners=True, int? tile=None, "
                         "int? rows=None"),
    "ds_conv3x3_pw": (D, "Tensor x, Tensor w_dw, Tensor b_dw, Tensor w_pw, Tensor b_pw, "
                         "int stride=1, int padding=1, int? rows=None"),
    "dw_conv3x3": (D, "Tensor x, Tensor w, Tensor? b=None, int stride=1, int padding=1, "
                      "bool relu=False, int? rows=None, int? cols=None"),
    "ds_conv3x3_pw_multirow": (D, "Tensor x, Tensor w_dw, Tensor b_dw, Tensor w_pw, "
                                  "Tensor b_pw, int stride=1, int padding=1, "
                                  "int rows_per_step=8, int? rows=None, int? tile=None, "
                                  "int? strips=None"),
    "dw_conv3x3_dx": (D, "Tensor g, Tensor w, int stride, int padding, SymInt[] x_shape, "
                         "int? rows=None, int? cols=None"),
    "dw_conv3x3_dw": (D, "Tensor x, Tensor g, int stride=1, int padding=1, "
                         "ScalarType? out_dtype=None, int? blocks=None"),
    "pw_conv_a8": (Q, "Tensor x_q, Tensor w_eff, Tensor b_eff, bool relu=True, "
                      "bool quantize_out=False, int? tile=None"),
    "pw_conv_w8a8": (Q, "Tensor x_q, Tensor w_q, Tensor cs, Tensor b_eff, bool relu=True, "
                        "bool quantize_out=False, int? tile=None"),
}


def _implementation(impl, schema):
    """``impl`` called with every argument of ``schema``: the dispatcher
    leaves out trailing arguments that equal their defaults, which are put
    back here. With ``_unrecorded``, the resize tables it looks up stay out
    of every active ``recording_tables`` block (one list test a call when
    none is)."""
    defaults = tuple(a.default_value for a in torch._C.parse_schema(schema).arguments)

    @functools.wraps(impl)
    def run(*args):
        args += defaults[len(args):]
        if not resize._RECORDS:
            return impl(*args)
        records = resize._RECORDS[:]
        resize._RECORDS.clear()
        try:
            return impl(*args)
        finally:
            resize._RECORDS[:] = records

    return run


_LIB = torch.library.Library(NAMESPACE, "DEF")
for _name, (_module, _args) in SCHEMAS.items():
    _schema = f"{_name}({_args}) -> Tensor"
    _LIB.define(_schema)
    for _key in ("CPU", "CUDA"):
        _LIB.impl(_name, _implementation(getattr(_module, f"_{_name}_{_key.lower()}"), _schema),
                  _key)
    torch.library.register_fake(f"{NAMESPACE}::{_name}",
                                _implementation(getattr(_module, f"_{_name}_fake"), _schema),
                                lib=_LIB)

