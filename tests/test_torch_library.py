"""The kernels' ``torch.library`` operators (``fastscnn_tpu_torch/ops/cuda/library.py``)
on the CPU: one operator for each kernel wrapper, ``fastscnn::<name>``.

- ``torch.library.opcheck`` passes for all nine (schema, fake against the
  CPU implementation, autograd registration, AOT dispatch with dynamic
  shapes), on CPU inputs that do not require grad;
- each has implementations for the CPU, CUDA and ``meta`` alone, so a
  tensor on any other device raises in the dispatcher instead of taking
  the plain version; its CPU implementation is the plain version, bit for
  bit, and the wrapper goes through it (the operator's node in a trace);
- the dispatcher's dropped default arguments are put back;
- the resize tables an implementation looks up stay out of
  ``recording_tables`` (so that an exported module does not take them as
  buffers), while the tables the graph itself reads are recorded.
"""

import numpy as np
import pytest
import torch

from fastscnn_tpu_torch.ops import cuda as K
from fastscnn_tpu_torch.ops.cuda.library import NAMESPACE, SCHEMAS
from fastscnn_tpu_torch.ops.resize import recording_tables, resize_bilinear


def _inputs(name, rng):
    """(wrapper args, plain version, plain args) of kernel ``name`` at a
    small shape, from ``rng``."""
    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    def i8(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))

    x, w, b = f32(1, 9, 10, 8), f32(3, 3, 1, 8, scale=0.3), f32(8, scale=0.1)
    w_pw, b_pw = f32(1, 1, 8, 5, scale=0.3), f32(5, scale=0.1)
    g = f32(1, 5, 5, 8)
    x_q, b_eff = i8(1, 3, 4, 8), f32(5)
    return {
        "upsample_argmax": ((f32(1, 4, 5, 3), [9, 11], True), K.upsample_argmax_reference, None),
        "h_lerp_argmax": ((f32(1, 4, 3, 11), 9, False), K.h_lerp_argmax_reference, None),
        "ds_conv3x3_pw": ((x, w, b, w_pw, b_pw, 2, 1), K.ds_conv3x3_pw_reference, None),
        "dw_conv3x3": ((x, w, b, 2, 1, True), K.dw_conv3x3_reference, None),
        "ds_conv3x3_pw_multirow": ((x, w, b, w_pw, b_pw, 1, 1, 2), K.ds_conv3x3_pw_reference,
                                   (x, w, b, w_pw, b_pw, 1, 1)),
        "dw_conv3x3_dx": ((g, w, 2, 1, [1, 9, 10, 8]), K.dw_conv3x3_dx_reference, None),
        "dw_conv3x3_dw": ((x, g, 2, 1, torch.bfloat16), K.dw_conv3x3_dw_reference, None),
        "pw_conv_a8": ((x_q, f32(8, 5, scale=0.2).to(torch.bfloat16), b_eff, False),
                       K.pw_conv_a8_reference, None),
        "pw_conv_w8a8": ((x_q, i8(8, 5), f32(5, scale=1e-3).abs(), b_eff, True, True),
                         K.pw_conv_w8a8_reference, None),
    }[name]


NAMES = sorted(K.KERNELS)


def operator(name):
    return getattr(torch.ops.fastscnn, name).default


def test_one_operator_for_each_kernel():
    assert sorted(SCHEMAS) == NAMES and NAMESPACE == "fastscnn"
    for name in NAMES:
        assert str(operator(name)._schema).startswith(f"fastscnn::{name}(")


@pytest.mark.parametrize("name", NAMES)
def test_opcheck(name):
    args, _, _ = _inputs(name, np.random.default_rng(0))
    assert not any(isinstance(a, torch.Tensor) and a.requires_grad for a in args)
    results = torch.library.opcheck(operator(name), args)
    assert set(results.values()) == {"SUCCESS"}, results


@pytest.mark.parametrize("name", NAMES)
def test_dispatch_table_and_the_cpu_implementation(name):
    """CPU, CUDA and Meta kernels and no other (no Composite kernel that
    would serve every device); the wrapper's CPU result is the plain
    version's bit for bit, through the operator, with no launch counted;
    on ``meta`` the wrapper gives the plain version's shape and dtype."""
    qualified = f"{NAMESPACE}::{name}"
    keys = ("CPU", "CUDA", "Meta", "XPU", "MPS", "HIP", "CompositeImplicitAutograd",
            "CompositeExplicitAutograd", "Autograd")
    assert [k for k in keys if torch._C._dispatch_has_kernel_for_dispatch_key(qualified, k)] == [
        "CPU", "CUDA", "Meta"]
    args, plain, plain_args = _inputs(name, np.random.default_rng(1))
    want = plain(*(plain_args or args))
    before = K.launch_counts()
    got = K.KERNELS[name](*args)
    assert K.launch_counts() == before
    assert got.dtype == want.dtype and torch.equal(got, want)
    traced = torch.fx.experimental.proxy_tensor.make_fx(
        lambda *ts: K.KERNELS[name](*ts, *args[len(ts):]))(
        *[a for a in args if isinstance(a, torch.Tensor)])
    assert [str(n.target) for n in traced.graph.nodes if n.op == "call_function"] == [
        f"{NAMESPACE}.{name}.default"]
    meta = K.KERNELS[name](*(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args))
    assert meta.device.type == "meta" and meta.shape == want.shape and meta.dtype == want.dtype


def test_defaults_the_dispatcher_leaves_out_are_put_back():
    """The dispatcher calls an implementation without trailing arguments
    that equal their defaults; each implementation still gets them all."""
    x = torch.randn(1, 6, 7, 4)
    w = torch.randn(3, 3, 1, 4)
    assert torch.equal(operator("dw_conv3x3")(x, w), K.dw_conv3x3_reference(x, w))
    logits = torch.randn(1, 3, 4, 2)
    assert torch.equal(operator("upsample_argmax")(logits, [7, 9]),
                       K.upsample_argmax_reference(logits, (7, 9)))
    g = torch.randn(1, 6, 7, 4)
    assert operator("dw_conv3x3_dw")(x, g).dtype == torch.float32


def test_operator_tables_stay_out_of_recordings():
    """Inside ``recording_tables`` the tables an operator looks up itself
    (B1's and B2's lerp tables on the CPU) are not recorded, and a lookup
    outside an operator is; the operator's result is unchanged."""
    logits = torch.randn(1, 5, 6, 3)
    xw = torch.randn(1, 5, 3, 13)
    want = (K.upsample_argmax(logits, (17, 21)), K.h_lerp_argmax(xw, 17))
    record: dict = {}
    with recording_tables(record):
        got = (K.upsample_argmax(logits, (17, 21)), K.h_lerp_argmax(xw, 17))
        assert record == {}
        resize_bilinear(logits, (17, 21))
    assert record and all(torch.equal(a, b) for a, b in zip(got, want))
