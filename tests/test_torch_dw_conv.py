"""Kernels B3 and B4 (``fastscnn_tpu_torch/ops/cuda/dw_conv.py``): their
plain PyTorch versions, which the wrappers run for CPU tensors, against
the JAX package's Pallas kernels run in the Pallas interpreter.

Tolerances: in f32 the two sum the 9 taps (and the 1×1's channels) in a
different order, so 1e-5. In bf16 both accumulate in f32 and round once
at the end, so B4 may differ by one bf16 ulp (2^-7 relative); B3 rounds
twice (the dw activation, then the output), so two ulps. The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``: a CUDA kernel has no interpreter on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastscnn_tpu.ops.pallas.dw_conv import ds_conv3x3_pw_pallas, dw_conv3x3_pallas
from fastscnn_tpu_torch.ops.conv import conv2d
from fastscnn_tpu_torch.ops.cuda import ds_conv3x3_pw, dw_conv3x3

_ULP_BF16 = 2.0 ** -7


def _close(got: torch.Tensor, ref, dtype, ulps):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        limit = ulps * _ULP_BF16 * np.maximum(np.abs(got), np.abs(ref)) + 1e-6
        assert np.all(np.abs(got - ref) <= limit), np.max(np.abs(got - ref) - limit)


def _inputs(rng, shape, cout=None):
    c = shape[-1]
    arrs = {
        "x": rng.standard_normal(shape),
        "w": rng.standard_normal((3, 3, 1, c)) * 0.3,
        "b": rng.standard_normal(c) * 0.1,
    }
    if cout:
        arrs["w_pw"] = rng.standard_normal((1, 1, c, cout)) * 0.3
        arrs["b_pw"] = rng.standard_normal(cout) * 0.1
    return {k: v.astype(np.float32) for k, v in arrs.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias,relu", [(True, True), (False, False), (True, False)])
@pytest.mark.parametrize("stride,shape", [(2, (2, 11, 13, 8)), (1, (2, 9, 7, 8)), (2, (1, 12, 10, 16))])
def test_dw_conv3x3_plain_matches_pallas_interpret(rng, dtype, bias, relu, stride, shape):
    a = _inputs(rng, shape)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x = torch.from_numpy(a["x"]).to(tdt)
    ref = dw_conv3x3_pallas(
        jnp.asarray(a["x"], jdt), jnp.asarray(a["w"]), jnp.asarray(a["b"]) if bias else None,
        stride=stride, padding=1, relu=relu, interpret=True,
    )
    before = dw_conv3x3.launches
    got = dw_conv3x3(x, torch.from_numpy(a["w"]), torch.from_numpy(a["b"]) if bias else None,
                     stride=stride, padding=1, relu=relu)
    assert dw_conv3x3.launches == before  # the CPU path runs the plain version, no kernel
    assert got.dtype == tdt and tuple(got.shape) == tuple(ref.shape)
    _close(got, ref, dtype, ulps=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "stride,shape,cout", [(2, (2, 11, 13, 8), 12), (1, (2, 9, 7, 8), 8), (2, (1, 12, 10, 16), 24)]
)
def test_ds_conv3x3_pw_plain_matches_pallas_interpret(rng, dtype, stride, shape, cout):
    a = _inputs(rng, shape, cout)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ref = ds_conv3x3_pw_pallas(
        jnp.asarray(a["x"], jdt), jnp.asarray(a["w"]), jnp.asarray(a["b"]),
        jnp.asarray(a["w_pw"]), jnp.asarray(a["b_pw"]), stride=stride, padding=1, interpret=True,
    )
    before = ds_conv3x3_pw.launches
    got = ds_conv3x3_pw(
        torch.from_numpy(a["x"]).to(tdt), *(torch.from_numpy(a[k]) for k in ("w", "b", "w_pw", "b_pw")),
        stride=stride, padding=1,
    )
    assert ds_conv3x3_pw.launches == before
    assert got.dtype == tdt and tuple(got.shape) == tuple(ref.shape)
    _close(got, ref, dtype, ulps=2)


def test_ds_conv3x3_pw_plain_matches_unfused_port_graph(rng):
    """f32: the fused DSConv equals the port's own unfolded composition
    (cuDNN-style conv2d + bias + ReLU twice), as the serving graph uses it."""
    a = _inputs(rng, (2, 11, 13, 8), 12)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    mid = torch.relu(conv2d(t["x"], t["w"], t["b"], stride=2, padding=1, groups=8))
    ref = torch.relu(conv2d(mid, t["w_pw"], t["b_pw"]))
    got = ds_conv3x3_pw(t["x"], t["w"], t["b"], t["w_pw"], t["b_pw"], stride=2, padding=1)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fn", ["dw", "ds"])
def test_wrappers_refuse_other_devices(fn):
    """A tensor that is neither on the CPU nor on CUDA raises: the wrappers
    never fall back to the plain version for a device tensor."""
    x = torch.empty((1, 5, 5, 4), device="meta")
    w = torch.empty((3, 3, 1, 4), device="meta")
    b = torch.empty((4,), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        if fn == "dw":
            dw_conv3x3(x, w, b, stride=2)
        else:
            ds_conv3x3_pw(x, w, b, torch.empty((1, 1, 4, 6), device="meta"),
                          torch.empty((6,), device="meta"), stride=2)


def test_dw_wrappers_reject_bad_weights():
    x = torch.zeros((1, 5, 5, 4))
    with pytest.raises(ValueError, match="3,3,1,C"):
        dw_conv3x3(x, torch.zeros((3, 3, 1, 5)))
    with pytest.raises(ValueError, match="stride"):
        dw_conv3x3(x, torch.zeros((3, 3, 1, 4)), stride=3)
    with pytest.raises(ValueError, match="pw weights"):
        ds_conv3x3_pw(x, torch.zeros((3, 3, 1, 4)), torch.zeros(4), torch.zeros((1, 1, 5, 6)),
                      torch.zeros(6))
