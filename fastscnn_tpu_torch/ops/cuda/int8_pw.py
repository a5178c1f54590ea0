"""Int8 pointwise (1×1) convolutions with the requantizing epilogue: B7, B8.

Counterpart of ``fastscnn_tpu/ops/pallas/int8_pw.py``:

- :func:`quantize_act`: symmetric int8 activation quantization,
  ``clip(round(x / s), ±127)``. Plain PyTorch, as it is plain XLA there.
- :func:`pw_conv_a8` (B7) replaces ``pw_conv_a8``: int8 activations times
  bf16 effective weights (the folded weight × the activation scale), f32
  sums, + bias, [ReLU], then bf16 or requantized int8.
- :func:`pw_conv_w8a8` (B8) replaces ``pw_conv_w8a8``: int8 activations
  times int8 weights, int32 sums, × a per-channel f32 scale, then the same
  epilogue.

A 1×1 conv over NHWC is a matmul on the ``(N·H·W, K)`` view, so both take
NHWC or pre-flattened 2-D int8 input. The kernels (``csrc/int8_pw.cu``)
compute the product in their own bodies; no library GEMM is on the path.
The JAX package's TPU tiling (``use_pallas``, ``block_m``, ``interpret``
and its XLA fallback for ``M % 32 != 0``) has no counterpart: the kernels
take every M and mask the ragged last tile. They need ``K % 4 == 0`` (four
int8 values are read at once), which every site of the serving path has.

Each wrapper takes its plain PyTorch version (``*_reference``) for a CPU
tensor and launches its kernel for a CUDA tensor, raising on what the
kernel does not take; it never falls back. Each counts its launches in a
``launches`` attribute. B8's sums are exact integers below 2^24, so kernel,
plain version and the JAX function agree bit for bit; B7's plain version
adds the products k = 0..K−1 in the kernel's order, each product exact in
f32, so kernel and plain version agree bit for bit (the JAX function's dot
sums in an order of its own: one bf16 ulp, or one int8 level).
"""

from __future__ import annotations

import torch

from fastscnn_tpu_torch.ops.cuda._build import check, library

__all__ = [
    "quantize_act",
    "pw_conv_a8",
    "pw_conv_w8a8",
    "pw_conv_a8_reference",
    "pw_conv_w8a8_reference",
]


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 quantization ``clip(round(x / scale), -127, 127)``, in
    f32, rounding half to even (as ``jnp.round``). ``scale`` is a Python
    float (rounded to f32, as JAX's weak-typed scalar is) or an f32 tensor.

    The quotient is a true division, as the JAX function computes it when
    called eagerly: PyTorch's CUDA division by a CPU scalar multiplies by
    the reciprocal instead, which moves values at the half-way points to
    the next level, so the scale always goes in as a tensor on ``x``'s
    device. (XLA under ``jit`` also rewrites a division by a constant into
    a reciprocal multiply, so the jitted JAX function puts some values at
    a level's edge one level apart from the function as written.)"""
    if not isinstance(scale, torch.Tensor):
        scale = torch.tensor(scale, dtype=torch.float32, device=x.device)
    q = torch.div(x.float(), scale).round_().clamp_(-127.0, 127.0)
    return q.to(torch.int8)


def _flatten(x_q: torch.Tensor, k: int, name: str):
    if x_q.ndim not in (2, 4):
        raise ValueError(f"{name} needs NHWC or (M, K) input, got shape {tuple(x_q.shape)}")
    if x_q.dtype != torch.int8:
        raise ValueError(f"{name} needs int8 activations, got {x_q.dtype}")
    if x_q.shape[-1] != k:
        raise ValueError(f"{name}: input has {x_q.shape[-1]} channels, weights {k}")
    return x_q.reshape(-1, k), tuple(x_q.shape[:-1])


def _epilogue(acc: torch.Tensor, b_eff, relu: bool, quantize_out: bool) -> torch.Tensor:
    """The JAX ``_epilogue``: f32 ``acc + b``, [ReLU], then bf16 or
    ``clip(round(·), ±127)`` int8."""
    t = acc + b_eff.float()
    if relu:
        t = t.clamp_min(0.0)
    if quantize_out:
        return t.round().clamp(-127.0, 127.0).to(torch.int8)
    return t.to(torch.bfloat16)


def pw_conv_a8_reference(x_q, w_eff, b_eff, relu=True, quantize_out=False):
    """Plain PyTorch version of B7: the f32 sum over k = 0..K−1 in order,
    one exact product added at a time, then the epilogue."""
    k, n = w_eff.shape
    x2, lead = _flatten(x_q, k, "pw_conv_a8")
    xf = x2.float()
    wf = w_eff.to(torch.bfloat16).float()
    acc = torch.zeros((x2.shape[0], n), dtype=torch.float32, device=x2.device)
    for kk in range(k):
        acc.addcmul_(xf[:, kk : kk + 1], wf[kk])
    return _epilogue(acc, b_eff, relu, quantize_out).reshape(*lead, n)


def pw_conv_w8a8_reference(x_q, w_q, cs, b_eff, relu=True, quantize_out=False):
    """Plain PyTorch version of B8: the integer sums (exact in f64, and
    below 2^24 so exact in f32), × ``cs`` in f32, then the epilogue."""
    k, n = w_q.shape
    x2, lead = _flatten(x_q, k, "pw_conv_w8a8")
    acc = (x2.double() @ w_q.double()).float()
    return _epilogue(acc * cs.float(), b_eff, relu, quantize_out).reshape(*lead, n)


def _check_launch(x2: torch.Tensor, w: torch.Tensor, name: str):
    if x2.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA device, got {x2.device}")
    k = x2.shape[1]
    if k % 4 or x2.data_ptr() % 4:
        raise ValueError(f"{name}: the kernel reads 4 int8 values at once and needs K % 4 == 0 "
                         f"and 4-byte aligned rows, got K={k}")
    if w.device != x2.device:
        raise ValueError(f"{name}: weights on {w.device}, activations on {x2.device}")


def pw_conv_a8(x_q, w_eff, b_eff, relu=True, quantize_out=False):
    """Pointwise conv on int8 activations with bf16 effective weights (B7).

    ``x_q`` int8 NHWC or ``(M, K)``; ``w_eff`` ``(K, N)``, the folded
    weight × the activation scale (÷ the output scale when
    ``quantize_out``), used in bf16; ``b_eff`` ``(N,)``, used in f32.
    Returns bf16, or int8 when ``quantize_out``, shaped like ``x_q`` with
    N channels."""
    k, n = w_eff.shape
    x2, lead = _flatten(x_q, k, "pw_conv_a8")
    if x2.device.type == "cpu":
        return pw_conv_a8_reference(x_q, w_eff, b_eff, relu, quantize_out)
    x2 = x2.contiguous()
    _check_launch(x2, w_eff, "pw_conv_a8")
    m = x2.shape[0]
    w = w_eff.to(torch.bfloat16).contiguous()
    b = b_eff.float().contiguous()
    out = torch.empty((m, n), dtype=torch.int8 if quantize_out else torch.bfloat16,
                      device=x2.device)
    rc = library("int8_pw").fastscnn_pw_conv_a8(
        x2.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, int(relu),
        int(quantize_out), torch.cuda.current_stream(x2.device).cuda_stream,
    )
    check(rc, "pw_conv_a8")
    pw_conv_a8.launches += 1
    return out.reshape(*lead, n)


pw_conv_a8.launches = 0


def pw_conv_w8a8(x_q, w_q, cs, b_eff, relu=True, quantize_out=False):
    """Pointwise conv with both operands int8 (B8).

    ``w_q`` int8 ``(K, N)``; ``cs`` ``(N,)`` f32, the combined
    per-channel scale ``s_x · s_w[c]`` (÷ ``s_y`` when ``quantize_out``);
    ``b_eff`` as in :func:`pw_conv_a8`. Returns bf16 or int8 as there."""
    k, n = w_q.shape
    if w_q.dtype != torch.int8:
        raise ValueError(f"pw_conv_w8a8 needs int8 weights, got {w_q.dtype}")
    x2, lead = _flatten(x_q, k, "pw_conv_w8a8")
    if x2.device.type == "cpu":
        return pw_conv_w8a8_reference(x_q, w_q, cs, b_eff, relu, quantize_out)
    x2 = x2.contiguous()
    _check_launch(x2, w_q, "pw_conv_w8a8")
    m = x2.shape[0]
    w = w_q.contiguous()
    scale = cs.float().contiguous()
    b = b_eff.float().contiguous()
    out = torch.empty((m, n), dtype=torch.int8 if quantize_out else torch.bfloat16,
                      device=x2.device)
    rc = library("int8_pw").fastscnn_pw_conv_w8a8(
        x2.data_ptr(), w.data_ptr(), scale.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
        int(relu), int(quantize_out), torch.cuda.current_stream(x2.device).cuda_stream,
    )
    check(rc, "pw_conv_w8a8")
    pw_conv_w8a8.launches += 1
    return out.reshape(*lead, n)


pw_conv_w8a8.launches = 0
