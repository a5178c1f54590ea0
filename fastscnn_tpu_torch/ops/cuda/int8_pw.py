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
compute the product in their own bodies on the tensor cores, through one
``cp.async`` pipeline; no library GEMM is on the path. B7 widens its int8
activations to bf16 for ``mma.sync`` m16n8k16 (f32 sums); B8 feeds both
int8 operands to ``mma.sync`` m16n8k32 (s32 sums), its row-major weight
chunk transposed in shared memory one chunk ahead of the mmas that read it.
The JAX package's TPU tiling (``use_pallas``, ``block_m``, ``interpret``
and its XLA fallback for ``M % 32 != 0``) has no counterpart: the kernels
take every M and mask the ragged last tile. They need ``K % 4 == 0`` (four
int8 values are read at once), which every site of the serving path has.

Each wrapper calls its operator ``fastscnn::<name>`` (:mod:`.library`),
whose CPU implementation is the plain PyTorch version (``*_reference``)
and whose CUDA implementation launches the kernel, raising on what the
kernel does not take; it never falls back. The kernel's launches count
in the wrapper's ``launches`` attribute. B8's sums are exact integers
below 2^24, so kernel, plain version and the JAX function agree bit for
bit; B7's plain version adds the products k = 0..K−1 in the kernel's
order, each product exact in f32, so kernel and plain version agree bit
for bit (the JAX function's dot sums in an order of its own: one bf16
ulp, or one int8 level).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from fastscnn_tpu_torch.ops.cuda._build import check, launch
from fastscnn_tpu_torch.ops.cuda.dw_conv import _DTYPE_CODE

_OPS = torch.ops.fastscnn  # the operators of .library, registered when the package loads

__all__ = [
    "quantize_act",
    "pw_conv_a8",
    "pw_conv_w8a8",
    "pw_conv_a8_reference",
    "pw_conv_a8_tolerance",
    "pw_conv_w8a8_reference",
    "pw_a8_plan",
    "pw_w8a8_plan",
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


def pw_conv_a8_tolerance(x_q, w_eff):
    """Per-output bound on |B7's f32 sum − the plain version's|:
    ``γ_K · (|x| @ |w|)``, in f64, shaped like B7's output.

    ``γ_K = K · 2^-22``. Every product is exact in f32, so the two differ
    only in how the K products are added. The plain version's in-order
    sum errs by at most (K − 1) · 2^-24 · Σ|p| (each addition rounds to
    nearest, relative error 2^-24, of a partial sum at most Σ|p|). The
    tensor cores add in their own order and may truncate where they
    align or add, losing less than one f32 ulp, 2^-23 relative, of a
    partial sum at most Σ|p| in each of at most K additions: at most
    K · 2^-23 · Σ|p|. The two together stay below K · 2^-22 · Σ|p|."""
    k, n = w_eff.shape
    x2, lead = _flatten(x_q, k, "pw_conv_a8_tolerance")
    wa = w_eff.to(torch.bfloat16).double().abs()
    return ((x2.double().abs() @ wa) * (k * 2.0**-22)).reshape(*lead, n)


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


# -- B7's launch plan (csrc/int8_pw.cu, pw_a8_mma_kernel) ----------------------
# the block tiles the kernel is built for, largest first: (BM, BN, threads)
PW_A8_TILES = ((128, 128, 256), (64, 64, 128), (32, 64, 128))
# blocks of each tile an H100 SM holds, by registers (128, 72 and 72 a
# thread) and shared memory (58, 71 and 107 KB); chip_smoke.py --tune-pw
# prints the kernels' registers and times every tile at a frame's sites
_PW_A8_RESIDENT = (2, 3, 2)
_SMS = 132


class PwPlan(NamedTuple):
    """Launch plan of B7's or B8's kernel (see :func:`pw_a8_plan` and
    :func:`pw_w8a8_plan`)."""
    tile: int              # index into PW_A8_TILES or PW_W8A8_TILES
    bm: int                # output rows a block
    bn: int                # output columns a block
    threads: int
    grid: tuple[int, int]  # (N tiles, M tiles)


@functools.lru_cache(maxsize=256)
def pw_a8_plan(m: int, k: int, n: int, tile: int | None = None) -> PwPlan:
    """Launch plan of B7's kernel: the largest block tile of
    :data:`PW_A8_TILES` whose grid fills at least 0.6 of one wave of the
    blocks of that tile the SMs hold, else the smallest tile (the rule of
    :func:`~fastscnn_tpu_torch.ops.cuda.dw_conv.dw_fwd_plan`). At a
    1024×2048 frame that is 128 × 128 at the M = 32,768 and 131,072 sites
    and at M = 8,192 with N = 384, 64 × 64 at M = 2,048 with N = 576 and
    768, and 32 × 64 elsewhere: at least 128 blocks at every site. K does not
    change the plan (the kernel walks K in chunks of 32 to 128), but is part of
    its signature so that a shape always maps to one plan. ``tile`` may be
    given to time alternatives. A pure function of the shape."""
    if k < 1 or m < 1 or n < 1:
        raise ValueError(f"pw_a8_plan: empty product ({m}x{k})x({k}x{n})")
    if tile is None:
        tile = len(PW_A8_TILES) - 1
        for i, (bm, bn, _) in enumerate(PW_A8_TILES):
            if -(-m // bm) * -(-n // bn) >= 0.6 * _PW_A8_RESIDENT[i] * _SMS:
                tile = i
                break
    if not 0 <= tile < len(PW_A8_TILES):
        raise ValueError(f"pw_a8_plan: no tile {tile}")
    bm, bn, threads = PW_A8_TILES[tile]
    grid = (-(-n // bn), -(-m // bm))
    if grid[1] > 65535:
        raise ValueError(f"pw_a8_plan: M={m} needs more than 65,535 row tiles of {bm}")
    return PwPlan(tile, bm, bn, threads, grid)


# -- B8's launch plan (csrc/int8_pw.cu, pw_w8a8_mma_kernel) -------------------
# the block tiles the kernel is built for: (BM, BN, threads); B7's three, and
# 128 x 64 for the long-M, short-K sites, which stream their bytes
PW_W8A8_TILES = PW_A8_TILES + ((128, 64, 128),)
_STREAM_TILE = 3


@functools.lru_cache(maxsize=256)
def pw_w8a8_plan(m: int, k: int, n: int, tile: int | None = None) -> PwPlan:
    """Launch plan of B8's kernel. A site with K and N both at most 64 (the
    LTD's 1×1s, 131,072 × 32 × 48 and 32,768 × 48 × 64 at a 1024×2048
    frame) does little arithmetic a byte and streams: the 128 × 64 tile,
    K in chunks of 32. Every other site takes B7's tile by B7's rule
    (:func:`pw_a8_plan`): at a frame's sites that is the fastest of the
    three in ``chip_smoke.py --tune-pw``, 32 × 64 included at M = 2,048
    with N of 96 or 128, whose 128 blocks (4 of the 132 SMs idle) beat
    32 × 32's 192–256. ``tile`` may be given to time alternatives. A pure
    function of the shape."""
    if k < 1 or m < 1 or n < 1:
        raise ValueError(f"pw_w8a8_plan: empty product ({m}x{k})x({k}x{n})")
    if tile is None:
        tile = _STREAM_TILE if k <= 64 and n <= 64 else pw_a8_plan(m, k, n).tile
    if not 0 <= tile < len(PW_W8A8_TILES):
        raise ValueError(f"pw_w8a8_plan: no tile {tile}")
    bm, bn, threads = PW_W8A8_TILES[tile]
    grid = (-(-n // bn), -(-m // bm))
    if grid[1] > 65535:
        raise ValueError(f"pw_w8a8_plan: M={m} needs more than 65,535 row tiles of {bm}")
    return PwPlan(tile, bm, bn, threads, grid)


def pw_conv_a8(x_q, w_eff, b_eff, relu=True, quantize_out=False, tile=None):
    """Pointwise conv on int8 activations with bf16 effective weights (B7,
    the operator ``fastscnn::pw_conv_a8``).

    ``x_q`` int8 NHWC or ``(M, K)``; ``w_eff`` ``(K, N)``, the folded
    weight × the activation scale (÷ the output scale when
    ``quantize_out``), used in bf16; ``b_eff`` ``(N,)``, used in f32 (the
    kernel reads an f32 or bf16 bias as it is stored). Returns bf16, or
    int8 when ``quantize_out``, shaped like ``x_q`` with N channels.
    ``tile`` overrides the launch plan's block tile (:func:`pw_a8_plan`)."""
    return _OPS.pw_conv_a8.default(x_q, w_eff, b_eff, relu, quantize_out, tile)


def _pw_out_dtype(quantize_out: bool) -> torch.dtype:
    return torch.int8 if quantize_out else torch.bfloat16


def _pw_conv_a8_cpu(x_q, w_eff, b_eff, relu, quantize_out, tile):
    return pw_conv_a8_reference(x_q, w_eff, b_eff, relu, quantize_out)


def _pw_conv_a8_fake(x_q, w_eff, b_eff, relu, quantize_out, tile):
    _flatten(x_q, w_eff.shape[0], "pw_conv_a8")
    return x_q.new_empty((*x_q.shape[:-1], w_eff.shape[1]), dtype=_pw_out_dtype(quantize_out))


def _pw_conv_a8_cuda(x_q, w_eff, b_eff, relu, quantize_out, tile):
    k, n = w_eff.shape
    x2, lead = _flatten(x_q, k, "pw_conv_a8")
    x2 = x2.contiguous()
    _check_launch(x2, w_eff, "pw_conv_a8")
    m = x2.shape[0]
    w = w_eff.to(torch.bfloat16).contiguous()  # the model's w_eff is bf16 already: no copy
    b = (b_eff if b_eff.dtype in _DTYPE_CODE else b_eff.float()).contiguous()
    if b.device != x2.device:
        raise ValueError(f"pw_conv_a8: bias on {b.device}, activations on {x2.device}")
    out = torch.empty((m, n), dtype=_pw_out_dtype(quantize_out), device=x2.device)
    plan = pw_a8_plan(m, k, n, tile)
    avec = 16 if k % 16 == 0 and x2.data_ptr() % 16 == 0 else 4
    wvec = n % 8 == 0 and w.data_ptr() % 16 == 0
    vec_out = n % (16 // out.element_size()) == 0 and out.data_ptr() % 16 == 0
    rc = launch("int8_pw", "fastscnn_pw_conv_a8", x2.device,
        x2.data_ptr(), w.data_ptr(), _DTYPE_CODE[b.dtype], b.data_ptr(), out.data_ptr(), m, k, n,
        int(relu), int(quantize_out), plan.tile, avec, int(wvec), int(vec_out),
    )
    check(rc, "pw_conv_a8")
    pw_conv_a8.launches += 1
    return out.reshape(*lead, n)


pw_conv_a8.launches = 0


def pw_conv_w8a8(x_q, w_q, cs, b_eff, relu=True, quantize_out=False, tile=None):
    """Pointwise conv with both operands int8 (B8, the operator
    ``fastscnn::pw_conv_w8a8``).

    ``w_q`` int8 ``(K, N)``, row-major as the model folds it; ``cs``
    ``(N,)`` f32, the combined per-channel scale ``s_x · s_w[c]`` (÷ ``s_y``
    when ``quantize_out``); ``b_eff`` ``(N,)``, read by the kernel in its
    stored dtype (f32 or bf16; another dtype goes in as f32). Returns bf16,
    or int8 when ``quantize_out``, shaped like ``x_q`` with N channels.
    ``tile`` overrides the launch plan's block tile (:func:`pw_w8a8_plan`).

    The kernel runs on the int8 tensor cores (``mma.sync`` m16n8k32, s32
    sums), with the activations and the weight chunks brought in by
    ``cp.async`` through a ring of shared-memory stages and each weight
    chunk transposed there (each output channel's k contiguous, the
    layout the mma's second operand wants). Its integer sums are exact in
    any order and its epilogue is the plain version's operations, so the
    two agree bit for bit."""
    return _OPS.pw_conv_w8a8.default(x_q, w_q, cs, b_eff, relu, quantize_out, tile)


def _check_w8a8(x_q, w_q):
    if w_q.dtype != torch.int8:
        raise ValueError(f"pw_conv_w8a8 needs int8 weights, got {w_q.dtype}")
    return _flatten(x_q, w_q.shape[0], "pw_conv_w8a8")


def _pw_conv_w8a8_cpu(x_q, w_q, cs, b_eff, relu, quantize_out, tile):
    _check_w8a8(x_q, w_q)
    return pw_conv_w8a8_reference(x_q, w_q, cs, b_eff, relu, quantize_out)


def _pw_conv_w8a8_fake(x_q, w_q, cs, b_eff, relu, quantize_out, tile):
    _check_w8a8(x_q, w_q)
    return x_q.new_empty((*x_q.shape[:-1], w_q.shape[1]), dtype=_pw_out_dtype(quantize_out))


def _pw_conv_w8a8_cuda(x_q, w_q, cs, b_eff, relu, quantize_out, tile):
    k, n = w_q.shape
    x2, lead = _check_w8a8(x_q, w_q)
    x2 = x2.contiguous()
    _check_launch(x2, w_q, "pw_conv_w8a8")
    m = x2.shape[0]
    w = w_q.contiguous()
    scale = cs.float().contiguous()  # the model's cs is f32 already: no copy
    b = (b_eff if b_eff.dtype in _DTYPE_CODE else b_eff.float()).contiguous()
    for name, t in (("scale", scale), ("bias", b)):
        if t.device != x2.device:
            raise ValueError(f"pw_conv_w8a8: {name} on {t.device}, activations on {x2.device}")
    out = torch.empty((m, n), dtype=_pw_out_dtype(quantize_out), device=x2.device)
    plan = pw_w8a8_plan(m, k, n, tile)
    avec = 16 if k % 16 == 0 and x2.data_ptr() % 16 == 0 else 4
    wvec = n % 16 == 0 and w.data_ptr() % 16 == 0
    vec_out = n % (16 // out.element_size()) == 0 and out.data_ptr() % 16 == 0
    rc = launch("int8_pw", "fastscnn_pw_conv_w8a8", x2.device,
        x2.data_ptr(), w.data_ptr(), scale.data_ptr(), _DTYPE_CODE[b.dtype], b.data_ptr(),
        out.data_ptr(), m, k, n, int(relu), int(quantize_out), plan.tile, avec, int(wvec),
        int(vec_out),
    )
    check(rc, "pw_conv_w8a8")
    pw_conv_w8a8.launches += 1
    return out.reshape(*lead, n)


pw_conv_w8a8.launches = 0
