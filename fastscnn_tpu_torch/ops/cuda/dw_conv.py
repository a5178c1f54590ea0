"""Depthwise 3×3 and fused DSConv for the LTD stem: kernels B3–B6.

Counterpart of ``fastscnn_tpu/ops/pallas/dw_conv.py``:

- :func:`ds_conv3x3_pw` (B3) replaces ``ds_conv3x3_pw_pallas``:
  relu(pw1×1(cast(relu(dw3×3(x) + b_dw))) + b_pw), the dw activation
  never leaving the chip;
- :func:`ds_conv3x3_pw_multirow` (B5) replaces
  ``ds_conv3x3_pw_pallas_multirow``: B3's function, a block walking
  strips of at most ``rows_per_step`` output rows whose input rows are
  fetched into two shared-memory slots by ``cp.async`` while it computes
  the previous strip, as the TPU kernel double-buffers its DMAs
  (``csrc/ds_conv_mr.cu``); its plain version is B3's;
- :func:`dw_conv3x3` (B4) replaces ``dw_conv3x3_pallas``: depthwise 3×3
  with optional bias and ReLU;
- :func:`dw_conv3x3_vjp` (B6) replaces ``dw_conv3x3_pallas_vjp``: the
  differentiable depthwise 3×3 (no bias, no ReLU) of the training stem.
  Its forward is the B4 kernel; its backward is two kernels of
  ``csrc/dw_conv_bwd.cu``, :func:`dw_conv3x3_dx` (the transposed conv,
  JAX ``_conv_dx``) and :func:`dw_conv3x3_dw` (the per-tap reductions,
  JAX ``_conv_dw_taps``), where the JAX package used XLA ops.

All are bound by bytes on an H100 (9 FMAs per dw output, C MACs per pw
output): forward, dX and dW each move about one activation-sized tensor
in and one out (dW writes only 9 × C values). The kernels read NHWC rows
straight from device memory with bounds-checked taps (no padded or
zero-dilated copy); B3 and B5 keep their tile's dw activation in shared
memory; dW sums across blocks in two passes without atomics. The forward
(B4, B6's forward), B3's and B5's dw phases, dX and dW give a thread
``VEC`` channels moved by one load of up to 16 bytes, :func:`vec_width` of
C, the dtype and the pointers' alignment, and a block of outputs whose
shared inputs stay in registers (dX at stride 2: 2 × 2 cells of dX split
by parity); B3's and B5's 1x1 phases give a thread 4 pixels by 8 output
channels. Their launch plans (:func:`dw_fwd_plan`, :func:`ds_plan`,
:func:`mr_plan`, :func:`dx_plan`, :func:`dw_plan`) are functions of the
shape. See the sources for the designs.

Each wrapper calls its operator ``fastscnn::<name>`` (:mod:`.library`),
whose CPU implementation is the plain PyTorch version (``*_reference``)
and whose CUDA implementation (``_<name>_cuda`` here) launches the
kernel, raising on what the kernel does not take; it never falls back.
The kernel's launches count in the wrapper's ``launches`` attribute. The
plain versions do the kernel's f32 operations in the kernel's order, so
the two agree bit for bit — except dW, whose plain version sums in
tensor-reduction order (the two agree to f32 reassociation).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fastscnn_tpu_torch.ops.conv import conv_dw_taps, conv_out_len
from fastscnn_tpu_torch.ops.cuda._build import check, launch

_OPS = torch.ops.fastscnn  # the operators of .library, registered when the package loads

__all__ = [
    "dw_conv3x3",
    "ds_conv3x3_pw",
    "ds_conv3x3_pw_multirow",
    "dw_conv3x3_vjp",
    "dw_conv3x3_dx",
    "dw_conv3x3_dw",
    "dw_conv3x3_reference",
    "ds_conv3x3_pw_reference",
    "dw_conv3x3_dx_reference",
    "dw_conv3x3_dw_reference",
    "ds_plan",
    "mr_plan",
    "dx_plan",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_dw_args(x: torch.Tensor, w: torch.Tensor, stride: int, name: str):
    if x.ndim != 4:
        raise ValueError(f"{name} needs NHWC input, got shape {tuple(x.shape)}")
    kh, kw, mult, c = w.shape
    if (kh, kw, mult) != (3, 3, 1) or c != x.shape[-1]:
        raise ValueError(f"{name} needs (3,3,1,C) weights, got {tuple(w.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")


def _check_pw_weights(x: torch.Tensor, w_pw: torch.Tensor):
    c = x.shape[-1]
    if w_pw.ndim != 4 or tuple(w_pw.shape[:3]) != (1, 1, c):
        raise ValueError(f"pw weights must be (1,1,{c},Cout), got {tuple(w_pw.shape)}")


def _kernel_input(x: torch.Tensor, name: str) -> int:
    """Validate a tensor for the CUDA kernels; return its dtype code."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA device, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: kernel takes a contiguous NHWC tensor")
    return _DTYPE_CODE[x.dtype]


def _out_hw(x: torch.Tensor, stride: int, padding: int, name: str):
    n, h, wd, _ = x.shape
    ho, wo = conv_out_len(h, 3, stride, padding), conv_out_len(wd, 3, stride, padding)
    if min(n, ho, wo) < 1 or ho > 65535 or n > 65535:
        raise ValueError(f"{name}: unsupported shape {tuple(x.shape)} (out {ho}x{wo})")
    return ho, wo


def _fake_nhwc(x: torch.Tensor, stride: int, padding: int, c: int) -> torch.Tensor:
    """An empty (N, Ho, Wo, ``c``) tensor like ``x``: the output a fake
    implementation gives for a 3×3 conv of ``x``."""
    n, h, wd, _ = x.shape
    return x.new_empty((n, conv_out_len(h, 3, stride, padding), conv_out_len(wd, 3, stride, padding),
                        c))


def vec_width(c: int, itemsize: int, ptrs) -> int:
    """Channels a thread of the forward and dW kernels owns (``VEC``): the
    largest power of two with ``VEC * itemsize <= 16`` bytes that divides
    ``c`` and to whose width, ``VEC * itemsize`` bytes, every activation
    pointer is aligned; down to 1. C = 32 and 48 get 8 in bf16 and 4 in
    f32."""
    vec = 16 // itemsize
    while vec > 1 and (c % vec or any(p % (vec * itemsize) for p in ptrs)):
        vec //= 2
    return vec


# -- the forward kernel's launch plan (csrc/dw_conv.cu, dw_conv3x3_kernel) ----
_FWD_THREADS = 128  # kFwdThreads: a block's threads at most; C / VEC beyond it
                    # takes channel groups
FWD_COLS = (2, 3, 4)  # output columns a thread the kernel is built for (3 and 4 at
                      # the widest VEC only)
# blocks of 128 threads an H100 SM holds by registers at 2, 3 and 4 columns
# (93, 127 and 164 a thread at bf16 VEC 8; chip_smoke.py --tune-dw prints them)
_FWD_RESIDENT = {2: 5, 3: 4, 4: 3}
_SMS = 132


class FwdPlan(NamedTuple):
    """Launch plan of the forward kernel (see :func:`dw_fwd_plan`)."""
    cols: int               # output columns a thread
    rows: int               # output rows a thread
    block: tuple[int, int]  # (channel vectors, column groups)
    tiles: int              # column tiles
    groups: int             # channel groups
    grid: tuple[int, int, int]


@functools.lru_cache(maxsize=256)
def dw_fwd_plan(n: int, ho: int, wo: int, c: int, vec: int, itemsize: int,
                rows: int | None = None, cols: int | None = None) -> FwdPlan:
    """Launch plan of the forward kernel: block ``(C / VEC, column groups)``
    of at most 128 threads (channel groups of at most 128 vectors), each
    thread ``cols`` output columns by ``rows`` output rows. ``cols`` is 4
    at the widest VEC (``VEC * itemsize == 16``), else 2 (the only count
    built for narrower VECs). ``rows`` is 16, halved while the grid fills
    less than 0.6 of one wave of the blocks the SMs hold at that column
    count (16, 8, 4 and 2 rows at the training and serving dsconv1 and
    dsconv2 at any column count). ``chip_smoke.py --tune-dw`` times every
    column count by 1 to 16 rows at those four sites: this rule picks the
    fastest rows (or one within 1 %) for each, and 4 columns is the
    fastest count or within 2 % of it at each, and the fastest over the
    sites of a step and of a frame. ``rows`` and ``cols`` may be given to
    time alternatives. ``grid = (tiles * groups, ceil(Ho / rows), N)``. A
    pure function of the shape."""
    if cols is None:
        cols = 4 if vec * itemsize == 16 else 2
    if cols not in FWD_COLS or (cols != 2 and vec * itemsize != 16):
        raise ValueError(f"dw_fwd_plan: {cols} columns a thread not built for VEC {vec}")
    return FwdPlan(cols, *_vec_grid(n, ho, wo, c, vec, cols, rows, _FWD_RESIDENT[cols]))


def _vec_grid(n: int, units_h: int, units_w: int, c: int, vec: int, cols: int,
              rows: int | None, resident: int, most: int = 16):
    """The grid of the vector kernels (the forward and dX): a block of
    ``(C / VEC, column groups)`` threads, at most 128 (channel groups of at
    most 128 vectors), each thread ``cols`` column units by ``rows`` row
    units. ``rows`` is ``most``, halved while the grid fills less than 0.6
    of one wave of ``resident`` blocks an SM. Returns (rows, block, tiles,
    groups, grid)."""
    cv = c // vec
    bx = min(cv, _FWD_THREADS)
    groups = -(-cv // bx)
    col_groups = -(-units_w // cols)
    tiles = -(-col_groups // (_FWD_THREADS // bx))
    by = -(-col_groups // tiles)
    if rows is None:
        rows = most
        while rows > 1 and tiles * groups * -(-units_h // rows) * n < 0.6 * resident * _SMS:
            rows //= 2
    if rows < 1:
        raise ValueError(f"rows must be >= 1, got {rows}")
    return rows, (bx, by), tiles, groups, (tiles * groups, -(-units_h // rows), n)


def _as_kernel_weights(t: torch.Tensor) -> torch.Tensor:
    """Weights or bias as the forward kernel reads them: f32 or bf16 (it
    widens bf16 to f32 exactly, as ``.float()`` does) and contiguous;
    other dtypes become f32."""
    return (t if t.dtype in _DTYPE_CODE else t.float()).contiguous()


def _dw_taps_f32(x, w, b, stride, padding, relu):
    """The 9 taps in (di, dj) order in f32 from a zero-padded copy, then
    + bias and ReLU — the kernel's sequence of operations."""
    n, h, wd, c = x.shape
    ho, wo = conv_out_len(h, 3, stride, padding), conv_out_len(wd, 3, stride, padding)
    xp = F.pad(x.float(), (0, 0, padding, padding, padding, padding))
    w9 = w.float().reshape(9, c)
    acc = torch.zeros((n, ho, wo, c), dtype=torch.float32, device=x.device)
    for di in range(3):
        for dj in range(3):
            xv = xp[:, di : di + (ho - 1) * stride + 1 : stride, dj : dj + (wo - 1) * stride + 1 : stride]
            acc = acc + xv * w9[di * 3 + dj]
    if b is not None:
        acc = acc + b.float()
    return acc.clamp_min(0.0) if relu else acc


def dw_conv3x3_reference(x, w, b=None, stride=1, padding=1, relu=False):
    """Plain PyTorch version of B4."""
    _check_dw_args(x, w, stride, "dw_conv3x3")
    return _dw_taps_f32(x, w, b, stride, padding, relu).to(x.dtype)


def ds_conv3x3_pw_reference(x, w_dw, b_dw, w_pw, b_pw, stride=1, padding=1):
    """Plain PyTorch version of B3 and B5: the dw activation rounds to the input
    dtype before the 1×1 (as the unfused graph hands it over), and the
    1×1 accumulates over input channels in order, in f32."""
    _check_dw_args(x, w_dw, stride, "ds_conv3x3_pw")
    c, cout = w_pw.shape[2], w_pw.shape[3]
    mid = _dw_taps_f32(x, w_dw, b_dw, stride, padding, relu=True).to(x.dtype).float()
    wpw = w_pw.reshape(c, cout).to(x.dtype).float()
    acc = torch.zeros((*mid.shape[:3], cout), dtype=torch.float32, device=x.device)
    for ci in range(c):
        acc = acc + mid[..., ci : ci + 1] * wpw[ci]
    acc = acc + b_pw.float()
    return acc.clamp_min(0.0).to(x.dtype)


def dw_conv3x3(x, w, b=None, stride=1, padding=1, relu=False, rows=None, cols=None):
    """Depthwise 3×3 [+bias][+ReLU], NHWC x, (3,3,1,C) w, multiplier 1;
    output in the input dtype, f32 accumulation (kernel B4, the operator
    ``fastscnn::dw_conv3x3``). ``rows`` and ``cols`` override the launch
    plan's (:func:`dw_fwd_plan`); the result is the same bits."""
    return _OPS.dw_conv3x3.default(x, w, b, stride, padding, relu, rows, cols)


def _dw_conv3x3_cpu(x, w, b, stride, padding, relu, rows, cols):
    return dw_conv3x3_reference(x, w, b, stride, padding, relu)


def _dw_conv3x3_fake(x, w, b, stride, padding, relu, rows, cols):
    _check_dw_args(x, w, stride, "dw_conv3x3")
    return _fake_nhwc(x, stride, padding, x.shape[-1])


def _dw_conv3x3_cuda(x, w, b, stride, padding, relu, rows, cols):
    _check_dw_args(x, w, stride, "dw_conv3x3")
    code = _kernel_input(x, "dw_conv3x3")
    n, h, wd, c = x.shape
    ho, wo = _out_hw(x, stride, padding, "dw_conv3x3")
    w9 = _as_kernel_weights(w.reshape(9, c))
    bias = None if b is None else _as_kernel_weights(b)
    out = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
    itemsize = x.element_size()
    vec = vec_width(c, itemsize, (x.data_ptr(), out.data_ptr()))
    plan = dw_fwd_plan(n, ho, wo, c, vec, itemsize, rows, cols)
    rc = launch("dw_conv", "fastscnn_dw_conv3x3", x.device,
        code, x.data_ptr(), _DTYPE_CODE[w9.dtype], w9.data_ptr(),
        _DTYPE_CODE[w9.dtype if bias is None else bias.dtype],
        None if bias is None else bias.data_ptr(), out.data_ptr(), n, h, wd, c, ho, wo, stride,
        padding, int(relu), vec, plan.cols, plan.rows, *plan.block, plan.tiles, plan.groups,
    )
    check(rc, "dw_conv3x3")
    dw_conv3x3.launches += 1
    return out


dw_conv3x3.launches = 0


# -- B3's launch plan (csrc/dw_conv.cu, ds_conv3x3_pw_kernel) -----------------
_DS_TILE_W = 64    # kDsTileW: output columns a block
_DS_PIX = 4        # kDsPix: neighbouring pixels a thread in the 1×1 phase
_DS_CO = 8         # kDsCo: output channels a thread in the 1×1 phase
_DS_THREADS = 256  # kDsThreads: a block's threads at most
_DS_SMEM = 227 * 1024  # an H100 block's shared memory at most


class DsPlan(NamedTuple):
    """Launch plan of B3's kernel (see :func:`ds_plan`)."""
    rows: int                   # output rows a block
    block: tuple[int, int]      # (output-channel groups of 8, pixel-group stride)
    grid: tuple[int, int, int]  # (column tiles of 64, row strips, N)
    smem: int                   # dynamic shared memory, bytes


# registers a thread of B3's kernel takes, rounded up to the allocation unit
# (122 at bf16 VEC 8 stride 2; chip_smoke.py --tune-dw prints them)
_DS_REGS = 128


def _pw_block(cout: int, pix_groups: int) -> tuple[int, int]:
    """The block of B3's and B5's 1×1 phase: output-channel groups of 8 by
    a pixel-group stride, the largest power of two that divides the
    block's ``pix_groups`` groups of 4 pixels with at most 256 threads in
    all, so that every thread makes as many groups as the others."""
    cog = -(-cout // _DS_CO)
    by = 1
    while by * 2 * cog <= _DS_THREADS and pix_groups % (by * 2) == 0:
        by *= 2
    return cog, by


def _ds_block(c: int, cout: int, rows: int):
    """B3's block (output-channel groups of 8, pixel-group stride) at
    ``rows`` output rows, and its dynamic shared memory in bytes."""
    cog, by = _pw_block(cout, rows * _DS_TILE_W // _DS_PIX)
    cop = cog * _DS_CO
    return (cog, by), 4 * (-(-10 * c // 4) * 4 + c * cop + cop + c * rows * _DS_TILE_W)


@functools.lru_cache(maxsize=256)
def ds_plan(n: int, ho: int, wo: int, c: int, cout: int, rows: int | None = None) -> DsPlan:
    """Launch plan of B3's kernel. A block makes ``rows`` output rows by 64
    output columns; its threads are (⌈Cout / 8⌉, pixel-group stride), at
    most 256, each of 4 pixels by 8 output channels in the 1×1 phase, the
    stride a power of two that divides the block's pixel groups so that
    every thread makes as many as the others. ``rows`` is 8, halved while
    the grid fills less than 0.9 of one wave of the blocks the SMs hold
    (by registers and shared memory): 8 at serving dsconv1 (256 blocks)
    and at the training sites, 2 at serving dsconv2 (256 blocks).
    ``chip_smoke.py --tune-dw`` times 1 to 8 rows at the serving sites:
    this rule picks the fastest at both. Shared memory: the 9 dw taps and
    bias, the 1×1 weights and bias (Cout padded to a multiple of 8) and
    the block's dw activation, all f32. ``rows`` may be given to time
    alternatives. A pure function of the shape."""
    if -(-cout // _DS_CO) > _DS_THREADS:
        raise ValueError(f"ds_plan: Cout={cout} exceeds {_DS_THREADS * _DS_CO} output channels")
    tiles = -(-wo // _DS_TILE_W)

    def resident(rows):  # blocks an SM holds
        (cog, by), smem = _ds_block(c, cout, rows)
        threads = -(-cog * by // 32) * 32
        return max(1, min(65536 // (threads * _DS_REGS), 232448 // (smem + 1024)))

    if rows is None:
        rows = 8
        while rows > 1 and tiles * -(-ho // rows) * n < 0.9 * resident(rows) * _SMS:
            rows //= 2
    if rows < 1:
        raise ValueError(f"ds_plan: rows must be >= 1, got {rows}")
    block, smem = _ds_block(c, cout, rows)
    return DsPlan(rows, block, (tiles, -(-ho // rows), n), smem)


def ds_conv3x3_pw(x, w_dw, b_dw, w_pw, b_pw, stride=1, padding=1, rows=None):
    """The whole folded DSConv in one kernel (B3, the operator
    ``fastscnn::ds_conv3x3_pw``):
    relu(pw1×1(cast(relu(dw3×3(x) + b_dw))) + b_pw), NHWC, HWIO weights.
    The kernel reads weights and biases as they are stored (f32 or bf16).
    ``rows`` overrides the launch plan's (:func:`ds_plan`); the result is
    the same bits."""
    return _OPS.ds_conv3x3_pw.default(x, w_dw, b_dw, w_pw, b_pw, stride, padding, rows)


def _check_ds_args(x, w_dw, w_pw, stride, name):
    _check_dw_args(x, w_dw, stride, name)
    _check_pw_weights(x, w_pw)


def _ds_conv3x3_pw_cpu(x, w_dw, b_dw, w_pw, b_pw, stride, padding, rows):
    _check_ds_args(x, w_dw, w_pw, stride, "ds_conv3x3_pw")
    return ds_conv3x3_pw_reference(x, w_dw, b_dw, w_pw, b_pw, stride, padding)


def _ds_conv3x3_pw_fake(x, w_dw, b_dw, w_pw, b_pw, stride, padding, rows):
    _check_ds_args(x, w_dw, w_pw, stride, "ds_conv3x3_pw")
    return _fake_nhwc(x, stride, padding, w_pw.shape[3])


def _ds_conv3x3_pw_cuda(x, w_dw, b_dw, w_pw, b_pw, stride, padding, rows):
    _check_ds_args(x, w_dw, w_pw, stride, "ds_conv3x3_pw")
    n, h, wd, c = x.shape
    cout = w_pw.shape[3]
    ho, wo = _out_hw(x, stride, padding, "ds_conv3x3_pw")
    plan = ds_plan(n, ho, wo, c, cout, rows)
    if plan.smem > _DS_SMEM:
        raise ValueError(f"ds_conv3x3_pw: C={c}, Cout={cout} at {plan.rows} rows a block need "
                         f"{plan.smem} bytes of shared memory, more than 227 KB")
    code = _kernel_input(x, "ds_conv3x3_pw")
    w9 = _as_kernel_weights(w_dw.reshape(9, c))
    bd = _as_kernel_weights(b_dw)
    wpw = _as_kernel_weights(w_pw.reshape(c, cout))
    bp = _as_kernel_weights(b_pw)
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    vec = vec_width(c, x.element_size(), (x.data_ptr(),))
    vec_out = cout % _DS_CO == 0 and out.data_ptr() % 16 == 0
    rc = launch("dw_conv", "fastscnn_ds_conv3x3_pw", x.device,
        code, x.data_ptr(), _DTYPE_CODE[w9.dtype], w9.data_ptr(), _DTYPE_CODE[bd.dtype],
        bd.data_ptr(), _DTYPE_CODE[wpw.dtype], wpw.data_ptr(), _DTYPE_CODE[bp.dtype],
        bp.data_ptr(), out.data_ptr(), n, h, wd, c, cout, ho, wo, stride, padding, vec, plan.rows,
        *plan.block, int(vec_out),
    )
    check(rc, "ds_conv3x3_pw")
    ds_conv3x3_pw.launches += 1
    return out


ds_conv3x3_pw.launches = 0

# -- B5's launch plan (csrc/ds_conv_mr.cu, ds_conv3x3_pw_mr_kernel) ------------
# Its 1×1 phase is B3's: kMrPix, kMrCo and kMrThreads equal _DS_PIX, _DS_CO
# and _DS_THREADS.
_MR_TILES = (32, 16, 8, 4)  # output columns a block the plan tries, widest first
_MR_PIXELS = 128    # output pixels a strip the plan aims at
_MR_WAVE = 2 * _SMS  # blocks the plan's grid aims at: two an SM


class MrPlan(NamedTuple):
    """Launch plan of B5's kernel (see :func:`mr_plan`)."""
    rows: int                   # output rows a strip
    tile: int                   # output columns a block
    strips: int                 # strips a block walks
    block: tuple[int, int]      # (output-channel groups of 8, pixel-group stride)
    grid: tuple[int, int, int]  # (column tiles, strip groups, N)
    smem: int                   # dynamic shared memory, bytes


def _mr_smem_bytes(c: int, cout: int, rows: int, tile: int, stride: int, itemsize: int) -> int:
    """Dynamic shared memory of one B5 block (``mr_smem_bytes`` in the
    source): the f32 dw taps and bias, the 1×1 weights and bias (Cout
    padded to a multiple of 8), two strips' f32 dw activations, and two
    input slots of ``(rows - 1) * stride + 3`` rows by ``(tile - 1) *
    stride + 3`` columns by C, each rounded up to 16 bytes."""
    cop = -(-cout // _DS_CO) * _DS_CO
    slot = ((rows - 1) * stride + 3) * ((tile - 1) * stride + 3) * c * itemsize
    return (4 * (-(-10 * c // 4) * 4 + c * cop + cop + 2 * c * rows * tile)
            + 2 * (-(-slot // 16) * 16))


@functools.lru_cache(maxsize=256)
def mr_plan(n: int, ho: int, wo: int, c: int, cout: int, stride: int, itemsize: int,
            rows_per_step: int = 8, rows: int | None = None, tile: int | None = None,
            strips: int | None = None) -> MrPlan:
    """Launch plan of B5's kernel. A block owns ``tile`` output columns and
    walks ``strips`` strips of ``rows`` output rows down one image, each
    strip's input rows staged in one of two shared-memory slots while the
    block computes the previous strip. ``tile`` is the widest of 32, 16, 8
    and 4 and ``rows`` the most, a power of two at most ``rows_per_step``
    and at most 128 pixels a strip, whose block fits 227 KB of shared
    memory: 32 × 4 at both serving sites in bf16. ``strips`` is at least
    2 and makes the grid at most about one wave of two blocks an SM (264
    on 132 SMs): 4 and 2 there (256 and 128 blocks). The block is the 1×1
    phase's (:func:`_pw_block`). ``chip_smoke.py --tune-dw`` times tiles
    of 16 to 64 columns by 1 to 8 rows by 1 to 8 strips at the serving
    sites: 128 pixels a strip at a 16- or 32-column tile, 4 and 2 strips
    a block, is the fastest at both. ``rows``, ``tile`` and ``strips`` may
    be given to time alternatives; ``rows_per_step`` bounds only the
    plan's own choice. Raises where no block fits. A pure function of the
    shape."""
    if -(-cout // _DS_CO) > _DS_THREADS:
        raise ValueError(f"mr_plan: Cout={cout} exceeds {_DS_THREADS * _DS_CO} output channels")
    if rows_per_step < 1:
        raise ValueError(f"rows_per_step must be >= 1, got {rows_per_step}")
    for name, v in (("rows", rows), ("strips", strips)):
        if v is not None and v < 1:
            raise ValueError(f"mr_plan: {name} must be >= 1, got {v}")
    if tile is not None and (tile < _DS_PIX or tile % _DS_PIX):
        raise ValueError(f"mr_plan: tile must be a positive multiple of {_DS_PIX}, got {tile}")

    def smem(r, t):
        return _mr_smem_bytes(c, cout, r, t, stride, itemsize)

    options = []
    for t in (_MR_TILES if tile is None else (tile,)):
        most = min(rows_per_step, max(1, _MR_PIXELS // t))
        options += [(t, r) for r in ([rows] if rows is not None else
                                     [1 << k for k in range(most.bit_length() - 1, -1, -1)])]
    fits = [o for o in options if smem(*o) <= _DS_SMEM]
    if not fits:
        t, r = options[-1]
        raise ValueError(f"ds_conv3x3_pw_multirow: C={c}, Cout={cout} at {r} rows by {t} "
                         f"columns need {smem(r, t)} bytes of shared memory, more than 227 KB")
    tile, rows = fits[0]
    tiles, nstrips = -(-wo // tile), -(-ho // rows)
    if strips is None:  # at least two, so that a block has a copy to overlap
        strips = max(2, -(-tiles * nstrips * n // _MR_WAVE))
    strips = min(strips, nstrips)
    grid = (tiles, -(-nstrips // strips), n)
    if grid[1] > 65535 or n > 65535:
        raise ValueError(f"ds_conv3x3_pw_multirow: grid {grid} exceeds CUDA's limits")
    return MrPlan(rows, tile, strips, _pw_block(cout, rows * tile // _DS_PIX), grid,
                  smem(rows, tile))


def _mr_args(x, w_dw, b_dw, w_pw, b_pw, out, stride, padding, plan):
    """The C entry's arguments for B5, and the tensors they point into.
    The kernel reads the weights and biases as they are stored (f32 or
    bf16, each with its own dtype code): no cast, no copy of a contiguous
    tensor."""
    n, h, wd, c = x.shape
    cout, ho, wo = out.shape[3], out.shape[1], out.shape[2]
    w9, bd, wpw, bp = (_as_kernel_weights(t) for t in
                       (w_dw.reshape(9, c), b_dw, w_pw.reshape(c, cout), b_pw))
    vec = vec_width(c, x.element_size(), (x.data_ptr(),))
    vec_out = cout % _DS_CO == 0 and out.data_ptr() % 16 == 0
    args = (_DTYPE_CODE[x.dtype], x.data_ptr(),
            *(v for t in (w9, bd, wpw, bp) for v in (_DTYPE_CODE[t.dtype], t.data_ptr())),
            out.data_ptr(), n, h, wd, c, cout, ho, wo, stride, padding, vec, plan.rows, plan.tile,
            plan.strips, *plan.block, int(vec_out))
    return args, (w9, bd, wpw, bp)


def ds_conv3x3_pw_multirow(x, w_dw, b_dw, w_pw, b_pw, stride=1, padding=1, rows_per_step=8,
                           rows=None, tile=None, strips=None):
    """B3's function in the multi-row kernel (B5, the operator
    ``fastscnn::ds_conv3x3_pw_multirow``): a block walks strips of
    at most ``rows_per_step`` output rows down one column tile, each
    strip's input rows fetched into shared memory while the block computes
    the previous one (:func:`mr_plan`). Any shape; a ragged last tile or
    strip is masked. The kernel reads weights and biases as they are
    stored (f32 or bf16). ``rows``, ``tile`` and ``strips`` override the
    plan's; neither they nor ``rows_per_step`` change the result. Its plain
    version is :func:`ds_conv3x3_pw_reference`, which it equals bit for
    bit."""
    return _OPS.ds_conv3x3_pw_multirow.default(x, w_dw, b_dw, w_pw, b_pw, stride, padding,
                                               rows_per_step, rows, tile, strips)


def _check_mr_args(x, w_dw, w_pw, stride, rows_per_step):
    _check_ds_args(x, w_dw, w_pw, stride, "ds_conv3x3_pw_multirow")
    if rows_per_step < 1:
        raise ValueError(f"rows_per_step must be >= 1, got {rows_per_step}")


def _ds_conv3x3_pw_multirow_cpu(x, w_dw, b_dw, w_pw, b_pw, stride, padding, rows_per_step, rows,
                                tile, strips):
    _check_mr_args(x, w_dw, w_pw, stride, rows_per_step)
    return ds_conv3x3_pw_reference(x, w_dw, b_dw, w_pw, b_pw, stride, padding)


def _ds_conv3x3_pw_multirow_fake(x, w_dw, b_dw, w_pw, b_pw, stride, padding, rows_per_step, rows,
                                 tile, strips):
    _check_mr_args(x, w_dw, w_pw, stride, rows_per_step)
    return _fake_nhwc(x, stride, padding, w_pw.shape[3])


def _ds_conv3x3_pw_multirow_cuda(x, w_dw, b_dw, w_pw, b_pw, stride, padding, rows_per_step, rows,
                                 tile, strips):
    _check_mr_args(x, w_dw, w_pw, stride, rows_per_step)
    _kernel_input(x, "ds_conv3x3_pw_multirow")
    n, _, _, c = x.shape
    cout = w_pw.shape[3]
    ho, wo = _out_hw(x, stride, padding, "ds_conv3x3_pw_multirow")
    plan = mr_plan(n, ho, wo, c, cout, stride, x.element_size(), rows_per_step, rows, tile,
                   strips)
    out = torch.empty((n, ho, wo, cout), dtype=x.dtype, device=x.device)
    args, _keep = _mr_args(x, w_dw, b_dw, w_pw, b_pw, out, stride, padding, plan)
    rc = launch("ds_conv_mr", "fastscnn_ds_conv3x3_pw_mr", x.device, *args)
    check(rc, "ds_conv3x3_pw_multirow")
    ds_conv3x3_pw_multirow.launches += 1
    return out


ds_conv3x3_pw_multirow.launches = 0


# -- B6: the differentiable depthwise 3×3 of the training stem ----------------
_DW_BLOCKS = 6 * 132  # pass-1 blocks to aim at: two waves of the three blocks an
                      # H100 SM holds at VEC 8 (chip_smoke.py --tune-dw prints the
                      # registers and times the alternatives)
_DW_GROUP = 32        # channel vectors a pass-1 block covers at most (one warp)


def _check_bwd_shapes(g, x_shape, stride, padding, name):
    n, h, wd, c = x_shape
    want = (n, conv_out_len(h, 3, stride, padding), conv_out_len(wd, 3, stride, padding), c)
    if tuple(g.shape) != want:
        raise ValueError(f"{name}: gradient shape {tuple(g.shape)}, expected {want}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")


def dw_conv3x3_dx_reference(g, w, stride, padding, x_shape):
    """Plain PyTorch version of the dX kernel: each tap's ``g · w[tap]``
    added, taps in (di, dj) order, into an f32 buffer with the input's
    padding, then cropped — per element the kernel's f32 operations in
    the kernel's order. Output in ``g``'s dtype."""
    _check_bwd_shapes(g, x_shape, stride, padding, "dw_conv3x3_dx")
    n, h, wd, c = x_shape
    ho, wo = g.shape[1], g.shape[2]
    gf = g.float()
    w9 = w.float().reshape(9, c)
    acc = torch.zeros((n, h + 2 * padding, wd + 2 * padding, c), dtype=torch.float32,
                      device=g.device)
    for di in range(3):
        for dj in range(3):
            acc[:, di : di + (ho - 1) * stride + 1 : stride,
                dj : dj + (wo - 1) * stride + 1 : stride] += gf * w9[di * 3 + dj]
    return acc[:, padding : padding + h, padding : padding + wd].to(g.dtype)


def dw_conv3x3_dw_reference(x, g, stride, padding, out_dtype=torch.float32):
    """Plain PyTorch version of the dW kernel: the JAX package's
    ``_conv_dw_taps`` (a multiply-reduce over (N, Ho, Wo) per tap, in f32),
    as (3, 3, 1, C) in ``out_dtype``."""
    _check_bwd_shapes(g, x.shape, stride, padding, "dw_conv3x3_dw")
    return conv_dw_taps(x, g, 3, 3, stride, padding, groups=x.shape[-1]).to(out_dtype)


# -- dX's launch plan (csrc/dw_conv_bwd.cu, dw_conv3x3_dx_kernel) -------------
DX_COLS = (1, 2, 4)  # column units a thread the kernel is built for (1 and 4 at the
                     # widest VEC only); a unit is a 2 × 2 cell at stride 2
# blocks of 128 threads an H100 SM holds by registers at 1, 2 and 4 units
# (77, 87 and 128 a thread at bf16 VEC 8 stride 2; chip_smoke.py --tune-dw
# prints them)
_DX_RESIDENT = {1: 6, 2: 5, 4: 4}
_DX_ROWS = 2  # row units a thread at most (2 cell rows, 4 dX rows at stride 2)


class DxPlan(NamedTuple):
    """Launch plan of the dX kernel (see :func:`dx_plan`)."""
    cols: int               # column units a thread
    rows: int               # row units a thread walks
    block: tuple[int, int]  # (channel vectors, column groups)
    tiles: int              # column tiles
    groups: int             # channel groups
    grid: tuple[int, int, int]


def dx_units(h: int, w: int, stride: int, padding: int) -> tuple[int, int]:
    """dX's row and column units: at stride 2 the 2 × 2 cells, whose first
    row (and column) is ``2 * floor((padding - 1) / 2) + 1 - padding``, 0
    or -1; at stride 1 the pixels."""
    if stride == 1:
        return h, w
    first = 2 * ((padding - 1) // 2) + 1 - padding
    return (h - first + 1) // 2, (w - first + 1) // 2


@functools.lru_cache(maxsize=256)
def dx_plan(n: int, h: int, w: int, c: int, vec: int, itemsize: int, stride: int, padding: int,
            rows: int | None = None, cols: int | None = None) -> DxPlan:
    """Launch plan of the dX kernel, on the forward's grid rule
    (:func:`dw_fwd_plan`) over dX's units (:func:`dx_units`): block
    ``(C / VEC, column groups)`` of at most 128 threads, each thread
    ``cols`` units across (2 cells, 4 dX columns, at stride 2) by ``rows``
    units down, 2 halved while the grid fills less than 0.6 of a wave: a
    thread makes a 4 × 4 block of dX pixels at both training sites.
    ``chip_smoke.py --tune-dw`` times 1, 2 and 4 cells by 1 to 16 cell
    rows there: 2 × 2 is the fastest or within 2 % of it at each (2 × 16
    is 11 % slower at dsconv1: a thread walks too long a column of
    cells). ``rows`` and ``cols`` may be given to time alternatives.
    ``grid = (tiles * groups, ⌈units_h / rows⌉, N)``. A pure function of
    the shape."""
    if cols is None:
        cols = 2
    if cols not in DX_COLS or (cols != 2 and vec * itemsize != 16):
        raise ValueError(f"dx_plan: {cols} column units a thread not built for VEC {vec}")
    units_h, units_w = dx_units(h, w, stride, padding)
    return DxPlan(cols, *_vec_grid(n, units_h, units_w, c, vec, cols, rows, _DX_RESIDENT[cols],
                                   _DX_ROWS))


def dw_conv3x3_dx(g, w, stride=1, padding=1, x_shape=None, rows=None, cols=None):
    """Input gradient of the depthwise 3×3 (kernel B6, dX; the operator
    ``fastscnn::dw_conv3x3_dx``): NHWC ``g`` of the output, (3, 3, 1, C)
    ``w`` (read as stored, f32 or bf16) → dX of shape ``x_shape`` in
    ``g``'s dtype, f32 accumulation. ``rows`` and ``cols`` override the
    launch plan's (:func:`dx_plan`); the result is the same bits."""
    if x_shape is None:
        raise ValueError("dw_conv3x3_dx needs x_shape, the forward input's shape")
    return _OPS.dw_conv3x3_dx.default(g, w, stride, padding, list(x_shape), rows, cols)


def _dw_conv3x3_dx_cpu(g, w, stride, padding, x_shape, rows, cols):
    return dw_conv3x3_dx_reference(g, w, stride, padding, x_shape).contiguous()


def _dw_conv3x3_dx_fake(g, w, stride, padding, x_shape, rows, cols):
    _check_bwd_shapes(g, x_shape, stride, padding, "dw_conv3x3_dx")
    return g.new_empty(tuple(x_shape))


def _dw_conv3x3_dx_cuda(g, w, stride, padding, x_shape, rows, cols):
    _check_bwd_shapes(g, x_shape, stride, padding, "dw_conv3x3_dx")
    code = _kernel_input(g, "dw_conv3x3_dx")
    n, h, wd, c = x_shape
    w9 = _as_kernel_weights(w.reshape(9, c))
    dx = torch.empty(tuple(x_shape), dtype=g.dtype, device=g.device)
    itemsize = g.element_size()
    vec = vec_width(c, itemsize, (g.data_ptr(), dx.data_ptr()))
    plan = dx_plan(n, h, wd, c, vec, itemsize, stride, padding, rows, cols)
    if plan.grid[1] > 65535 or n > 65535:
        raise ValueError(f"dw_conv3x3_dx: unsupported shape {tuple(x_shape)}")
    rc = launch("dw_conv_bwd", "fastscnn_dw_conv3x3_dx", g.device,
        code, g.data_ptr(), _DTYPE_CODE[w9.dtype], w9.data_ptr(), dx.data_ptr(), n, h, wd, c,
        g.shape[1], g.shape[2], stride, padding, vec, plan.cols, plan.rows, *plan.block,
        plan.tiles, plan.groups,
    )
    check(rc, "dw_conv3x3_dx")
    dw_conv3x3_dx.launches += 1
    return dx


dw_conv3x3_dx.launches = 0


def dw_plan(n_rows: int, c: int, vec: int, target: int = _DW_BLOCKS):
    """Pass-1 launch plan of the dW kernel: (rows per block, blocks,
    channel groups). Each block takes a run of consecutive (n, ho) output
    rows, about ``target`` blocks in all (by default two whole waves), and
    at most 32 channel vectors (grid.y covers the rest). Depends on the
    shape only, so a given shape always sums in the same order."""
    rows = -(-n_rows // target)
    return rows, -(-n_rows // rows), -(-(c // vec) // _DW_GROUP)


def dw_conv3x3_dw(x, g, stride=1, padding=1, out_dtype=torch.float32, blocks=None):
    """Weight gradient of the depthwise 3×3 (kernel B6, dW; the operator
    ``fastscnn::dw_conv3x3_dw``): NHWC ``x`` and output gradient ``g`` →
    (3, 3, 1, C) in ``out_dtype`` (f32 or bf16), summed over (N, Ho, Wo)
    in f32 in two passes through an f32 scratch tensor of (9·C, blocks)
    partials. ``blocks`` overrides the pass-1 blocks :func:`dw_plan` aims
    at (another summation order)."""
    return _OPS.dw_conv3x3_dw.default(x, g, stride, padding, out_dtype, blocks)


def _dw_conv3x3_dw_cpu(x, g, stride, padding, out_dtype, blocks):
    return dw_conv3x3_dw_reference(x, g, stride, padding, out_dtype or torch.float32)


def _dw_conv3x3_dw_fake(x, g, stride, padding, out_dtype, blocks):
    _check_bwd_shapes(g, x.shape, stride, padding, "dw_conv3x3_dw")
    return x.new_empty((3, 3, 1, x.shape[-1]), dtype=out_dtype or torch.float32)


def _dw_conv3x3_dw_cuda(x, g, stride, padding, out_dtype, blocks):
    _check_bwd_shapes(g, x.shape, stride, padding, "dw_conv3x3_dw")
    out_dtype = out_dtype or torch.float32
    code = _kernel_input(x, "dw_conv3x3_dw")
    if _kernel_input(g, "dw_conv3x3_dw") != code:
        raise ValueError("dw_conv3x3_dw: x and g must have one dtype")
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"dw_conv3x3_dw: out_dtype must be float32 or bfloat16, got {out_dtype}")
    n, h, wd, c = x.shape
    ho, wo = g.shape[1], g.shape[2]
    vec = vec_width(c, x.element_size(), (x.data_ptr(), g.data_ptr()))
    rows, blocks, groups = dw_plan(n * ho, c, vec, blocks or _DW_BLOCKS)
    if groups > 65535:
        raise ValueError(f"dw_conv3x3_dw: C={c} exceeds the grid")
    partial = torch.empty((9 * c, blocks), dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, 1, c), dtype=out_dtype, device=x.device)
    rc = launch("dw_conv_bwd", "fastscnn_dw_conv3x3_dw", x.device,
        code, _DTYPE_CODE[out_dtype], x.data_ptr(), g.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), n, h, wd, c, ho, wo, stride, padding, vec, rows, blocks, groups,
    )
    check(rc, "dw_conv3x3_dw")
    dw_conv3x3_dw.launches += 1
    return dw


dw_conv3x3_dw.launches = 0


class _DwConv3x3Vjp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding)
        return dw_conv3x3(x, w, None, stride=stride, padding=padding, relu=False)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding = ctx.conf
        if not g.is_contiguous():
            # the layout the kernels read; a gradient arriving in another
            # layout costs one copy, counted here
            g = g.contiguous()
            dw_conv3x3_vjp.g_copies += 1
        dx = dw_ = None
        if ctx.needs_input_grad[0]:
            dx = dw_conv3x3_dx(g, w.to(x.dtype), stride, padding, x.shape)
        if ctx.needs_input_grad[1]:
            dw_ = dw_conv3x3_dw(x, g, stride, padding, w.dtype)
        return dx, dw_, None, None


def dw_conv3x3_vjp(x, w, stride=1, padding=1):
    """Differentiable depthwise 3×3, no bias or ReLU (kernel B6): forward
    through the B4 kernel, backward through the dX and dW kernels. dX in
    ``x``'s dtype, dW in ``w``'s, both accumulated in f32."""
    _check_dw_args(x, w, stride, "dw_conv3x3_vjp")
    return _DwConv3x3Vjp.apply(x, w, stride, padding)


dw_conv3x3_vjp.g_copies = 0
