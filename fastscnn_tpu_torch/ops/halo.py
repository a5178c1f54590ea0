"""Differentiable exchanges over the mesh's ``space`` axis.

Under a ``space`` axis of n each rank holds one block of rows of every
activation, and :func:`space_rows` is the one definition of which: at the
network's input rank s holds rows ``[s·H/n, (s+1)·H/n)`` (JAX's
``P('data', 'space')`` block, ``parallel/mesh.py::block_sharding``), and
at each level a 3×3 stride-2 conv makes, output row i goes to the rank that
holds row 2i of the level above. Output rows then follow their inputs, and
a conv's halo stays at a row or two; but the levels' heights do not split
evenly (an input of 72 rows has 35, 18, 9, 5 and 3 at 1/2 ... 1/32), so a
block may be thinner than its halo, or hold no row at all. JAX's GSPMD
pads such levels and inserts the exchanges; here they are written by hand,
forward and backward, and the model's forward (``models/fast_scnn.py``)
calls them wherever a block needs rows it does not hold:

- :func:`window_rows`: any window of global rows, one a rank, zeros past
  the image's edges; each row comes from whichever rank holds it. Its
  backward sends each fetched row's gradient back to its owner, which adds
  it to its own. :func:`halo_rows` (a block plus rows above and below), the
  3×3 convs (:func:`conv_rows`) and the align-corners upsamples whose
  source rows cross a cut (``ops/resize.py::resize_rows``) run on such
  windows;
- :func:`gather_rows_h`: every rank's block concatenated on H (the whole
  tensor on every rank). Its backward is a reduce-scatter: the gradients
  of the gathered tensor summed over the space group, each rank keeping its
  own rows. The pyramid pooling gathers its 1/32 input this way.

Each moves its rows in one ``all_gather`` of equal-sized pieces (which
``torch.distributed`` needs on gloo and NCCL): each piece padded with zero
rows to the largest and cut after, over either transport
(``parallel/spatial.py``), so that both compute one thing.

Each takes ``space``, one rank's place on the axis
(``parallel/spatial.py::Space``: its ``transport``, ``index``, ``size``
and ``rows``, every rank's rows of the tensor's level, which every
function here requires: the step and the engine attach the input's at
the axis's entry, ``Space.at``), and ``space=None`` means no ``space`` axis: each
function is then the whole-tensor op (:func:`conv_rows` the conv, the
others their input), so a caller has one call for both.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

__all__ = ["space_rows", "layout", "conv_space", "window_rows", "halo_rows", "gather_rows_h",
           "block_rows", "conv_rows", "conv_windows"]


@functools.lru_cache(maxsize=None)
def space_rows(n: int, height: int, above: tuple | None = None) -> tuple:
    """The global rows ``(start, stop)`` that each of the ``n`` ranks of a
    ``space`` axis holds of a level of ``height`` rows, in rank order.

    ``above=None``: the network's input, rank s holding ``[s·H//n,
    (s+1)·H//n)``: JAX's block where n divides H (the steps and the engine
    take no other raw input), near-equal blocks otherwise (the engine's
    input after its ``internal_size`` resize). ``above``: the rows of the
    level that a 3×3 stride-2 conv (any padding) of ``height`` output rows
    reads; output row i goes to the rank that holds row 2i there. A block
    may be empty."""
    if above is None:
        return tuple((s * height // n, (s + 1) * height // n) for s in range(n))
    return tuple((min(-(-a // 2), height), min(-(-b // 2), height)) for a, b in above)


def _level_rows(space) -> tuple:
    if space.rows is None:
        raise ValueError("a Space without the rows of its level: attach them with Space.at")
    return space.rows


def layout(x: torch.Tensor, space) -> tuple:
    """Every rank's rows of the level of ``x``, this rank's block: the
    Space's ``rows``, checked against the block's height."""
    a, b = _level_rows(space)[space.index]
    if x.shape[1] != b - a:
        raise ValueError(f"a block of {x.shape[1]} rows where rank {space.index} holds "
                         f"{b - a} of the level")
    return space.rows


def conv_space(space, kernel: int, stride: int, padding: int):
    """The Space of the output of a ``kernel``-row conv of ``stride`` and
    ``padding`` on the level of ``space``'s rows: the same rows for stride
    1 (a conv that keeps the height), else :func:`space_rows` of the output
    height. None for no ``space`` axis."""
    if space is None:
        return None
    return space.at(_conv_rows_out(space.rows, kernel, stride, padding))


def _conv_rows_out(rows: tuple, kernel: int, stride: int, padding: int) -> tuple:
    if stride == 1:
        return rows
    return space_rows(len(rows), (rows[-1][1] + 2 * padding - kernel) // stride + 1, rows)


def _rows_of(x: torch.Tensor, k: int) -> torch.Tensor:
    return x.new_zeros((x.shape[0], k, *x.shape[2:]))


def _span(x: torch.Tensor, start: int, stop: int, first: int) -> torch.Tensor:
    """Global rows ``[start, stop)`` of a piece whose row 0 is global row
    ``first``."""
    return x[:, start - first:stop - first]


@functools.lru_cache(maxsize=256)
def _plan(rows: tuple, windows: tuple) -> tuple:
    """What the exchange of ``windows`` (one ``(start, stop)`` of global
    rows a rank) over blocks ``rows`` moves: for each rank the number of
    its top rows that ranks before it read and of its bottom rows that
    ranks after it read, the forward pieces' height (the largest of
    those), and the backward pieces' height (the most rows a window reads
    above or below its own block, inside the image)."""
    height = rows[-1][1]
    tops, bottoms, back = [], [], [0]
    for r, (a, b) in enumerate(rows):
        tops.append(max([min(w1, b) - a for w0, w1 in windows[:r] if min(w1, b) > max(w0, a)],
                        default=0))
        bottoms.append(max([b - max(w0, a) for w0, w1 in windows[r + 1:]
                            if min(w1, b) > max(w0, a)], default=0))
        w0, w1 = windows[r]
        if min(w1, a) > max(w0, 0):
            back.append(a - max(w0, 0))
        if min(w1, height) > max(w0, b):
            back.append(min(w1, height) - b)
    return tuple(tops), tuple(bottoms), max(tops + bottoms, default=0), max(back)


class _WindowRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows, windows, space):
        ctx.conf = (rows, windows, space)
        s, height = space.index, rows[-1][1]
        tops, bottoms, p, _ = _plan(rows, windows)
        a, b = rows[s]
        parts = None
        if p:
            top, bottom = x[:, :tops[s]], x[:, b - a - bottoms[s]:]
            parts = space.transport.all_gather(torch.cat(
                [top, _rows_of(x, 2 * p - tops[s] - bottoms[s]), bottom], dim=1))
        w0, w1 = windows[s]
        out = [_rows_of(x, max(min(w1, 0) - w0, 0))]
        for r, (ar, br) in enumerate(rows):
            lo, hi = max(w0, ar), min(w1, br)
            if hi <= lo:
                continue
            if r == s:
                out.append(_span(x, lo, hi, a))
            elif r < s:  # the bottom half of r's piece: rows [br - p, br)
                out.append(_span(parts[r], lo, hi, br - 2 * p))
            else:  # the top half: rows [ar, ar + p)
                out.append(_span(parts[r], lo, hi, ar))
        out.append(_rows_of(x, max(w1 - max(w0, height), 0)))
        return torch.cat(out, dim=1)

    @staticmethod
    def backward(ctx, g):
        rows, windows, space = ctx.conf
        s, height = space.index, rows[-1][1]
        q = _plan(rows, windows)[3]
        a, b = rows[s]
        w0, w1 = windows[s]
        dx = _rows_of(g, b - a)
        lo, hi = max(w0, a), min(w1, b)
        if hi > lo:
            dx[:, lo - a:hi - a] += _span(g, lo, hi, w0)
        if not q:
            return dx, None, None, None
        # the gradients of the rows above this block, at rows [a - q, a), and
        # of those below it, at rows [b, b + q)
        lo, hi = max(w0, 0), min(w1, a)
        up = (torch.cat([_rows_of(g, lo - a + q), _span(g, lo, hi, w0), _rows_of(g, a - hi)],
                        dim=1) if hi > lo else _rows_of(g, q))
        lo, hi = max(w0, b), min(w1, height)
        down = (torch.cat([_rows_of(g, lo - b), _span(g, lo, hi, w0), _rows_of(g, b + q - hi)],
                          dim=1) if hi > lo else _rows_of(g, q))
        parts = space.transport.all_gather(torch.cat([up, down], dim=1))
        for r, part in enumerate(parts):
            ar, br = rows[r]
            if r > s:  # r's rows above its block: [ar - q, ar)
                lo, hi, piece, first = max(a, ar - q), min(b, ar), part[:, :q], ar - q
            elif r < s:  # r's rows below its block: [br, br + q)
                lo, hi, piece, first = max(a, br), min(b, br + q), part[:, q:], br
            else:
                continue
            if hi > lo:
                dx[:, lo - a:hi - a] += _span(piece, lo, hi, first)
        return dx, None, None, None


def window_rows(x: torch.Tensor, windows: tuple, space) -> torch.Tensor:
    """Global rows ``[start, stop)`` of ``windows[space.index]`` (one
    window a rank, every rank passing the same tuple) of the tensor whose
    block this rank holds in ``x`` (H on axis 1), zeros past the image's
    edges; differentiable (module docstring)."""
    rows = layout(x, space)
    if windows[space.index] == rows[space.index] and not any(_plan(rows, windows)[2:]):
        return x
    return _WindowRows.apply(x, rows, tuple(windows), space)


def halo_rows(x: torch.Tensor, above: int, below: int, space) -> torch.Tensor:
    """This rank's block ``x`` (H on axis 1) with the ``above`` rows before
    it and the ``below`` rows after it, wherever they are held, zeros past
    the image's top and bottom edges; differentiable (module docstring)."""
    if above < 0 or below < 0:
        raise ValueError(f"halo of {above} rows above and {below} below")
    windows = tuple((a - above, b + below) for a, b in layout(x, space))
    return window_rows(x, windows, space)


class _GatherRowsH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows, space):
        ctx.conf = (rows, space)
        p = max(b - a for a, b in rows)
        parts = space.transport.all_gather(torch.cat([x, _rows_of(x, p - x.shape[1])], dim=1))
        return torch.cat([part[:, :b - a] for part, (a, b) in zip(parts, rows)], dim=1)

    @staticmethod
    def backward(ctx, g):
        rows, space = ctx.conf
        a, b = rows[space.index]
        return space.transport.all_reduce(g)[:, a:b].contiguous(), None, None


def gather_rows_h(x: torch.Tensor, space) -> torch.Tensor:
    """Every rank's block concatenated on H (axis 1): the whole tensor, on
    every rank; differentiable (module docstring)."""
    return x if space is None else _GatherRowsH.apply(x, layout(x, space), space)


def block_rows(t: torch.Tensor, space) -> torch.Tensor:
    """This rank's rows of a tensor every rank holds whole (H on axis 1),
    at the level of ``space``'s rows."""
    if space is None:
        return t
    rows = _level_rows(space)
    if rows[-1][1] != t.shape[1]:
        raise ValueError(f"a tensor of {t.shape[1]} rows at a level of {rows[-1][1]}")
    a, b = rows[space.index]
    return t[:, a:b]


def _pointwise(conv: Callable, x: torch.Tensor, w, **kwargs) -> torch.Tensor:
    """A 1×1 conv of stride 1; on a block of no rows, which no conv
    library takes, the same contraction as a product (an empty one)."""
    if x.shape[1]:
        return conv(x, w, stride=1, padding=0, **kwargs)
    y = x @ w[0, 0].to(x.dtype)
    return y + kwargs["b"].to(y.dtype) if kwargs.get("b") is not None else y


def conv_rows(conv: Callable, x: torch.Tensor, w, stride: int, padding: int, space,
              **kwargs) -> torch.Tensor:
    """This rank's output rows of ``conv(X, w, stride=stride,
    padding=padding, **kwargs)`` on the global tensor X (NHWC, ``w`` HWIO),
    from its block ``x``: the output rows are those of :func:`conv_space`.
    A 1×1 conv of stride 1 reads no other rank's rows and runs on the
    block. Any other runs with its own symmetric ``padding`` (which pads W,
    and H where the window reaches past the image) on a window of global
    rows (:func:`window_rows`) that starts on the conv's stride, so that
    its windows line up with the global conv's; the output rows outside
    the block are cut off. Output row i reads rows ``stride·i − padding``
    on, so the window starts at the last multiple of ``stride`` at or
    before the first output row's first row (a row above the block for a
    stride-2 window of padding 1; inside it for the stem's padding 0) and
    ends at the last output row's last row; a rank with no output rows
    still runs the conv on a window of a few rows, and keeps none of them.
    The windows never need a row past the image that the global conv
    reads as data. A cut output row gets a zero gradient, so it adds
    nothing to dW."""
    kernel = w.shape[0]
    if space is None or (kernel == 1 and stride == 1 and padding == 0):
        return (conv(x, w, stride=stride, padding=padding, **kwargs) if space is None
                else _pointwise(conv, x, w, **kwargs))
    rows = layout(x, space)
    windows, cuts = conv_windows(rows, kernel, stride, padding)
    c, d = _conv_rows_out(rows, kernel, stride, padding)[space.index]
    ext = window_rows(x, windows, space)
    j = cuts[space.index]
    return conv(ext, w, stride=stride, padding=padding, **kwargs)[:, j:j + d - c]


@functools.lru_cache(maxsize=256)
def conv_windows(rows: tuple, kernel: int, stride: int, padding: int) -> tuple:
    """The windows of global rows (one a rank) that :func:`conv_rows` runs
    a ``kernel``-row conv of ``stride`` and ``padding`` on, over blocks
    ``rows``, and the index of each rank's first output row in its
    window's conv output."""
    windows, cuts = [], []
    for c, d in _conv_rows_out(rows, kernel, stride, padding):
        w0 = (stride * c - padding) // stride * stride
        windows.append((w0, max(stride * (d - 1) - padding + kernel,
                                w0 + kernel - 2 * padding)))
        cuts.append(c - w0 // stride)
    return tuple(windows), tuple(cuts)
