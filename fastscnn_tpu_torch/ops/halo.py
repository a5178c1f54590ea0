"""Differentiable exchanges over the mesh's ``space`` axis.

Under a ``space`` axis of n each rank holds one block of every activation:
the image's H split in n equal blocks of rows, rank s holding rows
``[s·h, (s+1)·h)`` (``parallel/mesh.py::block_sharding``). JAX's GSPMD
inserts the exchanges this needs; here they are written by hand, forward
and backward, and the model's forward (``models/fast_scnn.py``) calls them
wherever a block needs rows it does not hold:

- :func:`halo_rows`: a block plus ``above`` rows of the rank above and
  ``below`` rows of the rank below, zeros past the image's edges. Its
  backward sends each halo row's gradient back to its owner, which adds it
  to its own. The 3×3 convs (:func:`conv_rows`) and the align-corners
  upsamples whose source rows cross the cut (``ops/resize.py::resize_rows``)
  run on such an extended block;
- :func:`gather_rows_h`: every rank's block concatenated on H (the whole
  tensor on every rank). Its backward is a reduce-scatter: the gradients
  of the gathered tensor summed over the space group, each rank keeping its
  own rows. The pyramid pooling gathers its 1/32 input this way.

Each takes ``space``, one rank's place on the axis
(``parallel/spatial.py::Space``: its ``transport``, ``index`` and
``size``), and ``space=None`` means no ``space`` axis: each function is
then the whole-tensor op (:func:`conv_rows` the conv, the others their
input), so a caller has one call for both.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["halo_rows", "gather_rows_h", "block_rows", "conv_rows"]


def _zeros_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    return x.new_zeros((x.shape[0], k, *x.shape[2:]))


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, above, below, space):
        h = x.shape[1]
        ctx.conf = (above, below, space, h)
        i, n = space.index, space.size
        parts = space.transport.all_gather(torch.cat([x[:, :below], x[:, h - above:]], dim=1))
        top = parts[i - 1][:, below:] if i > 0 else _zeros_rows(x, above)
        bottom = parts[i + 1][:, :below] if i < n - 1 else _zeros_rows(x, below)
        return torch.cat([top, x, bottom], dim=1)

    @staticmethod
    def backward(ctx, g):
        above, below, space, h = ctx.conf
        i, n = space.index, space.size
        parts = space.transport.all_gather(
            torch.cat([g[:, :above], g[:, above + h:]], dim=1))
        dx = g[:, above:above + h].clone()
        if i < n - 1 and above:  # the rank below's top halo is my bottom rows
            dx[:, h - above:] += parts[i + 1][:, :above]
        if i > 0 and below:  # the rank above's bottom halo is my top rows
            dx[:, :below] += parts[i - 1][:, above:]
        return dx, None, None, None


def halo_rows(x: torch.Tensor, above: int, below: int, space) -> torch.Tensor:
    """This rank's block ``x`` (H on axis 1) with ``above`` rows of the rank
    above on top and ``below`` rows of the rank below underneath, zeros at
    the image's top and bottom edges; differentiable (module docstring).
    Each must be at most the block's height."""
    h = x.shape[1]
    if not (0 <= above <= h and 0 <= below <= h):
        raise ValueError(f"halo of {above} rows above and {below} below a block of {h} rows")
    if above == below == 0:
        return x
    return _HaloRows.apply(x, above, below, space)


class _GatherRowsH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, space):
        ctx.conf = (space, x.shape[1])
        return torch.cat(space.transport.all_gather(x), dim=1)

    @staticmethod
    def backward(ctx, g):
        space, h = ctx.conf
        full = space.transport.all_reduce(g)
        return full[:, space.index * h:(space.index + 1) * h].contiguous(), None


def gather_rows_h(x: torch.Tensor, space) -> torch.Tensor:
    """Every rank's block concatenated on H (axis 1): the whole tensor, on
    every rank; differentiable (module docstring)."""
    return x if space is None else _GatherRowsH.apply(x, space)


def block_rows(t: torch.Tensor, space) -> torch.Tensor:
    """This rank's rows of a tensor every rank holds whole (H on axis 1)."""
    if space is None:
        return t
    h = t.shape[1] // space.size
    return t[:, space.index * h:(space.index + 1) * h]


def conv_rows(conv: Callable, x: torch.Tensor, w, stride: int, padding: int, space,
              **kwargs) -> torch.Tensor:
    """This rank's output rows of ``conv(X, w, stride=stride,
    padding=padding, **kwargs)`` on the global tensor X (NHWC, ``w`` HWIO),
    from its block ``x`` and halo rows. A 1×1 conv of stride 1 reads no
    other rank's rows and runs on the block. A 3×3 conv runs with its own
    symmetric ``padding`` (which pads W, and H where the extended block
    reaches past a halo) on an extended block, and the output rows outside
    the block are cut off. The windows:

    - stride 1, padding 1: one row from each side; the two outer output
      rows are cut;
    - stride 2, padding 1 (the block starts on an even row): the window of
      output row i is rows 2i−1..2i+1, so one row from above; the block is
      extended by two, which puts the windows on the conv's stride, and the
      first output row is cut;
    - stride 2, padding 0 (the stem): rows 2i..2i+2, one row from below and
      nothing cut. At the image's bottom the last rank's last output row
      reads the zero halo: it lies past the global output (H/2 − 1 rows),
      and the caller drops it (``models/fast_scnn.py``).

    A cut output row gets a zero gradient, so it adds nothing to dW."""
    if space is None or (w.shape[0] == 1 and stride == 1 and padding == 0):
        return conv(x, w, stride=stride, padding=padding, **kwargs)
    if (stride, padding) == (1, 1):
        return conv(halo_rows(x, 1, 1, space), w, stride=1, padding=1, **kwargs)[:, 1:-1]
    if (stride, padding) == (2, 1):
        return conv(halo_rows(x, 2, 0, space), w, stride=2, padding=1, **kwargs)[:, 1:]
    if (stride, padding) == (2, 0):
        return conv(halo_rows(x, 0, 1, space), w, stride=2, padding=0, **kwargs)
    raise ValueError(f"no spatial window for a 3x3 conv of stride {stride}, padding {padding}")
