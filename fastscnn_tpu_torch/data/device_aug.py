"""On-device training augmentation: the host chains as batched matmuls.

Counterpart of ``fastscnn_tpu/data/device_aug.py``, which states the
formulation and its documented divergences from the PIL chain. Every
step of a chain is a per-sample linear operator along one axis, so a
batch is augmented with two batched matmuls per image, on sampling
matrices built on the device from a few random scalars a sample:

  resize + crop  PIL's triangle weights (antialias on a downscale, rows
                 renormalised), rows past the resized extent zero (the
                 bottom/right zero pad);
  hflip          the source index reversed, folded into the W matrix;
  blur           a truncated-Gaussian band matrix composed into the
                 image's matrices (the mask is not blurred);
  mask           NEAREST at the exact rational source index. Here it is
                 an index gather, where the JAX package multiplies by a
                 one-hot matrix: both are exact, so the masks are equal.

Images are multiplied in ``compute_dtype`` (bf16 products with f32 sums
on the tensor cores) and come out f32 in [0, 255]; masks come out int32
with ``pad_label`` in the pad.

The ``draw_*`` functions draw the reference distributions (inclusive
``randint`` bounds, Bernoulli(0.5) flips and blurs, radius U[0, 1)) from
a ``torch.Generator`` on the device. They cannot reproduce JAX's key
streams, so parity tests draw with JAX and hand the same parameters to
the ``apply_*`` functions. Nothing here copies from the host to the
device in a step: the matrices are built from ``arange``s and the drawn
tensors on the device.

Three chains, as in the JAX package: PSP (``make_device_augment``:
Cityscapes, TuSimple, BDD100K), custom (``make_device_augment_custom``:
[multi-scale resize →] min-size guard resize → crop → hflip after the
crop, no pad and no blur) and original (``make_device_augment_original``:
BDD100K ``--keep-original-size``, flip and blur at the native size).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

__all__ = [
    "AugParams",
    "draw_params",
    "apply_params",
    "make_device_augment",
    "CustomAugParams",
    "draw_custom_params",
    "apply_custom_params",
    "make_device_augment_custom",
    "OriginalAugParams",
    "draw_original_params",
    "apply_original_params",
    "make_device_augment_original",
]

_F32 = torch.float32


class AugParams(NamedTuple):
    """Per-sample draws of the PSP chain, each a (B,) tensor."""

    flip: torch.Tensor  # bool — hflip before the resize
    short: torch.Tensor  # int — the target short edge
    y1: torch.Tensor  # int — crop top in the padded resized image
    x1: torch.Tensor  # int — crop left
    blur_on: torch.Tensor  # bool
    radius: torch.Tensor  # f32 in [0, 1)


def _ratio(num: int, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` in f32, one rounding (``int / tensor`` in PyTorch is a
    reciprocal and a product: two)."""
    den = den.to(_F32)
    return torch.full_like(den, float(num)) / den


def _bernoulli_half(generator, batch):
    return torch.rand(batch, generator=generator, device=generator.device) < 0.5


def _randint_inclusive(generator, high: torch.Tensor) -> torch.Tensor:
    """U{0, ..., high} per element of the int tensor ``high`` (the
    reference's ``random.randint(0, high)``), from f64 uniforms."""
    u = torch.rand(high.shape, generator=generator, device=high.device, dtype=torch.float64)
    return torch.minimum((u * (high + 1).double()).long(), high.long())


def _resized_dims(short: torch.Tensor, src_h: int, src_w: int):
    """PIL's short-edge resize size, ``int(1.0 * w * oh / h)`` in exact
    integers."""
    short = short.long()
    if src_h > src_w:
        ow = short
        oh = (src_h * ow) // src_w
    else:
        oh = short
        ow = (src_w * oh) // src_h
    return oh, ow


def draw_params(generator: torch.Generator, batch: int, src_h: int, src_w: int,
                base_size: int, crop_size: int) -> AugParams:
    """Per-sample parameters of the PSP chain, on ``generator``'s device."""
    dev = generator.device
    flip = _bernoulli_half(generator, batch)
    short = torch.randint(int(base_size * 0.5), int(base_size * 2.0) + 1, (batch,),
                          generator=generator, device=dev)
    oh, ow = _resized_dims(short, src_h, src_w)
    y1 = _randint_inclusive(generator, torch.clamp(oh, min=crop_size) - crop_size)
    x1 = _randint_inclusive(generator, torch.clamp(ow, min=crop_size) - crop_size)
    blur_on = _bernoulli_half(generator, batch)
    radius = torch.rand(batch, generator=generator, device=dev, dtype=_F32)
    return AugParams(flip, short, y1, x1, blur_on, radius)


def _axis_matrices(g0, resized, flip, src: int, crop: int):
    """For one axis of each sample: the (B, crop, src) bilinear weights, the
    (B, crop) NEAREST source index and the (B, crop) row validity, from the
    crop offsets ``g0``, the resized extents and the flips (all (B,))."""
    dev = g0.device
    g = g0.long()[:, None] + torch.arange(crop, device=dev)  # rows of the resized image
    valid = g < resized[:, None]
    scale = _ratio(src, resized)
    fscale = torch.clamp(scale, min=1.0)
    center = (g.to(_F32) + 0.5) * scale[:, None]
    j = torch.arange(src, device=dev, dtype=_F32)
    # a flip before the resize reverses the source coordinate
    pos = torch.where(flip[:, None], (src - 0.5) - j, j + 0.5)
    w = torch.clamp(1.0 - torch.abs(pos[:, None, :] - center[:, :, None])
                    / fscale[:, None, None], min=0.0)
    w = w * valid[:, :, None]
    w = w / torch.clamp(w.sum(dim=2, keepdim=True), min=1e-12)
    # exact rational NEAREST: floor((i + 0.5) * src / resized)
    idx = torch.clamp(((2 * g + 1) * src) // (2 * resized[:, None]), 0, src - 1)
    idx = torch.where(flip[:, None], src - 1 - idx, idx)
    return w, idx, valid


def _blur_matrix(blur_on, radius, n: int):
    """(B, n, n) truncated-Gaussian band matrices with PIL's edge
    replication (the mass of taps outside folds onto the edge pixel); the
    identity where the blur is off (sigma 1e-3 is one-hot exactly). The
    radius is below 1 in every recipe, so 8 pixels cover the tails."""
    dev = radius.device
    sigma = torch.clamp(torch.where(blur_on, radius.to(_F32), 0.0), min=1e-3)
    ext = 8
    i = torch.arange(n, device=dev, dtype=_F32)
    pos = torch.arange(-ext, n + ext, device=dev, dtype=_F32)
    two_var = (2.0 * sigma * sigma)[:, None, None]
    g = torch.exp(-((i[:, None] - pos[None, :]) ** 2)[None] / two_var)
    g = g / g.sum(dim=2, keepdim=True)
    m = g[:, :, ext:ext + n].clone()
    m[:, :, 0] += g[:, :, :ext].sum(dim=2)
    m[:, :, -1] += g[:, :, ext + n:].sum(dim=2)
    return m


def _sample(images, mh, mw, compute_dtype):
    """``img[b, i, j, c] = Σ_h Σ_w mh[b, i, h] · mw[b, j, w] · images[b, h,
    w, c]``: two batched matmuls in ``compute_dtype`` (each rounded to it,
    as the JAX einsums), then f32 clipped to [0, 255]. ``mh`` may be one
    (I, H) matrix shared by the batch."""
    b, h, w, ch = images.shape
    x = images.to(compute_dtype).reshape(b, h, w * ch)
    mh = mh.to(compute_dtype)
    t = torch.matmul(mh, x).reshape(b, -1, w, ch)  # (B, I, W, C)
    rows = t.shape[1]
    t = t.permute(0, 2, 1, 3).reshape(b, w, rows * ch)
    out = torch.bmm(mw.to(compute_dtype), t).reshape(b, -1, rows, ch)  # (B, J, I, C)
    # written NHWC in memory, as a loaded batch: the convolutions (and their
    # rounding) then see the layout they see without the augmentation
    img = torch.empty((b, rows, out.shape[1], ch), dtype=_F32, device=out.device)
    return img.copy_(out.permute(0, 2, 1, 3)).clamp_(0.0, 255.0)


def _gather_mask(masks, idx_h, idx_w):
    """``masks[b, idx_h[b, i], idx_w[b, j]]`` as int32 (B, I, J); ``idx_h``
    may be one (I,) index shared by the batch."""
    b = masks.shape[0]
    bi = torch.arange(b, device=masks.device)[:, None, None]
    rows = idx_h[:, :, None] if idx_h.dim() == 2 else idx_h[None, :, None]
    return masks[bi, rows, idx_w[:, None, :]].to(torch.int32)


def apply_params(images, masks, params: AugParams, *, crop_size: int, base_size: int,
                 pad_label: int, compute_dtype: torch.dtype = torch.bfloat16):
    """The PSP chain with the given per-sample parameters.

    images: (B, H, W, 3) uint8 or float, one source size for the batch.
    masks:  (B, H, W) integer labels, already remapped (NEAREST commutes
            with the remap).
    Returns (B, crop, crop, 3) f32 in [0, 255] and (B, crop, crop) int32
    with ``pad_label`` in the pad."""
    src_h, src_w = images.shape[1], images.shape[2]
    oh, ow = _resized_dims(params.short, src_h, src_w)
    no_flip = torch.zeros_like(params.flip)  # the flip never touches H
    wh, ih, vh = _axis_matrices(params.y1, oh, no_flip, src_h, crop_size)
    ww, iw, vw = _axis_matrices(params.x1, ow, params.flip, src_w, crop_size)
    gm = _blur_matrix(params.blur_on, params.radius, crop_size)
    # the blur composes into the image's matrices (blur after the crop,
    # separable); the mask is not blurred
    img = _sample(images, torch.bmm(gm, wh), torch.bmm(gm, ww), compute_dtype)
    inside = vh[:, :, None] & vw[:, None, :]
    mask = torch.where(inside, _gather_mask(masks, ih, iw),
                       torch.full((), pad_label, dtype=torch.int32, device=masks.device))
    return img, mask


def make_device_augment(*, base_size: int, crop_size: int, pad_label: int,
                        compute_dtype: torch.dtype = torch.bfloat16):
    """``augment(images, masks, generator) -> (img f32, mask int32)``: the
    PSP chain with parameters drawn from ``generator`` (a
    ``torch.Generator`` on the batch's device). The source size is read
    from the batch, so one augment serves any dataset of one size."""

    def augment(images, masks, generator):
        params = draw_params(generator, images.shape[0], images.shape[1], images.shape[2],
                             base_size, crop_size)
        return apply_params(images, masks, params, crop_size=crop_size, base_size=base_size,
                            pad_label=pad_label, compute_dtype=compute_dtype)

    return augment


# ---------------------------------------------------------------------------
# The CUSTOM dataset's chain (reference:custom.py:123-164): [multi-scale
# resize →] min-size guard resize → random crop → hflip AFTER the crop. No
# pad, no blur.
# ---------------------------------------------------------------------------


class CustomAugParams(NamedTuple):
    """Per-sample draws of the custom chain, each a (B,) tensor."""

    scale_k: torch.Tensor  # int — index into the scales tuple
    x1: torch.Tensor  # int — crop left in the guard-resized image
    y1: torch.Tensor  # int — crop top
    flip: torch.Tensor  # bool — hflip AFTER the crop


@functools.lru_cache(maxsize=64)
def _int_table(values: tuple, device: torch.device) -> torch.Tensor:
    """A small int64 lookup table on ``device``, built once (so a step makes
    no host→device copy)."""
    return torch.tensor(values, dtype=torch.long, device=device)


def _custom_dims(scales, src: int, device) -> torch.Tensor:
    """Each scale's post-resize extent, PIL's ``int(src * scale)``."""
    return _int_table(tuple(int(src * s) for s in scales), torch.device(device))


def draw_custom_params(generator: torch.Generator, batch: int, src_h: int, src_w: int,
                       crop_size: int, scales) -> CustomAugParams:
    """The reference's distributions: ``random.choice(scales)`` shared by
    both axes, ``randint(0, extent - crop)`` per axis after the guard
    resize, a Bernoulli(0.5) flip."""
    dev = generator.device
    n = len(scales)
    if n > 1:
        scale_k = torch.randint(0, n, (batch,), generator=generator, device=dev)
    else:
        scale_k = torch.zeros(batch, dtype=torch.long, device=dev)
    ow = _custom_dims(scales, src_w, dev)[scale_k]
    oh = _custom_dims(scales, src_h, dev)[scale_k]
    x1 = _randint_inclusive(generator, torch.clamp(ow, min=crop_size) - crop_size)
    y1 = _randint_inclusive(generator, torch.clamp(oh, min=crop_size) - crop_size)
    flip = _bernoulli_half(generator, batch)
    return CustomAugParams(scale_k, x1, y1, flip)


def _two_tap(center, extent):
    """Two-tap triangle sampling at filter scale 1 (the guard and crop
    stage never downscales): tap indices and weights, renormalised over
    the window clipped to [0, extent) as PIL does. ``center`` (B, R) f32,
    ``extent`` (B,) int."""
    x = center - 0.5
    k = torch.floor(x).long()
    f = x - k.to(_F32)
    ext = extent[:, None]
    w0 = torch.where((k >= 0) & (k < ext), 1.0 - f, 0.0)
    w1 = torch.where((k + 1 >= 0) & (k + 1 < ext), f, 0.0)
    tot = torch.clamp(w0 + w1, min=1e-12)
    lo = torch.zeros_like(k)
    return (torch.clamp(torch.maximum(k, lo), max=ext - 1),
            torch.clamp(torch.maximum(k + 1, lo), max=ext - 1), w0 / tot, w1 / tot)


def _scale_rows(k, scale_out, src: int):
    """Rows ``k`` (B, R) of each sample's resize matrix src → ``scale_out``
    (B,), from the triangle formula (the PSP chain's math), (B, R, src)."""
    scale = _ratio(src, scale_out)
    fscale = torch.clamp(scale, min=1.0)
    center = (k.to(_F32) + 0.5) * scale[:, None]
    j = torch.arange(src, device=k.device, dtype=_F32) + 0.5
    w = torch.clamp(1.0 - torch.abs(j - center[:, :, None]) / fscale[:, None, None], min=0.0)
    return w / torch.clamp(w.sum(dim=2, keepdim=True), min=1e-12)


def _scale_matrix(scale_out: int, src: int, n_rows: int, device) -> torch.Tensor:
    """The (n_rows, src) resize matrix src → ``scale_out`` (rows ≥ it zero)."""
    g = torch.arange(n_rows, device=device)[None]
    out = torch.full((1,), scale_out, dtype=torch.long, device=device)
    return (_scale_rows(g, out, src) * (g < scale_out)[:, :, None])[0]


def _custom_rows(g0, flip_rows, crop: int):
    """Output rows of the guard and crop stage, mirrored by the flip after
    the crop."""
    i = torch.arange(crop, device=g0.device)
    return g0.long()[:, None] + torch.where(flip_rows[:, None], crop - 1 - i, i)


def _custom_axis_image(scale_out, g0, flip_rows, src: int, crop: int, multi: bool):
    """(B, crop, src) image sampling matrices of one axis: the guard and crop
    stage (two taps) composed over the multi-scale resize."""
    gh = torch.clamp(scale_out, min=crop)
    rows = _custom_rows(g0, flip_rows, crop)
    center = (rows.to(_F32) + 0.5) * (scale_out.to(_F32) / gh.to(_F32))[:, None]
    k0, k1, w0, w1 = _two_tap(center, scale_out)
    if not multi:
        j = torch.arange(src, device=g0.device)
        return (w0[:, :, None] * (j == k0[:, :, None]).to(_F32)
                + w1[:, :, None] * (j == k1[:, :, None]).to(_F32))
    return (w0[:, :, None] * _scale_rows(k0, scale_out, src)
            + w1[:, :, None] * _scale_rows(k1, scale_out, src))


def _custom_axis_nearest(scale_out, g0, flip_rows, src: int, crop: int):
    """(B, crop) NEAREST source indices of one axis: the two PIL NEAREST
    maps chained in exact integers."""
    rows = _custom_rows(g0, flip_rows, crop)
    so = scale_out[:, None]
    gh = torch.clamp(so, min=crop)
    t = ((2 * rows + 1) * so) // (2 * gh)  # guard + crop → the scaled image
    return torch.clamp(((2 * t + 1) * src) // (2 * so), 0, src - 1)


def apply_custom_params(images, masks, params: CustomAugParams, *, crop_size: int, scales,
                        compute_dtype: torch.dtype = torch.bfloat16):
    """The custom chain with the given per-sample parameters.

    images: (B, H, W, 3) uint8 or float, one source size for the batch.
    masks:  (B, H, W) integer labels (binarised for the custom dataset).
    Returns (B, crop, crop, 3) f32 in [0, 255] and (B, crop, crop) int32.
    There is no pad: the guard resize keeps both axes ≥ crop."""
    src_h, src_w = int(images.shape[1]), int(images.shape[2])
    dev = images.device
    multi = len(scales) > 1 or float(scales[0]) != 1.0
    if not multi and src_h >= crop_size and src_w >= crop_size:
        # the chain is a crop and a flip (no resize, no guard): an exact
        # gather, no matmul
        i = torch.arange(crop_size, device=dev)
        rows = params.y1.long()[:, None] + i
        cols = params.x1.long()[:, None] + torch.where(params.flip[:, None], crop_size - 1 - i, i)
        bi = torch.arange(images.shape[0], device=dev)[:, None, None]
        img = images[bi, rows[:, :, None], cols[:, None, :]]
        return img.to(_F32), masks[bi, rows[:, :, None], cols[:, None, :]].to(torch.int32)
    oh = _custom_dims(scales, src_h, dev)[params.scale_k.long()]
    ow = _custom_dims(scales, src_w, dev)[params.scale_k.long()]
    no_flip = torch.zeros_like(params.flip)
    wh = _custom_axis_image(oh, params.y1, no_flip, src_h, crop_size, multi)
    ww = _custom_axis_image(ow, params.x1, params.flip, src_w, crop_size, multi)
    ih = _custom_axis_nearest(oh, params.y1, no_flip, src_h, crop_size)
    iw = _custom_axis_nearest(ow, params.x1, params.flip, src_w, crop_size)
    return _sample(images, wh, ww, compute_dtype), _gather_mask(masks, ih, iw)


def make_device_augment_custom(*, crop_size: int, multi_scale: bool = False,
                               scales=(0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0),
                               keep_original_size: bool = False, base_size: int = 520,
                               compute_dtype: torch.dtype = torch.bfloat16):
    """``augment(images, masks, generator)`` for the CUSTOM chain.
    ``keep_original_size`` resizes every sample to base_size² (and flips
    at random): fixed matrices, only the flip is drawn."""
    use_scales = tuple(scales) if multi_scale else (1.0,)

    def augment(images, masks, generator):
        b, src_h, src_w = images.shape[0], int(images.shape[1]), int(images.shape[2])
        if not keep_original_size:
            params = draw_custom_params(generator, b, src_h, src_w, crop_size, use_scales)
            return apply_custom_params(images, masks, params, crop_size=crop_size,
                                       scales=use_scales, compute_dtype=compute_dtype)
        dev = images.device
        flip = _bernoulli_half(generator, b)
        sh = _scale_matrix(base_size, src_h, base_size, dev)
        sw = _scale_matrix(base_size, src_w, base_size, dev)
        # NEAREST src → base in one stage: the exact rational index
        i = torch.arange(base_size, device=dev)
        idx_h = torch.clamp(((2 * i + 1) * src_h) // (2 * base_size), 0, src_h - 1)
        idx_w = torch.clamp(((2 * i + 1) * src_w) // (2 * base_size), 0, src_w - 1)
        swf = torch.where(flip[:, None, None], sw.flip(0)[None], sw[None])
        iwf = torch.where(flip[:, None], idx_w.flip(0)[None], idx_w[None])
        return _sample(images, sh, swf, compute_dtype), _gather_mask(masks, idx_h, iwf)

    return augment


# ---------------------------------------------------------------------------
# BDD100K's keep-original-size chain (reference:bdd100k.py:242-259): hflip
# (p = 0.5) → Gaussian blur (p = blur_p, radius U[0, 1)) at the native size.
# ---------------------------------------------------------------------------


class OriginalAugParams(NamedTuple):
    """Per-sample draws of the keep-original-size chain, each (B,)."""

    flip: torch.Tensor  # bool
    blur_on: torch.Tensor  # bool — Bernoulli(blur_p)
    radius: torch.Tensor  # f32 in [0, 1)


def draw_original_params(generator: torch.Generator, batch: int,
                         blur_p: float) -> OriginalAugParams:
    """Bernoulli(0.5) flip, Bernoulli(blur_p) blur, radius U[0, 1)."""
    dev = generator.device
    flip = _bernoulli_half(generator, batch)
    blur_on = torch.rand(batch, generator=generator, device=dev) < float(blur_p)
    radius = torch.rand(batch, generator=generator, device=dev, dtype=_F32)
    return OriginalAugParams(flip, blur_on, radius)


def apply_original_params(images, masks, params: OriginalAugParams, *,
                          compute_dtype: torch.dtype = torch.bfloat16):
    """Flip and separable Gaussian blur at the native size: (B, H, W, 3) f32
    in [0, 255] and the flipped masks as int32 (the blur leaves labels)."""
    src_h, src_w = int(images.shape[1]), int(images.shape[2])
    flip = params.flip
    x = torch.where(flip[:, None, None, None], images.flip(2), images)
    gh = _blur_matrix(params.blur_on, params.radius, src_h)
    gw = _blur_matrix(params.blur_on, params.radius, src_w)
    mask = torch.where(flip[:, None, None], masks.flip(2), masks).to(torch.int32)
    return _sample(x, gh, gw, compute_dtype), mask


def make_device_augment_original(*, blur_p: float = 0.3,
                                 compute_dtype: torch.dtype = torch.bfloat16):
    """``augment(images, masks, generator)`` for the keep-original-size
    chain."""

    def augment(images, masks, generator):
        params = draw_original_params(generator, images.shape[0], blur_p)
        return apply_original_params(images, masks, params, compute_dtype=compute_dtype)

    return augment
