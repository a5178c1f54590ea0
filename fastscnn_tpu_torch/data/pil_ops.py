"""PIL's image operations on numpy arrays, bit-equal to Pillow 12.1.

The JAX package's host augmentation (``fastscnn_tpu/data/transforms.py``,
``data/custom.py``) and its mask dumps run through PIL. The machine that
runs the port on the card has no PIL, so this module computes the same
operations on uint8 arrays, (H, W) or (H, W, C), with numpy alone:

- :func:`resize` ``"bilinear"``: Pillow's two-pass fixed-point resampler
  (``libImaging/Resample.c``). A triangle filter whose support grows with
  the scale on a downscale (antialias); per output pixel the taps
  ``[int(center - support + 0.5), int(center + support + 0.5))`` clipped to
  the image, weights normalised in double and rounded to 22 fractional
  bits; each pass adds ``1 << 21``, shifts and clips to uint8. The
  horizontal pass runs first, on only the rows the vertical pass reads;
  a pass whose axis keeps its size is skipped.
- :func:`resize` ``"nearest"``: ``ImagingScaleAffine``, whose source
  coordinate starts at ``0.5 · src / dst`` and steps by ``src / dst``, a
  running double sum, truncated. That is not ``floor((x + 0.5) · src /
  dst)`` in exact integers: the two differ at some pixel for about one
  size pair in six.
- :func:`gaussian_blur`: Pillow's extended box blur, three passes along
  the rows, then three along the columns. The box radius comes from the
  Gaussian radius in single precision (``BoxBlur.c``'s
  ``_gaussian_blur_radius``); the whole taps weigh ``ww = 2^24 / (2r + 1)``
  and the two fractional edge taps ``fw``, in 24-bit fixed point and
  UINT32 arithmetic, with the edge pixels replicated.
- :func:`expand` (bottom/right zero pad), :func:`crop` (zero outside the
  image) and :func:`flip_lr`.

Every operation is vectorised: gathers and int32 sums over the taps, and
shifted slices (cumulative sums past a box radius of 0) for the blur.
:func:`resize` also takes a ``window`` of its result to compute alone:
each output pixel depends only on its own row's and column's taps, so a
window equals the same crop of the whole result, bit for bit, at the
window's cost (the host augmentation crops 768² out of resizes up to
2048 × 4096).
"""

from __future__ import annotations

import numpy as np

__all__ = ["resize", "gaussian_blur", "expand", "crop", "flip_lr"]

_PRECISION_BITS = 32 - 8 - 2


def _bilinear_coeffs(in_size: int, out_size: int):
    """``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the triangle
    filter: (first tap, tap count) (out,) each and int32 weights
    (out, taps); a tap past its pixel's count weighs 0."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero; clipping at 0 makes that a floor here
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    count = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    x = (taps[None, :] + xmin[:, None]).astype(np.float64)
    w = np.abs((x - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(w < 1.0, 1.0 - w, 0.0)
    w[taps[None, :] >= count[:, None]] = 0.0
    ww = np.zeros(out_size)
    for k in range(ksize):  # C's order of the sum
        ww += w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << _PRECISION_BITS)).astype(np.int32)
    return xmin, count, fixed[:, :max(int(count.max()), 1)]


def _fixed_pass(flat: np.ndarray, axis: int, start, weights, channels: int) -> np.ndarray:
    """One fixed-point pass over a (rows, columns · channels) array: along
    the rows (axis 0) or the columns (axis 1, every channel alike)."""
    size = flat.shape[axis] // (channels if axis else 1)
    acc = None
    for k in range(weights.shape[1]):
        idx = np.minimum(start + k, size - 1)
        if axis == 0:
            term = flat[idx].astype(np.int32)
            term *= weights[:, k, None]
        else:
            idx = (idx[:, None] * channels + np.arange(channels)).ravel()
            term = np.take(flat, idx, axis=1).astype(np.int32)
            term *= np.repeat(weights[:, k], channels)[None, :]
        if acc is None:
            acc = term
            acc += 1 << (_PRECISION_BITS - 1)
        else:
            acc += term
    acc >>= _PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    a0 = float(in_size) / out_size
    steps = np.full(out_size, a0)
    steps[0] = a0 * 0.5
    return np.cumsum(steps).astype(np.int64)  # cumsum: C's running `xo += a[0]`


def resize(img: np.ndarray, size, resample: str = "bilinear", window=None) -> np.ndarray:
    """``Image.fromarray(img).resize(size, BILINEAR | NEAREST)``, ``size`` =
    (width, height) as PIL's; ``"nearest"`` takes any dtype, ``"bilinear"``
    uint8. ``window=(x1, y1, x2, y2)``, inside the result: only that part
    of it (see the module docstring)."""
    img = np.asarray(img)
    ow, oh = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if ow <= 0 or oh <= 0:
        raise ValueError(f"resize to {ow}x{oh}: the size must be positive")
    x1, y1, x2, y2 = (0, 0, ow, oh) if window is None else (int(v) for v in window)
    if not (0 <= x1 < x2 <= ow and 0 <= y1 < y2 <= oh):
        raise ValueError(f"window {(x1, y1, x2, y2)} is not inside the {ow}x{oh} result")
    if (ow, oh) == (w, h):
        return img[y1:y2, x1:x2].copy()
    if resample == "nearest":
        rows, cols = _nearest_index(h, oh)[y1:y2], _nearest_index(w, ow)[x1:x2]
        return img[rows][:, cols]
    if resample != "bilinear":
        raise ValueError(f"unknown resample {resample!r} (bilinear or nearest)")
    if img.dtype != np.uint8:
        raise TypeError(f"bilinear resize takes uint8 images, not {img.dtype}")
    channels = img.shape[2] if img.ndim == 3 else 1
    first, last = y1, y2
    if oh != h:
        ystart, ycount, yweights = (c[y1:y2] for c in _bilinear_coeffs(h, oh))
        first, last = int(ystart.min()), int((ystart + ycount).max())
    out = img.reshape(h, w * channels)[first:last]
    if ow != w:
        xstart, _, xweights = _bilinear_coeffs(w, ow)
        out = _fixed_pass(out, 1, xstart[x1:x2], xweights[x1:x2], channels)
    else:
        out = out[:, x1 * channels:x2 * channels]
    if oh != h:
        out = _fixed_pass(out, 0, ystart - first, yweights, channels)
    return np.ascontiguousarray(out).reshape((y2 - y1, x2 - x1) + img.shape[2:])


def _box_radius(radius: float) -> np.float32:
    """``_gaussian_blur_radius(radius, 3)`` in C's single precision."""
    f = np.float32
    radius = f(radius)
    sigma2 = f(radius * radius) / f(3)
    big_l = f(np.sqrt(12.0 * float(sigma2) + 1.0))
    small_l = f(np.floor((float(big_l) - 1.0) / 2.0))
    a = (f(2) * small_l + f(1)) * (small_l * (small_l + f(1)) - f(3) * sigma2)
    a = a / (f(6) * (sigma2 - (small_l + f(1)) * (small_l + f(1))))
    return small_l + a


def _box_pass(img: np.ndarray, axis: int, radius: np.float32) -> np.ndarray:
    """``ImagingLineBoxBlur8/32`` on every line along ``axis`` at once: the
    window of 2r + 1 clamped pixels × ``ww`` plus the two beyond it × ``fw``,
    in UINT32 arithmetic (numpy's uint32 wraps as C's does)."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / (radius * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    n = img.shape[axis]
    pad = [(0, 0)] * img.ndim
    pad[axis] = (r + 1, r + 1)
    padded = np.pad(img, pad, mode="edge")

    def part(a, lo):  # a[lo:lo + n] along the axis
        return a[(slice(None),) * axis + (slice(lo, lo + n),)]

    if r == 0:
        bulk = part(padded, 1).astype(np.uint32)
    else:
        cs = np.cumsum(padded, axis=axis, dtype=np.uint32)
        bulk = part(cs, 2 * r + 1) - part(cs, 0)
    bulk *= np.uint32(ww)
    far = part(padded, 0).astype(np.uint32)
    far += part(padded, 2 * r + 2)
    far *= np.uint32(fw)
    bulk += far
    bulk += np.uint32(1 << 23)
    bulk >>= np.uint32(24)
    return bulk.astype(np.uint8)


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """``Image.fromarray(img).filter(ImageFilter.GaussianBlur(radius))`` of a
    uint8 (H, W) or (H, W, C) array."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"gaussian_blur takes uint8 images, not {img.dtype}")
    box = _box_radius(radius)
    if radius == 0 or box == 0:
        return img.copy()
    out = img
    for axis in (1, 0):
        for _ in range(3):
            out = _box_pass(out, axis, box)
    return out


def expand(img: np.ndarray, right: int, bottom: int, fill=0) -> np.ndarray:
    """``ImageOps.expand(img, border=(0, 0, right, bottom), fill=fill)``."""
    img = np.asarray(img)
    pad = [(0, bottom), (0, right)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, constant_values=fill)


def crop(img: np.ndarray, box) -> np.ndarray:
    """``img.crop((x1, y1, x2, y2))``: pixels outside the image are 0."""
    img = np.asarray(img)
    x1, y1, x2, y2 = (int(v) for v in box)
    h, w = img.shape[:2]
    out = np.zeros((max(y2 - y1, 0), max(x2 - x1, 0)) + img.shape[2:], img.dtype)
    sy0, sy1, sx0, sx1 = max(y1, 0), min(y2, h), max(x1, 0), min(x2, w)
    if sy1 > sy0 and sx1 > sx0:
        out[sy0 - y1:sy1 - y1, sx0 - x1:sx1 - x1] = img[sy0:sy1, sx0:sx1]
    return out


def flip_lr(img: np.ndarray) -> np.ndarray:
    """``img.transpose(Image.FLIP_LEFT_RIGHT)``."""
    return np.ascontiguousarray(np.asarray(img)[:, ::-1])
