"""Synchronised image/mask augmentation on the host, in numpy.

Counterpart of ``fastscnn_tpu/data/transforms.py`` (the reference's
PSP-style chain): each method takes the image (uint8 HWC) and the mask
(uint8 HW) as arrays and returns arrays, equal to the JAX version's
``to_numpy_pair`` output under the same ``random.Random`` state. The PIL
operations it runs are :mod:`~fastscnn_tpu_torch.data.pil_ops`, bit-equal
to Pillow's, and the draws come in the JAX version's order.

train:   random hflip → random short-edge scale in [0.5·base, 2.0·base] →
         bottom/right zero pad to the crop size → random crop → random
         Gaussian blur (radius in [0, 1), p = 0.5)
val:     short-edge resize to the crop size → centre crop
testval: identity (the datasets skip this class)

The crop's corner depends only on the resized size, so ``train`` and
``val`` resize only the window they keep (``pil_ops.resize(window=...)``):
the same pixels as resizing the whole frame and cropping it.
"""

from __future__ import annotations

import random as _global_random

import numpy as np

from fastscnn_tpu_torch.data import pil_ops

__all__ = ["SyncTransforms"]


def _resized_crop(img: np.ndarray, size, box, resample: str) -> np.ndarray:
    """``pil_ops.crop(pil_ops.resize(img, size, resample), box)``, the
    resize run only where the box meets the resized image (0 elsewhere)."""
    ow, oh = size
    x1, y1, x2, y2 = box
    out = np.zeros((y2 - y1, x2 - x1) + img.shape[2:], img.dtype)
    wx1, wy1, wx2, wy2 = max(x1, 0), max(y1, 0), min(x2, ow), min(y2, oh)
    if wx2 > wx1 and wy2 > wy1:
        out[wy1 - y1:wy2 - y1, wx1 - x1:wx2 - x1] = pil_ops.resize(
            img, size, resample, window=(wx1, wy1, wx2, wy2))
    return out


class SyncTransforms:
    def __init__(self, base_size=520, crop_size=480, rng=None):
        self.base_size = base_size
        self.crop_size = crop_size
        self.rng = rng if rng is not None else _global_random

    def train(self, img: np.ndarray, mask: np.ndarray):
        rng = self.rng
        if rng.random() < 0.5:
            img, mask = pil_ops.flip_lr(img), pil_ops.flip_lr(mask)
        crop_size = self.crop_size
        short_size = rng.randint(int(self.base_size * 0.5), int(self.base_size * 2.0))
        h, w = img.shape[:2]
        if h > w:
            ow = short_size
            oh = int(1.0 * h * ow / w)
        else:
            oh = short_size
            ow = int(1.0 * w * oh / h)
        # the zero pad to the crop size (short_size < crop_size) is the
        # crop's part outside the resized image
        pw, ph = (max(ow, crop_size), max(oh, crop_size)) if short_size < crop_size else (ow, oh)
        x1 = rng.randint(0, pw - crop_size)
        y1 = rng.randint(0, ph - crop_size)
        box = (x1, y1, x1 + crop_size, y1 + crop_size)
        img = _resized_crop(img, (ow, oh), box, "bilinear")
        mask = _resized_crop(mask, (ow, oh), box, "nearest")
        if rng.random() < 0.5:
            img = pil_ops.gaussian_blur(img, rng.random())
        return img, mask

    def val(self, img: np.ndarray, mask: np.ndarray):
        outsize = self.crop_size
        short_size = outsize
        h, w = img.shape[:2]
        if w > h:
            oh = short_size
            ow = int(1.0 * w * oh / h)
        else:
            ow = short_size
            oh = int(1.0 * h * ow / w)
        x1 = int(round((ow - outsize) / 2.0))
        y1 = int(round((oh - outsize) / 2.0))
        box = (x1, y1, x1 + outsize, y1 + outsize)
        return (_resized_crop(img, (ow, oh), box, "bilinear"),
                _resized_crop(mask, (ow, oh), box, "nearest"))

    # -- the BDD100K extras ---------------------------------------------------
    def original_size(self, img: np.ndarray, mask: np.ndarray, blur_p=0.3):
        rng = self.rng
        if rng.random() < 0.5:
            img, mask = pil_ops.flip_lr(img), pil_ops.flip_lr(mask)
        if rng.random() < blur_p:
            img = pil_ops.gaussian_blur(img, rng.random())
        return img, mask

    def multi_scale(self, img: np.ndarray, mask: np.ndarray, min_scale=0.8, max_scale=1.2,
                    blur_p=0.3):
        rng = self.rng
        if rng.random() < 0.5:
            img, mask = pil_ops.flip_lr(img), pil_ops.flip_lr(mask)
        scale = rng.uniform(min_scale, max_scale)
        h, w = img.shape[:2]
        size = (int(w * scale), int(h * scale))
        img = pil_ops.resize(img, size, "bilinear")
        mask = pil_ops.resize(mask, size, "nearest")
        if rng.random() < blur_p:
            img = pil_ops.gaussian_blur(img, rng.random())
        return img, mask
