"""Synchronised image/mask augmentation on the host, through PIL.

Counterpart of ``fastscnn_tpu/data/transforms.py`` (the reference's
PSP-style chain), on numpy arrays: each method takes the image (uint8
HWC) and the mask (uint8 HW) as arrays, runs the JAX package's PIL
operations on them, and returns arrays, bit-equal to the JAX version
under the same ``random.Random`` state.

train:   random hflip → random short-edge scale in [0.5·base, 2.0·base] →
         bottom/right zero pad to the crop size → random crop → random
         Gaussian blur (radius in [0, 1), p = 0.5)
val:     short-edge resize to the crop size → centre crop
testval: identity (the datasets skip this class)

PIL is imported inside each method: the machine that runs the port on
the card has none, and its path (``--device-aug``, ``testval``) never
calls these.
"""

from __future__ import annotations

import random as _global_random

import numpy as np

__all__ = ["SyncTransforms"]


def _pil():
    try:
        from PIL import Image, ImageFilter, ImageOps
    except ImportError as e:
        raise RuntimeError(
            "the host augmentation (train and val modes) needs PIL, which is not installed; "
            "train with --device-aug and evaluate with --mode testval") from e
    return Image, ImageFilter, ImageOps


class SyncTransforms:
    def __init__(self, base_size=520, crop_size=480, rng=None):
        self.base_size = base_size
        self.crop_size = crop_size
        self.rng = rng if rng is not None else _global_random

    def train(self, img: np.ndarray, mask: np.ndarray):
        Image, ImageFilter, ImageOps = _pil()
        img, mask = Image.fromarray(img), Image.fromarray(mask)
        rng = self.rng
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
        crop_size = self.crop_size
        short_size = rng.randint(int(self.base_size * 0.5), int(self.base_size * 2.0))
        w, h = img.size
        if h > w:
            ow = short_size
            oh = int(1.0 * h * ow / w)
        else:
            oh = short_size
            ow = int(1.0 * w * oh / h)
        img = img.resize((ow, oh), Image.BILINEAR)
        mask = mask.resize((ow, oh), Image.NEAREST)
        if short_size < crop_size:
            padh = crop_size - oh if oh < crop_size else 0
            padw = crop_size - ow if ow < crop_size else 0
            img = ImageOps.expand(img, border=(0, 0, padw, padh), fill=0)
            mask = ImageOps.expand(mask, border=(0, 0, padw, padh), fill=0)
        w, h = img.size
        x1 = rng.randint(0, w - crop_size)
        y1 = rng.randint(0, h - crop_size)
        img = img.crop((x1, y1, x1 + crop_size, y1 + crop_size))
        mask = mask.crop((x1, y1, x1 + crop_size, y1 + crop_size))
        if rng.random() < 0.5:
            img = img.filter(ImageFilter.GaussianBlur(radius=rng.random()))
        return np.asarray(img), np.asarray(mask)

    def val(self, img: np.ndarray, mask: np.ndarray):
        Image, _, _ = _pil()
        img, mask = Image.fromarray(img), Image.fromarray(mask)
        outsize = self.crop_size
        short_size = outsize
        w, h = img.size
        if w > h:
            oh = short_size
            ow = int(1.0 * w * oh / h)
        else:
            ow = short_size
            oh = int(1.0 * h * ow / w)
        img = img.resize((ow, oh), Image.BILINEAR)
        mask = mask.resize((ow, oh), Image.NEAREST)
        w, h = img.size
        x1 = int(round((w - outsize) / 2.0))
        y1 = int(round((h - outsize) / 2.0))
        img = img.crop((x1, y1, x1 + outsize, y1 + outsize))
        mask = mask.crop((x1, y1, x1 + outsize, y1 + outsize))
        return np.asarray(img), np.asarray(mask)

    # -- the BDD100K extras ---------------------------------------------------
    def original_size(self, img: np.ndarray, mask: np.ndarray, blur_p=0.3):
        Image, ImageFilter, _ = _pil()
        img, mask = Image.fromarray(img), Image.fromarray(mask)
        rng = self.rng
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
        if rng.random() < blur_p:
            img = img.filter(ImageFilter.GaussianBlur(radius=rng.random()))
        return np.asarray(img), np.asarray(mask)

    def multi_scale(self, img: np.ndarray, mask: np.ndarray, min_scale=0.8, max_scale=1.2,
                    blur_p=0.3):
        Image, ImageFilter, _ = _pil()
        img, mask = Image.fromarray(img), Image.fromarray(mask)
        rng = self.rng
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
        scale = rng.uniform(min_scale, max_scale)
        w, h = img.size
        img = img.resize((int(w * scale), int(h * scale)), Image.BILINEAR)
        mask = mask.resize((int(w * scale), int(h * scale)), Image.NEAREST)
        if rng.random() < blur_p:
            img = img.filter(ImageFilter.GaussianBlur(radius=rng.random()))
        return np.asarray(img), np.asarray(mask)
