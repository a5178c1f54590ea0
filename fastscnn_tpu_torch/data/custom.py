"""Custom ``images/`` + ``masks/`` folder dataset.

Counterpart of ``fastscnn_tpu/data/custom.py``: basename-matched
image/mask pairs, mask binarised ``> 128 → 1``, the 90/10 train/val
split of scikit-learn's ``train_test_split(random_state=42)`` (its numpy
form; scikit-learn is never imported), and the crop, original-size and
multi-scale train modes. This dataset is fed as plain /255 with no
ImageNet mean/std (``normalization = 'unit'``). ``.jpg``/``.jpeg`` images
are decoded by the port's JPEG codec (``data/jpeg.py``, no PIL), ``.png``
ones by ``data/image_io.py``.
"""

from __future__ import annotations

import os
import random as _random

import numpy as np

from fastscnn_tpu_torch.data import decoded_cache
from fastscnn_tpu_torch.data import pil_ops
from fastscnn_tpu_torch.data.transforms import SyncTransforms

__all__ = ["CustomDataset"]


def _train_test_split(items, train_size, seed):
    """``sklearn.model_selection.train_test_split(items, train_size=...,
    random_state=seed)``: a shuffled permutation, the test part first."""
    rng = np.random.RandomState(seed)
    n_train = int(np.floor(train_size * len(items)))
    perm = rng.permutation(len(items))
    test = [items[i] for i in perm[: len(items) - n_train]]
    train = [items[i] for i in perm[len(items) - n_train:]]
    return train, test


class CustomDataset:
    NUM_CLASS = 2
    normalization = "unit"
    # device-aug: the custom chain never pads (the min-size guard resize
    # keeps both axes ≥ crop), so the pad label is unused; 0 = background
    DEVICE_AUG_PAD_LABEL = 0
    DEVICE_AUG_CHAIN = "custom"  # reference:custom.py:123-164 (not PSP)

    def __init__(self, root="./data/custom", split="train", mode=None, base_size=520,
                 crop_size=480, train_split=0.9, multi_scale=False, keep_original_size=False,
                 rng=None, **kwargs):
        self.root = root
        self.split = split
        self.mode = mode if mode is not None else split
        self.base_size = base_size
        self.crop_size = crop_size
        self.multi_scale = multi_scale
        self.keep_original_size = keep_original_size
        self.images_root = os.path.join(root, "images")
        self.masks_root = os.path.join(root, "masks")
        self.tf = SyncTransforms(base_size, crop_size, rng=rng)
        self._rng = rng if rng is not None else _random
        self.scales = [0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0]

        all_filenames = []
        for filename in sorted(os.listdir(self.images_root)):
            if filename.lower().endswith((".jpg", ".jpeg", ".png")):
                basename = os.path.splitext(filename)[0]
                if os.path.exists(os.path.join(self.masks_root, basename + ".png")):
                    all_filenames.append(basename)
        if not all_filenames:
            raise FileNotFoundError(f"No matching image-mask pairs found in {root}")
        if len(all_filenames) == 1:
            self.filenames = all_filenames
        else:
            train_files, val_files = _train_test_split(all_filenames, train_split, 42)
            if split == "train":
                self.filenames = train_files
            elif split == "val":
                self.filenames = val_files
            else:
                self.filenames = all_filenames

    def _find_image(self, basename):
        for ext in (".jpg", ".jpeg", ".png"):
            p = os.path.join(self.images_root, basename + ext)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"Image not found for {basename}")

    def __getitem__(self, index):
        basename = self.filenames[index]
        image = decoded_cache.open_rgb(self._find_image(basename))
        if self.mode == "test":
            return image, basename
        mask = decoded_cache.open_image(os.path.join(self.masks_root, basename + ".png"))
        if mask.ndim == 3:
            mask = mask[:, :, 0]
        mask = (mask > 128).astype(np.uint8)
        if self.mode == "train":
            image, mask = self._sync_transform(image, mask)
        elif self.mode == "val":
            image, mask = self._val_sync_transform(image, mask)
        elif self.mode not in ("testval", "device-aug"):
            # device-aug: native resolution and binarised labels; the custom
            # chain runs on the device (one resolution across the dataset)
            raise ValueError(f"unknown mode {self.mode!r}")
        return image, mask.astype(np.int32)

    def _sync_transform(self, img: np.ndarray, mask: np.ndarray):
        """reference:custom.py:123-164 (the flip comes AFTER the crop, unlike
        the other datasets; original-size mode resizes to base_size²)."""
        rng = self._rng
        if not self.keep_original_size:
            if self.multi_scale:
                scale = rng.choice(self.scales)
                h, w = img.shape[:2]
                img, mask = self._resize_pair(img, mask, (int(w * scale), int(h * scale)))
            h, w = img.shape[:2]
            if w < self.crop_size or h < self.crop_size:
                nw, nh = max(w, self.crop_size), max(h, self.crop_size)
                img, mask = self._resize_pair(img, mask, (nw, nh))
            h, w = img.shape[:2]
            x1 = rng.randint(0, w - self.crop_size)
            y1 = rng.randint(0, h - self.crop_size)
            box = (x1, y1, x1 + self.crop_size, y1 + self.crop_size)
            img, mask = pil_ops.crop(img, box), pil_ops.crop(mask, box)
        else:
            img, mask = self._resize_pair(img, mask, (self.base_size, self.base_size))
        if rng.random() < 0.5:
            img, mask = pil_ops.flip_lr(img), pil_ops.flip_lr(mask)
        return img, mask

    @staticmethod
    def _resize_pair(img, mask, size):
        return pil_ops.resize(img, size, "bilinear"), pil_ops.resize(mask, size, "nearest")

    def _val_sync_transform(self, img: np.ndarray, mask: np.ndarray):
        if not self.keep_original_size:
            return self.tf.val(img, mask)
        return self._resize_pair(img, mask, (self.base_size, self.base_size))

    def __len__(self):
        return len(self.filenames)

    @property
    def num_class(self):
        return self.NUM_CLASS

    @property
    def pred_offset(self):
        return 0
