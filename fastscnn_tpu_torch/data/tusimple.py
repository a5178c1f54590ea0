"""TuSimple binary lane-segmentation dataset.

Counterpart of ``fastscnn_tpu/data/tusimple.py``: pairs from
``seg_label/list/train_val_gt.txt`` (first 90 % train, last 10 % val),
mask binarised ``> 0 → 1``. The clips' ``.jpg`` frames are decoded by
the port's JPEG codec (``data/jpeg.py``, Pillow's pixels, no PIL) and the
label PNGs by ``data/image_io.py``.
"""

from __future__ import annotations

import os

import numpy as np

from fastscnn_tpu_torch.data import decoded_cache
from fastscnn_tpu_torch.data.transforms import SyncTransforms

__all__ = ["TUSimpleSegmentation"]


class TUSimpleSegmentation:
    BASE_DIR = "tusimple"
    NUM_CLASS = 2
    normalization = "imagenet"
    DEVICE_AUG_PAD_LABEL = 0  # binarize(raw 0) = 0

    def __init__(self, root="./manideep1108/tusimple/versions/5/TUSimple", split="train",
                 mode=None, base_size=520, crop_size=480, rng=None, **kwargs):
        self.root = root
        self.split = split
        self.mode = mode if mode is not None else split
        self.tf = SyncTransforms(base_size, crop_size, rng=rng)
        self.images, self.mask_paths = self._get_pairs(root, split)
        if len(self.images) == 0:
            raise RuntimeError(f"Found 0 images in subfolders of: {root}")

    def _get_pairs(self, root, split):
        if split in ("train", "val"):
            gt_file = os.path.join(root, "train_set", "seg_label", "list", "train_val_gt.txt")
            clips_root = os.path.join(root, "train_set")
        else:
            gt_file = os.path.join(root, "train_set", "seg_label", "list", "test_gt.txt")
            clips_root = os.path.join(root, "test_set")
        seg_root = os.path.join(root, "train_set", "seg_label")
        if not os.path.exists(gt_file):
            raise RuntimeError(f"Ground truth file not found: {gt_file}")
        with open(gt_file) as f:
            lines = f.readlines()
        # 90/10 split of the training list (reference:tusimple.py:85-90)
        if split == "train":
            lines = lines[: int(0.9 * len(lines))]
        elif split == "val":
            lines = lines[int(0.9 * len(lines)):]
        img_paths, mask_paths = [], []
        for line in lines:
            parts = line.strip().split()
            if len(parts) < 2:
                continue
            img_path = os.path.join(clips_root, parts[0].lstrip("/"))
            mask_path = os.path.join(seg_root, parts[1].lstrip("/").replace("seg_label/", ""))
            if os.path.exists(img_path) and os.path.exists(mask_path):
                img_paths.append(img_path)
                mask_paths.append(mask_path)
        return img_paths, mask_paths

    def _mask_transform(self, mask: np.ndarray) -> np.ndarray:
        if mask.ndim == 3:
            mask = mask[:, :, 0]
        return np.where(mask.astype(np.int32) > 0, 1, 0).astype(np.int32)

    def __getitem__(self, index):
        img = decoded_cache.open_rgb(self.images[index])
        if self.mode == "test":
            return img, os.path.basename(self.images[index])
        mask = decoded_cache.open_image(self.mask_paths[index])
        if self.mode == "train":
            img, mask = self.tf.train(img, mask)
        elif self.mode == "val":
            img, mask = self.tf.val(img, mask)
        elif self.mode not in ("testval", "device-aug"):
            raise ValueError(f"unknown mode {self.mode!r}")
        return img, self._mask_transform(mask)

    def __len__(self):
        return len(self.images)

    @property
    def num_class(self):
        return self.NUM_CLASS

    @property
    def pred_offset(self):
        return 0
