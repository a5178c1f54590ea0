"""BDD100K drivable-area segmentation dataset.

Counterpart of ``fastscnn_tpu/data/bdd100k.py``: ``{name}.jpg`` ↔
``{name}_drivable_id.png`` pairing, binary (label 1, direct drivable →
1) or ternary labels, the 10k/100k subsets, seed-42 subsampling, and the
three train transforms (standard crop, keep-original-size, multi-scale
without crop). The ``.jpg`` images are decoded by the port's JPEG codec
(``data/jpeg.py``, Pillow's pixels, no PIL) and the label PNGs by
``data/image_io.py``.
"""

from __future__ import annotations

import os
import random as _random

import numpy as np

from fastscnn_tpu_torch.data import decoded_cache
from fastscnn_tpu_torch.data.transforms import SyncTransforms

__all__ = ["BDD100KSegmentation"]


class BDD100KSegmentation:
    BASE_DIR = "bdd100k"
    NUM_CLASS = 2
    normalization = "imagenet"
    DEVICE_AUG_PAD_LABEL = 0  # label-map(raw 0) = 0 for binary and ternary

    def __init__(self, root="./bdd100k", split="train", subset="100k", label_type="binary",
                 mode=None, base_size=520, crop_size=480, sample_ratio=1.0, max_samples=None,
                 multi_scale=False, keep_original_size=False, min_scale=0.8, max_scale=1.2,
                 rng=None, **kwargs):
        self.root = root
        self.split = split
        self.subset = subset
        self.label_type = label_type
        self.NUM_CLASS = 2 if label_type == "binary" else 3
        self.mode = mode if mode is not None else split
        self.base_size = base_size
        self.crop_size = crop_size
        self.sample_ratio = sample_ratio
        self.max_samples = max_samples
        self.multi_scale = multi_scale
        self.keep_original_size = keep_original_size
        # the device-aug chain the trainer builds: flip + blur at the native
        # resolution for keep-original-size, else the PSP chain
        self.DEVICE_AUG_CHAIN = "original" if keep_original_size else "psp"
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.tf = SyncTransforms(base_size, crop_size, rng=rng)
        self.images, self.mask_paths = self._get_pairs(root, split, subset)
        if sample_ratio < 1.0 or max_samples is not None:
            self.images, self.mask_paths = self._apply_sampling(self.images, self.mask_paths)
        if len(self.images) == 0:
            raise RuntimeError(f"Found 0 images in subfolders of: {root}")

    def _get_pairs(self, root, split, subset):
        img_dir = os.path.join(root, "images", subset, split)
        label_dir = os.path.join(root, "drivable_maps", "labels", split)
        if not os.path.exists(img_dir):
            raise RuntimeError(f"Image directory not found: {img_dir}")
        if not os.path.exists(label_dir):
            raise RuntimeError(f"Label directory not found: {label_dir}")
        img_paths, mask_paths = [], []
        for img_file in sorted(f for f in os.listdir(img_dir) if f.endswith(".jpg")):
            base = os.path.splitext(img_file)[0]
            label_path = os.path.join(label_dir, f"{base}_drivable_id.png")
            if os.path.exists(label_path):
                img_paths.append(os.path.join(img_dir, img_file))
                mask_paths.append(label_path)
        return img_paths, mask_paths

    def _apply_sampling(self, images, mask_paths):
        """Seed-42 reproducible subsampling (reference:bdd100k.py:325-347)."""
        total = len(images)
        if self.max_samples is not None:
            target = min(self.max_samples, total)
        else:
            target = int(total * self.sample_ratio)
        if target >= total:
            return images, mask_paths
        indices = sorted(_random.Random(42).sample(range(total), target))
        return [images[i] for i in indices], [mask_paths[i] for i in indices]

    def _mask_transform(self, mask: np.ndarray) -> np.ndarray:
        if mask.ndim == 3:
            mask = mask[:, :, 0]
        mask = mask.astype(np.int32)
        if self.label_type == "binary":
            return np.where(mask == 1, 1, 0).astype(np.int32)
        return np.clip(mask, 0, 2).astype(np.int32)

    def __getitem__(self, index):
        img = decoded_cache.open_rgb(self.images[index])
        if self.mode == "test":
            return img, os.path.basename(self.images[index])
        mask = decoded_cache.open_image(self.mask_paths[index])
        if self.mode == "device-aug":
            if self.multi_scale:
                # multi-scale without crop gives each sample its own size,
                # which does not batch; the host transform stays its path
                raise ValueError(
                    "device-aug supports the standard PSP transform and "
                    "--keep-original-size, not --multi-scale (variable "
                    "output shapes)")
        elif self.mode == "train":
            if self.keep_original_size:
                img, mask = self.tf.original_size(img, mask)
            elif self.multi_scale:
                img, mask = self.tf.multi_scale(img, mask, self.min_scale, self.max_scale)
            else:
                img, mask = self.tf.train(img, mask)
        elif self.mode == "val":
            # keep-original-size validates at the native resolution with no
            # random flip or blur, so that evaluations repeat
            if not self.keep_original_size:
                img, mask = self.tf.val(img, mask)
        elif self.mode != "testval":
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
