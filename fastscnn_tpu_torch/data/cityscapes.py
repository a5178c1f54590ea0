"""Cityscapes 19-class semantic segmentation dataset.

Counterpart of ``fastscnn_tpu/data/cityscapes.py``: the same pairing
(``leftImg8bit`` ↔ ``gtFine_labelIds`` by a directory walk), the 34 → 19
trainId remap (ignore = -1) and modes. Images come out as uint8 HWC
arrays, masks as int32 HW.
"""

from __future__ import annotations

import os

import numpy as np

from fastscnn_tpu_torch.data import decoded_cache
from fastscnn_tpu_torch.data.transforms import SyncTransforms

__all__ = ["CitySegmentation"]

# labelId → trainId lookup for ids -1..33 (-1 and unlabeled ids → -1).
_VALID_CLASSES = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33)
_KEY = np.full(35, -1, np.int32)
for train_id, label_id in enumerate(_VALID_CLASSES):
    _KEY[label_id + 1] = train_id


class CitySegmentation:
    BASE_DIR = "cityscapes"
    NUM_CLASS = 19
    normalization = "imagenet"
    # device-aug pad fill: the remap of the reference's raw-0 pad (label 0,
    # 'unlabeled' → ignore); see data/device_aug.py
    DEVICE_AUG_PAD_LABEL = -1

    def __init__(self, root="./datasets/citys", split="train", mode=None, base_size=520,
                 crop_size=480, rng=None, **kwargs):
        self.root = root
        self.split = split
        self.mode = mode if mode is not None else split
        self.tf = SyncTransforms(base_size, crop_size, rng=rng)
        self.images, self.mask_paths = _get_city_pairs(root, split)
        if len(self.images) != len(self.mask_paths):
            raise RuntimeError(f"{len(self.images)} images but {len(self.mask_paths)} masks")
        if len(self.images) == 0:
            raise RuntimeError(f"Found 0 images in subfolders of: {root}")

    def _class_to_index(self, mask: np.ndarray) -> np.ndarray:
        mask = mask.astype(np.int32)
        if mask.min() < -1 or mask.max() > 33:
            raise ValueError(f"unexpected label ids {np.unique(mask)}")
        return _KEY[mask + 1]

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
            # device-aug: native resolution and remapped labels; the PSP
            # chain runs on the device inside the train step
            raise ValueError(f"unknown mode {self.mode!r}")
        return img, self._class_to_index(mask)

    def __len__(self):
        return len(self.images)

    @property
    def num_class(self):
        return self.NUM_CLASS

    @property
    def pred_offset(self):
        return 0


def _get_city_pairs(folder: str, split: str = "train"):
    def get_path_pairs(img_folder, mask_folder):
        img_paths, mask_paths = [], []
        for root, _, files in os.walk(img_folder):
            for filename in sorted(files):
                if filename.endswith(".png"):
                    imgpath = os.path.join(root, filename)
                    foldername = os.path.basename(os.path.dirname(imgpath))
                    maskname = filename.replace("leftImg8bit", "gtFine_labelIds")
                    maskpath = os.path.join(mask_folder, foldername, maskname)
                    if os.path.isfile(maskpath):
                        img_paths.append(imgpath)
                        mask_paths.append(maskpath)
        return img_paths, mask_paths

    def pairs(part):
        return get_path_pairs(os.path.join(folder, "leftImg8bit", part),
                              os.path.join(folder, "gtFine", part))

    if split in ("train", "val"):
        return pairs(split)
    if split != "trainval":
        raise ValueError(f"unknown split {split!r}")
    ti, tm = pairs("train")
    vi, vm = pairs("val")
    return ti + vi, tm + vm
