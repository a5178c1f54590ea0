"""The synthetic 19-class Cityscapes tree of the JAX package's system check.

Counterpart of ``fastscnn_tpu/tools/system_check.py``; only
:func:`generate_dataset` is ported. The tree is the JAX one pixel for
pixel (the same ``default_rng`` draws in the same order), its PNGs
written by :func:`~fastscnn_tpu_torch.data.image_io.write_png` instead of
PIL. The check's ``main`` (train, export, the pipeline) waits for the
export surface (ROADMAP.md, queue 1, item 5).
"""

from __future__ import annotations

import os

import numpy as np

from fastscnn_tpu_torch.data.image_io import write_png

__all__ = ["generate_dataset"]

# The 19 valid Cityscapes labelIds (train ids 0..18).
_VALID = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33)


def generate_dataset(root: str, n_train=24, n_val=4, height=128, width=256, seed=0):
    """Synthetic scenes: horizontal bands of classes, each class with a
    distinctive (noisy) color — learnable but not trivial. Writes
    ``leftImg8bit/{train,val}/synth/*.png`` (RGB) and the matching
    ``gtFine_labelIds`` maps (greyscale) under ``root``; returns ``root``."""
    rng = np.random.default_rng(seed)
    palette = rng.integers(30, 226, (19, 3))
    for split, count in (("train", n_train), ("val", n_val)):
        img_dir = os.path.join(root, "leftImg8bit", split, "synth")
        lbl_dir = os.path.join(root, "gtFine", split, "synth")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(lbl_dir, exist_ok=True)
        for i in range(count):
            img = np.zeros((height, width, 3), np.float64)
            lbl = np.zeros((height, width), np.uint8)
            n_bands = rng.integers(3, 7)
            edges = np.sort(rng.choice(np.arange(8, height - 8), n_bands - 1, replace=False))
            edges = np.concatenate([[0], edges, [height]])
            classes = rng.choice(19, n_bands, replace=False)
            for b in range(n_bands):
                sl = slice(edges[b], edges[b + 1])
                img[sl] = palette[classes[b]]
                lbl[sl] = _VALID[classes[b]]
            img += rng.normal(0, 18, img.shape)
            # a few ignore blobs (labelId 0 = unlabeled → trainId -1)
            for _ in range(2):
                y = rng.integers(0, height - 12)
                x = rng.integers(0, width - 12)
                lbl[y : y + 12, x : x + 12] = 0
            write_png(os.path.join(img_dir, f"synth_{i:06d}_leftImg8bit.png"),
                      np.clip(img, 0, 255).astype(np.uint8))
            write_png(os.path.join(lbl_dir, f"synth_{i:06d}_gtFine_labelIds.png"), lbl)
    return root
