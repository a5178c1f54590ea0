"""The datasets' class counts and checkpoint acronyms.

The port's own copy of ``DATASET_NUM_CLASSES`` and ``DATASET_ACRONYMS``
from ``fastscnn_tpu/models/registry.py``: the ``NUM_CLASS`` constants of
the reference's four datasets, and the acronym in a checkpoint's name
(``fast_scnn_<acronym>.pth``).
"""

from __future__ import annotations

__all__ = ["DATASET_NUM_CLASSES", "DATASET_ACRONYMS"]

DATASET_NUM_CLASSES = {
    "citys": 19,
    "tusimple": 2,
    "bdd100k": 2,  # binary drivable by default; ternary uses 3
    "custom": 2,
}

DATASET_ACRONYMS = {
    "pascal_voc": "voc",
    "pascal_aug": "voc",
    "ade20k": "ade",
    "coco": "coco",
    "citys": "citys",
    "tusimple": "tusimple",
    "bdd100k": "bdd100k",
    "custom": "custom",
}
