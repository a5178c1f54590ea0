"""Datasets, the threaded loader, the decoded cache and the on-device
augmentation (counterpart of ``fastscnn_tpu/data``). Nothing here
imports PIL at import time: the PNG path decodes with ``zlib`` and numpy
(``image_io``), and the host transforms import PIL where they run."""

from fastscnn_tpu_torch.data.bdd100k import BDD100KSegmentation
from fastscnn_tpu_torch.data.cityscapes import CitySegmentation
from fastscnn_tpu_torch.data.custom import CustomDataset
from fastscnn_tpu_torch.data.loader import DataLoader, narrow_labels
from fastscnn_tpu_torch.data.tusimple import TUSimpleSegmentation

datasets = {
    "citys": CitySegmentation,
    "tusimple": TUSimpleSegmentation,
    "bdd100k": BDD100KSegmentation,
    "custom": CustomDataset,
}


def get_segmentation_dataset(name, **kwargs):
    """Build a dataset by registry name."""
    return datasets[name.lower()](**kwargs)


__all__ = [
    "datasets",
    "get_segmentation_dataset",
    "CitySegmentation",
    "TUSimpleSegmentation",
    "BDD100KSegmentation",
    "CustomDataset",
    "DataLoader",
    "narrow_labels",
]
