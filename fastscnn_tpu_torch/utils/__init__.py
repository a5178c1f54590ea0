from fastscnn_tpu_torch.utils.lr_scheduler import LRScheduler, lr_schedule
from fastscnn_tpu_torch.utils.metric import (
    SegmentationMetric,
    seg_hist_update,
    seg_scores_from_hist,
)
from fastscnn_tpu_torch.utils.visualize import get_color_pallete

__all__ = [
    "LRScheduler",
    "SegmentationMetric",
    "get_color_pallete",
    "lr_schedule",
    "seg_hist_update",
    "seg_scores_from_hist",
]
