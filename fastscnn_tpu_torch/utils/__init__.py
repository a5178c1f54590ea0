from fastscnn_tpu_torch.utils.lr_scheduler import LRScheduler, lr_schedule
from fastscnn_tpu_torch.utils.metric import (
    SegmentationMetric,
    seg_hist_update,
    seg_scores_from_hist,
)

__all__ = [
    "LRScheduler",
    "SegmentationMetric",
    "lr_schedule",
    "seg_hist_update",
    "seg_scores_from_hist",
]
