"""Streaming pixel accuracy and mIoU, computed on the device.

Counterpart of ``fastscnn_tpu/utils/metric.py``: the reference's
histogram math (pixels with negative labels ignored, predicted or label
ids outside ``[0, nclass)`` counted in no class) as fixed-shape tensor
reductions whose sums add across batches.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["seg_hist_update", "seg_scores_from_hist", "SegmentationMetric"]


def _onehot(ids: torch.Tensor, nclass: int) -> torch.Tensor:
    """int32 one-hot along a new last axis; ids outside [0, nclass) give a
    zero row (``jax.nn.one_hot``'s rule — ``F.one_hot`` would raise)."""
    classes = torch.arange(nclass, device=ids.device, dtype=ids.dtype)
    return (ids.unsqueeze(-1) == classes).to(torch.int32)


def seg_hist_update(pred: torch.Tensor, target: torch.Tensor, nclass: int,
                    per_sample: bool = False):
    """Sufficient statistics of one batch: ``(correct, labeled, inter,
    union)`` as int32 tensors on the inputs' device — scalars and (C,), or
    with ``per_sample`` reduced over every axis but the leading batch axis:
    (B,), (B,), (B, C), (B, C)."""
    pred = pred.to(torch.int32)
    target = target.to(torch.int32)
    valid = target >= 0
    axes = tuple(range(pred.ndim))[1:] if per_sample else tuple(range(pred.ndim))

    def total(t):
        return t.sum(dim=axes).to(torch.int32) if axes else t.to(torch.int32)

    correct = total((pred == target) & valid)
    labeled = total(valid)
    v = valid.unsqueeze(-1).to(torch.int32)
    onehot_t = _onehot(torch.where(valid, target, torch.zeros_like(target)), nclass) * v
    onehot_p = _onehot(pred, nclass) * v
    area_lab = total(onehot_t)
    area_pred = total(onehot_p)
    inter = total(onehot_t * onehot_p)
    union = area_pred + area_lab - inter
    return correct, labeled, inter, union


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def seg_scores_from_hist(correct, labeled, inter, union):
    """(pixAcc, mIoU) from accumulated statistics."""
    correct = np.asarray(_np(correct), np.float64)
    labeled = np.asarray(_np(labeled), np.float64)
    inter = np.asarray(_np(inter), np.float64)
    union = np.asarray(_np(union), np.float64)
    pix_acc = correct / (np.spacing(1) + labeled)
    iou = inter / (np.spacing(1) + union)
    return float(pix_acc), float(iou.mean())


class SegmentationMetric:
    """The reference metric class: ``update(pred, label)`` takes numpy
    arrays or tensors (batched or single, or lists of them), ``get()``
    returns (pixAcc, mIoU)."""

    def __init__(self, nclass: int):
        self.nclass = nclass
        self.reset()

    def reset(self):
        self.total_correct = 0
        self.total_label = 0
        self.total_inter = np.zeros(self.nclass, np.int64)
        self.total_union = np.zeros(self.nclass, np.int64)

    def update(self, preds, labels):
        if isinstance(preds, (list, tuple)):
            for p, lab in zip(preds, labels):
                self.update(p, lab)
            return
        if isinstance(preds, np.ndarray) and isinstance(labels, np.ndarray):
            # host arrays: the same integer math in numpy, no device trip
            n = self.nclass
            p = preds.astype(np.int64, copy=False).ravel()
            lab = labels.astype(np.int64, copy=False).ravel()
            valid = lab >= 0
            self.total_correct += int(((p == lab) & valid).sum())
            self.total_label += int(valid.sum())
            pv, lv = p[valid], lab[valid]
            area_p = np.bincount(pv[(pv >= 0) & (pv < n)], minlength=n)[:n]
            area_l = np.bincount(lv[lv < n], minlength=n)[:n]
            inter = np.bincount(lv[(pv == lv) & (lv < n)], minlength=n)[:n]
            self.total_inter += inter
            self.total_union += area_p + area_l - inter
            return
        preds, labels = torch.as_tensor(preds), torch.as_tensor(labels)
        self.update_stats(*seg_hist_update(preds, labels.to(preds.device), self.nclass))

    def update_stats(self, correct, labeled, inter, union):
        """Accumulate statistics computed on the device (one sample's row of
        a ``per_sample`` :func:`seg_hist_update`, or a batch's totals)."""
        self.total_correct += int(correct)
        self.total_label += int(labeled)
        self.total_inter += np.asarray(_np(inter), np.int64)
        self.total_union += np.asarray(_np(union), np.int64)

    def get(self):
        return seg_scores_from_hist(
            self.total_correct, self.total_label, self.total_inter, self.total_union
        )

    def per_class_iou(self):
        return self.total_inter / (np.spacing(1) + self.total_union)
