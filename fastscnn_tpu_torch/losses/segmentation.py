"""Segmentation losses: Dice, Focal-Dice, CE and OHEM CE, all on the device.

Counterpart of ``fastscnn_tpu/losses/segmentation.py``, with the same
semantics. Logits are NHWC (class axis last), at the target's resolution
or lower; targets are (N, H, W) integer labels, ``ignore_label`` (−1)
marking pixels to ignore.

Each loss performs the network's final ``align_corners=True`` upsample
itself when the logits are smaller than the target (the train step asks
the model for 1/8 logits), through the interpolation-matrix contractions
of :func:`~fastscnn_tpu_torch.ops.resize.resize_bilinear_matmul`, as the
JAX losses do.

OHEM keeps the ``min_kept`` hardest valid pixels (lowest true-class
probability) and every pixel whose probability is at most
``max(thresh, k-th smallest)``. The k-th smallest is exact, ties included,
over the probabilities with ignored pixels set to ``inf`` (with fewer
valid pixels than ``min_kept`` it is ``inf`` and every valid pixel is
kept), found as the JAX package finds it: 31 bisection steps on the int32
bit pattern, each one full reduction. ``torch.kthvalue`` gives the same
value, but on the card it runs one block per slice: 42 ms per head at the
recipe's 9.4 M pixels on an H100, half of a train step's device time.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from fastscnn_tpu_torch.ops.resize import resize_bilinear_matmul

__all__ = [
    "dice_loss",
    "mix_dice_loss",
    "focal_dice_loss",
    "cross_entropy_loss",
    "mix_cross_entropy_loss",
    "ohem_cross_entropy_loss",
    "mix_ohem_cross_entropy_loss",
    "get_loss_fn",
    "CITYSCAPES_CLASS_WEIGHTS",
]

# Cityscapes class-balance weights of the reference trainer.
CITYSCAPES_CLASS_WEIGHTS = (
    0.8373, 0.918, 0.866, 1.0345, 1.0166, 0.9969, 0.9754,
    1.0489, 0.8786, 1.0023, 0.9539, 0.9843, 1.1116, 0.9037, 1.0865, 1.0955,
    1.0865, 1.1529, 1.0507,
)


def _match_resolution(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Upsample (align_corners=True) NHWC logits to the target's size."""
    if logits.ndim == 4 and target.ndim >= 3 and logits.shape[1:3] != target.shape[1:3]:
        logits = resize_bilinear_matmul(logits, tuple(target.shape[1:3]), align_corners=True)
    return logits


def _binary_diff_at_target_res(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(N, h, w, 2) logits → (N, H, W) f32 class-1-minus-class-0 logit at the
    target's size. Exact: softmax(z)[..., 1] == sigmoid(z1 − z0), and the
    resize is linear, so resizing the difference equals differencing the
    resized channels."""
    d = (logits[..., 1] - logits[..., 0]).float()
    if target.ndim >= 3 and d.shape[1:3] != target.shape[1:3]:
        d = resize_bilinear_matmul(d, tuple(target.shape[1:3]), align_corners=True)
    return d


def _dice_from_prob(prob: torch.Tensor, target: torch.Tensor, smooth: float) -> torch.Tensor:
    """1 − dice on a class-1 probability map; the raw target values enter
    the sums (no ignore masking), as in the reference."""
    p = prob.reshape(-1)
    t = target.reshape(-1).float()
    inter = (p * t).sum()
    return 1.0 - (2.0 * inter + smooth) / (p.sum() + t.sum() + smooth)


def dice_loss(logits, target, smooth: float = 1e-6):
    """Binary Dice on the class-1 probability: softmax for multi-channel
    logits, sigmoid for one channel."""
    if logits.ndim == 4 and logits.shape[-1] == 2:
        prob = torch.sigmoid(_binary_diff_at_target_res(logits, target))
    else:
        logits = _match_resolution(logits, target)
        lf = logits.float()
        if logits.ndim == 4 and logits.shape[-1] > 1:
            prob = torch.softmax(lf, dim=-1)[..., 1]
        elif logits.ndim == 4:
            prob = torch.sigmoid(lf[..., 0])
        else:
            prob = torch.sigmoid(lf)
    return _dice_from_prob(prob, target, smooth)


def mix_dice_loss(outputs, target, aux_weight: float = 0.4, smooth: float = 1e-6):
    """Main + aux_weight · aux Dice."""
    loss = dice_loss(outputs[0], target, smooth)
    if len(outputs) > 1:
        loss = loss + aux_weight * dice_loss(outputs[1], target, smooth)
    return loss


def _select_class(values: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``values[..., target]`` with the target clipped into range."""
    tc = target.clamp(0, values.shape[-1] - 1).long()
    return values.gather(-1, tc.unsqueeze(-1)).squeeze(-1)


def _per_pixel_ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Unreduced CE in f32; target clipped into range (callers mask)."""
    return -_select_class(torch.log_softmax(logits.float(), dim=-1), target)


def _pixel_class_weights(target, class_weights, num_classes):
    w = torch.as_tensor(class_weights, dtype=torch.float32, device=target.device)
    return w[target.clamp(0, num_classes - 1).long()]


def focal_dice_loss(logits, target, alpha: float = 0.5, gamma: float = 2.0,
                    dice_weight: float = 0.5, smooth: float = 1e-6):
    """(1 − dice_weight) · focal + dice_weight · dice."""
    if logits.ndim == 4 and logits.shape[-1] == 2:
        # 2-class CE through the logit difference:
        # −log softmax(z)[t] == −log_sigmoid((2t − 1)(z1 − z0)), target
        # clipped into [0, 1] as the general path clips it
        d = _binary_diff_at_target_res(logits, target)
        sign = 2.0 * target.clamp(0, 1).float() - 1.0
        ce = -F.logsigmoid(sign * d)
        pt = torch.exp(-ce)
        focal = (alpha * (1 - pt) ** gamma * ce).mean()
        dice = _dice_from_prob(torch.sigmoid(d), target, smooth)
        return (1 - dice_weight) * focal + dice_weight * dice
    logits = _match_resolution(logits, target)
    lf = logits.float()
    if logits.ndim == 4 and logits.shape[-1] > 1:
        ce = _per_pixel_ce(lf, target)
        pt = torch.exp(-ce)
    else:
        prob = torch.sigmoid(lf[..., 0] if logits.ndim == 4 else lf)
        tf = target.float()
        eps = 1e-12
        ce = -(tf * torch.log(prob + eps) + (1 - tf) * torch.log(1 - prob + eps))
        pt = torch.where(tf == 1, prob, 1 - prob)
    focal = (alpha * (1 - pt) ** gamma * ce).mean()
    return (1 - dice_weight) * focal + dice_weight * dice_loss(logits, target, smooth)


def cross_entropy_loss(logits, target, ignore_label: int = -1, class_weights=None):
    """CE with ignore label and optional class weights; the weighted mean of
    ``torch.nn.CrossEntropyLoss`` (denominator: the kept pixels' weights)."""
    logits = _match_resolution(logits, target)
    valid = (target != ignore_label).float()
    ce = _per_pixel_ce(logits, target)
    if class_weights is not None:
        pw = _pixel_class_weights(target, class_weights, logits.shape[-1])
        ce = ce * pw
        denom = (pw * valid).sum()
    else:
        denom = valid.sum()
    return (ce * valid).sum() / denom.clamp_min(1e-12)


def mix_cross_entropy_loss(outputs, target, aux_weight: float = 0.2, ignore_label: int = -1):
    loss = cross_entropy_loss(outputs[0], target, ignore_label)
    for aux_logits in outputs[1:]:
        loss = loss + aux_weight * cross_entropy_loss(aux_logits, target, ignore_label)
    return loss


def _kth_smallest_nonneg(x_flat: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th smallest of a non-negative f32 vector (``inf`` allowed):
    for such floats the int32 bit pattern orders as the value does, so 31
    bisection steps over [0, inf]'s bit range find the value a sort would
    (ties included), without a host sync."""
    bits = x_flat.view(torch.int32)
    lo = torch.zeros((), dtype=torch.int32, device=x_flat.device)
    hi = torch.full((), 0x7F800000, dtype=torch.int32, device=x_flat.device)
    for _ in range(31):
        mid = lo + (hi - lo) // 2
        kth_above_mid = (bits <= mid).sum() < k
        lo = torch.where(kth_above_mid, mid + 1, lo)
        hi = torch.where(kth_above_mid, hi, mid)
    return lo.view(torch.float32)


def ohem_cross_entropy_loss(logits, target, ignore_label: int = -1, thresh: float = 0.7,
                            min_kept: int = 256, class_weights=None):
    """Online hard example mining CE (see the module docstring), then the
    class-weighted CE mean over the kept pixels."""
    logits = _match_resolution(logits, target)
    lf = logits.float()
    valid = target != ignore_label
    # one per-pixel CE map drives both the mining and the loss:
    # ce = lse − l_t, true-class probability exp(−ce)
    ce_pix = torch.logsumexp(lf, dim=-1) - _select_class(lf, target)
    with torch.no_grad():
        true_prob = torch.exp(-ce_pix)
        flat = torch.where(valid, true_prob, torch.full_like(true_prob, float("inf"))).reshape(-1)
        k = min(int(min_kept), flat.numel())
        threshold = _kth_smallest_nonneg(flat, k).clamp_min(thresh) if k > 0 else thresh
        kept = (valid & (true_prob <= threshold)).float()
    if class_weights is not None:
        pw = _pixel_class_weights(target, class_weights, logits.shape[-1])
        num = (ce_pix * pw * kept).sum()
        den = (pw * kept).sum()
    else:
        num = (ce_pix * kept).sum()
        den = kept.sum()
    return num / den.clamp_min(1e-12)


def mix_ohem_cross_entropy_loss(outputs, target, aux_weight: float = 0.2, ignore_label: int = -1,
                                thresh: float = 0.7, min_kept: int = 256, class_weights=None):
    """OHEM on the main head plus aux_weight · OHEM on each aux head — the
    trainer's 'ce' loss."""
    loss = ohem_cross_entropy_loss(outputs[0], target, ignore_label, thresh, min_kept,
                                   class_weights)
    for aux_logits in outputs[1:]:
        loss = loss + aux_weight * ohem_cross_entropy_loss(
            aux_logits, target, ignore_label, thresh, min_kept, class_weights)
    return loss


def get_loss_fn(name: str, aux: bool = False, aux_weight: float = 0.4,
                num_classes: int | None = None, ignore_label: int = -1,
                use_class_weights: bool = True):
    """The trainer's loss registry: 'dice' → mix Dice, 'focal_dice' →
    Focal-Dice on the main head, 'ce' → mix OHEM CE (with the Cityscapes
    class weights when ``num_classes == 19``), 'ce_plain' → mix CE.
    ``aux=False`` trains on the main head only, whatever the model emits."""
    if not aux:
        main_only = get_loss_fn(name, aux=True, aux_weight=aux_weight, num_classes=num_classes,
                                ignore_label=ignore_label, use_class_weights=use_class_weights)
        return lambda outputs, target: main_only(outputs[:1], target)
    if name == "dice":
        return functools.partial(mix_dice_loss, aux_weight=aux_weight)
    if name == "focal_dice":
        return lambda outputs, target: focal_dice_loss(outputs[0], target)
    if name == "ce":
        weights = CITYSCAPES_CLASS_WEIGHTS if (use_class_weights and num_classes == 19) else None
        return functools.partial(mix_ohem_cross_entropy_loss, aux_weight=aux_weight,
                                 ignore_label=ignore_label, class_weights=weights)
    if name == "ce_plain":
        return functools.partial(mix_cross_entropy_loss, ignore_label=ignore_label)
    raise ValueError(f"unknown loss '{name}' (expected dice|focal_dice|ce|ce_plain)")
