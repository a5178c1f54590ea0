from fastscnn_tpu_torch.losses.segmentation import (
    CITYSCAPES_CLASS_WEIGHTS,
    cross_entropy_loss,
    dice_loss,
    focal_dice_loss,
    get_loss_fn,
    mix_cross_entropy_loss,
    mix_dice_loss,
    mix_ohem_cross_entropy_loss,
    ohem_cross_entropy_loss,
)

__all__ = [
    "CITYSCAPES_CLASS_WEIGHTS",
    "cross_entropy_loss",
    "dice_loss",
    "focal_dice_loss",
    "get_loss_fn",
    "mix_cross_entropy_loss",
    "mix_dice_loss",
    "mix_ohem_cross_entropy_loss",
    "ohem_cross_entropy_loss",
]
