"""Host-side pre/postprocessing matching the deployed-model contract.

The port's own copy of ``fastscnn_tpu/perception/preprocessing.py``:

- ``preprocess_matched_resolution``: resize→640×360 if needed, BGR→RGB,
  float16/32 keeping [0,255], HWC→NCHW with batch dim.
- ``postprocess_matched_resolution``: argmax over the class dim →
  0/255 uint8 mask → nearest resize back to the original size.
- ``create_visualization``: green drivable overlay.

The JAX module resizes with OpenCV where it is installed and with PIL
otherwise; the port has neither, and resizes with ``data/pil_ops.py``,
bit-equal to Pillow's bilinear and nearest resizes. The overlay is the
JAX module's numpy branch.
"""

from __future__ import annotations

import numpy as np

from fastscnn_tpu_torch.data import pil_ops

__all__ = [
    "preprocess_matched_resolution",
    "postprocess_matched_resolution",
    "create_visualization",
]


def _resize(img, width, height, nearest=False):
    return pil_ops.resize(img, (width, height), "nearest" if nearest else "bilinear")


def preprocess_matched_resolution(
    img_bgr: np.ndarray, target_width=640, target_height=360, dtype=np.float32
) -> np.ndarray:
    """BGR any-size image → (1, 3, H, W) float tensor in [0, 255]."""
    height, width = img_bgr.shape[:2]
    if width != target_width or height != target_height:
        img_bgr = _resize(img_bgr, target_width, target_height)
    img_rgb = img_bgr[:, :, ::-1]
    img_typed = img_rgb.astype(dtype)
    return np.ascontiguousarray(np.transpose(img_typed, (2, 0, 1))[np.newaxis])


def postprocess_matched_resolution(
    output_tensor: np.ndarray, original_width: int, original_height: int
) -> np.ndarray:
    """(1, C, H, W) logits → (original_height, original_width) 0/255 mask.

    Any non-background argmax maps to 255 (``pred * 255`` would wrap in
    uint8 for C > 2 and corrupt downstream ``mask > 0`` consumers)."""
    pred_mask = np.argmax(output_tensor, axis=1).squeeze()
    vis_mask = np.where(pred_mask > 0, 255, 0).astype(np.uint8)
    model_height, model_width = vis_mask.shape
    if original_width != model_width or original_height != model_height:
        vis_mask = _resize(vis_mask, original_width, original_height, nearest=True)
    return vis_mask


def create_visualization(original_img: np.ndarray, mask: np.ndarray, alpha=0.5) -> np.ndarray:
    """Green overlay of the drivable mask on the BGR image."""
    green = np.zeros_like(original_img)
    green[mask > 0] = [0, 255, 0]
    return np.clip(
        original_img.astype(np.float64) + green.astype(np.float64) * alpha, 0, 255
    ).astype(np.uint8)
