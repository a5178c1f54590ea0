"""Bird's-eye-view perspective transform.

The port's own copy of ``fastscnn_tpu/perception/transform.py``:
``PerspectiveTransformer`` maps an image and its mask to a bird's-eye
view through the combined world→pixel · image→world homography, over
the full image's or the calibration region's bounds with a margin,
rescaled for inputs other than 640×360, and returns the ``view_params``
dict the planner and the controller read.

The warp is the JAX module's numpy inverse mapping (bilinear for images,
nearest for masks, constant-0 border), its branch without OpenCV: the
port has no cv2.
"""

from __future__ import annotations

import numpy as np

from fastscnn_tpu_torch.perception.calibration import (
    get_builtin_calibration,
    get_corrected_calibration,
)

__all__ = ["PerspectiveTransformer", "warp_perspective"]


def warp_perspective(image: np.ndarray, matrix: np.ndarray, out_size, nearest=False):
    """``cv2.warpPerspective`` with a constant-0 border, by inverse mapping:
    each output pixel samples the source at ``matrix⁻¹ · (x, y, 1)``."""
    out_w, out_h = out_size
    inv = np.linalg.inv(matrix.astype(np.float64))
    ys, xs = np.mgrid[0:out_h, 0:out_w]
    ones = np.ones_like(xs, np.float64)
    src = inv @ np.stack([xs, ys, ones]).reshape(3, -1)
    sx = (src[0] / src[2]).reshape(out_h, out_w)
    sy = (src[1] / src[2]).reshape(out_h, out_w)
    h, w = image.shape[:2]
    if nearest:
        ix = np.round(sx).astype(np.int64)
        iy = np.round(sy).astype(np.int64)
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        out_shape = (out_h, out_w) + image.shape[2:]
        out = np.zeros(out_shape, image.dtype)
        out[valid] = image[iy[valid], ix[valid]]
        return out
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = sx - x0
    fy = sy - y0
    out_shape = (out_h, out_w) + image.shape[2:]
    acc = np.zeros(out_shape, np.float64)
    for dy in (0, 1):
        for dx in (0, 1):
            wgt = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
            xi = np.clip(x0 + dx, 0, w - 1)
            yi = np.clip(y0 + dy, 0, h - 1)
            sample = image[yi, xi].astype(np.float64)
            inside = (
                (x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0) & (y0 + dy < h)
            ).astype(np.float64)
            weight = (wgt * inside)[..., None] if image.ndim == 3 else wgt * inside
            acc += sample * weight
    return acc.astype(image.dtype)


class PerspectiveTransformer:
    """Generates bird's-eye views of images and segmentation masks."""

    def __init__(self, calibration_data: dict | None = None, use_corrected: bool = True):
        if calibration_data is None:
            calibration_data = (
                get_corrected_calibration() if use_corrected else get_builtin_calibration()
            )
        self.calibration_data = calibration_data
        self.transform_matrix = np.asarray(calibration_data["transform_matrix"], np.float32)
        self.inverse_transform_matrix = np.asarray(
            calibration_data["inverse_transform_matrix"], np.float32
        )
        self.image_points = calibration_data["image_points"]
        self.world_points = calibration_data["world_points"]
        self.original_image_size = calibration_data["image_size"]

    def calculate_bird_eye_params(
        self, pixels_per_unit=20, margin_ratio=0.1, full_image=True
    ):
        """Output size, combined homography and world bounds of the view:
        the full image's corners (``full_image``) or the calibration
        points, widened by ``margin_ratio``."""
        if full_image:
            img_w, img_h = self.original_image_size
            corners = np.asarray(
                [[0, 0, 1], [img_w - 1, 0, 1], [img_w - 1, img_h - 1, 1], [0, img_h - 1, 1]],
                np.float64,
            )
            pts = (self.transform_matrix.astype(np.float64) @ corners.T).T
            world = pts[:, :2] / pts[:, 2:3]
            min_x, min_y = world.min(axis=0)
            max_x, max_y = world.max(axis=0)
            margin_x = (max_x - min_x) * margin_ratio
            margin_y = (max_y - min_y) * margin_ratio
            min_x -= margin_x
            min_y -= margin_y
            max_x += margin_x
            max_y += margin_y
        else:
            world = np.asarray(self.world_points)
            min_x, min_y = world.min(axis=0)
            max_x, max_y = world.max(axis=0)
            margin = max(max_x - min_x, max_y - min_y) * margin_ratio
            min_x -= margin
            min_y -= margin
            max_x += margin
            max_y += margin

        output_width = int((max_x - min_x) * pixels_per_unit)
        output_height = int((max_y - min_y) * pixels_per_unit)
        world_to_pixel = np.asarray(
            [
                [pixels_per_unit, 0, -min_x * pixels_per_unit],
                [0, pixels_per_unit, -min_y * pixels_per_unit],
                [0, 0, 1],
            ],
            np.float32,
        )
        combined = world_to_pixel @ self.transform_matrix
        return output_width, output_height, combined, (min_x, min_y, max_x, max_y)

    def transform_image_and_mask(
        self, image, mask, pixels_per_unit=20, margin_ratio=0.1, full_image=True
    ):
        """Bird's-eye image (bilinear), mask (nearest) and ``view_params``."""
        out_w, out_h, combined, view_bounds = self.calculate_bird_eye_params(
            pixels_per_unit, margin_ratio, full_image
        )
        in_h, in_w = image.shape[:2]
        orig_w, orig_h = self.original_image_size
        if in_w != orig_w or in_h != orig_h:
            scale = np.asarray(
                [[in_w / orig_w, 0, 0], [0, in_h / orig_h, 0], [0, 0, 1]], np.float32
            )
            combined = combined @ np.linalg.inv(scale)
        bird_eye_image = warp_perspective(image, combined, (out_w, out_h))
        bird_eye_mask = warp_perspective(mask, combined, (out_w, out_h), nearest=True)
        view_params = {
            "output_size": (out_w, out_h),
            "view_bounds": view_bounds,
            "pixels_per_unit": pixels_per_unit,
            "margin_ratio": margin_ratio,
            "transform_matrix": combined.tolist(),
            "image_to_world_matrix": self.transform_matrix.tolist(),
        }
        return bird_eye_image, bird_eye_mask, view_params
