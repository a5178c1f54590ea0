"""Perspective-transform calibration (A4-paper homography).

The port's own copy of ``fastscnn_tpu/perception/calibration.py``: the
built-in calibration points of the 640×360 camera, the 4-point
homography solved directly (DLT, an 8×8 linear system, no OpenCV), and
the "corrected" calibration that makes the image's top and bottom edges
parallel in world Y.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "perspective_transform_matrix",
    "get_builtin_calibration",
    "get_corrected_calibration",
    "IMAGE_POINTS",
    "WORLD_POINTS",
    "IMAGE_SIZE",
]

# Built-in A4-paper calibration for the 640×360 camera.
IMAGE_POINTS = [(260, 87), (378, 87), (410, 217), (231, 221)]
WORLD_POINTS = [(0.0, 0.0), (21.0, 0.0), (21.0, 29.7), (0.0, 29.7)]  # cm
IMAGE_SIZE = [640, 360]


def perspective_transform_matrix(src_points, dst_points) -> np.ndarray:
    """Homography H (3×3) with H @ [x, y, 1]ᵀ ∝ [x', y', 1]ᵀ for the four
    correspondences — the math behind ``cv2.getPerspectiveTransform``."""
    src = np.asarray(src_points, np.float64)
    dst = np.asarray(dst_points, np.float64)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        a[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y]
        a[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y]
        b[2 * i] = u
        b[2 * i + 1] = v
    h = np.linalg.solve(a, b)
    return np.append(h, 1.0).reshape(3, 3)


def _project(matrix: np.ndarray, point_h) -> tuple[float, float]:
    p = matrix @ np.asarray(point_h, np.float64)
    return float(p[0] / p[2]), float(p[1] / p[2])


def get_builtin_calibration() -> dict:
    """The A4-paper calibration as measured: image ↔ world homographies."""
    transform = perspective_transform_matrix(IMAGE_POINTS, WORLD_POINTS)
    inverse = perspective_transform_matrix(WORLD_POINTS, IMAGE_POINTS)
    return {
        "image_size": list(IMAGE_SIZE),
        "image_points": list(IMAGE_POINTS),
        "world_points": list(WORLD_POINTS),
        "transform_matrix": transform.tolist(),
        "inverse_transform_matrix": inverse.tolist(),
        "description": "A4-paper perspective calibration",
        "units": "centimeters",
    }


def get_corrected_calibration(verbose: bool = False) -> dict:
    """Re-derive the homography forcing the image's top and bottom edges to
    be parallel in world Y (a rectangular bird's-eye view)."""
    original = get_builtin_calibration()
    transform = np.asarray(original["transform_matrix"], np.float32)
    w, h = IMAGE_SIZE
    corners_h = [(0, 0, 1), (w - 1, 0, 1), (w - 1, h - 1, 1), (0, h - 1, 1)]
    world_corners = np.asarray([_project(transform, c) for c in corners_h])

    top_y = (world_corners[0][1] + world_corners[1][1]) / 2
    bottom_y = (world_corners[2][1] + world_corners[3][1]) / 2
    corrected = [
        [world_corners[0][0], top_y],
        [world_corners[1][0], top_y],
        [world_corners[2][0], bottom_y],
        [world_corners[3][0], bottom_y],
    ]
    src = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
    new_transform = perspective_transform_matrix(src, corrected)
    new_inverse = perspective_transform_matrix(corrected, src)
    if verbose:
        print(
            f"perspective correction: top Y {world_corners[0][1]:.2f}~{world_corners[1][1]:.2f}"
            f" -> {top_y:.2f}; bottom Y {world_corners[2][1]:.2f}~{world_corners[3][1]:.2f}"
            f" -> {bottom_y:.2f} cm"
        )
    return {
        "image_size": list(IMAGE_SIZE),
        "image_points": list(IMAGE_POINTS),
        "world_points": list(WORLD_POINTS),
        "transform_matrix": new_transform.tolist(),
        "inverse_transform_matrix": new_inverse.tolist(),
        "corrected_world_corners": corrected,
        "original_world_corners": world_corners.tolist(),
        "description": "corrected perspective calibration (parallel top/bottom edges)",
        "units": "centimeters",
    }
