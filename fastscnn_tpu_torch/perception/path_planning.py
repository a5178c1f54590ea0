"""Centerline extraction, path smoothing, control-map generation.

The port's own copy of ``fastscnn_tpu/perception/path_planning.py``, with
the same outputs:

- ``extract_centerline``: per row (bottom-up), keep the largest
  contiguous drivable run of width ≥ min_width; center = (start+end)//2,
  with the run-length analysis vectorised in numpy.
- ``extract_centerline_fast``: the row-skipping centroid variant.
- ``smooth_path``: weighted ``np.polyfit`` of x = f(y) with a 1e6-weight
  anchor at the image-bottom-center world point (force_bottom_center);
  'spline' takes the same fit.
- ``generate_waypoints`` over the view's y range; path length;
  ``create_control_map``: the BEV mask as a BGR map, drivable in green.

The JAX module draws the grid, labels and path overlay on the map with
OpenCV, and returns the map unchanged where cv2 is missing. The port has
no cv2, so its two drawing functions are that branch: the map is the
green drivable area alone.
"""

from __future__ import annotations

import json

import numpy as np

from fastscnn_tpu_torch.perception.calibration import get_corrected_calibration

__all__ = [
    "PathPlanner",
    "create_control_map",
    "add_grid_to_control_map",
    "visualize_path_on_control_map",
    "world_to_pixels",
    "save_path_data_json",
]

def _row_runs(row: np.ndarray):
    """(start, end) pairs of maximal runs of row > 0 (end exclusive)."""
    mask = (row > 0).astype(np.int8)
    diff = np.diff(np.concatenate(([0], mask, [0])))
    starts = np.flatnonzero(diff == 1)
    ends = np.flatnonzero(diff == -1)
    return starts, ends


class PathPlanner:
    """Plans a drivable path from a bird's-eye segmentation mask."""

    def __init__(self, view_params: dict):
        self.view_params = view_params
        self.pixels_per_unit = view_params["pixels_per_unit"]
        self.view_bounds = view_params["view_bounds"]

    # -- centerline ----------------------------------------------------------
    def extract_centerline(self, bird_eye_mask, scan_from_bottom=True, min_width=10):
        height = bird_eye_mask.shape[0]
        rows = range(height - 1, -1, -1) if scan_from_bottom else range(height)
        points = []
        for y in rows:
            starts, ends = _row_runs(bird_eye_mask[y])
            widths = ends - starts
            keep = widths >= min_width
            if keep.any():
                # largest qualifying segment == the main road
                i = np.argmax(np.where(keep, widths, -1))
                center_x = int((starts[i] + ends[i]) // 2)
                points.append((center_x, y))
        return points, self._pixels_to_world(points)

    def extract_centerline_fast(
        self, bird_eye_mask, scan_from_bottom=True, min_width=5, skip_rows=5
    ):
        height = bird_eye_mask.shape[0]
        rows = (
            range(height - 1, -1, -skip_rows) if scan_from_bottom else range(0, height, skip_rows)
        )
        points = []
        for y in rows:
            idx = np.flatnonzero(bird_eye_mask[y] > 0)
            if len(idx) >= min_width:
                points.append((int(np.mean(idx)), y))
        return points, self._pixels_to_world(points)

    def _pixels_to_world(self, pixel_points):
        min_x, min_y, _, _ = self.view_bounds
        return [
            (min_x + px / self.pixels_per_unit, min_y + py / self.pixels_per_unit)
            for px, py in pixel_points
        ]

    # -- smoothing -----------------------------------------------------------
    def _get_bottom_center_world_coord(self):
        """World position of the 640×360 image's bottom-center pixel
        (reference:path_planning.py:388-416)."""
        try:
            if "image_to_world_matrix" in self.view_params:
                matrix = np.asarray(self.view_params["image_to_world_matrix"], np.float64)
            else:
                matrix = np.asarray(
                    get_corrected_calibration()["transform_matrix"], np.float64
                )
            pt = matrix @ np.asarray([320, 359, 1], np.float64)
            return (float(pt[0] / pt[2]), float(pt[1] / pt[2]))
        except Exception:
            return None

    def smooth_path(self, centerline_world, method="polynomial", degree=3,
                    force_bottom_center=True):
        if not centerline_world:
            return None, None
        points = np.asarray(centerline_world, np.float64)
        y = points[:, 1]
        x = points[:, 0]
        order = np.argsort(y)
        y, x = y[order], x[order]
        weights = np.ones_like(y)
        if force_bottom_center:
            bottom = self._get_bottom_center_world_coord()
            if bottom is not None:
                y = np.append(y, bottom[1])
                x = np.append(x, bottom[0])
                weights = np.append(weights, 1e6)
                order = np.argsort(y)
                y, x, weights = y[order], x[order], weights[order]
        if len(y) <= degree:
            return None, None
        # polynomial fit of x = f(y); 'spline' also falls back to weighted
        # polyfit (reference:path_planning.py:379-384).
        fit_params = np.polyfit(y, x, degree, w=weights)
        return np.poly1d(fit_params), fit_params

    # -- waypoints -----------------------------------------------------------
    def generate_waypoints(self, smooth_path_func, num_points=20, y_range=None):
        if smooth_path_func is None:
            return []
        if y_range is None:
            _, min_y, _, max_y = self.view_bounds
        else:
            min_y, max_y = y_range
        ys = np.linspace(min_y, max_y, num_points)
        xs = smooth_path_func(ys)
        return list(zip(xs, ys))

    def plan_complete_path(
        self,
        bird_eye_mask,
        smooth_method="polynomial",
        degree=3,
        num_waypoints=20,
        min_width=10,
        fast_mode=True,
        force_bottom_center=True,
    ):
        """reference:path_planning.py:450-512."""
        if fast_mode:
            centerline_pixels, centerline_world = self.extract_centerline_fast(
                bird_eye_mask, min_width=min_width // 2, skip_rows=3
            )
        else:
            centerline_pixels, centerline_world = self.extract_centerline(
                bird_eye_mask, min_width=min_width
            )
        if not centerline_world:
            return {
                "centerline_pixels": [],
                "centerline_world": [],
                "smooth_path_func": None,
                "fit_params": None,
                "waypoints": [],
                "path_length": 0,
                "num_centerline_points": 0,
                "num_waypoints": 0,
                "fast_mode": fast_mode,
                "force_bottom_center": force_bottom_center,
            }
        smooth_degree = min(2, degree) if fast_mode else degree
        smooth_path_func, fit_params = self.smooth_path(
            centerline_world,
            method=smooth_method,
            degree=smooth_degree,
            force_bottom_center=force_bottom_center,
        )
        waypoints = self.generate_waypoints(smooth_path_func, num_waypoints)
        return {
            "centerline_pixels": centerline_pixels,
            "centerline_world": centerline_world,
            "smooth_path_func": smooth_path_func,
            "fit_params": fit_params,
            "waypoints": waypoints,
            "path_length": self._calculate_path_length(waypoints) if waypoints else 0,
            "num_centerline_points": len(centerline_world),
            "num_waypoints": len(waypoints),
            "fast_mode": fast_mode,
            "force_bottom_center": force_bottom_center,
        }

    @staticmethod
    def _calculate_path_length(waypoints):
        if len(waypoints) < 2:
            return 0.0
        pts = np.asarray(waypoints, np.float64)
        return float(np.sum(np.hypot(*np.diff(pts, axis=0).T)))


# -- control-map rendering ---------------------------------------------------


def world_to_pixels(world_points, view_params):
    min_x, min_y, _, _ = view_params["view_bounds"]
    ppu = view_params["pixels_per_unit"]
    return [((wx - min_x) * ppu, (wy - min_y) * ppu) for wx, wy in world_points]


def create_control_map(
    bird_eye_mask,
    view_params,
    add_grid=True,
    add_path=True,
    path_smooth_method="polynomial",
    path_degree=3,
    num_waypoints=20,
    min_road_width=10,
    edge_computing=False,
    force_bottom_center=True,
):
    """BEV mask → BGR control map (green drivable) + planned path
    (reference:path_planning.py:33-95)."""
    control_map = np.zeros((*bird_eye_mask.shape, 3), np.uint8)
    control_map[bird_eye_mask > 0] = [0, 255, 0]
    path_data = None
    if add_path:
        try:
            planner = PathPlanner(view_params)
            path_data = planner.plan_complete_path(
                bird_eye_mask,
                smooth_method=path_smooth_method,
                degree=path_degree,
                num_waypoints=num_waypoints,
                min_width=min_road_width,
                fast_mode=edge_computing,
                force_bottom_center=force_bottom_center,
            )
            control_map = visualize_path_on_control_map(control_map, path_data, view_params)
        except Exception as e:  # pragma: no cover
            print(f"path planning failed: {e}")
            path_data = None
    if add_grid:
        control_map = add_grid_to_control_map(control_map, view_params)
    return control_map, path_data


def add_grid_to_control_map(control_map, view_params):
    """The JAX module's 10 cm grid, labels, origin and A4 markers are drawn
    with OpenCV, and without it that function returns the map unchanged:
    so does this one (the port has no cv2)."""
    return control_map


def visualize_path_on_control_map(control_map, path_data, view_params):
    """The centerline and waypoint overlay, drawn with OpenCV in the JAX
    module; unchanged without it, as here."""
    return control_map


def save_path_data_json(path_data, json_path):
    """reference:path_planning.py:598-622."""
    json_data = {
        "centerline_world": [list(map(float, p)) for p in path_data["centerline_world"]],
        "waypoints": [list(map(float, p)) for p in path_data["waypoints"]],
        "path_length": float(path_data["path_length"]),
        "num_centerline_points": path_data["num_centerline_points"],
        "num_waypoints": path_data["num_waypoints"],
        "fit_params": (
            np.asarray(path_data["fit_params"]).tolist()
            if path_data["fit_params"] is not None
            else None
        ),
        "description": "lane centerline and waypoint data (world coordinates, cm)",
        "coordinate_system": "world coordinates (cm)",
        "waypoints_description": "waypoints directly usable for vehicle control",
    }
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(json_data, f, indent=2, ensure_ascii=False)
