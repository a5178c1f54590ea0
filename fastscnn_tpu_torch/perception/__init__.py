"""Perception: calibration, the bird's-eye view, path planning and the
model's host-side pre/postprocessing (the JAX package's ``perception``)."""

from fastscnn_tpu_torch.perception.calibration import (
    get_builtin_calibration,
    get_corrected_calibration,
    perspective_transform_matrix,
)
from fastscnn_tpu_torch.perception.transform import PerspectiveTransformer
from fastscnn_tpu_torch.perception.path_planning import (
    PathPlanner,
    create_control_map,
    add_grid_to_control_map,
    visualize_path_on_control_map,
    world_to_pixels,
    save_path_data_json,
)
from fastscnn_tpu_torch.perception.preprocessing import (
    preprocess_matched_resolution,
    postprocess_matched_resolution,
    create_visualization,
)

__all__ = [
    "get_builtin_calibration",
    "get_corrected_calibration",
    "perspective_transform_matrix",
    "PerspectiveTransformer",
    "PathPlanner",
    "create_control_map",
    "add_grid_to_control_map",
    "visualize_path_on_control_map",
    "world_to_pixels",
    "save_path_data_json",
    "preprocess_matched_resolution",
    "postprocess_matched_resolution",
    "create_visualization",
]
