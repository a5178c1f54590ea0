"""Visual lateral-error differential-drive controller.

The port's own copy of ``fastscnn_tpu/control/visual_controller.py``.
Three modules:

1. visual error perception — lateral error = preview-point x − car x,
   where the car is the image bottom-center projected to world
   coordinates and the preview point is the waypoint whose distance is
   closest to ``preview_distance`` among points ahead (smaller world Y);
2. proportional steering — steering = Kp · error;
3. dynamic speed adaptation — pwm = base / (1 + damping·|error|),
   clipped to [min_pwm, max_pwm]; wheels: left = pwm + steering,
   right = pwm − steering, each clipped to ±1000.

The EMA smoothing of the input error (α, enable flag, hot update, reset)
is included. The control overlay, which the JAX module draws with
OpenCV, follows its branch without cv2: the map comes back unchanged.
"""

from __future__ import annotations

import json
import time

import numpy as np

from fastscnn_tpu_torch.perception.calibration import get_corrected_calibration

__all__ = ["VisualLateralErrorController"]


class VisualLateralErrorController:
    def __init__(
        self,
        steering_gain: float = 50.0,
        base_pwm: float = 300,
        curvature_damping: float = 0.1,
        preview_distance: float = 30.0,
        max_pwm: float = 1000,
        min_pwm: float = 100,
        ema_alpha: float = 0.5,
        enable_smoothing: bool = True,
    ):
        self.steering_gain = steering_gain
        self.base_pwm = base_pwm
        self.curvature_damping = curvature_damping
        self.preview_distance = preview_distance
        self.max_pwm = max_pwm
        self.min_pwm = min_pwm
        self.ema_alpha = ema_alpha
        self.enable_smoothing = enable_smoothing
        self.ema_lateral_error: float | None = None
        self.control_history: list[dict] = []

    # -- module 1: visual error perception -----------------------------------
    def calculate_lateral_error(self, path_data, view_params):
        car_position = self._get_car_position_world(view_params)
        control_point = self._find_preview_point(path_data, car_position)
        if control_point is None:
            return 0.0, car_position, None
        return control_point[0] - car_position[0], car_position, control_point

    # -- module 2: proportional steering -------------------------------------
    def calculate_steering_adjustment(self, lateral_error):
        return self.steering_gain * lateral_error

    # -- module 3: dynamic speed adaptation ----------------------------------
    def calculate_dynamic_pwm(self, lateral_error):
        dynamic = self.base_pwm / (1 + self.curvature_damping * abs(lateral_error))
        return float(np.clip(dynamic, self.min_pwm, self.max_pwm))

    def compute_wheel_pwm(self, path_data, view_params):
        raw_error, car_position, control_point = self.calculate_lateral_error(
            path_data, view_params
        )
        if self.enable_smoothing:
            if self.ema_lateral_error is None:
                self.ema_lateral_error = raw_error
                lateral_error = raw_error
            else:
                self.ema_lateral_error = (
                    self.ema_alpha * raw_error + (1 - self.ema_alpha) * self.ema_lateral_error
                )
                lateral_error = self.ema_lateral_error
        else:
            lateral_error = raw_error

        steering = self.calculate_steering_adjustment(lateral_error)
        dynamic_pwm = self.calculate_dynamic_pwm(lateral_error)
        pwm_right = float(np.clip(dynamic_pwm - steering, -1000, 1000))
        pwm_left = float(np.clip(dynamic_pwm + steering, -1000, 1000))

        result = {
            "lateral_error": lateral_error,
            "car_position": car_position,
            "control_point": control_point,
            "steering_adjustment": steering,
            "dynamic_pwm": dynamic_pwm,
            "pwm_right": pwm_right,
            "pwm_left": pwm_left,
            "turn_direction": (
                "left" if lateral_error < 0 else "right" if lateral_error > 0 else "straight"
            ),
            "curvature_level": abs(lateral_error) / self.preview_distance,
            "pwm_reduction_factor": self.base_pwm / dynamic_pwm if dynamic_pwm > 0 else 1.0,
            # compatibility aliases kept by the reference
            "dynamic_speed": dynamic_pwm,
            "speed_right": pwm_right,
            "speed_left": pwm_left,
            "speed_reduction_factor": self.base_pwm / dynamic_pwm if dynamic_pwm > 0 else 1.0,
            "smoothing_enabled": self.enable_smoothing,
            "ema_alpha": self.ema_alpha,
            "raw_lateral_error": raw_error,
            "smoothed_lateral_error": lateral_error,
            "smoothing_effect": abs(raw_error - lateral_error) if self.enable_smoothing else 0.0,
        }
        self.control_history.append(result.copy())
        if len(self.control_history) > 10_000:
            # bound the history: a 30 Hz loop would otherwise grow without
            # limit, and save_control_data only reads the last 10 entries
            del self.control_history[:-5_000]
        return result

    # -- EMA state management -------------------------------------------------
    def reset_ema_state(self):
        self.ema_lateral_error = None

    def update_smoothing_params(self, ema_alpha=None, enable_smoothing=None):
        if ema_alpha is not None:
            self.ema_alpha = max(0.1, min(1.0, ema_alpha))
        if enable_smoothing is not None:
            if not enable_smoothing and self.enable_smoothing:
                self.reset_ema_state()
            self.enable_smoothing = enable_smoothing

    # -- geometry -------------------------------------------------------------
    def _get_car_position_world(self, view_params):
        try:
            if "image_to_world_matrix" in view_params:
                matrix = np.asarray(view_params["image_to_world_matrix"], np.float64)
            else:
                matrix = np.asarray(
                    get_corrected_calibration()["transform_matrix"], np.float64
                )
            pt = matrix @ np.asarray([320, 359, 1], np.float64)
            return (float(pt[0] / pt[2]), float(pt[1] / pt[2]))
        except Exception:
            min_x, _, max_x, max_y = view_params["view_bounds"]
            return ((min_x + max_x) / 2, max_y)

    def _find_preview_point(self, path_data, car_position):
        waypoints = path_data.get("waypoints", [])
        if not waypoints:
            return None
        car_x, car_y = car_position
        best, best_diff = None, float("inf")
        for wx, wy in waypoints:
            if wy < car_y:  # only points ahead (smaller world Y)
                distance = np.hypot(wx - car_x, wy - car_y)
                diff = abs(distance - self.preview_distance)
                if diff < best_diff:
                    best_diff = diff
                    best = (wx, wy)
        if best is None and waypoints:
            best = min(waypoints, key=lambda p: p[1])
        return best

    # -- visualization / persistence ------------------------------------------
    def generate_control_visualization(self, control_map, control_result, view_params):
        """The JAX controller draws the car, the target and the control
        readout on the map with OpenCV and returns the map unchanged
        without it; so does this one (the port has no cv2)."""
        return control_map

    def save_control_data(self, control_result, json_path):
        def conv(o):
            if isinstance(o, np.ndarray):
                return o.tolist()
            if isinstance(o, (np.integer,)):
                return int(o)
            if isinstance(o, (np.floating,)):
                return float(o)
            if isinstance(o, np.bool_):
                return bool(o)
            if isinstance(o, dict):
                return {k: conv(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return [conv(v) for v in o]
            return o

        data = {
            "algorithm_name": "visual lateral-error proportional-speed-adaptive differential drive",
            "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
            "parameters": {
                "steering_gain": float(self.steering_gain),
                "base_pwm": float(self.base_pwm),
                "curvature_damping": float(self.curvature_damping),
                "preview_distance": float(self.preview_distance),
                "max_pwm": float(self.max_pwm),
                "min_pwm": float(self.min_pwm),
            },
            "current_control": conv(control_result),
            "control_history": conv(self.control_history[-10:]),
            "units": {"position": "cm", "pwm": "-1000~+1000 (bidirectional)", "error": "cm"},
        }
        with open(json_path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=2, ensure_ascii=False)
