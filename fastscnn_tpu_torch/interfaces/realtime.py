"""Realtime autonomous perception loop.

The port of ``fastscnn_tpu/interfaces/realtime.py``: a camera loop runs
preprocess → infer → postprocess → BEV → plan → control per frame,
optionally driving the serial car controller, sharing state with the web
dashboard under a lock, honouring hot parameter updates and the
emergency stop, and warning-but-continuing on camera read failures.

Camera access is abstracted behind ``FrameSource``; ``SyntheticCamera``
gives deterministic frames for runs without a camera. The OpenCV sources
(a V4L2 camera, a video file) raise on construction: the port has no cv2.
On the card, the session's CUDA graph is captured by :meth:`warm` on the
thread that starts the loop (``start_background`` calls it).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from fastscnn_tpu_torch.control import VisualLateralErrorController
from fastscnn_tpu_torch.perception import PerspectiveTransformer
from fastscnn_tpu_torch.pipeline import FRAME_SIZE, inference_single_image

__all__ = ["FrameSource", "OpenCVCamera", "VideoFileCamera", "SyntheticCamera",
           "RealtimePipeline"]


class FrameSource:
    """Minimal camera interface: ``read() -> (ok, bgr_frame)``.

    Sources may set ``self.exhausted = True`` when the stream has ended
    for good (video EOF, fixed frame budget) — the loop then terminates
    instead of treating it as a transient camera failure."""

    exhausted = False

    def read(self):  # pragma: no cover - interface
        raise NotImplementedError

    def release(self):
        pass


class OpenCVCamera(FrameSource):
    """A V4L2 camera at 640×360@30: it needs OpenCV, which the port does
    not have (ROADMAP.md, queue 1, item 5, left out: cameras)."""

    def __init__(self, index=0, width=640, height=360, fps=30):
        raise NotImplementedError(
            "OpenCVCamera needs cv2, which the port does not use; cameras are not ported yet "
            "(ROADMAP.md, queue 1, item 5, left out: cameras). Use SyntheticCamera or a "
            "FrameSource.")


class VideoFileCamera(FrameSource):
    """Frames from a video file: it needs OpenCV's decoder (ROADMAP.md,
    queue 1, item 5, left out: cameras)."""

    def __init__(self, path: str, loop: bool = False):
        raise NotImplementedError(
            "VideoFileCamera needs cv2, which the port does not use; video replay is not "
            "ported yet (ROADMAP.md, queue 1, item 5, left out: cameras)")


class SyntheticCamera(FrameSource):
    """Deterministic synthetic road frames for hardware-free runs."""

    def __init__(self, width=640, height=360, n_frames=None, fail_every=None):
        self.width = width
        self.height = height
        self.n_frames = n_frames
        self.fail_every = fail_every
        self.i = 0

    def read(self):
        self.i += 1
        if self.n_frames is not None and self.i > self.n_frames:
            self.exhausted = True
            return False, None
        if self.fail_every and self.i % self.fail_every == 0:
            return False, None
        frame = np.zeros((self.height, self.width, 3), np.uint8)
        # moving road band
        for y in range(self.height):
            cx = int(self.width / 2 + 60 * np.sin((y + 5 * self.i) / 80.0))
            frame[y, max(0, cx - 80) : min(self.width, cx + 80)] = (60, 60, 60)
        return True, frame


class RealtimePipeline:
    """The per-frame loop + shared state for the dashboard."""

    def __init__(
        self,
        session,
        camera: FrameSource,
        controller: VisualLateralErrorController | None = None,
        car=None,
        edge_computing: bool = True,
        pixels_per_unit: int = 20,
        target_fps: float = 30.0,
    ):
        self.session = session
        self.camera = camera
        self.controller = controller or VisualLateralErrorController()
        self.car = car  # SimpleCarController or None
        self.transformer = PerspectiveTransformer()
        self.edge_computing = edge_computing
        self.pixels_per_unit = pixels_per_unit
        self.target_fps = target_fps

        self.web_data: dict = {"frame_count": 0, "fps": 0.0}
        self.web_data_lock = threading.Lock()
        self.params_lock = threading.Lock()
        # serializes drive commands against emergency_stop: without it the
        # pipeline thread can pass the enabled-check, lose the CPU, and
        # send a nonzero-PWM packet AFTER the web thread's stop packet —
        # up to 500 ms of uncommanded motion until the firmware watchdog
        self.drive_lock = threading.Lock()
        self.pending_params: dict = {}
        self.driving_enabled = False
        self.emergency_stopped = False
        self.running = False
        self._thread: threading.Thread | None = None
        self.frame_count = 0
        self.camera_failures = 0

    # -- control API (called by the web layer) -------------------------------
    def update_params(self, params: dict):
        """Queue hot parameter updates (reference:web_interface.py:743-779)."""
        with self.params_lock:
            self.pending_params.update(params)

    def start_driving(self):
        self.emergency_stopped = False
        self.driving_enabled = True
        self.controller.reset_ema_state()

    def emergency_stop(self):
        """reference:web_interface.py:895-916 + controller EMA reset."""
        with self.drive_lock:
            self.emergency_stopped = True
            self.driving_enabled = False
            if self.car is not None:
                self.car.stop()
        self.controller.reset_ema_state()

    def get_stats(self) -> dict:
        with self.web_data_lock:
            return dict(self.web_data)

    # -- loop ----------------------------------------------------------------
    def _apply_pending_params(self):
        with self.params_lock:
            params, self.pending_params = self.pending_params, {}
        for key, value in params.items():
            if key in ("steering_gain", "base_pwm", "curvature_damping",
                       "preview_distance", "min_pwm", "max_pwm"):
                setattr(self.controller, key, float(value))
            elif key == "ema_alpha":
                self.controller.update_smoothing_params(ema_alpha=float(value))
            elif key == "enable_smoothing":
                self.controller.update_smoothing_params(enable_smoothing=bool(value))
            elif key == "pixels_per_unit":
                self.pixels_per_unit = int(value)

    def _adjusted_ppu(self) -> int:
        """Realtime BEV pixel density: the one-shot pipeline renders at the
        full configured ``pixels_per_unit`` (20 px/cm → a ~9 MP canvas at
        640×360), but the canvas area — two warps, the control-map render,
        the centerline scan — scales with ppu², and the planner's
        waypoints do not need that resolution. Edge mode pins 1 px/unit on
        the full-image view; non-edge keeps proportional floors."""
        if self.edge_computing:
            return 1
        return max(1, self.pixels_per_unit // 20)

    def warm(self):
        """Build the session's per-frame callable on the calling thread: on
        the card that captures its CUDA graph, which must not overlap
        another thread's use of the device (the dashboard's stats). The
        loop's thread then only replays it."""
        predict_fn = getattr(self.session, "predict_fn", None)
        if predict_fn is not None:
            predict_fn((1, FRAME_SIZE[1], FRAME_SIZE[0], 3))

    def step(self) -> bool:
        """One loop iteration; returns False when the source is exhausted."""
        self._apply_pending_params()
        ok, frame = self.camera.read()
        if not ok:
            if getattr(self.camera, "exhausted", False):
                return False
            self.camera_failures += 1
            time.sleep(0.01)
            return True
        t0 = time.perf_counter()
        result = inference_single_image(
            frame,
            self.session,
            bird_eye=True,
            save_control_map=True,
            enable_control=True,
            controller=self.controller,
            transformer=self.transformer,
            pixels_per_unit=self._adjusted_ppu(),
            edge_computing=self.edge_computing,
        )
        dt = time.perf_counter() - t0
        self.frame_count += 1

        control = result.get("control_result")
        if control and self.car is not None:
            with self.drive_lock:  # flag check + send are atomic vs e-stop
                if self.driving_enabled and not self.emergency_stopped:
                    self.car.set_wheel_speeds(
                        int(control["pwm_left"]), int(control["pwm_right"])
                    )

        with self.web_data_lock:
            self.web_data.update(
                frame_count=self.frame_count,
                fps=1.0 / dt if dt > 0 else 0.0,
                frame_time_ms=dt * 1e3,
                camera_failures=self.camera_failures,
                driving_enabled=self.driving_enabled,
                emergency_stopped=self.emergency_stopped,
                lateral_error=control["lateral_error"] if control else None,
                pwm_left=control["pwm_left"] if control else 0,
                pwm_right=control["pwm_right"] if control else 0,
                turn_direction=control["turn_direction"] if control else "straight",
            )
            self.web_data["control_map"] = result.get("control_map")
            self.web_data["visualization"] = result.get("visualization")
        return True

    def run(self, max_frames: int | None = None):
        self.running = True
        n = 0
        try:
            while self.running:
                if not self.step():
                    break
                n += 1
                if max_frames is not None and n >= max_frames:
                    break
        finally:
            self.running = False
            if self.car is not None:
                self.car.stop()
            self.camera.release()

    def start_background(self, max_frames=None):
        self.warm()
        self._thread = threading.Thread(target=self.run, args=(max_frames,), daemon=True)
        self._thread.start()
        return self._thread

    def stop(self):
        self.running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
