"""The port's perception and controller (``fastscnn_tpu_torch/perception``,
``control``) against the JAX package's, on the CPU, bit for bit.

The same seeded numpy inputs go through both: homographies and the two
calibrations, ``warp_perspective`` (bilinear and nearest), the bird's-eye
transform at 1 and 20 px/unit, both centerline scans and the planner's
``plan_complete_path``, ``create_control_map``, the pre/postprocessing at
640×360 and at another size, ``create_visualization``, and the controller
over a sequence of paths with its EMA, a hot update and a reset.

The port has no OpenCV, so it is held against the JAX modules' branch
without cv2 (their resize then goes through PIL, which the port's
``pil_ops`` matches bit for bit): the ``cv2_absent`` fixture takes that
branch wherever cv2 is installed.
"""

import json
import sys

import numpy as np
import pytest

import fastscnn_tpu.perception.path_planning as jax_planning
import fastscnn_tpu.perception.preprocessing as jax_pre
import fastscnn_tpu.perception.transform as jax_transform
from fastscnn_tpu import perception as J
from fastscnn_tpu.control import VisualLateralErrorController as JaxController
from fastscnn_tpu_torch import perception as P
from fastscnn_tpu_torch.control import VisualLateralErrorController
from fastscnn_tpu_torch.perception import transform as port_transform


@pytest.fixture(autouse=True)
def cv2_absent(monkeypatch):
    """The JAX perception modules' branch without OpenCV."""
    for mod in (jax_transform, jax_pre, jax_planning):
        monkeypatch.setattr(mod, "_HAS_CV2", False)
    monkeypatch.setitem(sys.modules, "cv2", None)  # the controller imports it in its call


def assert_same(a, b, where="result"):
    """Equal values of equal types, recursively: arrays by dtype and
    elements, polynomials by coefficients, floats exactly."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, np.poly1d):
        assert isinstance(b, np.poly1d), where
        assert_same(a.coeffs, b.coeffs, f"{where}.coeffs")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b), f"{where}: {type(a)} vs {type(b)}"
        assert a == b or (a != a and b != b), f"{where}: {a!r} vs {b!r}"


def road_mask(width, height, seed, amp=30, half=25):
    """A curvy drivable band (0/255) with seeded jitter, as a BEV mask."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((height, width), np.uint8)
    for y in range(height):
        cx = int(width / 2 + amp * np.sin(y / 40.0) + rng.integers(-2, 3))
        h = half + int(5 * np.cos(y / 25.0))
        mask[y, max(0, cx - h):min(width, cx + h)] = 255
    return mask


def camera_frame(width=640, height=360, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (height, width, 3), dtype=np.uint8)


# -- calibration -------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_homography_is_bit_equal(seed):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 640, (4, 2)).tolist()
    dst = rng.uniform(-50, 50, (4, 2)).tolist()
    assert_same(P.perspective_transform_matrix(src, dst), J.perspective_transform_matrix(src, dst))


def test_calibrations_are_bit_equal(capsys):
    assert_same(P.get_builtin_calibration(), J.get_builtin_calibration())
    assert_same(P.get_corrected_calibration(verbose=True),
                J.get_corrected_calibration(verbose=True))
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1]


# -- bird's-eye view -----------------------------------------------------------


@pytest.mark.parametrize("nearest", [False, True], ids=["bilinear", "nearest"])
@pytest.mark.parametrize("shape", [(360, 640, 3), (120, 200), (97, 131, 3)])
def test_warp_perspective_is_bit_equal(nearest, shape):
    rng = np.random.default_rng(sum(shape))
    image = rng.integers(0, 256, shape, dtype=np.uint8)
    tf = J.PerspectiveTransformer()
    out_w, out_h, combined, _ = tf.calculate_bird_eye_params(pixels_per_unit=2)
    scale = np.diag([shape[1] / 640, shape[0] / 360, 1.0]).astype(np.float32)
    matrix = combined @ np.linalg.inv(scale)
    got = port_transform.warp_perspective(image, matrix, (out_w, out_h), nearest=nearest)
    ref = jax_transform.warp_perspective(image, matrix, (out_w, out_h), nearest=nearest)
    assert got.shape == (out_h, out_w) + shape[2:] and (got > 0).any()
    assert_same(got, ref)


@pytest.mark.parametrize("ppu,full_image,size", [
    (1, True, (640, 360)), (1, True, (500, 300)), (20, True, (640, 360)),
    (20, False, (640, 360)),
])
def test_transform_image_and_mask_is_bit_equal(ppu, full_image, size):
    image = camera_frame(*size, seed=ppu)
    mask = road_mask(*size, seed=ppu, amp=80, half=120)
    got = P.PerspectiveTransformer().transform_image_and_mask(
        image, mask, pixels_per_unit=ppu, full_image=full_image)
    ref = J.PerspectiveTransformer().transform_image_and_mask(
        image, mask, pixels_per_unit=ppu, full_image=full_image)
    assert_same(got, ref)
    assert got[1].any() and got[2]["pixels_per_unit"] == ppu


# -- planning --------------------------------------------------------------------


def _view(width=220, height=180, ppu=1):
    return {"pixels_per_unit": ppu, "view_bounds": (-40.0, -10.0, -40.0 + width / ppu,
                                                    -10.0 + height / ppu),
            "image_to_world_matrix": J.get_corrected_calibration()["transform_matrix"]}


@pytest.mark.parametrize("fast", [False, True], ids=["full", "fast"])
@pytest.mark.parametrize("seed", [0, 1])
def test_centerline_scans_are_bit_equal(fast, seed):
    mask = road_mask(220, 180, seed)
    view = _view()
    scan = "extract_centerline_fast" if fast else "extract_centerline"
    counts = []
    for kwargs in ({}, {"scan_from_bottom": False}, {"min_width": 58}):
        got = getattr(P.PathPlanner(view), scan)(mask, **kwargs)
        ref = getattr(J.PathPlanner(view), scan)(mask, **kwargs)
        assert_same(got, ref, f"{scan}{kwargs}")
        counts.append(len(got[0]))
    assert counts[0] == counts[1] > counts[2] > 0  # 58 px: only the band's widest rows


@pytest.mark.parametrize("fast_mode", [False, True], ids=["full", "fast"])
@pytest.mark.parametrize("method", ["polynomial", "spline"])
def test_plan_complete_path_is_bit_equal(method, fast_mode):
    mask = road_mask(220, 180, 3)
    for view in (_view(), {k: v for k, v in _view().items() if k != "image_to_world_matrix"}):
        for degree, force in ((3, True), (2, False), (1, True)):
            kw = dict(smooth_method=method, degree=degree, num_waypoints=17, min_width=10,
                      fast_mode=fast_mode, force_bottom_center=force)
            got = P.PathPlanner(view).plan_complete_path(mask, **kw)
            ref = J.PathPlanner(view).plan_complete_path(mask, **kw)
            assert_same(got, ref, f"plan {kw}")
            assert got["num_waypoints"] == 17
    empty = np.zeros_like(mask)
    assert_same(P.PathPlanner(_view()).plan_complete_path(empty, fast_mode=fast_mode),
                J.PathPlanner(_view()).plan_complete_path(empty, fast_mode=fast_mode))


@pytest.mark.parametrize("edge", [False, True], ids=["full", "edge"])
def test_create_control_map_and_path_json_are_bit_equal(edge, tmp_path):
    image = camera_frame(seed=5)
    mask = road_mask(640, 360, 5, amp=60, half=110)
    _, bev_mask, view = J.PerspectiveTransformer().transform_image_and_mask(
        image, mask, pixels_per_unit=2)
    got = P.create_control_map(bev_mask, view, edge_computing=edge)
    ref = J.create_control_map(bev_mask, view, edge_computing=edge)
    assert_same(got, ref)
    assert got[1]["waypoints"] and (got[0][..., 1] == 255).any()
    assert_same(P.world_to_pixels(got[1]["waypoints"], view),
                J.world_to_pixels(ref[1]["waypoints"], view))
    assert_same(P.add_grid_to_control_map(got[0], view), J.add_grid_to_control_map(ref[0], view))
    P.save_path_data_json(got[1], tmp_path / "port.json")
    J.save_path_data_json(ref[1], tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


# -- pre/postprocessing ------------------------------------------------------------


@pytest.mark.parametrize("size", [(640, 360), (500, 300), (1280, 720)])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_preprocessing_is_bit_equal(size, dtype):
    image = camera_frame(*size, seed=size[0])
    got = P.preprocess_matched_resolution(image, dtype=dtype)
    assert got.shape == (1, 3, 360, 640) and got.dtype == dtype
    assert_same(got, J.preprocess_matched_resolution(image, dtype=dtype))


@pytest.mark.parametrize("size", [(640, 360), (500, 300), (777, 401)])
@pytest.mark.parametrize("classes", [2, 3])
def test_postprocessing_is_bit_equal(size, classes):
    logits = np.random.default_rng(classes).normal(size=(1, classes, 360, 640)).astype(np.float32)
    got = P.postprocess_matched_resolution(logits, *size)
    assert got.shape == size[::-1] and set(np.unique(got)) == {0, 255}
    assert_same(got, J.postprocess_matched_resolution(logits, *size))


@pytest.mark.parametrize("alpha", [0.5, 0.3])
def test_create_visualization_is_bit_equal(alpha):
    image = camera_frame(seed=7)
    mask = road_mask(640, 360, 7, amp=60, half=110)
    got = P.create_visualization(image, mask, alpha=alpha)
    assert_same(got, J.create_visualization(image, mask, alpha=alpha))
    assert not np.array_equal(got, image)


# -- control ---------------------------------------------------------------------------


def _paths(n=8):
    """Planned paths of a band whose world position sweeps from the car's
    left to its right, with their views."""
    car_x = JaxController()._get_car_position_world(_view())[0]
    out = []
    for i in range(n):
        view = _view()
        min_x = car_x - 110 + 8 * (i - n // 2)  # the band's center column is ~110
        view["view_bounds"] = (min_x,) + tuple(view["view_bounds"][1:])
        mask = road_mask(220, 180, i, amp=10)
        out.append((J.PathPlanner(view).plan_complete_path(mask, fast_mode=i % 2 == 0), view))
    return out


@pytest.mark.parametrize("smoothing", [True, False])
def test_controller_sequence_is_bit_equal(smoothing, tmp_path):
    paths = _paths()
    kw = dict(steering_gain=40.0, base_pwm=320, curvature_damping=0.2, preview_distance=25.0,
              ema_alpha=0.4, enable_smoothing=smoothing)
    port, jax = VisualLateralErrorController(**kw), JaxController(**kw)
    for i, (path, view) in enumerate(paths):
        if i == 3:  # a hot update mid-run, as the dashboard sends it
            for c in (port, jax):
                c.update_smoothing_params(ema_alpha=0.05, enable_smoothing=not smoothing)
                c.steering_gain = 55.0
        if i == 5:
            port.reset_ema_state()
            jax.reset_ema_state()
        v = view if i % 3 else {k: x for k, x in view.items() if k != "image_to_world_matrix"}
        got, ref = port.compute_wheel_pwm(path, v), jax.compute_wheel_pwm(path, v)
        assert_same(got, ref, f"frame {i}")
        assert port.ema_lateral_error == jax.ema_lateral_error
        cmap = np.zeros((180, 220, 3), np.uint8)
        assert port.generate_control_visualization(cmap, got, v) is cmap
        assert_same(port.generate_control_visualization(cmap, got, v),
                    jax.generate_control_visualization(cmap, ref, v))
    assert_same(port.control_history, jax.control_history)
    assert {r["turn_direction"] for r in port.control_history} >= {"left", "right"}
    assert_same(port._find_preview_point({"waypoints": []}, (0.0, 0.0)),
                jax._find_preview_point({"waypoints": []}, (0.0, 0.0)))
    port.save_control_data(got, tmp_path / "port.json")
    jax.save_control_data(ref, tmp_path / "jax.json")
    a, b = (json.loads((tmp_path / f).read_text()) for f in ("port.json", "jax.json"))
    a.pop("timestamp"), b.pop("timestamp")
    assert a == b
