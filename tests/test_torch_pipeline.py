"""The port's control loop (``fastscnn_tpu_torch/pipeline.py``,
``interfaces``, ``control_dashboard``, the demos) against the JAX
package's, on the CPU.

- ``inference_single_image`` of both packages, driven by one shared fake
  session (the JAX tests' ``FakeRoadSession`` on the ``.infer`` seam, and a
  ``.predict`` fake for the engine path): every output bit-equal — mask,
  visualization, BEV image and mask, ``view_params``, control map,
  ``path_data``, ``control_result``, the perf stages — and the written
  artifacts under the JAX names, the JPEGs byte for byte, the mask as
  pixels, the JSON as values;
- the two real engines at 360×640 in f32 from one ``from_jax_params``
  conversion: masks equal on ≥ 99.9 % of pixels;
- ``RealtimePipeline`` with a fake transport: the commands of both
  packages' loops equal frame for frame, the e-stop, camera failures and
  the no-path stop;
- ``DashboardServer``'s routes against the JAX dashboard's payloads, the
  ``/video_feed`` parts JPEG in the JAX encoder's bytes;
- ``control_dashboard.main`` (``--input``, and ``--realtime --web
  --synthetic-camera --max-frames`` with its routes driven over HTTP),
  ``pipeline.main`` and the two demos, with ``--cpu`` / ``--device cpu``;
  ``demo_tusimple`` of both packages on JPEG frames, their panels byte
  for byte.

The JAX modules run their branch without OpenCV, the only one the port
has (``cv2_absent``).
"""

import contextlib
import json
import os
import socket
import sys
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import fastscnn_tpu.interfaces as jax_interfaces
import fastscnn_tpu.perception.path_planning as jax_planning
import fastscnn_tpu.perception.preprocessing as jax_pre
import fastscnn_tpu.perception.transform as jax_transform
import fastscnn_tpu.pipeline as jax_pipeline
from fastscnn_tpu.engine import E2EConfig as JaxE2EConfig
from fastscnn_tpu.engine import InferenceEngine as JaxEngine
from fastscnn_tpu.models import FastSCNN as JaxFastSCNN
from fastscnn_tpu.models import init_fast_scnn as jax_init
from fastscnn_tpu.serialbridge import SimpleCarController as JaxCar
from fastscnn_tpu_torch import control_dashboard, demo, demo_tusimple, interfaces, pipeline
from fastscnn_tpu_torch.data import bmp, image_io, jpeg
from fastscnn_tpu_torch.engine import IMAGENET_MEAN, IMAGENET_STD, E2EConfig, InferenceEngine
from fastscnn_tpu_torch.models import FastSCNN, from_jax_params
from fastscnn_tpu_torch.perception import create_visualization
from fastscnn_tpu_torch.serialbridge import SimpleCarController
from tests.test_pipeline_interfaces import FakeRoadSession
from tests.test_torch_perception import assert_same

NUM_CLASSES = 2
_IMAGENET = (IMAGENET_MEAN, IMAGENET_STD)


@contextlib.contextmanager
def pil_blocked():
    """The card's machine has no PIL: the port's calls run without it."""
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        yield
    finally:
        sys.modules["PIL"] = saved


@pytest.fixture(autouse=True)
def cv2_absent(monkeypatch):
    for mod in (jax_transform, jax_pre, jax_planning):
        monkeypatch.setattr(mod, "_HAS_CV2", False)
    monkeypatch.setitem(sys.modules, "cv2", None)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FakePredictSession:
    """The engine path's seam: ``predict(rgb)`` → a class mask, a curvy
    band that depends on the frame's mean so that frames differ."""

    def predict(self, rgb):
        h, w = rgb.shape[:2]
        ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
        shift = float(rgb.mean()) / 4
        return (np.abs(xs - (w / 2 + shift + 50 * np.sin(ys / 70.0))) < 90).astype(np.uint8)


class BandSession:
    """``predict(rgb)``: the synthetic camera's road band (grey 60) as the
    drivable class, so that each frame's path follows its band."""

    def predict(self, rgb):
        return (rgb[..., 0] == 60).astype(np.uint8)


class NoRoadSession:
    def predict(self, rgb):
        return np.zeros(rgb.shape[:2], np.uint8)


def frame(width=640, height=360, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (height, width, 3), dtype=np.uint8)


def _same_run(got, ref, port_dir=None, jax_dir=None):
    """Every output of two ``inference_single_image`` results, and their
    artifacts."""
    assert set(got) == set(ref)
    for key in got:
        if key != "perf":
            assert_same(got[key], ref[key], key)
    assert got["perf"]._order == ref["perf"]._order
    if port_dir is None:
        return
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir)) == [
        "t_control_data.json", "t_control_map.jpg", "t_mask.png", "t_path_data.json",
        "t_vis.jpg"]
    read = image_io.read_image
    assert_same(read(os.path.join(port_dir, "t_mask.png")),
                read(os.path.join(jax_dir, "t_mask.png")))
    assert_same(read(os.path.join(port_dir, "t_mask.png")), ref["mask"])
    for name in ("t_vis.jpg", "t_control_map.jpg"):  # the JAX no-cv2 branch's PIL bytes
        with open(os.path.join(port_dir, name), "rb") as a, open(os.path.join(jax_dir, name),
                                                                 "rb") as b:
            assert a.read() == b.read(), name
    for name in ("t_path_data.json", "t_control_data.json"):
        a, b = (json.load(open(os.path.join(d, name))) for d in (port_dir, jax_dir))
        a.pop("timestamp", None), b.pop("timestamp", None)
        assert a == b, name


@pytest.mark.parametrize("seam,size,ppu,edge", [
    ("infer", (640, 360), 2, False), ("infer", (500, 300), 1, True),
    ("predict", (640, 360), 1, True), ("predict", (500, 300), 2, False),
])
def test_inference_single_image_is_bit_equal_on_a_shared_session(seam, size, ppu, edge,
                                                                    tmp_path):
    session = FakeRoadSession() if seam == "infer" else FakePredictSession()
    img = frame(*size, seed=size[0])
    kw = dict(pixels_per_unit=ppu, edge_computing=edge, basename="t")
    got = pipeline.inference_single_image(img, session, output_dir=str(tmp_path / "port"), **kw)
    ref = jax_pipeline.inference_single_image(img, session, output_dir=str(tmp_path / "jax"), **kw)
    _same_run(got, ref, tmp_path / "port", tmp_path / "jax")
    assert got["path_data"]["waypoints"] and got["control_result"]["pwm_left"] != 0
    assert got["perf"]._order == ["preprocess", "inference", "postprocess", "bird_eye_transform",
                                  "path_planning", "control", "save_artifacts"]


@pytest.mark.parametrize("options", [
    dict(bird_eye=False), dict(enable_control=False), dict(save_control_map=False),
    dict(path_smooth_method="spline", path_degree=2, num_waypoints=9, min_road_width=30,
         margin_ratio=0.2),
], ids=["no-bev", "no-control", "no-map", "spline"])
def test_inference_single_image_options_are_bit_equal(options):
    session = FakePredictSession()
    img = frame(seed=4)
    got = pipeline.inference_single_image(img, session, pixels_per_unit=1, **options)
    ref = jax_pipeline.inference_single_image(img, session, pixels_per_unit=1, **options)
    _same_run(got, ref)


def test_no_road_commands_the_no_path_stop():
    got = pipeline.inference_single_image(frame(), NoRoadSession(), pixels_per_unit=1,
                                          edge_computing=True)
    ref = jax_pipeline.inference_single_image(frame(), NoRoadSession(), pixels_per_unit=1,
                                              edge_computing=True)
    _same_run(got, ref)
    assert got["control_result"]["status"] == "no_path_stop"
    assert (got["control_result"]["pwm_left"], got["control_result"]["pwm_right"]) == (0, 0)


# -- the real engines ----------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """The JAX and the port's 2-class f32 engines on one set of weights
    (BN statistics moved off (0, 1) so that masks are not one class), each
    with uint8 masks as the pipeline builds them."""
    params, state = jax_init(jax.random.PRNGKey(2), NUM_CLASSES)
    rng = np.random.default_rng(2)

    def perturb(path, v):
        name = jax.tree_util.keystr(path)
        if "mean" in name:
            return jnp.asarray(rng.uniform(-0.05, 0.05, v.shape), v.dtype)
        if "var" in name:
            return jnp.asarray(rng.uniform(0.05, 0.2, v.shape), v.dtype)
        return v

    state = jax.tree_util.tree_map_with_path(perturb, state)
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                         jax.tree_util.tree_map(np.asarray, state))
    jeng = JaxEngine(JaxFastSCNN(NUM_CLASSES), params, state,
                     config=JaxE2EConfig(compute_dtype="float32", mask_dtype="uint8"))
    model = FastSCNN(NUM_CLASSES)
    model.load_state_dict(sd)
    peng = InferenceEngine(model, device="cpu",
                           config=E2EConfig(compute_dtype="float32", mask_dtype="uint8"))
    return jeng, peng, sd


def test_real_engines_agree_through_the_pipeline(engines):
    jeng, peng, _ = engines
    agree = []
    for seed in (0, 1):
        img = interfaces.SyntheticCamera().read()[1] if seed == 0 else frame(seed=seed)
        kw = dict(pixels_per_unit=1, edge_computing=True)
        got = pipeline.inference_single_image(img, peng, **kw)
        ref = jax_pipeline.inference_single_image(img, jeng, **kw)
        assert got["mask"].shape == (360, 640) and 0 < (got["mask"] > 0).mean() < 1
        agree.append((got["mask"] == ref["mask"]).mean())
        if agree[-1] == 1.0:
            for key in ("path_data", "control_result", "bird_eye_mask"):
                assert_same(got[key], ref[key], key)
    assert min(agree) >= 0.999, agree
    # the port engine's per-shape callable ran (eagerly on the CPU), not predict
    assert peng.predict_fn((1, 360, 640, 3)).replays == 2


# -- the realtime loop ------------------------------------------------------------


class Transport:
    def __init__(self):
        self.sent = []

    def send_speeds(self, left, right):
        self.sent.append((left, right))


_STATS = ("frame_count", "camera_failures", "driving_enabled", "emergency_stopped",
          "lateral_error", "pwm_left", "pwm_right", "turn_direction")


def _loop_trace(mod, car_cls, session, n_frames, fail_every=None, steps=None):
    car = car_cls(transport=Transport())
    car.command_timeout = 1e9  # no keepalive resend: what is sent depends on the frames alone
    pipe = mod.RealtimePipeline(session, mod.SyntheticCamera(n_frames=n_frames,
                                                             fail_every=fail_every),
                                car=car, edge_computing=True)
    pipe.start_driving()
    stats = []
    for i in range(steps or n_frames + 1):
        if i == 3:
            pipe.update_params({"steering_gain": 70, "ema_alpha": 0.2, "base_pwm": 280})
        if not pipe.step():
            break
        s = pipe.get_stats()
        stats.append({k: s[k] for k in _STATS})
        assert s["fps"] > 0
    return car.serial.sent, stats, pipe


def test_realtime_commands_equal_the_jax_loop():
    port = _loop_trace(interfaces, SimpleCarController, BandSession(), 6, fail_every=4)
    ref = _loop_trace(jax_interfaces, JaxCar, BandSession(), 6, fail_every=4)
    assert port[:2] == ref[:2]
    sent, stats, pipe = port
    assert len(sent) >= 4 and all(s != (0, 0) for s in sent)
    assert pipe.camera_failures == 1 and stats[-1]["frame_count"] == 5
    assert pipe.controller.steering_gain == 70.0 and pipe.controller.ema_alpha == 0.2
    assert all(np.array_equal(a.read()[1], b.read()[1]) for a, b in
               [(interfaces.SyntheticCamera(), jax_interfaces.SyntheticCamera())] * 3)


def test_realtime_emergency_stop_blocks_driving():
    car = SimpleCarController(transport=Transport())
    pipe = interfaces.RealtimePipeline(FakePredictSession(), interfaces.SyntheticCamera(n_frames=4),
                                       car=car, edge_computing=True)
    pipe.start_driving()
    pipe.step()
    assert car.serial.sent[-1] != (0, 0)
    pipe.emergency_stop()
    before = len(car.serial.sent)
    pipe.run(max_frames=3)
    assert car.serial.sent[before - 1] == (0, 0)
    assert all(s == (0, 0) for s in car.serial.sent[before:])
    assert pipe.get_stats()["emergency_stopped"] and not pipe.driving_enabled


def test_camera_failures_and_the_no_path_stop_keep_the_loop_alive():
    pipe = interfaces.RealtimePipeline(FakePredictSession(),
                                       interfaces.SyntheticCamera(n_frames=8, fail_every=3),
                                       edge_computing=True)
    pipe.run(max_frames=8)
    assert pipe.camera_failures >= 2 and pipe.frame_count >= 4
    car = SimpleCarController(transport=Transport())
    pipe = interfaces.RealtimePipeline(FakePredictSession(), interfaces.SyntheticCamera(n_frames=3),
                                       car=car, edge_computing=True)
    pipe.start_driving()
    pipe.step()
    pipe.session = NoRoadSession()  # the road disappears: the next command is a stop
    pipe.step()
    stats = pipe.get_stats()
    assert car.serial.sent[-1] == (0, 0) and stats["lateral_error"] is None
    assert stats["turn_direction"] == "straight"


def test_opencv_sources_raise_naming_the_roadmap():
    for cls, args in ((interfaces.realtime.OpenCVCamera, ()),
                      (interfaces.realtime.VideoFileCamera, ("drive.mp4",))):
        with pytest.raises(NotImplementedError, match="item 5, left out: cameras"):
            cls(*args)


# -- the dashboard ---------------------------------------------------------------------


def _get(base, path):
    with urllib.request.urlopen(f"{base}{path}", timeout=10) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _post(base, path, body=None):
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(body or {}).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, json.loads(r.read())


def _first_part(base):
    """The content-type line and body of the first part of ``/video_feed``
    (a part ends where the next one's boundary starts)."""
    with urllib.request.urlopen(f"{base}/video_feed", timeout=10) as r:
        assert r.headers["Content-Type"] == "multipart/x-mixed-replace; boundary=frame"
        assert r.readline() == b"--frame\r\n"
        ctype = r.readline().decode().strip()
        assert r.readline() == b"\r\n"
        buf = b""
        while b"\r\n--frame\r\n" not in buf:
            chunk = r.read1(65536)
            assert chunk, "the stream ended inside its first part"
            buf += chunk
        return ctype, buf[:buf.index(b"\r\n--frame\r\n")]


def _drive_routes(base, pipe):
    """Every route of one dashboard; returns what a comparison needs."""
    out = {}
    status, ctype, html = _get(base, "/")
    out["page"] = (status, ctype, "dashboard" in html.decode())
    for name in ("steering_gain", "base_pwm", "preview_distance", "curvature_damping",
                 "min_pwm", "max_pwm", "ema_alpha", "enable_smoothing"):
        assert f'id="{name}"' in html.decode()
    deadline = time.time() + 20
    while time.time() < deadline:
        stats = json.loads(_get(base, "/api/stats")[2])
        if stats.get("frame_count", 0) >= 2:
            break
        time.sleep(0.05)
    out["stats_keys"] = sorted(stats)
    out["system_keys"] = sorted(stats["system"])
    hot = {"steering_gain": 72.5, "base_pwm": 311.0, "preview_distance": 41.0,
           "curvature_damping": 0.23, "min_pwm": 55.0, "max_pwm": 890.0, "ema_alpha": 0.9,
           "enable_smoothing": False}
    out["update"] = _post(base, "/api/update_params", hot)
    deadline = time.time() + 20
    while time.time() < deadline and pipe.controller.steering_gain != 72.5:
        time.sleep(0.02)
    out["status_after_update"] = json.loads(_get(base, "/api/control_status")[2])
    out["start"] = _post(base, "/api/start_driving")
    assert pipe.driving_enabled
    out["stop"] = _post(base, "/api/emergency_stop")
    assert pipe.emergency_stopped and not pipe.driving_enabled
    out["status_after_stop"] = json.loads(_get(base, "/api/control_status")[2])
    out["connect"] = _post(base, "/api/connect_serial")
    try:
        _get(base, "/nowhere")
    except urllib.error.HTTPError as e:
        out["missing"] = (e.code, json.loads(e.read()))
    out["part"] = _first_part(base)
    return out


def test_dashboard_routes_match_the_jax_dashboard():
    results = []
    for mod in (interfaces, jax_interfaces):
        pipe = mod.RealtimePipeline(FakeRoadSession(), mod.SyntheticCamera(), edge_computing=True)
        server = mod.DashboardServer(pipe, host="127.0.0.1", port=0)
        base = f"http://127.0.0.1:{server.start()}"
        pipe.start_background(max_frames=400)
        try:
            results.append(_drive_routes(base, pipe))
        finally:
            pipe.stop()
            server.stop()
    port, ref = results
    port_part, ref_part = port.pop("part"), ref.pop("part")
    assert port == ref
    assert port["status_after_update"]["steering_gain"] == 72.5
    assert port["status_after_stop"]["emergency_stopped"] is True
    assert port_part[0] == ref_part[0] == "Content-Type: image/jpeg"
    img = image_io.decode_bytes(port_part[1])[0]
    assert img.ndim == 3 and img.shape[2] == 3 and (img[..., 1] > 200).any()  # the green map
    # the part's encoder gives the JAX encoder's PIL bytes on the same frames
    from fastscnn_tpu.interfaces import web_interface as jax_web
    from fastscnn_tpu_torch.interfaces import web_interface as port_web

    bgr = img[..., ::-1].copy()
    assert port_web._encode_jpeg(bgr) == jax_web._encode_jpeg(bgr)
    assert port_web._encode_jpeg(bgr[..., 1].copy()) == jax_web._encode_jpeg(bgr[..., 1].copy())
    assert port_web._encode_jpeg(None) is None


# -- the CLIs -------------------------------------------------------------------


def _png(path, img_bgr):
    image_io.write_png(path, img_bgr[..., ::-1])
    return str(path)


def test_pipeline_main_writes_every_artifact(tmp_path, capsys):
    png = _png(tmp_path / "road.png", interfaces.SyntheticCamera().read()[1])
    out = tmp_path / "out"
    result = pipeline.main(["--device", "cpu", "--input", png, "--output-dir", str(out),
                            "--pixels-per-unit", "2"])
    assert sorted(os.listdir(out)) == ["road_control_data.json", "road_control_map.jpg",
                                       "road_mask.png", "road_path_data.json", "road_vis.jpg"]
    assert_same(image_io.read_image(str(out / "road_mask.png")), result["mask"])
    for name, key in (("road_vis.jpg", "visualization"), ("road_control_map.jpg", "control_map")):
        jax_pipeline._imwrite(str(tmp_path / name), result[key])  # its no-cv2 branch: PIL
        assert (out / name).read_bytes() == (tmp_path / name).read_bytes(), name
    text = capsys.readouterr().out
    assert "warning: no --weights not found" in text and "single-image pipeline" in text
    # --export-path: a .pt2 and an .onnx of export_model (the frame resized
    # to the artifacts' 72x128 and the mask back), each to a wheel command
    from fastscnn_tpu_torch import export_model

    results = {}
    for fmt in ("pt2", "onnx"):
        art = str(tmp_path / f"m.{fmt}")
        export_model.main(["--device", "cpu", "--format", fmt, "--argmax", "--dtype", "float32",
                           "--input-height", "72", "--input-width", "128", "--internal-size",
                           "0", "--output", art])
        results[fmt] = pipeline.main(["--device", "cpu", "--input", png, "--export-path", art,
                                      "--output-dir", str(tmp_path / fmt),
                                      "--pixels-per-unit", "2"])
        assert isinstance(pipeline.build_session(pipeline.parse_args(
            ["--device", "cpu", "--input", png, "--export-path", art])), pipeline.ArtifactSession)
        assert results[fmt]["mask"].shape == result["mask"].shape
        assert results[fmt]["control_result"] is not None
        assert len(os.listdir(tmp_path / fmt)) == 5
    assert (results["pt2"]["mask"] == results["onnx"]["mask"]).mean() >= 0.999
    # item 10: a BMP frame is read without PIL (the PNG's mask); a broken
    # BMP raises naming the file; a GIF, a format no call site names, needs
    # PIL and raises naming the item without it
    bmp_path = tmp_path / "road.bmp"
    bmp_path.write_bytes(bmp.encode_bmp(image_io.read_image(png)))
    with pil_blocked():
        assert_same(pipeline.main(["--device", "cpu", "--input", str(bmp_path), "--output-dir",
                                   str(tmp_path / "bmp"), "--pixels-per-unit", "2"])["mask"],
                    result["mask"])
    (tmp_path / "x.bmp").write_bytes(b"BM neither a PNG nor a JPEG")
    with pytest.raises(ValueError, match="x.bmp.*BMP"):
        pipeline.main(["--device", "cpu", "--input", str(tmp_path / "x.bmp")])
    # a GIF frame is read without PIL too (its quantized pixels: the mask of
    # a PNG of them); a TGA, a format only PIL reads, raises naming the item
    Image.fromarray(image_io.read_image(png)).save(tmp_path / "x.gif")
    image_io.write_png(str(tmp_path / "gif.png"),
                       np.asarray(Image.open(tmp_path / "x.gif").convert("RGB")))
    with pil_blocked():
        assert_same(pipeline.main(["--device", "cpu", "--input", str(tmp_path / "x.gif"),
                                   "--output-dir", str(tmp_path / "gif"),
                                   "--pixels-per-unit", "2"])["mask"],
                    pipeline.main(["--device", "cpu", "--input", str(tmp_path / "gif.png"),
                                   "--output-dir", str(tmp_path / "gifpng"),
                                   "--pixels-per-unit", "2"])["mask"])
    Image.fromarray(image_io.read_image(png)).save(tmp_path / "x.tga")
    with pil_blocked(), pytest.raises(RuntimeError, match="x.tga.*item 10: formats only PIL reads"):
        pipeline.main(["--device", "cpu", "--input", str(tmp_path / "x.tga")])
    (tmp_path / "x.jpg").write_bytes(b"\xff\xd8\xff\xe0 a broken JPEG")
    with pytest.raises(ValueError, match="x.jpg.*item 10: formats only PIL reads"):
        pipeline.main(["--device", "cpu", "--input", str(tmp_path / "x.jpg")])


def test_pipeline_main_loads_weights(engines, tmp_path, capsys):
    _, peng, sd = engines
    torch.save(sd, tmp_path / "lane.pth")
    img = frame(seed=9)
    png = _png(tmp_path / "f.png", img)
    result = pipeline.main(["--device", "cpu", "--input", png, "--weights",
                            str(tmp_path / "lane.pth"), "--dtype", "float32", "--output-dir",
                            str(tmp_path / "out"), "--pixels-per-unit", "1", "--edge-computing"])
    assert f"loaded {tmp_path / 'lane.pth'}" in capsys.readouterr().out
    want = pipeline.inference_single_image(img, peng, pixels_per_unit=1, edge_computing=True)
    assert_same(result["mask"], want["mask"])


def _frame_file(tmp_path, kind, rgb):
    """``rgb`` as a 24-bit BMP (the port's writer, Pillow's bytes) or a
    16-bit RGB PNG (each sample ``v * 257 + 3``, which Pillow reads back as
    ``v``)."""
    from tests.test_torch_images import mf as make_fixtures

    path = tmp_path / ("frame.bmp" if kind == "bmp" else "frame16.png")
    path.write_bytes(bmp.encode_bmp(rgb) if kind == "bmp" else
                     make_fixtures.png_bytes(rgb.astype(np.uint16) * 257 + 3, 16, 2))
    return str(path)


@pytest.mark.parametrize("kind", ["bmp", "png16"])
def test_pipeline_main_reads_bmp_and_16bit_png_as_the_jax_pipeline(engines, tmp_path, kind):
    """The slice against the JAX package: ``pipeline.main --device cpu`` on
    a BMP frame and on a 16-bit PNG frame (read without PIL) and the JAX
    ``pipeline.main`` on the same files and weights (its no-OpenCV branch
    reads through Pillow): equal masks; every artifact byte for byte (the
    mask PNG in Pillow's row filters, the JPEGs, the path data), the
    control data as values but the wall-clock timestamp."""
    _, _, sd = engines
    torch.save(sd, tmp_path / "lane.pth")
    path = _frame_file(tmp_path, kind, np.ascontiguousarray(
        interfaces.SyntheticCamera().read()[1][..., ::-1]))
    args = ["--input", path, "--weights", str(tmp_path / "lane.pth"), "--dtype", "float32",
            "--pixels-per-unit", "1"]
    with pil_blocked():
        got = pipeline.main(["--device", "cpu", *args, "--output-dir", str(tmp_path / "port")])
    ref = jax_pipeline.main([*args, "--output-dir", str(tmp_path / "jax")])
    assert_same(got["mask"], ref["mask"])
    assert 0 < (got["mask"] > 0).mean() < 1
    base = os.path.splitext(os.path.basename(path))[0]
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == 5
    for name in names:
        mine, theirs = tmp_path / "port" / name, tmp_path / "jax" / name
        if name == f"{base}_control_data.json":
            a, b = json.loads(mine.read_text()), json.loads(theirs.read_text())
            a.pop("timestamp"), b.pop("timestamp")
            assert a == b
        else:
            assert mine.read_bytes() == theirs.read_bytes(), name


def test_control_dashboard_single_image(tmp_path):
    png = _png(tmp_path / "cam.png", frame(seed=3))
    result = control_dashboard.main(["--cpu", "--input", png, "--pixels-per-unit", "2",
                                     "--output-dir", str(tmp_path / "out")])
    assert result["mask"].shape == (360, 640)
    assert (tmp_path / "out" / "cam_mask.png").exists()


def test_control_dashboard_runs_an_exported_artifact(tmp_path):
    """``control_dashboard --cpu --export-path <.pt2> --input <png>`` runs
    the port's exported artifact through ``pipeline.build_session``: the
    mask of ``pipeline.main`` on the same artifact and frame."""
    from fastscnn_tpu_torch import export_model

    art = str(tmp_path / "m.pt2")
    export_model.main(["--device", "cpu", "--format", "pt2", "--argmax", "--dtype", "float32",
                       "--input-height", "72", "--input-width", "128", "--internal-size", "0",
                       "--output", art])
    png = _png(tmp_path / "cam.png", frame(seed=4, width=256, height=144))
    flags = ["--input", png, "--export-path", art, "--pixels-per-unit", "2"]
    got = control_dashboard.main(["--cpu", *flags, "--output-dir", str(tmp_path / "dash")])
    ref = pipeline.main(["--device", "cpu", *flags, "--output-dir", str(tmp_path / "pipe")])
    assert got["mask"].shape == (144, 256)
    assert_same(got["mask"], ref["mask"])
    assert (tmp_path / "dash" / "cam_mask.png").exists()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_control_dashboard_realtime_web(monkeypatch):
    """``--realtime --web --synthetic-camera --max-frames``: the routes
    driven over HTTP while the loop runs (its camera holds frame 3 until
    the client is done, so every request meets a running loop)."""
    done = threading.Event()

    class HeldCamera(interfaces.SyntheticCamera):
        def read(self):
            if self.i == 2:
                done.wait(60)
            return super().read()

    monkeypatch.setattr(interfaces, "SyntheticCamera", HeldCamera)
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    seen = {}

    def client():
        try:
            deadline = time.time() + 60
            while time.time() < deadline:
                try:
                    stats = json.loads(_get(base, "/api/stats")[2])
                    if stats.get("frame_count", 0) >= 2:
                        break
                except OSError:
                    pass
                time.sleep(0.05)
            seen["stats"] = stats
            seen["status"] = json.loads(_get(base, "/api/control_status")[2])
            seen["update"] = _post(base, "/api/update_params", {"base_pwm": 250})
            seen["start"] = _post(base, "/api/start_driving")
            seen["stop"] = _post(base, "/api/emergency_stop")
            seen["part"] = _first_part(base)
        finally:
            done.set()

    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    pipe = control_dashboard.main(["--cpu", "--realtime", "--web", "--synthetic-camera",
                                   "--max-frames", "5", "--web-host", "127.0.0.1",
                                   "--web-port", str(port)])
    thread.join(30)
    assert not thread.is_alive()
    assert pipe.frame_count == 5 and seen["stats"]["device"] == {"platform": "cpu"}
    assert seen["status"]["base_pwm"] == 300 and pipe.controller.base_pwm == 250.0
    assert seen["start"] == (200, {"status": "ok", "driving": True})
    assert seen["stop"] == (200, {"status": "ok", "stopped": True})
    assert seen["part"][0] == "Content-Type: image/jpeg"
    assert image_io.decode_bytes(seen["part"][1])[0].shape[2] == 3
    with pytest.raises(NotImplementedError, match="item 5, left out: cameras"):
        control_dashboard.main(["--cpu", "--realtime", "--max-frames", "1"])


def test_demos_run_on_the_cpu(tmp_path, capsys):
    src = tmp_path / "in"
    src.mkdir()
    for i in range(2):
        _png(src / f"lane{i}.png", frame(160, 96, seed=i))
    out = demo.demo(["--cpu", "--dataset", "custom", "--input-pic", str(src / "lane0.png"),
                     "--outdir", str(tmp_path / "demo"), "--weights-folder", str(tmp_path)])
    indices, mode = image_io.decode(out)
    assert mode == "P" and indices.shape == (96, 160)
    outs = demo_tusimple.main(["--device", "cpu", "--input", str(src), "--outdir",
                               str(tmp_path / "lanes"), "--weights-folder", str(tmp_path)])
    assert [os.path.basename(p) for p in outs] == ["lane0_lane_demo.jpg", "lane1_lane_demo.jpg"]
    # the panel is the frame beside its overlay, in the bytes of Pillow's JPEG
    engine = demo.build_engine(2, str(tmp_path / "none.pth"), False, *_IMAGENET, "cpu")
    bgr = frame(160, 96, seed=1)
    mask = (engine.predict(bgr[..., ::-1].copy()).cpu().numpy() * 255).astype(np.uint8)
    panel = np.concatenate([bgr, create_visualization(bgr, mask, alpha=0.5)], axis=1)
    assert open(outs[1], "rb").read() == jpeg.encode_jpeg(panel[:, :, ::-1].copy())
    assert image_io.read_image(outs[1]).shape == (96, 320, 3)
    assert "lane coverage" in capsys.readouterr().out


class _FakeLaneEngine:
    """Both demos' engine seam: a lane band that follows the frame's mean."""

    def __init__(self, *args, tensor=False, **kwargs):
        self.tensor = tensor

    def predict(self, rgb):
        mask = FakePredictSession().predict(np.asarray(rgb))
        return torch.from_numpy(mask) if self.tensor else mask


def test_demo_tusimple_writes_the_jax_demos_jpeg_bytes(tmp_path, monkeypatch, capsys):
    """On JPEG frames (4:2:0, odd sizes) and one shared fake engine, the
    port's ``<name>_lane_demo.jpg`` files are the JAX demo's, byte for
    byte: the frames decoded to Pillow's pixels, the panels encoded to
    Pillow's bytes."""
    import fastscnn_tpu.demo_tusimple as jax_demo
    import fastscnn_tpu.engine as jax_engine_mod

    src = tmp_path / "in"
    src.mkdir()
    for i, (w, h) in enumerate([(161, 97), (128, 72)]):
        (src / f"road{i}.jpg").write_bytes(jpeg.encode_jpeg(frame(w, h, seed=10 + i), 90))
    monkeypatch.setattr(jax_engine_mod, "InferenceEngine", _FakeLaneEngine)
    monkeypatch.setattr(demo, "build_engine", lambda *a, **k: _FakeLaneEngine(tensor=True))
    ref = jax_demo.main(["--input", str(src), "--outdir", str(tmp_path / "jax"),
                         "--weights-folder", str(tmp_path)])
    outs = demo_tusimple.main(["--device", "cpu", "--input", str(src), "--outdir",
                               str(tmp_path / "port"), "--weights-folder", str(tmp_path)])
    assert [os.path.basename(p) for p in outs] == [os.path.basename(p) for p in ref] == [
        "road0_lane_demo.jpg", "road1_lane_demo.jpg"]
    for a, b in zip(outs, ref):
        assert open(a, "rb").read() == open(b, "rb").read(), a
