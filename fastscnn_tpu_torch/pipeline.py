"""Single-image perception → planning → control pipeline.

The port of ``fastscnn_tpu/pipeline.py``:

  read image → preprocess → infer (a session: the port's
  ``InferenceEngine``, an exported artifact (:class:`ArtifactSession`,
  ``--export-path``), or any object with ``.predict`` or ``.infer``) →
  postprocess to a 0/255 mask → bird's-eye view → control map + path
  planning → wheel-PWM control → save artifacts → per-stage perf report.

On an engine the frame goes through ``session.predict_fn((1, 360, 640,
3))``: on the card one captured CUDA graph of the whole of ``predict``,
replayed per frame (the counterpart of the per-shape executable that the
JAX engine's ``predict`` dispatches); on the CPU the same call, eager.
The ``inference`` stage ends with the mask on the host, so it includes
the wait for the device.

Images are read as PNG, JPEG or BMP without PIL (``data/image_io.py``,
the JPEG through the port's codec, ``data/jpeg.py``); the artifacts get the
JAX package's names and formats, ``_mask.png``, ``_vis.jpg`` and
``_control_map.jpg``, in the bytes its no-OpenCV branch writes through
PIL (Pillow's JPEG at its default quality, 75).

Usage::

    python -m fastscnn_tpu_torch.pipeline --input image.jpg \\
        --weights weights/fast_scnn_custom.pth --output-dir output/
    python -m fastscnn_tpu_torch.pipeline --device cpu --input image.jpg
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from fastscnn_tpu_torch.control import VisualLateralErrorController
from fastscnn_tpu_torch.data import image_io
from fastscnn_tpu_torch.perception import (
    PerspectiveTransformer,
    create_control_map,
    create_visualization,
    postprocess_matched_resolution,
    preprocess_matched_resolution,
    save_path_data_json,
)
from fastscnn_tpu_torch.perception.preprocessing import _resize
from fastscnn_tpu_torch.utils.profiling import PerfTimer

__all__ = ["inference_single_image", "build_session", "load_model", "read_image_rgb",
           "ArtifactSession", "parse_args", "main"]

FRAME_SIZE = (640, 360)  # (width, height) the engine path runs at


def load_model(num_classes: int, weights: str | None, aux: bool, device):
    """A ``FastSCNN`` on ``device``: from the ``.pth`` (or ``.pth.npz``) at
    ``weights`` when that file exists, else ``init_fast_scnn`` from seed 0,
    with a warning."""
    from fastscnn_tpu_torch.models import FastSCNN, from_jax_params, init_fast_scnn
    from fastscnn_tpu_torch.utils.checkpoint import load_pth_checkpoint

    if weights and os.path.exists(weights):
        params, state = load_pth_checkpoint(weights, num_classes, aux=aux or None)
        model = FastSCNN(num_classes, aux="auxlayer" in params)
        model.load_state_dict(from_jax_params(params, state))
        print(f"loaded {weights}")
        return model.to(device).eval()
    print(f"warning: {weights or 'no --weights'} not found, using random init weights")
    return init_fast_scnn(num_classes, aux, generator=torch.Generator().manual_seed(0),
                          device=device)


class ArtifactSession:
    """An exported artifact as the pipeline's session: a ``.pt2`` program
    (``engine/export.py``) on ``device`` (None: the CUDA card), or an
    ``.onnx`` graph through onnxruntime or the numpy evaluator
    (``engine/onnx_native.py``). ``predict(rgb)`` returns the class mask
    of one RGB frame: the artifact runs at its own input size (batch 1),
    the frame resized to it and the mask back (nearest); an artifact of
    probabilities is argmaxed."""

    def __init__(self, path: str, device=None):
        from fastscnn_tpu_torch.engine.export import load_artifact

        self.artifact = load_artifact(path, device)
        if self.artifact.shape[0] != 1 or self.artifact.shape[3] != 3:
            raise ValueError(f"{path}: the pipeline runs one RGB frame a call, the artifact "
                             f"takes {self.artifact.shape}")

    def predict(self, rgb: np.ndarray) -> np.ndarray:
        h, w = rgb.shape[:2]
        ah, aw = self.artifact.shape[1:3]
        frame = rgb if (h, w) == (ah, aw) else _resize(rgb, aw, ah)
        out = self.artifact(np.ascontiguousarray(frame)[None])
        if isinstance(out, torch.Tensor):
            out = out.cpu().numpy()
        mask = (out.argmax(-1) if out.ndim == 4 else out)[0].astype(np.uint8)
        return mask if (h, w) == (ah, aw) else _resize(mask, w, h, nearest=True)


def build_session(args):
    """The port's ``InferenceEngine`` from CLI args, on ``args.device``
    (None: the CUDA card), over :func:`load_model`'s weights; with
    ``--export-path``, the :class:`ArtifactSession` of that artifact."""
    if getattr(args, "export_path", None):
        return ArtifactSession(args.export_path, getattr(args, "device", None))
    from fastscnn_tpu_torch import resolve_device
    from fastscnn_tpu_torch.engine import E2EConfig, InferenceEngine
    from fastscnn_tpu_torch.models import DATASET_NUM_CLASSES

    device = resolve_device(getattr(args, "device", None))
    num_classes = DATASET_NUM_CLASSES[args.dataset]
    model = load_model(num_classes, args.weights, args.aux, device)
    internal = (args.internal_size, args.internal_size) if args.internal_size else None
    # uint8 masks: lossless for every supported dataset (≤255 classes) and
    # a quarter of the device→host mask bytes of each frame
    return InferenceEngine(
        model, device=device,
        config=E2EConfig(
            internal_size=internal, compute_dtype=args.dtype,
            mask_dtype="uint8" if num_classes <= 255 else "int32",
        ),
    )


def _predict_mask(session, rgb: np.ndarray) -> np.ndarray:
    """The class mask of one RGB frame, on the host: through the session's
    per-shape callable where it has one, else its ``predict``."""
    predict_fn = getattr(session, "predict_fn", None)
    if predict_fn is not None:
        out = predict_fn((1,) + rgb.shape)(rgb[None])[0]
    else:
        out = session.predict(rgb)
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy()
    return np.asarray(out)


def inference_single_image(
    img_bgr: np.ndarray,
    session,
    bird_eye: bool = True,
    save_control_map: bool = True,
    enable_control: bool = True,
    controller: VisualLateralErrorController | None = None,
    transformer: PerspectiveTransformer | None = None,
    pixels_per_unit: int = 20,
    margin_ratio: float = 0.1,
    path_smooth_method: str = "polynomial",
    path_degree: int = 3,
    num_waypoints: int = 20,
    min_road_width: int = 10,
    edge_computing: bool = False,
    output_dir: str | None = None,
    basename: str = "result",
    dtype=np.float32,
    device_mask: bool = True,
):
    """Run the full pipeline on one BGR image; returns a result dict."""
    timer = PerfTimer()
    result: dict = {"perf": timer}

    h, w = img_bgr.shape[:2]
    if device_mask and hasattr(session, "predict"):
        # Engine path: the argmax runs on the device inside the engine's
        # graph and the host receives the small class mask, not the
        # full-resolution float logits of the `.infer()` seam.
        with timer.stage("preprocess"):
            frame = img_bgr
            if (w, h) != FRAME_SIZE:
                frame = _resize(img_bgr, *FRAME_SIZE)
            rgb = np.ascontiguousarray(frame[:, :, ::-1])
        with timer.stage("inference"):
            cls_mask = _predict_mask(session, rgb)
        with timer.stage("postprocess"):
            mask = np.where(cls_mask > 0, 255, 0).astype(np.uint8)
            if (w, h) != FRAME_SIZE:
                mask = _resize(mask, w, h, nearest=True)
    else:
        with timer.stage("preprocess"):
            tensor = preprocess_matched_resolution(img_bgr, dtype=dtype)
        with timer.stage("inference"):
            logits = session.infer([tensor])[0]
        with timer.stage("postprocess"):
            mask = postprocess_matched_resolution(np.asarray(logits, np.float32), w, h)
    result["mask"] = mask
    result["visualization"] = create_visualization(img_bgr, mask)

    if bird_eye:
        with timer.stage("bird_eye_transform"):
            transformer = transformer or PerspectiveTransformer()
            bev_img, bev_mask, view_params = transformer.transform_image_and_mask(
                img_bgr, mask, pixels_per_unit=pixels_per_unit, margin_ratio=margin_ratio
            )
        result.update(bird_eye_image=bev_img, bird_eye_mask=bev_mask, view_params=view_params)

        if save_control_map or enable_control:
            with timer.stage("path_planning"):
                control_map, path_data = create_control_map(
                    bev_mask,
                    view_params,
                    path_smooth_method=path_smooth_method,
                    path_degree=path_degree,
                    num_waypoints=num_waypoints,
                    min_road_width=min_road_width,
                    edge_computing=edge_computing,
                )
            result.update(control_map=control_map, path_data=path_data)

        if enable_control and result.get("path_data"):
            with timer.stage("control"):
                controller = controller or VisualLateralErrorController()
                if result["path_data"].get("waypoints"):
                    control_result = controller.compute_wheel_pwm(
                        result["path_data"], view_params
                    )
                else:
                    # No centerline found (occluded camera, off-road):
                    # commanding the controller would default lateral
                    # error to 0 and drive STRAIGHT AT FULL BASE PWM with
                    # no road in sight. Command a stop instead.
                    control_result = {
                        "pwm_left": 0,
                        "pwm_right": 0,
                        "lateral_error": None,
                        "steering": 0.0,
                        "turn_direction": "straight",
                        "status": "no_path_stop",
                    }
                result["control_result"] = control_result
                result["control_map"] = controller.generate_control_visualization(
                    result["control_map"], control_result, view_params
                )

    if output_dir:
        with timer.stage("save_artifacts"):
            os.makedirs(output_dir, exist_ok=True)
            _imwrite(os.path.join(output_dir, f"{basename}_mask.png"), mask)
            _imwrite(os.path.join(output_dir, f"{basename}_vis.jpg"), result["visualization"])
            if "control_map" in result:
                _imwrite(os.path.join(output_dir, f"{basename}_control_map.jpg"),
                         result["control_map"])
            if result.get("path_data"):
                save_path_data_json(
                    result["path_data"], os.path.join(output_dir, f"{basename}_path_data.json")
                )
            if result.get("control_result") and controller is not None:
                controller.save_control_data(
                    result["control_result"],
                    os.path.join(output_dir, f"{basename}_control_data.json"),
                )
    return result


def _imwrite(path, img):
    """A BGR (or greyscale) array as the JAX package's no-OpenCV branch
    writes it: channels flipped to RGB, then ``Image.save`` by extension
    (``image_io.save_image``: PNG, or Pillow's JPEG bytes)."""
    image_io.save_image(path, img[..., ::-1] if img.ndim == 3 else img)


def read_image_rgb(path: str) -> np.ndarray:
    """An image file as uint8 (H, W, 3) RGB, as ``np.asarray(
    Image.open(path).convert("RGB"))``: a PNG, JPEG or BMP through
    ``image_io`` without PIL (any format the JAX package's Pillow branch
    reads there); another format through PIL, which raises naming ROADMAP.md
    item 10 where it is not installed."""
    try:
        return image_io.read_image(path, convert="RGB")
    except OSError as e:
        raise SystemExit(f"cannot read {path}: {e}") from e


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Fast-SCNN perception pipeline (PyTorch/CUDA)")
    parser.add_argument("--input", type=str, required=True, help="a PNG, JPEG or BMP image")
    parser.add_argument("--dataset", type=str, default="custom")
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--export-path", type=str, default=None,
                        help="an exported artifact (.pt2 of export_model, or .onnx) to run "
                             "instead of the engine")
    parser.add_argument("--aux", action="store_true", default=False)
    parser.add_argument("--internal-size", type=int, default=0)
    parser.add_argument("--dtype", type=str, default="bfloat16")
    parser.add_argument("--bird-eye", action="store_true", default=True)
    parser.add_argument("--no-bird-eye", dest="bird_eye", action="store_false")
    parser.add_argument("--save-control-map", action="store_true", default=True)
    parser.add_argument("--no-save-control-map", dest="save_control_map",
                        action="store_false")
    parser.add_argument("--enable-control", action="store_true", default=True)
    parser.add_argument("--no-enable-control", dest="enable_control",
                        action="store_false")
    parser.add_argument("--edge-computing", action="store_true", default=False)
    parser.add_argument("--pixels-per-unit", type=int, default=20)
    parser.add_argument("--margin-ratio", type=float, default=0.1)
    parser.add_argument("--path-smooth-method", default="polynomial",
                        choices=["polynomial", "spline"])
    parser.add_argument("--path-degree", type=int, default=3)
    parser.add_argument("--num-waypoints", type=int, default=20)
    parser.add_argument("--min-road-width", type=int, default=10)
    parser.add_argument("--calibration", type=str, default=None,
                        help="external calibration JSON; default: the built-in corrected A4 "
                             "calibration")
    parser.add_argument("--output-dir", type=str, default="./output")
    parser.add_argument("--steering-gain", type=float, default=50.0)
    parser.add_argument("--base-pwm", type=float, default=300)
    parser.add_argument("--curvature-damping", type=float, default=0.1)
    parser.add_argument("--preview-distance", type=float, default=30.0)
    parser.add_argument("--ema-alpha", type=float, default=0.5)
    parser.add_argument("--disable-smoothing", action="store_true", default=False)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default: the CUDA card (raises without one)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    img = np.ascontiguousarray(read_image_rgb(args.input)[:, :, ::-1])

    session = build_session(args)
    transformer = None
    if args.calibration:
        import json as _json

        with open(args.calibration) as f:
            transformer = PerspectiveTransformer(_json.load(f))
    controller = VisualLateralErrorController(
        steering_gain=args.steering_gain,
        base_pwm=args.base_pwm,
        curvature_damping=args.curvature_damping,
        preview_distance=args.preview_distance,
        ema_alpha=args.ema_alpha,
        enable_smoothing=not args.disable_smoothing,
    )
    basename = os.path.splitext(os.path.basename(args.input))[0]
    result = inference_single_image(
        img,
        session,
        bird_eye=args.bird_eye,
        save_control_map=args.save_control_map,
        enable_control=args.enable_control,
        controller=controller,
        transformer=transformer,
        pixels_per_unit=args.pixels_per_unit,
        margin_ratio=args.margin_ratio,
        path_smooth_method=args.path_smooth_method,
        path_degree=args.path_degree,
        num_waypoints=args.num_waypoints,
        min_road_width=args.min_road_width,
        edge_computing=args.edge_computing,
        output_dir=args.output_dir,
        basename=basename,
    )
    result["perf"].print_performance_analysis("single-image pipeline")
    if result.get("control_result"):
        cr = result["control_result"]
        if cr.get("lateral_error") is None:  # no-path safety stop
            print("control: no centerline found -> STOP (pwm 0/0)")
        else:
            print(
                f"control: error {cr['lateral_error']:+.1f} cm -> "
                f"L {cr['pwm_left']:+.0f} R {cr['pwm_right']:+.0f} PWM "
                f"({cr['turn_direction']})"
            )
    return result


if __name__ == "__main__":
    main()
