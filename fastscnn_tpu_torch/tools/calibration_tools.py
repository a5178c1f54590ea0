"""Camera calibration tools: counterpart of ``fastscnn_tpu/tools/calibration_tools.py``.

Ports of the reference's calibration utilities
(reference:camera_calibration_tool.py, simple_camera_calibration.py,
calibrate_perspective.py, calibrate_bev.py, perspective_transform.py):

- ``calibrate_from_points``: 4 image points + marker dimensions →
  calibration dict (JSON-compatible with the built-in one)
- ``batch_bev``: warp a folder of images (and optional masks) to
  bird's-eye view with a given calibration
- the interactive 4-point picker (``pick``), which needs an OpenCV window
  and a display: not ported, it raises naming ROADMAP.md's "item 5, left
  out: display windows"

Over the port's ``perception/`` (the numpy BEV warp, no OpenCV); PNG and
JPEG images are read with ``data/image_io.py`` (a JPEG through the
port's codec) and the warps written as PNGs by ``image_io.write_png``
(no PIL).

Usage::

    python -m fastscnn_tpu_torch.tools.calibration_tools from-points \
        --points 260,87 378,87 410,217 231,221 --out calib.json
    python -m fastscnn_tpu_torch.tools.calibration_tools batch-bev \
        --input-dir imgs/ --output-dir bev/ [--calibration calib.json]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from fastscnn_tpu_torch.data import image_io
from fastscnn_tpu_torch.perception.calibration import perspective_transform_matrix
from fastscnn_tpu_torch.perception.transform import PerspectiveTransformer

__all__ = ["calibrate_from_points", "batch_bev"]


def calibrate_from_points(
    image_points,
    marker_width_cm: float = 21.0,
    marker_height_cm: float = 29.7,
    image_size=(640, 360),
) -> dict:
    """Build a calibration dict from 4 clicked corners of a flat marker
    (top-left, top-right, bottom-right, bottom-left) of known physical
    size — A4 paper by default, like the reference."""
    world_points = [
        (0.0, 0.0),
        (marker_width_cm, 0.0),
        (marker_width_cm, marker_height_cm),
        (0.0, marker_height_cm),
    ]
    transform = perspective_transform_matrix(image_points, world_points)
    inverse = perspective_transform_matrix(world_points, image_points)
    return {
        "image_size": list(image_size),
        "image_points": [list(map(float, p)) for p in image_points],
        "world_points": [list(p) for p in world_points],
        "transform_matrix": transform.tolist(),
        "inverse_transform_matrix": inverse.tolist(),
        "description": f"calibrated from {marker_width_cm}x{marker_height_cm} cm marker",
        "units": "centimeters",
    }


def batch_bev(
    input_dir: str,
    output_dir: str,
    calibration: dict | None = None,
    masks_dir: str | None = None,
    pixels_per_unit: int = 20,
) -> int:
    """Warp every image (and matching mask) in a folder to BEV
    (reference:perspective_transform.py). Returns processed count."""
    transformer = PerspectiveTransformer(calibration)
    os.makedirs(output_dir, exist_ok=True)
    n = 0
    for f in sorted(os.listdir(input_dir)):
        if not f.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        img = image_io.read_image(os.path.join(input_dir, f), "RGB")
        base = os.path.splitext(f)[0]
        mask = None
        if masks_dir:
            mpath = os.path.join(masks_dir, base + ".png")
            if os.path.exists(mpath):
                mask = image_io.read_image(mpath, "L")
        if mask is None:
            mask = np.zeros(img.shape[:2], np.uint8)
        bev_img, bev_mask, _ = transformer.transform_image_and_mask(
            img, mask, pixels_per_unit=pixels_per_unit
        )
        image_io.write_png(os.path.join(output_dir, base + "_bev.png"), bev_img)
        if masks_dir:
            image_io.write_png(os.path.join(output_dir, base + "_bev_mask.png"), bev_mask)
        n += 1
    return n


def _pick_points(image_path: str):
    raise NotImplementedError(
        "the 4-point picker needs an OpenCV window and a display, which the port does not use "
        "(ROADMAP.md, queue 1, item 5, left out: display windows); pass the points to "
        "from-points instead")


def main(argv=None):
    parser = argparse.ArgumentParser(description="calibration tools")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("from-points")
    p.add_argument("--points", nargs=4, required=True, metavar="X,Y")
    p.add_argument("--marker-width", type=float, default=21.0)
    p.add_argument("--marker-height", type=float, default=29.7)
    p.add_argument("--image-width", type=int, default=640)
    p.add_argument("--image-height", type=int, default=360)
    p.add_argument("--out", default="calibration.json")

    p = sub.add_parser("batch-bev")
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--masks-dir", default=None)
    p.add_argument("--calibration", default=None)
    p.add_argument("--pixels-per-unit", type=int, default=20)

    p = sub.add_parser("pick")
    p.add_argument("--image", required=True)
    p.add_argument("--out", default="calibration.json")
    p.add_argument("--marker-width", type=float, default=21.0)
    p.add_argument("--marker-height", type=float, default=29.7)

    args = parser.parse_args(argv)
    if args.cmd == "from-points":
        pts = [tuple(map(float, s.split(","))) for s in args.points]
        cal = calibrate_from_points(
            pts, args.marker_width, args.marker_height, (args.image_width, args.image_height)
        )
        with open(args.out, "w") as f:
            json.dump(cal, f, indent=2)
        print(f"wrote {args.out}")
    elif args.cmd == "batch-bev":
        cal = None
        if args.calibration:
            cal = json.load(open(args.calibration))
        n = batch_bev(args.input_dir, args.output_dir, cal, args.masks_dir, args.pixels_per_unit)
        print(f"warped {n} images")
    elif args.cmd == "pick":
        pts = _pick_points(args.image)
        if len(pts) != 4:
            raise SystemExit("need 4 points")
        # record the PICKED image's true size: the transformer rescales
        # by original_image_size, so writing the 640×360 default for a
        # 1280×720 frame would put every BEV mapping off by 2×
        picked_size = image_io.image_size(args.image)
        cal = calibrate_from_points(
            pts, args.marker_width, args.marker_height, image_size=picked_size
        )
        with open(args.out, "w") as f:
            json.dump(cal, f, indent=2)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
