"""TuSimple lane demo.

The port of ``fastscnn_tpu/demo_tusimple.py``: a PNG, JPEG, BMP, GIF, TIFF or
WebP image or a folder of them → binary lane mask → green overlay and a side-by-side
panel, written as ``<name>_lane_demo.jpg`` in the bytes the JAX demo's
``Image.save`` writes (the port's JPEG codec, no PIL); prints each
image's lane coverage.

    python -m fastscnn_tpu_torch.demo_tusimple --input frames/
    python -m fastscnn_tpu_torch.demo_tusimple --device cpu --input frame.jpg
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="TuSimple lane demo (PyTorch/CUDA)")
    parser.add_argument("--input", type=str, required=True,
                        help="a PNG, JPEG, BMP, GIF, TIFF or WebP image, or a folder")
    parser.add_argument("--weights-folder", default="./weights")
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--outdir", default="./test_result")
    parser.add_argument("--aux", action="store_true", default=False)
    parser.add_argument("--alpha", type=float, default=0.5)
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default: the CUDA card (raises without one)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from fastscnn_tpu_torch.data.image_io import save_image
    from fastscnn_tpu_torch.demo import build_engine
    from fastscnn_tpu_torch.engine import IMAGENET_MEAN, IMAGENET_STD
    from fastscnn_tpu_torch.perception import create_visualization
    from fastscnn_tpu_torch.pipeline import read_image_rgb

    weights = args.weights or os.path.join(args.weights_folder, "fast_scnn_tusimple.pth")
    engine = build_engine(2, weights, args.aux, IMAGENET_MEAN, IMAGENET_STD, args.device)

    if os.path.isdir(args.input):
        files = [
            os.path.join(args.input, f)
            for f in sorted(os.listdir(args.input))
            if f.lower().endswith((".jpg", ".jpeg", ".png"))
        ]
        if args.max_images:
            files = files[: args.max_images]
    else:
        files = [args.input]

    os.makedirs(args.outdir, exist_ok=True)
    outputs = []
    for path in files:
        rgb = read_image_rgb(path)
        pred = engine.predict(rgb).cpu().numpy()
        mask = (pred * 255).astype(np.uint8)
        bgr = rgb[:, :, ::-1].copy()
        overlay = create_visualization(bgr, mask, alpha=args.alpha)
        panel = np.concatenate([bgr, overlay], axis=1)
        base = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.outdir, f"{base}_lane_demo.jpg")
        save_image(out_path, panel[:, :, ::-1])
        coverage = 100.0 * (pred > 0).mean()
        print(f"{base}: lane coverage {coverage:.2f}% -> {out_path}")
        outputs.append(out_path)
    return outputs


if __name__ == "__main__":
    main()
