"""Single-image demo CLI.

The port of ``fastscnn_tpu/demo.py``: a PNG, JPEG, BMP, GIF, TIFF or WebP image →
the port's inference engine → the class mask → a palette PNG (``utils/visualize.py``).

    python -m fastscnn_tpu_torch.demo --input-pic frame.jpg --dataset citys
    python -m fastscnn_tpu_torch.demo --cpu --input-pic frame.png
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Fast-SCNN demo (PyTorch/CUDA)")
    parser.add_argument("--model", type=str, default="fast_scnn")
    parser.add_argument("--dataset", type=str, default="citys",
                        choices=["citys", "tusimple", "bdd100k", "custom"])
    parser.add_argument("--weights-folder", default="./weights")
    parser.add_argument("--input-pic", type=str, required=True,
                        help="a PNG, JPEG, BMP, GIF, TIFF or WebP image")
    parser.add_argument("--outdir", default="./test_result")
    parser.add_argument("--aux", action="store_true", default=False)
    parser.add_argument("--cpu", action="store_true", default=False,
                        help="run on the CPU (default: the CUDA card, which raises without one)")
    return parser.parse_args(argv)


def build_engine(num_classes, weights, aux, mean, std, device):
    """The engine of both demos over ``pipeline.load_model``'s weights."""
    from fastscnn_tpu_torch import resolve_device
    from fastscnn_tpu_torch.engine import E2EConfig, InferenceEngine
    from fastscnn_tpu_torch.pipeline import load_model

    device = resolve_device(device)
    model = load_model(num_classes, weights, aux, device)
    return InferenceEngine(model, device=device, config=E2EConfig(mean=mean, std=std))


def demo(argv=None):
    args = parse_args(argv)
    from fastscnn_tpu_torch.engine import IMAGENET_MEAN, IMAGENET_STD
    from fastscnn_tpu_torch.models import DATASET_NUM_CLASSES
    from fastscnn_tpu_torch.pipeline import read_image_rgb
    from fastscnn_tpu_torch.utils.visualize import get_color_pallete

    mean, std = (IMAGENET_MEAN, IMAGENET_STD) if args.dataset != "custom" else (None, None)
    engine = build_engine(DATASET_NUM_CLASSES[args.dataset],
                          os.path.join(args.weights_folder, f"fast_scnn_{args.dataset}.pth"),
                          args.aux, mean, std, "cpu" if args.cpu else None)

    image = read_image_rgb(args.input_pic)
    pred = engine.predict(image).cpu().numpy()
    os.makedirs(args.outdir, exist_ok=True)
    outname = os.path.splitext(os.path.basename(args.input_pic))[0] + ".png"
    out_path = os.path.join(args.outdir, outname)
    get_color_pallete(pred, args.dataset).save(out_path)
    print(f"saved {out_path}")
    return out_path


if __name__ == "__main__":
    demo()
