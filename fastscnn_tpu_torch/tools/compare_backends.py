"""Numerical parity gate across serving backends.

Counterpart of ``fastscnn_tpu/tools/compare_backends.py`` (a port of the
reference's parity gate, reference:compare_pytorch_onnx.py:16-150, which
reported 0.38 % pixel mismatch between PyTorch and its ONNX export). It
runs the same images through

  1. the f32 engine (ground truth),
  2. the bf16 BN-folded serving engine,
  3. optionally an exported artifact: a ``.pt2`` program of
     ``export_model`` on the device (pair ``export``), or an emitted
     ``.onnx`` through onnxruntime or the numpy evaluator (pair ``onnx``;
     the reference's gate compares exactly its shipped ONNX artifact,
     reference:compare_pytorch_onnx.py:88-112),
  4. optionally any PyTorch module fed the same NCHW floats (the
     reference model with the same weights, say), its logits at ``[0]``,

and reports per-pair argmax-mask disagreement rates. The default gate is
the reference's published tolerance (0.5 %).

Usage::

    python -m fastscnn_tpu_torch.tools.compare_backends --dataset citys --aux \\
        --weights weights/fast_scnn_citys.pth --image-dir frames/ --height 1024 --width 2048
"""

from __future__ import annotations

import argparse
import os

import numpy as np

__all__ = ["compare_backends", "parse_args", "main"]


def compare_backends(
    model,
    params,
    state,
    images: np.ndarray,
    mean=None,
    std=None,
    export_path: str | None = None,
    torch_model=None,
    device=None,
):
    """Return {pair_name: mismatch_rate} over argmax masks of uint8 NHWC
    ``images``, the engines running ``model`` with the weights of the
    ``params``/``state`` trees (numpy arrays or tensors) on ``device``
    (None: the CUDA card). ``export_path``, when the file exists, is an
    artifact taking batches of ``images``' shape, run on ``device``.
    ``torch_model`` runs where its parameters lie."""
    import torch

    from fastscnn_tpu_torch.engine import E2EConfig, InferenceEngine
    from fastscnn_tpu_torch.engine.export import load_artifact
    from fastscnn_tpu_torch.models import from_jax_params

    model.load_state_dict(from_jax_params(params, state))
    results = {}
    masks = {}

    # 1. f32 ground truth
    f32 = InferenceEngine(
        model, device=device, config=E2EConfig(mean=mean, std=std, compute_dtype="float32")
    )
    masks["f32"] = f32.predict(images).cpu().numpy()
    del f32

    # 2. bf16 folded serving
    bf16 = InferenceEngine(
        model, device=device, config=E2EConfig(mean=mean, std=std, compute_dtype="bfloat16")
    )
    masks["bf16"] = bf16.predict(images).cpu().numpy()
    del bf16

    # 3. the exported artifact
    if export_path and os.path.isfile(export_path):
        out = load_artifact(export_path, device)(images)
        out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        name = "onnx" if export_path.endswith(".onnx") else "export"
        masks[name] = out.argmax(-1) if out.ndim == 4 else out

    # 4. any module with the same weights, NCHW floats in
    if torch_model is not None:
        x = images.astype(np.float32) / 255.0
        if mean is not None:
            x = (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
        where = next(iter(torch_model.parameters()), torch.empty(0)).device
        with torch.no_grad():
            logits = torch_model(torch.from_numpy(np.transpose(x, (0, 3, 1, 2))).to(where))[0]
        masks["torch"] = logits.argmax(1).cpu().numpy()

    ref = masks["f32"]
    for name, mask in masks.items():
        if name == "f32":
            continue
        results[f"f32_vs_{name}"] = float((mask != ref).mean())
    if "torch" in masks:
        results["torch_vs_bf16"] = float((masks["torch"] != masks["bf16"]).mean())
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Backend parity gate")
    parser.add_argument("--dataset", type=str, default="custom",
                        choices=["citys", "tusimple", "bdd100k", "custom"])
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--aux", action="store_true", default=False)
    parser.add_argument("--num-images", type=int, default=4)
    parser.add_argument("--height", type=int, default=360)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--image-dir", type=str, default=None,
                        help="real images instead of random (PNG, JPEG or BMP, resized to HxW)")
    parser.add_argument("--export-path", type=str, default=None,
                        help="an exported artifact (.pt2 or .onnx) of the same weights")
    parser.add_argument("--tolerance", type=float, default=0.005,
                        help="max allowed mismatch rate (reference published 0.38%%)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default: the CUDA card (raises without one)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from fastscnn_tpu_torch.data import image_io, pil_ops
    from fastscnn_tpu_torch.engine.infer import IMAGENET_MEAN, IMAGENET_STD
    from fastscnn_tpu_torch.models import (
        DATASET_NUM_CLASSES,
        FastSCNN,
        init_fast_scnn,
        to_param_trees,
    )
    from fastscnn_tpu_torch.utils.checkpoint import load_pth_checkpoint

    num_classes = DATASET_NUM_CLASSES[args.dataset]
    if args.weights and os.path.exists(args.weights):
        params, state = load_pth_checkpoint(args.weights, num_classes, aux=args.aux or None)
    else:
        print("warning: random init")
        params, state = to_param_trees(init_fast_scnn(
            num_classes, args.aux, generator=torch.Generator().manual_seed(0), device="cpu"))
    model = FastSCNN(num_classes=num_classes, aux="auxlayer" in params)

    if args.image_dir:
        files = sorted(os.listdir(args.image_dir))[: args.num_images]
        images = np.stack(
            [
                pil_ops.resize(  # Image.resize's default for RGB: bicubic
                    image_io.read_image(os.path.join(args.image_dir, f), convert="RGB"),
                    (args.width, args.height), "bicubic",
                )
                for f in files
            ]
        )
    else:
        rng = np.random.default_rng(0)
        images = rng.integers(
            0, 256, (args.num_images, args.height, args.width, 3), dtype=np.uint8
        )

    mean, std = (None, None) if args.dataset == "custom" else (IMAGENET_MEAN, IMAGENET_STD)
    results = compare_backends(
        model, params, state, images, mean=mean, std=std, export_path=args.export_path,
        device=args.device,
    )
    worst = 0.0
    for pair, rate in sorted(results.items()):
        print(f"{pair}: {rate * 100:.4f}% pixels differ")
        worst = max(worst, rate)
    if worst > args.tolerance:
        raise SystemExit(
            f"PARITY FAIL: worst mismatch {worst * 100:.3f}% > {args.tolerance * 100:.3f}%"
        )
    print(f"PARITY OK (worst {worst * 100:.4f}% <= {args.tolerance * 100:.3f}%)")
    return results


if __name__ == "__main__":
    main()
