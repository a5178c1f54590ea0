"""GT-vs-prediction validation tool: counterpart of
``fastscnn_tpu/tools/validate_predictions.py``.

Port of reference:validate_model_predictions.py:16-60: runs the model on
validation images with the training side's preprocessing (the dataset's
``val`` mode: resize to ``--base-size``, crop, normalize), compares the
masks with the ground truth, and writes a per-image report
(``validation_report.csv``: pixAcc and mIoU per image, then ``OVERALL``)
and side-by-side GT|pred|diff panels as PNGs (``data/image_io.write_png``;
no PIL on PNG datasets). On the card the eval step is a CUDA graph
(``make_eval_step(graph=True)``, as ``eval.py`` runs it); on the CPU it
runs eagerly.

Usage::

    python -m fastscnn_tpu_torch.tools.validate_predictions --dataset custom \\
        --data-root data/custom --weights weights/fast_scnn_custom.pth [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

__all__ = ["parse_args", "main"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="validate model predictions vs GT")
    parser.add_argument("--dataset", type=str, default="custom",
                        choices=["citys", "tusimple", "bdd100k", "custom"])
    parser.add_argument("--data-root", type=str, required=True)
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--aux", action="store_true", default=False)
    parser.add_argument("--base-size", type=int, default=1024)
    parser.add_argument("--crop-size", type=int, default=768)
    parser.add_argument("--max-images", type=int, default=20)
    parser.add_argument("--outdir", type=str, default="./validation_results")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default: the CUDA card (raises without one)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from fastscnn_tpu_torch import resolve_device
    from fastscnn_tpu_torch.data import get_segmentation_dataset, image_io
    from fastscnn_tpu_torch.engine.infer import IMAGENET_MEAN, IMAGENET_STD
    from fastscnn_tpu_torch.models import FastSCNN, init_fast_scnn, to_param_trees
    from fastscnn_tpu_torch.parallel import make_eval_step
    from fastscnn_tpu_torch.utils.checkpoint import load_pth_checkpoint
    from fastscnn_tpu_torch.utils.metric import SegmentationMetric
    from fastscnn_tpu_torch.utils.tree import tree_map

    device = resolve_device(args.device)
    dataset = get_segmentation_dataset(
        args.dataset,
        root=args.data_root,
        split="val",
        mode="val",
        base_size=args.base_size,
        crop_size=args.crop_size,
    )
    num_classes = dataset.num_class
    if args.weights and os.path.exists(args.weights):
        params, state = load_pth_checkpoint(args.weights, num_classes, aux=args.aux or None)
    else:
        print("warning: random init")
        params, state = to_param_trees(init_fast_scnn(
            num_classes, aux=args.aux, generator=torch.Generator().manual_seed(0), device="cpu"))
    params = tree_map(lambda t: t.to(device), params)
    state = tree_map(lambda t: t.to(device), state)
    model = FastSCNN(num_classes=num_classes, aux="auxlayer" in params)  # runs on the trees
    mean, std = (
        (IMAGENET_MEAN, IMAGENET_STD) if dataset.normalization == "imagenet" else (None, None)
    )
    eval_step = make_eval_step(model, num_classes, mean=mean, std=std, device=device,
                               graph=device.type == "cuda")

    os.makedirs(args.outdir, exist_ok=True)
    metric = SegmentationMetric(num_classes)
    lines = ["image,pix_acc,miou"]
    n = min(len(dataset), args.max_images)
    for i in range(n):
        img, gt = dataset[i]
        pred, _ = eval_step(params, state, img[None], gt[None].astype(np.int32))
        pred = pred.cpu().numpy()[0]
        per = SegmentationMetric(num_classes)
        per.update(pred, gt)
        pa, miou = per.get()
        metric.update(pred, gt)
        lines.append(f"{i},{pa:.4f},{miou:.4f}")

        # GT | pred | diff panel
        scale = 255 // max(num_classes - 1, 1)
        gt_vis = np.where(gt < 0, 0, gt * scale).astype(np.uint8)
        pred_vis = (pred * scale).astype(np.uint8)
        diff = np.where((gt >= 0) & (pred != gt), 255, 0).astype(np.uint8)
        panel = np.concatenate([gt_vis, pred_vis, diff], axis=1)
        image_io.write_png(os.path.join(args.outdir, f"val_{i}_panel.png"), panel)

    pa, miou = metric.get()
    lines.append(f"OVERALL,{pa:.4f},{miou:.4f}")
    report = os.path.join(args.outdir, "validation_report.csv")
    with open(report, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"overall: pixAcc {pa * 100:.2f}% mIoU {miou * 100:.2f}% -> {report}")
    return pa, miou


if __name__ == "__main__":
    main()
