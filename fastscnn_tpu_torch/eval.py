"""Evaluation CLI on the port: counterpart of ``fastscnn_tpu/eval.py``.

Full-resolution (``testval``) evaluation with cumulative per-sample
pixAcc/mIoU prints and colour mask dumps to ``--outdir``, plus
``--device`` (default: the CUDA card). Images of any size are padded at
the right and bottom to the next multiple of ``--pad-multiple`` and
grouped by padded shape into batches of ``--batch-size`` (the pad is
masked out of the metric and of the dump). The metric's statistics come
out of the eval step per image. On the card the eval step is a CUDA
graph a padded shape, the counterpart of the JAX evaluator's jit a
bucket: a bucket's last partial batch is padded to ``--batch-size`` with
all-ignore rows, so each bucket is captured once; on the CPU the step
runs eagerly.

No PIL is needed on PNG, JPEG, BMP, GIF, TIFF or WebP datasets: ``val`` mode resizes and crops with
``data/pil_ops.py`` (PIL's operations in numpy, bit for bit), and each
dump is a palette PNG written by ``data/image_io.write_png`` (the bytes
PIL writes). ``--weights`` also takes the JAX package's ``.pth.npz``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

__all__ = ["parse_args", "Evaluator", "main"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Fast-SCNN evaluation on the PyTorch/CUDA port")
    parser.add_argument("--dataset", type=str, default="citys",
                        choices=["citys", "tusimple", "bdd100k", "custom"])
    parser.add_argument("--data-root", type=str, default=None)
    parser.add_argument("--weights", type=str, default=None,
                        help=".pth or .pth.npz checkpoint (defaults to "
                             "weights/fast_scnn_<dataset>.pth)")
    parser.add_argument("--save-folder", type=str, default="./weights")
    parser.add_argument("--outdir", type=str, default="./test_result")
    parser.add_argument("--aux", action="store_true", default=False)
    parser.add_argument("--base-size", type=int, default=1024)
    parser.add_argument("--crop-size", type=int, default=768)
    parser.add_argument("--mode", type=str, default="testval", choices=["testval", "val"])
    parser.add_argument("--pad-multiple", type=int, default=64)
    parser.add_argument("--batch-size", type=int, default=1,
                        help="images of one padded shape evaluated together")
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--per-class", action="store_true", default=False,
                        help="print per-class IoU (reference:utils/metric.py compute_score)")
    parser.add_argument("--dtype", type=str, default="float32",
                        help="compute dtype: float32 (parity) or bfloat16 (speed)")
    parser.add_argument("--no-dump", action="store_true", default=False,
                        help="skip the per-image colour PNG dumps (the metric-only protocol)")
    parser.add_argument("--decoded-cache", type=str, default=None,
                        help="decode-once image cache directory (data/decoded_cache.py)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default: the CUDA card (raises without one)")
    return parser.parse_args(argv)


_DEFAULT_ROOTS = {
    "citys": "./datasets/citys",
    "tusimple": "./manideep1108/tusimple/versions/5/TUSimple",
    "bdd100k": "./bdd100k",
    "custom": "./data/custom",
}

_CITYS_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
)


class Evaluator:
    """The evaluation of ``args`` (:func:`parse_args`). ``graph``: run the
    eval step as CUDA graphs; None (the CLI's only setting) means on the
    card, and the CPU runs it eagerly."""

    def __init__(self, args, graph: bool | None = None):
        import torch

        from fastscnn_tpu_torch import resolve_device
        from fastscnn_tpu_torch.data import decoded_cache, get_segmentation_dataset
        from fastscnn_tpu_torch.engine.infer import IMAGENET_MEAN, IMAGENET_STD
        from fastscnn_tpu_torch.models import FastSCNN, init_fast_scnn, to_param_trees
        from fastscnn_tpu_torch.parallel import make_eval_step
        from fastscnn_tpu_torch.utils.checkpoint import load_pth_checkpoint
        from fastscnn_tpu_torch.utils.metric import SegmentationMetric
        from fastscnn_tpu_torch.utils.tree import tree_map

        self.args = args
        self.device = resolve_device(args.device)
        self.graph = self.device.type == "cuda" if graph is None else graph
        if args.decoded_cache:
            decoded_cache.set_cache_dir(args.decoded_cache)
        root = args.data_root or _DEFAULT_ROOTS[args.dataset]
        self.dataset = get_segmentation_dataset(args.dataset, root=root, split="val",
                                                mode=args.mode, base_size=args.base_size,
                                                crop_size=args.crop_size)
        self.num_classes = self.dataset.num_class
        weights = args.weights or os.path.join(args.save_folder, f"fast_scnn_{args.dataset}.pth")
        if os.path.exists(weights):
            params, model_state = load_pth_checkpoint(weights, self.num_classes,
                                                      aux=args.aux or None)
            print(f"loaded {weights}")
        else:
            print(f"warning: {weights} not found, using random init")
            params, model_state = to_param_trees(init_fast_scnn(
                self.num_classes, aux=args.aux, generator=torch.Generator().manual_seed(0),
                device="cpu"))
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.model_state = tree_map(lambda t: t.to(self.device), model_state)
        self.model = FastSCNN(self.num_classes, aux="auxlayer" in params)  # runs on the trees
        mean, std = ((IMAGENET_MEAN, IMAGENET_STD) if self.dataset.normalization == "imagenet"
                     else (None, None))
        # uint8 masks back (a quarter of the device→host bytes) and the
        # metric's statistics per image out of the same step
        self.eval_step = make_eval_step(
            self.model, self.num_classes, compute_dtype=getattr(torch, args.dtype), mean=mean,
            std=std, per_sample_stats=True,
            pred_dtype=torch.uint8 if self.num_classes <= 255 else torch.int32,
            device=self.device, graph=self.graph)
        self.metric = SegmentationMetric(self.num_classes)

    def _pad(self, img: np.ndarray):
        m = self.args.pad_multiple
        h, w = img.shape[:2]
        ph = (h + m - 1) // m * m
        pw = (w + m - 1) // m * m
        if (ph, pw) == (h, w):
            return img, h, w
        out = np.zeros((ph, pw, 3), img.dtype)
        out[:h, :w] = img
        return out, h, w

    def eval(self):
        """Bucketed batches: samples grouped by padded shape, so a dataset of
        one size runs at the full batch size."""
        from fastscnn_tpu_torch.data import narrow_labels
        from fastscnn_tpu_torch.utils.visualize import get_color_pallete

        args = self.args
        os.makedirs(args.outdir, exist_ok=True)
        n = len(self.dataset)
        if args.max_images:
            n = min(n, args.max_images)
        bs = max(1, args.batch_size)
        self._done = 0

        def flush(shape, pending):
            """Run one padded batch and update the metric and the dumps."""
            chunk = pending[:bs]
            del pending[:len(chunk)]
            batch_imgs = np.zeros((bs, *shape), np.uint8)
            batch_tgts = np.full((bs, *shape[:2]), -1, np.int32)
            for row, (i, padded, mask, h, w) in enumerate(chunk):
                batch_imgs[row] = padded
                batch_tgts[row, :h, :w] = mask
            preds, stats = self.eval_step(self.params, self.model_state, batch_imgs,
                                          narrow_labels(batch_tgts))
            preds = preds.cpu().numpy()
            # rows past the chunk hold all-ignore targets and are not read
            correct, labeled, inter, union = (s.cpu().numpy() for s in stats)
            for row, (i, _, mask, h, w) in enumerate(chunk):
                self.metric.update_stats(correct[row], labeled[row], inter[row], union[row])
                self._done += 1
                pix_acc, miou = self.metric.get()
                print(f"sample {self._done}: pixAcc {pix_acc * 100:.3f}% mIoU {miou * 100:.3f}%")
                if not args.no_dump:
                    get_color_pallete(preds[row, :h, :w], args.dataset).save(
                        os.path.join(args.outdir, f"seg_{i}.png"))

        # per-shape accumulators (memory: O(bs × buckets))
        buckets: dict[tuple, list] = {}
        for i in range(n):
            img, mask = self.dataset[i]
            padded, h, w = self._pad(img)
            pending = buckets.setdefault(padded.shape, [])
            pending.append((i, padded, mask, h, w))
            if len(pending) >= bs:
                flush(padded.shape, pending)
        for shape, pending in buckets.items():
            while pending:
                flush(shape, pending)
        if self.graph:
            step = self.eval_step
            print(f"eval step: {len(step.graphs)} CUDA graph captures for {len(buckets)} "
                  f"padded shapes, {step.replays} replays, pool {step.pool_bytes} bytes")
        return self.metric.get()


def main(argv=None):
    args = parse_args(argv)
    evaluator = Evaluator(args)
    pix_acc, miou = evaluator.eval()
    if args.per_class:
        ious = evaluator.metric.per_class_iou()
        names = _CITYS_CLASSES if args.dataset == "citys" else [
            f"class_{i}" for i in range(len(ious))]
        for name, iou in zip(names, ious):
            print(f"  {name:<16s} IoU {iou * 100:6.2f}%")
    print(f"FINAL pixAcc {pix_acc * 100:.3f}% mIoU {miou * 100:.3f}%")
    return evaluator


if __name__ == "__main__":
    main()
