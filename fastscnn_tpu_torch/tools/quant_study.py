"""Post-training int8 quantization ACCURACY study, on trained weights.

Counterpart of ``fastscnn_tpu/tools/quant_study.py``. Train a model on
the seed-generated synthetic 19-class Cityscapes-format set
(``tools/system_check.py``'s generator) through the trainer, then
simulate PTQ at the VALUE level:

- weights: symmetric int8 quant-dequant on every folded conv kernel,
  per-output-channel or per-tensor;
- activations: per-site per-tensor symmetric int8 quant-dequant at every
  conv INPUT via the model's ``act_fake_quant`` hook, with scales
  calibrated as the per-site max |x| over a calibration batch set (MinMax
  PTQ calibration).

Each variant reports, over the held-out val set: mask agreement with the
bf16 baseline, pixAcc/mIoU (against ground truth), and the mIoU delta.
The fake-quant graph computes in the same bf16 pipeline as serving, so
the delta isolates the int8 value grid. The mask head is kernel B2
(``w_matmul_h_lerp_argmax`` with ``use_kernel=True``).

Variants:
  w8-perchan     int8 weights, per-output-channel scales
  w8-pertensor   int8 weights, per-tensor scales
  w8a8           w8-perchan + int8 activations at every conv input
  w8a8-skip-ends w8a8 but first conv + heads stay bf16
                 (the usual deployment compromise)

Usage::

    python -m fastscnn_tpu_torch.tools.quant_study [--epochs 40] [--out study.json] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

__all__ = [
    "fake_quant_array",
    "quantize_folded_weights",
    "ActQuantHook",
    "calibrate_act_scales",
    "evaluate",
    "main",
]

# paths of the folded tree (fold_inference_params) whose kernels skip-ends
# keeps in the compute dtype: the stem conv and the two heads' last convs
_SKIP_END_PATHS = ("learning_to_downsample/conv", "classifier/conv", "auxlayer/conv2")


def fake_quant_array(w: np.ndarray, per_channel: bool) -> np.ndarray:
    """Symmetric int8 quant-dequant (the value grid an int8 kernel sees)."""
    w = np.asarray(w, np.float32)
    if per_channel:
        axes = tuple(range(w.ndim - 1))  # HWIO: scale per cout
        amax = np.max(np.abs(w), axis=axes, keepdims=True)
    else:
        amax = np.max(np.abs(w))
    scale = np.where(amax > 0, amax / 127.0, 1.0)
    return (np.clip(np.round(w / scale), -127, 127) * scale).astype(np.float32)


def quantize_folded_weights(folded, per_channel=True, skip_paths=()):
    """Quant-dequant every conv kernel 'w' leaf in a folded serving tree
    (each back in its dtype, on its device); biases stay float (deployed
    int8 kernels carry int32 biases at full scale, so their value grid is
    effectively exact)."""
    import torch

    def walk(tree, path):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                p = f"{path}/{k}" if path else k
                if k == "w" and not any(s in path for s in skip_paths):
                    q = fake_quant_array(v.detach().float().cpu().numpy(), per_channel)
                    out[k] = torch.from_numpy(q).to(device=v.device, dtype=v.dtype)
                else:
                    out[k] = walk(v, p)
            return out
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{path}[{i}]") for i, v in enumerate(tree))
        return tree

    return walk(folded, "")


class ActQuantHook:
    """``act_fake_quant`` hook; the call index within a forward identifies
    the site.

    calibrate=True: records each site's max|x| (an f32 scalar tensor) and
    input shape. calibrate=False: applies int8 quant-dequant with the
    calibrated scales (sites whose scale is None pass through). The JAX
    hook restarts its count when a function is traced; the port runs
    eagerly, so whoever runs a forward resets ``_idx`` (and, calibrating,
    ``maxima`` and ``site_shapes``) before each call."""

    def __init__(self, calibrate: bool, scales=None):
        self.calibrate = calibrate
        self.scales = scales
        self.maxima = []  # in site order
        self.site_shapes = []
        self._idx = 0

    def __call__(self, y, site=None):
        # `site` (the apply_folded conv-site label) is accepted for the
        # shared hook protocol; this study keys by call index instead.
        import torch

        i = self._idx
        self._idx += 1
        if self.calibrate:
            self.maxima.append(y.float().abs().amax())
            self.site_shapes.append(tuple(y.shape))
            return y
        s = self.scales[i]
        if s is None:
            return y
        q = torch.clamp(torch.round(y.float() / s), -127, 127)
        return (q * s).to(y.dtype)


def _preprocess(images, device, dtype=None):
    """uint8 NHWC → normalised on ``device``: cast, / 255, then
    (x − mean) / std, each rounded to ``dtype`` (None: bf16, the study's;
    the JAX study's order)."""
    import torch

    from fastscnn_tpu_torch.engine.infer import IMAGENET_MEAN, IMAGENET_STD

    dtype = dtype or torch.bfloat16
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device)
    std = torch.tensor(IMAGENET_STD, dtype=dtype, device=device)
    x = torch.as_tensor(images).to(device).to(dtype) / 255.0
    return (x - mean) / std


def _mask_fn(model, folded, act_hook=None):
    """uint8 NHWC (numpy or tensor) → full-resolution int32 mask on the
    folded tree's device, as the serving default does it (bf16, imagenet
    normalisation), the mask by kernel B2 (``w_matmul_h_lerp_argmax``,
    ``align_corners=True``). The hook is installed as the model's
    ``act_fake_quant`` option (``with_options``), and its site counter is
    reset on every call."""
    import torch

    from fastscnn_tpu_torch.ops.cuda.upsample_argmax import w_matmul_h_lerp_argmax
    from fastscnn_tpu_torch.utils.tree import tree_leaves

    qmodel = model.with_options(act_fake_quant=act_hook) if act_hook else model
    device = tree_leaves(folded)[0].device

    @torch.inference_mode()
    def fn(images):
        if act_hook is not None:
            act_hook._idx = 0
        x = _preprocess(images, device)
        logits = qmodel.apply_folded(folded, x, upsample_outputs=False)[0]
        return w_matmul_h_lerp_argmax(logits, x.shape[1:3], align_corners=True, use_kernel=True)

    return fn


def calibrate_act_scales(model, folded, images_u8):
    """Per-site max|conv input| over the calibration batches → scales.
    Returns ``(scales, site_shapes)``: a float per site (max / 127) in call
    order, and each site's input shape (of the last batch)."""
    import torch

    from fastscnn_tpu_torch.utils.tree import tree_leaves

    hook = ActQuantHook(calibrate=True)
    qmodel = model.with_options(act_fake_quant=hook)
    device = tree_leaves(folded)[0].device
    per_batch = []
    with torch.inference_mode():
        for b in images_u8:
            hook.maxima, hook.site_shapes, hook._idx = [], [], 0
            qmodel.apply_folded(folded, _preprocess(b, device), upsample_outputs=False)
            per_batch.append(torch.stack(hook.maxima).cpu().numpy())
    maxima = np.max(np.stack(per_batch), axis=0)
    return [float(m) / 127.0 for m in maxima], list(hook.site_shapes)


def evaluate(mask_fn, images, masks, nclass, batch=4):
    from fastscnn_tpu_torch.utils.metric import SegmentationMetric

    metric = SegmentationMetric(nclass)
    preds = []
    for i in range(0, len(images), batch):
        m = mask_fn(images[i : i + batch]).cpu().numpy()
        preds.append(m)
        metric.update(m, masks[i : i + batch])
    pixacc, miou = metric.get()
    return np.concatenate(preds), pixacc, miou, metric.per_class_iou()


def main(argv=None):
    p = argparse.ArgumentParser(description="int8 PTQ accuracy study")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--n-train", type=int, default=48)
    p.add_argument("--n-val", type=int, default=12)
    p.add_argument("--workdir", default=None)
    p.add_argument("--out", default=None, help="write the result table JSON here")
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (raises without one)")
    args = p.parse_args(argv)

    import torch

    from fastscnn_tpu_torch.data import get_segmentation_dataset
    from fastscnn_tpu_torch.models import FastSCNN, fold_inference_params, from_jax_params
    from fastscnn_tpu_torch.tools.system_check import generate_dataset
    from fastscnn_tpu_torch.train import Trainer
    from fastscnn_tpu_torch.train import parse_args as train_args

    workdir = args.workdir or tempfile.mkdtemp(prefix="quant_study_")
    root = os.path.join(workdir, "citys")
    generate_dataset(
        root, n_train=args.n_train, n_val=args.n_val,
        height=args.height, width=args.width, seed=3,
    )
    print(f"training {args.epochs} epochs on the synthetic 19-class set...", flush=True)
    trainer = Trainer(
        train_args(
            [
                "--dataset", "citys", "--data-root", root,
                "--base-size", str(args.height), "--crop-size", str(args.height),
                "--batch-size", "8", "--epochs", str(args.epochs),
                "--loss-type", "ce", "--aux", "--no-val",
                "--save-folder", os.path.join(workdir, "weights"),
                "--num-workers", "2", "--print-interval", "100000",
            ]
            + (["--device", args.device] if args.device else [])
        )
    )
    trainer.train()
    params, state = trainer.state.params, trainer.state.model_state

    # full-image val tensors (no crop: the generator emits one size)
    val = get_segmentation_dataset(
        "citys", root=root, split="val", mode="testval",
        base_size=args.height, crop_size=args.height,
    )
    images = np.stack([np.asarray(val[i][0]) for i in range(len(val))])
    masks = np.stack([np.asarray(val[i][1]) for i in range(len(val))])

    model = FastSCNN(num_classes=19, aux=True)
    model.load_state_dict(from_jax_params(params, state))
    folded = fold_inference_params(model.to(trainer.device), dtype=torch.bfloat16)

    base_fn = _mask_fn(model, folded)
    base_pred, base_pixacc, base_miou, base_iou = evaluate(base_fn, images, masks, 19)
    rows = [
        {
            "variant": "bf16-baseline",
            "mask_agreement": 1.0,
            "pixacc": base_pixacc,
            "miou": base_miou,
            "miou_delta": 0.0,
        }
    ]
    print(f"bf16 baseline: pixAcc {base_pixacc:.4f} mIoU {base_miou:.4f}", flush=True)

    # calibration on 2 batches of TRAIN images (never the val set)
    train_imgs = []
    tds = get_segmentation_dataset(
        "citys", root=root, split="train", mode="testval",
        base_size=args.height, crop_size=args.height,
    )
    for i in range(8):
        train_imgs.append(np.asarray(tds[i][0]))
    calib = [np.stack(train_imgs[:4]), np.stack(train_imgs[4:])]
    scales, shapes = calibrate_act_scales(model, folded, calib)
    print(f"calibrated {len(scales)} activation sites", flush=True)

    def add_variant(name, folded_v, act_scales):
        hook = ActQuantHook(calibrate=False, scales=act_scales) if act_scales else None
        fn = _mask_fn(model, folded_v, act_hook=hook)
        pred, pixacc, miou, _ = evaluate(fn, images, masks, 19)
        rows.append(
            {
                "variant": name,
                "mask_agreement": float((pred == base_pred).mean()),
                "pixacc": pixacc,
                "miou": miou,
                "miou_delta": miou - base_miou,
            }
        )
        print(
            f"{name}: agreement {rows[-1]['mask_agreement']:.4f} "
            f"pixAcc {pixacc:.4f} mIoU {miou:.4f} (Δ {miou - base_miou:+.4f})",
            flush=True,
        )

    w8_pc = quantize_folded_weights(folded, per_channel=True)
    add_variant("w8-perchan", w8_pc, None)
    add_variant(
        "w8-pertensor", quantize_folded_weights(folded, per_channel=False), None
    )
    add_variant("w8a8", w8_pc, scales)
    # skip-ends: first conv + heads stay bf16 (weights by path; acts by
    # site: site 0 is the stem conv input, the last two are the heads)
    skip_scales = list(scales)
    skip_scales[0] = None
    skip_scales[-1] = None
    skip_scales[-2] = None
    add_variant(
        "w8a8-skip-ends",
        quantize_folded_weights(folded, per_channel=True, skip_paths=_SKIP_END_PATHS),
        skip_scales,
    )

    result = {"rows": rows, "val_images": len(images), "epochs": args.epochs}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
