"""Accuracy study: the 'argmax-first' serving fast mode on TRAINED models.

Counterpart of ``fastscnn_tpu/tools/argmax_first_study.py``: the same
scenes, recipe, modes and report, on the port's train step and engine.

'argmax-first' (``engine/infer.py`` ``E2EConfig.final_upsample``)
argmaxes at the classifier's 1/8 resolution and nearest-expands — a
semantic change, opt in. This tool quantifies it on trained models,
against both of the plausible "exact" baselines:

- ``exact``        the shipping path: bilinear align_corners=True ×8
                   upsample of the logits at native input resolution,
                   then argmax ('hybrid' plan).
- ``argmax-first`` argmax at 1/8 res → nearest ×8.
- ``ref-deploy``   the reference's own deployed postprocess (19-class leg
                   only): the backbone at a fixed internal 1024×1024,
                   argmax at MODEL resolution, then a NEAREST resize of the
                   mask to the frame size. For the 640×360 lane pipeline
                   the model runs at the camera resolution, so ref-deploy
                   degenerates to ``exact`` and is omitted.

Two legs, mirroring the two shipping configurations:

1. ``citys19``: 19-class band scenes (the ``system_check`` distribution,
   emitted directly as train ids) — OHEM-CE + aux + class weights,
   SGD+momentum, poly LR, bf16, on 768² crops of 1024×2048 scenes, then
   masks compared at 1024×2048.
2. ``lane2``: 2-class curved-lane scenes (the mini-lane fixture
   distribution at camera resolution) — trained and compared at 360×640.

Metrics per mode: pixAcc / mIoU against ground truth, pixel agreement
with ``exact``, and for disagreeing pixels the Manhattan
distance-to-nearest-class-boundary histogram (boundary = class edge of
the exact mask).

The scenes and the batch, crop and flip draws are the JAX study's, bit
for bit. The initial weights (``init_fast_scnn`` from ``seed``) and the
dropout masks (a ``torch.Generator`` on the device seeded ``1000 + it``
for step ``it``, where JAX splits ``PRNGKey(1000 + it)``) come from
PyTorch's generators, so the trained weights are not JAX's.

Usage::

    python -m fastscnn_tpu_torch.tools.argmax_first_study --out study.json   # on the card
    python -m fastscnn_tpu_torch.tools.argmax_first_study --quick --device cpu  # logic smoke
"""

from __future__ import annotations

import argparse
import json

import numpy as np

__all__ = [
    "gen_citys19_scenes",
    "gen_lane2_scenes",
    "train_model",
    "confusion_scores",
    "boundary_distance_hist",
    "eval_modes",
    "main",
]

# The same 19-class band-scene distribution as tools/system_check.py
# generate_dataset, but emitted directly as train ids (-1 = ignore) at
# arbitrary resolution — the study needs scenes at 1024×2048.


def gen_citys19_scenes(n: int, height: int, width: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    # FIXED class→color mapping, independent of the scene seed: train and
    # val scenes must share it or eval is out-of-distribution
    palette = np.random.default_rng(0).integers(30, 226, (19, 3))
    images = np.empty((n, height, width, 3), np.uint8)
    labels = np.empty((n, height, width), np.int32)
    for i in range(n):
        img = np.zeros((height, width, 3), np.float64)
        lbl = np.zeros((height, width), np.int32)
        n_bands = rng.integers(3, 7)
        edges = np.sort(rng.choice(np.arange(8, height - 8), n_bands - 1, replace=False))
        edges = np.concatenate([[0], edges, [height]])
        classes = rng.choice(19, n_bands, replace=False)
        for b in range(n_bands):
            sl = slice(edges[b], edges[b + 1])
            img[sl] = palette[classes[b]]
            lbl[sl] = classes[b]
        img += rng.normal(0, 18, img.shape)
        for _ in range(2):  # ignore blobs
            y = rng.integers(0, height - 12)
            x = rng.integers(0, width - 12)
            lbl[y : y + 12, x : x + 12] = -1
        images[i] = np.clip(img, 0, 255).astype(np.uint8)
        labels[i] = lbl
    return images, labels


# The mini-lane distribution (tests/fixtures/gen_mini_lane.py) at camera
# resolution: dark noisy background + one bright curved band (class 1).


def gen_lane2_scenes(n: int, height: int, width: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    images = np.empty((n, height, width, 3), np.uint8)
    labels = np.empty((n, height, width), np.int32)
    ys = np.arange(height, dtype=np.float64)
    xs = np.arange(width, dtype=np.float64)
    for i in range(n):
        img = rng.integers(0, 90, (height, width, 3)).astype(np.uint8)
        c0 = rng.uniform(0.25, 0.75) * width
        tilt = rng.uniform(-0.3, 0.3) * width
        bend = rng.uniform(-0.4, 0.4) * width
        w_band = rng.uniform(0.17, 0.27) * width
        t = ys / height - 0.5
        center = c0 + tilt * t + bend * t * t
        band = np.abs(xs[None, :] - center[:, None]) < (w_band / 2.0)
        bright = rng.integers(170, 250, (height, width, 3)).astype(np.uint8)
        images[i] = np.where(band[..., None], bright, img)
        labels[i] = band.astype(np.int32)
    return images, labels


# ---------------------------------------------------------------------------
# training (the recipe core: the port's train step on in-memory scenes)


def train_model(
    num_classes: int,
    images: np.ndarray,
    labels: np.ndarray,
    steps: int,
    batch: int,
    crop: int | None,
    loss_type: str,
    lr: float,
    seed: int = 0,
    device=None,
):
    """Train ``FastSCNN(num_classes, aux=True)`` for ``steps`` bf16 steps
    on random batches of ``images``/``labels`` (random crops of ``crop``²
    when the scenes are larger, random horizontal flips). Returns
    ``(model, state, (mean, std))``: the model, the ``TrainState`` that
    holds the trained weights, and the normalisation it trained with.
    ``device=None`` means the CUDA card."""
    import torch

    from fastscnn_tpu_torch import resolve_device
    from fastscnn_tpu_torch.engine.infer import IMAGENET_MEAN, IMAGENET_STD
    from fastscnn_tpu_torch.losses import get_loss_fn
    from fastscnn_tpu_torch.models import init_fast_scnn
    from fastscnn_tpu_torch.parallel import create_train_state, make_optimizer, make_train_step
    from fastscnn_tpu_torch.utils import lr_schedule

    device = resolve_device(device)
    mean, std = (IMAGENET_MEAN, IMAGENET_STD) if num_classes > 2 else (None, None)
    model = init_fast_scnn(num_classes, aux=True, generator=torch.Generator().manual_seed(seed),
                           device="cpu")
    schedule = lr_schedule("poly", base_lr=lr, niters=steps, power=0.9)
    optimizer = make_optimizer("sgd", schedule)
    state = create_train_state(model, optimizer, device=device)
    loss_fn = get_loss_fn(loss_type, aux=True, num_classes=num_classes)
    step = make_train_step(model, loss_fn, optimizer, mean=mean, std=std, device=device)

    rng = np.random.default_rng(seed)
    n, h, w = labels.shape
    last = float("nan")
    for it in range(steps):
        idx = rng.integers(0, n, batch)
        if crop is not None and (h > crop or w > crop):
            ys = rng.integers(0, h - crop + 1, batch)
            xs = rng.integers(0, w - crop + 1, batch)
            xb = np.stack(
                [images[i, y : y + crop, x : x + crop] for i, y, x in zip(idx, ys, xs)]
            )
            tb = np.stack(
                [labels[i, y : y + crop, x : x + crop] for i, y, x in zip(idx, ys, xs)]
            )
        else:
            xb, tb = images[idx], labels[idx]
        flip = rng.random(batch) < 0.5
        xb = np.where(flip[:, None, None, None], xb[:, :, ::-1], xb)
        tb = np.where(flip[:, None, None], tb[:, :, ::-1], tb)
        dropout = torch.Generator(device=device).manual_seed(1000 + it)
        state, metrics = step(state, xb, tb, dropout)
        if it % max(1, steps // 10) == 0 or it == steps - 1:
            last = float(metrics["loss"])
            print(f"  step {it:4d}/{steps}  loss {last:.4f}")
    assert np.isfinite(last), "training diverged"
    return model, state, (mean, std)


# ---------------------------------------------------------------------------
# metrics


def confusion_scores(pred: np.ndarray, gt: np.ndarray, num_classes: int):
    """pixAcc + mIoU with the repo's CANONICAL metric definition
    (``utils/metric.py`` ``seg_scores_from_hist`` — IoU averaged over ALL
    classes, as eval.py's FINAL mIoU), plus the present-classes-only
    average as a secondary reading."""
    from fastscnn_tpu_torch.utils.metric import SegmentationMetric

    m = SegmentationMetric(num_classes)
    m.update(np.asarray(pred), np.asarray(gt))
    pix_acc, miou = m.get()
    iou = m.per_class_iou()
    gt_valid = np.asarray(gt)[np.asarray(gt) >= 0]
    present = np.zeros(num_classes, bool)
    present[np.unique(gt_valid.astype(np.int64))] = True
    return {
        "pixAcc": float(pix_acc),
        "mIoU": float(miou),
        "mIoU_present": float(iou[present].mean()) if present.any() else float("nan"),
    }


def boundary_distance_hist(exact: np.ndarray, other: np.ndarray, max_d: int = 16):
    """For pixels where ``other`` != ``exact``: histogram of Manhattan
    distance to the nearest class-boundary pixel of the exact mask
    (distance 0 = the disagreeing pixel is itself on a class edge)."""
    b = np.zeros(exact.shape, bool)
    d_h = exact[..., :-1, :] != exact[..., 1:, :]
    d_w = exact[..., :, :-1] != exact[..., :, 1:]
    b[..., :-1, :] |= d_h
    b[..., 1:, :] |= d_h
    b[..., :, :-1] |= d_w
    b[..., :, 1:] |= d_w
    remaining = exact != other
    n_disagree = int(remaining.sum())
    reached = b
    counts = []
    for _ in range(max_d + 1):
        counts.append(int((remaining & reached).sum()))
        remaining = remaining & ~reached
        if not remaining.any():
            break
        grown = reached.copy()
        grown[..., :-1, :] |= reached[..., 1:, :]
        grown[..., 1:, :] |= reached[..., :-1, :]
        grown[..., :, :-1] |= reached[..., :, 1:]
        grown[..., :, 1:] |= reached[..., :, :-1]
        reached = grown
    return {
        "n_disagree": n_disagree,
        "dist_counts": counts,  # index = Manhattan distance, 0-based
        "beyond": int(remaining.sum()),
        "frac_within_2": (
            float(sum(counts[:3]) / n_disagree) if n_disagree else 1.0
        ),
        "frac_within_4": (
            float(sum(counts[:5]) / n_disagree) if n_disagree else 1.0
        ),
    }


def eval_modes(model, state, norm, images, labels, num_classes, ref_deploy_internal,
               device=None):
    """Build the mask for each mode with the weights of ``state`` (a
    ``TrainState``) loaded into ``model``, and score it. ``device=None``
    means the CUDA card."""
    from fastscnn_tpu_torch.engine import E2EConfig, InferenceEngine
    from fastscnn_tpu_torch.models import from_jax_params

    mean, std = norm
    modes = {
        "exact": E2EConfig(mean=mean, std=std, compute_dtype="bfloat16"),
        "argmax-first": E2EConfig(
            mean=mean, std=std, compute_dtype="bfloat16",
            final_upsample="argmax-first",
        ),
    }
    if ref_deploy_internal is not None:
        modes["ref-deploy"] = E2EConfig(
            mean=mean, std=std, compute_dtype="bfloat16",
            internal_size=ref_deploy_internal,
        )
    model.load_state_dict(from_jax_params(state.params, state.model_state))
    masks = {}
    for name, cfg in modes.items():
        eng = InferenceEngine(model, device=device, config=cfg)
        masks[name] = eng.predict(images).cpu().numpy()
        print(f"  {name}: mask computed")
    out = {}
    for name, mask in masks.items():
        row = confusion_scores(mask, labels, num_classes)
        if name != "exact":
            row["agreement_vs_exact"] = float(np.mean(mask == masks["exact"]))
            row["boundary_hist_vs_exact"] = boundary_distance_hist(
                masks["exact"], mask
            )
        out[name] = row
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--legs", default="citys19,lane2")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--quick", action="store_true",
                    help="tiny shapes / few steps — logic smoke, not a result")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    report = {}
    legs = args.legs.split(",")

    if "citys19" in legs:
        print("== leg citys19: 19-class 1024×2048, full-recipe core ==")
        if args.quick:
            train_hw, val_hw, crop, steps, batch = (128, 256), (128, 256), 96, 8, 4
        else:
            train_hw, val_hw, crop, steps, batch = (
                (1024, 2048), (1024, 2048), 768, args.steps, 8,
            )
        tr_img, tr_lbl = gen_citys19_scenes(24, *train_hw, seed=0)
        va_img, va_lbl = gen_citys19_scenes(8, *val_hw, seed=100)
        model, state, norm = train_model(
            19, tr_img, tr_lbl, steps=steps, batch=batch, crop=crop,
            loss_type="ce", lr=0.05, device=device,
        )
        internal = (96, 96) if args.quick else (1024, 1024)
        report["citys19"] = eval_modes(
            model, state, norm, va_img, va_lbl, 19, ref_deploy_internal=internal,
            device=device,
        )

    if "lane2" in legs:
        print("== leg lane2: 2-class 360×640 (pipeline resolution) ==")
        if args.quick:
            hw, steps, batch = (64, 96), 8, 4
        else:
            hw, steps, batch = (360, 640), args.steps, 8
        tr_img, tr_lbl = gen_lane2_scenes(24, *hw, seed=7)
        va_img, va_lbl = gen_lane2_scenes(8, *hw, seed=107)
        model, state, norm = train_model(
            2, tr_img, tr_lbl, steps=steps, batch=batch, crop=None,
            loss_type="ce", lr=0.05, device=device,
        )
        # ref-deploy degenerates to exact at matched resolution (the lane
        # graph runs at the camera size) — omitted by design.
        report["lane2"] = eval_modes(
            model, state, norm, va_img, va_lbl, 2, ref_deploy_internal=None, device=device,
        )

    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
