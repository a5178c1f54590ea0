"""End-to-end system check — one command that exercises the whole stack.

Counterpart of ``fastscnn_tpu/tools/system_check.py``'s six stages, on the
port: generates a synthetic 19-class dataset in Cityscapes format (a real
``leftImg8bit``/``gtFine_labelIds`` tree, so the Cityscapes loader and
the 34→19 remap run), trains Fast-SCNN through the port's ``Trainer``
(OHEM CE + class weights + aux, bf16; on the card's CUDA graphs), saves
a reference-dialect ``.pth``, evaluates pixAcc/mIoU through the port's
``Evaluator``, cross-checks the engine's f32 masks against the
checkpoint strict-loaded into the reference-layout module
(``FastSCNN.forward``, unfolded; not in ``--quick``), then exports the
19-class end-to-end graph (``engine/export.py``) and runs the perception
pipeline on the artifact.

The tree is the JAX one pixel for pixel (the same ``default_rng`` draws
in the same order), its PNGs written by
:func:`~fastscnn_tpu_torch.data.image_io.write_png` instead of PIL.

Usage::

    python -m fastscnn_tpu_torch.tools.system_check [--epochs 8] [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from fastscnn_tpu_torch.data.image_io import write_png

__all__ = ["generate_dataset", "main"]

#: the exported artifact's input: one 640x360 camera frame
EXPORT_SHAPE = (1, 360, 640, 3)

# The 19 valid Cityscapes labelIds (train ids 0..18).
_VALID = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33)


def generate_dataset(root: str, n_train=24, n_val=4, height=128, width=256, seed=0):
    """Synthetic scenes: horizontal bands of classes, each class with a
    distinctive (noisy) color — learnable but not trivial. Writes
    ``leftImg8bit/{train,val}/synth/*.png`` (RGB) and the matching
    ``gtFine_labelIds`` maps (greyscale) under ``root``; returns ``root``."""
    rng = np.random.default_rng(seed)
    palette = rng.integers(30, 226, (19, 3))
    for split, count in (("train", n_train), ("val", n_val)):
        img_dir = os.path.join(root, "leftImg8bit", split, "synth")
        lbl_dir = os.path.join(root, "gtFine", split, "synth")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(lbl_dir, exist_ok=True)
        for i in range(count):
            img = np.zeros((height, width, 3), np.float64)
            lbl = np.zeros((height, width), np.uint8)
            n_bands = rng.integers(3, 7)
            edges = np.sort(rng.choice(np.arange(8, height - 8), n_bands - 1, replace=False))
            edges = np.concatenate([[0], edges, [height]])
            classes = rng.choice(19, n_bands, replace=False)
            for b in range(n_bands):
                sl = slice(edges[b], edges[b + 1])
                img[sl] = palette[classes[b]]
                lbl[sl] = _VALID[classes[b]]
            img += rng.normal(0, 18, img.shape)
            # a few ignore blobs (labelId 0 = unlabeled → trainId -1)
            for _ in range(2):
                y = rng.integers(0, height - 12)
                x = rng.integers(0, width - 12)
                lbl[y : y + 12, x : x + 12] = 0
            write_png(os.path.join(img_dir, f"synth_{i:06d}_leftImg8bit.png"),
                      np.clip(img, 0, 255).astype(np.uint8))
            write_png(os.path.join(lbl_dir, f"synth_{i:06d}_gtFine_labelIds.png"), lbl)
    return root


def main(argv=None):
    parser = argparse.ArgumentParser(description="fastscnn end-to-end system check (PyTorch/CUDA)")
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--quick", action="store_true",
                        help="2 epochs, skip the reference-layout cross-check")
    parser.add_argument("--workdir", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default: the CUDA card (raises without one)")
    args = parser.parse_args(argv)
    if args.quick:
        args.epochs = 2

    import torch

    from fastscnn_tpu_torch import resolve_device

    device = resolve_device(args.device)
    dev_flag = [] if args.device is None else ["--device", args.device]
    # abspath before chdir: a relative --workdir would otherwise make the
    # just-built data_root resolve to workdir/workdir/citys
    workdir = os.path.abspath(args.workdir or tempfile.mkdtemp(prefix="fastscnn_syscheck_"))
    data_root = generate_dataset(os.path.join(workdir, "citys"))
    cwd = os.getcwd()
    os.chdir(workdir)  # the CLIs write logs/ under the working directory
    try:
        print(f"[1/6] synthetic 19-class Cityscapes-format dataset at {data_root}")
        print(f"      device: {device}"
              + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
        ok = _stages(args, workdir, data_root, dev_flag, device)
    finally:
        os.chdir(cwd)
    print("SYSTEM CHECK:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def _stages(args, workdir, data_root, dev_flag, device) -> bool:
    import torch

    from fastscnn_tpu_torch.train import Trainer, parse_args as train_args

    trainer = Trainer(train_args([
        "--dataset", "citys", "--data-root", data_root, "--base-size", "128",
        "--crop-size", "96", "--epochs", str(args.epochs), "--batch-size", "8", "--lr", "0.05",
        "--loss-type", "ce",  # OHEM + Cityscapes class weights
        "--aux", "--val-epoch", "1000", "--save-epoch", "1000", "--print-interval", "1000",
        "--num-workers", "2", *dev_flag]))
    print(f"[2/6] training {args.epochs} epochs (OHEM CE + aux, bf16)...")
    trainer.train()
    ckpt = trainer.save_checkpoint()
    print(f"      checkpoint: {ckpt}")

    from fastscnn_tpu_torch.eval import Evaluator, parse_args as eval_args

    evaluator = Evaluator(eval_args([
        "--dataset", "citys", "--data-root", data_root, "--weights", ckpt, "--mode", "testval",
        "--batch-size", "4", "--aux", "--outdir", os.path.join(workdir, "test_result"),
        *dev_flag]))
    pix_acc, miou = evaluator.eval()
    print(f"[3/6] eval: pixAcc {pix_acc * 100:.2f}% mIoU {miou * 100:.2f}%")
    # quick mode runs too few steps to converge; gate accuracy only on full runs
    ok = True if args.quick else pix_acc > 0.6
    if not ok:
        print("      WARNING: pixAcc below 60% — training did not converge as expected")

    from fastscnn_tpu_torch.engine import E2EConfig, IMAGENET_MEAN, IMAGENET_STD, InferenceEngine
    from fastscnn_tpu_torch.models import FastSCNN

    model = FastSCNN(19, aux=True)
    model.load_state_dict(torch.load(ckpt, map_location="cpu", weights_only=True))
    model = model.to(device).eval()
    cross = "skipped"
    if not args.quick:
        from fastscnn_tpu_torch.data import get_segmentation_dataset

        engine = InferenceEngine(model, device=device, config=E2EConfig(
            mean=IMAGENET_MEAN, std=IMAGENET_STD, compute_dtype="float32"))
        ds = get_segmentation_dataset("citys", root=data_root, split="val", mode="testval")
        mismatches = []
        for i in range(min(3, len(ds))):
            img, _ = ds[i]
            ours = engine.predict(img).cpu().numpy()
            x = ((img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
            with torch.no_grad():
                logits = model(torch.from_numpy(x.astype(np.float32)[None]).to(device))[0]
            theirs = logits.argmax(-1).cpu().numpy()[0]
            mismatches.append(float((ours != theirs).mean()))
        worst = max(mismatches)
        cross = f"worst mask mismatch {worst * 100:.3f}% (reference-layout module, unfolded)"
        ok = ok and worst < 0.005
    print(f"[4/6] reference-layout cross-check: {cross}")

    # export the E2E graph and run the perception pipeline on the artifact
    try:
        from fastscnn_tpu_torch.engine.export import export_torch
        from fastscnn_tpu_torch.pipeline import ArtifactSession, inference_single_image

        engine = InferenceEngine(model, device=device, config=E2EConfig(
            mean=IMAGENET_MEAN, std=IMAGENET_STD, compute_dtype="bfloat16"))
        path = export_torch(engine, EXPORT_SHAPE, os.path.join(workdir, "model.pt2"))
        session = ArtifactSession(path, device)
        print(f"[5/6] torch.export artifact ok ({os.path.getsize(path)} bytes)")
        frame = np.zeros(EXPORT_SHAPE[1:], np.uint8)
        frame[EXPORT_SHAPE[1] // 2:, :] = 120
        result = inference_single_image(
            frame, session, edge_computing=True, output_dir=os.path.join(workdir, "out"))
        cr = result.get("control_result")
        if cr is None or not -1000 <= cr["pwm_left"] <= 1000:
            raise AssertionError(f"no wheel command in range: {cr}")
        print(
            f"[6/6] perception pipeline on the exported artifact: "
            f"PWM L {cr['pwm_left']:+.0f} R {cr['pwm_right']:+.0f} ({cr['turn_direction']})"
        )
    except Exception as e:
        print(f"[5-6/6] export/pipeline stage FAILED: {type(e).__name__}: {e}")
        ok = False
    return ok


if __name__ == "__main__":
    raise SystemExit(main())
