"""Export CLI — port of reference:export_onnx_fixed.py's user surface.

Counterpart of ``fastscnn_tpu/export_model.py``. Builds the end-to-end
graph (on-graph preprocessing: resize to the internal resolution, /255
scaling, optional ImageNet normalize; the network on BN-folded weights;
softmax or argmax postprocessing resized back) and serializes it, then
smoke-tests the artifact and gates its agreement with the in-process
engine — the equivalent of the reference's export → onnxsim → ORT-test
flow (reference:export_onnx_fixed.py:260-443).

Formats: ``pt2`` (default; a ``torch.export`` program, the counterpart of
the JAX CLI's StableHLO artifact, ``engine/export.py``) and ``onnx`` (the
self-contained emitter, ``engine/onnx_native.py``, gated through
onnxruntime when installed, else the numpy evaluator). ``stablehlo`` is
JAX's own format, and ``tflite``/``savedmodel`` need tensorflow, which the
card's machine lacks: those three raise ``SystemExit`` naming why.

Usage::

    python -m fastscnn_tpu_torch.export_model --dataset custom \\
        --weights weights/fast_scnn_custom.pth \\
        --input-width 640 --input-height 360 --internal-size 1024 \\
        --output exports/fast_scnn_e2e.pt2
    python -m fastscnn_tpu_torch.export_model --device cpu --format onnx ...
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

__all__ = ["parse_args", "main"]

_NOT_PORTED = {
    "stablehlo": "StableHLO is the JAX package's own artifact format; the port's "
                 "counterpart is --format pt2 (a torch.export program)",
    "tflite": "TFLite export needs tensorflow, which the card's machine lacks "
              "(ROADMAP.md, queue 1, item 5 (b))",
    "savedmodel": "SavedModel export needs tensorflow, which the card's machine lacks "
                  "(ROADMAP.md, queue 1, item 5 (b))",
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Fast-SCNN E2E export (torch.export / ONNX)")
    parser.add_argument("--dataset", type=str, default="custom",
                        choices=["citys", "tusimple", "bdd100k", "custom"])
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--aux", action="store_true", default=False)
    parser.add_argument("--input-width", type=int, default=640)
    parser.add_argument("--input-height", type=int, default=360)
    parser.add_argument("--internal-size", type=int, default=1024,
                        help="square internal backbone resolution (0 = native)")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--softmax", action="store_true", default=True,
                        help="emit class probabilities (reference E2E default)")
    parser.add_argument("--argmax", dest="softmax", action="store_false",
                        help="emit argmax mask instead of probabilities")
    parser.add_argument("--normalize", action="store_true", default=False,
                        help="apply ImageNet mean/std (reference default: off for custom)")
    parser.add_argument("--dtype", type=str, default="bfloat16")
    parser.add_argument("--atc-compat", action="store_true", default=False,
                        help="reproduce the reference's deployed graph exactly "
                             "(pyramid grids 1/2/4/8, align_corners=False PPM) "
                             "instead of the faithful training architecture")
    parser.add_argument("--format", type=str, default="pt2",
                        choices=["pt2", "onnx", "stablehlo", "tflite", "savedmodel"],
                        help="pt2: a torch.export program (torch.export.load); onnx: the "
                             "reference's shipped deploy format, emitted self-contained (no "
                             "onnx package needed; reference:export_onnx_fixed.py:308-318); "
                             "stablehlo, tflite, savedmodel: not available in the port")
    parser.add_argument("--fp16", action="store_true", default=False,
                        help="tflite only: post-training float16 weight quantization")
    parser.add_argument("--int8", action="store_true", default=False,
                        help="tflite only: post-training int8 quantization")
    parser.add_argument("--calib-images", type=str, default=None,
                        help="directory of images for int8 calibration")
    parser.add_argument("--output", type=str, default=None,
                        help="artifact path (default exports/fast_scnn_e2e.<format ext>)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default: the CUDA card (raises without one)")
    return parser.parse_args(argv)


def _calibration_batches(images_dir, shape, rng, limit: int = 16):
    """int8 calibration batches: real PNG, JPEG or BMP images
    (``data/image_io.py``) resized to the export shape as ``Image.resize``
    does by default, bicubic (``data/pil_ops.py``), when a directory is
    given; synthetic frames otherwise."""
    batch, h, w, _ = shape
    if images_dir and os.path.isdir(images_dir):
        from fastscnn_tpu_torch.data import image_io, pil_ops

        names = sorted(
            f for f in os.listdir(images_dir)
            if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp"))
        )[: limit * batch]
        frames = [
            pil_ops.resize(image_io.read_image(os.path.join(images_dir, n), convert="RGB"),
                           (w, h), "bicubic")
            for n in names
        ]
        if frames:
            out = []
            for i in range(0, len(frames) - batch + 1, batch):
                out.append(np.stack(frames[i : i + batch]).astype(np.uint8))
            if out:
                print(f"int8 calibration: {len(out)} batches from {images_dir}")
                return out
    print("int8 calibration: synthetic frames (pass --calib-images for real data)")
    return [
        rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(8)
    ]


def _load_model(args, num_classes, device):
    import torch

    from fastscnn_tpu_torch.models import FastSCNN, from_jax_params, init_fast_scnn
    from fastscnn_tpu_torch.utils.checkpoint import load_pth_checkpoint

    if args.weights and os.path.exists(args.weights):
        params, state = load_pth_checkpoint(args.weights, num_classes, aux=args.aux or None)
        model = FastSCNN(num_classes, aux="auxlayer" in params)
        model.load_state_dict(from_jax_params(params, state))
        model = model.to(device).eval()
        print(f"loaded {args.weights}")
    else:
        print("warning: no weights provided/found, exporting random init")
        model = init_fast_scnn(num_classes, args.aux, generator=torch.Generator().manual_seed(0),
                               device=device)
    if args.atc_compat:
        model = model.with_options(ppm_sizes=(1, 2, 4, 8), ppm_align_corners=False)
    return model


def main(argv=None):
    args = parse_args(argv)
    if args.fp16 and args.int8:
        raise SystemExit("--fp16 and --int8 are mutually exclusive")
    if (args.fp16 or args.int8) and args.format != "tflite":
        raise SystemExit("--fp16/--int8 apply to --format tflite only")
    if args.calib_images and not args.int8:
        raise SystemExit("--calib-images only applies with --int8")
    if args.format in _NOT_PORTED:
        raise SystemExit(f"--format {args.format}: {_NOT_PORTED[args.format]}")

    from fastscnn_tpu_torch import resolve_device
    from fastscnn_tpu_torch.engine import E2EConfig, IMAGENET_MEAN, IMAGENET_STD, InferenceEngine
    from fastscnn_tpu_torch.models import DATASET_NUM_CLASSES

    if args.output is None:
        args.output = f"exports/fast_scnn_e2e.{args.format}"
    if args.format == "onnx" and args.dtype == "bfloat16":
        # edge runtimes execute f32; bf16 is an accelerator compute dtype
        print(f"note: {args.format} export computes in float32 (was {args.dtype})")
        args.dtype = "float32"

    device = resolve_device(args.device)
    num_classes = DATASET_NUM_CLASSES[args.dataset]
    model = _load_model(args, num_classes, device)
    internal = (args.internal_size, args.internal_size) if args.internal_size else None
    mean, std = (IMAGENET_MEAN, IMAGENET_STD) if args.normalize else (None, None)
    engine = InferenceEngine(
        model, device=device,
        config=E2EConfig(internal_size=internal, mean=mean, std=std, softmax=args.softmax,
                         compute_dtype=args.dtype),
    )
    shape = (args.batch, args.input_height, args.input_width, 3)
    fn = engine.predict_fn(shape)

    # forward-pass test before export (reference:export_onnx_fixed.py:260-307)
    rng = np.random.default_rng(0)
    test_in = rng.integers(0, 256, shape, dtype=np.uint8)
    ref_out = fn(test_in).cpu().numpy()
    print(f"forward test ok: output {ref_out.shape} {ref_out.dtype}")

    metadata = {
        "dataset": args.dataset,
        "num_classes": num_classes,
        "internal_size": args.internal_size,
        "softmax": args.softmax,
        "normalize": args.normalize,
        "compute_dtype": args.dtype,
        "atc_compat": args.atc_compat,
    }
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    if args.format == "pt2":
        from fastscnn_tpu_torch.engine.export import export_torch, load_exported

        path = export_torch(engine, shape, args.output, metadata=metadata)
        artifact = load_exported(path, device)
        loaded = lambda x: artifact(x).cpu().numpy()  # noqa: E731
    else:
        # Self-contained emission: the ModelProto is hand-encoded (no
        # onnx package needed), mirroring the reference's shipped artifact
        # (reference:export_onnx_fixed.py:308-318) but with EXACT adaptive
        # pooling at any resolution.
        from fastscnn_tpu_torch.engine.onnx_native import (
            OnnxArtifact,
            emit_fastscnn_onnx,
            folded_numpy,
        )

        emit_fastscnn_onnx(
            model, folded_numpy(model), (args.batch, 3, args.input_height, args.input_width),
            args.output, internal_size=internal, mean=mean, std=std,
            output="softmax" if args.softmax else "mask",
        )
        with open(args.output + ".json", "w") as f:
            json.dump(dict(metadata, format="onnx", opset=13), f, indent=2)
        path = args.output
        loaded = OnnxArtifact(path)
        print(f"artifact smoke test backend: {loaded.backend}")
    print(f"exported {path} ({os.path.getsize(path)} bytes, format {args.format})")

    # artifact smoke test (the ORT-test equivalent,
    # reference:export_onnx_fixed.py:382-443)
    out = np.asarray(loaded(test_in))
    if args.softmax:
        agree = float((out.argmax(-1) == ref_out.argmax(-1)).mean())
    else:
        agree = float((out == ref_out).mean())
    print(f"artifact parity vs in-process engine: {agree * 100:.3f}% pixels agree")
    # unquantized artifacts must be ~exact (the JAX CLI's gate)
    tol = 0.999
    if not agree > tol:
        # hard failure, not assert: python -O would strip an assert and
        # silently skip the tool's only accuracy gate
        raise SystemExit(
            f"exported artifact diverges from the engine: "
            f"{agree:.4f} pixel agreement <= required {tol}"
        )
    return path


if __name__ == "__main__":
    main()
