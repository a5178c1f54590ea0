"""End-to-end serving A/B of the port: bf16 1×1 convs against the int8
kernels (``folded_pw_impl`` ∈ {'int8-a8' (kernel B7), 'int8-w8a8' (B8)}),
at the flagship shape, behind a mask-agreement report.

    python -m fastscnn_tpu_torch.tools.ab_int8_e2e [--hw 1024x2048]
        [--batches 64,128] [--impls conv,int8-a8,int8-w8a8] [--iters 20]
        [--trials 3] [--out FILE]

The port of the repo root's ``tools/ab_int8_e2e.py``, with the same flags
and JSON, plus ``--device`` (default: the CUDA card). Protocol:
``InferenceEngine.throughput_fn`` (one CUDA graph of ``--iters`` forwards,
each on an input the previous mask changed), the host clock around a
replay and the read-back of its checksum, median of ``--trials`` per batch
size. The int8 engines take their scales from ``calibrate_pw_scales`` on
two seeded uint8 batches through the bf16 engine's own preprocessing; the
report is each engine's mask agreement with the bf16 engine on a held-out
batch (int8 is a semantic change: an opt-in fast mode). Weights are random
from seed 0 with default BN statistics, whose mask is nearly one class, so
the agreement says little there; PERF.md §6 has it on trained weights.

Prints one JSON line ``{"hw", "iters", "trials", "num_classes", "results":
{impl: {"mask_agreement", "batches": {batch: {"fps", "ms_iter"} or
{"error"}}}}}`` (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch


def build_engine(model, device):
    from fastscnn_tpu_torch.engine import IMAGENET_MEAN, IMAGENET_STD, E2EConfig, InferenceEngine

    return InferenceEngine(model, device=device, config=E2EConfig(
        mean=IMAGENET_MEAN, std=IMAGENET_STD, compute_dtype="bfloat16",
        final_upsample="hybrid"))


def measure(engine, shape, iters, trials, rng) -> float:
    """Seconds a forward of ``throughput_fn(shape, iters)``."""
    x = torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8)).to(engine.device)
    fn = engine.throughput_fn(tuple(x.shape), iters=iters)
    int(fn(x))  # capture (on the card) and a first replay
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        int(fn(x))
        times.append((time.perf_counter() - t0) / iters)
    return statistics.median(times)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hw", default="1024x2048")
    p.add_argument("--batches", default="64,128")
    p.add_argument("--impls", default="conv,int8-a8,int8-w8a8")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--calib-batch", type=int, default=2)
    p.add_argument("--gate-batch", type=int, default=2)
    p.add_argument("--num-classes", type=int, default=19)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (raises without one)")
    args = p.parse_args(argv)

    from fastscnn_tpu_torch import resolve_device
    from fastscnn_tpu_torch.models import calibrate_pw_scales, init_fast_scnn, quantized_model

    device = resolve_device(args.device)
    h, w = (int(v) for v in args.hw.split("x"))
    batches = [int(b) for b in args.batches.split(",")]
    impls = args.impls.split(",")
    rng = np.random.default_rng(0)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}, {h}x{w}, impls {impls}", flush=True)

    model = init_fast_scnn(args.num_classes, generator=torch.Generator().manual_seed(0),
                           device=device)
    base = build_engine(model, device)
    # calibrated on seeded uint8 batches through the engine's own
    # preprocessing (what deployment inputs look like to the 1×1 sites)
    calib = [rng.integers(0, 256, size=(args.calib_batch, h, w, 3), dtype=np.uint8)
             for _ in range(2)]
    scales = calibrate_pw_scales(base.model, base.folded, calib, preprocess=base._preprocess)
    print(f"calibrated {len(scales)} pw sites", flush=True)

    gate_x = rng.integers(0, 256, size=(args.gate_batch, h, w, 3), dtype=np.uint8)
    gate_ref = base.predict(gate_x)

    results = {}
    for impl in impls:
        if impl == "conv":
            eng, agree = base, 1.0
        else:
            eng = build_engine(quantized_model(model, scales, impl), device)
            agree = float((eng.predict(gate_x) == gate_ref).float().mean())
        rows = {}
        for b in batches:
            try:
                dt = measure(eng, (b, h, w, 3), args.iters, args.trials, rng)
            except torch.OutOfMemoryError as e:
                print(f"  {impl} batch {b} failed: {e}", file=sys.stderr)
                rows[str(b)] = {"error": str(e)[:200]}
                continue
            rows[str(b)] = {"fps": round(b / dt, 1), "ms_iter": round(dt * 1e3, 3)}
            print(f"  {impl:10s} batch {b:4d}: {b / dt:8.1f} fps  mask-agree {agree:.4f}",
                  flush=True)
        results[impl] = {"mask_agreement": round(agree, 5), "batches": rows}

    out = {"hw": args.hw, "iters": args.iters, "trials": args.trials,
           "num_classes": args.num_classes, "results": results}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
