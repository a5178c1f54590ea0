#!/usr/bin/env python
"""Headline benchmark of the port: 1024×2048 bf16 inference throughput on
one card, end to end (uint8 input, normalisation on the card, BN-folded
weights, argmax mask).

    python -m fastscnn_tpu_torch.bench

The port of the repo root's ``bench.py``, over
``InferenceEngine.throughput_fn``: one captured CUDA graph runs
``BENCH_ITERS`` forwards back to back, each on an input that the previous
mask perturbed; a trial is the host clock around one replay and the
read-back of its checksum. Median of ``BENCH_TRIALS`` trials, best over
batch sizes. The same environment knobs as the root bench:
``BENCH_DW_IMPL`` (``folded_dw_impl``, default ``conv``),
``BENCH_UPSAMPLE`` (``final_upsample``, default ``hybrid``),
``BENCH_BATCHES`` (default ``64,96,128``), ``BENCH_ITERS`` (30) and
``BENCH_TRIALS`` (5). A batch that runs out of device memory prints to
stderr and the sweep goes on.

Prints ONE JSON line: ``{"metric", "value" (frames/s), "unit": "fps/card",
"batch", "dw_impl", "upsample", "device"}``. Left out against the root
bench: ``achieved_tflops``, ``mfu`` and ``hbm_gbps``, which come from
XLA's cost model and the TPU's peaks; ``vs_baseline``, a TPU target; and
``BENCH_PROFILE_DIR``, a TPU trace.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np
import torch

HEIGHT, WIDTH = 1024, 2048
NUM_CLASSES = 19


def run(device=None, size=(HEIGHT, WIDTH)) -> dict:
    """The sweep at ``size`` on ``device`` (None: the card); returns the
    JSON line's fields."""
    from fastscnn_tpu_torch import resolve_device
    from fastscnn_tpu_torch.engine import IMAGENET_MEAN, IMAGENET_STD, E2EConfig, InferenceEngine
    from fastscnn_tpu_torch.models import init_fast_scnn

    device = resolve_device(device)
    dw_impl = os.environ.get("BENCH_DW_IMPL", "conv")
    upsample = os.environ.get("BENCH_UPSAMPLE", "hybrid")
    model = init_fast_scnn(NUM_CLASSES, generator=torch.Generator().manual_seed(0),
                           device=device, folded_dw_impl=dw_impl)
    engine = InferenceEngine(model, device=device, config=E2EConfig(
        mean=IMAGENET_MEAN, std=IMAGENET_STD, compute_dtype="bfloat16", final_upsample=upsample))
    batches = [int(b) for b in os.environ.get("BENCH_BATCHES", "64,96,128").split(",")]
    iters = int(os.environ.get("BENCH_ITERS", "30"))
    trials = int(os.environ.get("BENCH_TRIALS", "5"))
    h, w = size
    best_fps, best_batch = 0.0, 0
    rng = np.random.default_rng(0)
    for batch in batches:
        x = torch.from_numpy(rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)).to(device)
        try:
            fn = engine.throughput_fn(tuple(x.shape), iters=iters)
            int(fn(x))  # capture (on the card) and one replay
            times = []
            for _ in range(trials):
                t0 = time.perf_counter()
                int(fn(x))  # the checksum's read-back waits for the replay
                times.append((time.perf_counter() - t0) / iters)
        except torch.OutOfMemoryError as e:
            print(f"batch {batch} failed: {e}", file=sys.stderr)
            continue
        dt = statistics.median(times)
        fps = batch / dt
        print(f"batch {batch}: {fps:.1f} fps ({1e3 * dt:.2f} ms/iter)", file=sys.stderr)
        if fps > best_fps:
            best_fps, best_batch = fps, batch
    return {
        "metric": f"cityscapes_{h}x{w}_bf16_e2e_inference_throughput",
        "value": round(best_fps, 1),
        "unit": "fps/card",
        "batch": best_batch,
        "dw_impl": dw_impl,
        "upsample": upsample,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def main():
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
