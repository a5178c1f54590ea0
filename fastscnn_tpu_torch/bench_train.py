#!/usr/bin/env python
"""Training-throughput benchmark of the port: the full train step
(forward, backward, BN statistics, optimizer) on synthetic batches.

    python -m fastscnn_tpu_torch.bench_train

The port of the repo root's ``bench_train.py``. There, ``iters`` steps run
inside one jitted ``fori_loop``; here the step is
``make_train_step(..., graph=True)``, captured once as a CUDA graph and
replayed ``iters`` times back to back with no sync between replays. A
window is the host clock around ``iters`` steps and the read-back of the
last loss; median of 3 windows, best over batch sizes. On the CPU (where
the caller asked for it) the step runs eagerly.

The root bench's environment knobs and defaults: ``BENCH_TRAIN_CROP``
(480), ``BENCH_TRAIN_BATCHES`` (``8,64,128``), ``BENCH_TRAIN_ITERS`` (20),
``BENCH_TRAIN_CLASSES`` (2), ``BENCH_TRAIN_LOSS`` (``dice``; the
Cityscapes recipe is ``CLASSES=19 LOSS=ce CROP=768 BATCHES=16``),
``BENCH_TRAIN_DEVICE_AUG`` (``1``: the chain inside the step, fed
native-resolution batches; ``2``: the split two-stage step, which also
prints the chain's own ms), ``BENCH_TRAIN_AUG_CHAIN`` (``psp``, ``custom``,
``custom-ms`` or ``original``, which trains at the source resolution),
``BENCH_TRAIN_NATIVE`` (``1``: the no-aug control at the source
resolution), ``BENCH_TRAIN_SRC`` (``1024x2048``), ``BENCH_TRAIN_BASE``
(1024), ``BENCH_TRAIN_SIZE`` (``HxW``: a non-square crop-fed size),
``BENCH_TRAIN_OPT`` (``sgd`` or ``adamw``), ``BENCH_TRAIN_STEM`` (``xla``;
``pallas`` runs kernel B6) and ``BENCH_TRAIN_GRAD_ACCUM`` (1). A batch
that fails (out of memory) prints to stderr and the sweep goes on.

Prints ONE JSON line: ``{"metric", "value" (samples/s), "unit", "batch",
"stem_impl", "grad_accum", "graph", "device"}``, the metric named as the
root bench names it. Left out against the root bench: ``vs_baseline``
(the reference's dev-GPU figure names no card) and ``BENCH_PROFILE_DIR``
(a TPU trace).
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import sys
import time

import numpy as np
import torch


def knobs(env=os.environ) -> dict:
    """The root bench's environment knobs, with its defaults."""
    devaug = env.get("BENCH_TRAIN_DEVICE_AUG", "")
    crop = int(env.get("BENCH_TRAIN_CROP", "480"))
    size = env.get("BENCH_TRAIN_SIZE", "")
    train_h, train_w = (int(v) for v in size.split("x")) if size else (crop, crop)
    src_h, src_w = (int(v) for v in env.get("BENCH_TRAIN_SRC", "1024x2048").split("x"))
    return {
        "crop": crop,
        "batches": [int(b) for b in env.get("BENCH_TRAIN_BATCHES", "8,64,128").split(",")],
        "iters": int(env.get("BENCH_TRAIN_ITERS", "20")),
        "num_classes": int(env.get("BENCH_TRAIN_CLASSES", "2")),
        "loss_name": env.get("BENCH_TRAIN_LOSS", "dice"),
        "device_aug_on": devaug in ("1", "2"),
        "device_aug_split": devaug == "2",
        "aug_chain": env.get("BENCH_TRAIN_AUG_CHAIN", "psp"),
        "native_ctl": env.get("BENCH_TRAIN_NATIVE", "") == "1",
        "src_h": src_h,
        "src_w": src_w,
        "base_size": int(env.get("BENCH_TRAIN_BASE", "1024")),
        "train_h": train_h,
        "train_w": train_w,
        "opt_name": env.get("BENCH_TRAIN_OPT", "sgd"),
        "stem_impl": env.get("BENCH_TRAIN_STEM", "xla"),
        "grad_accum": int(env.get("BENCH_TRAIN_GRAD_ACCUM", "1")),
    }


def metric_name(k: dict) -> str:
    """The JSON line's ``metric``, as the root bench builds it
    (``bench_train.py:269-286``)."""
    at_src = (k["device_aug_on"] and k["aug_chain"] == "original") or k["native_ctl"]
    res = f"{k['src_h']}x{k['src_w']}" if at_src else f"{k['train_h']}x{k['train_w']}"
    if k["num_classes"] == 2:
        name = f"train_step_throughput_{res}_{k['loss_name']}_aux_bf16"
    else:
        name = f"train_step_throughput_{res}_{k['loss_name']}{k['num_classes']}_aux_bf16"
    if k["device_aug_on"]:
        name += ("_devaug" + ("_" + k["aug_chain"] if k["aug_chain"] != "psp" else "")
                 + ("_split" if k["device_aug_split"] else ""))
    elif k["native_ctl"]:
        name += "_native"
    return name + ("_" + k["opt_name"] if k["opt_name"] != "sgd" else "")


def _chain(k: dict):
    from fastscnn_tpu_torch.data import device_aug

    if not k["device_aug_on"]:
        return None
    if k["aug_chain"] == "original":
        return device_aug.make_device_augment_original(blur_p=0.3)
    if k["aug_chain"].startswith("custom"):
        return device_aug.make_device_augment_custom(crop_size=k["crop"],
                                                     multi_scale=k["aug_chain"] == "custom-ms")
    return device_aug.make_device_augment(base_size=k["base_size"], crop_size=k["crop"],
                                          pad_label=-1)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(device=None, env=os.environ) -> dict:
    """The sweep on ``device`` (None: the card) with the knobs of ``env``;
    returns the JSON line's fields."""
    from fastscnn_tpu_torch import resolve_device
    from fastscnn_tpu_torch.losses import get_loss_fn
    from fastscnn_tpu_torch.models import init_fast_scnn
    from fastscnn_tpu_torch.parallel import (
        create_train_state,
        make_optimizer,
        make_split_aug_train_step,
        make_train_step,
    )
    from fastscnn_tpu_torch.utils import lr_schedule

    device = resolve_device(device)
    graph = device.type == "cuda"
    k = knobs(env)
    nc, aug = k["num_classes"], _chain(k)
    schedule = lr_schedule("poly", base_lr=1e-3 if k["opt_name"] == "adamw" else 1e-2,
                           niters=10000, power=0.9)
    optimizer = make_optimizer(k["opt_name"], schedule)
    loss_fn = get_loss_fn(k["loss_name"], aux=True, num_classes=nc)
    if k["device_aug_on"] or k["native_ctl"]:
        in_h, in_w = k["src_h"], k["src_w"]
    else:
        in_h, in_w = k["train_h"], k["train_w"]
    # native-resolution labels travel as int8 where they fit, as the trainer's
    tgt_dtype = np.int8 if k["device_aug_on"] and nc <= 127 else np.int32
    step_kw = dict(mean=None, std=None, compute_dtype=torch.bfloat16,
                   grad_accum=k["grad_accum"], device=device, graph=graph)
    best_sps, best_batch = 0.0, 0
    rng = np.random.default_rng(0)
    for batch in k["batches"]:
        images = torch.from_numpy(
            rng.integers(0, 256, (batch, in_h, in_w, 3), dtype=np.uint8)).to(device)
        targets = torch.from_numpy(
            rng.integers(-1, nc, (batch, in_h, in_w)).astype(tgt_dtype)).to(device)
        model = init_fast_scnn(nc, aux=True, generator=torch.Generator().manual_seed(0),
                               device="cpu", stem_impl=k["stem_impl"])
        state = create_train_state(model, optimizer, device=device)
        if k["device_aug_split"]:
            step = make_split_aug_train_step(model, loss_fn, optimizer, aug, **step_kw)
        else:
            step = make_train_step(model, loss_fn, optimizer, device_aug=aug, **step_kw)
        gen = torch.Generator(device=device).manual_seed(1)
        aug_gen = torch.Generator(device=device).manual_seed(2) if aug is not None else None
        try:
            state, m = step(state, images, targets, gen, aug_gen)
            float(m["loss"])  # capture (on the card) and one step
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(k["iters"]):
                    state, m = step(state, images, targets, gen, aug_gen)
                float(m["loss"])
                times.append((time.perf_counter() - t0) / k["iters"])
            dt = statistics.median(times)
            chain_ms = None
            if k["device_aug_split"]:  # the chain alone, eager, as the root bench's breakdown
                g2 = torch.Generator(device=device).manual_seed(2)
                aug(images, targets, g2)
                _sync(device)
                t0 = time.perf_counter()
                for _ in range(k["iters"]):
                    aug(images, targets, g2)
                _sync(device)
                chain_ms = 1e3 * (time.perf_counter() - t0) / k["iters"]
        except torch.OutOfMemoryError as e:
            print(f"batch {batch} failed: {e}", file=sys.stderr)
            del state, step, images, targets
            gc.collect()
            torch.cuda.empty_cache()
            continue
        sps = batch / dt
        pool = f", graph pool {step.pool_bytes} bytes" if graph else ""
        chain = f", the chain alone {chain_ms:.2f} ms" if chain_ms is not None else ""
        print(f"batch {batch}: {sps:.1f} samples/s ({dt * 1e3:.2f} ms/step{chain}{pool})",
              file=sys.stderr)
        if sps > best_sps:
            best_sps, best_batch = sps, batch
        del state, step, images, targets
        gc.collect()
        if graph:
            torch.cuda.empty_cache()
    return {
        "metric": metric_name(k),
        "value": round(best_sps, 1),
        "unit": "samples/sec/chip",
        "batch": best_batch,
        "stem_impl": k["stem_impl"],
        "grad_accum": k["grad_accum"],
        "graph": graph,
        "device": torch.cuda.get_device_name(device) if graph else "cpu",
    }


def main():
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
