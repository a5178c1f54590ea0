#!/usr/bin/env python
"""Input-pipeline benchmark of the port: can the host feed the card?

    python -m fastscnn_tpu_torch.bench_input [--workdir D] [--full]

The port of the repo root's ``bench_input.py``. From fixture sets on disk
at the two recipe shapes it measures:

1. loader-only samples/s: decode and the full host augmentation through
   the threaded loader (``data/loader.py``) and the worker-process loader
   (``data/grain_loader.py``); the decoded cache (``data/decoded_cache.py``)
   filled, then warm; the ``device-aug`` dataset mode (decode and label
   remap only, the chain left to the card), plain and with the warm cache;
2. end-to-end training samples/s with the loader in the loop: the port's
   ``Trainer`` for ``--train-epochs`` epochs after an untimed first one,
   plain, with the decoded cache, and with ``--device-aug`` and the cache.
   On the card the trainer's steps are CUDA graphs (captured in the
   untimed first epoch), on the CPU eager.

Shapes, halved unless ``--full``: ``citys`` Cityscapes-format PNGs at
1024×2048 (base 1024, crop 768, 24 train images); ``custom`` at 720×1280
(base 520, crop 480, 48 images of ``images/`` + binary ``masks/``). The
root bench writes the custom recipe's images as JPEG through PIL; here
they are PNGs written by ``image_io.write_png`` (the port decodes no JPEG
yet: ROADMAP.md, queue 1, item 5 (d)), so no PIL is on this path. The
Trainer legs run inside the work directory, where the trainer writes its
``logs/``. ``--device`` (default: the CUDA card) places the Trainer's
steps.

Prints one JSON line ``{"metric": "input_pipeline", "cpu_cores",
"device", "graphed", "recipes": {name: {...}}}`` with the root bench's
keys, and ``graphed``: whether the Trainer legs ran graphed steps.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np


def recipes(scale: int) -> dict:
    """The root bench's two recipes, sizes divided by ``scale``."""
    return {
        "citys_ce19": dict(dataset="citys", height=1024 // scale, width=2048 // scale,
                           base_size=1024 // scale, crop_size=768 // scale, n=24, loss="ce",
                           aux=True),
        "custom_dice2": dict(dataset="custom", height=720 // scale, width=1280 // scale,
                             base_size=520 // scale, crop_size=480 // scale, n=48, loss="dice",
                             aux=True),
    }


def _make_custom_set(root, n, height, width, seed=0):
    """TuSimple-like scenes and binary masks for ``data/custom.py``, both
    PNG (the root bench writes the images as JPEG)."""
    from fastscnn_tpu_torch.data.image_io import write_png

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "masks"), exist_ok=True)
    for i in range(n):
        img = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
        mask = np.zeros((height, width), np.uint8)
        lane_x = int(width * (0.3 + 0.4 * rng.random()))
        mask[:, lane_x:lane_x + 30] = 255
        write_png(os.path.join(root, "images", f"f{i:05d}.png"), img)
        write_png(os.path.join(root, "masks", f"f{i:05d}.png"), mask)
    return root


def measure_loader(loader, n_epochs=1, warmup=2):
    """samples/s through ``loader``, leaving out up to ``warmup`` leading
    batches (the workers' start), fewer when the set yields few batches."""
    stamps = [time.perf_counter()]
    counts = []
    for _ in range(n_epochs):
        for images, _targets in loader:
            stamps.append(time.perf_counter())
            counts.append(len(images))
    if not counts:
        return 0.0
    w = min(warmup, len(counts) - 1)
    dt = stamps[-1] - stamps[w]
    return sum(counts[w:]) / dt if dt > 0 else 0.0


def _timed_epochs(trainer, epochs):
    """Wall seconds of ``epochs`` more epochs of an already trained one."""
    trainer.args.start_epoch, trainer.args.epochs = 1, 1 + epochs
    t0 = time.perf_counter()
    trainer.train()
    if trainer.device.type == "cuda":
        import torch

        torch.cuda.synchronize(trainer.device)
    return time.perf_counter() - t0


def run(workdir, recipe_table, batch_size=8, workers=4, train_epochs=1, device=None) -> dict:
    from fastscnn_tpu_torch.data import DataLoader, decoded_cache, get_segmentation_dataset
    from fastscnn_tpu_torch.data.grain_loader import GrainDataLoader
    from fastscnn_tpu_torch.tools.system_check import generate_dataset
    from fastscnn_tpu_torch.train import Trainer
    from fastscnn_tpu_torch.train import parse_args as train_args

    out = {"metric": "input_pipeline", "cpu_cores": os.cpu_count() or 1, "device": None,
           "graphed": None, "recipes": {}}
    for name, r in recipe_table.items():
        root = os.path.abspath(os.path.join(workdir, f"{r['dataset']}_{r['height']}"))
        if not os.path.exists(root):
            if r["dataset"] == "citys":
                generate_dataset(root, n_train=r["n"], n_val=4, height=r["height"],
                                 width=r["width"], seed=1)
            else:
                _make_custom_set(root, r["n"], r["height"], r["width"])
        ds_kw = dict(root=root, split="train", base_size=r["base_size"],
                     crop_size=r["crop_size"])
        ds = get_segmentation_dataset(r["dataset"], mode="train", **ds_kw)
        loader_kw = dict(batch_size=batch_size, shuffle=True, num_workers=workers)
        row = {"threads_sps": round(measure_loader(DataLoader(ds, **loader_kw), n_epochs=2), 2)}

        # the decoded cache: one epoch fills it (decode + write), two read it
        cache_dir = os.path.abspath(os.path.join(workdir, f"decoded_{name}"))
        decoded_cache.set_cache_dir(cache_dir)
        try:
            row["threads_cache_fill_sps"] = round(
                measure_loader(DataLoader(ds, **loader_kw), n_epochs=1), 2)
            row["threads_cached_sps"] = round(
                measure_loader(DataLoader(ds, **loader_kw), n_epochs=2), 2)
        finally:
            decoded_cache.set_cache_dir(None)
        grain = GrainDataLoader(ds, batch_size=batch_size, shuffle=True, seed=0,
                                num_workers=workers, num_epochs=2)
        try:
            row["grain_sps"] = round(measure_loader(grain, n_epochs=1), 2)
        finally:
            grain.close()

        # device-aug mode: the host decodes (or reads the cache) and remaps
        # labels; the chain runs on the card inside the train step
        ds_dev = get_segmentation_dataset(r["dataset"], mode="device-aug", **ds_kw)
        row["threads_device_aug_sps"] = round(
            measure_loader(DataLoader(ds_dev, **loader_kw), n_epochs=2), 2)
        decoded_cache.set_cache_dir(cache_dir)
        try:
            row["threads_device_aug_cached_sps"] = round(
                measure_loader(DataLoader(ds_dev, **loader_kw), n_epochs=2), 2)
        finally:
            decoded_cache.set_cache_dir(None)
        print(f"{name}: threads {row['threads_sps']} samples/s (decoded cache warm "
              f"{row['threads_cached_sps']}), grain {row['grain_sps']}, device-aug loader "
              f"{row['threads_device_aug_sps']} (cache warm "
              f"{row['threads_device_aug_cached_sps']}); crop {r['crop_size']}, bs "
              f"{batch_size}, {workers} workers, {out['cpu_cores']} cores", file=sys.stderr)

        if train_epochs > 0:
            flags = ["--dataset", r["dataset"], "--data-root", root,
                     "--base-size", str(r["base_size"]), "--crop-size", str(r["crop_size"]),
                     "--batch-size", str(batch_size), "--epochs", str(train_epochs),
                     "--loss-type", r["loss"], "--no-val", "--num-workers", str(workers),
                     "--save-folder", os.path.abspath(os.path.join(workdir, "w_" + name)),
                     "--save-epoch", "100000", "--print-interval", "100000"]
            flags += ["--aux"] if r["aux"] else []
            flags += ["--device", str(device)] if device is not None else []
            with contextlib.chdir(workdir):
                tr = Trainer(train_args(flags))
                out["device"], out["graphed"] = str(tr.device), tr.graph
                tr.train()  # the first epoch: cuDNN plans, allocator growth; not timed
                steps = tr.iters_per_epoch * train_epochs
                row["e2e_train_sps"] = round(
                    steps * batch_size / _timed_epochs(tr, train_epochs), 2)
                decoded_cache.set_cache_dir(cache_dir)
                try:
                    row["e2e_train_cached_sps"] = round(
                        steps * batch_size / _timed_epochs(tr, train_epochs), 2)
                    tr2 = Trainer(train_args(flags + ["--device-aug"]))
                    tr2.train()
                    row["e2e_train_device_aug_cached_sps"] = round(
                        steps * batch_size / _timed_epochs(tr2, train_epochs), 2)
                finally:
                    decoded_cache.set_cache_dir(None)
            print(f"{name}: end-to-end train {row['e2e_train_sps']} samples/s, decoded cache "
                  f"{row['e2e_train_cached_sps']}, device aug + decoded cache "
                  f"{row['e2e_train_device_aug_cached_sps']} ({steps} timed steps)",
                  file=sys.stderr)
        out["recipes"][name] = row
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                     "bench_input_fixtures"))
    p.add_argument("--full", action="store_true",
                   help="full-size fixture sets (1024x2048 citys); by default halved")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--train-epochs", type=int, default=1,
                   help="end-to-end Trainer epochs a leg (0 = skip)")
    p.add_argument("--device", default=None,
                   help="the Trainer's torch device; default: the CUDA card")
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    out = run(args.workdir, recipes(1 if args.full else 2), args.batch_size, args.workers,
              args.train_epochs, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
