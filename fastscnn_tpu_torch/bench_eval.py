#!/usr/bin/env python
"""Benchmark of the eval surface: ``eval.py``'s testval protocol on the
card.

    python -m fastscnn_tpu_torch.bench_eval [--n-uniform 16] [--n-mixed 4]

The port of the repo root's ``bench_eval.py``, over the port's
``eval.Evaluator`` and ``tools/system_check.generate_dataset``, on a
synthetic Cityscapes-format val set at the real resolutions:

1. **Protocol wall-clock**: ``Evaluator.eval()`` end to end in two
   configurations, the reference-faithful one (batch 1, float32, PNG dumps)
   and the native one (batch 8, bfloat16, ``--no-dump``), each run cold
   (the first pass: cuDNN plans, device tables, allocator growth) and warm.
2. **Host metric-update cost**: ``SegmentationMetric.update`` per image.
3. **Device loop**: ``make_eval_step`` run ``iters`` times back to back,
   each input perturbed by the previous mask (root ``bench_eval.py:122-126``),
   as one CUDA graph at (8, H, W) bf16 on the card (eagerly on the CPU).
4. **Mixed-resolution bucket census**: 1024×2048, 768×1536 and 1000×2000
   images, each padded to a multiple of 64 and batched by padded shape:
   the buckets, the first-pass cost and the padded pixels.
5. **Decoded-cache leg**, last (the cache directory is process-wide).

``--quick`` runs on the CPU at 128×256 (a logic check, not a result).
Prints one JSON line: ``{"metric", "value" (images/s of the native leg,
warm), "unit", "detail": {...}}`` with the root bench's keys, plus
``"device"``. ``compile_s_total`` keeps its name and means the first
pass's extra time (cold minus warm); ``buckets`` counts the distinct
padded shapes (1000×2000 pads to 1024×2048's bucket).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

PAD = 64  # eval.py's --pad-multiple default


def _gen_val_tree(root: str, sizes_counts, seed=0):
    """A Cityscapes-format val tree with images at the given (h, w, n)."""
    from fastscnn_tpu_torch.tools.system_check import generate_dataset

    img_dir = os.path.join(root, "leftImg8bit", "val", "synth")
    lbl_dir = os.path.join(root, "gtFine", "val", "synth")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lbl_dir, exist_ok=True)
    idx = 0
    for h, w, n in sizes_counts:
        with tempfile.TemporaryDirectory(dir=root) as td:
            generate_dataset(td, n_train=0, n_val=n, height=h, width=w, seed=seed + idx)
            src_i = os.path.join(td, "leftImg8bit", "val", "synth")
            src_l = os.path.join(td, "gtFine", "val", "synth")
            for i in range(n):
                shutil.move(os.path.join(src_i, f"synth_{i:06d}_leftImg8bit.png"),
                            os.path.join(img_dir, f"synth_{idx:06d}_leftImg8bit.png"))
                shutil.move(os.path.join(src_l, f"synth_{i:06d}_gtFine_labelIds.png"),
                            os.path.join(lbl_dir, f"synth_{idx:06d}_gtFine_labelIds.png"))
                idx += 1
    return root


def _run_protocol(root, outdir, batch_size, dtype, no_dump, device, extra_argv=()):
    """One full ``Evaluator.eval()`` pass; returns (seconds, images)."""
    from fastscnn_tpu_torch.eval import Evaluator, parse_args

    argv = ["--dataset", "citys", "--data-root", root, "--mode", "testval",
            "--batch-size", str(batch_size), "--dtype", dtype, "--outdir", outdir,
            "--weights", os.path.join(root, "no-weights-use-random-init.pth"),
            *extra_argv]
    if no_dump:
        argv.append("--no-dump")
    if device is not None:
        argv += ["--device", str(device)]
    with contextlib.redirect_stdout(io.StringIO()):
        ev = Evaluator(parse_args(argv))
        t0 = time.perf_counter()
        ev.eval()
        if ev.device.type == "cuda":
            torch.cuda.synchronize(ev.device)
        dt = time.perf_counter() - t0
    return dt, len(ev.dataset)


def device_loop(step, params, model_state, x, t, iters):
    """``iters`` eval steps, each on the input the previous mask changed
    (image 0's pixel (0, 0) gains ``pred[0, 0, 0] % 2``, wrapping as uint8),
    summing the ``correct`` counts in f32: the loop body of the root
    bench's ``fori_loop``."""
    xi = x.clone()
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        pred, (correct, _, _, _) = step(params, model_state, xi, t)
        xi[0, 0, 0, 0].add_((pred[0, 0, 0] % 2).to(xi.dtype))
        acc.add_(correct)
    return acc


def device_loop_rate(batch, h, w, iters, device):
    """Images/s of :func:`device_loop` over the 19-class model at
    (batch, h, w) bf16, random weights from seed 0: on the card one CUDA
    graph of the loop, timed by the host clock around a replay and the
    read-back of its sum, after a first replay. Returns (rate, sum)."""
    from fastscnn_tpu_torch.models import init_fast_scnn, to_param_trees
    from fastscnn_tpu_torch.parallel import make_eval_step
    from fastscnn_tpu_torch.utils.cuda_graph import capture
    from fastscnn_tpu_torch.utils.tree import tree_map

    model = init_fast_scnn(19, generator=torch.Generator().manual_seed(0), device="cpu")
    params, model_state = (tree_map(lambda v: v.to(device), tree)
                           for tree in to_param_trees(model))
    step = make_eval_step(model, 19, device=device)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)).to(device)
    t = torch.from_numpy(rng.integers(-1, 19, (batch, h, w)).astype(np.int32)).to(device)

    def body():
        return device_loop(step, params, model_state, x, t, iters)

    if device.type == "cuda":
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            body()  # warm-up: cuDNN plans, device tables
        torch.cuda.current_stream(device).wait_stream(stream)
        graph = capture(body, device, torch.cuda.graph_pool_handle(), stream)
        run = graph.replay
    else:
        run = body
    float(run())
    t0 = time.perf_counter()
    total = float(run())
    dt = time.perf_counter() - t0
    return batch * iters / dt, total


def main(argv=None):
    from fastscnn_tpu_torch import resolve_device
    from fastscnn_tpu_torch.utils.metric import SegmentationMetric

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-uniform", type=int, default=16,
                    help="1024×2048 images in the uniform-set protocol runs")
    ap.add_argument("--n-mixed", type=int, default=4, help="images of each mixed size")
    ap.add_argument("--skip-mixed", action="store_true")
    ap.add_argument("--skip-device-loop", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="tiny shapes on the CPU: a logic check, not a result")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.quick else None)
    cli_device = "cpu" if args.quick else None
    H, W = (128, 256) if args.quick else (1024, 2048)

    results = {}
    work = tempfile.mkdtemp(prefix="bench_eval_")
    print(f"# workdir {work}")
    try:
        uni_root = _gen_val_tree(os.path.join(work, "uniform"), [(H, W, args.n_uniform)])
        for label, bs, dtype, no_dump in (
            ("ref_faithful_bs1_f32_dump", 1, "float32", False),
            ("tpu_native_bs8_bf16_nodump", 8, "bfloat16", True),
        ):
            outdir = os.path.join(work, f"out_{label}")
            t_cold, n = _run_protocol(uni_root, outdir, bs, dtype, no_dump, cli_device)
            t_warm, _ = _run_protocol(uni_root, outdir, bs, dtype, no_dump, cli_device)
            results[label] = {"images": n, "cold_s": round(t_cold, 2),
                              "steady_s": round(t_warm, 2),
                              "images_per_s": round(n / t_warm, 3)}
            print(f"{label}: cold {t_cold:.2f}s steady {t_warm:.2f}s "
                  f"→ {n / t_warm:.2f} images/s")

        rng = np.random.default_rng(0)
        pred = rng.integers(0, 19, (H, W)).astype(np.int32)
        gt = rng.integers(-1, 19, (H, W)).astype(np.int32)
        metric = SegmentationMetric(19)
        metric.update(pred, gt)
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            metric.update(pred, gt)
        dt = (time.perf_counter() - t0) / reps
        results["metric_update_ms_per_image"] = round(1e3 * dt, 2)
        print(f"metric.update: {1e3 * dt:.2f} ms per {H}×{W} image (host)")

        if not args.skip_device_loop:
            rate, _ = device_loop_rate(8, H, W, 3 if args.quick else 20, device)
            results["device_loop_images_per_s_bs8_bf16"] = round(rate, 2)
            print(f"device loop of eval steps: {rate:.1f} images/s @ (8,{H},{W}) bf16"
                  + (" (one CUDA graph)" if device.type == "cuda" else " (eager)"))

        if not args.skip_mixed:
            k = args.n_mixed
            sizes = ([(128, 256, k), (96, 192, k), (100, 200, k)] if args.quick
                     else [(1024, 2048, k), (768, 1536, k), (1000, 2000, k)])
            mix_root = _gen_val_tree(os.path.join(work, "mixed"), sizes, seed=50)
            padded = [(-(-h // PAD) * PAD, -(-w // PAD) * PAD) for h, w, _ in sizes]
            waste = sum(n * (ph * pw - h * w) for (h, w, n), (ph, pw) in zip(sizes, padded))
            total = sum(n * ph * pw for (_, _, n), (ph, pw) in zip(sizes, padded))
            outdir = os.path.join(work, "out_mixed")
            t_cold, n = _run_protocol(mix_root, outdir, 4, "bfloat16", True, cli_device)
            t_warm, _ = _run_protocol(mix_root, outdir, 4, "bfloat16", True, cli_device)
            results["mixed_res"] = {
                "images": n,
                "buckets": len(set(padded)),
                "cold_s": round(t_cold, 2),
                "steady_s": round(t_warm, 2),
                "compile_s_total": round(t_cold - t_warm, 2),
                "padding_waste_pct": round(100.0 * waste / total, 2),
                "images_per_s": round(n / t_warm, 3),
            }
            print(f"mixed-res: {len(set(padded))} buckets, cold {t_cold:.2f}s steady "
                  f"{t_warm:.2f}s, padding waste {100.0 * waste / total:.1f}%")

        # last: --decoded-cache sets the process-wide cache directory
        from fastscnn_tpu_torch.data import decoded_cache

        extra = ["--decoded-cache", os.path.join(work, "decoded_cache")]
        outdir = os.path.join(work, "out_cache")
        try:
            t_fill, n = _run_protocol(uni_root, outdir, 8, "bfloat16", True, cli_device, extra)
            t_cached, _ = _run_protocol(uni_root, outdir, 8, "bfloat16", True, cli_device, extra)
        finally:
            decoded_cache.set_cache_dir(None)
        results["tpu_native_bs8_bf16_nodump_decoded_cache"] = {
            "images": n, "cache_warmup_s": round(t_fill, 2), "steady_s": round(t_cached, 2),
            "images_per_s": round(n / t_cached, 3)}
        print(f"decoded-cache leg: warmup {t_fill:.2f}s warm {t_cached:.2f}s "
              f"→ {n / t_cached:.2f} images/s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    line = {
        "metric": "eval_testval_images_per_s",
        "value": results.get("tpu_native_bs8_bf16_nodump", {}).get("images_per_s"),
        "unit": f"images/s (bs8 bf16 metric-only steady-state protocol, {H}×{W})",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "detail": results,
    }
    print(json.dumps(line))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(line, f, indent=1)
    return line


if __name__ == "__main__":
    main()
