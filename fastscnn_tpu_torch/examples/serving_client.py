#!/usr/bin/env python3
"""Minimal client for the batching inference server (fastscnn_tpu_torch.serving).

Start the server (any dataset/weights; random init works for a demo):

    python -m fastscnn_tpu_torch.serving --dataset custom --height 128 --width 128 \
        --max-batch 8 --port 8500

then run this client to POST frames and print mask stats + latency:

    python -m fastscnn_tpu_torch.examples.serving_client --url http://127.0.0.1:8500 \
        --image path/to/frame.webp --repeat 32 --concurrency 8

``--image`` is any file the port reads (PNG, JPEG, BMP, GIF, TIFF, WebP),
without PIL; the body is its RGB pixels as a quality-92 JPEG, in the bytes
Pillow writes for it.
"""

import argparse
import json
import threading
import time
import urllib.request

import numpy as np

from fastscnn_tpu_torch.data.image_io import read_image
from fastscnn_tpu_torch.data.jpeg import encode_jpeg


def encode_image(path: str | None) -> bytes:
    if path:
        rgb = read_image(path, "RGB")
    else:
        rng = np.random.default_rng(0)
        rgb = rng.integers(0, 255, (128, 128, 3), dtype=np.uint8).astype(np.uint8)
    return encode_jpeg(rgb, quality=92)


def main(argv=None):
    parser = argparse.ArgumentParser(description="serving client example")
    parser.add_argument("--url", default="http://127.0.0.1:8500")
    parser.add_argument("--image", default=None, help="frame to send (random if unset)")
    parser.add_argument("--repeat", type=int, default=16)
    parser.add_argument("--concurrency", type=int, default=4)
    args = parser.parse_args(argv)

    body = encode_image(args.image)
    latencies: list[float] = []
    errors: list[str] = []
    lock = threading.Lock()

    def one():
        req = urllib.request.Request(
            args.url + "/predict",
            data=body,
            headers={"Accept": "application/json"},
            method="POST",
        )
        t0 = time.perf_counter()
        try:
            payload = json.loads(urllib.request.urlopen(req, timeout=120).read())
        except Exception as e:
            with lock:
                errors.append(f"{type(e).__name__}: {e}")
            return None
        dt = time.perf_counter() - t0
        mask = np.asarray(payload["mask"])
        with lock:
            latencies.append(dt)
        return mask

    # warm-up (the first request pays the engine's graph capture)
    mask = one()
    if mask is None:
        raise SystemExit(f"warm-up request failed: {errors[-1]}")
    print(f"mask shape {mask.shape}, classes {sorted(np.unique(mask).tolist())}")
    latencies.clear()

    t0 = time.perf_counter()
    threads = []
    for i in range(args.repeat):
        t = threading.Thread(target=one)
        t.start()
        threads.append(t)
        if (i + 1) % args.concurrency == 0:
            for t in threads:
                t.join()
            threads = []
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0

    lat = sorted(latencies)
    if errors:
        print(f"{len(errors)} of {args.repeat} requests failed; first: {errors[0]}")
    if not lat:
        raise SystemExit("no successful requests — no latency stats")
    print(f"{len(lat)} requests in {wall:.2f}s ({len(lat) / wall:.1f} rps)")
    print(f"latency p50 {lat[len(lat) // 2] * 1e3:.1f} ms, "
          f"p95 {lat[int(0.95 * (len(lat) - 1))] * 1e3:.1f} ms")
    stats = json.loads(urllib.request.urlopen(args.url + "/stats", timeout=10).read())
    print("server stats:", json.dumps(stats, indent=2))


if __name__ == "__main__":
    main()
