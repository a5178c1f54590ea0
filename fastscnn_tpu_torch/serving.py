"""Micro-batching HTTP inference server on the port's engine.

The port's counterpart of ``fastscnn_tpu/serving.py``, with the same
routes, flags, defaults, statistics and error codes. It fronts an
``InferenceEngine`` (or any ``predict(batch) -> masks`` callable) with a
micro-batching queue: concurrent requests are grouped up to
``max_batch`` or ``max_delay_ms`` (whichever first — and for free while
the device pipeline is full), padded to the smallest power-of-two
*bucket* (one captured CUDA graph per bucket, ``InferenceEngine.predict_fn``,
so a lone request doesn't pay a full max_batch of device work), and
answered per-request. Dispatch and device→host gather run in separate
threads (a graph replay returns before the card has finished), so batch
i+1 computes on the card while batch i is distributed to its callers.
``--data-parallel N`` serves under a local mesh of N devices, each
request batch split over them.

No PIL: a PNG, JPEG, BMP, GIF, TIFF or WebP body is decoded by
``data/image_io.decode_bytes`` to Pillow's pixels (a JPEG through the port's
codec, ``data/jpeg.py``, a BMP through ``data/bmp.py``, a GIF, TIFF or WebP
through ``data/gif.py``, ``data/tiff.py`` or ``data/webp.py``),
a wrong-size frame resized by ``data/pil_ops.resize`` (PIL's bilinear,
bit for bit) and the PNG answer written by ``data/image_io.write_png``.

Routes (stdlib HTTP, threads):
  POST /predict        image bytes (PNG/JPEG/BMP/GIF/TIFF/WebP) → PNG palette mask
                       (JSON mask with Accept: application/json, or raw
                       mask bytes + X-Mask-Shape/X-Mask-Dtype headers
                       with Accept: application/octet-stream)
  GET  /healthz        liveness
  GET  /stats          request/batch/latency statistics

Usage::

    python -m fastscnn_tpu_torch.serving --dataset citys \
        --weights weights/fast_scnn_citys.pth --height 1024 --width 2048
    python -m fastscnn_tpu_torch.serving --device cpu --dataset custom \
        --height 128 --width 128 --max-batch 2
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import statistics
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from fastscnn_tpu_torch.data import image_io, pil_ops

__all__ = ["BatchingPredictor", "ServingServer", "build_server", "main"]


class _Request:
    __slots__ = ("image", "event", "result", "error", "t_enqueue")

    def __init__(self, image):
        self.image = image
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t_enqueue = time.perf_counter()


class BatchingPredictor:
    """Micro-batching wrapper around a ``predict(batch_u8_nhwc)`` callable.

    Two-stage pipeline: a *dispatcher* thread groups requests and launches
    the device work (a graph replay returns before the card finishes; a
    CUDA result goes to the next stage with an event recorded on the
    dispatcher's stream after it), and a *completion* thread waits for
    that event, copies the result to the host and answers requests. The
    bounded hand-off queue (``pipeline_depth``) lets batch i+1 compute
    on the card while batch i is still being gathered and distributed on
    the host. ``predict_batch`` must return a new tensor (or array) per
    call, as ``InferenceEngine.predict_fn`` does: up to ``pipeline_depth``
    results are held at once."""

    def __init__(
        self,
        predict_batch,
        input_size: tuple[int, int],
        max_batch: int = 8,
        max_delay_ms: float = 5.0,
        queue_size: int = 256,
        pipeline_depth: int = 2,
        bucket_sizes: tuple[int, ...] | None = None,
    ):
        """``bucket_sizes``: optional ascending padded-batch sizes (must end
        at ``max_batch``). A batch of n requests is padded to the smallest
        bucket ≥ n instead of always to ``max_batch`` — a fill-1 batch on a
        batch-16 graph wastes 15/16 of the device FLOPs and 16× the
        host→device bytes. One CUDA graph is captured per bucket;
        ``predict_batch`` must accept every bucket shape (a shape-cached
        ``predict_fn`` does). Default: (max_batch,) — the single-graph
        behavior."""
        self.predict_batch = predict_batch
        self.input_size = input_size
        self.max_batch = max_batch
        if bucket_sizes is None:
            bucket_sizes = (max_batch,)
        bucket_sizes = tuple(sorted(set(int(b) for b in bucket_sizes)))
        if not bucket_sizes or bucket_sizes[-1] != max_batch or bucket_sizes[0] < 1:
            raise ValueError(
                f"bucket_sizes must be ≥1 and end at max_batch={max_batch}: {bucket_sizes}"
            )
        self.bucket_sizes = bucket_sizes
        self.max_delay = max_delay_ms / 1e3
        self.queue: queue.Queue = queue.Queue(maxsize=queue_size)
        self._inflight: queue.Queue = queue.Queue(maxsize=max(1, pipeline_depth))
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.stats = {
            "requests": 0,
            "batches": 0,
            "batch_sizes": [],
            "latencies_ms": [],
        }
        self._dispatcher = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._completer = threading.Thread(target=self._complete_loop, daemon=True)
        self._dispatcher.start()
        self._completer.start()

    # -- client side ----------------------------------------------------------
    def predict(self, image: np.ndarray, timeout: float = 30.0) -> np.ndarray:
        """Blocking single-image predict through the batching queue.

        ``timeout`` bounds the TOTAL wait (enqueue + inference).
        Raises ``ValueError`` for images that are not (H, W, 3) after
        the resize — validated here, before the shared dispatcher ever
        touches the array, so one bad request cannot hurt the pipeline.
        """
        h, w = self.input_size
        if image.shape[:2] != (h, w):
            image = pil_ops.resize(np.asarray(image, np.uint8), (w, h), "bilinear")
        if image.shape != (h, w, 3):
            raise ValueError(
                f"expected an (H, W, 3) RGB image, got shape {image.shape}"
            )
        deadline = time.perf_counter() + timeout
        req = _Request(image)
        self.queue.put(req, timeout=timeout)
        if not req.event.wait(max(0.0, deadline - time.perf_counter())):
            raise TimeoutError("predict timed out")
        if req.error is not None:
            raise req.error
        return req.result

    # -- pipeline stages --------------------------------------------------------
    def _dispatch_loop(self):
        h, w = self.input_size
        while not self._stop.is_set():
            try:
                first = self.queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_delay
            while len(batch) < self.max_batch:
                now = time.perf_counter()
                if now >= deadline and not self._inflight.full():
                    break
                # Past the deadline with a FULL pipeline: dispatch would
                # block on _inflight.put anyway, so keep filling — it
                # raises batch fill under sustained load at zero added
                # latency (poll in short slices so a freed slot is seen).
                timeout = (deadline - now) if now < deadline else 0.005
                try:
                    batch.append(self.queue.get(timeout=max(timeout, 1e-4)))
                except queue.Empty:
                    continue
            # pad to the smallest bucket that holds the batch (see __init__)
            size = next(b for b in self.bucket_sizes if b >= len(batch))
            images = np.zeros((size, h, w, 3), np.uint8)
            kept = []
            for req in batch:
                # predict() validates shape, but a caller bypassing it must
                # not be able to kill the shared dispatcher thread.
                try:
                    images[len(kept)] = req.image
                    kept.append(req)
                except Exception as e:
                    req.error = ValueError(f"bad image: {e}")
                    req.event.set()
            batch = kept
            if not batch:
                continue
            done = None
            try:
                # a graph replay returns before the card finishes: the
                # card computes while we collect the next batch
                result, err = self.predict_batch(images), None
                if isinstance(result, torch.Tensor) and result.is_cuda:
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(result.device))
            except Exception as e:  # pragma: no cover
                result, err = None, e
            while not self._stop.is_set():
                try:
                    self._inflight.put((batch, result, done, err), timeout=0.1)
                    break
                except queue.Full:
                    continue
            else:  # shutting down with a full pipeline: fail this batch
                self._fail_batch(batch, RuntimeError("predictor stopped"))

    @staticmethod
    def _fail_batch(batch, exc):
        for req in batch:
            req.error = exc
            req.event.set()

    def _complete_loop(self):
        while True:
            try:
                batch, result, done, err = self._inflight.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return  # queue drained and stopping
                continue
            if self._stop.is_set():
                # shutting down: answer immediately instead of paying the
                # device->host gather for work nobody is waiting on
                self._fail_batch(batch, RuntimeError("predictor stopped"))
                continue
            if err is None:
                try:
                    if done is not None:
                        done.synchronize()  # the dispatcher's stream has produced it
                    # blocks on device→host (np.asarray raises on a CUDA tensor)
                    masks = (result.cpu().numpy() if isinstance(result, torch.Tensor)
                             else np.asarray(result))
                except Exception as e:  # pragma: no cover
                    masks, err = None, e
            now = time.perf_counter()
            with self._lock:
                self.stats["requests"] += len(batch)
                self.stats["batches"] += 1
                self.stats["batch_sizes"].append(len(batch))
                for req in batch:
                    self.stats["latencies_ms"].append((now - req.t_enqueue) * 1e3)
                if len(self.stats["latencies_ms"]) > 10000:
                    self.stats["latencies_ms"] = self.stats["latencies_ms"][-5000:]
                    self.stats["batch_sizes"] = self.stats["batch_sizes"][-5000:]
            for i, req in enumerate(batch):
                if err is not None:
                    req.error = err
                else:
                    req.result = masks[i]
                req.event.set()

    def get_stats(self) -> dict:
        with self._lock:
            sizes = list(self.stats["batch_sizes"])
            lats = list(self.stats["latencies_ms"])
            out = {
                "requests": self.stats["requests"],
                "batches": self.stats["batches"],
                "max_batch": self.max_batch,
            }
        if sizes:
            out["mean_batch_size"] = statistics.mean(sizes)
            # batch-fill histogram: how well concurrency actually fills
            # batches (the whole point of the micro-batcher)
            hist: dict[int, int] = {}
            for s in sizes:
                hist[s] = hist.get(s, 0) + 1
            out["batch_size_hist"] = {str(k): hist[k] for k in sorted(hist)}
        if lats:
            srt = sorted(lats)
            out["latency_ms_p50"] = statistics.median(lats)
            out["latency_ms_p95"] = srt[int(0.95 * (len(srt) - 1))]
            out["latency_ms_p99"] = srt[int(0.99 * (len(srt) - 1))]
        # host and card resources, as the JAX server's /stats
        from fastscnn_tpu_torch.utils.system_monitor import device_stats, host_stats

        out["system"] = host_stats()
        out["device"] = device_stats()
        return out

    def stop(self):
        self._stop.set()
        self._dispatcher.join(timeout=2)
        self._completer.join(timeout=2)
        # answer anything still queued so clients fail fast, not by timeout
        while True:
            try:
                req = self.queue.get_nowait()
            except queue.Empty:
                break
            req.error = RuntimeError("predictor stopped")
            req.event.set()


class _Server(ThreadingHTTPServer):
    # A concurrent client burst larger than socketserver's default listen
    # backlog (5) gets TCP resets before accept() ever runs — observed as
    # ECONNRESET on 42/64 simultaneous connects. Size the backlog to the
    # predictor queue so admission control happens in predict(), not in
    # the kernel.
    request_queue_size = 256
    daemon_threads = True


class ServingServer:
    def __init__(self, predictor: BatchingPredictor, palette_dataset="citys",
                 host="0.0.0.0", port=8500):
        self.predictor = predictor
        self.palette_dataset = palette_dataset
        self.host = host
        self.port = port
        self.httpd = None
        self._thread = None

    def _handler(server_self):
        predictor = server_self.predictor
        palette_dataset = server_self.palette_dataset

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, data, ctype, code=200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(b'{"status":"ok"}', "application/json")
                elif self.path == "/stats":
                    self._send(
                        json.dumps(predictor.get_stats()).encode(), "application/json"
                    )
                else:
                    self._send(b'{"error":"not found"}', "application/json", 404)

            def do_POST(self):
                if self.path != "/predict":
                    self._send(b'{"error":"not found"}', "application/json", 404)
                    return
                length = int(self.headers.get("Content-Length", 0) or 0)
                body = self.rfile.read(length)
                try:
                    image = image_io.decode_bytes(body, "RGB")[0]
                except Exception as e:  # malformed upload: client error
                    self._send(
                        json.dumps({"error": str(e)}).encode(), "application/json", 400
                    )
                    return
                try:
                    mask = predictor.predict(image)
                except ValueError as e:  # bad image shape: client error
                    self._send(
                        json.dumps({"error": str(e)}).encode(), "application/json", 400
                    )
                    return
                except Exception as e:
                    # overload / shutdown / device failure: server error, so
                    # clients and load balancers retry or shed load
                    code = 503 if isinstance(e, (queue.Full, TimeoutError)) else 500
                    self._send(
                        json.dumps({"error": str(e)}).encode(), "application/json", code
                    )
                    return
                accept = self.headers.get("Accept") or ""
                if "application/octet-stream" in accept:
                    # raw row-major mask bytes — the cheap machine-to-machine
                    # path (JSON-encoding a 2M-pixel mask costs seconds of
                    # host CPU; this is a memcpy)
                    mask = np.ascontiguousarray(mask)
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("X-Mask-Shape", "x".join(map(str, mask.shape)))
                    self.send_header("X-Mask-Dtype", str(mask.dtype))
                    data = mask.tobytes()
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif "application/json" in accept:
                    self._send(
                        json.dumps({"mask": mask.tolist()}).encode(), "application/json"
                    )
                else:
                    from fastscnn_tpu_torch.utils.visualize import get_color_pallete

                    bio = io.BytesIO()
                    get_color_pallete(mask.astype(np.uint8), palette_dataset).save(
                        bio, "PNG"
                    )
                    self._send(bio.getvalue(), "image/png")

        return Handler

    def start(self):
        self.httpd = _Server((self.host, self.port), self._handler())
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        if self.httpd:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None
        self.predictor.stop()


def _parser():
    parser = argparse.ArgumentParser(description="fastscnn-tpu batching inference server "
                                     "(PyTorch/CUDA port)")
    parser.add_argument("--dataset", type=str, default="citys")
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--aux", action="store_true", default=False)
    parser.add_argument("--height", type=int, default=1024)
    parser.add_argument("--width", type=int, default=2048)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--max-delay-ms", type=float, default=5.0)
    parser.add_argument("--pipeline-depth", type=int, default=2,
                        help="in-flight batches (device compute / host gather overlap)")
    parser.add_argument("--data-parallel", type=int, default=1,
                        help="shard each batch over this many devices ('data' mesh axis, one "
                        "replica of the weights a device); max-batch must be divisible by it")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8500)
    parser.add_argument("--dtype", type=str, default="bfloat16")
    parser.add_argument("--final-upsample", type=str, default="hybrid",
                        choices=["hybrid", "hybrid-pallas", "matmul", "gather",
                                 "pallas", "argmax-first"],
                        help="mask upsample formulation (engine.E2EConfig); "
                        "'argmax-first' is the opt-in fast mode (mask boundaries "
                        "quantize to the 8-px grid)")
    parser.add_argument("--folded-dw-impl", type=str, default="conv",
                        choices=["conv", "taps", "pallas", "fused-ds", "fused-ds-mr"],
                        help="LTD depthwise-conv impl in the folded serving "
                        "graph (models.FastSCNN.folded_dw_impl; 'pallas', "
                        "'fused-ds' and 'fused-ds-mr' are the card's kernels)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device, or a comma-separated list of the devices "
                        "--data-parallel takes its first N from; default: the CUDA cards "
                        "(raises without one)")
    return parser


def visible_devices(spec: str | None) -> list:
    """The devices ``--device`` makes visible: None or ``cuda`` every CUDA
    card (raises without one), else the comma-separated devices named."""
    from fastscnn_tpu_torch import resolve_device

    if spec is None or spec == "cuda":
        resolve_device(None)  # raises without a card
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [resolve_device(d.strip()) for d in spec.split(",")]


def build_server(argv=None) -> ServingServer:
    """Everything ``main`` does before it waits: the engine (random
    weights from seed 0 unless ``--weights``), one ``predict_fn`` per
    power-of-two bucket warmed (on the card: captured) before traffic is
    accepted, the batching predictor and the started server.

    ``--data-parallel N`` above 1: the engine serves under a local mesh of
    the first N visible devices (``--device``), one replica of the folded
    weights a device, each batch split over them; the single bucket
    ``[max_batch]``. Checked, as the JAX server checks it, before the
    weights load: ``--max-batch`` must divide, and N devices be visible."""
    parser = _parser()
    args = parser.parse_args(argv)
    from fastscnn_tpu_torch.engine import E2EConfig, IMAGENET_MEAN, IMAGENET_STD, InferenceEngine
    from fastscnn_tpu_torch.models import FastSCNN, init_fast_scnn, load_checkpoint
    from fastscnn_tpu_torch.models.registry import DATASET_NUM_CLASSES
    from fastscnn_tpu_torch.parallel.mesh import make_mesh

    mesh = None
    devices = visible_devices(args.device)
    if args.data_parallel > 1:  # validate before the expensive weight load
        if args.max_batch % args.data_parallel:
            parser.error("--max-batch must be divisible by --data-parallel")
        if len(devices) < args.data_parallel:
            parser.error(f"only {len(devices)} device(s) visible")
        mesh = make_mesh(n_data=args.data_parallel, devices=devices[:args.data_parallel])
    device = devices[0]
    num_classes = DATASET_NUM_CLASSES[args.dataset]
    if args.weights:
        state = load_checkpoint(args.weights)
        aux = args.aux or any(k.startswith("auxlayer.") for k in state)
        model = FastSCNN(num_classes, aux=aux, folded_dw_impl=args.folded_dw_impl)
        model.load_state_dict(state)
    else:
        print("warning: random init")
        model = init_fast_scnn(num_classes, args.aux, generator=torch.Generator().manual_seed(0),
                               device=device, folded_dw_impl=args.folded_dw_impl)
    mean, std = (
        (IMAGENET_MEAN, IMAGENET_STD) if args.dataset != "custom" else (None, None)
    )
    engine = InferenceEngine(
        model, device=device,
        config=E2EConfig(mean=mean, std=std, compute_dtype=args.dtype,
                         final_upsample=args.final_upsample,
                         # lossless for num_classes ≤ 255; quarters the
                         # device→host mask transfer per request
                         mask_dtype="uint8"),
        mesh=mesh,
    )
    # Power-of-two padded-batch buckets: a fill-n batch pads to the next
    # bucket instead of always to max_batch (one CUDA graph per bucket).
    # --data-parallel keeps the single full bucket (each must divide the
    # data axis).
    if args.data_parallel > 1:
        buckets = [args.max_batch]
    else:
        buckets, b = [], 1
        while b < args.max_batch:
            buckets.append(b)
            b *= 2
        buckets.append(args.max_batch)
    # Capture every bucket's graph BEFORE accepting traffic, as the JAX
    # server compiles them: a first request must not pay the warm-up
    # passes and the capture.
    for b in buckets:
        print(f"warming up batch={b} (capture)...", flush=True)
        t0 = time.perf_counter()
        fn_b = engine.predict_fn((b, args.height, args.width, 3))
        fn_b(np.zeros((b, args.height, args.width, 3), np.uint8)).cpu()
        print(f"  warm in {time.perf_counter() - t0:.1f}s, graph pool "
              f"{fn_b.pool_bytes / 2**20:.1f} MiB", flush=True)
    predictor = BatchingPredictor(
        # predict_fn caches one graph per shape; the dispatcher's padded
        # bucket size selects it
        lambda batch: engine.predict_fn(batch.shape)(batch),
        (args.height, args.width),
        max_batch=args.max_batch,
        max_delay_ms=args.max_delay_ms,
        pipeline_depth=args.pipeline_depth,
        bucket_sizes=tuple(buckets),
    )
    server = ServingServer(predictor, args.dataset, args.host, args.port)
    server.start()
    return server


def main(argv=None):
    server = build_server(argv)
    print(f"serving at http://{server.host}:{server.port}/predict (Ctrl-C to stop)")
    try:
        server._thread.join()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
