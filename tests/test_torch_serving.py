"""The port's batching server (``fastscnn_tpu_torch/serving.py``): the
cases of ``tests/test_serving.py`` on the port's ``BatchingPredictor``,
``ServingServer`` and ``InferenceEngine``, plus ``build_server`` (the
path ``main`` takes) on the CPU, the port's copies of the palette and
the dataset registry against the JAX package's, and the PNG body, the
resize of a wrong-size frame and the PNG answer, without PIL, against the
JAX server's answers.

On the CPU ``InferenceEngine.predict_fn`` runs eagerly; on the card it
replays a CUDA graph, which ``chip_smoke.py`` drives through this server.
"""

import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from fastscnn_tpu.models.registry import DATASET_ACRONYMS as JAX_ACRONYMS
from fastscnn_tpu.models.registry import DATASET_NUM_CLASSES as JAX_NUM_CLASSES
from fastscnn_tpu.utils.visualize import get_color_pallete as jax_color_pallete
from fastscnn_tpu_torch.engine import E2EConfig, InferenceEngine
from fastscnn_tpu_torch.models import DATASET_ACRONYMS, DATASET_NUM_CLASSES, init_fast_scnn
from fastscnn_tpu_torch.serving import BatchingPredictor, ServingServer, build_server, main
from fastscnn_tpu_torch.utils import get_color_pallete


def _slow_predictor(calls):
    """Fake batch predictor: mask = mean-intensity threshold; records batches."""

    def predict(batch):
        calls.append(batch.shape[0])
        time.sleep(0.03)  # make batching worthwhile
        return (batch.mean(axis=-1) > 127).astype(np.int32)

    return predict


def _png(image):
    bio = io.BytesIO()
    Image.fromarray(image).save(bio, "PNG")
    return bio.getvalue()


def _engine(num_classes=2, mask_dtype="int32"):
    model = init_fast_scnn(num_classes, generator=torch.Generator().manual_seed(0), device="cpu")
    return InferenceEngine(model, device="cpu",
                           config=E2EConfig(compute_dtype="float32", mask_dtype=mask_dtype))


def test_batching_groups_concurrent_requests():
    calls = []
    predictor = BatchingPredictor(
        _slow_predictor(calls), input_size=(16, 16), max_batch=4, max_delay_ms=30
    )
    try:
        images = [np.full((16, 16, 3), v, np.uint8) for v in (0, 255, 0, 255, 255, 0)]
        results = [None] * len(images)

        def call(i):
            results[i] = predictor.predict(images[i])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(images))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        for i, img in enumerate(images):
            expected = 1 if img[0, 0, 0] > 127 else 0
            assert (results[i] == expected).all()
        stats = predictor.get_stats()
        assert stats["requests"] == 6
        assert stats["batches"] < 6  # concurrency produced a multi-request batch
        assert stats["mean_batch_size"] > 1
        assert "latency_ms_p50" in stats
    finally:
        predictor.stop()


def test_predict_resizes_input():
    predictor = BatchingPredictor(
        lambda b: (b.mean(-1) > 127).astype(np.int32), input_size=(16, 16), max_batch=2,
        max_delay_ms=1,
    )
    try:
        mask = predictor.predict(np.full((64, 48, 3), 255, np.uint8))
        assert mask.shape == (16, 16)
        assert (mask == 1).all()
        with pytest.raises(ValueError, match="RGB"):
            predictor.predict(np.full((16, 16, 4), 255, np.uint8))
    finally:
        predictor.stop()


def test_http_server_roundtrip():
    """/healthz, a PNG mask, a JSON mask, /stats with the host and device
    payload, 404 on an unknown route and 400 on a malformed body."""
    predictor = BatchingPredictor(
        _slow_predictor([]), input_size=(16, 16), max_batch=4, max_delay_ms=10
    )
    server = ServingServer(predictor, palette_dataset="citys", host="127.0.0.1", port=0)
    port = server.start()
    try:
        base = f"http://127.0.0.1:{port}"
        health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=5).read())
        assert health == {"status": "ok"}
        body = _png(np.full((16, 16, 3), 255, np.uint8))

        req = urllib.request.Request(f"{base}/predict", data=body, method="POST")
        resp = urllib.request.urlopen(req, timeout=10)
        assert resp.headers["Content-Type"] == "image/png"
        mask_img = Image.open(io.BytesIO(resp.read()))
        assert mask_img.size == (16, 16) and mask_img.mode == "P"
        assert (np.asarray(mask_img) == 1).all()

        req = urllib.request.Request(f"{base}/predict", data=body, method="POST",
                                     headers={"Accept": "application/json"})
        payload = json.loads(urllib.request.urlopen(req, timeout=10).read())
        assert np.asarray(payload["mask"]).shape == (16, 16)

        stats = json.loads(urllib.request.urlopen(f"{base}/stats", timeout=5).read())
        assert stats["requests"] >= 2
        assert "cpu_percent" in stats["system"]
        assert stats["device"] == {"platform": "cpu"}

        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"{base}/nowhere", timeout=5)
        assert exc.value.code == 404
        req = urllib.request.Request(f"{base}/predict", data=b"not an image", method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=5)
        assert exc.value.code == 400
    finally:
        server.stop()


def test_octet_stream_response():
    """Accept: application/octet-stream returns raw mask bytes with shape
    and dtype headers — the cheap machine-to-machine path."""
    predictor = BatchingPredictor(
        lambda b: (b.mean(-1) > 127).astype(np.uint8), input_size=(16, 16),
        max_batch=2, max_delay_ms=1,
    )
    server = ServingServer(predictor, palette_dataset="citys", host="127.0.0.1", port=0)
    port = server.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict", data=_png(np.full((16, 16, 3), 255, np.uint8)),
            headers={"Accept": "application/octet-stream"}, method="POST",
        )
        resp = urllib.request.urlopen(req, timeout=10)
        assert resp.headers["Content-Type"] == "application/octet-stream"
        shape = tuple(int(v) for v in resp.headers["X-Mask-Shape"].split("x"))
        mask = np.frombuffer(resp.read(), np.dtype(resp.headers["X-Mask-Dtype"])).reshape(shape)
        assert mask.shape == (16, 16) and mask.dtype == np.uint8
        assert (mask == 1).all()
    finally:
        server.stop()


def test_serving_with_real_engine():
    """Full stack: BatchingPredictor over the port's engine, whose
    ``predict_fn`` hands back a torch tensor that the completion thread
    brings to the host; each answer equals ``predict`` on its frame."""
    engine = _engine()
    fn = engine.predict_fn((2, 32, 48, 3))
    predictor = BatchingPredictor(lambda b: fn(b), input_size=(32, 48), max_batch=2,
                                  max_delay_ms=5)
    try:
        rng = np.random.default_rng(0)
        frames = [rng.integers(0, 256, (32, 48, 3)).astype(np.uint8) for _ in range(3)]
        for frame in frames:
            mask = predictor.predict(frame)
            assert isinstance(mask, np.ndarray) and mask.shape == (32, 48)
            np.testing.assert_array_equal(mask, engine.predict(frame).numpy())
        assert fn.replays == 3
    finally:
        predictor.stop()


def test_pipeline_overlaps_dispatch_and_gather():
    """Batch i+1 must dispatch while batch i's (slow) device->host gather is
    still in progress — the two-thread pipeline, not a serial worker."""
    dispatch_times = []

    class LazyResult:
        """Ready 0.2 s after dispatch; ``np.asarray`` blocks until then."""

        def __init__(self):
            self.ready_at = time.perf_counter() + 0.2

        def __array__(self, dtype=None, copy=None):
            delay = self.ready_at - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            return np.zeros((1, 4, 4), np.int32)

    def predict(batch):
        dispatch_times.append(time.perf_counter())
        return LazyResult()

    predictor = BatchingPredictor(
        predict, input_size=(4, 4), max_batch=1, max_delay_ms=1, pipeline_depth=2
    )
    try:
        img = np.zeros((4, 4, 3), np.uint8)
        results = [None, None]

        def call(i):
            results[i] = predictor.predict(img, timeout=10)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        elapsed = time.perf_counter() - t0
        assert all(r is not None and r.shape == (4, 4) for r in results)
        assert len(dispatch_times) == 2
        assert dispatch_times[1] - dispatch_times[0] < 0.15, dispatch_times
        assert elapsed < 0.38, elapsed
    finally:
        predictor.stop()


def test_stop_with_full_pipeline_fails_fast_and_joins():
    """stop() while the completer is wedged must not hang the dispatcher
    or leave queued clients waiting out their full timeout."""

    class NeverReady:
        def __array__(self, dtype=None, copy=None):
            time.sleep(5.0)  # wedged device->host gather
            return np.zeros((1, 4, 4), np.int32)

    predictor = BatchingPredictor(
        lambda b: NeverReady(), input_size=(4, 4), max_batch=1, max_delay_ms=1,
        pipeline_depth=1,
    )
    img = np.zeros((4, 4, 3), np.uint8)
    errors = []

    def call():
        try:
            predictor.predict(img, timeout=8.0)
        except Exception as e:
            errors.append(e)

    # enough requests to fill: 1 gathering + 1 inflight + 1 blocking put + queued
    threads = [threading.Thread(target=call) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.5)  # let the pipeline wedge
    t0 = time.perf_counter()
    predictor.stop()
    stop_took = time.perf_counter() - t0
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert stop_took < 5.0, stop_took
    assert not any(isinstance(e, TimeoutError) for e in errors), errors
    assert len(errors) >= 3
    assert all(isinstance(e, RuntimeError) for e in errors), errors


def test_bucketed_padding_picks_smallest_bucket():
    """A lone request pads to bucket 1, a 3-request burst to bucket 4 —
    never to max_batch."""
    shapes = []

    def predict(batch):
        shapes.append(batch.shape[0])
        time.sleep(0.03)
        return (batch.mean(-1) > 127).astype(np.int32)

    predictor = BatchingPredictor(
        predict, input_size=(8, 8), max_batch=8, max_delay_ms=30, bucket_sizes=(1, 2, 4, 8),
    )
    try:
        assert (predictor.predict(np.full((8, 8, 3), 255, np.uint8)) == 1).all()
        assert shapes == [1]
        results = [None] * 3

        def call(i):
            results[i] = predictor.predict(np.full((8, 8, 3), 255, np.uint8))

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert all((r == 1).all() for r in results)
        assert all(s in (1, 2, 4) for s in shapes[1:]), shapes
    finally:
        predictor.stop()


@pytest.mark.parametrize("buckets", [(1, 2), (0, 8), ()])
def test_bucket_sizes_validated(buckets):
    with pytest.raises(ValueError):
        BatchingPredictor(lambda b: b, (4, 4), max_batch=8, bucket_sizes=buckets)


def test_engine_mask_dtype_uint8():
    """E2EConfig(mask_dtype='uint8') returns identical masks 4x smaller."""
    img = np.random.default_rng(1).integers(0, 255, (1, 32, 64, 3)).astype(np.uint8)
    m32 = _engine(19).predict(img)
    m8 = _engine(19, mask_dtype="uint8").predict(img)
    assert m32.dtype == torch.int32 and m8.dtype == torch.uint8
    assert torch.equal(m32, m8.to(torch.int32))


def test_data_parallel_is_not_ported(capsys):
    """``--data-parallel`` is ported (``tests/test_torch_multidevice.py``
    serves over two CPU replicas); past the visible devices it is refused
    with the JAX server's parser error, before any weight loads."""
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--data-parallel", "2"])
    assert "only 1 device(s) visible" in capsys.readouterr().err


def test_build_server_serves_on_the_cpu(capsys):
    """``main``'s path without its wait: a random-init engine on the CPU,
    every power-of-two bucket warmed before traffic, the HTTP surface."""
    server = build_server(["--device", "cpu", "--dataset", "custom", "--height", "32",
                           "--width", "48", "--max-batch", "3", "--host", "127.0.0.1",
                           "--port", "0", "--dtype", "float32"])
    try:
        out = capsys.readouterr().out
        assert "random init" in out
        assert [b for b in (1, 2, 3) if f"warming up batch={b}" in out] == [1, 2, 3]
        assert server.predictor.bucket_sizes == (1, 2, 3)
        frame = np.random.default_rng(2).integers(0, 256, (32, 48, 3)).astype(np.uint8)
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/predict",
                                     data=_png(frame), method="POST",
                                     headers={"Accept": "application/octet-stream"})
        resp = urllib.request.urlopen(req, timeout=60)
        assert resp.headers["X-Mask-Dtype"] == "uint8"
        mask = np.frombuffer(resp.read(), np.uint8).reshape(32, 48)
        assert set(np.unique(mask)) <= {0, 1}
    finally:
        server.stop()


def test_palette_and_registry_match_jax():
    """The port's copies: the same PNG bytes for a mask in every palette,
    and the same dataset tables."""
    mask = np.random.default_rng(3).integers(0, 19, (12, 20)).astype(np.int32)
    for dataset in ("citys", "ade20k", "pascal_voc", "custom"):
        ours, theirs = io.BytesIO(), io.BytesIO()
        get_color_pallete(mask, dataset).save(ours, "PNG")
        jax_color_pallete(mask, dataset).save(theirs, "PNG")
        assert ours.getvalue() == theirs.getvalue(), dataset
    assert DATASET_NUM_CLASSES == JAX_NUM_CLASSES
    assert DATASET_ACRONYMS == JAX_ACRONYMS


def _pixel_model(batch):
    """A fake model whose mask is a function of the pixels it is fed, so a
    resize or decode that differed would show."""
    return (batch.astype(np.int32).sum(-1) // 40).astype(np.int32)  # 0..19


def _answers_of_both_servers(monkeypatch, bodies):
    """Each body's answers (palette PNG and raw mask) from the JAX server
    (PIL's path) and from the port's with PIL blocked."""
    from fastscnn_tpu.serving import BatchingPredictor as JaxPredictor
    from fastscnn_tpu.serving import ServingServer as JaxServer

    def answers(predictor_cls, server_cls):
        predictor = predictor_cls(_pixel_model, input_size=(24, 32), max_batch=2,
                                  max_delay_ms=1)
        server = server_cls(predictor, palette_dataset="citys", host="127.0.0.1", port=0)
        port = server.start()
        try:
            out = []
            for body in bodies:
                for accept in ("image/png", "application/octet-stream"):
                    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body,
                                                 method="POST", headers={"Accept": accept})
                    out.append(urllib.request.urlopen(req, timeout=30).read())
            return out
        finally:
            server.stop()

    theirs = answers(JaxPredictor, JaxServer)
    with monkeypatch.context() as m:
        for name in [k for k in sys.modules if k == "PIL" or k.startswith("PIL.")]:
            m.setitem(sys.modules, name, None)
        ours = answers(BatchingPredictor, ServingServer)
    return ours, theirs


def test_png_bodies_resizes_and_png_answers_equal_the_jax_server(monkeypatch):
    """A PNG body (RGB, greyscale and palette), a wrong-size frame and the
    PNG answer, with PIL blocked in the port's server: each answer's bytes
    equal the JAX server's, whose path is PIL's (decode, bilinear resize,
    palette PNG)."""
    rng = np.random.default_rng(7)
    frame = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    palette = rng.integers(0, 256, 120).tolist()  # 40 entries: PIL writes 8 bits a pixel
    bodies = [_png(frame), _png(frame[:24, :32]), _png(frame[:, :, 0])]
    pal = Image.fromarray(frame[:, :, 1] % 40)
    pal.putpalette(palette)
    bio = io.BytesIO()
    pal.save(bio, "PNG")
    bodies.append(bio.getvalue())
    ours, theirs = _answers_of_both_servers(monkeypatch, bodies)
    assert len(ours) == len(theirs) == 8
    for a, b in zip(ours, theirs):
        assert a == b
    assert len({bytes(a) for a in ours[1::2]}) == 4  # four different masks


def test_jpeg_bodies_equal_the_jax_server(monkeypatch):
    """JPEG bodies (4:2:0 at the model's size, a wrong-size 4:4:4 one, a
    progressive one, a greyscale one), with PIL blocked in the port's
    server: the port's codec decodes each to Pillow's pixels, so every
    answer's bytes equal the JAX server's."""
    rng = np.random.default_rng(11)
    y, x = np.mgrid[0:37, 0:53]
    frame = np.clip(np.stack([x * 4, y * 6, (x + y) * 3], -1)
                    + rng.integers(-30, 31, (37, 53, 3)), 0, 255).astype(np.uint8)

    def jpeg_body(arr, **kw):
        bio = io.BytesIO()
        Image.fromarray(arr).save(bio, "JPEG", **kw)
        return bio.getvalue()

    bodies = [jpeg_body(frame[:24, :32], quality=90),
              jpeg_body(frame, quality=95, subsampling=0),
              jpeg_body(frame, progressive=True),
              jpeg_body(frame[:, :, 1])]
    ours, theirs = _answers_of_both_servers(monkeypatch, bodies)
    assert len(ours) == len(theirs) == 8
    for a, b in zip(ours, theirs):
        assert a == b
    assert len({bytes(a) for a in ours[1::2]}) == 4
