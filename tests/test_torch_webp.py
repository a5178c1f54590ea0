"""The port's WebP reader (``data/webp.py`` over ``data/imgcodecs.cpp``)
against Pillow 12 and its libwebp 1.6, with PIL blocked in the port's calls.

Every comparison is exact (tolerance 0): the array, its dtype and mode,
the four converts the call sites ask for, the header size. The committed
fixtures (Pillow's lossless and lossy files, ALPH chunks raw and
lossless-coded under each filter, animated files, libwebp's own encoder
with the simple loop filter, sharpness, partitions and segments) and the
1280x720 lossy frame are held to Pillow and the manifest; hypothesis draws
Pillow's encoder settings (lossless or lossy, quality, method, ``exact``,
alpha and its quality) and libwebp's (loop filter type, strength and
sharpness, token partitions, segments, alpha filtering and compression).
Then a WebP and a TIFF body through the port's serving server over config
A (the B3 and B1 wrappers, their plain versions on the CPU), and the
port's serving client against the JAX example's.
"""

import hashlib
import importlib.util
import io
import json
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from fastscnn_tpu_torch.data import image_io
from fastscnn_tpu_torch.data.webp import decode_webp
from tests.test_torch_gif import check_against_pillow, mf, pil_blocked, sw

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "images"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
WEBPS = sorted(n for n in MANIFEST["decode"] if n.endswith(".webp"))


@pytest.mark.parametrize("name", WEBPS)
def test_webp_fixture_equals_pillow(name, tmp_path):
    """Each WebP fixture: Pillow's array, mode, converts and size."""
    check_against_pillow((FIXTURES / name).read_bytes(), tmp_path)


def test_webp_frame_equals_manifest():
    """The 1280x720 frame as Pillow writes a quality-80 WebP decodes to the
    manifest's digest (libwebp's YUV 4:2:0 to RGB, bit for bit)."""
    entry = MANIFEST["frames"]["frame_1280x720_q80.webp"]
    with pil_blocked():
        arr, mode = image_io.decode(str(FIXTURES / "frame_1280x720_q80.webp"))
    assert [mode, list(arr.shape)] == [entry["mode"], entry["shape"]]
    assert hashlib.sha256(arr.tobytes()).hexdigest() == entry["sha256"]


def _image(seed, h, w, alpha, smooth):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 7, y * 5, (x + y) * 3, 255 - x * 2], -1) % 256
    noise = rng.integers(-60, 61, (h, w, 4)) if not smooth else rng.integers(-6, 7, (h, w, 4))
    px = np.clip(base + noise, 0, 255).astype(np.uint8)
    return px if alpha else np.ascontiguousarray(px[..., :3])


@settings(max_examples=30, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2**16),
       lossless=st.booleans(), quality=st.integers(0, 100), method=st.integers(0, 6),
       exact=st.booleans(), alpha=st.booleans(), alpha_quality=st.integers(0, 100),
       smooth=st.booleans())
def test_pillow_webp_draws(h, w, seed, lossless, quality, method, exact, alpha, alpha_quality,
                           smooth):
    """WebPs Pillow writes, lossless and lossy, at every quality and method,
    with ``exact`` and alpha at any alpha quality."""
    buf = io.BytesIO()
    Image.fromarray(_image(seed, h, w, alpha, smooth)).save(
        buf, "WEBP", lossless=lossless, quality=quality, method=method, exact=exact,
        alpha_quality=alpha_quality)
    check_against_pillow(buf.getvalue())


@settings(max_examples=30, deadline=None)
@given(h=st.integers(1, 48), w=st.integers(1, 48), seed=st.integers(0, 2**16),
       quality=st.floats(0, 100), filter_type=st.integers(0, 1),
       filter_strength=st.integers(0, 100), filter_sharpness=st.integers(0, 7),
       partitions=st.integers(0, 3), segments=st.integers(1, 4),
       sns_strength=st.integers(0, 100), alpha=st.booleans(),
       alpha_filtering=st.integers(0, 2), alpha_compression=st.integers(0, 1),
       method=st.integers(0, 6))
def test_libwebp_option_draws(h, w, seed, quality, filter_type, filter_strength,
                              filter_sharpness, partitions, segments, sns_strength, alpha,
                              alpha_filtering, alpha_compression, method):
    """Lossy WebPs written by libwebp's own encoder with the options Pillow
    does not pass: both loop filters at any strength and sharpness, 1 to 8
    token partitions, 1 to 4 segments, every alpha filter, raw or
    lossless alpha."""
    data = mf.libwebp_encode(
        _image(seed, h, w, alpha, False), quality=quality, filter_type=filter_type,
        filter_strength=filter_strength, filter_sharpness=filter_sharpness,
        partitions=partitions, segments=segments, sns_strength=sns_strength,
        alpha_filtering=alpha_filtering, alpha_compression=alpha_compression, method=method)
    check_against_pillow(data)


@settings(max_examples=15, deadline=None)
@given(h=st.integers(1, 30), w=st.integers(1, 30), seed=st.integers(0, 2**16),
       filtering=st.integers(0, 3), coded=st.booleans(), offset=st.tuples(
           st.integers(0, 5), st.integers(0, 5)), lossless_frame=st.booleans())
def test_crafted_alph_and_animation_draws(h, w, seed, filtering, coded, offset,
                                          lossless_frame):
    """An ALPH chunk under each filter, raw or lossless-coded (the filtered
    plane as a VP8L stream's green), and an animated file whose first
    frame sits at an offset of a larger canvas."""
    px = _image(seed, h, w, True, False)
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "WEBP", quality=70)
    lossy = buf.getvalue()
    bits = None
    if coded:
        g = sw.alpha_filtered(px[..., 3], filtering)
        gbuf = io.BytesIO()
        Image.fromarray(np.stack([g * 0, g, g * 0], -1)).save(gbuf, "WEBP", lossless=True)
        bits = dict(sw.riff_chunks(gbuf.getvalue()))[b"VP8L"][5:]
    check_against_pillow(sw.replace_alph(lossy, sw.alph(px[..., 3], filtering, bits)))
    if lossless_frame:
        buf = io.BytesIO()
        Image.fromarray(px).save(buf, "WEBP", lossless=True)
        image = [c for c in sw.riff_chunks(buf.getvalue()) if c[0] == b"VP8L"]
    else:
        image = [c for c in sw.riff_chunks(lossy) if c[0] in (b"ALPH", b"VP8 ")]
    x, y = 2 * offset[0], 2 * offset[1]
    check_against_pillow(sw.anim_webp((w + x + 3, h + y + 1), [(x, y, w, h, image)], True))


def _refused(kind):
    buf = io.BytesIO()
    Image.fromarray(_image(0, 9, 11, True, False)).save(buf, "WEBP", quality=70)
    lossy = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(_image(0, 9, 11, False, False)).save(buf, "WEBP", lossless=True)
    lossless = buf.getvalue()
    chunks = dict(sw.riff_chunks(lossy))
    if kind == "an interframe":
        vp8 = bytearray(chunks[b"VP8 "])
        vp8[0] |= 1
        return sw.webp_file([(b"VP8 ", bytes(vp8))]), "interframe"
    if kind == "a VP8L version other than 0":
        vp8l = bytearray(dict(sw.riff_chunks(lossless))[b"VP8L"])
        vp8l[4] |= 0x20
        return sw.webp_file([(b"VP8L", bytes(vp8l))]), "version other than 0"
    if kind == "a truncated lossless bitstream":
        vp8l = dict(sw.riff_chunks(lossless))[b"VP8L"]
        return sw.webp_file([(b"VP8L", vp8l[:len(vp8l) // 3])]), "truncated"
    if kind == "ALPH reserved bits":
        return sw.replace_alph(lossy, b"\xc0" + chunks[b"ALPH"][1:]), "reserved"
    if kind == "a frame past its canvas":
        image = [c for c in sw.riff_chunks(lossless) if c[0] == b"VP8L"]
        return sw.anim_webp((11, 9), [(2, 0, 11, 9, image)], False), "past its canvas"
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["an interframe", "a VP8L version other than 0",
                                  "a truncated lossless bitstream", "ALPH reserved bits",
                                  "a frame past its canvas"])
def test_refused_webps_name_what_failed(kind):
    """What libwebp refuses raises a ValueError naming the file and why,
    with PIL blocked; Pillow refuses each too."""
    data, match = _refused(kind)
    with pil_blocked(), pytest.raises(ValueError, match=f"x.webp.*{match}"):
        decode_webp(data, "x.webp")
    with pytest.raises(Exception):  # noqa: B017 - Pillow's own words
        Image.open(io.BytesIO(data)).load()


def test_webp_and_tiff_bodies_through_the_server_over_config_a():
    """A WebP body and a TIFF body POSTed to the port's serving server over
    config A (``fused-ds`` + ``pallas``: B3 and B1) are answered with the
    mask ``engine.predict`` gives for the decoded frame, PIL blocked."""
    from fastscnn_tpu_torch.engine import E2EConfig, InferenceEngine
    from fastscnn_tpu_torch.models import FastSCNN
    from fastscnn_tpu_torch.serving import BatchingPredictor, ServingServer

    import torch

    torch.manual_seed(0)
    eng = InferenceEngine(FastSCNN(2, folded_dw_impl="fused-ds").eval(), device="cpu",
                          config=E2EConfig(final_upsample="pallas", mask_dtype="uint8"))
    h, w = 64, 96
    rgb = _image(5, h, w, False, True)
    bodies = {}
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "WEBP", quality=80)
    bodies["webp"] = buf.getvalue()
    bodies["tiff"] = sw.tiff_bytes(rgb, photometric=2, compression=5, predictor=2,
                                   rows_per_strip=16)
    predictor = BatchingPredictor(lambda b: eng.predict_fn(b.shape)(b), (h, w), max_batch=1,
                                  bucket_sizes=(1,))
    server = ServingServer(predictor, "citys", host="127.0.0.1", port=0)
    base = f"http://127.0.0.1:{server.start()}"
    try:
        for kind, body in bodies.items():
            req = urllib.request.Request(f"{base}/predict", data=body, method="POST",
                                         headers={"Accept": "application/octet-stream"})
            with pil_blocked():
                answer = np.frombuffer(urllib.request.urlopen(req, timeout=120).read(), np.uint8)
                decoded = image_io.decode_bytes(body, "RGB")[0]
            ref = eng.predict(torch.from_numpy(decoded)).numpy()
            np.testing.assert_array_equal(answer.reshape(h, w), ref, err_msg=kind)
    finally:
        server.stop()


def test_serving_client_body_equals_the_jax_example():
    """The port's ``examples/serving_client.encode_image`` gives the JAX
    example's body bytes (a quality-92 JPEG of the RGB pixels) for a WebP,
    a TIFF and a GIF fixture and for no image, with PIL blocked."""
    from fastscnn_tpu_torch.examples import serving_client

    spec = importlib.util.spec_from_file_location("jax_serving_client",
                                                  REPO / "examples" / "serving_client.py")
    jax_client = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_client)
    for name in ("lossy_rgba_q60_43x29.webp", "rgb_lzw_predictor2_37x23.tif",
                 "pillow_rgb_43x29.gif", None):
        path = str(FIXTURES / name) if name else None
        want = jax_client.encode_image(path)
        with pil_blocked():
            got = serving_client.encode_image(path)
        assert got == want, name


_MUTATE = r"""
import glob, random, sys
sys.modules["PIL"] = None
from fastscnn_tpu_torch.data import image_io
files = sorted(glob.glob(sys.argv[1] + "/*"))
datas = [open(f, "rb").read() for f in files
         if f.endswith((".gif", ".tif", ".webp")) and "1280" not in f]
rng = random.Random(int(sys.argv[2]))
for i in range(int(sys.argv[3])):
    d = bytearray(rng.choice(datas))
    kind = i % 3
    if kind == 0:  # bytes overwritten
        for _ in range(rng.randint(1, 8)):
            d[rng.randrange(len(d))] = rng.randrange(256)
    elif kind == 1:  # cut short
        d = d[:rng.randrange(len(d))]
    else:  # bits flipped past the headers
        for _ in range(rng.randint(1, 30)):
            d[rng.randrange(min(len(d) - 1, 40), len(d))] ^= 1 << rng.randrange(8)
    for convert in (None, "RGB"):
        try:
            image_io.decode_bytes(bytes(d), convert)
        except (ValueError, RuntimeError):
            pass
print("ok")
"""


def test_corrupt_files_raise_and_never_crash(tmp_path):
    """A server decodes what clients send: 900 GIF, TIFF and WebP fixtures
    with bytes overwritten, cut short or bits flipped decode or raise a
    ValueError (a RuntimeError where a broken signature sends them to the
    missing PIL); none crashes the process or raises anything else."""
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-c", _MUTATE, str(FIXTURES), "25", "900"],
                          capture_output=True, text=True, cwd=REPO, timeout=240)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]
