"""The port's TIFF reader (``data/tiff.py`` over ``data/imgcodecs.cpp``,
``zlib`` and ``data/jpeg.cpp``) against Pillow 12 and its libtiff, with PIL
blocked in the port's calls.

Every comparison is exact (tolerance 0): the array, its dtype and mode,
the four converts the call sites ask for, the header size and the
palette. The committed fixtures (Pillow's TIFFs in every mode and
compression it writes, and ``spec_writers.tiff_bytes``'s: tiles, separate
planes, predictors, ``MM`` and BigTIFF, fill order 2, orientations, every
bit depth and sample format, associated alpha, YCbCr JPEG strips) and the
1280x720 JPEG TIFF are held to Pillow and the manifest; hypothesis draws
Pillow's compressions and modes and the specification's layouts. Each
variant the port refuses raises a ValueError naming it and the ROADMAP
item.
"""

import hashlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from fastscnn_tpu_torch.data import image_io
from fastscnn_tpu_torch.data.jpeg import ROADMAP_ITEM
from fastscnn_tpu_torch.data.tiff import decode_tiff
from tests.test_torch_gif import check_against_pillow, mf, pil_blocked, sw

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
TIFFS = sorted(n for n in MANIFEST["decode"] if n.endswith(".tif"))


@pytest.mark.parametrize("name", TIFFS)
def test_tiff_fixture_equals_pillow(name, tmp_path):
    """Each TIFF fixture: Pillow's array, mode, converts, size, palette."""
    check_against_pillow((FIXTURES / name).read_bytes(), tmp_path)


def test_tiff_frames():
    """The 1280x720 frame: Pillow's JPEG TIFF decodes to the manifest's
    digest; a 128x192 crop written with LZW (predictor 2) and Deflate by
    ``spec_writers`` (as the card's smoke script writes the whole frame)
    decodes to the crop, as Pillow decodes it."""
    entry = MANIFEST["frames"]["frame_1280x720_jpeg.tif"]
    with pil_blocked():
        arr, mode = image_io.decode(str(FIXTURES / "frame_1280x720_jpeg.tif"))
        frame = image_io.read_image(str(FIXTURES / "frame_1280x720_q80.webp"), "RGB")
    assert [mode, list(arr.shape)] == [entry["mode"], entry["shape"]]
    assert hashlib.sha256(arr.tobytes()).hexdigest() == entry["sha256"]
    crop = np.ascontiguousarray(frame[300:428, 500:692])
    for kw in (dict(compression=5, predictor=2, rows_per_strip=64), dict(compression=8)):
        data = sw.tiff_bytes(crop, photometric=2, **kw)
        with pil_blocked():
            got, _ = image_io.decode_bytes(data)
        np.testing.assert_array_equal(got, crop)
        check_against_pillow(data)


_PILLOW_MODES = {
    "RGB": lambda a: Image.fromarray(a[..., :3]), "RGBA": lambda a: Image.fromarray(a),
    "L": lambda a: Image.fromarray(a[..., 0]), "1": lambda a: Image.fromarray(a[..., 0] > 127),
    "LA": lambda a: Image.fromarray(a[..., :2], "LA"),
    "P": lambda a: Image.fromarray(a[..., :3]).quantize(37),
    "I;16": lambda a: Image.fromarray(a[..., 0].astype(np.uint16) * 251),
    "I": lambda a: Image.fromarray(a[..., 0].astype(np.int32) * 1001 - 100000),
    "F": lambda a: Image.fromarray(a[..., 0].astype(np.float32) / 7 - 3),
    "CMYK": lambda a: Image.fromarray(a[..., :3]).convert("CMYK"),
}


@settings(max_examples=30, deadline=None)
@given(h=st.integers(1, 33), w=st.integers(1, 33), seed=st.integers(0, 2**16),
       mode=st.sampled_from(sorted(_PILLOW_MODES)),
       compression=st.sampled_from(["raw", "tiff_lzw", "tiff_adobe_deflate", "packbits",
                                    "jpeg"]),
       quality=st.integers(5, 100))
def test_pillow_tiff_draws(h, w, seed, mode, compression, quality):
    """TIFFs Pillow writes: each mode with each compression it takes (JPEG
    for L and RGB, at any quality)."""
    if compression == "jpeg" and mode not in ("L", "RGB"):
        compression = "tiff_lzw"
    a = np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)
    buf = io.BytesIO()
    kw = {"quality": quality} if compression == "jpeg" else {}
    _PILLOW_MODES[mode](a).save(buf, "TIFF", compression=compression, **kw)
    check_against_pillow(buf.getvalue())


# (photometric, bits, sample format, extra samples, samples, dtype) of the
# layouts Pillow opens
_LAYOUTS = {
    "1": (1, 1, 1, (), 1, np.uint8), "1-white": (0, 1, 1, (), 1, np.uint8),
    "L2": (1, 2, 1, (), 1, np.uint8), "L4-white": (0, 4, 1, (), 1, np.uint8),
    "L": (1, 8, 1, (), 1, np.uint8), "L-white": (0, 8, 1, (), 1, np.uint8),
    "I;16": (1, 16, 1, (), 1, np.uint16), "I16S": (1, 16, 2, (), 1, np.int16),
    "I32S": (1, 32, 2, (), 1, np.int32), "F": (1, 32, 3, (), 1, np.float32),
    "P4": (3, 4, 1, (), 1, np.uint8), "P": (3, 8, 1, (), 1, np.uint8),
    "PA": (3, 8, 1, (2,), 2, np.uint8), "LA": (1, 8, 1, (2,), 2, np.uint8),
    "RGB": (2, 8, 1, (), 3, np.uint8), "RGBA": (2, 8, 1, (2,), 4, np.uint8),
    "RGBa": (2, 8, 1, (1,), 4, np.uint8), "RGBX": (2, 8, 1, (0,), 4, np.uint8),
    "RGB16": (2, 16, 1, (), 3, np.uint16), "CMYK": (5, 8, 1, (), 4, np.uint8),
}


@settings(max_examples=150, deadline=None)
@given(h=st.integers(1, 29), w=st.integers(1, 29), seed=st.integers(0, 2**16),
       layout=st.sampled_from(sorted(_LAYOUTS)),
       compression=st.sampled_from([1, 5, 8, 32946, 32773]), predictor=st.sampled_from([1, 2, 3]),
       planar=st.sampled_from([1, 2]), byteorder=st.sampled_from(["<", ">"]),
       tile=st.one_of(st.none(), st.sampled_from([(16, 16), (32, 16)])),
       rows=st.integers(1, 8), fillorder=st.sampled_from([1, 1, 2]), bigtiff=st.booleans(),
       orientation=st.sampled_from([None, 1, 2, 3, 4, 5, 6, 7, 8]))
def test_spec_tiff_draws(h, w, seed, layout, compression, predictor, planar, byteorder, tile,
                         rows, fillorder, bigtiff, orientation):
    """TIFFs from the specification: every layout Pillow opens, in both
    byte orders, strips of any height or tiles, separate planes, each
    compression, the predictors where libtiff takes them, fill order 2,
    BigTIFF, every orientation. Pillow refuses some combinations (``MM``
    16-bit min-is-white, say); the port must refuse those too."""
    photometric, bits, fmt, extra, spp, dtype = _LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        vals = (rng.standard_normal((h, w, spp)) * 100).astype(dtype)
    else:
        info = np.iinfo(dtype)
        top = (1 << bits) - 1 if bits < 8 else info.max
        vals = rng.integers(info.min if bits >= 8 else 0, top, (h, w, spp),
                            endpoint=True).astype(dtype)
    if predictor == 2 and (bits < 8 or dtype == np.float32):
        predictor = 1
    if predictor == 3 and dtype != np.float32:
        predictor = 1
    if compression == 1:
        predictor = 1  # Pillow's own reader of uncompressed files ignores the tag
    if spp == 1:
        planar = 1
    colormap = rng.integers(0, 65536, (1 << bits, 3)) if photometric == 3 else None
    data = sw.tiff_bytes(vals, photometric=photometric, bits=bits, sample_format=fmt,
                         extra=extra, compression=compression, predictor=predictor,
                         planar=planar, byteorder=byteorder, tile=tile, rows_per_strip=rows,
                         colormap=colormap, fillorder=fillorder,
                         bigtiff=bigtiff, orientation=orientation)
    try:
        Image.open(io.BytesIO(data)).load()
    except Exception:  # noqa: BLE001 - Pillow refuses this layout: the port must refuse it too
        with pil_blocked(), pytest.raises(ValueError):
            image_io.decode_bytes(data)
        return
    try:
        with pil_blocked():
            image_io.decode_bytes(data)
    except ValueError as e:  # one of the variants the port refuses by name
        assert ROADMAP_ITEM in str(e) and any(q in str(e) for q in _QUIRKS), e
        return
    check_against_pillow(data)


# what Pillow reads in its own way and the port refuses by name
_QUIRKS = ("16-bit samples in separate planes", "extra sample in a separate plane",
           "separate planes and FillOrder 2")


def test_old_style_lzw_and_ycbcr_jpeg_strips():
    """libtiff's old LSB-first LZW; YCbCr JPEG strips at 4:2:0 and 4:4:4
    (whole JPEG streams, no JPEGTables), decoded to Pillow's RGB."""
    rgb = mf.seeded(40, 45, 3, 31)
    check_against_pillow(sw.tiff_bytes(rgb, photometric=2, compression=5, old_lzw=True))
    for sub, tag in ((2, (2, 2)), (0, (1, 1))):
        chunks = []
        for y in range(0, 40, 16):
            buf = io.BytesIO()
            Image.fromarray(rgb[y:y + 16]).save(buf, "JPEG", quality=85, subsampling=sub)
            chunks.append(buf.getvalue())
        check_against_pillow(sw.tiff_bytes(rgb, photometric=6, compression=7, rows_per_strip=16,
                                           chunks=chunks, extra_tags={530: (3, list(tag))}))


_REFUSED = [("CCITT modified Huffman RLE", dict(compression=2)),
            ("CCITT G3", dict(compression=3)), ("CCITT G4", dict(compression=4)),
            ("old-style JPEG (6)", dict(compression=6)),
            ("SGI LogLuv", dict(compression=34676)), ("JBIG", dict(compression=34661)),
            ("LZMA", dict(compression=34925)), ("ZSTD", dict(compression=50000)),
            ("WebP-in-TIFF", dict(compression=50001)),
            ("a LogLuv TIFF", dict(photometric=32844)),
            ("a YCbCr TIFF that is not JPEG-compressed", dict(photometric=6)),
            ("a CIELab TIFF", dict(photometric=8))]


@pytest.mark.parametrize("variant,kw", _REFUSED, ids=[v for v, _ in _REFUSED])
def test_refused_variants_name_themselves_and_the_item(variant, kw):
    """Each TIFF variant the port does not read raises a ValueError naming
    it and the ROADMAP item, with PIL blocked and nothing decoded."""
    vals = mf.seeded(8, 9, 3 if kw.get("photometric") in (6, 8) else 1, 3)
    args = {"photometric": 1, **kw}
    if vals.ndim == 2 and args["photometric"] == 32844:
        args["bits"] = 8
    data = sw.tiff_bytes(vals, **args)
    with pil_blocked(), pytest.raises(ValueError) as err:
        image_io.decode_bytes(data)
    assert variant in str(err.value) and ROADMAP_ITEM in str(err.value)
    with pytest.raises(ValueError, match="x.tif"):
        decode_tiff(data, "x.tif")


def test_layouts_pillow_refuses_raise():
    """A layout Pillow's OPEN_INFO lacks (RGB floats, 12-bit grey) and a
    file that is not a TIFF raise a ValueError naming the file."""
    floats = sw.tiff_bytes(np.zeros((4, 5, 3), np.float32), photometric=2, bits=32,
                           sample_format=3)
    twelve = sw.tiff_bytes(np.zeros((4, 5), np.uint8), photometric=1, bits=8,
                           extra_tags={258: (3, [12])})
    for data in (floats, twelve, b"II*\0" + b"\xff" * 4):
        with pil_blocked(), pytest.raises(ValueError, match="x.tif"):
            decode_tiff(data, "x.tif")
