"""The port's BMP reader and writer (``data/bmp.py``) against Pillow's
``BmpImagePlugin``, with PIL blocked in the port's calls.

Reads give ``np.asarray(Image.open(f))`` and its mode bit for bit, writes
the bytes of ``Image.fromarray(a).save(f, "BMP")``; what Pillow refuses
the port refuses too. The committed fixtures are in
``tests/fixtures/images`` (``test_torch_images.py`` holds them to the
manifest); here hypothesis draws sizes, RLE streams and headers.
"""

import contextlib
import importlib.util
import io
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from fastscnn_tpu_torch.data import bmp, image_io

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"

def _image_fixtures():
    """``tests/fixtures/images/make_fixtures.py`` under a name of its own
    (``tests/fixtures/jpeg`` has a ``make_fixtures.py`` too)."""
    spec = importlib.util.spec_from_file_location("image_fixtures", FIXTURES / "make_fixtures.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


mf = _image_fixtures()


@contextlib.contextmanager
def pil_blocked():
    """The card's machine has no PIL: the port's calls run without it."""
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        yield
    finally:
        sys.modules["PIL"] = saved


def _pillow_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "BMP")
    return buf.getvalue()


def _pillow_or_error(data: bytes):
    try:
        with Image.open(io.BytesIO(data)) as img:
            img.load()
            return np.asarray(img), img.mode
    except Exception as e:  # Pillow's refusal, to compare with the port's
        return e


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), kind=st.sampled_from(["1", "L", "RGB", "RGBA"]),
       seed=st.integers(0, 2**16))
def test_writes_equal_pillows_bytes(h, w, kind, seed):
    """``save_image(path.bmp, a)`` writes Pillow's bytes for bool, (H, W),
    (H, W, 3) and (H, W, 4) arrays at every size (row padding, the 1-bit
    packing), and reads back as Pillow reads them (RGBA as RGB)."""
    channels = {"1": 1, "L": 1, "RGB": 3, "RGBA": 4}[kind]
    arr = mf.write_input("1" if kind == "1" else "x", (h, w), channels, seed)
    data = bmp.encode_bmp(arr)
    assert data == _pillow_bytes(arr)
    with pil_blocked():
        back, mode = image_io.decode_bytes(data)
    want, want_mode = _pillow_or_error(data)
    assert mode == want_mode and back.tobytes() == want.tobytes()


@pytest.mark.parametrize("k", range(len(mf.WRITES)))
def test_save_image_writes_the_manifest(tmp_path, k):
    """``image_io.save_image`` of each manifest input, PIL blocked: the
    digest of Pillow's bytes."""
    import hashlib
    import json

    entry = json.loads((FIXTURES / "manifest.json").read_text())["write"][k]
    arr = mf.write_input(entry["kind"], entry["shape"], entry["channels"], entry["seed"])
    with pil_blocked():
        image_io.save_image(str(tmp_path / "a.BMP"), arr)
    assert hashlib.sha256((tmp_path / "a.BMP").read_bytes()).hexdigest() == entry["sha256"]


def _rle_stream(draw_ops, rle4: bool) -> bytes:
    out = bytearray()
    for op, a, b in draw_ops:
        if op == "run":
            out += bytes([a, b])
        elif op == "eol":
            out += b"\0\0"
        elif op == "delta":
            out += bytes([0, 2, a, b, b, a])  # Pillow reads two bytes, then two more
        else:  # absolute: a pixels, then a pad byte where the run is odd
            n = max(3, a)
            body = bytes((b + i) & (15 if rle4 else 255) for i in range(n))
            if rle4:
                body = bytes(((body[i] << 4) | body[i + 1]) & 255 for i in range(0, n - 1, 2))
            out += bytes([0, n]) + body + b"\0" * (len(body) % 2)
    return bytes(out + b"\0\1")


_OPS = st.lists(st.tuples(st.sampled_from(["run", "run", "eol", "abs", "delta"]),
                          st.integers(0, 40), st.integers(0, 255)), max_size=40)


@settings(max_examples=60, deadline=None)
@given(ops=_OPS, rle4=st.booleans(), w=st.integers(1, 23), h=st.integers(1, 9),
       top_down=st.booleans(), grey=st.booleans())
def test_rle_streams_decode_as_pillows_decoder(ops, rle4, w, h, top_down, grey):
    """Random RLE8 and RLE4 streams (runs past the row's end, deltas, odd
    absolute runs, early end of bitmap, short data) give Pillow's pixels,
    or a refusal where Pillow refuses."""
    colours = 16 if rle4 else 256
    palette = (np.repeat(np.arange(colours, dtype=np.uint8)[:, None], 3, 1) if grey and not rle4
               else np.random.default_rng(w).integers(0, 256, (colours, 3), dtype=np.uint8))
    data = mf.bmp_bytes(w, h, 4 if rle4 else 8, _rle_stream(ops, rle4), 2 if rle4 else 1, palette,
                        top_down=top_down)
    want = _pillow_or_error(data)
    with pil_blocked():
        try:
            got = image_io.decode_bytes(data)
        except ValueError as e:
            got = e
    if isinstance(want, Exception):
        assert isinstance(got, Exception), f"Pillow refused ({want!r}), the port read it"
    else:
        assert not isinstance(got, Exception), got
        assert got[1] == want[1] and got[0].tobytes() == want[0].tobytes()


def _header_variant(name: str) -> bytes:
    """A BMP that Pillow refuses: name -> bytes."""
    rgb = mf.seeded(5, 7, 3, 1)
    rows = mf._rows_bottom_up([r.tobytes() for r in rgb[..., ::-1]], False)
    good = mf.bmp_bytes(7, 5, 24, rows)
    if name == "header 20":
        return good[:14] + struct.pack("<I", 20) + good[18:]
    if name == "depth 2":
        return good[:28] + struct.pack("<H", 2) + good[30:]
    if name == "compression 4 (JPEG)":
        return good[:30] + struct.pack("<I", 4) + good[34:]
    if name == "bitfields 10-10-10":
        return mf.bmp_bytes(7, 5, 32, bytes(140), 3, masks=(0x3FF00000, 0xFFC00, 0x3FF))
    if name == "truncated pixels":
        return good[:-30]
    if name == "grey ramp at 4 bits":
        idx = mf.seeded(5, 7, 1, 2, 15)
        return mf.bmp_bytes(7, 5, 4, mf._rows_bottom_up(mf._packed_rows(idx, 4), False),
                            palette=np.repeat(np.arange(16, dtype=np.uint8)[:, None], 3, 1))
    if name == "RLE with a black/white palette":
        return mf.bmp_bytes(7, 5, 8, mf.rle8(mf.seeded(5, 7, 1, 3, 1)), 1,
                            np.array([[0, 0, 0], [255, 255, 255]], np.uint8))
    return b"BX" + good[2:]  # not a BMP


@pytest.mark.parametrize("name", ["header 20", "depth 2", "compression 4 (JPEG)",
                                  "bitfields 10-10-10", "truncated pixels", "grey ramp at 4 bits",
                                  "RLE with a black/white palette"])
def test_refuses_what_pillow_refuses(name):
    """Headers, depths, compressions and bitfields layouts Pillow does not
    take, pixel data cut short, a grey ramp whose 8-bit unpacker overruns
    4-bit rows, and RLE under a black/white palette: Pillow refuses each
    and the port raises a ValueError naming the file."""
    data = _header_variant(name)
    assert isinstance(_pillow_or_error(data), Exception)
    with pil_blocked(), pytest.raises(ValueError, match="<bytes>"):
        bmp.decode_bmp(data)


def test_sizes_from_the_header(tmp_path):
    """``image_size`` of a core-header, a top-down and a Pillow BMP: the
    header's size, as ``Image.open(f).size``, no decode and no PIL."""
    for name in ("core_rgb24_21x13.bmp", "rgb24_topdown_v5_33x25.bmp", "pillow_rgba_27x31.bmp"):
        with pil_blocked():
            size = image_io.image_size(str(FIXTURES / name))
        assert size == Image.open(FIXTURES / name).size, name
