"""The port's GIF reader (``data/gif.py`` over ``data/imgcodecs.cpp``)
against Pillow 12, with PIL blocked in the port's calls.

Every comparison is exact (tolerance 0): the array, its dtype and mode,
the four converts the call sites ask for (RGB, L, RGBA, LA), the header
size and the palette. The committed fixtures of ``tests/fixtures/images``
(Pillow's GIFs and ``spec_writers.gif_bytes``'s) and the 1280x720 frame
are held to Pillow and to the manifest; hypothesis draws Pillow's encoder
settings (mode, palette size, interlace, transparency, optimize) and the
specification's variants (LZW minimum code size, local and global tables,
offset frames, a full table without a clear code, sub-block sizes).
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from fastscnn_tpu_torch.data import image_io
from fastscnn_tpu_torch.data.gif import decode_gif

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
CONVERTS = ("RGB", "L", "RGBA", "LA")


def _fixtures_module():
    spec = importlib.util.spec_from_file_location("image_fixtures", FIXTURES / "make_fixtures.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


mf = _fixtures_module()
sw = mf.spec_writers()


@contextlib.contextmanager
def pil_blocked():
    """The card's machine has no PIL: the port's calls run without it."""
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        yield
    finally:
        sys.modules["PIL"] = saved


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def check_against_pillow(data: bytes, tmp_path=None):
    """Decode, the four converts, the size and the palette of ``data``
    with PIL blocked, each equal to Pillow's."""
    def convert(img, c):
        try:
            conv = img.convert(c)
        except ValueError:  # Pillow refuses this convert: so must the port
            return None, None
        return np.asarray(conv), conv.mode

    with Image.open(io.BytesIO(data)) as img:
        img.load()
        want = [(np.asarray(img), img.mode)] + [convert(img, c) for c in CONVERTS]
        size, palette = img.size, img.getpalette() if img.mode in ("P", "PA") else None
    got = []
    for c, (ref, _) in zip((None, *CONVERTS), want):
        if ref is None:
            with pil_blocked(), pytest.raises(ValueError, match="Pillow refuses it too"):
                image_io.decode_bytes(data, c)
        with pil_blocked():
            got.append(image_io.decode_bytes(data, c) if ref is not None else (None, None))
    for (arr, mode), (ref, ref_mode) in zip(got, want):
        if ref is None:
            continue
        assert mode == ref_mode
        assert arr.dtype == ref.dtype and arr.shape == ref.shape
        assert arr.tobytes() == np.ascontiguousarray(ref).tobytes()
    if tmp_path is not None:
        path = tmp_path / "f"
        path.write_bytes(data)
        with pil_blocked():
            assert image_io.image_size(str(path)) == size
            assert image_io.read_palette(str(path)) == palette


GIFS = sorted(n for n in MANIFEST["decode"] if n.endswith(".gif"))


@pytest.mark.parametrize("name", GIFS)
def test_gif_fixture_equals_pillow(name, tmp_path):
    """Each GIF fixture: Pillow's array, mode, converts, size and palette."""
    check_against_pillow((FIXTURES / name).read_bytes(), tmp_path)


def test_gif_frame_equals_manifest():
    """The 1280x720 frame as Pillow writes a GIF (quantized to 256 colours)
    decodes to the manifest's digest, and its RGB to Pillow's."""
    name = "frame_1280x720.gif"
    entry = MANIFEST["frames"][name]
    with pil_blocked():
        arr, mode = image_io.decode(str(FIXTURES / name))
        rgb = image_io.read_image(str(FIXTURES / name), "RGB")
    assert [mode, list(arr.shape), _digest(arr)] == [entry["mode"], entry["shape"],
                                                     entry["sha256"]]
    assert _digest(rgb) == entry["rgb_sha256"]


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2**16),
       mode=st.sampled_from(["RGB", "L", "1", "P16", "P2"]), interlace=st.booleans(),
       transparency=st.one_of(st.none(), st.integers(0, 15)), optimize=st.booleans())
def test_pillow_gif_draws(h, w, seed, mode, interlace, transparency, optimize):
    """GIFs Pillow writes from every mode, palette size and option."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if mode == "RGB":
        img = Image.fromarray(rgb)
    elif mode == "L":
        img = Image.fromarray(rgb[..., 0])
    elif mode == "1":
        img = Image.fromarray(rgb[..., 0] > 127)
    else:
        img = Image.fromarray(rgb).quantize(int(mode[1:]))
    kw = {"interlace": interlace, "optimize": optimize}
    if transparency is not None and mode.startswith("P"):
        kw["transparency"] = transparency % int(mode[1:])
    buf = io.BytesIO()
    img.save(buf, "GIF", **kw)
    check_against_pillow(buf.getvalue())


@settings(max_examples=30, deadline=None)
@given(h=st.integers(1, 33), w=st.integers(1, 33), seed=st.integers(0, 2**16),
       min_bits=st.integers(2, 8), local=st.sampled_from(["none", "local", "grey"]),
       global_table=st.booleans(), interlace=st.booleans(),
       transparency=st.one_of(st.none(), st.integers(0, 3)), offset=st.tuples(
           st.integers(0, 9), st.integers(0, 9)), grow=st.booleans(),
       clear_when_full=st.booleans(), block=st.integers(1, 255))
def test_spec_gif_draws(h, w, seed, min_bits, local, global_table, interlace, transparency,
                        offset, grow, clear_when_full, block):
    """GIFs from the specification: every minimum code size, local and
    global tables (a grey local table hides the global one), offset frames
    on a larger screen or one the frame grows, transparency, interlace, a
    full table with or without a clear, any sub-block size."""
    rng = np.random.default_rng(seed)
    colours = 1 << min_bits
    idx = rng.integers(0, colours, (h, w)).astype(np.uint8)
    pal = rng.integers(0, 256, (colours, 3))
    grey = np.repeat(np.arange(colours)[:, None], 3, 1)
    frame = dict(indices=idx, offset=offset, interlace=interlace, transparency=transparency,
                 min_bits=min_bits, clear_when_full=clear_when_full, block=block,
                 palette={"none": None, "local": pal[::-1], "grey": grey}[local])
    screen = (w + offset[0] - 3, h + offset[1] - 3) if grow else (w + 9, h + 9)
    screen = (max(screen[0], 1), max(screen[1], 1))
    data = sw.gif_bytes([frame], screen, pal if global_table else None)
    check_against_pillow(data)


def test_full_lzw_table_both_ways():
    """A 97x90 image of 256 colours fills the 4096-code table: with a clear
    code and without one (the table stops growing, codes stay 12 bits)."""
    idx = mf.seeded(90, 97, 1, 7)
    pal = np.random.default_rng(7).integers(0, 256, (256, 3))
    for clear in (True, False):
        check_against_pillow(sw.gif_bytes([dict(indices=idx, clear_when_full=clear)], (97, 90),
                                          pal))


@pytest.mark.parametrize("variant", ["no image", "truncated data", "not a GIF"])
def test_refused_gifs_name_the_file(variant):
    """What Pillow refuses raises a ValueError naming the file and why."""
    good = sw.gif_bytes([dict(indices=np.zeros((4, 4), np.uint8))], (4, 4), np.zeros((4, 3)))
    data, match = {"no image": (good[:13 + 12] + b";", "no image in the GIF"),
                   "truncated data": (good[:-8], "truncated"),
                   "not a GIF": (b"GIF90a" + good[6:], "not a GIF file")}[variant]
    with pil_blocked(), pytest.raises(ValueError, match=f"x.gif.*{match}"):
        decode_gif(data, "x.gif")
    with pytest.raises(Exception):  # noqa: B017 - Pillow refuses it too, in its own words
        Image.open(io.BytesIO(data)).load()
