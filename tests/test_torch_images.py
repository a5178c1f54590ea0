"""The port's PNG reader and mode conversions (``data/image_io.py``)
against Pillow, with PIL blocked in the port's calls.

Every comparison is exact. The committed fixtures of
``tests/fixtures/images`` (written by ``make_fixtures.py``: Pillow's own
files and files written from the PNG and BMP specifications) are held to
their manifest, which the card's smoke script checks too; hypothesis
draws PNGs of every bit depth, colour type and interlace method.
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from fastscnn_tpu_torch.data import image_io

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
REPO = Path(__file__).resolve().parents[1]

def _image_fixtures():
    """``tests/fixtures/images/make_fixtures.py`` under a name of its own
    (``tests/fixtures/jpeg`` has a ``make_fixtures.py`` too)."""
    spec = importlib.util.spec_from_file_location("image_fixtures", FIXTURES / "make_fixtures.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


mf = _image_fixtures()

CONVERTS = ("RGB", "L", "RGBA", "LA")


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


def _pillow(data: bytes, convert=None):
    with Image.open(io.BytesIO(data)) as img:
        img = img.convert(convert) if convert else img
        return np.asarray(img), img.mode


def _same(got, want):
    """Pillow's array bit for bit: dtype, shape, bytes (mode 1's True is 255)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", sorted(MANIFEST["decode"]))
def test_fixture_decodes_to_pillow(name):
    """Each fixture, PNG or BMP: ``np.asarray(Image.open(f))`` and its mode,
    and the manifest's digest, shape and dtype, with PIL blocked."""
    data = (FIXTURES / name).read_bytes()
    entry = MANIFEST["decode"][name]
    with pil_blocked():
        arr, mode = image_io.decode_bytes(data)
        size = image_io.image_size(str(FIXTURES / name))
    assert [mode, list(arr.shape), arr.dtype.str, _digest(arr)] == \
        [entry["mode"], entry["shape"], entry["dtype"], entry["sha256"]]
    want, want_mode = _pillow(data)
    assert mode == want_mode
    _same(arr, want)
    assert size == Image.open(io.BytesIO(data)).size


@pytest.mark.parametrize("name", sorted(MANIFEST["decode"]))
def test_fixture_converts_to_pillow(name):
    """``.convert(c)`` of each fixture for RGB, L, RGBA and LA: Pillow's
    array and the manifest's digest (tRNS chunks, palettes of every
    depth, 16-bit clipping, mode 1's 0/255)."""
    data = (FIXTURES / name).read_bytes()
    for c in CONVERTS:
        with pil_blocked():
            arr, mode = image_io.decode_bytes(data, c)
        entry = MANIFEST["decode"][name]["convert"][c]
        assert [mode, _digest(arr)] == [entry["mode"], entry["sha256"]], c
        want, want_mode = _pillow(data, c)
        assert mode == want_mode
        _same(arr, want)


# PNG draws: (bit depth, colour type) that Pillow opens
_PNG_KINDS = sorted(k for k in image_io._PNG_MODES)


@settings(max_examples=60, deadline=None)
@given(kind=st.sampled_from(_PNG_KINDS), h=st.integers(1, 19), w=st.integers(1, 19),
       interlace=st.booleans(), seed=st.integers(0, 2**16), with_trns=st.booleans(),
       convert=st.sampled_from([None, *CONVERTS]))
def test_png_draws_equal_pillow(kind, h, w, interlace, seed, with_trns, convert):
    """Random PNGs of every bit depth and colour type, Adam7 or not, with a
    tRNS chunk or without, decode and convert to Pillow's arrays."""
    depth, colour = kind
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    vals = rng.integers(0, top + 1, (h, w, mf.SAMPLES[colour]))
    palette = rng.integers(0, 256, (int(rng.integers(1, 257)), 3)) if colour == 3 else None
    trns = None
    if with_trns and colour == 3:
        trns = rng.integers(0, 256, int(rng.integers(1, 257)), dtype=np.uint8).tobytes()
    elif with_trns and colour in (0, 2):
        key = vals[rng.integers(0, h), rng.integers(0, w)]  # a value the image holds
        trns = b"".join(int(v).to_bytes(2, "big") for v in key)
    data = mf.png_bytes(vals, depth, colour, palette, trns, interlace)
    with pil_blocked():
        arr, mode = image_io.decode_bytes(data, convert)
    want, want_mode = _pillow(data, convert)
    assert mode == want_mode
    _same(arr, want)


@pytest.mark.parametrize("convert", ["1", "P", "I", "F", "YCbCr", "HSV", "LAB", "I;16", "CMYK"])
def test_other_converts_raise_naming_the_item(convert):
    """Dithering, quantising and the other modes are not ported: each
    raises a ValueError naming the ROADMAP item, never going to PIL."""
    data = (FIXTURES / "rgb16_37x45.png").read_bytes()
    with pil_blocked(), pytest.raises(ValueError, match=f"convert='{convert}'.*item 10"):
        image_io.decode_bytes(data, convert)


@pytest.mark.parametrize("fmt", ["GIF", "TIFF", "WEBP"])
def test_formats_no_call_site_names_go_to_pil(tmp_path, fmt):
    """GIF, TIFF and WebP, which no call site of the JAX package names but
    its ``Image.open`` reads, are the port's own since PIL left the card:
    read with PIL blocked to Pillow's array and mode, and converted to
    RGB, its size from the header; a format still only PIL reads (ICO)
    raises a RuntimeError naming the file and the item without PIL."""
    rgb = mf.seeded(9, 11, 3, 7)
    path = tmp_path / f"x.{fmt.lower()}"
    Image.fromarray(rgb).save(path, fmt, **({"lossless": True} if fmt == "WEBP" else {}))
    with pil_blocked():
        arr, mode = image_io.decode(str(path))
        conv, cmode = image_io.decode(str(path), "RGB")
        size = image_io.image_size(str(path))
    want, want_mode = _pillow(path.read_bytes())
    assert mode == want_mode
    _same(arr, want)
    assert cmode == "RGB"
    _same(conv, np.asarray(Image.open(path).convert("RGB")))
    assert size == Image.open(path).size == (11, 9)
    ico = tmp_path / "x.ico"
    Image.fromarray(rgb).save(ico)
    with pil_blocked(), pytest.raises(RuntimeError, match="x.ico.*item 10"):
        image_io.decode(str(ico))


def test_plte_of_a_grey_png_is_ignored():
    """PngImagePlugin keeps a PLTE chunk for palette images only: a grey
    PNG carrying one converts as grey (a GIF keeps its hidden palette)."""
    data = mf.png_bytes(mf.seeded(7, 9, 1, 3), 8, 0, palette=mf._palette(256, 3))
    for c in CONVERTS:
        with pil_blocked():
            arr, mode = image_io.decode_bytes(data, c)
        want, want_mode = _pillow(data, c)
        assert mode == want_mode
        _same(arr, want)


@pytest.mark.parametrize("name", ["gif_frame_grows_screen_57x32.gif", "orientation6_37x23.tif",
                                  "rgb_bigtiff_deflate_37x23.tif", "lossy_rgb_q80_43x29.webp",
                                  "lossless_rgba_exact_43x29.webp",
                                  "anim_lossless_offset_60x50.webp"])
def test_image_size_reads_gif_tiff_webp_headers(name):
    """``image_size`` (the calibration tools' and ``dataset_check``'s) of a
    GIF whose frame grows its screen, a TIFF whose Orientation swaps its
    sides, a BigTIFF, and simple and animated WebPs: ``Image.open(f).size``
    from the headers, PIL blocked."""
    with pil_blocked():
        size = image_io.image_size(str(FIXTURES / name))
    assert size == Image.open(FIXTURES / name).size


@pytest.mark.parametrize("kind", ["bool", "uint16", "la", "p2-palette"])
def test_write_png_writes_what_pillow_reads_back(tmp_path, kind):
    """``write_png`` of mode 1 (bool), I;16 (uint16), LA and a small palette
    (the dataset tools' flips of such masks) reads back in Pillow as the
    same array and mode; the palette image in Pillow's bytes (indices at
    2 bits, rows filtered as Pillow's encoder filters them)."""
    rng = np.random.default_rng(3)
    palette = None
    arr = {"bool": lambda: rng.integers(0, 2, (13, 17)).astype(bool),
           "uint16": lambda: rng.integers(0, 65536, (13, 17)).astype(np.uint16),
           "la": lambda: rng.integers(0, 256, (13, 17, 2), dtype=np.uint8),
           "p2-palette": lambda: rng.integers(0, 4, (13, 17), dtype=np.uint8)}[kind]()
    if kind == "p2-palette":
        palette = rng.integers(0, 256, 12).tolist()
    image_io.write_png(str(tmp_path / "a.png"), arr, palette=palette)
    with Image.open(tmp_path / "a.png") as img:
        assert img.mode == {"bool": "1", "uint16": "I;16", "la": "LA", "p2-palette": "P"}[kind]
        np.testing.assert_array_equal(np.asarray(img), arr)
    with pil_blocked():
        back, _ = image_io.decode(str(tmp_path / "a.png"))
    np.testing.assert_array_equal(back, arr)
    if palette is not None:
        img = Image.frombytes("P", arr.shape[::-1], arr.tobytes())
        img.putpalette(palette)
        img.save(tmp_path / "b.png")
        assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), seed=st.integers(0, 2**16),
       kind=st.sampled_from(["L", "LA", "RGB", "RGBA", "1", "I;16"]), smooth=st.booleans())
def test_save_image_writes_pillows_png_bytes(tmp_path_factory, h, w, seed, kind, smooth):
    """``save_image(x.png, a)`` writes the bytes of ``Image.fromarray(a).save``
    for every mode: each row's filter picked as Pillow's encoder picks it
    (none, Up, Sub, Paeth by the sum of the signed bytes), zlib's filtered
    strategy; smooth images make each filter win somewhere."""
    rng = np.random.default_rng(seed)
    channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "1": 1, "I;16": 1}[kind]
    top = {"1": 1, "I;16": 65535}.get(kind, 255)
    arr = mf.seeded(h, w, channels, seed, top) if smooth else \
        rng.integers(0, top + 1, (h, w, channels)[:2 if channels == 1 else 3])
    arr = arr.astype(bool if kind == "1" else np.uint16 if kind == "I;16" else np.uint8)
    path = tmp_path_factory.mktemp("png") / "a.png"
    with pil_blocked():
        image_io.save_image(str(path), arr)
    ref = io.BytesIO()
    Image.fromarray(arr).save(ref, "PNG")
    assert path.read_bytes() == ref.getvalue()


def test_read_palette_of_sub_byte_palettes():
    """``read_palette`` of 2 and 4-bit palette PNGs and a palette BMP:
    Pillow's palette entries, as ``write_png`` takes them."""
    for name in ("p2_trns_bytes_31x19.png", "p4_trns_index_27x33.png", "pillow_p_39x25.bmp"):
        with pil_blocked():
            pal = image_io.read_palette(str(FIXTURES / name))
        with Image.open(FIXTURES / name) as img:
            want = img.getpalette()
        assert pal == want[:len(pal)] and len(pal) % 3 == 0, name
    assert image_io.read_palette(str(FIXTURES / "rgb16_37x45.png")) is None


def test_adam7_frames_in_threads():
    """Eight threads decode the Adam7 fixtures at once (the anti-diagonal
    unfilter runs one pass at a time under its lock): every array right."""
    import threading

    names = [n for n in sorted(MANIFEST["decode"]) if n.startswith("adam7")]
    data = {n: (FIXTURES / n).read_bytes() for n in names}
    bad = []

    def work(k):
        for n in names[k % 3:]:
            arr, _ = image_io.decode_bytes(data[n])
            if _digest(arr) != MANIFEST["decode"][n]["sha256"]:
                bad.append(n)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not bad and len(names) >= 15


_NO_PIL = r"""
import hashlib, importlib.abc, json, os, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("PIL is blocked")

sys.meta_path.insert(0, _Block())
sys.path.insert(0, sys.argv[1])
import numpy as np
import make_fixtures as mf
from fastscnn_tpu_torch.data import image_io
fixtures, out = sys.argv[1], sys.argv[2]
manifest = json.load(open(os.path.join(fixtures, "manifest.json")))
digest = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
for name, entry in manifest["decode"].items():
    arr, mode = image_io.decode(os.path.join(fixtures, name))
    assert (digest(arr), mode) == (entry["sha256"], entry["mode"]), name
    for c, ce in entry["convert"].items():
        assert digest(image_io.read_image(os.path.join(fixtures, name), c)) == ce["sha256"], (name, c)
for k, w in enumerate(manifest["write"]):
    path = os.path.join(out, f"{k}.bmp")
    image_io.save_image(path, mf.write_input(w["kind"], w["shape"], w["channels"], w["seed"]))
    assert hashlib.sha256(open(path, "rb").read()).hexdigest() == w["sha256"], w
assert "PIL" not in sys.modules
print("ok", len(manifest["decode"]), len(manifest["write"]))
"""


def test_no_image_reaches_pil(tmp_path):
    """In a process where PIL cannot be imported, ``image_io`` decodes and
    converts every fixture and writes every BMP to the manifest."""
    proc = subprocess.run([sys.executable, "-c", _NO_PIL, str(FIXTURES), str(tmp_path)],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok", str(len(MANIFEST["decode"])),
                                   str(len(MANIFEST["write"]))]


# --- the loaders and the calibration directory against the JAX package -----------------


@pytest.fixture
def mask_tree(tmp_path):
    """A custom-dataset tree whose masks are Adam7, 1-bit, 16-bit, LA and
    2-bit palette PNGs (images PNG, 16-bit PNG and JPEG), and a calibration
    directory listing BMPs (24-bit, grey, RLE8 palette, bitfields) beside
    a 16-bit PNG and a JPEG."""
    root = tmp_path / "custom"
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir()
    h, w = 40, 56
    for i in range(6):
        rgb = mf.seeded(h, w, 3, 300 + i)
        lane = mf.seeded(h, w, 1, 310 + i) > 128
        img = root / "images" / f"f{i}.{('png', 'jpg', 'png')[i % 3]}"
        if i % 3 == 2:
            img.write_bytes(mf.png_bytes(rgb.astype(np.uint16) * 257, 16, 2, interlace=True))
        else:
            Image.fromarray(rgb).save(img)
        masks = [mf.png_bytes(lane * 255, 8, 0, interlace=True),
                 mf.png_bytes(lane, 1, 0),
                 mf.png_bytes(lane.astype(np.uint16) * 40000, 16, 0),
                 mf.png_bytes(np.stack([lane * 200, lane * 0 + 255], -1), 8, 4, interlace=True),
                 mf.png_bytes(lane * 3, 2, 3, mf._palette(4, i)),
                 mf.png_bytes(lane * 255, 8, 0)]
        (root / "masks" / f"f{i}.png").write_bytes(masks[i])
    calib = tmp_path / "calib"
    calib.mkdir()
    for i in range(3):
        rgb = mf.seeded(30 + i, 50 + i, 3, 320 + i)
        Image.fromarray(rgb).save(calib / f"a{i}.bmp")
        Image.fromarray(rgb[..., 1]).save(calib / f"b{i}.BMP")
        (calib / f"c{i}.png").write_bytes(mf.png_bytes(rgb.astype(np.uint16) * 257, 16, 2))
        Image.fromarray(rgb).save(calib / f"d{i}.jpg")
    for name in ("rle8_35x29.bmp", "bitfields565_31x23.bmp", "bitfields_bgra_v4_27x21.bmp"):
        (calib / name).write_bytes((FIXTURES / name).read_bytes())
    return str(root), str(calib)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("mode", ["train", "val", "testval", "device-aug"])
def test_custom_items_equal_jax_on_every_mask_format(mask_tree, tmp_path, monkeypatch, mode,
                                                     cached):
    """The port's ``custom`` dataset reads the tree without PIL, through
    the decoded cache or not, and every item equals the JAX dataset's
    (through Pillow), bit for bit, the global ``random`` seeded alike."""
    import random

    from fastscnn_tpu.data import decoded_cache as jax_cache
    from fastscnn_tpu.data import get_segmentation_dataset as jax_dataset
    from fastscnn_tpu_torch.data import decoded_cache, get_segmentation_dataset

    for mod, sub in ((jax_cache, "jax"), (decoded_cache, "port")):
        monkeypatch.setattr(mod, "_cache_dir", str(tmp_path / f"cache_{sub}") if cached else None)
        if cached:
            os_dir = tmp_path / f"cache_{sub}"
            os_dir.mkdir(exist_ok=True)
    kw = dict(root=mask_tree[0], split="all", mode=mode, base_size=40, crop_size=32)
    theirs = jax_dataset("custom", **kw)
    for rnd in range(1 + cached):  # a second round reads the cache's entries
        with pil_blocked():
            ours = get_segmentation_dataset("custom", **kw)
            items = []
            for i in range(len(ours)):
                random.seed(2000 + i)
                items.append(ours[i])
        assert len(items) == len(theirs) == 6
        for i, (a_img, a_mask) in enumerate(items):
            random.seed(2000 + i)
            b_img, b_mask = theirs[i]
            np.testing.assert_array_equal(a_img, b_img)
            assert a_mask.dtype == b_mask.dtype == np.int32
            np.testing.assert_array_equal(a_mask, b_mask)


def test_calibration_batches_equal_jax_on_bmp_directories(mask_tree):
    """``export_model``'s int8 calibration batches from a directory of BMPs
    (24-bit, grey, RLE8 palette, bitfields; ``.bmp`` and ``.BMP``), 16-bit
    PNGs and JPEGs: the JAX package's batches (Pillow's decode and
    bilinear resize) bit for bit, with PIL blocked for the port."""
    from fastscnn_tpu import export_model as jax_export
    from fastscnn_tpu_torch import export_model

    with pil_blocked():
        ours = export_model._calibration_batches(mask_tree[1], (3, 24, 40, 3),
                                                 np.random.default_rng(0))
    theirs = jax_export._calibration_batches(mask_tree[1], (3, 24, 40, 3),
                                             np.random.default_rng(0))
    assert len(ours) == len(theirs) == 5
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
