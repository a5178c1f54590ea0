"""The port's JPEG codec (``data/jpeg.cpp`` through ``data/jpeg.py``)
against Pillow on libjpeg-turbo, and its wiring into ``image_io`` and
the datasets.

Every comparison is exact: the decoder gives Pillow's pixels and the
encoder Pillow's bytes. The committed fixtures (``tests/fixtures/jpeg``,
written by ``make_fixtures.py`` with Pillow) are held to their manifest,
which the card's smoke script checks too.
"""

import hashlib
import io
import json
import random
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from fastscnn_tpu.data import get_segmentation_dataset as jax_dataset
from fastscnn_tpu_torch.data import get_segmentation_dataset, image_io, jpeg

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
REPO = Path(__file__).resolve().parents[1]


def _image(seed: int, h: int, w: int, mode: str) -> np.ndarray:
    """A gradient with seeded noise: smooth and busy blocks both."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x * 7 + y * 3) % 256],
                    axis=-1)
    arr = np.clip(base + rng.integers(-60, 61, base.shape), 0, 255).astype(np.uint8)
    return arr[..., 1].copy() if mode == "L" else arr


def _pillow_jpeg(arr: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _digest(data) -> str:
    return hashlib.sha256(data).hexdigest()


# --- decoder ----------------------------------------------------------------------------


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**16), h=st.integers(1, 64), w=st.integers(1, 64),
       mode=st.sampled_from(["L", "RGB"]), subsampling=st.sampled_from([0, 1, 2]),
       quality=st.integers(1, 100), progressive=st.booleans(),
       restart=st.sampled_from([0, 1, 3]))
def test_decode_equals_pillow(seed, h, w, mode, subsampling, quality, progressive, restart):
    """Every pixel of ``np.asarray(Image.open(f))``, over sizes, modes,
    4:4:4 / 4:2:2 / 4:2:0, quality, progressive and restart intervals."""
    kw = {"quality": quality, "progressive": progressive}
    if mode == "RGB":
        kw["subsampling"] = subsampling
    if restart:
        kw["restart_marker_blocks"] = restart
    data = _pillow_jpeg(_image(seed, h, w, mode), **kw)
    got, got_mode = jpeg.decode_jpeg(data)
    with Image.open(io.BytesIO(data)) as img:
        assert got_mode == img.mode
        np.testing.assert_array_equal(got, np.asarray(img))


@pytest.mark.parametrize("name", sorted(MANIFEST["decode"]))
def test_fixtures_decode_to_the_manifest(name):
    """Each committed fixture (the 1280x720 4:2:0 quality-90 frame too)
    decodes to Pillow's pixels here and to the manifest's digest."""
    data = (FIXTURES / name).read_bytes()
    entry = MANIFEST["decode"][name]
    got, mode = jpeg.decode_jpeg(data, name)
    assert [mode, list(got.shape)] == [entry["mode"], entry["shape"]]
    assert _digest(got.tobytes()) == entry["sha256"]
    np.testing.assert_array_equal(got, np.asarray(Image.open(FIXTURES / name)))


# --- encoder ----------------------------------------------------------------------------


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**16), h=st.integers(1, 64), w=st.integers(1, 64),
       mode=st.sampled_from(["L", "RGB"]), quality=st.sampled_from([None, 75, 90, 95]))
def test_encode_equals_pillow(seed, h, w, mode, quality):
    """The bytes of ``Image.fromarray(a).save(f, "JPEG", quality=q)``; no
    quality is Pillow's default, 75."""
    arr = _image(seed, h, w, mode)
    if quality is None:
        assert jpeg.encode_jpeg(arr) == _pillow_jpeg(arr)
    else:
        assert jpeg.encode_jpeg(arr, quality) == _pillow_jpeg(arr, quality=quality)


@pytest.mark.parametrize("entry", MANIFEST["encode"], ids=lambda e: f"{e['input']}-q{e['quality']}")
def test_encoder_matches_the_manifest(entry):
    """Each seeded input (and the frame's pixels) encodes to the digest of
    Pillow's bytes in the manifest."""
    arr = np.asarray(Image.open(FIXTURES / entry["input"]))
    assert _digest(jpeg.encode_jpeg(arr, entry["quality"])) == entry["sha256"]


def test_encode_refuses_what_pillow_cannot_write_as_jpeg():
    with pytest.raises(TypeError, match="uint8"):
        jpeg.encode_jpeg(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="arrays"):
        jpeg.encode_jpeg(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError, match="pixels a side"):
        jpeg.encode_jpeg(np.zeros((0, 4), np.uint8))


# --- variants: decoded where Pillow decodes, refused where Pillow refuses ------------------


def _patched(data: bytes, old: bytes, new: bytes) -> bytes:
    i = data.index(old)
    return data[:i] + new + data[i + len(old):]


def _pillow_or_error(data: bytes):
    try:
        with Image.open(io.BytesIO(data)) as img:
            img.load()
            return np.asarray(img), img.mode
    except Exception as e:  # Pillow's refusal, to compare with the port's
        return e


def _variants() -> dict:
    """name -> (bytes, what the refusal names, or the fixture of a valid
    file of that variant)."""
    rgb = _pillow_jpeg(_image(0, 24, 40, "RGB"), quality=80)
    sof = rgb.index(b"\xff\xc0")
    sos = rgb.index(b"\xff\xda")
    return {
        # a Huffman-coded file under SOF9: libjpeg-turbo decodes its bits as
        # arithmetic-coded data, and so does the port, to the same pixels
        "arithmetic": (rgb[:sof] + b"\xff\xc9" + rgb[sof + 2:], "arith_rgb420_q75_45x37.jpg"),
        "lossless": (rgb[:sof] + b"\xff\xc3" + rgb[sof + 2:], "lossless"),
        "12-bit": (rgb[:sof + 4] + b"\x0c" + rgb[sof + 5:], "12-bit samples"),
        # Y sampled 4x1, Cb and Cr 1x1: 4:1:1 over 4:2:0 data
        "4:1:1": (_patched(rgb, b"\x01\x22\x00", b"\x01\x41\x00"), "rgb411_q80_45x37.jpg"),
        "cmyk": (None, "cmyk_adobe_q85_33x41.jpg"),
        "truncated": (rgb[:sos + (len(rgb) - sos) // 2], "truncated"),
        "no-eoi": (rgb[:-2], "truncated"),
    }


@pytest.mark.parametrize("variant", ["arithmetic", "lossless", "12-bit", "4:1:1", "cmyk",
                                     "truncated", "no-eoi"])
def test_refused_variants_raise_naming_the_item(variant):
    """Arithmetic coding, 4:1:1 sampling and CMYK, which Pillow decodes
    through libjpeg-turbo, decode to Pillow's pixels: the committed
    fixture of each (held to the manifest too) and, for the first two,
    the hand-patched file (Huffman data under SOF9; 4:2:0 data under 4:1:1
    factors), which Pillow decodes as well. A hand-patched lossless frame
    (a DCT scan's parameters), 12-bit samples, a truncated scan and a
    missing EOI, which Pillow refuses, raise a ValueError naming the
    variant and the ROADMAP item; none goes to PIL."""
    data, why = _variants()[variant]
    if why.endswith(".jpg"):
        for blob in (data, (FIXTURES / why).read_bytes()):
            if blob is None:
                continue
            want = _pillow_or_error(blob)
            assert not isinstance(want, Exception), want
            got, mode = jpeg.decode_jpeg(blob)
            assert mode == want[1]
            np.testing.assert_array_equal(got, want[0])
        return
    assert isinstance(_pillow_or_error(data), Exception)  # Pillow refuses the same bytes
    with pytest.raises(ValueError, match=why) as e:
        jpeg.decode_jpeg(data)
    assert "item 10: formats only PIL reads" in str(e.value)
    with pytest.raises(ValueError, match="item 10"):
        image_io.decode_bytes(data, "RGB")


def _spec_refusals() -> dict:
    """Variants Pillow refuses, written from T.81: name -> (bytes, what
    the port's refusal names)."""
    sys.path.insert(0, str(FIXTURES))
    import spec_writers as sw

    rgb = _image(4, 21, 27, "RGB")
    grey = _image(5, 21, 27, "L")
    planes = [rgb[..., i] for i in range(3)]
    header = b"\xff\xc1\x00\x0b\x08\x00\x15"  # SOF1, one component, height 21
    one = sw.dct_jpeg([grey], [(1, 1)])
    return {
        "two components": (sw.dct_jpeg(planes[:2], [(1, 1), (1, 1)]), "2 components"),
        "fractional sampling 3x1/2x1": (sw.dct_jpeg(planes, [(3, 1), (2, 1), (1, 1)], jfif=True),
                                        "fractional"),
        "lossless YCbCr": (sw.lossless_jpeg(planes, jfif=True), "lossless YCbCr"),
        "lossless arithmetic (SOF11)": (_patched(sw.lossless_jpeg([grey]), b"\xff\xc3",
                                                 b"\xff\xcb"), "SOF11"),
        "hierarchical (SOF5)": (_patched(one, b"\xff\xc1", b"\xff\xc5"), "hierarchical"),
        "DNL height": (_patched(one, header, header[:-2] + b"\x00\x00"), "DNL"),
        "16-bit samples": (_patched(one, header, header[:4] + b"\x10" + header[5:]), "16-bit"),
        "arithmetic, truncated": (sw.dct_jpeg(planes, [(2, 2), (1, 1), (1, 1)], jfif=True,
                                              coding="arith")[:300], "truncated"),
        "lossless, truncated": (sw.lossless_jpeg([grey])[:200], "truncated"),
    }


@pytest.mark.parametrize("variant", ["two components", "fractional sampling 3x1/2x1",
                                     "lossless YCbCr", "lossless arithmetic (SOF11)",
                                     "hierarchical (SOF5)", "DNL height", "16-bit samples",
                                     "arithmetic, truncated", "lossless, truncated"])
def test_what_pillow_refuses_the_codec_refuses(variant):
    """Each variant libjpeg-turbo or Pillow refuses here (2 components, a
    fractional upsampling ratio, a lossless frame that needs a colour
    conversion, lossless arithmetic coding, hierarchical frames, a DNL
    height, 16-bit samples, truncated arithmetic and lossless scans):
    Pillow raises on the bytes, and the codec raises a ValueError naming
    the variant and the ROADMAP item."""
    data, why = _spec_refusals()[variant]
    assert isinstance(_pillow_or_error(data), Exception)
    with pytest.raises(ValueError, match=f"{why}.*item 10"):
        jpeg.decode_jpeg(data)


# --- image_io: converts, threads, no PIL ------------------------------------------------


@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("convert", [None, "RGB", "L", "RGBA"])
def test_image_io_converts_jpegs_as_pillow(tmp_path, mode, convert):
    path = tmp_path / "x.jpg"
    path.write_bytes(_pillow_jpeg(_image(3, 19, 27, mode), quality=70))
    arr, got_mode = image_io.decode(str(path), convert)
    with Image.open(path) as img:
        ref = img.convert(convert) if convert else img
        assert got_mode == ref.mode
        np.testing.assert_array_equal(arr, np.asarray(ref))
    with pytest.raises(ValueError, match="convert='P' of a JPEG.*item 10"):
        image_io.decode(str(path), "P")


def test_save_image_writes_pillows_jpeg_bytes(tmp_path):
    arr = _image(5, 30, 41, "RGB")
    image_io.save_image(str(tmp_path / "a.jpg"), arr)
    image_io.save_image(str(tmp_path / "b.JPEG"), arr[..., 0])
    assert (tmp_path / "a.jpg").read_bytes() == _pillow_jpeg(arr)
    assert (tmp_path / "b.JPEG").read_bytes() == _pillow_jpeg(arr[..., 0].copy())


def test_threads_decode_at_once():
    """Eight threads decode the fixtures at once (the codec releases the
    interpreter lock): every array is right."""
    names = sorted(MANIFEST["decode"])
    data = {n: (FIXTURES / n).read_bytes() for n in names}
    bad = []

    def work(k):
        for n in names[k % 3:]:
            arr, _ = jpeg.decode_jpeg(data[n])
            if _digest(arr.tobytes()) != MANIFEST["decode"][n]["sha256"]:
                bad.append(n)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not bad


_NO_PIL = r"""
import hashlib, importlib.abc, json, os, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("PIL is blocked")

sys.meta_path.insert(0, _Block())
from fastscnn_tpu_torch.data import image_io, jpeg
fixtures, out = sys.argv[1], sys.argv[2]
manifest = json.load(open(os.path.join(fixtures, "manifest.json")))
for name, entry in manifest["decode"].items():
    arr = image_io.read_image(os.path.join(fixtures, name))
    assert hashlib.sha256(arr.tobytes()).hexdigest() == entry["sha256"], name
for k, entry in enumerate(manifest["encode"]):
    arr = image_io.read_image(os.path.join(fixtures, entry["input"]))
    path = os.path.join(out, f"{k}.jpg")
    if entry["quality"] == 75:  # save_image writes at Pillow's default quality
        image_io.save_image(path, arr)
    else:
        open(path, "wb").write(jpeg.encode_jpeg(arr, entry["quality"]))
    assert hashlib.sha256(open(path, "rb").read()).hexdigest() == entry["sha256"], entry
assert "PIL" not in sys.modules
print("ok", len(manifest["decode"]), len(manifest["encode"]))
"""


def test_no_jpeg_reaches_pil(tmp_path):
    """In a process where PIL cannot be imported, ``image_io`` decodes
    every fixture and encodes every seeded input to the manifest."""
    proc = subprocess.run([sys.executable, "-c", _NO_PIL, str(FIXTURES), str(tmp_path)],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["ok", str(len(MANIFEST["decode"])),
                                   str(len(MANIFEST["encode"]))]


def test_the_codec_loads_without_torch():
    """The data loader's worker processes decode without importing torch:
    the codec, its build helper and the serial bridge (which shares it)
    load without it."""
    code = ("import sys\n"
            "from fastscnn_tpu_torch.data import jpeg\n"
            "import fastscnn_tpu_torch.serialbridge\n"
            "jpeg.load_codec()\n"
            "assert 'torch' not in sys.modules, 'torch was imported'\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr


# --- the datasets on JPEG trees ---------------------------------------------------------


def _jpeg_tree(root: Path, name: str) -> dict:
    rng = np.random.default_rng(7)
    img = lambda h, w: _image(int(rng.integers(1 << 16)), h, w, "RGB")  # noqa: E731
    if name == "tusimple":
        clips, seg = root / "train_set" / "clips" / "r1", root / "train_set" / "seg_label" / "r1"
        lst = root / "train_set" / "seg_label" / "list"
        for d in (clips, seg, lst):
            d.mkdir(parents=True)
        lines = []
        for i in range(4):
            Image.fromarray(img(45, 80)).save(clips / f"{i}.jpg", quality=90)
            label = (rng.random((45, 80)) < 0.2).astype(np.uint8) * 3
            Image.fromarray(label).save(seg / f"{i}.png")
            lines.append(f"/clips/r1/{i}.jpg /seg_label/r1/{i}.png 1 1\n")
        (lst / "train_val_gt.txt").write_text("".join(lines))
        return {"root": str(root)}
    if name == "bdd100k":
        for split in ("train", "val"):
            (root / "images" / "100k" / split).mkdir(parents=True)
            (root / "drivable_maps" / "labels" / split).mkdir(parents=True)
            for i in range(3):
                Image.fromarray(img(36, 64)).save(
                    root / "images" / "100k" / split / f"img{i:04d}.jpg", quality=90)
                Image.fromarray(rng.choice([0, 1, 2], size=(36, 64)).astype(np.uint8)).save(
                    root / "drivable_maps" / "labels" / split / f"img{i:04d}_drivable_id.png")
        return {"root": str(root), "split": "val"}
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir()
    for i in range(4):
        Image.fromarray(img(48, 64)).save(root / "images" / f"f{i}.jpeg" if i % 2 else
                                          root / "images" / f"f{i}.jpg")
        Image.fromarray((rng.random((48, 64)) < 0.5).astype(np.uint8) * 255).save(
            root / "masks" / f"f{i}.png")
    return {"root": str(root), "split": "all"}


@pytest.mark.parametrize("name", ["tusimple", "bdd100k", "custom"])
def test_datasets_read_jpeg_trees_through_the_codec(tmp_path, monkeypatch, name):
    """The port's val items equal the JAX dataset's on a JPEG tree, with
    the port's PIL route shut: every image went through the codec."""
    kw = dict(_jpeg_tree(tmp_path / name, name), mode="val", base_size=40, crop_size=32)
    theirs = jax_dataset(name, **kw)
    calls = []
    decode = jpeg.decode_jpeg

    def counted(data, name="<bytes>"):
        calls.append(name)
        return decode(data, name)

    def no_pil(*a, **k):
        raise AssertionError("a dataset image went to PIL")

    monkeypatch.setattr(image_io, "decode_jpeg", counted)
    monkeypatch.setattr(image_io, "_decode_with_pil", no_pil)
    ours = get_segmentation_dataset(name, **kw)
    assert len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        random.seed(i)
        a = ours[i]
        random.seed(i)
        b = theirs[i]
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
    assert len(calls) == len(ours) and all(c.endswith((".jpg", ".jpeg")) for c in calls)
