"""The port's input pipeline against the JAX package's: PNG decoding,
the decoded cache, the four datasets in every mode, the host transforms
and the threaded loader. Every comparison here is exact (bit for bit):
the port reads PNGs and JPEGs without PIL, and where it uses PIL (the
host transforms) it runs the JAX package's PIL calls on the same
pixels.

Protocol for the host augmentation: both datasets draw from the
module-global ``random``; it is seeded the same way before each item.
"""

import os
import random
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from fastscnn_tpu.data import DataLoader as JaxLoader
from fastscnn_tpu.data import decoded_cache as jax_cache
from fastscnn_tpu.data import get_segmentation_dataset as jax_dataset
from fastscnn_tpu.data.custom import _train_test_split as jax_split
from fastscnn_tpu_torch.data import (
    DataLoader,
    decoded_cache,
    get_segmentation_dataset,
    image_io,
    narrow_labels,
)
from fastscnn_tpu_torch.data.custom import _train_test_split

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes here are small, and under the
    suite's parallel workers the default pool's spinning threads take the
    cores the other workers need."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- a PNG writer with chosen row filters (PIL picks its own) ----------------


def _filter_rows(arr: np.ndarray, kinds) -> np.ndarray:
    """(H, W[, C]) uint8 → (H, 1 + W·C) filtered scanlines, row r filtered
    with ``kinds[r % len(kinds)]``."""
    h = arr.shape[0]
    bpp = 1 if arr.ndim == 2 else arr.shape[2]
    x = arr.reshape(h, -1).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, paeth]
    out = np.empty((h, x.shape[1] + 1), np.uint8)
    for r in range(h):
        k = kinds[r % len(kinds)]
        out[r, 0] = k
        out[r, 1:] = (x[r] - preds[k][r]) & 255
    return out


def write_png(path, arr: np.ndarray, kinds=(0, 1, 2, 3, 4), palette=None):
    """An 8-bit PNG of ``arr`` (L, RGB or RGBA by its channels; P with a
    ``palette``), its rows filtered by ``kinds`` in turn."""
    chunks = []
    h, w = arr.shape[:2]
    colour = {1: 0, 3: 2, 4: 6}[1 if arr.ndim == 2 else arr.shape[2]]
    if palette is not None:
        colour = 3
        chunks.append((b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    chunks.insert(0, (b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)))
    raw = zlib.compress(_filter_rows(arr, kinds).tobytes(), 6)
    # two IDAT chunks: the reader must join them
    chunks += [(b"IDAT", raw[:len(raw) // 2]), (b"IDAT", raw[len(raw) // 2:]), (b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(image_io.PNG_SIGNATURE)
        for kind, body in chunks:
            f.write(struct.pack(">I", len(body)) + kind + body
                    + struct.pack(">I", zlib.crc32(kind + body)))


# --- image_io ------------------------------------------------------------------


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 3, 1)])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_rows_of_every_filter_decode_exactly(tmp_path, kinds, channels):
    """Every row filter alone and mixed, for L, RGB and RGBA: the decode
    equals the array written, and PIL's decode of the same file."""
    rng = np.random.default_rng(channels * 10 + len(kinds))
    shape = (23, 37) if channels == 1 else (23, 37, channels)
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    arr[5:9] = 255  # runs that wrap in the Sub and Up sums
    path = str(tmp_path / "x.png")
    write_png(path, arr, kinds)
    got, mode = image_io.decode(path)
    assert got.dtype == np.uint8 and mode == {1: "L", 3: "RGB", 4: "RGBA"}[channels]
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))


@pytest.mark.parametrize("mode", ["RGB", "L", "P", "RGBA"])
def test_read_image_equals_pil_on_pil_written_pngs(tmp_path, mode):
    """PIL's own files (its adaptive filters) read as ``np.asarray(Image.open)``,
    and ``convert='RGB'`` as PIL converts (a palette of 5 colours with
    indices up to 11: the missing entries read black, as in PIL)."""
    rng = np.random.default_rng(len(mode))
    if mode == "P":
        img = Image.fromarray(rng.integers(0, 12, (40, 70), dtype=np.uint8), "P")
        img.putpalette([10, 20, 30, 40, 50, 60, 70, 80, 90, 1, 2, 3, 4, 5, 6])
    else:
        shape = (40, 70) if mode == "L" else (40, 70, len(mode))
        img = Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode)
    path = str(tmp_path / "x.png")
    img.save(path)
    np.testing.assert_array_equal(image_io.read_image(path), np.asarray(Image.open(path)))
    np.testing.assert_array_equal(image_io.read_image(path, "RGB"),
                                  np.asarray(Image.open(path).convert("RGB")))
    write_png(str(tmp_path / "y.png"), np.asarray(img), palette=img.getpalette()[:15]
              if mode == "P" else None)
    np.testing.assert_array_equal(image_io.read_image(str(tmp_path / "y.png"), "RGB"),
                                  np.asarray(Image.open(path).convert("RGB")))


def test_other_files_go_through_pil_and_raise_without_it(tmp_path, monkeypatch):
    """A 16-bit PNG is PIL's; without PIL it raises a RuntimeError naming
    the file and the item of the formats only PIL reads (no silent skip).
    A JPEG is the port's codec's, with PIL or without."""
    rng = np.random.default_rng(0)
    jpg, deep = str(tmp_path / "x.jpg"), str(tmp_path / "d.png")
    Image.fromarray(rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)).save(jpg)
    Image.fromarray((np.arange(24 * 32).reshape(24, 32) * 37).astype(np.uint16)).save(deep)
    for path in (jpg, deep):
        arr, mode = image_io.decode(path)
        assert mode == Image.open(path).mode
        np.testing.assert_array_equal(arr, np.asarray(Image.open(path)))
    np.testing.assert_array_equal(image_io.read_image(jpg, "L"),
                                  np.asarray(Image.open(jpg).convert("L")))
    png = str(tmp_path / "ok.png")
    write_png(png, rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert image_io.read_image(png).shape == (8, 8, 3)  # no PIL needed
    assert image_io.read_image(jpg).shape == (24, 32, 3)  # nor for a JPEG
    with pytest.raises(RuntimeError, match="d.png.*PIL.*item 10: formats only PIL reads"):
        image_io.read_image(deep)


def test_threads_decoding_at_once_get_every_image_right(tmp_path):
    """More decoding threads than cores on PNGs of every filter mix (the
    anti-diagonal loop runs one thread at a time), with a short switch
    interval; bounded in time."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(0)
    arrays, paths = [], []
    for i in range(24):
        arrays.append(rng.integers(0, 256, (17, 29, 3), dtype=np.uint8))
        paths.append(str(tmp_path / f"{i}.png"))
        write_png(paths[-1], arrays[-1], kinds=[(0, 1, 2), (4,), (3, 0), (0, 1, 2, 3, 4)][i % 4])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(2 * (os.cpu_count() or 1) + 2) as pool:
            results = list(pool.map(image_io.read_image, paths * 4, timeout=120))
    finally:
        sys.setswitchinterval(interval)
    for got, want in zip(results, arrays * 4):
        np.testing.assert_array_equal(got, want)
    assert not image_io._DIAGONALS.locked()


def test_corrupt_and_malformed_pngs_raise(tmp_path):
    path = str(tmp_path / "x.png")
    write_png(path, np.zeros((4, 4), np.uint8))
    data = bytearray(open(path, "rb").read())
    data[40] ^= 0xFF  # the type of the first IDAT chunk: its CRC no longer holds
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC|truncated"):
        image_io.read_image(path)
    rows = np.zeros((2, 5), np.uint8)
    with pytest.raises(ValueError, match="filter"):
        image_io.unfilter(rows[:, 1:], np.array([0, 7], np.uint8), 1)


# --- the decoded cache ---------------------------------------------------------


@pytest.fixture()
def fresh_caches(monkeypatch):
    """Both packages' caches off and their counts at 0 for the test."""
    for mod in (jax_cache, decoded_cache):
        monkeypatch.setattr(mod, "_cache_dir", None)
        monkeypatch.setattr(mod, "_hits", 0)
        monkeypatch.setattr(mod, "_misses", 0)


def test_decoded_cache_entries_cross_both_ways(tmp_path, fresh_caches):
    """An entry written by the JAX cache is a hit in the port's, and the
    other way round, for an RGB image, an L label and a P label; ``stats()``
    counts each package's hits and misses."""
    rng = np.random.default_rng(0)
    files = {}
    for name, arr, pal in (("rgb", rng.integers(0, 256, (30, 40, 3), dtype=np.uint8), None),
                           ("lab", rng.integers(0, 34, (30, 40), dtype=np.uint8), None),
                           ("pal", rng.integers(0, 4, (30, 40), dtype=np.uint8), [9] * 12)):
        files[name] = str(tmp_path / f"{name}.png")
        write_png(files[name], arr, palette=pal)
    for writer, reader in ((jax_cache, decoded_cache), (decoded_cache, jax_cache)):
        cache_dir = str(tmp_path / f"cache_{writer.__name__.split('.')[0]}")
        writer.set_cache_dir(cache_dir)
        reader.set_cache_dir(cache_dir)
        first = [np.asarray(writer.open_rgb(files["rgb"])),
                 np.asarray(writer.open_image(files["lab"])),
                 np.asarray(writer.open_image(files["pal"]))]
        assert writer.stats()["misses"] == 3 and len(os.listdir(cache_dir)) == 3
        hits = reader.stats()["hits"]
        again = [np.asarray(reader.open_rgb(files["rgb"])),
                 np.asarray(reader.open_image(files["lab"])),
                 np.asarray(reader.open_image(files["pal"]))]
        assert reader.stats()["hits"] == hits + 3 and len(os.listdir(cache_dir)) == 3
        for a, b, name in zip(first, again, ("rgb", "lab", "pal")):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, np.asarray(Image.open(files[name]).convert("RGB"))
                                          if name == "rgb" else np.asarray(Image.open(files[name])))
    assert decoded_cache.stats() == {"hits": 3, "misses": 3, "dir": str(tmp_path / "cache_fastscnn_tpu_torch")}


def test_decoded_cache_off_decodes_and_a_changed_file_misses(tmp_path, fresh_caches):
    path = str(tmp_path / "x.png")
    write_png(path, np.full((6, 6), 3, np.uint8))
    assert decoded_cache.open_image(path).max() == 3
    assert decoded_cache.stats() == {"hits": 0, "misses": 0, "dir": None}
    decoded_cache.set_cache_dir(str(tmp_path / "c"))
    decoded_cache.open_image(path)
    decoded_cache.open_image(path)
    write_png(path, np.full((6, 6), 4, np.uint8))
    os.utime(path, ns=(1, 1))  # another mtime: a new key
    assert decoded_cache.open_image(path).max() == 4
    assert decoded_cache.stats()["hits"] == 1 and decoded_cache.stats()["misses"] == 2


# --- datasets ------------------------------------------------------------------


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Small trees of the four datasets (3-5 images, ≤ 72×128)."""
    root = tmp_path_factory.mktemp("trees")
    rng = np.random.default_rng(0)
    out = {}
    city = root / "citys"
    for split in ("train", "val"):
        for d in ("leftImg8bit", "gtFine"):
            (city / d / split / "cityA").mkdir(parents=True)
        for i in range(3):
            img = rng.integers(0, 255, (48, 96, 3), dtype=np.uint8)
            mask = rng.choice([0, 7, 8, 26, 33], size=(48, 96)).astype(np.uint8)
            Image.fromarray(img).save(city / "leftImg8bit" / split / "cityA"
                                      / f"cityA_{i:06d}_leftImg8bit.png")
            Image.fromarray(mask).save(city / "gtFine" / split / "cityA"
                                       / f"cityA_{i:06d}_gtFine_labelIds.png")
    out["citys"] = {"root": str(city)}
    tus = root / "tusimple"
    clips, seg = tus / "train_set" / "clips" / "r1", tus / "train_set" / "seg_label" / "r1"
    lst = tus / "train_set" / "seg_label" / "list"
    for d in (clips, seg, lst):
        d.mkdir(parents=True)
    lines = []
    for i in range(5):
        Image.fromarray(rng.integers(0, 255, (45, 80, 3), dtype=np.uint8)).save(clips / f"{i}.jpg")
        Image.fromarray((rng.random((45, 80)) < 0.2).astype(np.uint8) * 3).save(seg / f"{i}.png")
        lines.append(f"/clips/r1/{i}.jpg /seg_label/r1/{i}.png 1 1\n")
    (lst / "train_val_gt.txt").write_text("".join(lines))
    out["tusimple"] = {"root": str(tus)}
    bdd = root / "bdd100k"
    (bdd / "images" / "100k" / "train").mkdir(parents=True)
    (bdd / "drivable_maps" / "labels" / "train").mkdir(parents=True)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (36, 64, 3), dtype=np.uint8)).save(
            bdd / "images" / "100k" / "train" / f"img{i:04d}.jpg")
        Image.fromarray(rng.choice([0, 1, 2], size=(36, 64)).astype(np.uint8)).save(
            bdd / "drivable_maps" / "labels" / "train" / f"img{i:04d}_drivable_id.png")
    out["bdd100k"] = {"root": str(bdd), "split": "train"}
    custom = root / "custom"
    (custom / "images").mkdir(parents=True)
    (custom / "masks").mkdir()
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
            custom / "images" / f"f{i}.jpg")
        Image.fromarray((rng.random((48, 64)) < 0.5).astype(np.uint8) * 255).save(
            custom / "masks" / f"f{i}.png")
    out["custom"] = {"root": str(custom), "split": "all"}
    return out


_EXTRAS = {
    "bdd100k": [{}, {"keep_original_size": True}, {"multi_scale": True},
                {"label_type": "ternary", "max_samples": 3}],
    "custom": [{}, {"multi_scale": True}, {"keep_original_size": True}],
}


def _cases():
    for name in ("citys", "tusimple", "bdd100k", "custom"):
        for mode in ("train", "val", "testval", "device-aug", "test"):
            for k, extra in enumerate(_EXTRAS.get(name, [{}])):
                if mode == "device-aug" and extra.get("multi_scale") and name == "bdd100k":
                    continue
                yield pytest.param(name, mode, extra, id=f"{name}-{mode}-{k}")


@pytest.mark.parametrize("name,mode,extra", list(_cases()))
def test_dataset_items_equal_jax(trees, fresh_caches, name, mode, extra):
    """Every item of every mode, bit for bit: the same image, mask (or file
    name in 'test' mode), length and class count; the global ``random``
    seeded alike before each item."""
    kw = dict(trees[name], mode=mode, base_size=40, crop_size=32, **extra)
    kw.setdefault("split", "val" if mode in ("val", "testval") and name == "citys" else "train")
    ours, theirs = get_segmentation_dataset(name, **kw), jax_dataset(name, **kw)
    assert len(ours) == len(theirs) > 0 and ours.num_class == theirs.num_class
    assert ours.normalization == theirs.normalization
    assert ours.DEVICE_AUG_PAD_LABEL == theirs.DEVICE_AUG_PAD_LABEL
    assert getattr(ours, "DEVICE_AUG_CHAIN", "psp") == getattr(theirs, "DEVICE_AUG_CHAIN", "psp")
    for i in range(len(ours)):
        random.seed(1000 + i)
        a = ours[i]
        random.seed(1000 + i)
        b = theirs[i]
        np.testing.assert_array_equal(a[0], b[0])
        assert a[0].dtype == np.uint8
        if mode == "test":
            assert a[1] == b[1]
        else:
            assert a[1].dtype == np.int32 == b[1].dtype
            np.testing.assert_array_equal(a[1], b[1])


def test_bdd_multi_scale_refuses_device_aug(trees):
    ds = get_segmentation_dataset("bdd100k", **trees["bdd100k"], mode="device-aug",
                                  multi_scale=True)
    with pytest.raises(ValueError, match="multi-scale"):
        ds[0]


@pytest.mark.parametrize("n", [2, 3, 7, 10, 41])
@pytest.mark.parametrize("train_size", [0.7, 0.9])
def test_custom_split_is_the_jax_split_without_sklearn(n, train_size):
    """The JAX package calls scikit-learn's ``train_test_split`` where it is
    installed; the port's numpy form gives the same split."""
    items = [f"f{i}" for i in range(n)]
    got, want = _train_test_split(items, train_size, 42), jax_split(items, train_size, 42)
    assert [list(part) for part in got] == [list(part) for part in want]


# --- the loader ----------------------------------------------------------------


def test_loader_gives_the_jax_batches_in_the_jax_order(trees, fresh_caches):
    """Shuffled batches over two epochs: the same indices, images and
    targets as the JAX loader for the seed and epoch."""
    kw = dict(trees["custom"], mode="device-aug")
    ours = DataLoader(get_segmentation_dataset("custom", **kw), batch_size=3, shuffle=True,
                      drop_last=False, num_workers=2, seed=5)
    theirs = JaxLoader(jax_dataset("custom", **kw), batch_size=3, shuffle=True, drop_last=False,
                       num_workers=2, seed=5)
    assert len(ours) == len(theirs) == 2
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 2
        for (gi, gt), (wi, wt) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gt, wt)
    dropping = DataLoader(get_segmentation_dataset("custom", **kw), batch_size=3, drop_last=True)
    assert len(dropping) == 1 and len(list(dropping)) == 1


def test_collate_pads_mixed_sizes_as_jax():
    rng = np.random.default_rng(0)
    samples = [(rng.integers(0, 255, (h, w, 3), dtype=np.uint8),
                rng.integers(0, 5, (h, w)).astype(np.int32)) for h, w in ((5, 7), (6, 4), (5, 7))]
    got, want = DataLoader._collate(samples), JaxLoader._collate(samples)
    assert got[0].shape == (3, 6, 7, 3) and got[1].shape == (3, 6, 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1][1, :, 4:] == -1).all() and (got[0][1, :, 4:] == 0).all()


@pytest.mark.parametrize("low,high,narrow", [(-1, 18, True), (0, 127, True), (-128, 0, True),
                                             (0, 128, False), (-129, 5, False)])
def test_labels_narrow_to_int8_by_their_range_not_the_class_count(low, high, narrow):
    """The trainer's and evaluator's int8 wire rule: the labels' own range
    decides (a 2-class dataset whose ids reach 255 keeps int32)."""
    labels = np.array([[low, high], [0, 0]], np.int32)
    out = narrow_labels(labels)
    assert out.dtype == (np.int8 if narrow else np.int32)
    np.testing.assert_array_equal(out, labels)


@pytest.mark.parametrize("high,dtype", [(18, np.int8), (255, np.int32)])
def test_loader_workers_narrow_the_labels_by_their_range(high, dtype):
    """``narrow_targets``: the workers narrow each sample, and the batch is
    int8 only when every sample's range fits (one sample whose ids reach
    255 widens it); the values are those of the plain loader."""
    rng = np.random.default_rng(3)
    samples = [(rng.integers(0, 256, (4, 6, 3)).astype(np.uint8),
                rng.integers(-1, 19, (4, 6)).astype(np.int32)) for _ in range(4)]
    samples[2][1][0, 0] = high

    class Listed:
        def __len__(self):
            return len(samples)

        def __getitem__(self, i):
            return samples[i]

    plain = list(DataLoader(Listed(), batch_size=4, num_workers=2))
    narrow = list(DataLoader(Listed(), batch_size=4, num_workers=2, narrow_targets=True))
    assert plain[0][1].dtype == np.int32 and narrow[0][1].dtype == dtype
    np.testing.assert_array_equal(narrow[0][0], plain[0][0])
    np.testing.assert_array_equal(narrow[0][1], plain[0][1])


def test_a_producer_error_reaches_the_consumer():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("sample 2 is broken")
            return np.zeros((2, 2, 3), np.uint8), np.zeros((2, 2), np.int32)

    loader = DataLoader(Broken(), batch_size=2, num_workers=2)
    with pytest.raises(KeyError, match="sample 2 is broken"):
        list(loader)
