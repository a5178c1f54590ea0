"""PIL's operations in numpy (``fastscnn_tpu_torch/data/pil_ops.py``) held to
Pillow, and the host transforms built on them held to the JAX package's.

Every comparison is exact (bit for bit): bilinear and nearest resizes,
windows of a resize, the Gaussian blur, crop, expand and flip on
hypothesis draws of 1-97 px (upscales, downscales past 2x, odd sizes,
radii in the recipes' [0, 1) and past it); ``SyncTransforms`` and the
custom dataset's transforms against the JAX versions' arrays under the
same ``random.Random`` state, the RNG left in the same state; the PNG
writer against PIL's reader and, for palette masks, PIL's bytes.
"""

import io
import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, ImageFilter, ImageOps

from fastscnn_tpu.data.custom import CustomDataset as JaxCustom
from fastscnn_tpu.data.transforms import SyncTransforms as JaxTransforms
from fastscnn_tpu.data.transforms import to_numpy_pair
from fastscnn_tpu.utils.visualize import get_color_pallete as jax_color_pallete
from fastscnn_tpu_torch.data import image_io, pil_ops
from fastscnn_tpu_torch.data.custom import CustomDataset
from fastscnn_tpu_torch.data.transforms import SyncTransforms
from fastscnn_tpu_torch.utils.visualize import get_color_pallete

SIZE = st.integers(1, 97)
FEW = settings(max_examples=60, deadline=None, database=None)
MANY = settings(max_examples=150, deadline=None, database=None)


def _image(seed, h, w, channels):
    rng = np.random.default_rng(seed)
    shape = (h, w) if channels == 1 else (h, w, channels)
    return rng.integers(0, 256, shape).astype(np.uint8)


@MANY
@given(seed=st.integers(0, 2**31), h=SIZE, w=SIZE, oh=SIZE, ow=SIZE,
       channels=st.sampled_from([1, 3]))
def test_bilinear_resize_equals_pillow(seed, h, w, oh, ow, channels):
    img = _image(seed, h, w, channels)
    want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
    np.testing.assert_array_equal(pil_ops.resize(img, (ow, oh), "bilinear"), want)


def test_nearest_resize_equals_pillow_at_every_size_pair():
    """Every source and target length 1-97 on one axis: Pillow's running
    double sum, which ``floor((x + 0.5) · src / dst)`` in exact integers
    misses somewhere on 1,517 of the 9,409 pairs (counted here, so the
    distinction stays visible)."""
    exact_misses = 0
    for src in range(1, 98):
        row = np.arange(src, dtype=np.int32)[None, :]
        for dst in range(1, 98):
            want = np.asarray(Image.fromarray(row, "I").resize((dst, 1), Image.NEAREST))[0]
            got = pil_ops.resize(row, (dst, 1), "nearest")[0]
            np.testing.assert_array_equal(got, want, err_msg=f"{src} -> {dst}")
            exact = ((2 * np.arange(dst) + 1) * src) // (2 * dst)
            exact_misses += not np.array_equal(exact, want)
    assert exact_misses == 1517


@FEW
@given(seed=st.integers(0, 2**31), h=SIZE, w=SIZE, oh=SIZE, ow=SIZE)
def test_nearest_resize_of_a_mask_equals_pillow(seed, h, w, oh, ow):
    mask = _image(seed, h, w, 1) % 34
    want = np.asarray(Image.fromarray(mask).resize((ow, oh), Image.NEAREST))
    np.testing.assert_array_equal(pil_ops.resize(mask, (ow, oh), "nearest"), want)


@FEW
@given(seed=st.integers(0, 2**31), h=SIZE, w=SIZE, oh=SIZE, ow=SIZE, data=st.data(),
       resample=st.sampled_from(["bilinear", "nearest"]))
def test_a_window_equals_the_crop_of_the_whole_resize(seed, h, w, oh, ow, data, resample):
    img = _image(seed, h, w, 3)
    x1 = data.draw(st.integers(0, ow - 1))
    x2 = data.draw(st.integers(x1 + 1, ow))
    y1 = data.draw(st.integers(0, oh - 1))
    y2 = data.draw(st.integers(y1 + 1, oh))
    whole = pil_ops.resize(img, (ow, oh), resample)
    got = pil_ops.resize(img, (ow, oh), resample, window=(x1, y1, x2, y2))
    np.testing.assert_array_equal(got, whole[y1:y2, x1:x2])


@MANY
@given(seed=st.integers(0, 2**31), h=SIZE, w=SIZE, channels=st.sampled_from([1, 3]),
       radius=st.one_of(st.floats(0.0, 1.0, exclude_max=True), st.floats(1.0, 6.0)))
def test_gaussian_blur_equals_pillow(seed, h, w, channels, radius):
    img = _image(seed, h, w, channels)
    want = np.asarray(Image.fromarray(img).filter(ImageFilter.GaussianBlur(radius=radius)))
    np.testing.assert_array_equal(pil_ops.gaussian_blur(img, radius), want)


@FEW
@given(seed=st.integers(0, 2**31), h=SIZE, w=SIZE, box=st.tuples(*[st.integers(-20, 120)] * 4),
       pad=st.tuples(st.integers(0, 30), st.integers(0, 30)))
def test_crop_expand_and_flip_equal_pillow(seed, h, w, box, pad):
    img = _image(seed, h, w, 3)
    x1, y1 = min(box[0], box[2]), min(box[1], box[3])
    x2, y2 = max(box[0], box[2]) + 1, max(box[1], box[3]) + 1
    pil = Image.fromarray(img)
    np.testing.assert_array_equal(pil_ops.crop(img, (x1, y1, x2, y2)),
                                  np.asarray(pil.crop((x1, y1, x2, y2))))
    np.testing.assert_array_equal(pil_ops.expand(img, *pad),
                                  np.asarray(ImageOps.expand(pil, (0, 0, *pad), fill=0)))
    np.testing.assert_array_equal(pil_ops.flip_lr(img),
                                  np.asarray(pil.transpose(Image.FLIP_LEFT_RIGHT)))


# --- the transforms against the JAX package's -------------------------------------------


def _pair(seed, h, w):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
            rng.integers(0, 34, (h, w)).astype(np.uint8))


def _both(ours_fn, theirs_fn, img, mask, seed):
    """Run both under ``random.Random(seed)``: the arrays equal, and each
    RNG's next draw too (the draws came in the same order)."""
    r1, r2 = random.Random(seed), random.Random(seed)
    got = ours_fn(r1, img, mask)
    want = to_numpy_pair(*theirs_fn(r2, Image.fromarray(img), Image.fromarray(mask)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].astype(np.int32), want[1])
    assert r1.random() == r2.random()


@MANY
@given(seed=st.integers(0, 2**31), h=st.integers(8, 97), w=st.integers(8, 97),
       base=st.integers(8, 64), crop=st.integers(4, 64),
       method=st.sampled_from(["train", "val", "original_size", "multi_scale"]))
def test_sync_transforms_equal_jax(seed, h, w, base, crop, method):
    img, mask = _pair(seed, h, w)

    def run(cls):
        return lambda rng, a, b: getattr(cls(base, crop, rng=rng), method)(a, b)

    _both(run(SyncTransforms), run(JaxTransforms), img, mask, seed)


@FEW
@given(seed=st.integers(0, 2**31), h=st.integers(8, 97), w=st.integers(8, 97),
       base=st.integers(8, 64), crop=st.integers(4, 64),
       keep=st.booleans(), multi=st.booleans(), train=st.booleans())
def test_custom_transforms_equal_jax(seed, h, w, base, crop, keep, multi, train):
    img, mask = _pair(seed, h, w)
    mask = (mask > 16).astype(np.uint8)

    def run(cls, transforms):
        def go(rng, a, b):
            ds = object.__new__(cls)
            ds.base_size, ds.crop_size = base, crop
            ds.keep_original_size, ds.multi_scale = keep, multi
            ds.scales = [0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0]
            ds._rng, ds.tf = rng, transforms(base, crop, rng=rng)
            return (ds._sync_transform if train else ds._val_sync_transform)(a, b)
        return go

    _both(run(CustomDataset, SyncTransforms), run(JaxCustom, JaxTransforms), img, mask, seed)


# --- PNG writing and the mask dumps ------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (31, 5, 3), (20, 20, 3)])
def test_write_png_reads_back_through_pil_and_the_port(tmp_path, shape):
    arr = np.random.default_rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    path = tmp_path / "x.png"
    image_io.write_png(str(path), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    got, mode = image_io.decode(str(path))
    assert mode == ("L" if arr.ndim == 2 else "RGB")
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(image_io.decode_bytes(path.read_bytes())[0], arr)


@pytest.mark.parametrize("dataset", ["citys", "ade20k", "pascal_voc"])
def test_mask_dumps_are_the_jax_dumps(tmp_path, dataset):
    """A dump written without PIL: PIL reads the same indices and palette as
    from the JAX package's dump, the port's reader the same indices, and
    the files are the same bytes."""
    mask = np.random.default_rng(5).integers(0, 19, (37, 150)).astype(np.int32)
    ours, theirs = tmp_path / "ours.png", tmp_path / "theirs.png"
    get_color_pallete(mask, dataset).save(str(ours))
    jax_color_pallete(mask, dataset).save(str(theirs))
    a, b = Image.open(ours), Image.open(theirs)
    assert a.mode == b.mode == "P" and a.getpalette() == b.getpalette()
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got, mode = image_io.decode(str(ours))
    assert mode == "P"
    np.testing.assert_array_equal(got, np.asarray(b))
    assert ours.read_bytes() == theirs.read_bytes()
    buf = io.BytesIO()
    get_color_pallete(mask, dataset).save(buf, "PNG")
    assert buf.getvalue() == theirs.read_bytes()
    with pytest.raises(ValueError, match="PNG"):
        get_color_pallete(mask, dataset).save(buf, "JPEG")
