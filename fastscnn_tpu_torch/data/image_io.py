"""Image files to numpy arrays, and back, without PIL.

The JAX package opens every image with ``PIL.Image.open`` and writes
with ``Image.save``. The machine that runs the port on the card has no
PIL, so this module reads and writes the files the datasets, the
pipeline, the server and the demos use with the standard library, numpy
and the port's JPEG codec (``data/jpeg.py``) alone:

- PNG, read with ``zlib`` and numpy: 8-bit greyscale, RGB, RGBA and
  palette images (a palette image gives its indices, as
  ``np.asarray(Image.open(path))`` does), non-interlaced, with any mix of
  the five row filters;
- JPEG, read by :func:`~fastscnn_tpu_torch.data.jpeg.decode_jpeg` to
  Pillow's pixels: baseline, extended-sequential or progressive Huffman,
  8-bit, 1 or 3 components, 4:4:4, 4:2:2 or 4:2:0 (mode ``L`` or
  ``RGB``);
- ``convert="RGB"``, ``"L"`` and ``"RGBA"`` of either, as Pillow converts
  those modes (``Convert.c``): greyscale replicated, alpha dropped,
  palette indices looked up (entries the palette lacks read as black,
  alpha 255); ``L`` the ITU-R 601-2 luma in Pillow's integers,
  ``(R·19595 + G·38470 + B·7471 + 0x8000) >> 16``, of the RGB (or
  palette) values; ``RGBA`` with alpha 255 but where a PNG's ``tRNS``
  chunk says otherwise, as Pillow honours it: a palette image's alphas
  by index, a greyscale or RGB image's one transparent sample value at
  alpha 0.

A JPEG variant the codec does not read raises its ``ValueError``, and a
JPEG never goes to PIL. Any other file (BMP, a 16-bit or interlaced PNG,
another ``convert``) goes through PIL, imported inside :func:`decode`;
where PIL is not installed that raises a ``RuntimeError`` naming the file
and the ROADMAP item of the formats only PIL reads. :func:`decode_bytes`
does the same for an image held in memory (a request body).

:func:`write_png` writes 8-bit L, RGB, RGBA and palette PNGs with filter
type 0: a palette image (the mask dumps) in the bytes PIL writes for it.
:func:`save_image` writes a ``.png`` path through it and a ``.jpg`` or
``.jpeg`` path through :func:`~fastscnn_tpu_torch.data.jpeg.encode_jpeg`
(Pillow's bytes at its default quality, 75), and hands any other to PIL;
:func:`image_size` reads a PNG's or a JPEG's size from its header
without decoding it.

Sub and Up rows unfilter with one vector operation a row. Average and
Paeth rows depend on the pixel to their left, so an image that has any
is unfiltered along anti-diagonals instead: pixel (r, c) needs only
(r, c-1), (r-1, c) and (r-1, c-1), so every pixel of one anti-diagonal
r + c = t can be computed at once from the two before it. The image is
held skewed, ``K[t, r] = pixel (r, t - r)``, so that each anti-diagonal is
one contiguous slice: W + H - 1 vector steps an image, whatever its
filters. Those steps are small numpy calls that each take and release
the interpreter lock, so loader threads decoding at once thrash it (four
threads took 4.7x the serial time a file on an H100 machine's host,
PERF.md §5): one thread at a time runs them, the others meanwhile read
and inflate their files. A JPEG decode is one call into the codec, which
releases the lock, so threads decode JPEGs in parallel.
"""

from __future__ import annotations

import io
import struct
import threading
import zlib

import numpy as np

from fastscnn_tpu_torch.data.jpeg import ROADMAP_ITEM, decode_jpeg, encode_jpeg, is_jpeg

__all__ = ["decode", "decode_bytes", "image_size", "read_image", "read_palette", "save_image",
           "write_png", "PNG_SIGNATURE"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# IHDR colour type -> (samples a pixel, PIL mode) for the 8-bit subset read here
_COLOUR_TYPES = {0: (1, "L"), 2: (3, "RGB"), 3: (1, "P"), 6: (4, "RGBA")}
_DIAGONALS = threading.Lock()  # one thread at a time in the anti-diagonal loop


def read_image(path: str, convert: str | None = None) -> np.ndarray:
    """``np.asarray(Image.open(path))``, or of ``.convert(convert)``: uint8
    (H, W) for a greyscale or palette image, (H, W, C) otherwise."""
    return decode(path, convert)[0]


def decode(path: str, convert: str | None = None) -> tuple[np.ndarray, str]:
    """:func:`read_image` and the PIL mode of the result (a palette image
    without ``convert`` gives its indices under mode ``'P'``)."""
    with open(path, "rb") as f:
        return _decode(f.read(), convert, path)


def read_palette(path: str):
    """The PLTE entries of a palette PNG in the subset, flat RGB values as
    :func:`write_png` takes them; None for any other file."""
    with open(path, "rb") as f:
        png = _read_png(f.read(), path)
    if png is None or png[1] != "P":
        return None
    return png[2].ravel().tolist()


def decode_bytes(data: bytes, convert: str | None = None) -> tuple[np.ndarray, str]:
    """:func:`decode` of an image file's bytes."""
    return _decode(bytes(data), convert, "<bytes>")


_CONVERTS = (None, "RGB", "L", "RGBA")


def _decode(data: bytes, convert: str | None, name: str) -> tuple[np.ndarray, str]:
    if is_jpeg(data):
        if convert not in _CONVERTS:
            raise ValueError(f"{name}: convert={convert!r} of a JPEG is not read without PIL "
                             f"({ROADMAP_ITEM})")
        (arr, mode), palette, trns = decode_jpeg(data, name), None, None
    else:
        png = _read_png(data, name) if convert in _CONVERTS else None
        if png is None:
            return _decode_with_pil(data, convert, name)
        arr, mode, palette, trns = png
    if convert is not None and convert != mode:
        arr, mode = _CONVERTERS[convert](arr, mode, palette, trns), convert
    return arr, mode


def _decode_with_pil(data: bytes, convert: str | None, name: str) -> tuple[np.ndarray, str]:
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"cannot read {name!r}: it is neither an 8-bit non-interlaced PNG nor a JPEG, which "
            f"are all that is read without PIL, and the PIL package is not installed "
            f"({ROADMAP_ITEM})") from e
    with Image.open(io.BytesIO(data)) as img:
        if convert:
            img = img.convert(convert)
        return np.asarray(img), img.mode


def _read_png(data: bytes, path: str):
    """``(array, mode, palette, trns)`` of a PNG in the subset, else None;
    ``trns`` is the body of its ``tRNS`` chunk (None without one)."""
    if not data.startswith(PNG_SIGNATURE):
        return None
    pos, header, palette, trns, idat = len(PNG_SIGNATURE), None, None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: CRC mismatch in PNG chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, compression, filtering, interlace = header
    if (depth != 8 or colour not in _COLOUR_TYPES or compression or filtering or interlace
            or (colour == 3 and palette is None)):
        return None
    channels, mode = _COLOUR_TYPES[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = width * channels
    if raw.size < height * (stride + 1):
        raise ValueError(f"{path}: PNG image data holds {raw.size} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = raw[:height * (stride + 1)].reshape(height, stride + 1)
    pixels = unfilter(rows[:, 1:], rows[:, 0], channels)
    shape = (height, width) if channels == 1 else (height, width, channels)
    return pixels.reshape(shape), mode, palette, trns


def _palette_table(palette, trns) -> np.ndarray:
    """A palette as Pillow holds it: 256 RGBA entries, those past the PLTE
    chunk black, alpha 255 but for the first ``len(trns)`` entries."""
    table = np.zeros((256, 4), np.uint8)
    table[:, 3] = 255
    table[:len(palette), :3] = palette[:256]
    if trns:
        alphas = np.frombuffer(trns, np.uint8)[:256]
        table[:len(alphas), 3] = alphas
    return table


def _to_rgb(arr: np.ndarray, mode: str, palette, trns=None) -> np.ndarray:
    if mode == "L":
        return np.repeat(arr[:, :, None], 3, axis=2)
    if mode == "RGBA":
        return np.ascontiguousarray(arr[:, :, :3])
    return _palette_table(palette, None)[:, :3][arr]


def _to_l(arr: np.ndarray, mode: str, palette, trns=None) -> np.ndarray:
    """Pillow's ``rgb2l`` (and ``p2l`` over the palette): the luma in 16.16
    fixed point, rounded half up; alpha plays no part."""
    rgb = (_palette_table(palette, None)[:, :3] if mode == "P" else arr[..., :3]).astype(np.uint32)
    luma = ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)
    return luma[arr] if mode == "P" else luma


def _to_rgba(arr: np.ndarray, mode: str, palette, trns=None) -> np.ndarray:
    """Alpha 255, but as ``trns`` says: alpha by palette index for a
    palette image; alpha 0 where a greyscale or RGB pixel equals the one
    16-bit sample value (per channel) that ``trns`` names."""
    if mode == "P":
        return _palette_table(palette, trns)[arr]
    rgb = arr if mode == "RGB" else _to_rgb(arr, mode, palette)
    alpha = np.full(arr.shape[:2], 255, np.uint8)
    if trns is not None:
        key = np.frombuffer(trns[:len(trns) // 2 * 2], ">u2")
        if mode == "L" and key.size >= 1:
            alpha[arr == key[0]] = 0
        elif mode == "RGB" and key.size >= 3:
            alpha[(arr == key[:3]).all(axis=-1)] = 0
    return np.concatenate([rgb, alpha[:, :, None]], axis=2)


_CONVERTERS = {"RGB": _to_rgb, "L": _to_l, "RGBA": _to_rgba}


def unfilter(rows: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """PNG rows (H, W·bpp) uint8 after their filter bytes ``ftype`` (H,)
    → the (H, W·bpp) uint8 samples."""
    if ftype.size and int(ftype.max()) > 4:
        raise ValueError(f"PNG row filter {int(ftype.max())} is not one of 0-4")
    if np.isin(ftype, (3, 4)).any():
        with _DIAGONALS:
            return _unfilter_diagonals(rows, ftype, bpp)
    out = np.empty_like(rows)
    prev = np.zeros(rows.shape[1], np.uint8)
    for r, kind in enumerate(ftype.tolist()):
        if kind == 0:
            out[r] = rows[r]
        elif kind == 1:  # Sub: a running sum along the row, per channel, mod 256
            out[r] = np.cumsum(rows[r].reshape(-1, bpp), axis=0, dtype=np.uint8).ravel()
        else:  # Up
            out[r] = rows[r] + prev
        prev = out[r]
    return out


def _unfilter_diagonals(rows: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Every filter at once, one anti-diagonal of pixels a step (see the
    module docstring). ``k[t + 2, r + 1]`` holds pixel (r, t - r); row -1
    and the columns left of 0 stay zero, as the filters define them."""
    h, w = rows.shape[0], rows.shape[1] // bpp
    steps = w + h - 1
    src = np.zeros((steps, h, bpp), np.int16)
    for r in range(h):
        src[r:r + w, r] = rows[r].reshape(w, bpp)
    k = np.zeros((steps + 2, h + 1, bpp), np.int16)
    kinds = set(ftype.tolist())
    ft = ftype.astype(np.int16)[:, None]
    for t in range(steps):
        lo, hi = max(0, t - w + 1), min(t, h - 1) + 1
        a = k[t + 1, lo + 1:hi + 1]  # left: (r, c - 1), the step before
        b = k[t + 1, lo:hi]          # up: (r - 1, c), the step before
        c = k[t, lo:hi]              # up-left: (r - 1, c - 1), two steps before
        if kinds == {4}:
            pred = _paeth(a, b, c)
        else:
            f = ft[lo:hi]
            pred = np.where(f == 1, a, np.where(f == 2, b, 0))
            if 3 in kinds:
                pred = np.where(f == 3, (a + b) >> 1, pred)
            if 4 in kinds:
                pred = np.where(f == 4, _paeth(a, b, c), pred)
        k[t + 2, lo + 1:hi + 1] = (src[t, lo:hi] + pred) & 255
    out = np.empty((h, w, bpp), np.uint8)
    for r in range(h):
        out[r] = k[r + 2:r + 2 + w, r + 1]
    return out.reshape(h, w * bpp)


def _paeth(a, b, c):
    """The Paeth predictor of PNG: of left, up and up-left, the one nearest
    to left + up - up-left, ties to left, then up."""
    da, db = a - c, b - c
    pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path_or_file, arr: np.ndarray, palette=None) -> None:
    """Write uint8 ``arr`` as an 8-bit PNG: (H, W) greyscale, (H, W, 3) RGB,
    (H, W, 4) RGBA, or, given ``palette`` (a flat list of RGB entries), (H, W) palette
    indices with that palette as its PLTE chunk. Every row has filter
    type 0; ``path_or_file`` is a path or a binary file."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8 arrays, not {arr.dtype}")
    if palette is not None:
        if arr.ndim != 2:
            raise ValueError(f"a palette image is (H, W) indices, not {arr.shape}")
        plte = np.asarray(palette, np.uint8).ravel()
        if plte.size % 3 or not 3 <= plte.size <= 768:
            raise ValueError(f"a palette holds 1 to 256 RGB entries, not {plte.size} values")
        colour = 3
    elif arr.ndim == 2:
        colour = 0
    elif arr.ndim == 3 and arr.shape[2] in (3, 4):
        colour = 2 if arr.shape[2] == 3 else 6
    else:
        raise ValueError(f"write_png writes (H, W), (H, W, 3) or (H, W, 4) arrays, not {arr.shape}")
    h, w = arr.shape[:2]
    if not h or not w:
        raise ValueError(f"a PNG holds at least one pixel, not {arr.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1)  # filter 0
    out = [PNG_SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))]
    if palette is not None:
        out.append(_chunk(b"PLTE", plte.tobytes()))
    # PIL's encoder: zlib level 6 at memLevel 9, its output cut into IDAT
    # chunks of its buffer's size, so a palette image's bytes equal PIL's
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9)
    idat = z.compress(rows.tobytes()) + z.flush()
    step = max(65536, w * 4)
    out += [_chunk(b"IDAT", idat[i:i + step]) for i in range(0, len(idat), step)]
    out.append(_chunk(b"IEND", b""))
    data = b"".join(out)
    if hasattr(path_or_file, "write"):
        path_or_file.write(data)
    else:
        with open(path_or_file, "wb") as f:
            f.write(data)


def save_image(path: str, arr: np.ndarray) -> None:
    """``Image.fromarray(arr).save(path)``: a ``.png`` path through
    :func:`write_png`, a ``.jpg`` or ``.jpeg`` path through
    :func:`~fastscnn_tpu_torch.data.jpeg.encode_jpeg` (Pillow's default
    quality, 75), any other through PIL, which raises a ``RuntimeError``
    naming the file where PIL is not installed."""
    lower = path.lower()
    if lower.endswith(".png"):
        write_png(path, arr)
        return
    if lower.endswith((".jpg", ".jpeg")):
        data = encode_jpeg(np.asarray(arr))
        with open(path, "wb") as f:
            f.write(data)
        return
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"cannot write {path!r}: only PNG and JPEG files are written without PIL, and the "
            f"PIL package is not installed ({ROADMAP_ITEM})") from e
    Image.fromarray(np.asarray(arr)).save(path)


# JPEG markers that carry a frame header: SOF0-SOF15 but DHT, JPG and DAC
_JPEG_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def image_size(path: str) -> tuple[int, int]:
    """``Image.open(path).size``, (width, height), from the file's header
    alone: a PNG's IHDR, a JPEG's frame header (SOF marker); any other
    file through PIL, which raises a ``RuntimeError`` where it is not
    installed."""
    with open(path, "rb") as f:
        data = f.read(64 * 1024)
        if data.startswith(PNG_SIGNATURE) and data[12:16] == b"IHDR":
            width, height = struct.unpack(">II", data[16:24])
            return int(width), int(height)
        if data.startswith(b"\xff\xd8"):
            data += f.read()
            size = _jpeg_size(data)
            if size is not None:
                return size
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"cannot read the size of {path!r}: it is neither a PNG nor a JPEG with a frame "
            "header, and the PIL package is not installed") from e
    with Image.open(path) as img:
        return img.size


def _jpeg_size(data: bytes):
    """(width, height) from the first frame header of JPEG ``data``: walk
    the marker segments after SOI, each ``FF xx`` with a two-byte length
    but the standalone markers (RSTn, TEM)."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return None
        marker = data[pos + 1]
        if marker == 0xFF:  # a fill byte
            pos += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        if marker in (0xD9, 0xDA):  # EOI or start of scan before any frame header
            return None
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker in _JPEG_SOF and pos + 9 <= len(data):
            height, width = struct.unpack(">HH", data[pos + 5:pos + 9])
            return int(width), int(height)
        pos += 2 + length
    return None
