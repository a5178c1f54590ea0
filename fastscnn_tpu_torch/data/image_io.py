"""Image files to numpy arrays, and back, without PIL.

The JAX package opens every image with ``PIL.Image.open`` and writes
with ``Image.save``. The machine that runs the port on the card has no
PIL, so this module reads and writes every format the JAX package's
call sites use with the standard library, numpy, the port's JPEG codec
(``data/jpeg.py``) and its BMP reader and writer (``data/bmp.py``), each
to Pillow 12's pixels and mode:

- PNG, read with ``zlib`` and numpy, as Pillow's ``PngImagePlugin``
  unpacks it: greyscale at 1 bit (mode ``1``, bool), 2 and 4 bits (``L``,
  scaled by 0x55 and 0x11), 8 bits (``L``) and 16 bits (``I;16``,
  uint16); palette images at 1, 2, 4 and 8 bits (``P``: the indices, as
  ``np.asarray(Image.open(path))`` gives them); RGB and RGBA at 8 and 16
  bits and grey + alpha at 8 bits (``LA``) and 16 bits (``RGBA``), 16-bit
  samples cut to their high byte; non-interlaced or Adam7, with any mix
  of the five row filters, and a ``tRNS`` chunk read as Pillow reads it;
- JPEG, read by :func:`~fastscnn_tpu_torch.data.jpeg.decode_jpeg` to
  the pixels libjpeg-turbo gives Pillow (modes ``L``, ``RGB``, ``CMYK``);
- BMP, read by :func:`~fastscnn_tpu_torch.data.bmp.decode_bmp` (modes
  ``1``, ``L``, ``P``, ``RGB``, ``RGBA``);
- GIF, read by :func:`~fastscnn_tpu_torch.data.gif.decode_gif` (the first
  frame: ``P`` or ``L``, the transparency index);
- TIFF, read by :func:`~fastscnn_tpu_torch.data.tiff.decode_tiff` (page 0:
  ``1``, ``L``, ``I;16``, ``I;16B``, ``I``, ``F``, ``P``, ``PA``, ``LA``,
  ``RGB``, ``RGBA``, ``CMYK``);
- WebP, read by :func:`~fastscnn_tpu_torch.data.webp.decode_webp` (the
  first frame: ``RGB`` or ``RGBA``);
- ``convert="RGB"``, ``"L"``, ``"RGBA"`` and ``"LA"`` from each of those
  modes, as Pillow's ``Image.convert`` and ``Convert.c`` do: greyscale
  replicated, alpha dropped, palette indices looked up (entries the
  palette lacks read as black), ``1`` as 0 and 255, ``I;16``, ``I;16B``
  and ``I`` clipped to 0-255, ``F`` clipped and truncated, CMYK as
  ``255 - K - C·(255 - K)/255`` in Pillow's rounding; ``L`` the ITU-R
  601-2 luma in Pillow's integers, ``(R·19595 + G·38470 + B·7471 +
  0x8000) >> 16``; alpha 255 but where the image says otherwise: its alpha
  band (``PA``'s too), a palette's ``tRNS`` alphas by index or GIF's one
  transparent index, or a greyscale or RGB image's one transparent value
  (its low byte) at alpha 0.

A variant the readers refuse raises a ``ValueError`` naming it; nothing
read here goes to PIL, and every other ``convert`` (``1``, ``P``, ``I``,
``F``, ``YCbCr``, ``HSV``, ``LAB``, ...) raises naming the ROADMAP item.
Any other file (ICO, PPM, TGA, JPEG 2000, ...) goes through PIL, imported
inside :func:`decode`; where PIL is not installed that raises a
``RuntimeError`` naming the file and the ROADMAP item.
:func:`decode_bytes` does the same for an image held in memory (a request
body).

:func:`write_png` writes L, RGB, RGBA, LA, palette, 1-bit and 16-bit
grey PNGs with filter type 0 (quick to write and to read back): a palette
image (the mask dumps) in the bytes PIL writes for it.
:func:`save_image` writes a ``.png`` path with the row filters Pillow's
encoder picks, in ``Image.save``'s bytes for every mode, a ``.jpg`` or
``.jpeg`` path through
:func:`~fastscnn_tpu_torch.data.jpeg.encode_jpeg` (Pillow's bytes at its
default quality, 75) and a ``.bmp`` path through
:func:`~fastscnn_tpu_torch.data.bmp.encode_bmp` (Pillow's bytes), and
hands any other to PIL; :func:`image_size` reads a PNG's, a JPEG's, a
BMP's, a GIF's, a TIFF's or a WebP's size from its header without
decoding it.

Sub and Up rows unfilter with one vector operation a row. Average and
Paeth rows depend on the pixel to their left, so an image (or Adam7
pass) that has any is unfiltered along anti-diagonals instead: pixel
(r, c) needs only (r, c-1), (r-1, c) and (r-1, c-1), so every pixel of
one anti-diagonal r + c = t can be computed at once from the two before
it. The image is held skewed, ``K[t, r] = pixel (r, t - r)``, so that
each anti-diagonal is one contiguous slice: W + H - 1 vector steps an
image, whatever its filters. Those steps are small numpy calls that each
take and release the interpreter lock, so loader threads decoding at
once thrash it (four threads took 4.7x the serial time a file on an H100
machine's host, PERF.md §5): one thread at a time runs them, the others
meanwhile read and inflate their files. A JPEG decode is one call into
the codec, which releases the lock, so threads decode JPEGs in parallel.
"""

from __future__ import annotations

import io
import struct
import threading
import zlib

import numpy as np

from fastscnn_tpu_torch.data.bmp import bmp_size, decode_bmp, encode_bmp, is_bmp
from fastscnn_tpu_torch.data.gif import decode_gif, gif_size, is_gif
from fastscnn_tpu_torch.data.jpeg import ROADMAP_ITEM, decode_jpeg, encode_jpeg, is_jpeg
from fastscnn_tpu_torch.data.tiff import decode_tiff, is_tiff, tiff_size
from fastscnn_tpu_torch.data.webp import decode_webp, is_webp, webp_size

__all__ = ["decode", "decode_bytes", "image_size", "read_image", "read_palette", "save_image",
           "write_png", "PNG_SIGNATURE"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# (bit depth, colour type) -> Pillow's mode, as PngImagePlugin's _MODES
_PNG_MODES = {(1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L", (16, 0): "I;16",
              (8, 2): "RGB", (16, 2): "RGB", (1, 3): "P", (2, 3): "P", (4, 3): "P",
              (8, 3): "P", (8, 4): "LA", (16, 4): "RGBA", (8, 6): "RGBA", (16, 6): "RGBA"}
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_DIAGONALS = threading.Lock()  # one thread at a time in the anti-diagonal loop
_CONVERTS = (None, "RGB", "L", "RGBA", "LA")


def read_image(path: str, convert: str | None = None) -> np.ndarray:
    """``np.asarray(Image.open(path))``, or of ``.convert(convert)``: uint8
    (H, W) for a greyscale or palette image (bool for mode ``1``, uint16
    for ``I;16``), (H, W, C) otherwise."""
    return decode(path, convert)[0]


def decode(path: str, convert: str | None = None) -> tuple[np.ndarray, str]:
    """:func:`read_image` and the PIL mode of the result (a palette image
    without ``convert`` gives its indices under mode ``'P'``)."""
    with open(path, "rb") as f:
        return _decode(f.read(), convert, path)


def read_palette(path: str):
    """The palette entries of a palette PNG, BMP, GIF or TIFF (``P`` or
    ``PA``), flat RGB values as :func:`write_png` takes them, as Pillow's
    ``getpalette()``; None for any other file."""
    with open(path, "rb") as f:
        img = _read(f.read(), path)
    if img is None or img[1] not in ("P", "PA"):
        return None
    return img[2].ravel().tolist()


def decode_bytes(data: bytes, convert: str | None = None) -> tuple[np.ndarray, str]:
    """:func:`decode` of an image file's bytes."""
    return _decode(bytes(data), convert, "<bytes>")


def _read(data: bytes, name: str):
    """``(array, mode, palette, transparency)`` of a file the port reads,
    else None: ``palette`` a palette image's (N, 3) entries, and
    ``transparency`` what Pillow puts in ``info["transparency"]``."""
    if is_jpeg(data):
        arr, mode = decode_jpeg(data, name)
        return arr, mode, None, None
    if is_bmp(data):
        arr, mode, palette = decode_bmp(data, name)
        return arr, mode, palette, None
    if data.startswith(PNG_SIGNATURE):
        return _read_png(data, name)
    if is_gif(data):
        return decode_gif(data, name)
    if is_tiff(data):
        return decode_tiff(data, name)
    if is_webp(data):
        return decode_webp(data, name)
    return None


def _kind(data: bytes) -> str:
    """The name of a format :func:`_read` reads, for messages."""
    for kind, test in (("JPEG", is_jpeg), ("BMP", is_bmp), ("GIF", is_gif), ("TIFF", is_tiff),
                       ("WebP", is_webp)):
        if test(data):
            return kind
    return "PNG"


def _decode(data: bytes, convert: str | None, name: str) -> tuple[np.ndarray, str]:
    img = _read(data, name)
    if img is None:
        return _decode_with_pil(data, convert, name)
    arr, mode, palette, trns = img
    if convert is None or convert == mode:
        # an L GIF that kept a palette is P in Pillow's core: its copy says so
        return arr, "P" if convert and mode == "L" and palette is not None else mode
    if convert not in _CONVERTS:
        raise ValueError(f"{name}: convert={convert!r} of a {_kind(data)} ({mode}) is not done "
                         f"without PIL ({ROADMAP_ITEM})")
    if mode == "L" and palette is not None and trns is not None and convert in ("RGBA", "LA"):
        # Pillow's convert_transparent of its P core raises, and so does this
        raise ValueError(f"{name}: conversion from P to {convert} not supported in "
                         f"convert_transparent (Pillow refuses it too)")
    return _convert(arr, mode, palette, trns, convert), convert


def _decode_with_pil(data: bytes, convert: str | None, name: str) -> tuple[np.ndarray, str]:
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"cannot read {name!r}: it is not a PNG, JPEG, BMP, GIF, TIFF or WebP file, which "
            f"are all that is read without PIL, and the PIL package is not installed "
            f"({ROADMAP_ITEM})") from e
    with Image.open(io.BytesIO(data)) as img:
        if convert:
            img = img.convert(convert)
        return np.asarray(img), img.mode


def _read_png(data: bytes, path: str):
    """:func:`_read` of a PNG; None for a bit depth and colour type that
    Pillow does not open or an unknown filter method."""
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
            if length < 13:
                raise ValueError(f"{path}: truncated IHDR chunk")
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:length // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, _compression, filtering, interlace = header
    mode = _PNG_MODES.get((depth, colour))
    if mode is None or filtering or (colour == 3 and palette is None):
        return None
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    samples = _SAMPLES[colour]
    if not interlace:
        vals = _png_pass(raw, 0, width, height, depth, samples, path)[0]
    else:
        vals = np.zeros((height, width, samples), np.uint16 if depth == 16 else np.uint8)
        at = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
            if pw > 0 and ph > 0:
                vals[y0::dy, x0::dx], at = _png_pass(raw, at, pw, ph, depth, samples, path)
    # PngImagePlugin keeps a PLTE chunk for palette images only
    return (_png_pixels(vals, depth, mode), mode, palette if mode == "P" else None,
            _transparency(trns, mode, depth))


def _png_pass(raw: np.ndarray, at: int, w: int, h: int, depth: int, samples: int, path: str):
    """The (h, w, samples) samples of one image or Adam7 pass whose
    filtered rows start at ``raw[at]``, and where the next pass starts."""
    bits = depth * samples
    stride = (w * bits + 7) // 8
    n = h * (stride + 1)
    if raw.size < at + n:
        raise ValueError(f"{path}: PNG image data holds {raw.size} bytes, expected "
                         f"{at + n}")
    rows = raw[at:at + n].reshape(h, stride + 1)
    px = unfilter(rows[:, 1:], rows[:, 0], max(1, bits // 8))
    if depth == 16:
        vals = px.view(">u2").reshape(h, w, samples)
    elif depth == 8:
        vals = px.reshape(h, w, samples)
    else:  # 1, 2 or 4 bits, one sample a pixel, the leftmost in the high bits
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        unpacked = (px[:, :, None] >> shifts) & ((1 << depth) - 1)
        vals = unpacked.reshape(h, -1)[:, :w, None]
    return vals, at + n


def _png_pixels(vals: np.ndarray, depth: int, mode: str) -> np.ndarray:
    """PngImagePlugin's raw modes: samples (H, W, S) -> Pillow's array."""
    if mode == "1":
        return _bool255(vals[..., 0])
    if mode == "I;16":
        return vals[..., 0].astype("<u2")
    if depth == 16:
        vals = (vals >> 8).astype(np.uint8)  # RGB;16B, RGBA;16B and LA;16B keep the high byte
        if vals.shape[2] == 2:  # 16-bit grey + alpha opens as RGBA
            vals = vals[..., [0, 0, 0, 1]]
    elif depth < 8 and mode == "L":
        return (vals[..., 0] * (255 // ((1 << depth) - 1))).astype(np.uint8)
    vals = vals.astype(np.uint8, copy=False)
    return np.ascontiguousarray(vals[..., 0] if vals.shape[2] == 1 else vals)


def _bool255(v: np.ndarray) -> np.ndarray:
    """A mode ``1`` array as Pillow's ``__array_interface__`` gives it:
    bool, its True bytes 255 (numpy reads any nonzero byte as True)."""
    return np.where(v != 0, 255, 0).astype(np.uint8).view(bool)


def _transparency(trns, mode: str, depth: int):
    """``info["transparency"]`` as PngImagePlugin's ``chunk_tRNS`` sets it:
    a palette image's alphas, ``1``'s 0 or 255, a grey image's value, an
    RGB image's (R, G, B); None where it sets none."""
    if trns is None or mode in ("LA", "RGBA") or (mode == "RGB" and len(trns) < 6) or \
            (mode in ("1", "L", "I;16") and len(trns) < 2):
        return None
    if mode == "P":
        return trns
    if mode == "RGB":
        return struct.unpack(">HHH", trns[:6])
    value = struct.unpack(">H", trns[:2])[0]
    return (255 if value else 0) if mode == "1" else value


# --- Convert.c --------------------------------------------------------------------------


def _palette_table(palette, alphas=None) -> np.ndarray:
    """A palette as Pillow holds it: 256 RGBA entries, those past the
    palette black, alpha 255 but for the first ``len(alphas)`` entries."""
    table = np.zeros((256, 4), np.uint8)
    table[:, 3] = 255
    if palette is not None:
        table[:min(len(palette), 256), :3] = palette[:256]
    if alphas:
        a = np.frombuffer(alphas, np.uint8)[:256]
        table[:len(a), 3] = a
    return table


def _luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's ``rgb2l``: the luma in 16.16 fixed point, rounded half up."""
    rgb = rgb.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _cmyk_rgb(arr: np.ndarray) -> np.ndarray:
    """Pillow's ``cmyk2rgb``: ``nk - MULDIV255(c, nk)``, ``nk = 255 - K``."""
    c = arr.astype(np.int32)
    nk = 255 - c[..., 3:]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _convert(arr: np.ndarray, mode: str, palette, trns, to: str) -> np.ndarray:
    """``Image.convert(to)`` of an image of ``mode``, ``to`` one of RGB, L,
    RGBA and LA (``to != mode``)."""
    if mode in ("P", "PA") or (mode == "L" and palette is not None):
        if isinstance(trns, int):  # GIF's index: putpalettealpha(index, 0)
            trns = b"\xff" * trns + b"\x00"
        table = _palette_table(palette, trns if to in ("RGBA", "LA") and mode == "P" else None)
        if to in ("L", "LA"):
            table = np.concatenate([_luma(table[:, :3])[:, None], table[:, 3:]], axis=1)
        out = table[arr[..., 0] if mode == "PA" else arr]
        if mode == "PA":  # pa2rgba, pa2la: the alpha band, not the palette's
            out[..., -1] = arr[..., 1]
        return out[..., 0] if to == "L" else out[..., :3] if to == "RGB" else out
    if mode in ("RGB", "RGBA", "CMYK"):
        rgb = _cmyk_rgb(arr) if mode == "CMYK" else arr[..., :3]
        key = None if trns is None or mode != "RGB" else \
            (rgb == np.array(trns, np.int64) & 255).all(axis=-1)
        grey = None
    else:  # 1, L, LA, I;16, I;16B, I, F: one value a pixel, clipped to 0-255 (F truncated)
        grey = {"1": lambda a: np.where(a, 255, 0).astype(np.uint8),
                "L": lambda a: a, "LA": lambda a: a[..., 0],
                "I;16": lambda a: np.minimum(a, 255).astype(np.uint8),
                "I;16B": lambda a: np.minimum(a, 255).astype(np.uint8),
                "I": lambda a: np.clip(a, 0, 255).astype(np.uint8),
                "F": lambda a: np.where(a <= 0, 0, np.where(a >= 255, 255, np.nan_to_num(a)))
                .astype(np.uint8)}[mode](arr)
        key = None if trns is None or mode == "LA" else grey == (trns & 255)
    if to == "L":
        return grey if grey is not None else _luma(rgb)
    if to == "RGB":
        return np.repeat(grey[..., None], 3, axis=2) if grey is not None else \
            np.ascontiguousarray(rgb)
    alpha = arr[..., -1].copy() if mode in ("LA", "RGBA") else \
        np.full(arr.shape[:2], 255, np.uint8)
    if key is not None:
        alpha[key] = 0
    if to == "LA":
        first = grey if grey is not None else _luma(rgb)
        if grey is None and key is not None:  # Convert.c keeps a keyed pixel's R, not its luma
            first = np.where(key, rgb[..., 0], first)
    else:
        first = np.repeat(grey[..., None], 3, axis=2) if grey is not None else rgb
    return np.concatenate([first.reshape(*arr.shape[:2], -1), alpha[..., None]], axis=2)


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


def _pillow_filtered(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Pillow's ``ZipEncode.c`` row filters: each row (H, n) takes the
    filter whose bytes, read as signed, sum nearest zero, tried in the
    order none, Up, Sub, Paeth (Average only under ``optimize``), a later
    one only when strictly better; (H, 1 + n) with the filter bytes."""
    prev = np.zeros_like(raw)
    prev[1:] = raw[:-1]
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    upleft = np.zeros_like(raw)
    upleft[:, bpp:] = prev[:, :-bpp]
    a, b, c = (x.astype(np.int16) for x in (left, prev, upleft))
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    rows = np.stack([raw, raw - prev, raw - left, raw - paeth])  # uint8, mod 256
    cost = np.where(rows < 128, rows, 256 - rows.astype(np.int32)).sum(axis=2, dtype=np.int64)
    pick = np.argmin(cost, axis=0)  # the first of equal sums, as the strict < keeps it
    out = np.empty((raw.shape[0], raw.shape[1] + 1), np.uint8)
    out[:, 0] = np.array([0, 2, 1, 4], np.uint8)[pick]
    out[:, 1:] = rows[pick, np.arange(raw.shape[0])]
    return out


def write_png(path_or_file, arr: np.ndarray, palette=None) -> None:
    """Write ``arr`` as a PNG with filter-0 rows (the quick write of the
    port's synthetic trees and dumps; a palette image in Pillow's bytes):
    uint8 (H, W) greyscale, (H, W, 2) grey + alpha, (H, W, 3) RGB, (H, W, 4)
    RGBA, or, given ``palette`` (a flat list of RGB entries), (H, W)
    palette indices with that palette as its PLTE chunk, packed at 1, 2 or
    4 bits for 2, 4 or 16 entries or fewer, as Pillow packs them; bool
    (H, W) as 1-bit and uint16 (H, W) as 16-bit greyscale (modes ``1`` and
    ``I;16``). ``path_or_file`` is a path or a binary file."""
    data = _png_bytes(arr, palette, pillow_filters=palette is not None)
    if hasattr(path_or_file, "write"):
        path_or_file.write(data)
    else:
        with open(path_or_file, "wb") as f:
            f.write(data)


def _png_bytes(arr: np.ndarray, palette, pillow_filters: bool) -> bytes:
    """The PNG file of :func:`write_png`; with ``pillow_filters`` each row
    filtered as Pillow's encoder picks it (:func:`_pillow_filtered`, zlib's
    filtered strategy), which gives the bytes of ``Image.save`` for every
    mode. An 8-bit palette image is never filtered, as Pillow's."""
    arr = np.ascontiguousarray(arr)
    depth = 8
    if arr.dtype == bool or arr.dtype == np.uint16:
        if arr.ndim != 2 or palette is not None:
            raise ValueError(f"a {arr.dtype} PNG is (H, W) greyscale, not {arr.shape}")
        depth = 1 if arr.dtype == bool else 16
    elif arr.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, uint16 or bool arrays, not {arr.dtype}")
    if palette is not None:
        if arr.ndim != 2:
            raise ValueError(f"a palette image is (H, W) indices, not {arr.shape}")
        plte = np.asarray(palette, np.uint8).ravel()
        if plte.size % 3 or not 3 <= plte.size <= 768:
            raise ValueError(f"a palette holds 1 to 256 RGB entries, not {plte.size} values")
        colour, colours = 3, plte.size // 3
        depth = 1 if colours <= 2 else 2 if colours <= 4 else 4 if colours <= 16 else 8
    elif arr.ndim == 2:
        colour = 0
    elif arr.ndim == 3 and arr.shape[2] in (2, 3, 4):
        colour = {2: 4, 3: 2, 4: 6}[arr.shape[2]]
    else:
        raise ValueError(f"write_png writes (H, W), (H, W, 2), (H, W, 3) or (H, W, 4) arrays, "
                         f"not {arr.shape}")
    h, w = arr.shape[:2]
    if not h or not w:
        raise ValueError(f"a PNG holds at least one pixel, not {arr.shape}")
    if depth == 16:
        packed = arr.astype(">u2").view(np.uint8)
    elif depth < 8:  # the leftmost pixel in the high bits, rows padded with zero bits
        per = 8 // depth
        v = np.zeros((h, -(-w // per) * per), np.uint8)
        v[:, :w] = arr
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        packed = np.bitwise_or.reduce(v.reshape(h, -1, per) << shifts, axis=2)
    else:
        packed = arr.reshape(h, -1)
    out = [PNG_SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))]
    if palette is not None:
        out.append(_chunk(b"PLTE", plte.tobytes()))
    if palette is not None and depth == 8:  # PIL's "P" encoder: no filter, default strategy
        rows = np.concatenate([np.zeros((h, 1), np.uint8), packed], axis=1)
        z = zlib.compressobj(6, zlib.DEFLATED, 15, 9)
    elif pillow_filters:
        rows = _pillow_filtered(packed, max(1, depth * _SAMPLES[colour] // 8))
        z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    else:
        rows = np.concatenate([np.zeros((h, 1), np.uint8), packed], axis=1)
        z = zlib.compressobj(6, zlib.DEFLATED, 15, 9)
    # PIL's encoder: level 6 at memLevel 9, its output cut into IDAT chunks
    # of its buffer's size
    idat = z.compress(rows.tobytes()) + z.flush()
    step = max(65536, w * 4)
    out += [_chunk(b"IDAT", idat[i:i + step]) for i in range(0, len(idat), step)]
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def save_image(path: str, arr: np.ndarray) -> None:
    """``Image.fromarray(arr).save(path)``, in its bytes: a ``.png`` path
    with Pillow's row filters (:func:`_png_bytes`), a ``.jpg`` or ``.jpeg`` path through
    :func:`~fastscnn_tpu_torch.data.jpeg.encode_jpeg` (Pillow's default
    quality, 75), a ``.bmp`` path through
    :func:`~fastscnn_tpu_torch.data.bmp.encode_bmp`, any other through
    PIL, which raises a ``RuntimeError`` naming the file where PIL is not
    installed."""
    lower = path.lower()
    if lower.endswith((".png", ".jpg", ".jpeg", ".bmp")):
        arr = np.asarray(arr)
        data = (_png_bytes(arr, None, pillow_filters=True) if lower.endswith(".png") else
                encode_bmp(arr) if lower.endswith(".bmp") else encode_jpeg(arr))
        with open(path, "wb") as f:
            f.write(data)
        return
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"cannot write {path!r}: only PNG, JPEG and BMP files are written without PIL, and "
            f"the PIL package is not installed ({ROADMAP_ITEM})") from e
    Image.fromarray(np.asarray(arr)).save(path)


# JPEG markers that carry a frame header: SOF0-SOF15 but DHT, JPG and DAC
_JPEG_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def image_size(path: str) -> tuple[int, int]:
    """``Image.open(path).size``, (width, height), from the file's header
    alone: a PNG's IHDR, a JPEG's frame header (SOF marker), a BMP's
    headers, a GIF's screen and first image descriptor, a TIFF's first
    directory (swapped by its Orientation as Pillow swaps it), a WebP's
    canvas or bitstream header; any other file through PIL, which raises a
    ``RuntimeError`` where it is not installed."""
    with open(path, "rb") as f:
        data = f.read(64 * 1024)
        if data.startswith(PNG_SIGNATURE) and data[12:16] == b"IHDR":
            width, height = struct.unpack(">II", data[16:24])
            return int(width), int(height)
        if is_bmp(data):
            return bmp_size(data + f.read(), path)
        if is_gif(data):
            return gif_size(data + f.read(), path)
        if is_tiff(data):
            return tiff_size(data + f.read(), path)
        if is_webp(data):
            return webp_size(data, path)
        if data.startswith(b"\xff\xd8"):
            data += f.read()
            size = _jpeg_size(data)
            if size is not None:
                return size
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"cannot read the size of {path!r}: it is neither a PNG, BMP, GIF, TIFF, WebP nor "
            "a JPEG with a frame header, and the PIL package is not installed") from e
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
