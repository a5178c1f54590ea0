"""Write the PNG, BMP, GIF, TIFF and WebP fixtures and their manifest.

    python tests/fixtures/images/make_fixtures.py

Writes, beside this script, small files (at most 97x90, odd sizes) in
each variant the port reads without PIL:

- with Pillow: PNG at ``bits=1/2/4`` (palette), mode ``1``, ``I;16`` and
  ``LA``; BMP in modes ``1``, ``L``, ``P``, ``RGB`` and ``RGBA``; GIF from
  every mode, interlaced, with transparency, animated; TIFF uncompressed,
  LZW, Deflate, PackBits and JPEG in each mode Pillow writes; WebP lossless
  and lossy (quality, method, ``exact``, alpha quality), with ICC, EXIF and
  XMP chunks, animated;
- with the writers below, from the formats' specifications (PNG: ISO/IEC
  15948; BMP: the Windows GDI ``BITMAPINFOHEADER`` family): greyscale PNG
  at 2 and 4 bits, 16-bit RGB, RGBA and grey + alpha, Adam7 at every
  depth, ``tRNS`` for each colour type; BMP with RLE8 and RLE4, bitfields
  (5-6-5, 5-5-5, 32-bit with and without an alpha mask), 16 and 32-bit
  BI_RGB, top-down rows, the OS/2 core header and the 52, 56, 108 and
  124-byte headers;
- with ``spec_writers.py``: GIF local and global tables, grey ramps,
  offset and oversized frames, a full LZW table without a clear; TIFF
  tiles, separate planes, predictors 2 and 3, ``MM`` and BigTIFF files,
  fill order 2, orientations, every bit depth and sample format Pillow
  opens, associated alpha, YCbCr JPEG strips, old-style LZW; WebP ALPH
  chunks raw and lossless-coded under each filter, animated files whose
  first frame sits inside a larger canvas;
- with libwebp's own encoder (Pillow's bundled library, through
  ``ctypes``): the lossy options Pillow does not pass (the simple loop
  filter, sharpness, token partitions, segments, alpha filtering and
  compression);
- the 1280x720 frame of ``tests/fixtures/jpeg`` as a GIF, a JPEG TIFF and
  a lossy WebP, written by Pillow, for the card's smoke script;
- ``manifest.json``: for each file the sha256 of
  ``np.asarray(Image.open(f))``'s bytes, its shape, dtype and mode, and
  the same of ``.convert(c)`` for c in RGB, L, RGBA and LA; for each BMP
  write the sha256 of the bytes of ``Image.fromarray(a).save(f, "BMP")``;
  under ``frames`` the 1280x720 files' decodes and the frame's own digest.

The PNG writers use numpy and ``zlib`` alone, so the card's smoke script
imports them (:func:`png_bytes`) to write its 1280x720 Adam7 and 16-bit
frames (and ``spec_writers.tiff_bytes`` its LZW and Deflate TIFFs). The
port's tests and the smoke script hold the readers to the manifest, so a
machine without Pillow is checked too.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import importlib.util
import io
import json
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FRAME = os.path.join(HERE, "..", "jpeg", "frame_1280x720_q90.jpg")
NEW_KINDS = (".gif", ".tif", ".webp")
CONVERTS = ("RGB", "L", "RGBA", "LA")
# Adam7: (first column, first row, column step, row step) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def seeded(h: int, w: int, channels: int, seed: int, top: int = 255) -> np.ndarray:
    """A gradient with seeded noise, values 0..top: (h, w) or (h, w, c)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    planes = [x / max(w - 1, 1), y / max(h - 1, 1), 0.5 + 0.5 * np.sin((x + 2 * y) / 5.0),
              0.5 + 0.5 * np.cos((2 * x - y) / 7.0)]
    base = np.stack([planes[k % 4] for k in range(channels)], axis=-1) * top
    noise = rng.integers(-top // 6 - 1, top // 6 + 2, base.shape)
    arr = np.clip(np.rint(base) + noise, 0, top).astype(np.uint16 if top > 255 else np.uint8)
    return arr[..., 0] if channels == 1 else arr


# --- PNG ---------------------------------------------------------------------------------


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_rows(raw: np.ndarray, bpp: int, first: int) -> bytes:
    """Filter each row of ``raw`` (H, row bytes) with type (first + r) % 5:
    every filter of the standard, each row predicted from the unfiltered
    bytes."""
    h, n = raw.shape
    out = np.empty((h, n + 1), np.uint8)
    a = np.zeros_like(raw, dtype=np.int16)
    a[:, bpp:] = raw[:, :-bpp] if bpp < n else 0
    b = np.zeros_like(a)
    b[1:] = raw[:-1]
    c = np.zeros_like(a)
    c[1:, bpp:] = raw[:-1, :-bpp] if bpp < n else 0
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = (np.zeros_like(a), a, b, (a + b) >> 1, paeth)
    for r in range(h):
        kind = (first + r) % 5
        out[r, 0] = kind
        out[r, 1:] = (raw[r].astype(np.int16) - preds[kind][r]) & 255
    return out.tobytes()


def _pack(vals: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, s) samples -> (h, row bytes) at ``depth`` bits a sample."""
    h, w, s = vals.shape
    if depth == 16:
        return vals.astype(">u2").view(np.uint8).reshape(h, w * s * 2)
    if depth == 8:
        return vals.astype(np.uint8).reshape(h, w * s)
    per = 8 // depth
    pad = (-w) % per
    v = np.concatenate([vals[..., 0], np.zeros((h, pad), vals.dtype)], axis=1).astype(np.uint8)
    v = v.reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (v << shifts).sum(axis=2, dtype=np.uint16).astype(np.uint8)


def png_bytes(vals: np.ndarray, depth: int, colour: int, palette=None, trns: bytes | None = None,
              interlace: bool = False, level: int = 6) -> bytes:
    """A PNG of ``vals`` (samples at ``depth`` bits: (H, W) or (H, W, S)),
    colour type ``colour``, optionally Adam7-interlaced, each row (of each
    pass) filtered with one of the five filters in turn."""
    vals = np.asarray(vals)
    if vals.ndim == 2:
        vals = vals[..., None]
    h, w, s = vals.shape
    assert s == SAMPLES[colour]
    bpp = max(1, depth * s // 8)
    if interlace:
        parts = []
        for k, (x0, y0, dx, dy) in enumerate(ADAM7):
            sub = vals[y0::dy, x0::dx]
            if sub.shape[0] and sub.shape[1]:
                parts.append(_filter_rows(_pack(sub, depth), bpp, k))
        data = b"".join(parts)
    else:
        data = _filter_rows(_pack(vals, depth), bpp, 0)
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, int(interlace)))]
    if palette is not None:
        out.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        out.append(_chunk(b"tRNS", trns))
    idat = zlib.compress(data, level)
    out += [_chunk(b"IDAT", idat[i:i + 8192]) for i in range(0, len(idat), 8192)]
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def _palette(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 3), dtype=np.uint8)


def _spec_pngs() -> dict:
    """name -> bytes of the PNGs written from the specification."""
    g16 = seeded(37, 45, 1, 1, 65535)
    files = {
        "grey2_33x29.png": png_bytes(seeded(29, 33, 1, 2, 3), 2, 0),
        "grey4_41x27.png": png_bytes(seeded(27, 41, 1, 3, 15), 4, 0),
        "grey4_trns_19x23.png": png_bytes(seeded(23, 19, 1, 4, 15), 4, 0, trns=b"\x00\x00"),
        "grey8_trns_21x17.png": png_bytes(seeded(17, 21, 1, 5), 8, 0, trns=b"\x00\x80"),
        "grey16_trns_31x23.png": png_bytes(g16[:23, :31], 16, 0, trns=b"\x01\x2c"),
        "rgb16_37x45.png": png_bytes(seeded(37, 45, 3, 6, 65535), 16, 2),
        "rgb16_trns_29x31.png": png_bytes(seeded(31, 29, 3, 7, 65535), 16, 2,
                                          trns=struct.pack(">HHH", 0x1280, 0x40, 0x33)),
        "rgb8_trns_27x25.png": png_bytes(seeded(25, 27, 3, 8), 8, 2, trns=b"\x00\x40\x00\x80\x00\xc0"),
        "rgba16_33x39.png": png_bytes(seeded(39, 33, 4, 9, 65535), 16, 6),
        "la16_35x21.png": png_bytes(seeded(21, 35, 2, 10, 65535), 16, 4),
        "la8_trns_ignored_17x19.png": png_bytes(seeded(19, 17, 2, 11), 8, 4, trns=b"\x00\x05"),
        "bits1_trns_45x13.png": png_bytes(seeded(13, 45, 1, 12, 1), 1, 0, trns=b"\x00\x01"),
        "p2_trns_bytes_31x19.png": png_bytes(seeded(19, 31, 1, 13, 3), 2, 3, _palette(4, 13),
                                             trns=b"\x10\x80"),
        "p4_trns_index_27x33.png": png_bytes(seeded(33, 27, 1, 14, 15), 4, 3, _palette(12, 14),
                                             trns=b"\xff\xff\x00"),
        "p8_short_palette_23x21.png": png_bytes(seeded(21, 23, 1, 15, 255), 8, 3, _palette(40, 15)),
    }
    # Adam7 at every bit depth and colour type, odd sizes below and above one 8x8 block
    adam = [("grey1", 1, 0, 1), ("grey2", 2, 0, 3), ("grey4", 4, 0, 15), ("grey8", 8, 0, 255),
            ("grey16", 16, 0, 65535), ("rgb8", 8, 2, 255), ("rgb16", 16, 2, 65535),
            ("p1", 1, 3, 1), ("p2", 2, 3, 3), ("p4", 4, 3, 15), ("p8", 8, 3, 255),
            ("la8", 8, 4, 255), ("la16", 16, 4, 65535), ("rgba8", 8, 6, 255),
            ("rgba16", 16, 6, 65535)]
    sizes = [(5, 3), (37, 29), (64, 61), (1, 9), (23, 19)]
    for k, (kind, depth, colour, top) in enumerate(adam):
        h, w = sizes[k % len(sizes)]
        vals = seeded(h, w, SAMPLES[colour], 20 + k, top)
        pal = _palette(min(top + 1, 256), 20 + k) if colour == 3 else None
        files[f"adam7_{kind}_{w}x{h}.png"] = png_bytes(vals, depth, colour, pal, interlace=True)
    files["adam7_rgb8_trns_9x7.png"] = png_bytes(seeded(7, 9, 3, 40), 8, 2, interlace=True,
                                                 trns=b"\x00\x00\x00\x00\x00\x00")
    return files


def _pillow_pngs(Image) -> dict:
    """name -> bytes of the PNGs Pillow writes."""
    out = {}

    def save(name, img, **kw):
        buf = io.BytesIO()
        img.save(buf, "PNG", **kw)
        out[name] = buf.getvalue()

    for bits, (h, w) in ((1, (23, 37)), (2, (31, 17)), (4, (29, 43))):
        img = Image.fromarray(seeded(h, w, 1, 50 + bits, (1 << bits) - 1).astype(np.uint8), "L")
        img = img.convert("P")
        img.putpalette(_palette(1 << bits, bits).ravel().tolist())
        save(f"pillow_p{bits}_{w}x{h}.png", img, bits=bits)
    save("pillow_mode1_45x19.png", Image.fromarray(seeded(19, 45, 1, 60, 1).astype(bool)))
    save("pillow_i16_33x27.png", Image.fromarray(seeded(27, 33, 1, 61, 65535)))
    save("pillow_la_25x31.png", Image.fromarray(seeded(31, 25, 2, 62), "LA"))
    return out


# --- BMP ---------------------------------------------------------------------------------


def _rows_bottom_up(rows: list[bytes], top_down: bool) -> bytes:
    """Rows padded to four bytes, bottom row first unless ``top_down``."""
    padded = [r + b"\0" * (-len(r) % 4) for r in rows]
    return b"".join(padded if top_down else padded[::-1])


def bmp_bytes(w: int, h: int, bits: int, pixels: bytes, compression: int = 0,
              palette: np.ndarray | None = None, masks=None, header: int = 40,
              top_down: bool = False) -> bytes:
    """A BMP: file header, an info header of ``header`` bytes (12: OS/2
    core; 40, 52, 56, 108, 124: Windows), bitfield masks after a 40-byte
    header or inside a longer one, the palette (BGRX, BGR under the core
    header), then ``pixels`` as given (already in file order)."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        hh = (2**32 - h) if top_down else h
        colors = 0 if palette is None else len(palette)
        info = struct.pack("<IIIHHIIiiII", header, w, hh, 1, bits, compression, len(pixels),
                           2835, 2835, colors, colors)
        extra = b""
        if masks is not None and header > 40:
            extra = struct.pack("<" + "I" * len(masks), *masks)[:header - 40]
        info += extra + b"\0" * (header - 40 - len(extra))
        if masks is not None and header == 40:
            info += struct.pack("<III", *masks[:3])
    pal = b""
    if palette is not None:
        pal = (np.concatenate([palette[:, ::-1], np.zeros((len(palette), 1), np.uint8)], 1)
               .tobytes() if header != 12 else palette[:, ::-1].tobytes())
    offset = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<III", offset + len(pixels), 0, offset) + info + pal + pixels


def rle8(idx: np.ndarray, top_down: bool = False) -> bytes:
    """RLE8 of (H, W) indices: runs of equal values as (count, value),
    other stretches of three or more as absolute runs padded to 16 bits,
    an end of line after each row, an end of bitmap at the end."""
    out = bytearray()
    rows = idx if top_down else idx[::-1]
    for row in rows.tolist():
        x = 0
        while x < len(row):
            run = 1
            while x + run < len(row) and row[x + run] == row[x] and run < 255:
                run += 1
            if run >= 2:
                out += bytes([run, row[x]])
                x += run
                continue
            end = x + 1  # a literal stretch to the next run of two
            while end < len(row) and end - x < 255 and \
                    not (end + 1 < len(row) and row[end] == row[end + 1]):
                end += 1
            if end - x >= 3:
                out += bytes([0, end - x]) + bytes(row[x:end]) + (b"\0" if (end - x) % 2 else b"")
            else:
                for v in row[x:end]:
                    out += bytes([1, v])
            x = end
        out += b"\0\0"
    return bytes(out + b"\0\1")


def rle4(idx: np.ndarray) -> bytes:
    """RLE4 of (H, W) indices 0..15, bottom-up: pairs of alternating values
    as (count, hi << 4 | lo), literal stretches of four or more as absolute
    runs padded to 16 bits, an end of line after each row, an end of
    bitmap at the end."""
    out = bytearray()
    for row in idx[::-1].tolist():
        x = 0
        while x < len(row):
            if len(row) - x >= 8 and x % 3 == 0:  # an absolute run now and then
                n = min(9, len(row) - x)
                vals = row[x:x + n] + [0] * (n % 2)
                packed = bytes((vals[i] << 4) | vals[i + 1] for i in range(0, n + n % 2, 2))
                out += bytes([0, n]) + packed + (b"\0" if len(packed) % 2 else b"")
                x += n
                continue
            a = row[x]
            b = row[x + 1] if x + 1 < len(row) else 0
            run = 1  # how far the alternation a, b, a, b ... goes
            while x + run < len(row) and run < 255 and row[x + run] == (a, b)[run % 2]:
                run += 1
            out += bytes([run, (a << 4) | b])
            x += run
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _packed_rows(idx: np.ndarray, bits: int) -> list[bytes]:
    h, w = idx.shape
    per = 8 // bits
    pad = np.zeros((h, (-w) % per), np.uint8)
    v = np.concatenate([idx.astype(np.uint8), pad], axis=1).reshape(h, -1, per)
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    packed = (v << shifts).sum(axis=2, dtype=np.uint16).astype(np.uint8)
    return [r.tobytes() for r in packed]


def _spec_bmps() -> dict:
    """name -> bytes of the BMPs written from the specification."""
    files = {}
    idx8 = (seeded(29, 35, 1, 70) // 32).astype(np.uint8)  # long runs
    files["rle8_35x29.bmp"] = bmp_bytes(35, 29, 8, rle8(idx8), 1, _palette(8, 70))
    noisy = seeded(19, 41, 1, 71).astype(np.uint8)
    files["rle8_noisy_topdown_41x19.bmp"] = bmp_bytes(41, 19, 8, rle8(noisy, True), 1,
                                                      _palette(256, 71), top_down=True)
    idx4 = (seeded(27, 37, 1, 72) // 16).astype(np.uint8)
    files["rle4_37x27.bmp"] = bmp_bytes(37, 27, 4, rle4(idx4), 2, _palette(16, 72))
    grey_ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    files["rle8_grey_23x17.bmp"] = bmp_bytes(23, 17, 8, rle8(seeded(17, 23, 1, 73) // 8), 1,
                                             grey_ramp)
    rgb = seeded(23, 31, 3, 74)
    r5, g6, b5 = rgb[..., 0] >> 3, rgb[..., 1] >> 2, rgb[..., 2] >> 3
    p565 = ((r5.astype(np.uint16) << 11) | (g6.astype(np.uint16) << 5) | b5).astype("<u2")
    files["bitfields565_31x23.bmp"] = bmp_bytes(
        31, 23, 16, _rows_bottom_up([r.tobytes() for r in p565], False), 3,
        masks=(0xF800, 0x7E0, 0x1F))
    p555 = ((r5.astype(np.uint16) << 10) | ((rgb[..., 1] >> 3).astype(np.uint16) << 5)
            | b5).astype("<u2")
    files["rgb555_topdown_31x23.bmp"] = bmp_bytes(
        31, 23, 16, _rows_bottom_up([r.tobytes() for r in p555], True), top_down=True)
    files["bitfields555_v3_31x23.bmp"] = bmp_bytes(
        31, 23, 16, _rows_bottom_up([r.tobytes() for r in p555], False), 3,
        masks=(0x7C00, 0x3E0, 0x1F, 0), header=56)
    rgba = seeded(21, 27, 4, 75)
    bgra = [r.tobytes() for r in rgba[..., [2, 1, 0, 3]]]
    files["bitfields_bgra_v4_27x21.bmp"] = bmp_bytes(
        27, 21, 32, _rows_bottom_up(bgra, False), 3, masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000),
        header=108)
    abgr = [r.tobytes() for r in rgba[..., [3, 2, 1, 0]]]
    files["bitfields_abgr_v5_topdown_27x21.bmp"] = bmp_bytes(
        27, 21, 32, _rows_bottom_up(abgr, True), 3, masks=(0xFF000000, 0xFF0000, 0xFF00, 0xFF),
        header=124, top_down=True)
    xbgr = [r.tobytes() for r in rgba[..., [3, 2, 1, 0]]]
    files["bitfields_xbgr_52_27x21.bmp"] = bmp_bytes(
        27, 21, 32, _rows_bottom_up(xbgr, False), 3, masks=(0xFF000000, 0xFF0000, 0xFF00),
        header=52)
    files["rgb32_bgrx_27x21.bmp"] = bmp_bytes(27, 21, 32, _rows_bottom_up(bgra, False))
    files["rgb24_topdown_v5_33x25.bmp"] = bmp_bytes(
        33, 25, 24, _rows_bottom_up([r.tobytes() for r in seeded(25, 33, 3, 76)[..., ::-1]],
                                    True), header=124, top_down=True)
    idx = (seeded(19, 29, 1, 77) // 64).astype(np.uint8)
    files["core_p4_29x19.bmp"] = bmp_bytes(29, 19, 4, _rows_bottom_up(_packed_rows(idx, 4),
                                                                      False),
                                           palette=_palette(4, 77), header=12)
    files["core_rgb24_21x13.bmp"] = bmp_bytes(
        21, 13, 24, _rows_bottom_up([r.tobytes() for r in seeded(13, 21, 3, 78)[..., ::-1]],
                                    False), header=12)
    files["p1_colour_topdown_45x17.bmp"] = bmp_bytes(
        45, 17, 1, _rows_bottom_up(_packed_rows(seeded(17, 45, 1, 79, 1), 1), True),
        palette=_palette(2, 79), top_down=True)
    return files


def _pillow_bmps(Image) -> dict:
    out = {}
    for name, arr in (("pillow_1_43x19.bmp", seeded(19, 43, 1, 90, 1).astype(bool)),
                      ("pillow_l_37x23.bmp", seeded(23, 37, 1, 91)),
                      ("pillow_rgb_33x29.bmp", seeded(29, 33, 3, 92)),
                      ("pillow_rgba_27x31.bmp", seeded(31, 27, 4, 93))):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "BMP")
        out[name] = buf.getvalue()
    img = Image.fromarray(seeded(25, 39, 1, 94), "L").convert("P")
    img.putpalette(_palette(256, 94).ravel().tolist())
    buf = io.BytesIO()
    img.save(buf, "BMP")
    out["pillow_p_39x25.bmp"] = buf.getvalue()
    return out


# BMP writes: (input name, shape, channels, seed); bool for mode 1
WRITES = [("l", (23, 37), 1, 100), ("l", (1, 5), 1, 101), ("rgb", (29, 33), 3, 102),
          ("rgb", (7, 1), 3, 103), ("rgba", (31, 27), 4, 104), ("rgba", (3, 61), 4, 105),
          ("1", (19, 43), 1, 106)]


def write_input(kind: str, shape, channels: int, seed: int) -> np.ndarray:
    arr = seeded(*shape, channels, seed, 1 if kind == "1" else 255)
    return arr.astype(bool) if kind == "1" else arr


def pixels_digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def entry(arr: np.ndarray, mode: str) -> dict:
    return {"sha256": pixels_digest(arr), "shape": list(arr.shape), "dtype": arr.dtype.str,
            "mode": mode}


def spec_writers():
    """``spec_writers.py`` beside this script, as a module."""
    spec = importlib.util.spec_from_file_location("image_spec_writers",
                                                  os.path.join(HERE, "spec_writers.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --- GIF, TIFF, WebP ----------------------------------------------------------------------


def _gifs(Image, sw) -> dict:
    out = {}
    pal = _palette(16, 200)
    idx = (seeded(23, 37, 1, 201) // 16).astype(np.uint8)
    grey = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    big = seeded(90, 97, 1, 202)
    spec = {
        "gif89a_global16_37x23.gif": ([dict(indices=idx)], (37, 23), pal, {}),
        "gif87a_interlaced_37x23.gif": ([dict(indices=idx, interlace=True)], (37, 23), pal,
                                        {"version": b"GIF87a"}),
        "gif_transparency_37x23.gif": ([dict(indices=idx, transparency=5)], (37, 23), pal, {}),
        "gif_minbits4_blocks7_37x23.gif": ([dict(indices=idx, min_bits=4, block=7)], (37, 23),
                                           pal, {}),
        "gif_full_table_no_clear_97x90.gif": ([dict(indices=big, clear_when_full=False)],
                                              (97, 90), _palette(256, 203), {}),
        "gif_full_table_clear_97x90.gif": ([dict(indices=big)], (97, 90), _palette(256, 204), {}),
        "gif_offset_frame_50x40.gif": ([dict(indices=idx, offset=(5, 3))], (50, 40), pal, {}),
        "gif_offset_transparent_50x40.gif": ([dict(indices=idx, offset=(5, 3), transparency=7)],
                                             (50, 40), pal, {}),
        "gif_frame_grows_screen_57x32.gif": ([dict(indices=idx, offset=(20, 9))], (30, 20), pal,
                                             {}),
        "gif_local_only_37x23.gif": ([dict(indices=idx, palette=pal[::-1])], (37, 23), None, {}),
        "gif_local_grey_hides_global_37x23.gif": ([dict(indices=idx, palette=grey[:16])],
                                                  (37, 23), pal, {}),
        "gif_no_palette_37x23.gif": ([dict(indices=idx)], (37, 23), None, {}),
        "gif_global_grey_37x23.gif": ([dict(indices=idx)], (37, 23), grey, {}),
        "gif_1bit_interlaced_37x5.gif": ([dict(indices=idx[:5] & 1, interlace=True, min_bits=2)],
                                         (37, 5), pal[:2], {}),
        "gif_animated_extensions_37x23.gif": (
            [dict(indices=idx, transparency=2), dict(indices=idx[::-1], palette=pal[::-1])],
            (37, 23), pal,
            {"extensions": b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00!\xfe\x05hello\x00"}),
    }
    for name, (frames, screen, palette, kw) in spec.items():
        out[name] = sw.gif_bytes(frames, screen, palette, **kw)
    rgb = seeded(29, 43, 3, 205)

    def save(name, img, **kw):
        buf = io.BytesIO()
        img.save(buf, "GIF", **kw)
        out[name] = buf.getvalue()

    save("pillow_rgb_43x29.gif", Image.fromarray(rgb))
    save("pillow_l_43x29.gif", Image.fromarray(rgb[..., 0]))
    save("pillow_1_43x29.gif", Image.fromarray(rgb[..., 0] > 128))
    save("pillow_interlace_trns_43x29.gif", Image.fromarray(rgb).convert("P"), interlace=True,
         transparency=3)
    frames = [Image.fromarray(rgb), Image.fromarray(rgb[::-1].copy())]
    save("pillow_animated_43x29.gif", frames[0], save_all=True, append_images=frames[1:])
    return out


def _tiffs(Image, sw) -> dict:
    out = {}
    rng = np.random.default_rng(210)
    h, w = 23, 37
    v8 = seeded(h, w, 4, 211)
    u16 = seeded(h, w, 4, 212, 65535)
    cmap = lambda n: rng.integers(0, 65536, (n, 3))  # noqa: E731
    cases = {
        "rgb_lzw_predictor2_37x23.tif": (v8[..., :3], dict(photometric=2, compression=5,
                                                           predictor=2)),
        "rgb_lzw_old_style_37x23.tif": (v8[..., :3], dict(photometric=2, compression=5,
                                                          old_lzw=True)),
        "rgb_deflate_planar_strips5_37x23.tif": (v8[..., :3], dict(
            photometric=2, compression=8, planar=2, rows_per_strip=5)),
        "rgb_deflate32946_tiles16_37x23.tif": (v8[..., :3], dict(photometric=2, compression=32946,
                                                                  tile=(16, 16))),
        "rgb_lzw_tiles_planar_pred2_37x23.tif": (v8[..., :3], dict(
            photometric=2, compression=5, tile=(16, 16), planar=2, predictor=2)),
        "rgb_mm_packbits_37x23.tif": (v8[..., :3], dict(photometric=2, compression=32773,
                                                        byteorder=">")),
        "rgb_bigtiff_deflate_37x23.tif": (v8[..., :3], dict(photometric=2, compression=8,
                                                            bigtiff=True)),
        "rgba_unassociated_37x23.tif": (v8, dict(photometric=2, extra=(2,))),
        "rgba_associated_lzw_37x23.tif": (v8, dict(photometric=2, extra=(1,), compression=5)),
        "rgbx_unspecified_extra_37x23.tif": (v8, dict(photometric=2, extra=(0,))),
        "rgba_no_extrasamples_37x23.tif": (v8, dict(photometric=2)),
        "la_deflate_37x23.tif": (v8[..., :2], dict(photometric=1, extra=(2,), compression=8)),
        "l_min_is_white_37x23.tif": (v8[..., 0], dict(photometric=0)),
        "l_fillorder2_lzw_37x23.tif": (v8[..., 0], dict(photometric=1, fillorder=2,
                                                         compression=5)),
        "l_fillorder2_raw_37x23.tif": (v8[..., 0], dict(photometric=1, fillorder=2)),
        "l4_37x23.tif": (v8[..., 0] >> 4, dict(photometric=1, bits=4)),
        "l4_min_is_white_lzw_37x23.tif": (v8[..., 0] >> 4, dict(photometric=0, bits=4,
                                                                 compression=5)),
        "l2_37x23.tif": (v8[..., 0] >> 6, dict(photometric=1, bits=2)),
        "bilevel_packbits_37x23.tif": (v8[..., 0] >> 7, dict(photometric=1, bits=1,
                                                              compression=32773)),
        "bilevel_min_is_white_37x23.tif": (v8[..., 0] >> 7, dict(photometric=0, bits=1)),
        "bilevel_white_fill2_deflate_37x23.tif": (v8[..., 0] >> 7, dict(
            photometric=0, bits=1, fillorder=2, compression=8)),
        "p8_37x23.tif": (v8[..., 0], dict(photometric=3, colormap=cmap(256))),
        "p4_lzw_37x23.tif": (v8[..., 0] >> 4, dict(photometric=3, bits=4, colormap=cmap(16),
                                                   compression=5)),
        "p2_37x23.tif": (v8[..., 0] >> 6, dict(photometric=3, bits=2, colormap=cmap(4))),
        "p1_37x23.tif": (v8[..., 0] >> 7, dict(photometric=3, bits=1, colormap=cmap(2))),
        "pa_37x23.tif": (v8[..., :2], dict(photometric=3, extra=(2,), colormap=cmap(256))),
        "px_37x23.tif": (v8[..., :2], dict(photometric=3, extra=(0,), colormap=cmap(256))),
        "cmyk_lzw_37x23.tif": (v8, dict(photometric=5, compression=5)),
        "cmyk16_deflate_37x23.tif": (u16, dict(photometric=5, bits=16, compression=8)),
        "i16_lzw_predictor2_37x23.tif": (u16[..., 0], dict(photometric=1, bits=16, compression=5,
                                                           predictor=2)),
        "i16_min_is_white_37x23.tif": (u16[..., 0], dict(photometric=0, bits=16)),
        "i16b_mm_37x23.tif": (u16[..., 0], dict(photometric=1, bits=16, byteorder=">")),
        "i16b_mm_lzw_predictor2_37x23.tif": (u16[..., 0], dict(
            photometric=1, bits=16, byteorder=">", compression=5, predictor=2)),
        "i16_signed_37x23.tif": ((u16[..., 0].astype(np.int32) - 32768).astype(np.int16),
                                 dict(photometric=1, bits=16, sample_format=2)),
        "i16_signed_mm_deflate_37x23.tif": ((u16[..., 1].astype(np.int32) - 32768)
                                            .astype(np.int16), dict(
            photometric=1, bits=16, sample_format=2, byteorder=">", compression=8)),
        "i32_signed_lzw_predictor2_37x23.tif": (rng.integers(-2**31, 2**31, (h, w))
                                                .astype(np.int32), dict(
            photometric=1, bits=32, sample_format=2, compression=5, predictor=2)),
        "i32_signed_mm_lzw_37x23.tif": (rng.integers(-2**31, 2**31, (h, w)).astype(np.int32),
                                        dict(photometric=1, bits=32, sample_format=2,
                                             byteorder=">", compression=5)),
        "u32_37x23.tif": (rng.integers(0, 2**32, (h, w)).astype(np.uint32),
                          dict(photometric=1, bits=32)),
        "f32_37x23.tif": ((rng.standard_normal((h, w)) * 300).astype(np.float32),
                          dict(photometric=1, bits=32, sample_format=3)),
        "f32_deflate_predictor3_37x23.tif": ((rng.standard_normal((h, w)) * 300)
                                             .astype(np.float32), dict(
            photometric=1, bits=32, sample_format=3, compression=8, predictor=3)),
        "f32_mm_37x23.tif": ((rng.standard_normal((h, w)) * 300).astype(np.float32),
                             dict(photometric=1, bits=32, sample_format=3, byteorder=">")),
        "f32_mm_deflate_predictor3_37x23.tif": ((rng.standard_normal((h, w)) * 300)
                                                .astype(np.float32), dict(
            photometric=1, bits=32, sample_format=3, byteorder=">", compression=8,
            predictor=3)),
        "rgb16_lzw_predictor2_37x23.tif": (u16[..., :3], dict(photometric=2, bits=16,
                                                              compression=5, predictor=2)),
        "rgb16_mm_37x23.tif": (u16[..., :3], dict(photometric=2, bits=16, byteorder=">")),
        "rgba16_associated_37x23.tif": (u16, dict(photometric=2, bits=16, extra=(1,))),
        "orientation6_37x23.tif": (v8[..., :3], dict(photometric=2, orientation=6)),
        "orientation3_lzw_37x23.tif": (v8[..., :3], dict(photometric=2, orientation=3,
                                                         compression=5)),
        "orientation8_37x23.tif": (v8[..., :3], dict(photometric=2, orientation=8)),
        "three_pages_lzw_37x23.tif": (v8[..., :3], dict(photometric=2, pages=3, compression=5)),
        "raw_strips4_37x23.tif": (v8[..., :3], dict(photometric=2, rows_per_strip=4)),
    }
    for name, (vals, kw) in cases.items():
        out[name] = sw.tiff_bytes(vals, **kw)
    # YCbCr JPEG strips: whole JPEG streams (tables inline) of 16 rows each
    rgb = seeded(40, 45, 3, 213)
    for sub, tag in (("420", (2, 2)), ("444", (1, 1))):
        chunks = []
        for y in range(0, 40, 16):
            buf = io.BytesIO()
            Image.fromarray(rgb[y:y + 16]).save(buf, "JPEG", quality=80,
                                                subsampling=0 if sub == "444" else 2)
            chunks.append(buf.getvalue())
        out[f"ycbcr{sub}_jpeg_strips_45x40.tif"] = sw.tiff_bytes(
            rgb, photometric=6, compression=7, rows_per_strip=16, chunks=chunks,
            extra_tags={530: (3, list(tag))})

    def save(name, img, **kw):
        buf = io.BytesIO()
        img.save(buf, "TIFF", **kw)
        out[name] = buf.getvalue()

    src = seeded(29, 43, 4, 214)
    images = {"rgb": Image.fromarray(src[..., :3]), "rgba": Image.fromarray(src),
              "l": Image.fromarray(src[..., 0]), "1": Image.fromarray(src[..., 0] > 128),
              "la": Image.fromarray(src[..., :2], "LA"),
              "p": Image.fromarray(src[..., :3]).convert("P"),
              "i16": Image.fromarray(seeded(29, 43, 1, 215, 65535)),
              "i": Image.fromarray(seeded(29, 43, 1, 216, 65535).astype(np.int32) - 30000),
              "f": Image.fromarray(seeded(29, 43, 1, 217).astype(np.float32) / 3 - 20),
              "cmyk": Image.fromarray(src[..., :3]).convert("CMYK")}
    for comp in ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits"):
        for kind, img in images.items():
            save(f"pillow_{kind}_{comp}_43x29.tif", img, compression=comp)
    for kind in ("rgb", "l"):
        save(f"pillow_{kind}_jpeg_43x29.tif", images[kind], compression="jpeg")
    save("pillow_rgb_jpeg_q95_43x29.tif", images["rgb"], compression="jpeg", quality=95)
    return out


def libwebp_encode(pixels: np.ndarray, **config) -> bytes:
    """A WebP written by Pillow's bundled libwebp through its advanced API
    (``WebPConfig`` fields by name), for the options Pillow does not pass."""
    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    for dep in glob.glob(os.path.join(libs, "libsharpyuv-*")):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libwebp-*"))[0])
    fields = ["lossless", "quality", "method", "image_hint", "target_size", "target_PSNR",
              "segments", "sns_strength", "filter_strength", "filter_sharpness", "filter_type",
              "autofilter", "alpha_compression", "alpha_filtering", "alpha_quality", "pass_",
              "show_compressed", "preprocessing", "partitions", "partition_limit",
              "emulate_jpeg_size", "thread_level", "low_memory", "near_lossless", "exact",
              "use_delta_palette", "use_sharp_yuv", "qmin", "qmax"]

    class Config(ctypes.Structure):
        _fields_ = [(f, ctypes.c_float if f in ("quality", "target_PSNR") else ctypes.c_int)
                    for f in fields]

    class Writer(ctypes.Structure):
        _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                    ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32)]

    abi = 0x0200  # WEBP_ENCODER_ABI_VERSION's major, which libwebp checks
    cfg = Config()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(75.0), abi):
        raise RuntimeError("libwebp refused the encoder ABI")
    for k, v in config.items():
        setattr(cfg, k, v)
    if not lib.WebPValidateConfig(ctypes.byref(cfg)):
        raise ValueError(f"libwebp refused the configuration {config}")
    pic = (ctypes.c_uint8 * 256)()  # WebPPicture: width at 8, height at 12, writer at 96
    if not lib.WebPPictureInitInternal(pic, abi):
        raise RuntimeError("libwebp refused the picture ABI")
    arr = np.ascontiguousarray(pixels)
    h, w, c = arr.shape
    ctypes.c_int.from_buffer(pic, 8).value = w
    ctypes.c_int.from_buffer(pic, 12).value = h
    importer = lib.WebPPictureImportRGBA if c == 4 else lib.WebPPictureImportRGB
    if not importer(pic, arr.ctypes.data_as(ctypes.c_void_p), w * c):
        raise RuntimeError("WebPPictureImport failed")
    writer = Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    ctypes.c_void_p.from_buffer(pic, 96).value = ctypes.cast(lib.WebPMemoryWrite,
                                                             ctypes.c_void_p).value
    ctypes.c_void_p.from_buffer(pic, 104).value = ctypes.addressof(writer)
    ok = lib.WebPEncode(ctypes.byref(cfg), pic)
    data = ctypes.string_at(writer.mem, writer.size)
    lib.WebPPictureFree(pic)
    lib.WebPMemoryWriterClear(ctypes.byref(writer))
    if not ok:
        raise RuntimeError(f"WebPEncode failed ({config})")
    return data


def _webps(Image, sw) -> dict:
    out = {}
    rgba = seeded(29, 43, 4, 220)

    def save(name, img, **kw):
        buf = io.BytesIO()
        img.save(buf, "WEBP", **kw)
        out[name] = buf.getvalue()
        return out[name]

    rgb_img, rgba_img = Image.fromarray(rgba[..., :3]), Image.fromarray(rgba)
    save("lossless_rgb_43x29.webp", rgb_img, lossless=True)
    save("lossless_rgba_exact_43x29.webp", rgba_img, lossless=True, exact=True)
    save("lossless_rgba_m0_q0_43x29.webp", rgba_img, lossless=True, method=0, quality=0)
    save("lossless_rgba_m6_q100_43x29.webp", rgba_img, lossless=True, method=6, quality=100)
    save("lossless_few_colours_43x29.webp", Image.fromarray(rgba[..., :3] // 64 * 64),
         lossless=True)
    save("lossy_rgb_q80_43x29.webp", rgb_img, quality=80)
    save("lossy_rgb_q5_m0_43x29.webp", rgb_img, quality=5, method=0)
    save("lossy_rgb_q100_m6_43x29.webp", rgb_img, quality=100, method=6)
    lossy = save("lossy_rgba_q60_43x29.webp", rgba_img, quality=60)
    save("lossy_rgba_alpha_q30_43x29.webp", rgba_img, quality=60, alpha_quality=30)
    save("lossy_rgba_exact_43x29.webp", rgba_img, quality=70, exact=True)
    save("lossless_icc_exif_xmp_43x29.webp", rgba_img, lossless=True, icc_profile=b"\0" * 40,
         exif=b"Exif\0\0II*\0" + b"\0" * 10, xmp=b"<x/>")
    save("lossy_icc_43x29.webp", rgb_img, quality=80, icc_profile=b"\0" * 40)
    save("pillow_animated_43x29.webp", rgba_img, save_all=True, lossless=True,
         append_images=[Image.fromarray(rgba[::-1].copy())])
    save("lossy_1x1.webp", Image.fromarray(rgba[:1, :1, :3]), quality=75)
    save("lossy_16x16.webp", Image.fromarray(rgba[:16, :16]), quality=75)
    save("lossless_1x7.webp", Image.fromarray(rgba[:1, :7]), lossless=True)
    alpha = rgba[..., 3]
    for filt, fname in enumerate(("none", "horizontal", "vertical", "gradient")):
        out[f"alph_raw_{fname}_43x29.webp"] = sw.replace_alph(lossy, sw.alph(alpha, filt))
        g = sw.alpha_filtered(alpha, filt)
        buf = io.BytesIO()
        Image.fromarray(np.stack([g * 0, g, g * 0], -1)).save(buf, "WEBP", lossless=True)
        bits = dict(sw.riff_chunks(buf.getvalue()))[b"VP8L"][5:]
        out[f"alph_lossless_{fname}_43x29.webp"] = sw.replace_alph(lossy, sw.alph(alpha, filt,
                                                                                 bits))
    ll = [c for c in sw.riff_chunks(out["lossless_rgba_exact_43x29.webp"]) if c[0] == b"VP8L"]
    ly = [c for c in sw.riff_chunks(out["lossy_rgb_q80_43x29.webp"]) if c[0] == b"VP8 "]
    out["anim_lossless_offset_60x50.webp"] = sw.anim_webp((60, 50), [(4, 6, 43, 29, ll),
                                                                     (0, 0, 43, 29, ly)], True)
    out["anim_lossy_offset_noalpha_60x50.webp"] = sw.anim_webp((60, 50),
                                                               [(10, 2, 43, 29, ly)], False)
    noisy = np.clip(seeded(61, 77, 4, 221).astype(np.int32) +
                    np.random.default_rng(222).integers(-25, 25, (61, 77, 4)), 0, 255
                    ).astype(np.uint8)
    for name, cfg in (("simple_filter", dict(filter_type=0)),
                      ("simple_filter_sharp5", dict(filter_type=0, filter_sharpness=5)),
                      ("sharpness7_strength100", dict(filter_sharpness=7, filter_strength=100)),
                      ("partitions8", dict(partitions=3)),
                      ("one_segment_partitions4", dict(segments=1, partitions=2)),
                      ("no_loop_filter", dict(filter_strength=0)),
                      ("q5_simple_filter", dict(quality=5.0, filter_type=0)),
                      ("alpha_raw", dict(alpha_compression=0)),
                      ("alpha_filter_best", dict(alpha_filtering=2)),
                      ("alpha_preprocessing", dict(preprocessing=2, alpha_quality=40))):
        out[f"libwebp_{name}_77x61.webp"] = libwebp_encode(noisy, **cfg)
    return out


def _frames(Image) -> dict:
    """The 1280x720 frame as a GIF, a JPEG TIFF and a lossy WebP."""
    frame = Image.open(FRAME).convert("RGB")
    out = {}
    for name, fmt, kw in (("frame_1280x720.gif", "GIF", {}),
                          ("frame_1280x720_jpeg.tif", "TIFF", {"compression": "jpeg"}),
                          ("frame_1280x720_q80.webp", "WEBP", {"quality": 80})):
        buf = io.BytesIO()
        frame.save(buf, fmt, **kw)
        out[name] = buf.getvalue()
    return out


def _decode_entry(Image, data: bytes) -> dict:
    with Image.open(io.BytesIO(data)) as img:
        img.load()  # a file Pillow refuses is not a fixture: this raises
        e = entry(np.asarray(img), img.mode)
        e["convert"] = {}
        for c in CONVERTS:
            conv = img.convert(c)
            e["convert"][c] = entry(np.asarray(conv), conv.mode)
    return e


def main() -> None:
    from PIL import Image

    sw = spec_writers()
    files = {**_spec_pngs(), **_pillow_pngs(Image), **_spec_bmps(), **_pillow_bmps(Image),
             **_gifs(Image, sw), **_tiffs(Image, sw), **_webps(Image, sw)}
    frames = _frames(Image)
    for old in os.listdir(HERE):
        if old.endswith((".png", ".bmp") + NEW_KINDS):
            os.remove(os.path.join(HERE, old))
    manifest = {"pillow": Image.__version__, "decode": {}, "write": [], "frames": {}}
    for name, data in sorted(files.items()):
        manifest["decode"][name] = _decode_entry(Image, data)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    for kind, shape, channels, seed in WRITES:
        buf = io.BytesIO()
        Image.fromarray(write_input(kind, shape, channels, seed)).save(buf, "BMP")
        manifest["write"].append({"kind": kind, "shape": list(shape), "channels": channels,
                                  "seed": seed,
                                  "sha256": hashlib.sha256(buf.getvalue()).hexdigest()})
    with Image.open(FRAME) as img:
        manifest["frames"]["frame"] = entry(np.asarray(img.convert("RGB")), "RGB")
    for name, data in sorted(frames.items()):
        with Image.open(io.BytesIO(data)) as img:
            img.load()
            manifest["frames"][name] = entry(np.asarray(img), img.mode)
            manifest["frames"][name]["rgb_sha256"] = pixels_digest(np.asarray(img.convert("RGB")))
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
