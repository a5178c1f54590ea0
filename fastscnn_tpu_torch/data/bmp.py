"""BMP files to numpy arrays, and back, without PIL.

The JAX package reads and writes ``.bmp`` files through Pillow (the int8
calibration images of ``export_model``, the mask editor's images, any
frame or mask a user hands in). This module gives what Pillow 12's
``BmpImagePlugin`` gives, byte for byte, with the standard library and
numpy alone:

- :func:`decode_bmp`: ``np.asarray(Image.open(f))`` and its mode. Headers:
  the 12-byte OS/2 core header and the 40, 52, 56, 64, 108 and 124-byte
  Windows headers; BI_RGB at 1, 4, 8, 16 (5-5-5), 24 and 32 bits,
  BI_BITFIELDS at 16, 24 and 32 bits in the layouts Pillow takes (alpha
  mask included), RLE8 and RLE4; rows bottom-up or top-down. The mode is
  Pillow's: ``1`` for a two-entry black/white palette, ``L`` for a grey
  ramp, ``P`` (indices, and the palette beside them) for any other
  palette, ``RGB`` for 16, 24 and 32-bit BI_RGB, ``RGBA`` for a
  bitfields layout with an alpha mask.
- :func:`encode_bmp`: the bytes of ``Image.fromarray(a).save(f, "BMP")``
  for bool (mode ``1``), uint8 (H, W), (H, W, 3) and (H, W, 4) arrays: a
  40-byte header, 96 dpi, rows bottom-up padded to four bytes; RGBA as
  32-bit BI_RGB, which reads back as ``RGB``, as Pillow's does.
- :func:`bmp_size`: ``Image.open(f).size`` from the header.

What Pillow refuses (other headers, depths, compressions or bitfields
layouts, truncated pixel data) raises a ``ValueError`` naming the file.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["bmp_size", "decode_bmp", "encode_bmp", "is_bmp"]

# BMP bits -> (mode, raw mode) before the palette and bitfields decide
_BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"),
             24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
# BI_BITFIELDS masks Pillow takes -> raw mode (the channel of each byte,
# low byte first, or a 16-bit packing)
_MASKS = {
    32: {(0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX", (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
         (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR", (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA",
         (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
         (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR", (0x0, 0x0, 0x0, 0x0): "BGRA"},
    24: {(0xFF0000, 0xFF00, 0xFF): "BGR"},
    16: {(0xF800, 0x7E0, 0x1F): "BGR;16", (0x7C00, 0x3E0, 0x1F): "BGR;15"},
}
# bits a pixel of each raw mode
_RAW_BITS = {"1": 1, "L": 8, "P;1": 1, "P;4": 4, "P": 8, "BGR;15": 16, "BGR;16": 16, "BGR": 24}
_WINDOWS_HEADERS = (40, 52, 56, 64, 108, 124)
_DPM = int(96 * 39.3701 + 0.5)  # Pillow's default 96 dpi in pixels a metre


def is_bmp(data) -> bool:
    """Whether ``data`` starts with a BMP file header's ``BM``."""
    return bytes(data[:2]) == b"BM"


def _u32(data: bytes, pos: int) -> int:
    return struct.unpack_from("<I", data, pos)[0]


def _u16(data: bytes, pos: int) -> int:
    return struct.unpack_from("<H", data, pos)[0]


def _header(data: bytes, name: str) -> dict:
    """``BmpImageFile._bitmap``'s reading of the headers, the palette
    included: a dict of what the pixel data needs."""
    if len(data) < 18 or not is_bmp(data):
        raise ValueError(f"{name}: not a BMP file")
    offset, hsize = _u32(data, 10), _u32(data, 14)
    hdr = data[18:14 + hsize]
    if hsize < 12 or len(hdr) < hsize - 4:
        raise ValueError(f"{name}: truncated BMP header")
    pos = 14 + hsize  # where Pillow's file pointer stands after the header
    info = {"direction": -1, "rle": 0, "palette": None}
    if hsize == 12:
        width, height, _planes, bits = struct.unpack_from("<HHHH", hdr)
        compression, colors, padding = 0, 0, 3
    elif hsize in _WINDOWS_HEADERS:
        y_flip = hdr[7] == 0xFF
        info["direction"] = 1 if y_flip else -1
        width = _u32(hdr, 0)
        height = 2**32 - _u32(hdr, 4) if y_flip else _u32(hdr, 4)
        bits, compression, colors, padding = _u16(hdr, 10), _u32(hdr, 12), _u32(hdr, 28), 4
        if compression == 3:
            if len(hdr) >= 48:
                n = 4 if len(hdr) >= 52 else 3
                masks = [_u32(hdr, 36 + 4 * i) for i in range(n)] + [0] * (4 - n)
            else:
                if len(data) < pos + 12:
                    raise ValueError(f"{name}: truncated BMP bitfields")
                masks = [_u32(data, pos + 4 * i) for i in range(3)] + [0]
                pos += 12
    else:
        raise ValueError(f"{name}: unsupported BMP header type ({hsize})")
    info["size"] = (width, height)
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT2MODE:
        raise ValueError(f"{name}: unsupported BMP pixel depth ({bits})")
    mode, raw = _BIT2MODE[bits]
    if compression == 3:
        if bits == 32 and tuple(masks) in _MASKS[32]:
            raw = _MASKS[32][tuple(masks)]
            mode = "RGBA" if "A" in raw else mode
        elif bits in (24, 16) and tuple(masks[:3]) in _MASKS[bits]:
            raw = _MASKS[bits][tuple(masks[:3])]
        else:
            raise ValueError(f"{name}: unsupported BMP bitfields layout")
    elif compression in (1, 2):
        info["rle"] = compression
    elif compression != 0:
        raise ValueError(f"{name}: unsupported BMP compression ({compression})")
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"{name}: unsupported BMP palette size ({colors})")
        pal = data[pos:pos + padding * colors]
        ramp = (0, 255) if colors == 2 else range(colors)
        if all(pal[i * padding:i * padding + 3] == bytes([v & 255]) * 3
               for i, v in enumerate(ramp)):
            mode = raw = "1" if colors == 2 else "L"
        else:
            entries = np.frombuffer(pal[:len(pal) // padding * padding], np.uint8)
            info["palette"] = entries.reshape(-1, padding)[:, 2::-1]
    info.update(mode=mode, raw=raw, offset=offset, bits=bits)
    return info


def bmp_size(data: bytes, name: str = "<bytes>") -> tuple[int, int]:
    """``Image.open(f).size``, (width, height), from a BMP's headers."""
    return _header(bytes(data), name)["size"]


def decode_bmp(data, name: str = "<bytes>"):
    """``(array, mode, palette)`` of a BMP file's bytes: the array and mode
    of ``np.asarray(Image.open(f))``, and a palette image's (N, 3) RGB
    entries (None for any other mode)."""
    data = bytes(data)
    info = _header(data, name)
    (w, h), mode, raw = info["size"], info["mode"], info["raw"]
    if info["rle"]:
        if mode == "1":
            raise ValueError(f"{name}: an RLE BMP with a black/white palette (Pillow has no "
                             "unpacker for it)")
        flat = _rle(data, info["offset"], w, h, info["rle"] == 2)
        if len(flat) < w * h:
            raise ValueError(f"{name}: not enough image data in the RLE BMP")
        rows = np.frombuffer(flat, np.uint8, w * h).reshape(h, w)
        arr = rows[::-1] if info["direction"] < 0 else rows
        return np.ascontiguousarray(arr), mode, info["palette"]
    stride = ((w * info["bits"] + 31) >> 3) & ~3
    nbytes = (w * (32 if len(raw) == 4 else _RAW_BITS[raw]) + 7) // 8
    if nbytes > stride:
        raise ValueError(f"{name}: BMP rows of {stride} bytes cannot hold {w} pixels of {raw}")
    if h and len(data) < info["offset"] + (h - 1) * stride + nbytes:
        raise ValueError(f"{name}: truncated BMP pixel data")
    buf = np.frombuffer(data, np.uint8, (h - 1) * stride + nbytes if h else 0, info["offset"])
    rows = np.lib.stride_tricks.as_strided(buf, (h, nbytes), (stride, 1)) if h else \
        np.zeros((0, nbytes), np.uint8)
    if info["direction"] < 0:
        rows = rows[::-1]
    return _unpack(rows, w, raw), mode, info["palette"]


def _unpack(rows: np.ndarray, w: int, raw: str) -> np.ndarray:
    """Pillow's unpacker of ``raw`` over (H, row bytes) uint8 rows."""
    if raw in ("1", "P;1"):
        bits = np.unpackbits(rows, axis=1)[:, :w]
        # mode 1 as Pillow's array interface gives it: bool, its True bytes 255
        return (bits * np.uint8(255)).view(bool) if raw == "1" else bits
    if raw == "P;4":
        return np.stack([rows >> 4, rows & 15], axis=2).reshape(rows.shape[0], -1)[:, :w]
    if raw in ("L", "P"):
        return np.ascontiguousarray(rows[:, :w])
    if raw in ("BGR;15", "BGR;16"):
        p = rows[:, :2 * w].reshape(rows.shape[0], w, 2).astype(np.uint32)
        p = p[..., 0] | (p[..., 1] << 8)
        if raw == "BGR;15":
            r, g, b = (p >> 10) & 31, (p >> 5) & 31, p & 31
            rgb = (r * 255 // 31, g * 255 // 31, b * 255 // 31)
        else:
            r, g, b = (p >> 11) & 31, (p >> 5) & 63, p & 31
            rgb = (r * 255 // 31, g * 255 // 63, b * 255 // 31)
        return np.stack(rgb, axis=-1).astype(np.uint8)
    if raw == "BGR":
        return np.ascontiguousarray(rows[:, :3 * w].reshape(rows.shape[0], w, 3)[..., ::-1])
    px = rows[:, :4 * w].reshape(rows.shape[0], w, 4)
    order = [raw.index(c) for c in ("RGBA" if "A" in raw else "RGB")]
    return np.ascontiguousarray(px[..., order])


def _rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> bytearray:
    """Pillow's ``BmpRleDecoder`` step for step (its quirks included): one
    byte a pixel, ``w * h`` of them when the data is whole."""
    out = bytearray()
    x, need, n = 0, w * h, len(data)
    while len(out) < need:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:  # encoded mode: a run, clipped at the row's end
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:  # end of line
            while w and len(out) % w:
                out.append(0)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: Pillow reads two bytes, then its offsets from the next two
            if pos + 2 > n:
                break
            pos += 2
            if pos + 2 > n:
                raise ValueError("truncated BMP RLE delta")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w if w else 0
        else:  # absolute mode: ``byte`` pixels, padded to a 16-bit boundary of the file
            take = byte // 2 if rle4 else byte
            chunk = data[pos:pos + take]
            pos += len(chunk)
            if rle4:
                out += bytes(np.stack([np.frombuffer(chunk, np.uint8) >> 4,
                                       np.frombuffer(chunk, np.uint8) & 15], 1).ravel())
            else:
                out += chunk
            if len(chunk) < take:
                break
            x += byte
            if pos % 2:
                pos += 1
    return out


def encode_bmp(arr: np.ndarray) -> bytes:
    """The bytes of ``Image.fromarray(arr).save(f, "BMP")``: bool (H, W) as
    a 1-bit image with a black/white palette, uint8 (H, W) as 8-bit with a
    grey ramp, (H, W, 3) as 24-bit and (H, W, 4) as 32-bit BI_RGB."""
    arr = np.asarray(arr)
    if arr.dtype == bool and arr.ndim == 2:
        bits, palette = 1, b"\x00\x00\x00\x00\xff\xff\xff\x00"
        rows = np.packbits(arr, axis=1)
    elif arr.dtype != np.uint8:
        raise TypeError(f"a BMP is written from bool or uint8 arrays, not {arr.dtype}")
    elif arr.ndim == 2:
        bits, palette = 8, np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
        palette[:, 3] = 0
        palette, rows = palette.tobytes(), arr
    elif arr.ndim == 3 and arr.shape[2] in (3, 4):
        bits, palette = 8 * arr.shape[2], b""
        order = [2, 1, 0] if arr.shape[2] == 3 else [2, 1, 0, 3]
        rows = arr[..., order].reshape(arr.shape[0], -1)
    else:
        raise ValueError(f"a BMP is written from (H, W), (H, W, 3) or (H, W, 4) arrays, not "
                         f"{arr.shape}")
    h, w = arr.shape[:2]
    stride = ((w * bits + 7) // 8 + 3) & ~3
    body = np.zeros((h, stride), np.uint8)
    body[:, :rows.shape[1]] = rows
    colors = len(palette) // 4
    offset = 14 + 40 + 4 * colors
    image = stride * h
    head = (b"BM" + struct.pack("<III", offset + image, 0, offset)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, 0, image, _DPM, _DPM, colors,
                          colors))
    return head + palette + body[::-1].tobytes()
