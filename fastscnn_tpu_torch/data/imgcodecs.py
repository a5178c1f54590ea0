"""``ctypes`` over ``imgcodecs.cpp``: the bit-level work of the GIF, TIFF
and WebP readers (``data/gif.py``, ``data/tiff.py``, ``data/webp.py``).

The library is compiled with ``g++`` at first use
(``utils/native.build_library``), never at import; ctypes releases the
interpreter lock for each call, so loader threads decode in parallel. A
call that fails raises a ``ValueError`` naming the file, the failure and
:data:`~fastscnn_tpu_torch.data.jpeg.ROADMAP_ITEM`.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from fastscnn_tpu_torch.data.jpeg import ROADMAP_ITEM

__all__ = ["alpha_plane", "check_pixels", "gif_lzw", "load_codecs", "packbits", "tiff_lzw",
           "vp8", "vp8l"]

# Pillow's Image.MAX_IMAGE_PIXELS; twice it raises DecompressionBombError on open
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3

_SRC = Path(__file__).resolve().parent / "imgcodecs.cpp"
_LOCK = threading.Lock()
_LIB = None
_ERR = 512


def load_codecs() -> ctypes.CDLL:
    """Compile (at first use, when the library for this source is missing)
    and load the codec library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        from fastscnn_tpu_torch.utils.native import build_library

        lib = ctypes.CDLL(str(build_library(_SRC, "imgcodecs")))
        p, sz, i, c, lg = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_char_p, \
            ctypes.c_long
        lib.ic_gif_lzw.argtypes = [p, sz, i, p, lg, c, i]
        lib.ic_gif_lzw.restype = lg
        lib.ic_tiff_lzw.argtypes = [p, sz, p, sz, c, i]
        lib.ic_tiff_lzw.restype = lg
        lib.ic_packbits.argtypes = [p, sz, p, sz]
        lib.ic_packbits.restype = lg
        for fn in (lib.ic_vp8l, lib.ic_alpha, lib.ic_vp8):
            fn.argtypes = [p, sz, i, i, p, c, i]
            fn.restype = i
        _LIB = lib
        return lib


def check_pixels(width: int, height: int, name: str) -> None:
    """Refuse what Pillow refuses on open: an empty image, or more than
    twice ``MAX_IMAGE_PIXELS`` pixels (a decompression bomb)."""
    if width < 1 or height < 1:
        raise ValueError(f"{name}: an image of {width}x{height} pixels")
    if width * height > 2 * MAX_IMAGE_PIXELS:
        raise ValueError(f"{name}: {width * height} pixels exceed twice Pillow's limit of "
                         f"{MAX_IMAGE_PIXELS} (a decompression bomb)")


def _fail(err, name: str, what: str):
    raise ValueError(f"{name}: {what}: {err.value.decode(errors='replace')} ({ROADMAP_ITEM})")


def gif_lzw(data: bytes, min_bits: int, npix: int, out: np.ndarray, name: str) -> int:
    """GIF LZW ``data`` (the sub-blocks joined) into the first of ``npix``
    uint8 indices of ``out``; how many it wrote."""
    err = ctypes.create_string_buffer(_ERR)
    n = load_codecs().ic_gif_lzw(data, len(data), min_bits, out.ctypes.data, npix, err, _ERR)
    if n < 0:
        _fail(err, name, "GIF image data")
    return n


def tiff_lzw(data: bytes, size: int, name: str) -> np.ndarray:
    """A TIFF LZW strip or tile, up to ``size`` bytes (fewer where its EOI
    comes first)."""
    out = np.zeros(size, np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    n = load_codecs().ic_tiff_lzw(data, len(data), out.ctypes.data, size, err, _ERR)
    if n < 0:
        _fail(err, name, "TIFF LZW data")
    return out[:n]


def packbits(data: bytes, size: int) -> np.ndarray:
    """A PackBits strip or tile, up to ``size`` bytes."""
    out = np.zeros(size, np.uint8)
    n = load_codecs().ic_packbits(data, len(data), out.ctypes.data, size)
    return out[:n]


def vp8l(data: bytes, width: int, height: int, name: str) -> np.ndarray:
    """A VP8L bitstream (from its signature byte) to (H, W, 4) RGBA."""
    argb = np.empty((height, width), np.uint32)
    err = ctypes.create_string_buffer(_ERR)
    if load_codecs().ic_vp8l(data, len(data), width, height, argb.ctypes.data, err, _ERR):
        _fail(err, name, "WebP lossless bitstream")
    return np.ascontiguousarray(argb.astype("<u4").view(np.uint8).reshape(height, width, 4)
                                [..., [2, 1, 0, 3]])


def vp8(data: bytes, width: int, height: int, name: str) -> np.ndarray:
    """A VP8 key frame to (H, W, 4) RGBA, alpha 255."""
    rgba = np.empty((height, width, 4), np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    if load_codecs().ic_vp8(data, len(data), width, height, rgba.ctypes.data, err, _ERR):
        _fail(err, name, "WebP lossy bitstream")
    return rgba


def alpha_plane(data: bytes, width: int, height: int, name: str) -> np.ndarray:
    """An ALPH chunk's payload to the (H, W) uint8 alpha plane."""
    out = np.empty((height, width), np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    if load_codecs().ic_alpha(data, len(data), width, height, out.ctypes.data, err, _ERR):
        _fail(err, name, "WebP ALPH chunk")
    return out
