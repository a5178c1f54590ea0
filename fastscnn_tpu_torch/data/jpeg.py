"""JPEG decoding and encoding without PIL: ``ctypes`` over ``jpeg.cpp``.

The JAX package reads and writes JPEG through Pillow, which the machine
that runs the port on the card does not have. ``jpeg.cpp`` is a host C++
codec written to give Pillow's results where Pillow uses libjpeg-turbo:

- :func:`decode_jpeg` gives the pixels of ``np.asarray(Image.open(f))``
  (the islow IDCT, fancy upsampling, libjpeg's colour conversion) for
  baseline, extended-sequential and progressive Huffman files, 8-bit,
  1 component (mode ``L``) or 3 (``RGB``), 4:4:4, 4:2:2 or 4:2:0, with or
  without restart intervals;
- :func:`encode_jpeg` gives the bytes of ``Image.fromarray(a).save(f,
  "JPEG", quality=q)``: baseline, 4:2:0 for RGB, the standard tables.

Any other variant raises a ``ValueError`` naming it and
:data:`ROADMAP_ITEM`; nothing here falls back to PIL. The library is
compiled with ``g++`` at first use (``utils/native.build_library``), and
each call releases the interpreter lock, so loader threads decode in
parallel.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

__all__ = ["decode_jpeg", "encode_jpeg", "is_jpeg", "load_codec", "ROADMAP_ITEM"]

ROADMAP_ITEM = "ROADMAP.md, queue 1, item 10: formats only PIL reads"
_SRC = Path(__file__).resolve().parent / "jpeg.cpp"
_LOCK = threading.Lock()
_LIB = None
_ERR = 512


def load_codec() -> ctypes.CDLL:
    """Compile (at first use, when the library for this source is missing)
    and load the codec library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        from fastscnn_tpu_torch.utils.native import build_library

        lib = ctypes.CDLL(str(build_library(_SRC, "jpegcodec")))
        i, p, sz = ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t
        ip = ctypes.POINTER(ctypes.c_int)
        lib.jc_info.argtypes = [p, sz, ip, ip, ip, ctypes.c_char_p, i]
        lib.jc_info.restype = i
        lib.jc_decode.argtypes = [p, sz, p, i, i, i, ctypes.c_char_p, i]
        lib.jc_decode.restype = i
        lib.jc_encode_bound.argtypes = [i, i, i]
        lib.jc_encode_bound.restype = sz
        lib.jc_encode.argtypes = [p, i, i, i, i, p, sz, ctypes.c_char_p, i]
        lib.jc_encode.restype = ctypes.c_long
        _LIB = lib
        return lib


def is_jpeg(data) -> bool:
    """Whether ``data`` starts with a JPEG's SOI marker, ``FF D8``."""
    return bytes(data[:2]) == b"\xff\xd8"


def _raise(err, name: str):
    raise ValueError(f"{name}: {err.value.decode(errors='replace')}: not read without PIL "
                     f"({ROADMAP_ITEM})")


def _info(lib, buf: bytes, name: str) -> tuple[int, int, int]:
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR)
    if lib.jc_info(buf, len(buf), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c), err, _ERR):
        _raise(err, name)
    return w.value, h.value, c.value


def decode_jpeg(data, name: str = "<bytes>") -> tuple[np.ndarray, str]:
    """The pixels of a JPEG file's bytes and their PIL mode: uint8 (H, W)
    under ``'L'`` for one component, (H, W, 3) under ``'RGB'`` for three,
    (H, W, 4) under ``'CMYK'`` for four (CMYK or YCCK, Adobe-inverted as
    Pillow reads them)."""
    lib = load_codec()
    buf = bytes(data)
    w, h, c = _info(lib, buf, name)
    out = np.empty((h, w) if c == 1 else (h, w, c), np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    if lib.jc_decode(buf, len(buf), out.ctypes.data, w, h, c, err, _ERR):
        _raise(err, name)
    return out, {1: "L", 3: "RGB", 4: "CMYK"}[c]


def encode_jpeg(arr: np.ndarray, quality: int = 75) -> bytes:
    """The bytes Pillow writes for ``Image.fromarray(arr).save(f, "JPEG",
    quality=quality)``: uint8 (H, W) as one component, (H, W, 3) RGB as
    4:2:0 YCbCr; quality 75 by default, as Pillow's."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8:
        raise TypeError(f"encode_jpeg takes uint8 arrays, not {arr.dtype}")
    if arr.ndim == 2:
        c = 1
    elif arr.ndim == 3 and arr.shape[2] == 3:
        c = 3
    else:
        raise ValueError(f"encode_jpeg writes (H, W) or (H, W, 3) arrays, not {arr.shape}")
    h, w = arr.shape[:2]
    if not 1 <= h <= 65535 or not 1 <= w <= 65535:
        raise ValueError(f"a JPEG is 1 to 65535 pixels a side, not {arr.shape}")
    lib = load_codec()
    out = np.empty(lib.jc_encode_bound(w, h, c), np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    n = lib.jc_encode(arr.ctypes.data, w, h, c, int(quality), out.ctypes.data, out.size, err, _ERR)
    if n < 0:
        raise ValueError(f"encode_jpeg: {err.value.decode(errors='replace')}")
    return out[:n].tobytes()
