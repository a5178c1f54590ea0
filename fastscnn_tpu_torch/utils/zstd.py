"""Zstandard, CRC-32C and XXH64 without a package: ``ctypes`` over ``zstd.cpp``.

An Orbax checkpoint compresses its OCDBT nodes and its zarr chunks with
zstd and checks each node with a CRC-32C; the machine that runs the port
on the card has neither ``zstandard`` nor ``tensorstore``. ``zstd.cpp`` is
a host C++ decoder of RFC 8878 (every frame without a dictionary), a
raw-block encoder, CRC-32C (Castagnoli) and XXH64. A frame the decoder
cannot read raises a ``ValueError`` with the reason; nothing falls back to
another codec. The library is compiled with ``g++`` at first use
(``utils/native.build_library``), and each call releases the interpreter
lock.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

__all__ = ["compress", "decompress", "crc32c", "xxh64", "load_codec", "STAT_NAMES"]

_SRC = Path(__file__).resolve().parent / "zstd.cpp"
_LOCK = threading.Lock()
_LIB = None
_ERR = 256
# the decoder's counters, in the order of zstd.cpp's stats slots
STAT_NAMES = (
    "frames", "skippable_frames", "raw_blocks", "rle_blocks", "compressed_blocks",
    "multiblock_frames", "raw_literals", "rle_literals", "huffman_1_stream",
    "huffman_4_streams", "treeless_literals", "fse_weights", "direct_weights",
    "predefined_tables", "rle_tables", "fse_tables", "repeat_tables", "checksums", "sequences",
    "frames_without_size",
)


def load_codec() -> ctypes.CDLL:
    """Compile (at first use, when the library for this source is missing)
    and load the codec library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        from fastscnn_tpu_torch.utils.native import build_library

        lib = ctypes.CDLL(str(build_library(_SRC, "zstdcodec")))
        p, sz, i64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int64
        lib.zs_crc32c.argtypes = [p, sz, ctypes.c_uint32]
        lib.zs_crc32c.restype = ctypes.c_uint32
        lib.zs_xxh64.argtypes = [p, sz, ctypes.c_uint64]
        lib.zs_xxh64.restype = ctypes.c_uint64
        lib.zs_stat_count.restype = ctypes.c_int
        lib.zs_free.argtypes = [p]
        lib.zs_decompress.argtypes = [p, sz, ctypes.POINTER(p), ctypes.POINTER(i64),
                                      ctypes.c_char_p, ctypes.c_int]
        lib.zs_decompress.restype = i64
        lib.zs_compress_bound.argtypes = [sz]
        lib.zs_compress_bound.restype = sz
        lib.zs_compress_raw.argtypes = [p, sz, p, sz, ctypes.c_int]
        lib.zs_compress_raw.restype = i64
        if lib.zs_stat_count() != len(STAT_NAMES):
            raise RuntimeError("zstd.cpp's stats slots differ from STAT_NAMES")
        _LIB = lib
        return lib


def _buffer(data) -> bytes:
    return data if isinstance(data, bytes) else bytes(data)


def decompress(data, stats: dict | None = None) -> bytes:
    """The content of every zstd frame in ``data``, concatenated (skippable
    frames skipped). ``stats``, where given, gains the decoder's counts
    (:data:`STAT_NAMES`): blocks and literals of each kind, tables of each
    mode, checksums verified."""
    lib = load_codec()
    buf = _buffer(data)
    out = ctypes.c_void_p()
    counts = (ctypes.c_int64 * len(STAT_NAMES))()
    err = ctypes.create_string_buffer(_ERR)
    n = lib.zs_decompress(buf, len(buf), ctypes.byref(out), counts, err, _ERR)
    if n < 0:
        raise ValueError(f"zstd: {err.value.decode(errors='replace')}")
    try:
        result = ctypes.string_at(out, n)
    finally:
        lib.zs_free(out)
    if stats is not None:
        for name, c in zip(STAT_NAMES, counts):
            stats[name] = stats.get(name, 0) + c
    return result


def compress(data, checksum: bool = True) -> bytes:
    """One zstd frame of raw (stored) blocks holding ``data``, with its size
    in the header and, when ``checksum``, its XXH64 checksum: valid for
    every decoder, and no smaller than ``data``."""
    lib = load_codec()
    buf = _buffer(data)
    out = ctypes.create_string_buffer(lib.zs_compress_bound(len(buf)))
    n = lib.zs_compress_raw(buf, len(buf), out, len(out), int(checksum))
    if n < 0:
        raise RuntimeError("zs_compress_raw: output buffer too small")
    return out.raw[:n]


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli, RFC 3720) of ``data``, continuing ``crc``."""
    buf = _buffer(data)
    return load_codec().zs_crc32c(buf, len(buf), crc)


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (zstd's content checksum is its low 32 bits)."""
    buf = _buffer(data)
    return load_codec().zs_xxh64(buf, len(buf), seed)
