"""TIFF files to numpy arrays without PIL.

The JAX package opens a TIFF with ``PIL.Image.open``: Pillow 12's
``TiffImagePlugin`` reads an uncompressed file itself and hands every
compressed one to libtiff. :func:`decode_tiff` gives the same array, mode
and palette for page 0, byte for byte:

- classic and BigTIFF files, byte orders ``II`` and ``MM``; strips and
  tiles; ``PlanarConfiguration`` 1 and 2; ``FillOrder`` 2; the EXIF
  ``Orientation`` applied as Pillow applies it;
- compression none, PackBits, LZW (``imgcodecs.cpp``), Deflate (8 and
  32946, ``zlib``) and JPEG (7: each strip's abbreviated stream joined to
  the ``JPEGTables`` tag and decoded by the port's ``jpeg.cpp``, RGB as
  Pillow asks libtiff for it);
- ``Predictor`` 2 (horizontal differences on 8, 16 and 32-bit samples)
  and 3 (floating point);
- Pillow's modes (``OPEN_INFO``): ``1`` (min-is-white and min-is-black),
  ``L`` at 2, 4 and 8 bits, ``I;16`` and ``I;16B``, ``I`` (int16 and int32
  samples, uint32 as its bits), ``F``, ``P`` at 1, 2, 4 and 8 bits, ``PA``,
  ``LA``, ``RGB`` (also 16-bit samples cut to their high byte), ``RGBA``
  (unassociated alpha as it is, associated alpha divided out as Pillow's
  ``RGBa`` unpacker does) and ``CMYK``.

Pillow's own ways are copied where they change the bits: libtiff hands
``MM`` signed and float samples over in native order and Pillow unpacks
them as big-endian (byte-swapped values); libtiff applies a predictor
under LZW and Deflate only; four RGB samples without ExtraSamples in
separate planes come back divided by their alpha.

What the port does not read raises a ``ValueError`` naming it and
:data:`~fastscnn_tpu_torch.data.jpeg.ROADMAP_ITEM`: CCITT RLE, G3 and G4,
old-style JPEG (6), ThunderScan, LogLuv, JBIG, LZMA, ZSTD and WebP
compression, YCbCr that is not JPEG-compressed and CIELab (Pillow reads
those through libtiff's RGBA path, whose tables this module does not
copy), and the separate-plane layouts Pillow reads in its own way (a grey
or palette image's extra plane, uncompressed 16-bit planes, planes with
FillOrder 2, JPEG planes). Every layout Pillow refuses raises too
(``unknown pixel mode``, a big-endian BigTIFF).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from fastscnn_tpu_torch.data import imgcodecs
from fastscnn_tpu_torch.data.jpeg import ROADMAP_ITEM, decode_jpeg

__all__ = ["decode_tiff", "is_tiff", "tiff_size"]

_COMPRESSIONS = frozenset((1, 5, 7, 8, 32946, 32773))  # none, LZW, JPEG, Deflate x2, PackBits
_REFUSED = {2: "CCITT modified Huffman RLE", 3: "CCITT G3", 4: "CCITT G4",
            6: "old-style JPEG (6)", 32809: "ThunderScan", 34661: "JBIG", 34676: "SGI LogLuv",
            34677: "SGI LogLuv24", 34925: "LZMA", 50000: "ZSTD", 50001: "WebP-in-TIFF",
            32771: "CCITT RLEW"}
# (photometric, sample format, bits, extra samples) -> Pillow's mode and
# how its unpacker reads a pixel's samples (OPEN_INFO with fill order 1)
_MODES = {
    (0, 1, (1,), ()): ("1", "1;I"), (1, 1, (1,), ()): ("1", "1"),
    (0, 1, (2,), ()): ("L", "L;2I"), (1, 1, (2,), ()): ("L", "L;2"),
    (0, 1, (4,), ()): ("L", "L;4I"), (1, 1, (4,), ()): ("L", "L;4"),
    (0, 1, (8,), ()): ("L", "L;I"), (1, 1, (8,), ()): ("L", "L"), (1, 2, (8,), ()): ("L", "L"),
    (0, 1, (16,), ()): ("I;16", "I;16"), (1, 1, (16,), ()): ("I;16", "I;16"),
    (1, 2, (16,), ()): ("I", "I;16S"),
    (0, 3, (32,), ()): ("F", "F"), (1, 3, (32,), ()): ("F", "F"),
    (1, 1, (32,), ()): ("I", "I;32N"), (1, 2, (32,), ()): ("I", "I;32S"),
    (1, 1, (8, 8), (2,)): ("LA", "LA"),
    (2, 1, (8, 8, 8), ()): ("RGB", "RGB"),
    (2, 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
    (2, 1, (8, 8, 8, 8), (0,)): ("RGB", "RGB"),
    (2, 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGB"),
    (2, 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGB"),
    (2, 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
    (2, 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBa"),
    (2, 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBa"),
    (2, 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
    (2, 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBA"),
    (2, 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBA"),
    (2, 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
    (2, 1, (16, 16, 16), ()): ("RGB", "RGB;16"),
    (2, 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16"),
    (2, 1, (16, 16, 16, 16), (0,)): ("RGB", "RGB;16"),
    (2, 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16"),
    (2, 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16"),
    (3, 1, (1,), ()): ("P", "P"), (3, 1, (2,), ()): ("P", "P"), (3, 1, (4,), ()): ("P", "P"),
    (3, 1, (8,), ()): ("P", "P"), (3, 1, (8, 8), (0,)): ("P", "P"),
    (3, 1, (8, 8), (2,)): ("PA", "PA"),
    (5, 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
    (5, 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYK"),
    (5, 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYK"),
    (5, 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16"),
    (6, 1, (8,), ()): ("L", "L"),
    (6, 1, (8, 8, 8), ()): ("RGB", "RGB"),
}
# modes Pillow gives only in one byte order
_II_ONLY = {(0, 1, (16,), ()), (1, 1, (32,), ())}
# the layouts OPEN_INFO lists with FillOrder 2 (16-bit grey in II only), and
# those whose bit-reversed raw mode has no unpacker in Pillow's own reader
_FILLORDER2 = {(0, 1, (1,), ()), (1, 1, (1,), ()), (0, 1, (2,), ()), (1, 1, (2,), ()),
               (0, 1, (4,), ()), (1, 1, (4,), ()), (0, 1, (8,), ()), (1, 1, (8,), ()),
               (1, 1, (16,), ()), (2, 1, (8, 8, 8), ()), (3, 1, (1,), ()), (3, 1, (2,), ()),
               (3, 1, (4,), ()), (3, 1, (8,), ())}
_FILLORDER2_RAW_MISSING = {(0, 1, (8,), ()), (3, 1, (1,), ()), (3, 1, (2,), ()),
                           (3, 1, (4,), ())}
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
          11: "f", 12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}


def is_tiff(data) -> bool:
    """Whether ``data`` starts with a TIFF or BigTIFF header."""
    return bytes(data[:4]) in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")


def _ifd0(data: bytes, name: str) -> tuple[str, dict]:
    """The byte order and the first directory's tags, each a tuple."""
    if len(data) < 8 or not is_tiff(data):
        raise ValueError(f"{name}: not a TIFF file")
    bo = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\0", b"\0+")
    if big and bo == ">":  # Pillow 12 misreads their directory entries and opens none
        raise ValueError(f"{name}: a big-endian BigTIFF (Pillow cannot open one either)")
    if big:
        offset = struct.unpack_from(bo + "Q", data, 8)[0]
        count_fmt, entry, ptr = "Q", 20, "Q"
    else:
        offset = struct.unpack_from(bo + "I", data, 4)[0]
        count_fmt, entry, ptr = "H", 12, "I"
    csize = struct.calcsize(count_fmt)
    if offset + csize > len(data):
        raise ValueError(f"{name}: the TIFF directory lies past the file's end")
    count = struct.unpack_from(bo + count_fmt, data, offset)[0]
    tags = {}
    for k in range(count):
        at = offset + csize + k * entry
        if at + entry > len(data):
            raise ValueError(f"{name}: truncated TIFF directory")
        tag, typ = struct.unpack_from(bo + "HH", data, at)
        n = struct.unpack_from(bo + ("Q" if big else "I"), data, at + 4)[0]
        fmt = _TYPES.get(typ)
        if fmt is None:
            continue
        size = struct.calcsize(fmt) * n
        inline = 8 if big else 4
        where = at + 4 + (8 if big else 4)
        if size > inline:
            where = struct.unpack_from(bo + ptr, data, where)[0]
        raw = data[where:where + size]
        if len(raw) < size:
            raise ValueError(f"{name}: TIFF tag {tag} lies past the file's end")
        if typ in (2, 7):
            tags[tag] = raw
            continue
        vals = struct.unpack(bo + fmt * n, raw)
        if typ in (5, 10):
            vals = tuple(vals[i] / vals[i + 1] if vals[i + 1] else 0
                         for i in range(0, len(vals), 2))
        tags[tag] = vals
    return bo, tags


def tiff_size(data: bytes, name: str = "<bytes>") -> tuple[int, int]:
    """``Image.open(f).size``: (width, height), swapped by an Orientation of
    5 to 8."""
    try:
        _, tags = _ifd0(data, name)
        w, h = int(tags[256][0]), int(tags[257][0])
    except KeyError:
        raise ValueError(f"{name}: TIFF without its dimensions") from None
    except (IndexError, TypeError, OverflowError, struct.error) as e:
        raise ValueError(f"{name}: a corrupt TIFF file ({type(e).__name__}: {e})") from None
    return (h, w) if tags.get(274, (1,))[0] in (5, 6, 7, 8) else (w, h)


def _refuse(name: str, what: str):
    raise ValueError(f"{name}: {what} is not read without PIL ({ROADMAP_ITEM})")


def _reverse_bits(buf: np.ndarray) -> np.ndarray:
    table = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
    return table[buf]


def decode_tiff(data: bytes, name: str = "<bytes>"):
    """``(array, mode, palette, None)`` of page 0 of a TIFF: the array as
    ``np.asarray(Image.open(f))`` gives it, the (N, 3) palette of a ``P``
    or ``PA`` image (its ColorMap's entries)."""
    try:
        return _decode_tiff(data, name)
    except (IndexError, TypeError, OverflowError, struct.error) as e:  # tags out of range
        raise ValueError(f"{name}: a corrupt TIFF file ({type(e).__name__}: {e})") from None


def _decode_tiff(data: bytes, name: str):
    bo, t = _ifd0(data, name)
    if 0xBC01 in t:
        _refuse(name, "a Windows Media Photo TIFF")
    compression = t.get(259, (1,))[0]
    if compression in _REFUSED:
        _refuse(name, f"TIFF compression {_REFUSED[compression]}")
    if compression not in _COMPRESSIONS:
        _refuse(name, f"TIFF compression {compression}")
    planar = t.get(284, (1,))[0]
    photo = t.get(262, (0,))[0]
    if photo in (32844, 32845):
        _refuse(name, "a LogLuv TIFF")
    if photo == 6 and compression != 7:
        _refuse(name, "a YCbCr TIFF that is not JPEG-compressed")
    if photo == 8:
        _refuse(name, "a CIELab TIFF")
    fillorder = t.get(266, (1,))[0]
    try:
        width, height = int(t[256][0]), int(t[257][0])
    except KeyError:
        raise ValueError(f"{name}: TIFF without its dimensions") from None
    imgcodecs.check_pixels(width, height, name)
    sample_format = t.get(339, (1,))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bps = t.get(258, (1,))
    extra = t.get(338, ())
    spp = t.get(277, (1,))[0]
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"{name}: unknown TIFF data organization")
    if len(sample_format) != 1:
        raise ValueError(f"{name}: unknown TIFF pixel mode (sample formats {sample_format})")
    key = (photo, sample_format[0], tuple(bps), tuple(extra))
    if key not in _MODES or (bo == ">" and key in _II_ONLY) or fillorder not in (1, 2) or (
            fillorder == 2 and (key not in _FILLORDER2 or (bo == ">" and bps[0] == 16))):
        raise ValueError(f"{name}: unknown TIFF pixel mode {key}, FillOrder {fillorder} "
                         f"(Pillow refuses it too)")
    if fillorder == 2 and compression == 1 and key in _FILLORDER2_RAW_MISSING:
        raise ValueError(f"{name}: unknown raw mode for {key} in FillOrder 2 (Pillow refuses "
                         f"it too)")
    mode, raw = _MODES[key]
    if mode == "I;16" and bo == ">":
        mode = "I;16B"
    if planar == 2 and spp > 1:
        raw = _separate_planes(name, compression, fillorder, photo, extra, bps, spp, raw,
                               322 in t)
    # libtiff's LZW and Deflate codecs apply the predictor; PackBits and an
    # uncompressed file (Pillow's own reader) ignore the tag
    predictor = t.get(317, (1,))[0] if compression in (5, 8, 32946) else 1
    nbits = sum(bps)
    planes = spp if planar == 2 else 1
    pbits = bps[0] if planar == 2 else nbits  # bits a pixel within one plane
    if 322 in t:
        cw, ch = t[322][0], t.get(323, (0,))[0]
        offsets, counts = t.get(324), t.get(325)
    else:
        cw, ch = width, min(t.get(278, (2**32 - 1,))[0], height)
        offsets, counts = t.get(273), t.get(279)
    if not offsets or cw <= 0 or ch <= 0:
        raise ValueError(f"{name}: unknown TIFF data organization")
    if counts is None:
        counts = (len(data),) * len(offsets)
    across, down = -(-width // cw), -(-height // ch)
    if len(offsets) < across * down * planes:
        raise ValueError(f"{name}: TIFF with {len(offsets)} strips or tiles, not "
                         f"{across * down * planes}")
    if compression == 1 and 322 not in t and cw == width and ch >= height and planes == 1:
        offsets, counts = offsets[-1:], counts[-1:]  # Pillow reads the last strip only
    row_bytes = (cw * pbits + 7) // 8
    full = np.zeros((planes, down * ch, across * row_bytes), np.uint8)
    tables = t.get(347)
    for k in range(across * down * planes):
        plane, rest = divmod(k, across * down)
        ty, tx = divmod(rest, across)
        rows = ch if 322 in t else min(ch, height - ty * ch)
        size = rows * row_bytes
        chunk = data[offsets[k]:offsets[k] + counts[k]]
        if compression == 7:
            buf = _jpeg_chunk(chunk, tables, photo, cw, rows, spp, planes, name)
        else:
            if fillorder == 2:
                chunk = _reverse_bits(np.frombuffer(chunk, np.uint8)).tobytes()
            buf = _decompress(chunk, compression, size, name)
            if buf.size < size:
                if compression == 1:
                    raise ValueError(f"{name}: truncated TIFF strip or tile {k}")
                raise ValueError(f"{name}: TIFF strip or tile {k} decodes to {buf.size} bytes, "
                                 f"not {size}")
            buf = buf[:size].reshape(rows, row_bytes)
            if predictor != 1:
                buf = _unpredict(buf, predictor, 1 if planar == 2 else spp, bps[0], bo, name)
        full[plane, ty * ch:ty * ch + rows, tx * row_bytes:(tx + 1) * row_bytes] = buf
    samples = _samples(full, planes, across, cw, row_bytes, pbits, bps, spp, bo, width, height,
                       native=predictor == 3)
    arr = _unpack(samples, raw, mode)
    if compression != 1 and bo == ">" and raw in ("I;16S", "I;32S", "F"):
        # libtiff hands Pillow these samples in native order, and Pillow
        # unpacks them as big-endian ("I;16BS", "I;32BS", "F;32BF"): each
        # value comes out byte-swapped
        arr = (arr.astype("<i2").byteswap().astype("<i4") if raw == "I;16S" else
               arr.byteswap())
    palette = None
    if mode in ("P", "PA"):
        cmap = t.get(320)
        if cmap is None:
            raise ValueError(f"{name}: palette TIFF without a ColorMap")
        n = len(cmap) // 3  # R..., G..., B..., each 16 bits: Pillow keeps the high byte
        palette = (np.array(cmap[:3 * n], np.uint32).reshape(3, n).T[:256] // 256).astype(
            np.uint8)
    orientation = t.get(274, (1,))[0]
    return _orient(arr, orientation), mode, palette, None


def _separate_planes(name, compression, fillorder, photo, extra, bps, spp, raw, tiled):
    """The unpacker of a PlanarConfiguration 2 file as Pillow reads it, or
    a refusal: its own reader (uncompressed files) unpacks each plane with
    one letter of the raw mode, which exists for R, G, B, A, C, M, Y and K
    alone and reads 16-bit planes byte by byte; under libtiff strips with a
    plane of unspecified extra samples fail (tiles read as they should), an
    L or P image's extra plane is misplaced, and four RGB
    samples without ExtraSamples come back associated (libtiff's RGBA
    reading)."""
    if fillorder == 2:
        _refuse(name, "a TIFF with separate planes and FillOrder 2")
    if compression == 1:
        if not ((photo == 2 and spp == 3 and not extra) or
                (photo == 2 and spp == 4 and extra in ((), (2,), (999,))) or
                (photo == 5 and spp == 4 and not extra)):
            raise ValueError(f"{name}: unknown raw mode for separate planes of photometric "
                             f"{photo}, extra samples {extra} (Pillow refuses it too)")
        if bps[0] == 16:
            _refuse(name, "an uncompressed TIFF of 16-bit samples in separate planes (Pillow "
                          "reads their bytes as 8-bit samples)")
        return raw
    if 0 in extra and not tiled:
        raise ValueError(f"{name}: strips of separate planes of unspecified extra samples "
                         f"(Pillow's libtiff decoder fails on them too)")
    if photo in (1, 3):
        _refuse(name, "a grey or palette TIFF with an extra sample in a separate plane (Pillow "
                      "misplaces that plane)")
    if photo == 2 and spp == 4 and not extra:
        return raw.replace("RGBA", "RGBa")
    return raw


def _jpeg_chunk(chunk: bytes, tables, photo: int, cw: int, rows: int, spp: int, planes: int,
                name: str) -> np.ndarray:
    """A JPEG-compressed strip or tile: its abbreviated stream after the
    tables' DQT and DHT, with an Adobe APP14 marker that states libtiff's
    colour space (YCbCr for photometric 6, none to undo otherwise)."""
    if planes != 1:
        _refuse(name, "a JPEG-compressed TIFF with separate planes")
    if not chunk.startswith(b"\xff\xd8"):
        raise ValueError(f"{name}: a TIFF JPEG strip without SOI")
    head = b"\xff\xd8"
    if tables:
        if not tables.startswith(b"\xff\xd8"):
            raise ValueError(f"{name}: JPEGTables without SOI")
        head += tables[2:-2] if tables.endswith(b"\xff\xd9") else tables[2:]
    transform = 1 if photo == 6 else 0
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes([transform])
    arr, jmode = decode_jpeg(head + adobe + chunk[2:], name)
    if arr.ndim == 2:
        arr = arr[..., None]
    if jmode == "CMYK":  # the codec gives Pillow's inverted CMYK; libtiff gives the samples
        arr = 255 - arr
    if arr.shape[2] != spp:
        raise ValueError(f"{name}: a TIFF JPEG strip of {arr.shape[2]} components, not {spp}")
    out = np.zeros((rows, cw * spp), np.uint8)
    h, w = min(rows, arr.shape[0]), min(cw, arr.shape[1])
    out.reshape(rows, cw, spp)[:h, :w] = arr[:h, :w]
    return out


def _decompress(chunk: bytes, compression: int, size: int, name: str) -> np.ndarray:
    if compression == 1:
        return np.frombuffer(chunk, np.uint8)
    if compression == 5:
        return imgcodecs.tiff_lzw(chunk, size, name)
    if compression == 32773:
        return imgcodecs.packbits(chunk, size)
    try:  # Deflate: zlib's stream, as libtiff's ZIPDecode reads it
        d = zlib.decompressobj()
        return np.frombuffer(d.decompress(chunk, size), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{name}: TIFF Deflate data: {e}") from None


def _unpredict(buf: np.ndarray, predictor: int, stride: int, bits: int, bo: str,
               name: str) -> np.ndarray:
    """libtiff's horAcc8/16/32 and fpAcc on the (rows, row bytes) of one
    strip or tile; 16 and 32-bit samples come back in the file's order,
    floats in native order (libtiff's fpAcc output)."""
    rows, n = buf.shape
    if predictor == 2:
        if bits not in (8, 16, 32):
            _refuse(name, f"TIFF Predictor 2 on {bits}-bit samples")
        dt = np.dtype({8: "u1", 16: "u2", 32: "u4"}[bits]).newbyteorder(bo)
        vals = buf.view(dt).reshape(rows, -1, stride)
        out = np.cumsum(vals.astype(dt.newbyteorder("=")), axis=1,
                        dtype=dt.newbyteorder("="))
        return out.astype(dt).view(np.uint8).reshape(rows, n)
    if predictor == 3:
        if bits not in (16, 32, 64):
            _refuse(name, f"TIFF Predictor 3 on {bits}-bit samples")
        size = bits // 8
        acc = np.cumsum(buf.reshape(rows, -1, stride), axis=1, dtype=np.uint8).reshape(rows, n)
        planes = acc.reshape(rows, size, n // size)  # byte planes, most significant first
        return np.ascontiguousarray(planes[:, ::-1, :].transpose(0, 2, 1)).reshape(rows, n)
    _refuse(name, f"TIFF Predictor {predictor}")


def _samples(full, planes, across, cw, row_bytes, pbits, bps, spp, bo, width, height, native):
    """(H, W, S) samples from the assembled chunks: uint8 for 8 bits and
    less, else the sample width in the file's byte order (native after the
    float predictor)."""
    bits = bps[0]
    outs = []
    for p in range(planes):
        rows = full[p, :height].reshape(height, across, row_bytes)
        if bits < 8:
            unpacked = np.unpackbits(rows, axis=2)[:, :, :cw * pbits]
            per = pbits // bits
            vals = unpacked.reshape(height, across, cw * per, bits)
            weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
            vals = (vals * weights).sum(axis=3, dtype=np.uint8)
            vals = vals.reshape(height, across * cw, per)
        else:
            size = bits // 8
            dt = np.dtype({1: "u1", 2: "u2", 4: "u4", 8: "u8"}[size])
            dt = dt.newbyteorder("=" if native else bo)
            per = pbits // bits
            vals = rows[:, :, :cw * per * size].copy().view(dt).reshape(height, across * cw, per)
        outs.append(vals[:, :width])
    return outs[0] if planes == 1 else np.concatenate(outs, axis=2)


def _unpack(s: np.ndarray, raw: str, mode: str) -> np.ndarray:
    """Pillow's unpacker for ``raw`` on (H, W, S) samples."""
    from fastscnn_tpu_torch.data.image_io import _bool255

    first = s[..., 0]
    if mode == "1":
        return _bool255(first if raw == "1" else first == 0)
    if raw in ("L;2", "L;2I", "L;4", "L;4I"):
        top = 3 if raw.startswith("L;2") else 15
        v = top - first if raw.endswith("I") else first
        return (v * (255 // top)).astype(np.uint8)
    if raw == "L;I":
        return (255 - first).astype(np.uint8)
    if mode == "L":
        return first.astype(np.uint8)
    if mode in ("I;16", "I;16B"):
        return first.astype("<u2" if mode == "I;16" else ">u2")
    if mode == "F":
        return first.view(np.dtype("f4").newbyteorder(first.dtype.byteorder)).astype("<f4")
    if mode == "I":
        if raw == "I;16S":
            return first.view(np.dtype("i2").newbyteorder(first.dtype.byteorder)).astype("<i4")
        return first.view(np.dtype("i4").newbyteorder(first.dtype.byteorder)).astype("<i4")
    if raw.endswith(";16"):
        s = (s.astype(np.uint32) >> 8).astype(np.uint8)
        raw = raw[:-3]
    s = s.astype(np.uint8, copy=False)
    if mode == "P":
        return np.ascontiguousarray(first.astype(np.uint8))
    if mode in ("PA", "LA"):
        return np.ascontiguousarray(s[..., :2])
    if mode == "RGB":
        return np.ascontiguousarray(s[..., :3])
    if mode == "CMYK":
        return np.ascontiguousarray(s[..., :4])
    rgba = np.ascontiguousarray(s[..., :4])
    if raw == "RGBa":  # Unpack.c's unpackRGBa: CLIP8(c * 255 / a), 0 where a is 0
        a = rgba[..., 3:].astype(np.int32)
        rgb = rgba[..., :3].astype(np.int32)
        div = np.minimum(rgb * 255 // np.maximum(a, 1), 255)
        rgb = np.where(a == 255, rgb, np.where(a == 0, 0, div))
        rgba = np.concatenate([rgb.astype(np.uint8), rgba[..., 3:]], axis=2)
    return rgba


def _orient(arr: np.ndarray, orientation: int) -> np.ndarray:
    """``ImageOps.exif_transpose`` of an array by its Orientation value."""
    ops = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.swapaxes(0, 1), 6: lambda a: a[::-1].swapaxes(0, 1),
           7: lambda a: a[::-1, ::-1].swapaxes(0, 1), 8: lambda a: a[:, ::-1].swapaxes(0, 1)}
    if orientation in ops:
        arr = np.ascontiguousarray(ops[orientation](arr))
    return arr
