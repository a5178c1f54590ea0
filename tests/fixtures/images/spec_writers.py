"""GIF, TIFF and WebP writers from the formats' specifications, with numpy
and ``zlib`` alone.

They write the variants Pillow's encoders do not (TIFF tiles, separate
planes, predictors, big-endian and BigTIFF files, associated alpha, every
bit depth; GIF local tables, offset and oversized frames, a full LZW table
without a clear code; WebP ALPH chunks under each filter, animated files
whose first frame sits inside a larger canvas). ``make_fixtures.py``
writes the fixtures with them and holds each to Pillow's decode, and the
card's smoke script (no Pillow there) writes its 1280x720 LZW and Deflate
TIFFs with :func:`tiff_bytes`.

- GIF: CompuServe's GIF89a specification (LZW codes LSB first, the code
  width growing when the table reaches a power of two);
- TIFF: TIFF 6.0 (and the BigTIFF extension): LZW codes MSB first, one
  code early, as libtiff writes them, and the old LSB-first kind; PackBits;
  Deflate; the horizontal and floating-point predictors of TIFF Technical
  Note 3;
- WebP: the RIFF container of RFC 9649 around bitstreams an encoder wrote.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["alph", "alpha_filtered", "anim_webp", "gif_bytes", "gif_lzw", "packbits",
           "replace_alph", "riff_chunks", "tiff_bytes", "tiff_lzw", "webp_file"]


class _Bits:
    def __init__(self, msb_first: bool):
        self.msb, self.acc, self.n, self.out = msb_first, 0, 0, bytearray()

    def put(self, code: int, width: int):
        if self.msb:
            self.acc = (self.acc << width) | code
            self.n += width
            while self.n >= 8:
                self.n -= 8
                self.out.append((self.acc >> self.n) & 0xFF)
            self.acc &= (1 << self.n) - 1
        else:
            self.acc |= code << self.n
            self.n += width
            while self.n >= 8:
                self.out.append(self.acc & 0xFF)
                self.acc >>= 8
                self.n -= 8

    def flush(self) -> bytes:
        if self.n:
            self.out.append(((self.acc << (8 - self.n)) if self.msb else self.acc) & 0xFF)
        return bytes(self.out)


def _lzw(data, first_code: int, width_of, msb: bool, full_at: int, clear_when_full: bool):
    """LZW of the byte values ``data``: a clear code first, a clear again
    once ``full_at`` entries exist (else the table stops growing), the end
    code last. ``width_of(n)`` is the decoder's code width when its table
    holds n entries; the decoder adds each entry one code after the
    encoder, so a code's width follows the encoder's count less one."""
    clear, eoi = first_code - 2, first_code - 1
    bits = _Bits(msb)
    bits.put(clear, width_of(first_code))
    table, nxt, prefix, emitted = {}, first_code, None, 0
    for b in (int(v) for v in data):
        if prefix is None:
            prefix = b
            continue
        key = (prefix, b)
        if key in table:
            prefix = table[key]
            continue
        bits.put(prefix, width_of(nxt if emitted == 0 else nxt - 1))
        emitted += 1
        if nxt < full_at:
            table[key] = nxt
            nxt += 1
            if nxt == full_at and clear_when_full:
                bits.put(clear, width_of(nxt - 1))
                table, nxt, emitted = {}, first_code, 0
        prefix = b
    if prefix is not None:
        bits.put(prefix, width_of(nxt if emitted == 0 else nxt - 1))
    bits.put(eoi, width_of(nxt))
    return bits.flush()


def gif_lzw(indices, min_bits: int, clear_when_full: bool = True) -> bytes:
    """GIF LZW of palette indices, minimum code size ``min_bits`` (2-8)."""
    def width(n):
        return min(12, max(min_bits + 1, n.bit_length()))
    return _lzw(np.asarray(indices).ravel(), (1 << min_bits) + 2, width, False, 4096,
                clear_when_full)


def tiff_lzw(data: bytes, old_style: bool = False) -> bytes:
    """TIFF LZW: libtiff's codes (MSB first, widening at 511, 1023, 2047; a
    clear at 4094 entries) or, ``old_style``, the LSB-first codes that
    widen at 512, 1024, 2048."""
    def width(n):
        if old_style:
            return min(12, max(9, n.bit_length()))
        return 9 if n < 511 else 10 if n < 1023 else 11 if n < 2047 else 12
    return _lzw(np.frombuffer(bytes(data), np.uint8), 258, width, not old_style,
                4096 if old_style else 4094, True)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of two to 128 equal bytes as repeats, the rest as
    literal stretches of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + bytes(data[i:j])
        i = j
    return bytes(out)


# --- GIF ---------------------------------------------------------------------------------


def _gif_table(palette) -> tuple[int, bytes]:
    """(size field, entries padded to a power of two) of a colour table."""
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    bits = max(1, int(np.ceil(np.log2(max(len(pal), 2)))))
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:len(pal)] = pal
    return bits - 1, table.tobytes()


def _sub_blocks(data: bytes, size: int = 255) -> bytes:
    return b"".join(bytes([len(data[i:i + size])]) + data[i:i + size]
                    for i in range(0, len(data), size)) + b"\0"


def gif_bytes(frames, screen, global_palette=None, version=b"GIF89a", extensions=b"") -> bytes:
    """A GIF: the logical screen (width, height), an optional global table,
    ``extensions`` (raw blocks) before the first image, then each frame: a
    dict of ``indices`` (H, W), ``offset`` (x, y), ``palette`` (a local
    table), ``interlace``, ``transparency`` (a graphic-control extension),
    ``min_bits`` and ``clear_when_full``."""
    w, h = screen
    flags = 0
    table = b""
    if global_palette is not None:
        size, table = _gif_table(global_palette)
        flags = 0x80 | 0x70 | size
    out = [version, struct.pack("<HHBBB", w, h, flags, 0, 0), table, extensions]
    for f in frames:
        idx = np.asarray(f["indices"], np.uint8)
        fh, fw = idx.shape
        if f.get("transparency") is not None:
            out.append(b"!\xf9\x04" + bytes([1, 10, 0, f["transparency"]]) + b"\0")
        x, y = f.get("offset", (0, 0))
        iflags, local = 0, b""
        if f.get("palette") is not None:
            size, local = _gif_table(f["palette"])
            iflags = 0x80 | size
        if f.get("interlace"):
            iflags |= 0x40
            rows = np.concatenate([idx[0::8], idx[4::8], idx[2::4], idx[1::2]])
        else:
            rows = idx
        out.append(b"," + struct.pack("<HHHHB", x, y, fw, fh, iflags) + local)
        min_bits = f.get("min_bits", 8)
        out.append(bytes([min_bits]) + _sub_blocks(
            gif_lzw(rows, min_bits, f.get("clear_when_full", True)), f.get("block", 255)))
    out.append(b";")
    return b"".join(out)


# --- TIFF --------------------------------------------------------------------------------


def _pack_rows(vals: np.ndarray, bits: int, bo: str) -> np.ndarray:
    """(rows, pixels, samples) values -> (rows, row bytes) at ``bits`` a
    sample, rows padded to a byte."""
    r, w, s = vals.shape
    if bits >= 8:
        kind = "f" if vals.dtype.kind == "f" else "i" if vals.dtype.kind == "i" else "u"
        dt = np.dtype(f"{bo}{kind}{bits // 8}")
        return vals.astype(dt).view(np.uint8).reshape(r, w * s * bits // 8)
    flat = vals.reshape(r, w * s).astype(np.uint8)
    per = 8 // bits
    pad = (-flat.shape[1]) % per
    flat = np.concatenate([flat, np.zeros((r, pad), np.uint8)], axis=1).reshape(r, -1, per)
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    return np.bitwise_or.reduce(flat << shifts, axis=2).astype(np.uint8)


def _predict(rows: np.ndarray, predictor: int, stride: int, bits: int, bo: str) -> np.ndarray:
    """TIFF Technical Note 3's encoders on (rows, row bytes) of one chunk."""
    r, n = rows.shape
    if predictor == 2:
        dt = np.dtype(f"{bo}u{bits // 8}")
        v = rows.view(dt).reshape(r, -1, stride).astype(np.int64)
        d = v.copy()
        d[:, 1:] = v[:, 1:] - v[:, :-1]
        return (d & ((1 << bits) - 1)).astype(dt).view(np.uint8).reshape(r, n)
    size = bits // 8  # floating point: bytes to planes, most significant first
    vals = rows.view(np.dtype(f"{bo}u{size}")).astype(f">u{size}").view(np.uint8)
    planes = vals.reshape(r, -1, size).transpose(0, 2, 1).reshape(r, n).astype(np.int16)
    out = planes.copy()
    out[:, stride:] = planes[:, stride:] - planes[:, :-stride]
    return (out & 0xFF).astype(np.uint8)


def tiff_bytes(vals, *, photometric: int, bits=8, sample_format: int = 1, extra=(),
               compression: int = 1, predictor: int = 1, planar: int = 1, byteorder: str = "<",
               tile=None, rows_per_strip=None, colormap=None, fillorder: int = 1,
               orientation=None, bigtiff: bool = False, old_lzw: bool = False, pages: int = 1,
               chunks=None, extra_tags=None) -> bytes:
    """A TIFF of ``vals`` ((H, W) or (H, W, S) samples). ``chunks`` gives
    the encoded strips or tiles as they are (JPEG), else each is packed,
    predicted and compressed here (1 none, 5 LZW, 8 and 32946 Deflate,
    32773 PackBits; any other code stores the data raw under that tag).
    ``pages`` repeats the directory for a multi-page file."""
    vals = np.asarray(vals)
    if vals.ndim == 2:
        vals = vals[..., None]
    h, w, spp = vals.shape
    bo = byteorder
    tw, th = tile if tile else (w, rows_per_strip or h)
    across, down = -(-w // tw), -(-h // th)
    planes = spp if planar == 2 else 1
    encoded = []
    if chunks is not None:
        encoded = list(chunks)
    else:
        for p in range(planes):
            for ty in range(down):
                for tx in range(across):
                    block = vals[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
                    block = block[..., p:p + 1] if planar == 2 else block
                    if tile:  # a tile is always whole: pad it
                        pad = np.zeros((th, tw, block.shape[2]), vals.dtype)
                        pad[:block.shape[0], :block.shape[1]] = block
                        block = pad
                    rows = _pack_rows(block, bits, bo)
                    if predictor != 1:
                        rows = _predict(rows, predictor, 1 if planar == 2 else spp, bits, bo)
                    raw = rows.tobytes()
                    if compression == 5:
                        raw = tiff_lzw(raw, old_lzw)
                    elif compression in (8, 32946):
                        raw = zlib.compress(raw, 6)
                    elif compression == 32773:
                        raw = packbits(raw)
                    if fillorder == 2:  # the stored bytes, each bit-reversed
                        table = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
                        raw = raw.translate(table)
                    encoded.append(raw)
    short, long_ = 3, (16 if bigtiff else 4)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (short, [bits] * spp), 259: (short, [compression]),
            262: (short, [photometric]), 277: (short, [spp]), 284: (short, [planar])}
    if sample_format != 1:
        tags[339] = (short, [sample_format] * spp)
    if extra:
        tags[338] = (short, list(extra))
    if predictor != 1:
        tags[317] = (short, [predictor])
    if fillorder != 1:
        tags[266] = (short, [fillorder])
    if orientation:
        tags[274] = (short, [orientation])
    if colormap is not None:
        tags[320] = (short, list(np.asarray(colormap, np.uint16).T.ravel()))
    for tag, value in (extra_tags or {}).items():
        tags[tag] = value
    if tile:
        tags[322], tags[323] = (short, [tw]), (short, [th])
    else:
        tags[278] = (4, [th])
    # layout: header, the pixel data, then each page's directory and its values
    head = 16 if bigtiff else 8
    data = b"".join(encoded)
    offsets, at = [], head
    for e in encoded:
        offsets.append(at)
        at += len(e)
    oname, cname = (324, 325) if tile else (273, 279)
    tags[oname], tags[cname] = (long_, offsets), (long_, [len(e) for e in encoded])
    fmt = {1: "B", 2: "B", 3: "H", 4: "I", 7: "B", 16: "Q"}
    entry, inline, count_fmt, ptr_fmt = (20, 8, "Q", "Q") if bigtiff else (12, 4, "H", "I")
    body = bytearray(data)
    pages_out = []
    for page in range(pages):
        body += b"\0" * (len(body) & 1)  # a directory starts on a word boundary
        ifd_at = head + len(body)
        n = len(tags)
        ifd_size = struct.calcsize(count_fmt) + n * entry + struct.calcsize(ptr_fmt)
        values_at = ifd_at + ifd_size
        entries, values = [], bytearray()
        for tag in sorted(tags):
            typ, val = tags[tag]
            if typ in (2, 7) or isinstance(val, (bytes, bytearray)):
                raw, count = bytes(val), len(val)
            else:
                raw, count = struct.pack(bo + fmt[typ] * len(val), *val), len(val)
            if len(raw) <= inline:
                field = raw + b"\0" * (inline - len(raw))
            else:
                field = struct.pack(bo + ptr_fmt, values_at + len(values))
                values += raw + b"\0" * (len(raw) & 1)
            entries.append(struct.pack(bo + "HH", tag, typ) +
                           struct.pack(bo + ("Q" if bigtiff else "I"), count) + field)
        next_ifd = 0 if page == pages - 1 else values_at + len(values)
        block = struct.pack(bo + count_fmt, n) + b"".join(entries) + \
            struct.pack(bo + ptr_fmt, next_ifd) + bytes(values)
        pages_out.append(ifd_at)
        body += block
    first = pages_out[0]
    if bigtiff:
        header = (b"II" if bo == "<" else b"MM") + struct.pack(bo + "HHHQ", 43, 8, 0, first)
    else:
        header = (b"II" if bo == "<" else b"MM") + struct.pack(bo + "HI", 42, first)
    return header + bytes(body)


# --- WebP --------------------------------------------------------------------------------


def riff_chunks(data: bytes) -> list:
    """[(fourcc, payload)] of a WebP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        kind, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        out.append((kind, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return kind + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def webp_file(chunks) -> bytes:
    """A RIFF WebP file of [(fourcc, payload)]."""
    body = b"WEBP" + b"".join(_chunk(k, b) for k, b in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _u24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def _vp8x_animated(width: int, height: int, alpha: bool) -> tuple:
    """The VP8X chunk of an animated canvas, its alpha flag set or not."""
    flags = (0x10 if alpha else 0) | 0x02
    return b"VP8X", bytes([flags, 0, 0, 0]) + _u24(width - 1) + _u24(height - 1)


def alph(alpha: np.ndarray, filtering: int, vp8l_green=None) -> bytes:
    """An ALPH payload: the plane filtered (0 none, 1 horizontal, 2
    vertical, 3 gradient, as libwebp's filters define them), stored raw, or
    as ``vp8l_green`` (a headerless VP8L stream whose green channel an
    encoder wrote from :func:`alpha_filtered`)."""
    method = 0 if vp8l_green is None else 1
    head = bytes([method | (filtering << 2)])
    if vp8l_green is not None:
        return head + vp8l_green
    return head + alpha_filtered(alpha, filtering).tobytes()


def alpha_filtered(a: np.ndarray, filtering: int) -> np.ndarray:
    """The residuals libwebp's unfilter turns back into ``a``."""
    a = a.astype(np.int32)
    h, w = a.shape
    pred = np.zeros_like(a)
    if filtering == 0:
        return a.astype(np.uint8)
    pred[0, 1:] = a[0, :-1]
    if filtering == 1:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = a[1:, :-1]
    elif filtering == 2:
        pred[1:] = a[:-1]
    else:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 0xFF).astype(np.uint8)


def replace_alph(webp: bytes, payload: bytes) -> bytes:
    """A lossy WebP with its ALPH chunk replaced by ``payload``."""
    return webp_file([(k, payload if k == b"ALPH" else b) for k, b in riff_chunks(webp)])


def anim_webp(canvas, frames, alpha: bool) -> bytes:
    """An animated WebP: the canvas (width, height) and frames of
    (x, y, width, height, [(fourcc, payload)] of the frame's image)."""
    cw, ch = canvas
    chunks = [_vp8x_animated(cw, ch, alpha), (b"ANIM", b"\0\0\0\0\0\0")]
    for x, y, w, h, image in frames:
        head = _u24(x // 2) + _u24(y // 2) + _u24(w - 1) + _u24(h - 1) + _u24(100) + b"\0"
        chunks.append((b"ANMF", head + b"".join(_chunk(k, b) for k, b in image)))
    return webp_file(chunks)
