"""WebP files to numpy arrays without PIL.

The JAX package opens a WebP with ``PIL.Image.open``, which Pillow 12
hands to libwebp's ``WebPAnimDecoder`` for every file, still or animated.
:func:`decode_webp` gives the same first frame and mode, byte for byte:

- the RIFF container: simple lossy (``VP8``) and lossless (``VP8L``)
  files, and extended (``VP8X``) ones with their ICCP, EXIF, XMP and
  unknown chunks skipped;
- lossless bitstreams (RFC 9649) and lossy key frames (RFC 6386) with an
  ``ALPH`` chunk, raw or lossless-coded, under any of its filters, decoded
  by ``imgcodecs.cpp`` (YUV 4:2:0 to RGB as libwebp 1.6's C code does it);
- an animated file's first frame, drawn at its offset onto a transparent
  black canvas, as ``WebPAnimDecoder`` gives it;
- the mode is ``RGBA`` where the file says it has alpha (the ``VP8X``
  flag or an ``ALPH`` chunk, the ``VP8L`` header's bit), else ``RGB``
  (Pillow's raw mode ``RGBX``).

A file libwebp refuses raises a ``ValueError`` naming it.
"""

from __future__ import annotations

import struct

import numpy as np

from fastscnn_tpu_torch.data import imgcodecs

__all__ = ["decode_webp", "is_webp", "webp_size"]


def is_webp(data) -> bool:
    """Whether ``data`` is a RIFF WebP file whose first chunk Pillow takes
    (``VP8 ``, ``VP8L`` or ``VP8X``)."""
    return bytes(data[:4]) == b"RIFF" and bytes(data[8:12]) == b"WEBP" and \
        bytes(data[12:16]) in (b"VP8 ", b"VP8L", b"VP8X")


def _chunks(data: bytes, start: int, end: int, name: str):
    """[(fourcc, payload)] of the chunks in data[start:end], each padded
    to an even size."""
    out, pos = [], start
    while pos + 8 <= end:
        kind = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + size]
        if len(body) < size or pos + 8 + size > end:
            raise ValueError(f"{name}: truncated WebP chunk {kind!r}")
        out.append((kind, body))
        pos += 8 + size + (size & 1)
    return out


def _u24(b: bytes, at: int) -> int:
    return b[at] | (b[at + 1] << 8) | (b[at + 2] << 16)


def _frame_size(kind: bytes, body: bytes, name: str) -> tuple[int, int, bool]:
    """(width, height, alpha hint) from a VP8 or VP8L bitstream's header."""
    if kind == b"VP8L":
        if len(body) < 5 or body[0] != 0x2F:
            raise ValueError(f"{name}: not a VP8L bitstream")
        bits = struct.unpack_from("<I", body, 1)[0]
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, bool((bits >> 28) & 1)
    if len(body) < 10 or body[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"{name}: not a VP8 key frame")
    return (struct.unpack_from("<H", body, 6)[0] & 0x3FFF,
            struct.unpack_from("<H", body, 8)[0] & 0x3FFF, False)


def _decode_frame(chunks, name: str) -> np.ndarray:
    """(H, W, 4) RGBA of one image: an optional ALPH and a VP8 or VP8L."""
    alph = next((b for k, b in chunks if k == b"ALPH"), None)
    for kind, body in chunks:
        if kind == b"VP8L":
            w, h, _ = _frame_size(kind, body, name)
            imgcodecs.check_pixels(w, h, name)
            return imgcodecs.vp8l(body, w, h, name)
        if kind == b"VP8 ":
            w, h, _ = _frame_size(kind, body, name)
            imgcodecs.check_pixels(w, h, name)
            rgba = imgcodecs.vp8(body, w, h, name)
            if alph is not None:
                rgba[..., 3] = imgcodecs.alpha_plane(alph, w, h, name)
            return rgba
    raise ValueError(f"{name}: a WebP frame without a VP8 or VP8L bitstream")


def webp_size(data: bytes, name: str = "<bytes>") -> tuple[int, int]:
    """``Image.open(f).size``: the canvas of a ``VP8X`` file, else the
    bitstream's size."""
    if not is_webp(data):
        raise ValueError(f"{name}: not a WebP file")
    kind = data[12:16]
    if kind == b"VP8X":
        return 1 + _u24(data, 24), 1 + _u24(data, 27)
    body = data[20:20 + 10]
    w, h, _ = _frame_size(kind, body, name)
    return w, h


def decode_webp(data: bytes, name: str = "<bytes>"):
    """``(array, mode, None, None)``: uint8 (H, W, 3) under ``'RGB'`` or
    (H, W, 4) under ``'RGBA'``, the first frame as Pillow gives it."""
    try:
        return _decode_webp(data, name)
    except (IndexError, struct.error) as e:  # a chunk shorter than its fields
        raise ValueError(f"{name}: a corrupt WebP file ({e})") from None


def _decode_webp(data: bytes, name: str):
    if not is_webp(data):
        raise ValueError(f"{name}: not a WebP file")
    riff = struct.unpack_from("<I", data, 4)[0]
    end = min(len(data), 8 + riff)
    chunks = _chunks(data, 12, end, name)
    kind, first = chunks[0]
    if kind == b"VP8X":
        if len(first) < 10:
            raise ValueError(f"{name}: truncated VP8X chunk")
        flags = first[0]
        cw, ch = 1 + _u24(first, 4), 1 + _u24(first, 7)
        imgcodecs.check_pixels(cw, ch, name)
        if flags & 0x02:  # animation: the first ANMF frame on a transparent canvas
            frame = next((b for k, b in chunks if k == b"ANMF"), None)
            if frame is None or len(frame) < 16:
                raise ValueError(f"{name}: an animated WebP without a frame")
            x, y = 2 * _u24(frame, 0), 2 * _u24(frame, 3)
            fw, fh = 1 + _u24(frame, 6), 1 + _u24(frame, 9)
            if x + fw > cw or y + fh > ch:
                raise ValueError(f"{name}: a WebP frame past its canvas")
            rgba = _decode_frame(_chunks(frame, 16, len(frame), name), name)
            if rgba.shape[:2] != (fh, fw):
                raise ValueError(f"{name}: a WebP frame's bitstream differs from its size")
            out = np.zeros((ch, cw, 4), np.uint8)
            out[y:y + fh, x:x + fw] = rgba
            alpha = bool(flags & 0x10)
        else:
            out = _decode_frame(chunks, name)
            if out.shape[:2] != (ch, cw):
                raise ValueError(f"{name}: the WebP image differs from its canvas")
            alpha = bool(flags & 0x10) or any(k == b"ALPH" for k, _ in chunks)
    else:
        out = _decode_frame(chunks[:1], name)
        alpha = _frame_size(kind, first, name)[2]
    if alpha:
        return out, "RGBA", None, None
    return np.ascontiguousarray(out[..., :3]), "RGB", None, None
