"""GIF files to numpy arrays without PIL.

The JAX package opens a GIF with ``PIL.Image.open``. This module gives
what Pillow 12's ``GifImagePlugin`` and ``GifDecode.c`` give for the first
frame, byte for byte: :func:`decode_gif` returns ``np.asarray(img)``, its
mode, its palette and ``img.info.get("transparency")``.

- GIF87a and GIF89a; global and local colour tables of 2 to 256 entries;
  interlaced rows; the LZW data (``imgcodecs.cpp``) with clear codes and a
  table that stops growing at 4096 codes;
- the mode is Pillow's: ``P`` with the frame's palette (the local one,
  else the global one), or ``L`` where there is none or it is the identity
  grey ramp (Pillow drops such a palette);
- the first graphic-control extension's transparency index is
  ``info["transparency"]``;
- a frame smaller than the logical screen, or offset inside it, is pasted
  onto a screen filled with the transparency index (0 without one); a
  frame reaching past the screen grows it, as Pillow does;
- an animated file gives its first frame.

A file Pillow refuses (no image, a truncated block) raises a
``ValueError`` naming it.
"""

from __future__ import annotations

import numpy as np

from fastscnn_tpu_torch.data import imgcodecs

__all__ = ["decode_gif", "gif_size", "is_gif"]


def is_gif(data) -> bool:
    """Whether ``data`` starts with ``GIF87a`` or ``GIF89a``."""
    return bytes(data[:6]) in (b"GIF87a", b"GIF89a")


def gif_size(data: bytes, name: str = "<bytes>") -> tuple[int, int]:
    """``Image.open(f).size``: the logical screen, grown to hold the first
    frame where that reaches past it; from the headers alone."""
    return decode_gif(data, name, size_only=True)


def _palette_needed(p: bytes) -> bool:
    """``GifImageFile._is_palette_needed``: any entry other than (i, i, i)."""
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2]) for i in range(0, len(p) - 2, 3))


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def block(self):
        """One sub-block's bytes; None at a zero length or the end."""
        s = self.read(1)
        if s and s[0]:
            return self.read(s[0])
        return None


def decode_gif(data: bytes, name: str = "<bytes>", size_only: bool = False):
    """``(array, mode, palette, transparency)`` of a GIF's first frame:
    uint8 (H, W) indices under ``'P'`` with the (N, 3) palette, or grey
    values under ``'L'`` (with the global palette where a grey local table
    hid it, else None); the transparency index or None. With ``size_only``,
    (width, height) alone."""
    if len(data) < 13 or not is_gif(data):
        raise ValueError(f"{name}: not a GIF file")
    f = _Reader(data)
    s = f.read(13)
    width, height = int.from_bytes(s[6:8], "little"), int.from_bytes(s[8:10], "little")
    flags = s[10]
    global_palette = None
    if flags & 128:
        p = f.read(3 << ((flags & 7) + 1))
        if _palette_needed(p):
            global_palette = p
    palette, transparency, frame = None, None, None
    while True:
        s = f.read(1)
        if not s or s == b";":
            break
        if s == b"!":
            label = f.read(1)
            block = f.block()
            if label and label[0] == 249 and block is not None:
                if block[0] & 1:
                    if len(block) < 4:
                        raise ValueError(f"{name}: truncated graphic control extension")
                    transparency = block[3]
            while f.block():
                pass
        elif s == b",":
            s = f.read(9)
            if len(s) < 9:
                raise ValueError(f"{name}: truncated GIF image descriptor")
            x0, y0 = int.from_bytes(s[0:2], "little"), int.from_bytes(s[2:4], "little")
            fw, fh = int.from_bytes(s[4:6], "little"), int.from_bytes(s[6:8], "little")
            width, height = max(width, x0 + fw), max(height, y0 + fh)
            iflags = s[8]
            if iflags & 128:
                p = f.read(3 << ((iflags & 7) + 1))
                palette = p if _palette_needed(p) else False
            bits = f.read(1)
            if not bits:
                raise ValueError(f"{name}: truncated GIF image data")
            frame = (x0, y0, fw, fh, bool(iflags & 64), bits[0])
            break
    if frame is None:
        raise ValueError(f"{name}: no image in the GIF file")
    if size_only:
        return width, height
    imgcodecs.check_pixels(width, height, name)
    frame_palette = palette if palette is not None else global_palette
    mode = "P" if frame_palette else "L"
    x0, y0, fw, fh, interlace, min_bits = frame
    parts, ended = [], False
    while True:
        s = f.read(1)
        if not s:
            break
        if s[0] == 0:
            ended = True
            break
        chunk = f.read(s[0])
        parts.append(chunk)
        if len(chunk) < s[0]:
            break
    npix = fw * fh
    buf = np.full(npix, transparency or 0, np.uint8)
    written = imgcodecs.gif_lzw(b"".join(parts), min_bits, npix, buf, name) if npix else 0
    if written < npix and not ended:
        raise ValueError(f"{name}: the GIF image data is truncated")
    img = np.full((height, width), transparency or 0, np.uint8)
    rows = buf.reshape(fh, fw)
    if interlace:
        order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8), np.arange(2, fh, 4),
                                np.arange(1, fh, 2)])
        framed = np.empty_like(rows)
        framed[order] = rows
        rows = framed
    img[y0:y0 + fh, x0:x0 + fw] = rows
    # a P image's palette; an L image whose local table is a grey ramp keeps
    # the global one, which Pillow's core takes as a palette for converts
    pal = frame_palette if mode == "P" else global_palette if palette is False else None
    if pal is not None:
        pal = np.frombuffer(pal, np.uint8).reshape(-1, 3)
    return img, mode, pal, transparency
