"""Mask creation and editing: counterpart of ``fastscnn_tpu/tools/mask_editor.py``.

Ports of reference:create_mask.py (polygon/brush painter with undo) and
reference:interactive_mask_editor.py (4-mode editor: fill/rect/polygon/
brush with undo/redo): the headless geometry core (``MaskCanvas``) and
the directory session (``EditorSession``), reading PNG, JPEG and BMP
with ``data/image_io.py``, resizing with ``data/pil_ops.py`` and writing
PNGs with ``image_io.write_png`` (no PIL). The JAX package's OpenCV windows
(``--image`` and ``--images-dir`` on a display) are not ported: the
card's machine has neither OpenCV nor a display, and the CLI raises
naming ROADMAP.md's "item 5, left out: display windows".
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from fastscnn_tpu_torch.data import image_io, pil_ops

__all__ = ["MaskCanvas", "EditorSession"]

_LEFT_OUT = ("the OpenCV editor windows need a display and OpenCV, which the port does not "
             "use (ROADMAP.md, queue 1, item 5, left out: display windows); drive "
             "MaskCanvas and EditorSession from Python instead")


class MaskCanvas:
    """Headless mask editing state machine with undo/redo."""

    def __init__(self, height: int, width: int, mask: np.ndarray | None = None):
        self.mask = (
            np.zeros((height, width), np.uint8) if mask is None else mask.astype(np.uint8)
        )
        self._undo: list[np.ndarray] = []
        self._redo: list[np.ndarray] = []

    def _checkpoint(self):
        self._undo.append(self.mask.copy())
        if len(self._undo) > 50:
            self._undo.pop(0)
        self._redo.clear()

    # -- operations ----------------------------------------------------------
    def brush(self, x: int, y: int, radius: int, value: int = 255, checkpoint=True):
        if checkpoint:
            self._checkpoint()
        h, w = self.mask.shape
        ys, xs = np.ogrid[:h, :w]
        circle = (xs - x) ** 2 + (ys - y) ** 2 <= radius**2
        self.mask[circle] = value

    def rectangle(self, x0: int, y0: int, x1: int, y1: int, value: int = 255):
        self._checkpoint()
        # sort BEFORE clamping: clamp-then-sort turns a right-to-left drag
        # into an empty (or negative-start, edge-wrapping) slice
        x0, x1 = sorted((x0, x1))
        y0, y1 = sorted((y0, y1))
        x0, x1 = max(0, x0), min(self.mask.shape[1], x1)
        y0, y1 = max(0, y0), min(self.mask.shape[0], y1)
        self.mask[y0:y1, x0:x1] = value

    def polygon(self, points, value: int = 255):
        """Fill a polygon given [(x, y), ...] vertices (even-odd rule)."""
        self._checkpoint()
        h, w = self.mask.shape
        pts = np.asarray(points, np.float64)
        ys, xs = np.mgrid[:h, :w]
        inside = np.zeros((h, w), bool)
        n = len(pts)
        j = n - 1
        for i in range(n):
            xi, yi = pts[i]
            xj, yj = pts[j]
            crosses = ((yi > ys) != (yj > ys)) & (
                xs < (xj - xi) * (ys - yi) / (yj - yi + 1e-12) + xi
            )
            inside ^= crosses
            j = i
        self.mask[inside] = value

    def flood_fill(self, x: int, y: int, value: int = 255):
        """4-connected flood fill from (x, y) over the seed's current value."""
        self._checkpoint()
        target = self.mask[y, x]
        if target == value:
            return
        h, w = self.mask.shape
        stack = [(y, x)]
        while stack:
            cy, cx = stack.pop()
            if not (0 <= cy < h and 0 <= cx < w) or self.mask[cy, cx] != target:
                continue
            # fill the horizontal run
            x0 = cx
            while x0 > 0 and self.mask[cy, x0 - 1] == target:
                x0 -= 1
            x1 = cx
            while x1 < w - 1 and self.mask[cy, x1 + 1] == target:
                x1 += 1
            self.mask[cy, x0 : x1 + 1] = value
            for ny in (cy - 1, cy + 1):
                if 0 <= ny < h:
                    run = np.flatnonzero(self.mask[ny, x0 : x1 + 1] == target)
                    if len(run):
                        # push one seed per contiguous segment
                        breaks = np.flatnonzero(np.diff(run) > 1)
                        seeds = [run[0]] + [run[b + 1] for b in breaks]
                        for s in seeds:
                            stack.append((ny, x0 + int(s)))

    def clear(self):
        self._checkpoint()
        self.mask[:] = 0

    # -- history -------------------------------------------------------------
    def undo(self) -> bool:
        if not self._undo:
            return False
        self._redo.append(self.mask.copy())
        self.mask = self._undo.pop()
        return True

    def redo(self) -> bool:
        if not self._redo:
            return False
        self._undo.append(self.mask.copy())
        self.mask = self._redo.pop()
        return True

    def save(self, path: str):
        image_io.save_image(path, self.mask)


class EditorSession:
    """Directory-based editing session: image list, prev/next navigation,
    one :class:`MaskCanvas` per image with its existing mask auto-loaded.

    This is the headless (tested) half of the reference's interactive
    editor (reference:interactive_mask_editor.py:43-95): same image
    discovery (jpg/jpeg/png/bmp, deduped+sorted), same
    ``<mask_dir>/<image-stem>.png`` mask convention, same save semantics.
    The display windows that drive it in the JAX package are not ported
    (they need OpenCV and a display).
    """

    IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")

    def __init__(self, image_dir: str, mask_dir: str):
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.image_files = sorted(
            {
                os.path.join(image_dir, f)
                for f in os.listdir(image_dir)
                if f.lower().endswith(self.IMAGE_EXTS)
            }
        )
        self.index = 0
        self.canvas: MaskCanvas | None = None
        self.image: np.ndarray | None = None  # HWC RGB uint8
        if self.image_files:
            self._load()

    # -- navigation -----------------------------------------------------------
    @property
    def current_image_path(self) -> str:
        return self.image_files[self.index]

    @property
    def current_mask_path(self) -> str:
        stem = os.path.splitext(os.path.basename(self.current_image_path))[0]
        return os.path.join(self.mask_dir, f"{stem}.png")

    def _load(self):
        self.image = np.array(image_io.read_image(self.current_image_path, "RGB"))
        h, w = self.image.shape[:2]
        mask = None
        if os.path.exists(self.current_mask_path):
            m = image_io.read_image(self.current_mask_path, "L")
            if m.shape != (h, w):
                m = pil_ops.resize(m, (w, h), "nearest")
            mask = np.array(m, np.uint8)
        self.canvas = MaskCanvas(h, w, mask)

    def next(self) -> bool:
        """Advance to the next image; False when already at the last one
        (matching the reference's boundary behavior, :353-359)."""
        if self.index + 1 >= len(self.image_files):
            return False
        self.index += 1
        self._load()
        return True

    def prev(self) -> bool:
        if self.index == 0:
            return False
        self.index -= 1
        self._load()
        return True

    def save(self) -> str:
        os.makedirs(self.mask_dir, exist_ok=True)
        self.canvas.save(self.current_mask_path)
        return self.current_mask_path

    def overlay(self, color=(0, 200, 0), alpha=0.5) -> np.ndarray:
        """Painted-region overlay for display (RGB uint8)."""
        out = self.image.copy()
        sel = self.canvas.mask > 0
        out[sel] = ((1 - alpha) * out[sel] + alpha * np.asarray(color)).astype(np.uint8)
        return out


def _interactive(image_path: str, mask_path: str):
    raise NotImplementedError(_LEFT_OUT)


def _interactive_session(image_dir: str, mask_dir: str):
    raise NotImplementedError(_LEFT_OUT)


def main(argv=None):
    parser = argparse.ArgumentParser(description="interactive mask editor")
    parser.add_argument("--image", default=None, help="edit one image's mask")
    parser.add_argument("--mask", default=None)
    parser.add_argument("--images-dir", default=None,
                        help="directory session with n/, navigation "
                             "(reference interactive_mask_editor.py surface)")
    parser.add_argument("--masks-dir", default=None)
    args = parser.parse_args(argv)
    if args.images_dir:
        _interactive_session(args.images_dir, args.masks_dir or args.images_dir)
    elif args.image:
        mask_path = args.mask or os.path.splitext(args.image)[0] + "_mask.png"
        _interactive(args.image, mask_path)
    else:
        parser.error("one of --image or --images-dir is required")


if __name__ == "__main__":
    main()
