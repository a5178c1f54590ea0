"""Write the JPEG fixtures and their manifest with Pillow.

    python tests/fixtures/jpeg/make_fixtures.py

Writes, beside this script:

- small JPEGs saved by Pillow in each variant the port's codec reads
  (4:2:0, 4:2:2, 4:4:4, greyscale, progressive, a restart interval,
  quality 1 and 100, odd sizes) and one smooth 1280x720 quality-90
  frame;
- the seeded inputs of the encoder checks, as PNGs (lossless);
- ``manifest.json``: for each JPEG the sha256 of
  ``np.asarray(Image.open(f))``'s bytes, its shape and mode; for each
  encoder check the sha256 of the bytes of ``Image.fromarray(a).save(f,
  "JPEG", quality=q)``, ``a`` the input's pixels.

The port's tests and the card's smoke script hold the codec to the
manifest, so a build on a machine without Pillow is checked too.
"""

from __future__ import annotations

import hashlib
import io
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# name -> (height, width, mode, save keywords)
FILES = {
    "rgb420_q75_37x53.jpg": (37, 53, "RGB", {"quality": 75}),
    "rgb422_q90_40x31.jpg": (40, 31, "RGB", {"quality": 90, "subsampling": 1}),
    "rgb444_q95_29x45.jpg": (29, 45, "RGB", {"quality": 95, "subsampling": 0}),
    "gray_q75_37x53.jpg": (37, 53, "L", {"quality": 75}),
    "rgb420_progressive_q80_61x47.jpg": (61, 47, "RGB", {"quality": 80, "progressive": True}),
    "gray_progressive_q60_33x64.jpg": (33, 64, "L", {"quality": 60, "progressive": True}),
    "rgb420_restart2_q85_50x64.jpg": (50, 64, "RGB", {"quality": 85, "restart_marker_blocks": 2}),
    "rgb420_q1_33x27.jpg": (33, 27, "RGB", {"quality": 1}),
    "rgb444_q100_21x19.jpg": (21, 19, "RGB", {"quality": 100, "subsampling": 0}),
}
FRAME = "frame_1280x720_q90.jpg"
# encoder checks: (input file, quality); the frame's input is its decoded pixels
INPUTS = {"input_rgb_37x53.png": (37, 53, "RGB"), "input_gray_29x61.png": (29, 61, "L")}
ENCODES = [(name, q) for name in INPUTS for q in (75, 90, 95)] + [(FRAME, 90)]


def seeded(h: int, w: int, mode: str, seed: int) -> np.ndarray:
    """A smooth gradient with seeded noise on it: uint8 (h, w[, 3])."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([255 * x / max(w - 1, 1), 255 * y / max(h - 1, 1),
                     127.5 + 127.5 * np.sin((x + 2 * y) / 5.0)], axis=-1)
    arr = np.clip(base + rng.integers(-40, 41, base.shape), 0, 255).astype(np.uint8)
    return arr[..., 0].copy() if mode == "L" else arr


def frame() -> np.ndarray:
    """A smooth synthetic 1280x720 road-like RGB frame."""
    y, x = np.mgrid[0:720, 0:1280].astype(np.float64)
    sky = y < 300
    r = np.where(sky, 120 + 60 * y / 300, 90 + 40 * np.sin(x / 97.0))
    g = np.where(sky, 160 + 50 * y / 300, 90 + 30 * np.cos(y / 41.0))
    b = np.where(sky, 230 - 20 * y / 300, 95 + 20 * np.sin((x + y) / 63.0))
    lane = (np.abs((x - 640) - (y - 300) * 1.1) < 6) | (np.abs((x - 640) + (y - 300) * 1.1) < 6)
    rgb = np.stack([r, g, b], axis=-1)
    rgb[lane & ~sky] = 235
    return np.clip(rgb, 0, 255).astype(np.uint8)


def pixels_digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def main() -> None:
    from PIL import Image

    manifest = {"pillow": Image.__version__, "decode": {}, "encode": []}
    for k, (name, (h, w, mode, kw)) in enumerate(FILES.items()):
        Image.fromarray(seeded(h, w, mode, k)).save(os.path.join(HERE, name), "JPEG", **kw)
    Image.fromarray(frame()).save(os.path.join(HERE, FRAME), "JPEG", quality=90)
    for name in [*FILES, FRAME]:
        with Image.open(os.path.join(HERE, name)) as img:
            arr = np.asarray(img)
            manifest["decode"][name] = {"sha256": pixels_digest(arr), "shape": list(arr.shape),
                                        "mode": img.mode}
    for k, (name, (h, w, mode)) in enumerate(INPUTS.items()):
        Image.fromarray(seeded(h, w, mode, 100 + k)).save(os.path.join(HERE, name))
    for name, q in ENCODES:
        arr = np.asarray(Image.open(os.path.join(HERE, name)))
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=q)
        manifest["encode"].append({"input": name, "quality": q,
                                   "sha256": hashlib.sha256(buf.getvalue()).hexdigest()})
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
