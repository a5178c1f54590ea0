"""Write the JPEG fixtures and their manifest with Pillow.

    python tests/fixtures/jpeg/make_fixtures.py

Writes, beside this script:

- small JPEGs saved by Pillow in each variant its encoder writes (4:2:0,
  4:2:2, 4:4:4, greyscale, progressive, a restart interval, quality 1 and
  100, odd sizes, CMYK) and one smooth 1280x720 quality-90 frame;
- the variants Pillow decodes but does not write, from ``spec_writers.py``
  (ITU-T T.81): other sampling factors, YCCK and CMYK without Pillow's
  markers, sequential and progressive arithmetic coding, lossless frames;
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
CMYK = "cmyk_adobe_q85_33x41.jpg"  # Pillow's own CMYK writer (Adobe APP14, transform 0)


def _ycc(rgb: np.ndarray) -> list:
    """JFIF's Y, Cb, Cr planes of an RGB array (T.81 / JFIF 1.02), uint8."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    planes = (y, 128 + (b - y) / 1.772, 128 + (r - y) / 1.402)
    return [np.clip(np.rint(p), 0, 255).astype(np.uint8) for p in planes]


def spec_files() -> dict:
    """name -> bytes of the variants written from T.81 (``spec_writers``):
    sampling factors Pillow's encoder does not write, YCCK and CMYK without
    Pillow's markers, arithmetic coding, lossless frames."""
    import spec_writers as sw

    rgb = seeded(37, 45, "RGB", 200)
    ycc = _ycc(rgb)
    grey = seeded(29, 33, "L", 201)
    k = seeded(37, 45, "L", 202)
    cmy = [255 - rgb[..., i] for i in range(3)]
    f420 = [(2, 2), (1, 1), (1, 1)]
    return {
        "rgb411_q80_45x37.jpg": sw.dct_jpeg(ycc, [(4, 1), (1, 1), (1, 1)], jfif=True),
        "rgb440_q80_45x37.jpg": sw.dct_jpeg(ycc, [(1, 2), (1, 1), (1, 1)], jfif=True),
        "rgb410_q80_45x37.jpg": sw.dct_jpeg(ycc, [(4, 2), (1, 1), (1, 1)], jfif=True),
        "rgb_mixed_h2v2_h2v1_h1v2_45x37.jpg": sw.dct_jpeg(ycc, [(2, 2), (2, 1), (1, 2)],
                                                          jfif=True),
        "rgb_y3x1_q80_45x37.jpg": sw.dct_jpeg(ycc, [(3, 1), (1, 1), (1, 1)], jfif=True),
        "rgb_y1x3_restart_q80_45x37.jpg": sw.dct_jpeg(ycc, [(1, 3), (1, 1), (1, 1)], jfif=True,
                                                      restart=2),
        "rgb_y4x4_scan_a_component_45x37.jpg": sw.dct_jpeg(ycc, [(4, 4), (1, 1), (1, 1)],
                                                           jfif=True, interleave=False),
        "rgb_ids_rgb_h2v1_q90_45x37.jpg": sw.dct_jpeg([rgb[..., i] for i in range(3)],
                                                      [(2, 1), (1, 1), (1, 1)], quality=90,
                                                      ids=[82, 71, 66]),
        "gray_h2v2_q80_33x29.jpg": sw.dct_jpeg([grey], [(2, 2)]),
        "ycck_adobe2_q85_45x37.jpg": sw.dct_jpeg([*_ycc(rgb), k], [(2, 2), (1, 1), (1, 1), (2, 2)],
                                                 quality=85, adobe=2),
        "cmyk_noadobe_411_q85_45x37.jpg": sw.dct_jpeg([*cmy, k], [(2, 1), (1, 1), (1, 1), (2, 1)],
                                                      quality=85),
        "arith_rgb420_q75_45x37.jpg": sw.dct_jpeg(ycc, f420, quality=75, jfif=True,
                                                  coding="arith"),
        "arith_gray_dac_restart_q80_33x29.jpg": sw.dct_jpeg([grey], [(1, 1)], coding="arith",
                                                            dac=(1, 3, 2), restart=3),
        "arith_progressive_rgb420_q80_45x37.jpg": sw.dct_jpeg(ycc, f420, jfif=True,
                                                              coding="arith-progressive"),
        "arith_progressive_rgb422_dac_restart_45x37.jpg": sw.dct_jpeg(
            ycc, [(2, 1), (1, 1), (1, 1)], jfif=True, coding="arith-progressive", dac=(0, 2, 9),
            restart=4),
        "arith_progressive_gray_q60_33x29.jpg": sw.dct_jpeg([grey], [(1, 1)], quality=60,
                                                            coding="arith-progressive"),
        "arith_ycck_q80_45x37.jpg": sw.dct_jpeg([*_ycc(rgb), k], [(1, 1)] * 4, adobe=2,
                                                coding="arith"),
        "lossless_gray_p7_33x29.jpg": sw.lossless_jpeg([grey], predictor=7),
        "lossless_gray_p1_pt2_33x29.jpg": sw.lossless_jpeg([grey], predictor=1, pt=2),
        "lossless_rgb_p4_restart_45x37.jpg": sw.lossless_jpeg([rgb[..., i] for i in range(3)],
                                                              predictor=4, ids=[82, 71, 66],
                                                              restart_rows=3),
        "lossless_rgb_p5_45x37.jpg": sw.lossless_jpeg([rgb[..., i] for i in range(3)],
                                                      predictor=5, ids=[82, 71, 66]),
        "lossless_rgb_p6_45x37.jpg": sw.lossless_jpeg([rgb[..., i] for i in range(3)],
                                                      predictor=6, ids=[82, 71, 66]),
        "lossless_cmyk_p2_45x37.jpg": sw.lossless_jpeg([*cmy, k], predictor=2),
    }

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
    Image.fromarray(np.concatenate([seeded(41, 33, "RGB", 203), seeded(41, 33, "L", 204)[..., None]],
                                   axis=2), "CMYK").save(os.path.join(HERE, CMYK), "JPEG",
                                                         quality=85)
    spec = spec_files()
    for name, data in spec.items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    for name in [*FILES, FRAME, CMYK, *spec]:
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
