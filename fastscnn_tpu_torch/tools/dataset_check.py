"""Dataset diagnostics and visualization: counterpart of
``fastscnn_tpu/tools/dataset_check.py``.

- ``check_masks`` — mask sanity report (shapes, unique values, mode,
  foreground ratio, image↔mask size match) (reference:check_masks.py)
- ``make_overlay_grid`` — overlay grids of images + masks/predictions
  (reference:visualize_results.py, visualize_bdd100k_labels.py)

No PIL: masks and images are read with ``data/image_io.py``, an image's
size for the match check from its header alone (a PNG's IHDR, a JPEG's
frame header: ``image_io.image_size``, no decoder), the NEAREST and
BILINEAR resizes are ``data/pil_ops.resize`` (Pillow's, bit for bit) and
the grid is written by ``image_io.save_image``: by default
``overlay_grid.jpg``, as the JAX tool, in Pillow's JPEG bytes through the
port's codec (a ``.png`` name writes a PNG).

Usage::

    python -m fastscnn_tpu_torch.tools.dataset_check masks --images-dir ... --masks-dir ...
    python -m fastscnn_tpu_torch.tools.dataset_check overlay --images-dir ... \\
        --masks-dir ... --out grid.jpg
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from fastscnn_tpu_torch.data import image_io, pil_ops

__all__ = ["check_masks", "make_overlay_grid"]


def check_masks(images_dir: str, masks_dir: str) -> list[dict]:
    """Per-pair sanity report; flags size mismatches, empty/full masks,
    and unexpected value sets."""
    reports = []
    for f in sorted(os.listdir(masks_dir)):
        if not f.lower().endswith(".png"):
            continue
        base = os.path.splitext(f)[0]
        mask = image_io.read_image(os.path.join(masks_dir, f))
        if mask.ndim == 3:
            mask = mask[:, :, 0]
        report = {
            "name": f,
            "shape": tuple(mask.shape),
            "unique_values": np.unique(mask).tolist(),
            "foreground_ratio": float((mask > 128).mean()),
            "issues": [],
        }
        img_path = None
        for ext in (".jpg", ".jpeg", ".png"):
            p = os.path.join(images_dir, base + ext)
            if os.path.exists(p):
                img_path = p
                break
        if img_path is None:
            report["issues"].append("no matching image")
        else:
            size = image_io.image_size(img_path)
            if size != (mask.shape[1], mask.shape[0]):
                report["issues"].append(
                    f"size mismatch: image {size} vs mask {(mask.shape[1], mask.shape[0])}"
                )
        if report["foreground_ratio"] == 0.0:
            report["issues"].append("empty mask")
        elif report["foreground_ratio"] == 1.0:
            report["issues"].append("all-foreground mask")
        # values outside the small-class-id range and not the 0/255 binary
        # convention are label corruption
        extra = [v for v in report["unique_values"] if v not in (0, 255) and v > 3]
        if extra:
            report["issues"].append(f"unexpected values {extra[:5]}")
        reports.append(report)
    return reports


def make_overlay_grid(
    images_dir: str,
    masks_dir: str,
    out_path: str,
    max_samples: int = 9,
    alpha: float = 0.45,
    columns: int = 3,
) -> str:
    """Green-overlay grid of up to ``max_samples`` pairs."""
    pairs = []
    for f in sorted(os.listdir(masks_dir)):
        if not f.lower().endswith(".png"):
            continue
        base = os.path.splitext(f)[0]
        for ext in (".jpg", ".jpeg", ".png"):
            p = os.path.join(images_dir, base + ext)
            if os.path.exists(p):
                pairs.append((p, os.path.join(masks_dir, f)))
                break
        if len(pairs) >= max_samples:
            break
    if not pairs:
        raise FileNotFoundError("no image/mask pairs found")
    tiles = []
    tile_size = None
    for img_path, mask_path in pairs:
        img = image_io.read_image(img_path, "RGB").astype(np.float64)
        mask = image_io.read_image(mask_path)
        if mask.shape[:2] != img.shape[:2]:
            mask = pil_ops.resize(mask, (img.shape[1], img.shape[0]), "nearest")
        if mask.ndim == 3:
            mask = mask[:, :, 0]
        overlay = img.copy()
        overlay[mask > 128] = overlay[mask > 128] * (1 - alpha) + np.array([0, 255, 0]) * alpha
        tile = overlay.astype(np.uint8)
        if tile_size is None:
            tile_size = tile.shape[:2]
        elif tile.shape[:2] != tile_size:
            tile = pil_ops.resize(tile, (tile_size[1], tile_size[0]), "bilinear")
        tiles.append(tile)
    rows = -(-len(tiles) // columns)
    h, w = tile_size
    grid = np.zeros((rows * h, columns * w, 3), np.uint8)
    for i, tile in enumerate(tiles):
        r, c = divmod(i, columns)
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = tile
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    image_io.save_image(out_path, grid)
    return out_path


def main(argv=None):
    parser = argparse.ArgumentParser(description="dataset diagnostics")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("masks")
    p.add_argument("--images-dir", required=True)
    p.add_argument("--masks-dir", required=True)
    p = sub.add_parser("overlay")
    p.add_argument("--images-dir", required=True)
    p.add_argument("--masks-dir", required=True)
    p.add_argument("--out", default="overlay_grid.jpg")
    p.add_argument("--max-samples", type=int, default=9)
    args = parser.parse_args(argv)
    if args.cmd == "masks":
        reports = check_masks(args.images_dir, args.masks_dir)
        bad = 0
        for r in reports:
            status = "OK" if not r["issues"] else "; ".join(r["issues"])
            print(f"{r['name']}: shape {r['shape']} values {r['unique_values'][:6]} "
                  f"fg {r['foreground_ratio']:.1%} -> {status}")
            bad += bool(r["issues"])
        print(f"{len(reports)} masks, {bad} with issues")
    elif args.cmd == "overlay":
        out = make_overlay_grid(args.images_dir, args.masks_dir, args.out, args.max_samples)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
