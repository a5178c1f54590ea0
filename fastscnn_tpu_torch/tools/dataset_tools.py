"""Dataset preparation utilities: counterpart of
``fastscnn_tpu/tools/dataset_tools.py``.

- ``augment_dataset`` — horizontal-flip dataset doubling
  (reference:augment_data.py:1-165)
- ``convert_lane_to_drivable_mask`` — lane-line masks → filled
  between-lines drivable masks via a dilation + per-row fill
  (reference:convert_lane_to_drivable.py:1-201)
- ``dedupe_images`` — MD5 content dedup of collected images
  (reference:fix_image_duplication.py:1-438)

Each has a function core and a CLI (``python -m
fastscnn_tpu_torch.tools.dataset_tools <command> ...``). No PIL and no
OpenCV: PNG and JPEG images are read with ``data/image_io.py`` and
written back in their own format by ``image_io`` (a JPEG through the
port's codec, in Pillow's bytes at its default quality),
flips are ``data/pil_ops.flip_lr``, and the dilation is always the JAX
function's no-OpenCV branch, a 4-neighbour cross (where OpenCV imports,
the JAX function dilates with a 3×3 box instead; ROADMAP.md, queue 3,
not-fault 14).
"""

from __future__ import annotations

import argparse
import hashlib
import os

import numpy as np

from fastscnn_tpu_torch.data import image_io, pil_ops

__all__ = ["augment_dataset", "convert_lane_to_drivable_mask", "dedupe_images"]


def _flip_file(src: str, dst: str) -> None:
    """``Image.open(src).transpose(FLIP_LEFT_RIGHT).save(dst)``: the same
    pixels in the same mode (a palette PNG keeps its palette)."""
    arr, mode = image_io.decode(src)
    flipped = pil_ops.flip_lr(arr)
    if mode == "P" and dst.lower().endswith(".png"):
        image_io.write_png(dst, flipped, palette=image_io.read_palette(src))
    else:
        image_io.save_image(dst, flipped)


def augment_dataset(images_dir: str, masks_dir: str, suffix: str = "_flipped") -> int:
    """Add a horizontally flipped copy of every image/mask pair. Returns the
    number of new pairs created."""
    created = 0
    for filename in sorted(os.listdir(images_dir)):
        base, ext = os.path.splitext(filename)
        if ext.lower() not in (".jpg", ".jpeg", ".png") or base.endswith(suffix):
            continue
        mask_path = os.path.join(masks_dir, base + ".png")
        if not os.path.exists(mask_path):
            continue
        out_img = os.path.join(images_dir, base + suffix + ext)
        out_mask = os.path.join(masks_dir, base + suffix + ".png")
        if os.path.exists(out_img):
            continue
        _flip_file(os.path.join(images_dir, filename), out_img)
        _flip_file(mask_path, out_mask)
        created += 1
    return created


def convert_lane_to_drivable_mask(
    lane_mask: np.ndarray, dilate_iterations: int = 2, min_lane_pixels: int = 2
) -> np.ndarray:
    """Lane-line mask (thin lines) → filled drivable-area mask.

    Per row: find the leftmost and rightmost lane pixels (after a dilation
    to bridge gaps) and fill between them — the reference's morphology +
    row-fill strategy (reference:convert_lane_to_drivable.py:1-31). Each
    dilation step ORs every pixel with its 4 neighbours.
    """
    binary = (lane_mask > 0).astype(np.uint8)
    for _ in range(max(dilate_iterations, 0)):
        padded = np.pad(binary, 1)
        binary = (
            padded[:-2, 1:-1] | padded[2:, 1:-1] | padded[1:-1, :-2]
            | padded[1:-1, 2:] | padded[1:-1, 1:-1]
        ).astype(np.uint8)
    out = np.zeros_like(binary)
    for y in range(binary.shape[0]):
        xs = np.flatnonzero(binary[y])
        if len(xs) >= min_lane_pixels:
            out[y, xs[0] : xs[-1] + 1] = 1
    return (out * 255).astype(np.uint8)


def dedupe_images(directory: str, delete: bool = False) -> dict:
    """MD5-based duplicate detection; optionally delete later copies.

    Returns {kept_path: [duplicate_paths...]}.
    """
    seen: dict[str, str] = {}
    duplicates: dict[str, list[str]] = {}
    for filename in sorted(os.listdir(directory)):
        path = os.path.join(directory, filename)
        if not os.path.isfile(path):
            continue
        with open(path, "rb") as f:
            digest = hashlib.md5(f.read()).hexdigest()
        if digest in seen:
            duplicates.setdefault(seen[digest], []).append(path)
            if delete:
                os.remove(path)
        else:
            seen[digest] = path
    return duplicates


def main(argv=None):
    parser = argparse.ArgumentParser(description="dataset tools")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("augment", help="horizontal-flip dataset doubling")
    p.add_argument("--images", required=True)
    p.add_argument("--masks", required=True)

    p = sub.add_parser("lane2drivable", help="lane masks -> drivable masks")
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--dilate", type=int, default=2)

    p = sub.add_parser("dedupe", help="MD5 image dedup")
    p.add_argument("--dir", required=True)
    p.add_argument("--delete", action="store_true")

    args = parser.parse_args(argv)
    if args.cmd == "augment":
        n = augment_dataset(args.images, args.masks)
        print(f"created {n} flipped pairs")
    elif args.cmd == "lane2drivable":
        os.makedirs(args.output_dir, exist_ok=True)
        n = 0
        for f in sorted(os.listdir(args.input_dir)):
            if not f.lower().endswith(".png"):
                continue
            mask = image_io.read_image(os.path.join(args.input_dir, f), "L")
            out = convert_lane_to_drivable_mask(mask, dilate_iterations=args.dilate)
            image_io.write_png(os.path.join(args.output_dir, f), out)
            n += 1
        print(f"converted {n} masks")
    elif args.cmd == "dedupe":
        dups = dedupe_images(args.dir, delete=args.delete)
        total = sum(len(v) for v in dups.values())
        print(f"found {total} duplicates of {len(dups)} originals"
              + (" (deleted)" if args.delete else ""))


if __name__ == "__main__":
    main()
