"""Preset trainer entry points: the reference's wrapper scripts.

Counterpart of ``fastscnn_tpu/train_presets.py``: each preset runs the
port's trainer with the flags of one reference script, the user's flags
after them (so they override):

- tusimple        (reference:train_tusimple.py:15-30: base 512, crop 480,
                   bs 16, dice, aux)
- bdd100k         (reference:train_bdd100k.py: AdamW, 80 epochs, bs 8,
                   lr 1e-3, sample-ratio 0.1, binary drivable)
- custom_scratch  (reference:train_custom_scratch.py:19-38: 200 epochs,
                   wd 1e-5 for a deliberate overfit)
- custom_finetune (reference:train_custom_finetune.py: resume from a
                   BDD100K checkpoint by the shape-filtered partial load,
                   lr 1e-4, CE loss)

Usage::

    python -m fastscnn_tpu_torch.train_presets tusimple [extra train.py flags]
    python -m fastscnn_tpu_torch.train_presets custom_finetune \\
        --resume weights/fast_scnn_bdd100k.pth
"""

from __future__ import annotations

import sys

__all__ = ["PRESETS", "main"]

PRESETS = {
    "tusimple": [
        "--dataset", "tusimple",
        "--base-size", "512",
        "--crop-size", "480",
        "--batch-size", "16",
        "--loss-type", "dice",
        "--aux",
        "--epochs", "100",
    ],
    "bdd100k": [
        "--dataset", "bdd100k",
        "--optimizer", "adamw",
        "--epochs", "80",
        "--batch-size", "8",
        "--lr", "1e-3",
        "--sample-ratio", "0.1",
        "--label-type", "binary",
        "--base-size", "640",
        "--crop-size", "480",
        "--loss-type", "dice",
        "--aux",
    ],
    "custom_scratch": [
        "--dataset", "custom",
        "--epochs", "200",
        "--weight-decay", "1e-5",
        "--loss-type", "dice",
        "--aux",
        "--base-size", "640",
        "--crop-size", "480",
    ],
    "custom_finetune": [
        "--dataset", "custom",
        "--lr", "1e-4",
        "--loss-type", "ce_plain",
        "--epochs", "50",
        "--base-size", "640",
        "--crop-size", "480",
    ],
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in PRESETS:
        raise SystemExit(
            f"usage: python -m fastscnn_tpu_torch.train_presets {{{'|'.join(PRESETS)}}} [flags]")
    preset = argv.pop(0)
    from fastscnn_tpu_torch.train import main as train_main

    return train_main(PRESETS[preset] + argv)


if __name__ == "__main__":
    main()
