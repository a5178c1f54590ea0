#!/usr/bin/env python
"""Mask parity across ``folded_dw_impl`` variants on the card, in bf16.

    python -m fastscnn_tpu_torch.tools.check_dw_impls [--height 512
        --width 1024 --batch 8 --classes 19] [--device cpu]

The port of the repo root's ``tools/check_dw_impls.py``, with the same
flags plus ``--device`` (default: the CUDA card; raises without one). One
bf16 ``InferenceEngine`` (``E2EConfig(compute_dtype="bfloat16")``, the
other fields at their defaults) per impl of ``conv``, ``taps``,
``pallas`` (kernel B4), ``fused-ds`` (B3) and ``fused-ds-mr`` (B5), all on
the same weights, predicts the same seeded uint8 batch; each impl's mask
is compared with ``conv``'s and the share of pixels that differ printed,
``[OK]`` below 5e-3 and ``[SUSPECT]`` at or above it. Like the JAX tool it
reports and does not assert: at bf16 a near-tie can rightly flip a pixel.

Weights come from ``init_fast_scnn(classes, generator=
torch.Generator().manual_seed(0))``: PyTorch cannot replay JAX's
``PRNGKey(0)``, so the port's weights are its own seeded draw (the tests
carry JAX's over through ``models.convert.from_jax_params``). The input is
the JAX tool's, ``np.random.default_rng(0)``'s uint8 batch.
"""

from __future__ import annotations

import argparse

import numpy as np

DW_IMPLS = ("conv", "taps", "pallas", "fused-ds", "fused-ds-mr")
SUSPECT = 5e-3  # share of differing pixels from which a line reads SUSPECT


def impl_masks(model, x, device=None, impls=DW_IMPLS, compute_dtype="bfloat16") -> dict:
    """``{impl: (N, H, W) mask as numpy}``: ``x`` (uint8 NHWC, numpy)
    through one engine in ``compute_dtype`` a ``folded_dw_impl`` of
    ``impls``, each on ``model``'s weights (a ``FastSCNN``;
    ``with_options`` shares them)."""
    from fastscnn_tpu_torch.engine import E2EConfig, InferenceEngine

    masks = {}
    for impl in impls:
        eng = InferenceEngine(model.with_options(folded_dw_impl=impl), device=device,
                              config=E2EConfig(compute_dtype=compute_dtype))
        masks[impl] = eng.predict(x).cpu().numpy()
    return masks


def report(masks) -> list[str]:
    """The JAX tool's line for each impl but ``conv``: its share of pixels
    that differ from ``conv``'s mask and OK or SUSPECT."""
    lines = []
    for impl, mask in masks.items():
        if impl != "conv":
            diff = float((mask != masks["conv"]).mean())
            status = "OK" if diff < SUSPECT else "SUSPECT"
            lines.append(f"{impl:12s} vs conv: pixel diff {diff:.3e}  [{status}]")
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--classes", type=int, default=19)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)

    import torch

    from fastscnn_tpu_torch import resolve_device
    from fastscnn_tpu_torch.models import init_fast_scnn

    device = resolve_device(args.device)
    model = init_fast_scnn(args.classes, generator=torch.Generator().manual_seed(0),
                           device=device)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (args.batch, args.height, args.width, 3), dtype=np.uint8)
    masks = impl_masks(model, x, device)
    for line in report(masks):
        print(line, flush=True)
    print("done")
    return masks


if __name__ == "__main__":
    main()
