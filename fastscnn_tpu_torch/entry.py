"""``entry()``: the port's single-card serving step on the flagship model.

The analogue of the repo root's ``__graft_entry__.entry()``: the 19-class
Fast-SCNN (Cityscapes), random weights from a fixed seed, the bf16
end-to-end graph uint8 → normalise → network → argmax mask — here in the
kernel configuration, ``folded_dw_impl='fused-ds'`` (kernel B3) and
``final_upsample='pallas'`` (kernel B1).
"""

from __future__ import annotations

import torch

from fastscnn_tpu_torch import resolve_device
from fastscnn_tpu_torch.engine import IMAGENET_MEAN, IMAGENET_STD, E2EConfig, InferenceEngine
from fastscnn_tpu_torch.models import init_fast_scnn

__all__ = ["entry", "NUM_CLASSES", "SHAPE"]

NUM_CLASSES = 19
SHAPE = (1, 1024, 2048, 3)


def entry(device=None):
    """Returns ``(fn, (example,))``: ``fn`` maps a (1, 1024, 2048, 3)
    uint8 tensor on ``device`` (None: the CUDA card) to its (1, 1024,
    2048) int32 mask; ``example`` is such a tensor of zeros."""
    device = resolve_device(device)
    model = init_fast_scnn(
        NUM_CLASSES, generator=torch.Generator().manual_seed(0), device=device,
        folded_dw_impl="fused-ds",
    )
    engine = InferenceEngine(
        model, device=device,
        config=E2EConfig(mean=IMAGENET_MEAN, std=IMAGENET_STD, compute_dtype="bfloat16",
                         final_upsample="pallas"),
    )
    return engine.predict, (torch.zeros(SHAPE, dtype=torch.uint8, device=device),)
