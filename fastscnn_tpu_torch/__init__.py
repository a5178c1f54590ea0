"""Fast-SCNN serving and training in PyTorch on an NVIDIA Hopper card.

A port of ``fastscnn_tpu`` (JAX/Pallas on a TPU): the same model, the
same BN-folded inference graph and mask heads (``engine``), its int8
serving configuration (``models/quantize.py``), and the same
training step — train-mode forward, losses, LR schedules, metric,
SGD/AdamW (``models``, ``losses``, ``utils``, ``parallel``) — with the
TPU's Pallas kernels replaced by CUDA C++ kernels built for ``sm_90a``
(``csrc/``, bound by ``ops/cuda``).

Package rules:

- imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of
  ``fastscnn_tpu``; what it needs from there it keeps as its own copy;
- public functions keep the JAX package's layouts: NHWC activations,
  HWIO weights in parameter trees, (N, H, W) masks;
- every entry point takes a ``device``; ``None`` means the CUDA card and
  raises when there is none (no silent CPU fallback). Tests pass
  ``device="cpu"``, where every kernel wrapper runs its plain PyTorch
  version.

This module imports ``torch`` only inside its functions, so that the data
loader's worker processes, which import ``data/`` alone, start without it.
"""

from __future__ import annotations

__all__ = ["resolve_device", "f32_precision"]


def f32_precision() -> None:
    """Turn TF32 off for cuDNN convolutions and CUDA matmuls.

    The single place the port sets these flags. cuDNN defaults to TF32
    on Hopper, which keeps ~3 decimal digits of an f32 convolution — the
    GPU form of the bf16 truncation that ``fastscnn_tpu``'s
    ``ops/conv.py::f32_precision`` works around on the TPU. bf16 work is
    unaffected (it never used TF32).
    """
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Raises when ``device`` is None and CUDA is absent: the port never
    falls back to the CPU on its own. Also applies :func:`f32_precision`,
    so every entry point that resolves a device runs without TF32.
    """
    import torch

    f32_precision()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
