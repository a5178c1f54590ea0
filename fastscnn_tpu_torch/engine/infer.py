"""The serving engine: uint8 NHWC images → BN-folded Fast-SCNN → mask.

Counterpart of ``fastscnn_tpu/engine/infer.py``. The pipeline runs on the
engine's device: normalisation in the compute dtype, the folded network
(``FastSCNN.apply_folded``), then the ×8 bilinear upsample of the 1/8
logits (``align_corners=True``) and the argmax, in the formulation that
``E2EConfig.final_upsample`` names:

- ``'matmul'`` / ``'gather'``: interp-matmul / two-tap lerp upsample of the
  logits, then ``argmax``;
- ``'pallas'``: kernel B1, upsample and argmax fused, no full-resolution
  logits in device memory;
- ``'hybrid'``: W-first interp-matmul, H interp-matmul, ``argmax``;
- ``'hybrid-pallas'``: the same W-first matmul, then kernel B2 for the H
  pass and argmax.

The JAX mode names are kept so configurations map one to one. The
softmax and logits paths use the matmul (or, for ``'gather'``, the lerp)
upsample in every mode. ``'nbr-exact'`` and ``'argmax-first'`` are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fastscnn_tpu_torch import resolve_device
from fastscnn_tpu_torch.models.fast_scnn import FastSCNN, fold_inference_params
from fastscnn_tpu_torch.ops.cuda.upsample_argmax import upsample_argmax, w_matmul_h_lerp_argmax
from fastscnn_tpu_torch.ops.resize import resize_bilinear, resize_bilinear_matmul, resize_nearest

__all__ = ["InferenceEngine", "E2EConfig", "IMAGENET_MEAN", "IMAGENET_STD", "FINAL_UPSAMPLE_MODES"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

FINAL_UPSAMPLE_MODES = ("matmul", "gather", "pallas", "hybrid", "hybrid-pallas")
_NOT_PORTED_MODES = ("nbr-exact", "argmax-first")


@dataclasses.dataclass(frozen=True)
class E2EConfig:
    """End-to-end graph options; the fields and defaults of the JAX
    package's ``E2EConfig``.

    ``internal_size``: the resolution the backbone runs at (None: the
    input's). ``mean``/``std``: per-channel normalisation after /255
    (None: raw [0, 1]). ``softmax``: return class probabilities at the
    input size instead of a mask. ``final_upsample``: the mask head's
    formulation (see the module docstring). ``mask_dtype``: dtype of the
    returned mask ('int32' or 'uint8')."""

    internal_size: tuple[int, int] | None = None
    mean: tuple[float, ...] | None = None
    std: tuple[float, ...] | None = None
    softmax: bool = False
    compute_dtype: str = "bfloat16"
    final_upsample: str = "hybrid"
    mask_dtype: str = "int32"


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class InferenceEngine:
    """Fast-SCNN serving engine on BN-folded weights.

    Usage::

        model = init_fast_scnn(19, generator=torch.Generator().manual_seed(0))
        engine = InferenceEngine(model, config=E2EConfig(mean=IMAGENET_MEAN, std=IMAGENET_STD))
        mask = engine.predict(uint8_images)      # (N, H, W) on the engine's device

    ``device=None`` means the CUDA card (raises when there is none). The
    engine folds the model's weights once, into ``config.compute_dtype``.
    An engine over :func:`~fastscnn_tpu_torch.models.quantized_model`'s
    model is the int8 serving path (calibrate its scales on the 'conv'
    model with :func:`~fastscnn_tpu_torch.models.calibrate_pw_scales`).
    ``infer([nchw])`` is the reference's ``InferSession`` duck-type.
    """

    def __init__(self, model: FastSCNN, device=None, config: E2EConfig = E2EConfig()):
        if config.final_upsample in _NOT_PORTED_MODES:
            raise NotImplementedError(
                f"final_upsample={config.final_upsample!r} is not ported yet "
                "(ROADMAP.md, queue item 'nbr-exact and argmax-first')"
            )
        if config.final_upsample not in FINAL_UPSAMPLE_MODES:
            raise ValueError(f"unknown final_upsample {config.final_upsample!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.config = config
        self._dtype = _torch_dtype(config.compute_dtype)
        self._mask_dtype = _torch_dtype(config.mask_dtype)
        self.folded = fold_inference_params(self.model, self._dtype)
        if config.mean is not None:
            std = config.std if config.std is not None else (1.0,) * 3
            self._mean = torch.tensor(config.mean, dtype=self._dtype, device=self.device)
            self._std = torch.tensor(std, dtype=self._dtype, device=self.device)
        self._inv255 = torch.tensor(1.0 / 255.0, dtype=self._dtype, device=self.device)

    # -- graph pieces -------------------------------------------------------
    def _preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """uint8/float NHWC [0, 255] → normalised NHWC in the compute dtype,
        with the JAX rounding order: cast, × (1/255), then (x − mean) / std."""
        x = images.to(self._dtype) * self._inv255
        if self.config.internal_size is not None:
            x = resize_bilinear(x, self.config.internal_size, align_corners=False)
        if self.config.mean is not None:
            x = (x - self._mean) / self._std
        return x

    def _net_in_size(self, shape):
        return tuple(self.config.internal_size or shape[1:3])

    def _forward(self, images, resize_back=False, upsample=True):
        x = self._preprocess(images)
        logits = self.model.apply_folded(self.folded, x, upsample_outputs=False)[0]
        if upsample and logits.shape[1:3] != x.shape[1:3]:
            up = resize_bilinear if self.config.final_upsample == "gather" else resize_bilinear_matmul
            logits = up(logits, (x.shape[1], x.shape[2]), align_corners=True)
        if resize_back and logits.shape[1:3] != images.shape[1:3]:
            logits = resize_bilinear(
                logits, (images.shape[1], images.shape[2]), align_corners=False
            )
        return logits

    def _mask_at_net_res(self, images):
        mode = self.config.final_upsample
        size = self._net_in_size(images.shape)
        if mode == "pallas":
            logits = self._forward(images, upsample=False).contiguous()
            return upsample_argmax(logits, size, align_corners=True)
        if mode in ("hybrid", "hybrid-pallas"):
            return w_matmul_h_lerp_argmax(
                self._forward(images, upsample=False), size, align_corners=True,
                use_kernel=mode == "hybrid-pallas", out_dtype=self._mask_dtype,
            )
        return self._forward(images).argmax(dim=-1).to(torch.int32)

    def _as_input(self, images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        return images.to(self.device)

    # -- public API ---------------------------------------------------------
    @torch.inference_mode()
    def predict(self, images) -> torch.Tensor:
        """uint8 NHWC batch (numpy or tensor) → (N, H, W) mask in
        ``mask_dtype`` (or (N, H, W, C) f32 softmax probabilities when
        ``config.softmax``), on the engine's device."""
        images = self._as_input(images)
        squeeze = images.ndim == 3
        if squeeze:
            images = images[None]
        out_size = tuple(images.shape[1:3])
        if self.config.softmax:
            probs = torch.softmax(self._forward(images).float(), dim=-1)
            if tuple(probs.shape[1:3]) != out_size:
                probs = resize_bilinear(probs, out_size, align_corners=False)
            out = probs
        else:
            mask = self._mask_at_net_res(images)
            if tuple(mask.shape[1:3]) != out_size:
                mask = resize_nearest(mask, out_size)
            out = mask.to(self._mask_dtype)
        return out[0] if squeeze else out

    @torch.inference_mode()
    def logits(self, images) -> torch.Tensor:
        """Logits at the INPUT resolution (resized back when an internal
        backbone resolution is configured) — the ``.infer()`` seam."""
        return self._forward(self._as_input(images), resize_back=True)

    def infer(self, feeds: list) -> list:
        """[NCHW float array in [0, 255]] → [NCHW logits as numpy] — the
        reference's ``InferSession.infer`` duck-type."""
        x = np.asarray(feeds[0])
        logits = self.logits(np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1))))
        return [logits.float().permute(0, 3, 1, 2).cpu().numpy()]
