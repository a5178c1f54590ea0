"""The lateral-error wheel-PWM controller (the JAX package's ``control``)."""

from fastscnn_tpu_torch.control.visual_controller import VisualLateralErrorController

__all__ = ["VisualLateralErrorController"]
