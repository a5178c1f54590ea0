"""The realtime loop and its web dashboard (the JAX package's ``interfaces``)."""

from fastscnn_tpu_torch.interfaces.realtime import FrameSource, RealtimePipeline, SyntheticCamera
from fastscnn_tpu_torch.interfaces.web_interface import DashboardServer

__all__ = ["RealtimePipeline", "FrameSource", "SyntheticCamera", "DashboardServer"]
