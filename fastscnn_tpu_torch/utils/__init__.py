"""Utilities of the port. The names below load their modules at first
use (PEP 562), so that importing a light submodule such as
``utils.native`` (the host C++ build, which the data loader's worker
processes reach through the JPEG codec) does not import ``torch``."""

import importlib

_EXPORTS = {
    "LRScheduler": "lr_scheduler",
    "lr_schedule": "lr_scheduler",
    "SegmentationMetric": "metric",
    "seg_hist_update": "metric",
    "seg_scores_from_hist": "metric",
    "get_color_pallete": "visualize",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        value = getattr(module, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
