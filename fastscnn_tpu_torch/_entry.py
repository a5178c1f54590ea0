"""Console-script shims, the counterparts of ``fastscnn_tpu/_entry.py``.

Each runs the port's entry point (its ``main``, or ``demo``) with the
process's arguments and returns 0. The mains return their primary
artifact (a checkpoint path, metrics, a pipeline object) so that tests in
one process can check it; a console script's ``sys.exit(fn())`` would turn
that into a nonzero exit code. The package installs no scripts of its own:
these are importable, as ``fastscnn_tpu_torch._entry.train`` and so on.
"""

from __future__ import annotations

import importlib

__all__ = ["train", "evaluate", "demo", "export_model", "pipeline", "dashboard"]


def _wrap(import_path: str):
    module_name, fn_name = import_path.rsplit(":", 1)

    def runner() -> int:
        getattr(importlib.import_module(module_name), fn_name)()
        return 0

    runner.__doc__ = f"``{import_path}()`` with the process's arguments; returns 0."
    return runner


train = _wrap("fastscnn_tpu_torch.train:main")
evaluate = _wrap("fastscnn_tpu_torch.eval:main")
demo = _wrap("fastscnn_tpu_torch.demo:demo")
export_model = _wrap("fastscnn_tpu_torch.export_model:main")
pipeline = _wrap("fastscnn_tpu_torch.pipeline:main")
dashboard = _wrap("fastscnn_tpu_torch.control_dashboard:main")
