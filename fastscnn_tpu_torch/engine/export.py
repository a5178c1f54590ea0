"""Model export for deployment: a ``torch.export`` artifact of the
end-to-end graph.

Counterpart of ``fastscnn_tpu/engine/export.py``, whose deploy artifact
is a serialized StableHLO program of the engine's end-to-end function.
Here the artifact is a ``torch.export`` program of the same function,
saved with ``torch.export.save`` as a ``.pt2`` file:

  uint8 NHWC → (× 1/255, resize to ``internal_size``, mean/std) → the
  BN-folded network → the mask (or softmax probabilities) at the input
  size,

exactly what :meth:`InferenceEngine.predict` computes for the engine's
config (reference:export_onnx_fixed.py:34-98, the ``EndToEndFastSCNN``
wrapper), in any configuration. The module exported holds the folded
weights, the normalisation constants and every resize table the graph
reads as buffers; what the program calls is aten operators and, where
the engine's path runs a hand-written kernel (:data:`KERNEL_OPTIONS`),
that kernel's operator ``fastscnn::<name>`` as one node
(``ops/cuda/library.py``), as the JAX artifact carries its Pallas kernels
as custom calls. An int8 configuration's weight fold is part of the
graph (aten operators), its activation scales constants.

Loading: a kernel-free artifact loads with bare ``torch.export.load``,
without this package. A kernel artifact needs the operators registered,
so it loads where ``fastscnn_tpu_torch`` is importable: :class:`ExportedModel`
(``load_exported``, ``load_artifact``) registers them first (this module
imports ``ops/cuda/library.py``; no kernel is built for that). On a CUDA
device the artifact launches the hand-written kernels, each built at its
first launch; moved to the CPU (``move_to_device_pass``) it runs their
plain versions, and moved to ``meta`` their fake implementations.

The TFLite and SavedModel exports of the JAX module need tensorflow and
are not ported; the ONNX route is :mod:`~fastscnn_tpu_torch.engine.onnx_native`.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from fastscnn_tpu_torch import resolve_device
from fastscnn_tpu_torch.ops.cuda import library  # noqa: F401  the kernels' operators, for loads
from fastscnn_tpu_torch.ops.resize import recording_tables, substituted_tables

__all__ = ["export_torch", "load_exported", "load_artifact", "ExportedModel", "E2EModule",
           "KERNEL_OPTIONS"]

#: the engine options whose path calls a kernel's operator (``fastscnn::<name>``)
KERNEL_OPTIONS = {
    "folded_dw_impl": ("pallas", "fused-ds", "fused-ds-mr"),
    "folded_pw_impl": ("int8-a8", "int8-w8a8"),
    "final_upsample": ("pallas", "hybrid-pallas"),
}


def _leaves(tree, prefix):
    """(buffer name, tensor) for every leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}__{k}")]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree) for x in _leaves(t, f"{prefix}__{i}")]
    return [(prefix, tree)]


def _names(tree, prefix):
    """``tree`` with each leaf replaced by its buffer name (:func:`_leaves`)."""
    if isinstance(tree, dict):
        return {k: _names(v, f"{prefix}__{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_names(t, f"{prefix}__{i}") for i, t in enumerate(tree)]
    return prefix


def _take(names, module):
    if isinstance(names, dict):
        return {k: _take(v, module) for k, v in names.items()}
    if isinstance(names, list):
        return [_take(v, module) for v in names]
    return getattr(module, names)


class E2EModule(torch.nn.Module):
    """The engine's ``predict`` for uint8 NHWC batches of ``shape`` as an
    ``nn.Module`` whose state is buffers: the engine's graph tensors
    (:meth:`InferenceEngine.graph_tensors`) and every resize table the
    graph reads at that shape (found by one eager pass here, which runs
    the kernels' operators too, so none is built lazily under
    ``torch.export``; the tables an operator looks up inside its
    implementation stay out). ``forward`` is the engine's own graph code,
    run on those buffers."""

    def __init__(self, engine, shape):
        super().__init__()
        self._engine = engine  # a plain attribute: the model's own weights stay out
        self.shape = tuple(int(d) for d in shape)
        g = engine.graph_tensors()
        self._g_names = _names(g, "g")
        for name, t in _leaves(g, "g"):
            self.register_buffer(name, t.detach().clone())
        record: dict = {}
        with torch.no_grad(), recording_tables(record):
            engine._predict_batch(torch.zeros(self.shape, dtype=torch.uint8, device=engine.device))
        self._tables = []
        for i, (key, table) in enumerate(record.items()):
            parts = table if isinstance(table, tuple) else (table,)
            names = tuple(f"table{i}_{j}" for j in range(len(parts)))
            for name, t in zip(names, parts):
                self.register_buffer(name, t.detach().clone())
            self._tables.append((key, names, isinstance(table, tuple)))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        tables = {}
        for key, names, is_tuple in self._tables:
            parts = tuple(getattr(self, n) for n in names)
            tables[key] = parts if is_tuple else parts[0]
        with substituted_tables(tables):
            return self._engine._predict_batch(images, _take(self._g_names, self))


def export_torch(engine, shape, path: str, metadata: dict | None = None) -> str:
    """Export ``engine``'s end-to-end function for uint8 NHWC batches of
    ``shape`` with ``torch.export.export`` on the engine's device, save it
    to ``path`` (``torch.export.save``) and write the JSON sidecar
    ``path + ".json"``: ``format`` ('torch-export'), ``inputs``,
    ``program_bytes``, the exporting ``torch_version`` and ``device``, and
    ``metadata``. Returns ``path``. An engine whose path calls a kernel
    (:data:`KERNEL_OPTIONS`) exports on the CPU or the card alike: the
    program holds the kernel's operator."""
    module = E2EModule(engine, shape).eval()
    example = torch.zeros(module.shape, dtype=torch.uint8, device=engine.device)
    with torch.no_grad():
        program = torch.export.export(module, (example,))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    meta = {
        "format": "torch-export",
        "inputs": [{"shape": list(module.shape), "dtype": "uint8"}],
        "program_bytes": os.path.getsize(path),
        "torch_version": torch.__version__,
        "device": str(engine.device),
    }
    if metadata:
        meta.update(metadata)
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    return path


class ExportedModel:
    """A loaded ``.pt2`` artifact of :func:`export_torch` on ``device``
    (None: the CUDA card); the kernels' operators are registered before
    the load (module import). A program exported on another device is
    moved with ``torch.export.passes.move_to_device_pass``. Calling it with a
    uint8 NHWC batch (numpy or tensor) of the exported shape returns what
    the engine's ``predict`` returns, on ``device``; ``infer(feeds)`` is
    the reference's ``InferSession`` duck-type (lists of numpy arrays)."""

    def __init__(self, path: str, device=None):
        self.device = resolve_device(device)
        self.metadata = {}
        if os.path.exists(path + ".json"):
            with open(path + ".json") as f:
                self.metadata = json.load(f)
        program = torch.export.load(path)
        exported_on = self.metadata.get("device")
        if exported_on is None or torch.device(exported_on) != self.device:
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, self.device)
        self.program = program
        self._module = program.module()
        (example,), _ = program.example_inputs
        self.shape = tuple(example.shape)

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        return self._module(images.to(self.device))

    def infer(self, feeds: list) -> list:
        return [self(feeds[0]).cpu().numpy()]


def load_exported(path: str, device=None) -> ExportedModel:
    return ExportedModel(path, device)


def load_artifact(path: str, device=None):
    """An exported artifact as a callable from uint8 NHWC batches of its
    input shape (``.shape``) to the engine's output: an ``.onnx`` file as
    :class:`~fastscnn_tpu_torch.engine.onnx_native.OnnxArtifact` (numpy,
    on the host; ``device`` unused), anything else as an
    :class:`ExportedModel` on ``device`` (None: the CUDA card)."""
    if path.endswith(".onnx"):
        from fastscnn_tpu_torch.engine.onnx_native import OnnxArtifact

        return OnnxArtifact(path)
    return ExportedModel(path, device)
