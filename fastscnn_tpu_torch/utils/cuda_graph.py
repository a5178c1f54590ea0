"""One CUDA graph capture with the port's bookkeeping.

Shared by the graphed train steps (``parallel/train.py``) and the eval
bench's device loop (``bench_eval.py``): the caller warms its body up on
``stream`` first (every lazy allocation, cuDNN plan and device table made
there), then :func:`capture` records one pass into the memory ``pool``.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Any, Callable

import torch

from fastscnn_tpu_torch.ops.cuda import launch_counts
from fastscnn_tpu_torch.ops.resize import holding_tables

__all__ = ["Captured", "capture"]


@dataclasses.dataclass
class Captured:
    """A captured graph and what its capture recorded: ``out`` (the body's
    return value, tensors in the graph's pool that every replay rewrites),
    ``launches`` (the kernel wrappers' launches during the capture, which a
    replay repeats without passing through the wrappers), ``pool_bytes``
    (the device memory the capture reserved) and ``tables`` (the device
    tables the body read, held for as long as the graph lives)."""

    graph: Any
    out: Any
    launches: dict
    pool_bytes: int
    tables: list
    replays: int = 0

    def replay(self):
        self.graph.replay()
        self.replays += 1
        return self.out


def capture(body: Callable, device: torch.device, pool, stream: torch.cuda.Stream,
            generators=()) -> Captured:
    """``body()`` captured into ``pool`` on ``stream``, each device
    generator of ``generators`` registered with the graph (its replays then
    draw from the generator's current offset and advance it, as eager calls
    would). A failed capture raises ``ValueError``."""
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved, before = torch.cuda.memory_reserved(device), launch_counts()
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    tables: list = []
    try:
        with holding_tables(tables), torch.cuda.graph(graph, pool=pool, stream=stream):
            out = body()
    except Exception as e:  # torch raises several types for what cannot be captured
        raise ValueError(f"CUDA graph capture failed: {type(e).__name__}: {e}") from e
    after = launch_counts()
    return Captured(graph, out, {k: after[k] - before[k] for k in after if after[k] != before[k]},
                    torch.cuda.memory_reserved(device) - reserved, tables)
