"""Timing and tracing: counterpart of ``fastscnn_tpu/utils/profiling.py``.

- ``PerfTimer``, the port's own copy: every pipeline stage records its
  host time; the report prints per-stage ms, the percentage breakdown and
  the frame rate the total implies. A stage that reads a device result
  back includes the wait for the device.
- :func:`device_trace`: a ``torch.profiler`` trace of a block, written as
  Chrome-trace JSON that ``tools/xplane.py`` tabulates by device kernel.
- :func:`enable_compilation_cache`: the port's persistent compile cache,
  the directory the hand-written kernels are built into and reused from
  (``ops/cuda/_build.py``), namespaced by the host CPU.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

__all__ = ["PerfTimer", "enable_compilation_cache", "device_trace", "warm_profile",
           "device_kernels", "LEAD_IN_KERNELS", "TRACE_SUFFIX"]

TRACE_SUFFIX = ".pt.trace.json"


class PerfTimer:
    def __init__(self):
        self.times: dict[str, float] = {}
        self._order: list[str] = []

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self.times[name] = self.times.get(name, 0.0) + seconds
        if name not in self._order:
            self._order.append(name)

    @property
    def total(self) -> float:
        return sum(self.times.values())

    def report(self, title: str = "Performance analysis") -> str:
        total = self.total
        lines = [f"=== {title} ==="]
        for name in self._order:
            t = self.times[name]
            pct = 100.0 * t / total if total > 0 else 0.0
            lines.append(f"  {name:<24s} {t * 1e3:8.1f} ms  ({pct:5.1f}%)")
        lines.append(f"  {'TOTAL':<24s} {total * 1e3:8.1f} ms")
        if total > 0:
            lines.append(f"  theoretical FPS: {1.0 / total:.1f}")
        return "\n".join(lines)

    def print_performance_analysis(self, title: str = "Performance analysis"):
        print(self.report(title))


_CACHE_ENABLED: list = []


def _host_fingerprint() -> str:
    """12 hex digits of the SHA-1 of the machine name and the CPU's
    feature flags (``/proc/cpuinfo``), or the machine name where that file
    cannot be read — the JAX package's namespacing of its cache."""
    import hashlib
    import platform

    try:
        flags = ""
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
        return hashlib.sha1((platform.machine() + flags).encode()).hexdigest()[:12]
    except OSError:
        return platform.machine() or "unknown-host"


def enable_compilation_cache(path: str | None = None) -> str | None:
    """Turn on the persistent compile cache (idempotent): returns its
    directory, or None when ``FASTSCNN_NO_COMPILATION_CACHE`` is set truthy
    or the directory cannot be made.

    The port compiles no graphs ahead of time; what it compiles and keeps
    across processes is its kernels: ``ops/cuda/_build.py`` builds each
    ``csrc/*.cu`` with ``nvcc`` into a library named by the hash of its
    sources and flags, and every later process loads it from there. This
    function points that build at ``<path>/<host>`` (``path`` defaults to
    the build's own directory, ``build/fastscnn_tpu_torch`` under the
    checkout, which git ignores); ``<host>`` is a fingerprint of the host
    CPU, as in the JAX function, since a library's host code is compiled
    on and for the build machine. Call it before the first kernel launch:
    a library already loaded stays loaded from where it was built. The
    first call decides; later calls return its directory."""
    import os

    from fastscnn_tpu_torch.ops.cuda import _build

    if _CACHE_ENABLED:
        return _CACHE_ENABLED[0]
    if os.environ.get("FASTSCNN_NO_COMPILATION_CACHE", "").lower() not in (
        "", "0", "false", "no",
    ):
        return None
    path = os.path.join(str(path or _build.BUILD_DIR), _host_fingerprint())
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return None
    _build.set_build_dir(path)
    _CACHE_ENABLED.append(path)
    return path


# kernels launched in the trace's warm-up step (see device_trace)
LEAD_IN_KERNELS = 1024


@contextmanager
def warm_profile(on_trace_ready=None):
    """``torch.profiler`` over everything run inside the block, opened with
    a warm-up step whose records are discarded: with CUDA it launches
    ``LEAD_IN_KERNELS`` one-element kernels. In a process that has run for
    a while, the first kernel records after the profiler starts go
    missing, more of them the older the process (``chip_smoke.py`` phase
    11a counts them for a session without the warm-up); the warm-up
    absorbs them, so every kernel of the block is recorded, and none of
    the lead-in's. Yields the profiler: after the block (whose device work
    is waited for), its ``key_averages()`` hold the block's records, and
    ``on_trace_ready`` has been called with it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=on_trace_ready) as prof:
        if cuda:
            one = torch.zeros(1, device="cuda")
            for _ in range(LEAD_IN_KERNELS):
                one.add_(1)
            torch.cuda.synchronize()
        prof.step()  # the warm-up ends: the block is recorded
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()


def device_kernels(prof) -> list:
    """The device kernels among ``prof.key_averages()``: the rows with
    device time, but the step annotation ``ProfilerStep*`` that
    :func:`warm_profile`'s schedule adds, which the profiler reports as a
    device range spanning the whole block."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]


@contextmanager
def device_trace(outdir: str):
    """Trace everything run inside the block with ``torch.profiler``: the
    host's operators, and the card's kernels, copies and sets where CUDA
    is available (the block's device work is waited for before the trace
    stops). Writes one Chrome-trace JSON,
    ``<outdir>/<host>.<pid>.<ns>.pt.trace.json``, which
    ``tools/xplane.py`` finds (view it in Perfetto or chrome://tracing) —
    the counterpart of the JAX package's ``jax.profiler`` XPlane trace.
    The trace opens with :func:`warm_profile`'s warm-up step, so every
    kernel of the block is in it, and none of the lead-in's."""
    import os
    import socket

    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}"
                                f"{TRACE_SUFFIX}")
    with warm_profile(on_trace_ready=lambda prof: prof.export_chrome_trace(path)):
        yield