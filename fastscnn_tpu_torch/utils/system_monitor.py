"""Host and card resource sampling for the serving server's ``/stats``.

The port's own copy of ``fastscnn_tpu/utils/system_monitor.py``: the host
side is the same (psutil when installed, else ``/proc``); the card side
asks PyTorch's CUDA runtime instead of JAX's PJRT client. Sampling is on
demand, per HTTP request.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["host_stats", "device_stats"]

_lock = threading.Lock()
_prev_cpu: tuple[float, float] | None = None  # (busy, total) jiffy totals


def _proc_cpu_sample() -> tuple[float, float] | None:
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()[1:]
        vals = [float(v) for v in fields]
        idle = vals[3] + (vals[4] if len(vals) > 4 else 0.0)  # idle + iowait
        total = sum(vals)
        return total - idle, total
    except (OSError, ValueError, IndexError):
        return None


def _proc_meminfo() -> dict | None:
    try:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                key, _, rest = line.partition(":")
                info[key] = float(rest.split()[0])  # kB
        total = info["MemTotal"]
        avail = info.get("MemAvailable", info.get("MemFree", 0.0))
        return {
            "mem_percent": round(100.0 * (1.0 - avail / total), 1),
            "mem_total_mb": round(total / 1024.0, 1),
            "mem_available_mb": round(avail / 1024.0, 1),
        }
    except (OSError, ValueError, KeyError):
        return None


def host_stats() -> dict:
    """CPU %, memory % / MB.  psutil when installed; /proc fallback.

    The CPU percentage is a delta since the previous call (psutil's
    ``interval=None`` semantics) — the first call reports 0.0.
    """
    try:
        import psutil

        vm = psutil.virtual_memory()
        return {
            "cpu_percent": psutil.cpu_percent(interval=None),
            "mem_percent": vm.percent,
            "mem_total_mb": round(vm.total / 2**20, 1),
            "mem_available_mb": round(vm.available / 2**20, 1),
        }
    except Exception:
        pass
    out: dict = {"cpu_percent": 0.0}
    global _prev_cpu
    sample = _proc_cpu_sample()
    if sample is not None:
        with _lock:
            if _prev_cpu is not None:
                dbusy = sample[0] - _prev_cpu[0]
                dtotal = sample[1] - _prev_cpu[1]
                if dtotal > 0:
                    out["cpu_percent"] = round(100.0 * dbusy / dtotal, 1)
            _prev_cpu = sample
    mem = _proc_meminfo()
    if mem is not None:
        out.update(mem)
    return out


def device_stats() -> dict:
    """The card's identity and memory: ``{"platform": "gpu", ...}`` once
    this process has initialised CUDA, else ``{"platform": "cpu"}`` (a
    stats poll never initialises CUDA itself)."""
    if not torch.cuda.is_initialized():
        return {"platform": "cpu"}
    dev = torch.cuda.current_device()
    limit = torch.cuda.get_device_properties(dev).total_memory
    in_use = torch.cuda.memory_allocated(dev)
    return {
        "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(dev),
        "device_count": torch.cuda.device_count(),
        "bytes_in_use": in_use,
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
        "bytes_reserved": torch.cuda.memory_reserved(dev),
        "bytes_limit": limit,
        "mem_percent": round(100.0 * in_use / limit, 1),
    }
