"""Decode-once image cache for the input pipeline.

Counterpart of ``fastscnn_tpu/data/decoded_cache.py``, returning numpy
arrays where the JAX package returns PIL images:

- the first open of a path decodes it (:func:`~fastscnn_tpu_torch.data.image_io.read_image`)
  and writes the array as one ``.npy`` under the cache directory, keyed
  by the path's digest, mtime and size and the ``convert`` mode, so a
  stale entry decodes again;
- later opens copy the array out of a memory map of that ``.npy``: a
  memcpy in place of an inflate and unfilter pass, or of a JPEG decode.

The entry names, their content and the atomic write are the JAX
package's, so an entry written by either package is a hit for the other.
Off by default: enable it with :func:`set_cache_dir`, the
``FASTSCNN_DECODED_CACHE`` environment variable or the trainer's
``--decoded-cache`` flag. Thread-safe: loader workers that race to write
one entry each write a temporary file and ``os.replace`` it.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import threading

import numpy as np

from fastscnn_tpu_torch.data import image_io

__all__ = ["set_cache_dir", "get_cache_dir", "open_image", "open_rgb", "stats", "add_stats"]

_lock = threading.Lock()
_cache_dir: str | None = os.environ.get("FASTSCNN_DECODED_CACHE") or None
_hits = 0
_misses = 0

# modes whose array the JAX package caches ('P' as its palette indices)
_ARRAY_MODES = {"L", "P", "I", "RGB", "RGBA"}


def set_cache_dir(path: str | None) -> None:
    """Enable (or disable with None) the decoded cache for this process."""
    global _cache_dir
    _cache_dir = path
    if path:
        os.makedirs(path, exist_ok=True)


def get_cache_dir() -> str | None:
    return _cache_dir


def stats() -> dict:
    return {"hits": _hits, "misses": _misses, "dir": _cache_dir}


def add_stats(hits: int, misses: int) -> None:
    """Add another process's hits and misses (a loader worker's) to this
    process's counts."""
    global _hits, _misses
    with _lock:
        _hits += hits
        _misses += misses


def _entry_path(path: str, mode: str | None) -> str:
    st = os.stat(path)
    key = f"{os.path.abspath(path)}|{st.st_mtime_ns}|{st.st_size}|{mode}"
    digest = hashlib.sha1(key.encode()).hexdigest()[:20]
    base = os.path.splitext(os.path.basename(path))[0][:40]
    return os.path.join(_cache_dir, f"{base}.{digest}.npy")


def open_image(path: str, convert: str | None = None) -> np.ndarray:
    """:func:`~fastscnn_tpu_torch.data.image_io.read_image` through the
    decoded cache (a plain decode while the cache is off)."""
    global _hits, _misses
    if _cache_dir is None:
        return image_io.read_image(path, convert)
    entry = _entry_path(path, convert)
    if os.path.exists(entry):
        with _lock:
            _hits += 1
        return np.array(np.load(entry, mmap_mode="r"))
    arr, mode = image_io.decode(path, convert)
    if mode not in _ARRAY_MODES:
        return arr  # as the JAX cache: other modes are served, not cached
    with _lock:
        _misses += 1
    fd, tmp = tempfile.mkstemp(dir=_cache_dir, suffix=".npy.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.save(f, arr)
        os.replace(tmp, entry)  # atomic against racing workers
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    return arr


def open_rgb(path: str) -> np.ndarray:
    """``open_image(path, convert="RGB")``: every dataset's image branch."""
    return open_image(path, convert="RGB")
