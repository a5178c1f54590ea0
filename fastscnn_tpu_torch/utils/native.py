"""Host C++ libraries of the port, compiled with ``g++`` at first use.

The serial bridge (``serialbridge/bridge.cpp``), the MCU firmware
(``serialbridge/mcu.cpp``) and the JPEG codec (``data/jpeg.cpp``) are
plain C++ with a C interface, loaded with ``ctypes``. Each is built the
first time a function needs it (never at import) into
``build/fastscnn_tpu_torch/`` under the repo root, beside the CUDA
kernels' libraries, named by a hash of its source and the flags.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "GXX_FLAGS", "build_library"]

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fastscnn_tpu_torch"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def build_library(src: Path, name: str) -> Path:
    """The shared library of the C++ source ``src``, compiled with ``g++``
    when the one for this source and :data:`GXX_FLAGS` is missing, into
    ``BUILD_DIR/lib<name>-<hash>.so``. The caller holds its own lock."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    so = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ {src.name} (rc {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: no other process loads a partial library
    return so
