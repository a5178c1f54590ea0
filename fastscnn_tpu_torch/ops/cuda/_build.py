"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` becomes ``build/fastscnn_tpu_torch/<name>-<hash>.so``
under the repo root (``build/`` is git-ignored), compiled for ``sm_90a``
with a plain C interface and loaded with ``ctypes``. All sources compile
at once, one ``nvcc`` process each, started together. The hash covers the
sources, the shared header and the flags, so an edited kernel rebuilds and
an unchanged one is reused.

Nothing here runs at import time: modules that import this one must
import on a machine without ``nvcc``. The build runs the first time a
wrapper meets a CUDA tensor. :func:`set_build_dir` moves the libraries
elsewhere (``utils/profiling.py::enable_compilation_cache`` does: one
directory for each host CPU); :func:`build_dir` says where they go. It
also sets ``FASTSCNN_KERNEL_DIR``, which a process reads at import: the
processes a run starts (the ranks of a data-parallel group) load the
libraries it built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["library", "build_all", "build_dir", "check", "set_build_dir", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "fastscnn_tpu_torch"
SOURCES = ("dw_conv", "dw_conv_bwd", "ds_conv_mr", "int8_pw", "upsample_argmax")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of every C entry: c_void_p for each pointer and the stream (a
# bare Python int would be passed as a 32-bit int and cut the pointer)
_SIGNATURES = {
    "dw_conv": {
        "fastscnn_dw_conv3x3": [_I, _P, _I, _P, _I, _P, _P] + [_I] * 16 + [_P],
        "fastscnn_ds_conv3x3_pw": [_I, _P, _I, _P, _I, _P, _I, _P, _I, _P, _P] + [_I] * 14 + [_P],
    },
    "dw_conv_bwd": {
        "fastscnn_dw_conv3x3_dx": [_I, _P, _I, _P, _P] + [_I] * 15 + [_P],
        "fastscnn_dw_conv3x3_dw": [_I, _I, _P, _P, _P, _P] + [_I] * 12 + [_P],
    },
    "ds_conv_mr": {
        "fastscnn_ds_conv3x3_pw_mr": [_I, _P, _I, _P, _I, _P, _I, _P, _I, _P, _P] + [_I] * 16
                                     + [_P],
    },
    "int8_pw": {
        "fastscnn_pw_conv_w8a8": [_P, _P, _P, _I, _P, _P] + [_I] * 9 + [_P],
        "fastscnn_pw_conv_a8": [_P, _P, _I, _P, _P] + [_I] * 9 + [_P],
    },
    "upsample_argmax": {
        "fastscnn_upsample_argmax": [_I] + [_P] * 5 + [_I] * 14 + [_P],
        "fastscnn_h_lerp_argmax": [_I] + [_P] * 5 + [_I] * 10 + [_P],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
_build_dir: list[Path] = [Path(os.environ.get("FASTSCNN_KERNEL_DIR") or BUILD_DIR)]


def build_dir() -> Path:
    """The directory the libraries are built into and loaded from."""
    return _build_dir[0]


def set_build_dir(path) -> None:
    """Build and load the libraries under ``path`` from now on, in this
    process and in the ones it starts; those already loaded stay loaded."""
    _build_dir[0] = Path(path)
    os.environ["FASTSCNN_KERNEL_DIR"] = str(path)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel;
    raise with nvcc's output if any fails. Returns name -> library path."""
    targets = {name: _target(name) for name in SOURCES}
    todo = {name: t for name, t in targets.items() if not t.exists()}
    if todo:
        build_dir().mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, target in todo.items():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp,
            )
        failures = []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc {name}.cu (rc {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, todo[name])  # atomic: no reader sees a partial .so
        if failures:
            raise RuntimeError("kernel build failed\n" + "\n".join(failures))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building all sources at
    first use."""
    if name not in _loaded:
        paths = build_all()
        for lib_name, path in paths.items():
            if lib_name in _loaded:
                continue
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in _SIGNATURES[lib_name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[lib_name] = lib
    return _loaded[name]


def launch(name: str, symbol: str, device, *args) -> int:
    """Call ``symbol`` of the library for ``csrc/<name>.cu`` with ``args``
    and ``device``'s current stream. A ``<<<>>>`` launch and a
    ``cudaFuncSetAttribute`` act on the host thread's current device, which
    must be the tensors': where ``device`` is another card (a replica on a
    second card), the call runs under its guard. Returns the entry's code
    (see :func:`check`)."""
    import torch

    entry, stream = getattr(library(name), symbol), torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        return entry(*args, stream)
    with torch.cuda.device(device):
        return entry(*args, stream)


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (its cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
