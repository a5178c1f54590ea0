"""Zarr v2 arrays over a key-value mapping: the arrays of an Orbax checkpoint.

Orbax stores each array of a checkpoint as a zarr v2 array inside its
OCDBT store (:mod:`~fastscnn_tpu_torch.utils.ocdbt`): the metadata at
``<name>/.zarray`` and each chunk, C order, at ``<name>/<i>.<j>...``
(``<name>/0`` for a scalar), zstd-compressed. :func:`read_array` reads
such an array into a CPU tensor: any chunk grid, edge chunks cut to the
shape, a missing chunk at the fill value; the compressor zstd or none; the
dtypes ``<f4``, ``<f2``, ``<i4``, ``<i8``, ``|b1`` and ``bfloat16`` (through a
``uint16`` view). Any other field value raises naming the field.
:func:`write_array` writes a tensor as Orbax writes one: one chunk, zstd
(raw blocks, :func:`~fastscnn_tpu_torch.utils.zstd.compress`).
"""

from __future__ import annotations

import itertools
import json
import math

import numpy as np
import torch

from fastscnn_tpu_torch.utils import zstd

__all__ = ["read_array", "write_array", "DTYPES"]

# zarr dtype: (numpy dtype of the stored bytes, torch dtype)
DTYPES = {
    "<f4": (np.float32, torch.float32),
    "<f2": (np.float16, torch.float16),
    "<i4": (np.int32, torch.int32),
    "<i8": (np.int64, torch.int64),
    "|b1": (np.bool_, torch.bool),
    "bfloat16": (np.uint16, torch.bfloat16),
}
_NAMES = {t: name for name, (_, t) in DTYPES.items()}


def _field(meta: dict, name: str, field: str, ok) -> object:
    value = meta.get(field)
    if not ok(value):
        raise ValueError(f"zarr array {name!r}: {field} {value!r} is not read")
    return value


def read_array(items: dict, name: str, stats: dict | None = None) -> torch.Tensor:
    """The zarr v2 array ``name`` of ``items`` ({key bytes: value bytes})
    as a CPU tensor. ``stats``, where given, gains the zstd decoder's
    counts."""
    raw_meta = items.get(f"{name}/.zarray".encode())
    if raw_meta is None:
        raise KeyError(f"zarr array {name!r}: no {name}/.zarray in the store")
    meta = json.loads(raw_meta)
    _field(meta, name, "zarr_format", lambda v: v == 2)
    dtype = _field(meta, name, "dtype", lambda v: v in DTYPES)
    _field(meta, name, "order", lambda v: v == "C")
    _field(meta, name, "filters", lambda v: not v)
    compressor = _field(meta, name, "compressor", lambda v: v is None or (
        isinstance(v, dict) and v.get("id") == "zstd"))
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise ValueError(f"zarr array {name!r}: dimension_separator {sep!r} is not read")
    shape = [int(s) for s in meta["shape"]]
    chunks = [int(c) for c in meta["chunks"]]
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"zarr array {name!r}: chunks {chunks} for shape {shape}")
    np_dtype, torch_dtype = DTYPES[dtype]
    fill = meta.get("fill_value")
    if fill is None or dtype == "bfloat16":  # a bfloat16 fill is a float: 0 is all it takes
        if fill not in (None, 0, 0.0):
            raise ValueError(f"zarr array {name!r}: bfloat16 fill_value {fill!r} is not read")
        fill = 0
    out = np.full(shape, fill, np_dtype)
    chunk_bytes = math.prod(chunks) * np.dtype(np_dtype).itemsize
    for idx in itertools.product(*[range(-(-s // c)) for s, c in zip(shape, chunks)]):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}".encode()
        data = items.get(key)
        if data is None:
            continue
        if compressor is not None:
            data = zstd.decompress(data, stats)
        if len(data) != chunk_bytes:
            raise ValueError(f"zarr array {name!r}: chunk {key.decode()} holds {len(data)} "
                             f"bytes, a chunk of {chunks} {dtype} holds {chunk_bytes}")
        chunk = np.frombuffer(data, np_dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    tensor = torch.from_numpy(out)
    return tensor.view(torch.bfloat16) if torch_dtype is torch.bfloat16 else tensor


def write_array(items: dict, name: str, tensor: torch.Tensor) -> None:
    """Add the zarr v2 array ``name`` holding ``tensor`` to ``items``, as
    Orbax writes it: one chunk of the whole shape, zstd, no fill value."""
    t = tensor.detach().to("cpu").contiguous()
    if t.dtype not in _NAMES:
        raise TypeError(f"zarr array {name!r}: dtype {t.dtype} is not written")
    if 0 in t.shape:
        raise ValueError(f"zarr array {name!r}: an empty shape {tuple(t.shape)} has no chunk")
    dtype = _NAMES[t.dtype]
    arr = (t.view(torch.uint16) if t.dtype is torch.bfloat16 else t).numpy()
    meta = {"chunks": list(t.shape), "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": dtype, "fill_value": None, "filters": None,
            "order": "C", "shape": list(t.shape), "zarr_format": 2}
    items[f"{name}/.zarray".encode()] = json.dumps(meta, separators=(",", ":"),
                                                  sort_keys=True).encode()
    key = ".".join("0" for _ in t.shape) or "0"
    items[f"{name}/{key}".encode()] = zstd.compress(arr.tobytes())
