"""Orbax checkpoint directories without orbax: a pytree's leaves by key path.

The directory that ``orbax.checkpoint.StandardCheckpointer`` writes (orbax
0.11, OCDBT on, zarr v2) holds:

- ``_METADATA``: JSON, ``tree_metadata`` keyed by ``str(key_tuple)``, each
  entry the key path (``key_type`` 1 for a sequence index, 2 for a dict key
  or field) and the value's metadata: an array (``jax.Array``, the shape
  each process wrote, ``write_shape``) or an empty node (``None``,
  ``skip_deserialize``);
- ``_CHECKPOINT_METADATA``, ``_sharding`` (each array's sharding, keyed by
  base64 of its dotted name) and ``array_metadatas/process_0``: JSON;
- the OCDBT store (:mod:`~fastscnn_tpu_torch.utils.ocdbt`), whose arrays
  (:mod:`~fastscnn_tpu_torch.utils.zarr`) are named by the dotted key path.
  A store written by several processes is merged at the root, its data
  files under ``ocdbt.process_<n>/d/``.

:func:`read_tree` reads the leaves; :func:`write_tree` writes a directory
that orbax restores, into a sibling directory first and renamed into place
(replacing an existing one, as orbax's ``force=True`` does).
"""

from __future__ import annotations

import base64
import json
import os
import shutil
import time
from pathlib import Path

from fastscnn_tpu_torch.utils import ocdbt, zarr

__all__ = ["read_tree", "write_tree", "HANDLER", "SEQUENCE", "DICT"]

SEQUENCE, DICT = 1, 2  # orbax's key types
HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
# the device a template-free orbax restore places a leaf on: the host's,
# which every JAX process has
_SHARDING = json.dumps({"sharding_type": "SingleDeviceSharding", "device_str": "TFRT_CPU_0"})


def read_tree(directory, stats: dict | None = None) -> dict:
    """{key path (tuple of str): CPU tensor, or None for an empty node} of
    the Orbax checkpoint at ``directory``. ``stats``, where given, gains the
    store's counts (:func:`~fastscnn_tpu_torch.utils.ocdbt.read_store`)."""
    directory = Path(directory)
    meta_path = directory / "_METADATA"
    if not meta_path.exists():
        raise FileNotFoundError(f"{directory}: no _METADATA, not an Orbax checkpoint")
    meta = json.loads(meta_path.read_text())
    if not meta.get("use_ocdbt", True):
        raise ValueError(f"{directory}: a checkpoint without OCDBT (one directory an array) "
                         "is not read")
    if meta.get("use_zarr3", False):
        raise ValueError(f"{directory}: zarr v3 arrays are not read")
    stats = {} if stats is None else stats
    store = ocdbt.read_store(directory, stats)
    zstats = stats.setdefault("zstd", {})
    out = {}
    for entry in meta["tree_metadata"].values():
        keys = tuple(str(k["key"]) for k in entry["key_metadata"])
        value = entry["value_metadata"]
        if value.get("skip_deserialize"):
            out[keys] = None
            continue
        if value.get("value_type") not in _ARRAY_TYPES:
            raise ValueError(f"{directory}: leaf {keys} of type {value.get('value_type')!r} "
                             "is not read")
        # the shape is the array's (``write_shape`` is one shard's)
        out[keys] = zarr.read_array(store, ".".join(keys), zstats)
    return out


def write_tree(directory, entries: list) -> dict:
    """Write ``entries`` — (key path, key types, tensor or None), in the
    tree's order — as an Orbax checkpoint at ``directory``. Returns the
    store's counts (:func:`~fastscnn_tpu_torch.utils.ocdbt.write_store`)."""
    directory = Path(directory).absolute()
    directory.parent.mkdir(parents=True, exist_ok=True)
    stamp = time.time_ns()
    tmp = directory.parent / f"{directory.name}.orbax-checkpoint-tmp-{stamp}"
    items, tree, arrays, sharding, old = {}, {}, [], {}, None
    for keys, types, value in entries:
        key_metadata = [{"key": k, "key_type": t} for k, t in zip(keys, types)]
        if value is None:
            value_metadata = {"value_type": "None", "skip_deserialize": True}
        else:
            name = ".".join(keys)
            zarr.write_array(items, name, value)
            shape = list(value.shape)
            value_metadata = {"value_type": "jax.Array", "skip_deserialize": False,
                              "write_shape": shape}
            arrays.append({"array_metadata": {"param_name": name, "write_shape": shape,
                                              "chunk_shape": shape, "ext_metadata": None}})
            sharding[base64.b64encode(name.encode()).decode()] = _SHARDING
        tree[str(tuple(keys))] = {"key_metadata": key_metadata, "value_metadata": value_metadata}
    try:
        info = ocdbt.write_store(tmp, items)
        (tmp / "_METADATA").write_text(json.dumps({
            "tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
        (tmp / "_sharding").write_text(json.dumps(sharding))
        (tmp / "array_metadatas").mkdir()
        (tmp / "array_metadatas" / "process_0").write_text(json.dumps({"array_metadatas": arrays}))
        (tmp / "_CHECKPOINT_METADATA").write_text(json.dumps({
            "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": stamp, "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}}))
        if directory.exists():
            old = directory.parent / f"{directory.name}.orbax-checkpoint-old-{stamp}"
            os.replace(directory, old)
        os.replace(tmp, directory)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    return info

