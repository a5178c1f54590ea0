"""OCDBT key-value stores without tensorstore: the store under an Orbax checkpoint.

An OCDBT store (tensorstore's "optionally-cooperative distributed B+tree")
is a directory holding ``manifest.ocdbt`` and data files ``d/<hex>``. Each
structure in it — the manifest, a B-tree node, a version-tree node — is
framed alike: a 4-byte big-endian magic number, the u64 little-endian
length of the whole structure, a version varint (0), a compression varint
(0 none, 1 zstd), the body (a zstd frame when compressed) and a CRC-32C of
everything before it, little-endian. Integers in a body are LEB128
varints, and columns come one field at a time for all entries.

- The manifest's body: the config (uuid, manifest kind, the largest inline
  value, the largest decoded node, the version tree's arity, the
  compression and its level), then the newest versions inline (each a
  generation, its B-tree root's height and location, its counts and its
  commit time) and references to version-tree nodes holding the older
  ones.
- A B-tree node: its height, a table of the data files it points into
  (paths written with the prefix shared with the previous path), and its
  keys (each with the prefix shared with the previous key). A leaf gives
  each key's value inline or as (file, offset, length); an interior node
  gives each child's location, the prefix its keys share and its counts.
  A child's keys leave out the prefix that its parent's entry names.

:func:`read_store` reads the newest version (every CRC checked: a mismatch
raises), through interior nodes, and data files anywhere under the root
(Orbax's merged ``ocdbt.process_<n>/d/``); :func:`list_versions` reads
every version, through the version-tree nodes.
:func:`write_store` writes one version of one store at the root, in one
data file: the values of more than 1024 bytes, then one B-tree leaf (a
zstd frame of raw blocks), which tensorstore reads.
"""

from __future__ import annotations

import os
import struct
import time
import uuid as _uuid
from pathlib import Path

from fastscnn_tpu_torch.utils import zstd

__all__ = ["read_store", "write_store", "list_versions", "MANIFEST_MAGIC", "BTREE_MAGIC",
           "VERSION_MAGIC", "MAX_INLINE", "MAX_NODE"]

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_MAGIC = 0x0CDB1234
_EMPTY = (1 << 64) - 1  # the offset and length of an empty tree's root
_NAMES = {MANIFEST_MAGIC: "manifest", BTREE_MAGIC: "B-tree node", VERSION_MAGIC: "version node"}


class _Body:
    def __init__(self, data: bytes, what: str):
        self.d, self.p, self.what = data, 0, what

    def _need(self, n):
        if self.p + n > len(self.d):
            raise ValueError(f"OCDBT {self.what}: truncated body")

    def varint(self) -> int:
        v = shift = 0
        while True:
            self._need(1)
            c = self.d[self.p]
            self.p += 1
            v |= (c & 0x7F) << shift
            shift += 7
            if c < 0x80:
                return v
            if shift > 63:
                raise ValueError(f"OCDBT {self.what}: varint too long")

    def varints(self, n) -> list:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self._need(1)
        self.p += 1
        return self.d[self.p - 1]

    def raw(self, n) -> bytes:
        self._need(n)
        self.p += n
        return self.d[self.p - n:self.p]

    def u64(self) -> int:
        return struct.unpack("<Q", self.raw(8))[0]

    def done(self):
        if self.p != len(self.d):
            raise ValueError(f"OCDBT {self.what}: {len(self.d) - self.p} bytes after the body")


def _unframe(buf: bytes, magic: int, where: str, stats: dict) -> _Body:
    what = f"{_NAMES[magic]} in {where}"
    if len(buf) < 18:
        raise ValueError(f"OCDBT {what}: {len(buf)} bytes, too short")
    got_magic, length = struct.unpack(">I", buf[:4])[0], struct.unpack("<Q", buf[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"OCDBT {what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(buf):
        raise ValueError(f"OCDBT {what}: header length {length}, {len(buf)} bytes read")
    crc = struct.unpack("<I", buf[-4:])[0]
    if zstd.crc32c(buf[:-4]) != crc:
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    stats["crcs"] = stats.get("crcs", 0) + 1
    head = _Body(buf[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"OCDBT {what}: format version {version}")
    body = head.d[head.p:]
    if compression == 1:
        body = zstd.decompress(body, stats.setdefault("zstd", {}))
    elif compression != 0:
        raise ValueError(f"OCDBT {what}: compression {compression}")
    return _Body(body, what)


def _read_files(b: _Body) -> list:
    """A data file table: the paths, relative to the store's root."""
    n = b.varint()
    prefix = [0] + b.varints(n - 1) if n else []
    suffix = b.varints(n)
    b.varints(n)  # the length of each path's base (the part ahead of d/)
    paths, prev = [], b""
    for i in range(n):
        path = prev[:prefix[i]] + b.raw(suffix[i])
        paths.append(path.decode())
        prev = path
    return paths


def _read_keys(b: _Body, n: int, interior: bool):
    prefix = [0] + b.varints(n - 1) if n else []
    suffix = b.varints(n)
    common = b.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"OCDBT {b.what}: key prefix longer than the previous key")
        key = prev[:prefix[i]] + b.raw(suffix[i])
        keys.append(key)
        prev = key
    return keys, common


class _Files:
    """The store's data files, each read once."""

    def __init__(self, root: Path, stats: dict):
        self.root, self.stats, self.cache = root, stats, {}

    def read(self, path: str, offset: int, length: int) -> bytes:
        if path not in self.cache:
            full = (self.root / path).resolve()
            if self.root.resolve() not in full.parents:
                raise ValueError(f"OCDBT data file {path!r} lies outside the store")
            self.cache[path] = full.read_bytes()
            self.stats["data_files"] = self.stats.get("data_files", 0) + 1
        data = self.cache[path]
        if offset + length > len(data):
            raise ValueError(f"OCDBT {path}: bytes {offset}..{offset + length} past its "
                             f"{len(data)} bytes")
        return data[offset:offset + length]


def _read_manifest(root: Path, stats: dict):
    path = root / "manifest.ocdbt"
    if not path.exists():
        raise FileNotFoundError(f"{path}: no OCDBT manifest")
    b = _unframe(path.read_bytes(), MANIFEST_MAGIC, str(path), stats)
    config = {"uuid": b.raw(16).hex(), "manifest_kind": b.varint(),
              "max_inline_value_bytes": b.varint(), "max_decoded_node_bytes": b.varint(),
              "version_tree_arity_log2": b.byte(), "compression": b.varint()}
    if config["manifest_kind"] != 0:
        raise ValueError(f"{path}: numbered manifests (kind {config['manifest_kind']}) are "
                         "not read")
    if config["compression"] == 1:
        config["zstd_level"] = struct.unpack("<i", b.raw(4))[0]
    elif config["compression"] != 0:
        raise ValueError(f"{path}: compression {config['compression']}")
    files = _read_files(b)  # one table for the inline versions and the references
    versions = _read_versions(b, files)
    refs = _read_version_refs(b, files, with_height=True)
    b.done()
    return config, versions, refs


def _read_versions(b: _Body, files: list):
    """Versions held inline (a manifest's or a leaf version node's)."""
    n = b.varint()
    gen = b.varints(n)
    height = [b.byte() for _ in range(n)]
    fid, off, length = b.varints(n), b.varints(n), b.varints(n)
    keys, tree_bytes, value_bytes = b.varints(n), b.varints(n), b.varints(n)
    commit = [b.u64() for _ in range(n)]
    out = []
    for i in range(n):
        if fid[i] >= len(files):
            raise ValueError(f"OCDBT {b.what}: data file {fid[i]} of {len(files)}")
        out.append({"generation": gen[i], "height": height[i], "file": files[fid[i]],
                    "offset": off[i], "length": length[i], "num_keys": keys[i],
                    "num_tree_bytes": tree_bytes[i], "num_indirect_value_bytes": value_bytes[i],
                    "commit_time": commit[i]})
    return out


def _read_version_refs(b: _Body, files: list, with_height: bool, height: int = 0):
    """References to version-tree nodes: a manifest's carry each node's
    height last; an interior node's children are one level below it."""
    n = b.varint()
    gen = b.varints(n)
    fid, off, length = b.varints(n), b.varints(n), b.varints(n)
    count = b.varints(n)
    commit = [b.u64() for _ in range(n)]
    heights = [b.byte() for _ in range(n)] if with_height else [height - 1] * n
    refs = []
    for i in range(n):
        if fid[i] >= len(files):
            raise ValueError(f"OCDBT {b.what}: data file {fid[i]} of {len(files)}")
        refs.append({"generation": gen[i], "file": files[fid[i]], "offset": off[i],
                     "length": length[i], "num_generations": count[i],
                     "commit_time": commit[i], "height": heights[i]})
    return refs


def _walk_version_node(files: _Files, ref: dict, stats: dict, out: list):
    buf = files.read(ref["file"], ref["offset"], ref["length"])
    b = _unframe(buf, VERSION_MAGIC, ref["file"], stats)
    stats["version_nodes"] = stats.get("version_nodes", 0) + 1
    b.byte()  # the version tree's arity, log 2
    height = b.byte()
    if height != ref["height"]:
        raise ValueError(f"OCDBT version node in {ref['file']}: height {height}, its "
                         f"reference says {ref['height']}")
    node_files = _read_files(b)
    if height == 0:
        out.extend(_read_versions(b, node_files))
    else:
        for child in _read_version_refs(b, node_files, with_height=False, height=height):
            _walk_version_node(files, child, stats, out)
    b.done()


def list_versions(root, stats: dict | None = None) -> list:
    """Every version of the store at ``root`` (oldest first), from the
    manifest's inline versions and its version-tree nodes."""
    root, stats = Path(root), {} if stats is None else stats
    _, inline, refs = _read_manifest(root, stats)
    files, out = _Files(root, stats), []
    for ref in refs:
        _walk_version_node(files, ref, stats, out)
    return sorted(out + inline, key=lambda v: v["generation"])


def _walk_btree(files: _Files, loc: tuple, height: int, prefix: bytes, stats: dict,
                out: dict):
    path, offset, length = loc
    b = _unframe(files.read(path, offset, length), BTREE_MAGIC, path, stats)
    stats["btree_nodes"] = stats.get("btree_nodes", 0) + 1
    if b.byte() != height:
        raise ValueError(f"OCDBT B-tree node in {path}: height differs from its reference")
    node_files = _read_files(b)
    n = b.varint()
    keys, common = _read_keys(b, n, interior=height > 0)

    def data_file(i):
        if i >= len(node_files):
            raise ValueError(f"OCDBT B-tree node in {path}: data file {i} of {len(node_files)}")
        return node_files[i]

    if height > 0:
        fid, off, ln = b.varints(n), b.varints(n), b.varints(n)
        b.varints(3 * n)  # each child's keys, tree bytes and indirect value bytes
        b.done()
        for i in range(n):
            _walk_btree(files, (data_file(fid[i]), off[i], ln[i]), height - 1,
                        prefix + keys[i][:common[i]], stats, out)
        return
    lengths = b.varints(n)
    kinds = b.varints(n)
    indirect = [i for i in range(n) if kinds[i]]
    if any(k > 1 for k in kinds):
        raise ValueError(f"OCDBT B-tree leaf in {path}: value kind {max(kinds)}")
    fid, off = b.varints(len(indirect)), b.varints(len(indirect))
    where = dict(zip(indirect, zip(fid, off)))
    for i in range(n):
        if kinds[i]:
            f, o = where[i]
            out[prefix + keys[i]] = files.read(data_file(f), o, lengths[i])
        else:
            out[prefix + keys[i]] = b.raw(lengths[i])
    b.done()


def read_store(root, stats: dict | None = None) -> dict:
    """The newest version of the OCDBT store at ``root``: {key bytes: value
    bytes}. ``stats``, where given, gains the counts of manifests, B-tree
    and version nodes, CRCs checked and data files read, and the zstd
    decoder's counts under ``'zstd'``."""
    root, stats = Path(root), {} if stats is None else stats
    _, inline, _ = _read_manifest(root, stats)
    if not inline:  # the manifest holds the newest versions inline (the older in nodes)
        raise ValueError(f"{root}: the manifest holds no version")
    newest = max(inline, key=lambda v: v["generation"])
    out: dict = {}
    if newest["length"] != _EMPTY:
        _walk_btree(_Files(root, stats), (newest["file"], newest["offset"], newest["length"]),
                    newest["height"], b"", stats, out)
    if len(out) != newest["num_keys"]:
        raise ValueError(f"{root}: {len(out)} keys read, the manifest counts "
                         f"{newest['num_keys']}")
    return out


# ------------------------------------------------------------------ writing


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        c = v & 0x7F
        v >>= 7
        if v:
            out.append(c | 0x80)
        else:
            out.append(c)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _shared(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _frame(magic: int, body: bytes) -> bytes:
    """A structure framed as OCDBT frames it, its body a zstd frame of raw
    blocks."""
    payload = _varint(0) + _varint(1) + zstd.compress(body, checksum=False)
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(payload) + 4)
    crc = zstd.crc32c(head + payload)
    return head + payload + struct.pack("<I", crc)


def _files_table(paths: list) -> bytes:
    prev, prefix, suffix = b"", [], []
    for p in paths:
        p = p.encode()
        n = _shared(prev, p)
        prefix.append(n)
        suffix.append(p[n:])
        prev = p
    return (_varint(len(paths)) + _varints(prefix[1:]) + _varints(len(s) for s in suffix)
            + _varints(0 for _ in paths) + b"".join(suffix))


def _keys_block(keys: list) -> bytes:
    """A leaf's keys, each written after the prefix it shares with the one
    before."""
    prefix = [_shared(a, b) for a, b in zip(keys, keys[1:])]
    suffix = [k[n:] for k, n in zip(keys, [0] + prefix)]
    return (_varint(len(keys)) + _varints(prefix) + _varints(len(s) for s in suffix)
            + b"".join(suffix))


MAX_INLINE = 1024  # Orbax's config: larger values go to a data file
MAX_NODE = 100_000_000  # Orbax's config: the largest decoded node


def write_store(root, items: dict) -> dict:
    """Write ``items`` ({key bytes: value bytes}) as a new OCDBT store of
    one version at ``root`` (an empty or missing directory), with the
    config Orbax writes (zstd, inline values up to :data:`MAX_INLINE`
    bytes, nodes up to :data:`MAX_NODE`, arity 16): one data file
    ``d/<hex>`` holding the larger values and then the one B-tree leaf, and
    ``manifest.ocdbt``. Returns the counts the manifest records."""
    root = Path(root)
    (root / "d").mkdir(parents=True, exist_ok=True)
    data_path = f"d/{_uuid.uuid4().hex}"
    data = bytearray()
    keys = sorted(items)
    values = [bytes(items[k]) for k in keys]
    where = {}  # key index: offset of its value in the data file
    for i, v in enumerate(values):
        if len(v) > MAX_INLINE:
            where[i] = len(data)
            data += v
    indirect_bytes = len(data)
    height = fid = 0
    if keys:
        body = (b"\x00" + _files_table([data_path] if where else []) + _keys_block(keys)
                + _varints(len(v) for v in values)
                + _varints(int(i in where) for i in range(len(keys)))
                + _varints(0 for _ in where) + _varints(where.values())
                + b"".join(v for i, v in enumerate(values) if i not in where))
        if len(body) > MAX_NODE:
            raise ValueError(f"OCDBT leaf of {len(body)} bytes: more than one node holds")
        node = _frame(BTREE_MAGIC, body)
        offset, length, tree_bytes = len(data), len(node), len(node)
        data += node
    else:  # the empty tree
        offset = length = _EMPTY
        tree_bytes = 0
    (root / data_path).write_bytes(data)
    config = (_uuid.uuid4().bytes + _varint(0) + _varint(MAX_INLINE) + _varint(MAX_NODE)
              + bytes([4]) + _varint(1) + struct.pack("<i", 0))
    versions = (_varint(1) + _varint(1) + bytes([height]) + _varint(fid) + _varint(offset)
                + _varint(length) + _varint(len(keys)) + _varint(tree_bytes)
                + _varint(indirect_bytes) + struct.pack("<Q", time.time_ns()))
    manifest = _frame(MANIFEST_MAGIC, config + _files_table([data_path]) + versions + _varint(0))
    tmp = root / f"manifest.ocdbt.{os.getpid()}.tmp"
    tmp.write_bytes(manifest)
    os.replace(tmp, root / "manifest.ocdbt")
    return {"num_keys": len(keys), "num_tree_bytes": tree_bytes,
            "num_indirect_value_bytes": indirect_bytes, "data_file_bytes": len(data)}
