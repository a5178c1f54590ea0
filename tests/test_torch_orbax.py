"""The port's Orbax pair against the JAX package's, and the codecs under it.

- ``utils/zstd``: the decoder gives back what ``zstandard`` compressed
  (levels 1, 3 and 19, with and without the checksum, the content size
  absent, multi-block and concatenated frames, skippable frames, and
  hypothesis draws), refuses what it cannot read, and its raw-block frames
  read in ``zstandard``; CRC-32C on RFC 3720's check values.
- ``utils/ocdbt`` and ``utils/zarr``: stores and arrays that tensorstore
  writes (interior B-tree nodes, version-tree nodes, chunk grids, every
  dtype) read equal, and the port's open in tensorstore.
- ``utils/checkpoint``: a directory that the JAX package's
  ``save_train_state_orbax`` writes (SGD with a poly or a constant rate,
  AdamW; after 0 and 2 optimizer updates) loads into the port's template in
  place, bit for bit; one the port writes restores through the JAX
  package's ``load_train_state_orbax``, bit for bit; port to port; a
  mismatch raises before any copy; a corrupt node raises; two gloo ranks
  share one directory.
- the committed fixture (``tests/fixtures/orbax``) reads back equal to its
  regeneration from the seed.

The JAX states are FastSCNN(num_classes=2)'s, stepped with the optimizer's
own ``update`` on seeded gradients (what a checkpoint holds is the state,
not how it was reached).
"""

import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings, strategies as st

from fastscnn_tpu.models import FastSCNN as JaxFastSCNN
from fastscnn_tpu.models import init_fast_scnn as jax_init
from fastscnn_tpu.parallel.train import create_train_state as jax_create
from fastscnn_tpu.parallel.train import make_optimizer as jax_optimizer
from fastscnn_tpu.utils import checkpoint as jax_ckpt
from fastscnn_tpu.utils.lr_scheduler import lr_schedule as jax_lr
from fastscnn_tpu_torch.models import FastSCNN
from fastscnn_tpu_torch.parallel import create_train_state, make_optimizer, multihost
from fastscnn_tpu_torch.utils import lr_schedule, ocdbt, zarr, zstd
from fastscnn_tpu_torch.utils.checkpoint import load_train_state_orbax, save_train_state_orbax
from fastscnn_tpu_torch.utils.orbax_tree import read_tree
from fastscnn_tpu_torch.utils.tree import tree_leaves

zstandard = pytest.importorskip("zstandard")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "orbax")
NC = 2
LR = dict(base_lr=1e-2, niters=10)
# (optimizer, poly schedule or a constant rate)
OPTS = [("sgd", True), ("sgd", False), ("adamw", True)]


# ---------------------------------------------------------------- zstd


def _buffers(rng):
    walk = np.cumsum(rng.integers(-3, 4, 200_000)).astype(np.int32).tobytes()
    with open(os.path.join(ROOT, "fastscnn_tpu_torch", "utils", "zstd.cpp"), "rb") as f:
        text = f.read()
    return [b"", b"x", b"abc" * 700, bytes(rng.integers(0, 256, 5000, dtype=np.uint8)),
            rng.choice(8, 700, p=[.4, .2, .1, .1, .05, .05, .05, .05]).astype(np.uint8).tobytes(),
            walk, rng.standard_normal(40_000).astype(np.float32).tobytes(), bytes(300_000),
            text * 4]


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_decodes_what_zstandard_compressed(level, checksum):
    rng = np.random.default_rng(level)
    stats = {}
    for size in (True, False):
        c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                     write_content_size=size)
        for data in _buffers(rng):
            assert zstd.decompress(c.compress(data), stats) == data
    assert stats["checksums"] == (stats["frames"] if checksum else 0)
    assert stats["frames_without_size"] > 0 and stats["multiblock_frames"] > 0
    for kind in ("raw_blocks", "compressed_blocks", "huffman_4_streams", "fse_tables",
                 "predefined_tables", "fse_weights"):
        assert stats[kind] > 0, kind


def test_zstd_streamed_concatenated_and_skippable_frames():
    """A streamed frame (no content size, a block each flush; level 19
    repeats tables), two frames back to back and a skippable frame between
    them."""
    rng = np.random.default_rng(5)
    stats = {}
    for data in _buffers(rng):
        obj = zstandard.ZstdCompressor(level=19).compressobj()
        frame = b"".join(obj.compress(data[i:i + 9000])
                         + obj.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
                         for i in range(0, len(data), 9000)) + obj.flush()
        skip = b"\x5a\x2a\x4d\x18" + (3).to_bytes(4, "little") + b"\x01\x02\x03"
        assert zstd.decompress(frame + skip + frame, stats) == data + data
    assert stats["skippable_frames"] == len(_buffers(rng))
    for kind in ("rle_blocks", "treeless_literals", "repeat_tables", "rle_tables"):
        assert stats[kind] > 0, kind


@settings(max_examples=60, deadline=None)
@given(data=st.one_of(st.binary(max_size=3000),
                      st.lists(st.sampled_from([b"ab", b"zstd", b"\x00" * 7, b"q", b"123"]),
                               max_size=900).map(b"".join)),
       level=st.sampled_from([-3, 1, 3, 9, 19]), checksum=st.booleans())
def test_zstd_hypothesis_draws(data, level, checksum):
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data
    assert zstandard.ZstdDecompressor().decompress(zstd.compress(data, checksum)) == data


def test_zstd_one_stream_huffman_literals():
    rng = np.random.default_rng(0)
    data = rng.choice(8, 200, p=[.4, .2, .1, .1, .05, .05, .05, .05]).astype(np.uint8).tobytes()
    stats = {}
    assert zstd.decompress(zstandard.ZstdCompressor(level=1).compress(data), stats) == data
    assert stats["huffman_1_stream"] == 1


def test_zstd_rle_literals():
    """A compressed block of RLE literals and no sequences (zstandard's
    encoder rarely writes one), read as zstandard reads it."""
    frame = (b"\x28\xb5\x2f\xfd\x20\x14"  # magic, one segment, content size 20
             + b"\x1d\x00\x00"  # the last block, compressed, 3 bytes
             + b"\xa1q\x00")  # RLE literals, 20 of 'q'; no sequences
    stats = {}
    want = zstandard.ZstdDecompressor().decompress(frame)
    assert zstd.decompress(frame, stats) == want == b"q" * 20
    assert stats["rle_literals"] == 1


def _dict_frame():
    samples = [b"sample %d of a dictionary for zstd, " % i * 4 for i in range(200)]
    d = zstandard.train_dictionary(1024, samples)
    return zstandard.ZstdCompressor(dict_data=d).compress(samples[3])


@pytest.mark.parametrize("case", ["truncated", "checksum", "dictionary", "magic", "empty",
                                  "reserved block"])
def test_zstd_refuses_what_it_cannot_read(case):
    data = bytes(range(256)) * 40
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    bad, match = {
        "truncated": (frame[:len(frame) // 2], "truncated"),
        "checksum": (frame[:-1] + bytes([frame[-1] ^ 1]), "checksum mismatch"),
        "dictionary": (_dict_frame(), "dictionar"),
        "magic": (b"\x00" + frame[1:], "magic"),
        "empty": (b"", "no frame"),
        # a raw frame whose one block header has the reserved type 3
        "reserved block": (b"\x28\xb5\x2f\xfd\x20\x00\x07\x00\x00", "reserved block type"),
    }[case]
    with pytest.raises(ValueError, match=match):
        zstd.decompress(bad)


def test_raw_frames_read_in_zstandard():
    rng = np.random.default_rng(1)
    for n in (0, 1, 255, 256, 65_791, 65_792, 131_072, 400_000):
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        for checksum in (False, True):
            frame = zstd.compress(data, checksum)
            assert zstandard.ZstdDecompressor().decompress(frame) == data
            assert zstd.decompress(frame) == data
            assert len(frame) <= 13 + 3 * (n // 131_072 + 1) + n + 4


@pytest.mark.parametrize("data,crc", [
    (bytes(32), 0x8A9136AA), (b"\xff" * 32, 0x62A8AB43), (bytes(range(32)), 0x46DD794E),
    (bytes(range(31, -1, -1)), 0x113FDB5C), (b"123456789", 0xE3069283),
    (bytes.fromhex("01c00000" + "00" * 12 + "14000000" + "00000400" + "00000014"
                   + "00000018" + "28000000" + "00000000" + "02000000" + "00000000"), 0xD9963A56),
])
def test_crc32c_check_values(data, crc):
    assert zstd.crc32c(data) == crc
    assert zstd.crc32c(data[len(data) // 2:], zstd.crc32c(data[:len(data) // 2])) == crc


# ------------------------------------------------------------ OCDBT, zarr


def test_ocdbt_reads_tensorstore_stores_with_interior_and_version_nodes(tmp_path):
    ts = pytest.importorskip("tensorstore")
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/kv/",
            "config": {"max_decoded_node_bytes": 200, "max_inline_value_bytes": 16,
                       "version_tree_arity_log2": 1}}
    kv = ts.KvStore.open(spec).result()
    want = {}
    for i in range(40):  # one commit each: versions in version-tree nodes
        key, value = f"key/{i:03d}/v", b"v%d" % i * (1 + i % 9)
        kv.write(key, value).result()
        want[key.encode()] = value
    stats = {}
    assert ocdbt.read_store(tmp_path / "kv", stats) == want
    assert [v["generation"] for v in ocdbt.list_versions(tmp_path / "kv", stats)] == list(
        range(1, 42))
    assert stats["version_nodes"] > 0 and stats["btree_nodes"] > 1


@pytest.mark.parametrize("case", ["mixed", "inline only", "empty"])
def test_ocdbt_store_written_by_the_port_opens_in_tensorstore(tmp_path, case):
    """Values inline and in the data file, keys with shared prefixes, and
    the empty tree."""
    ts = pytest.importorskip("tensorstore")
    rng = np.random.default_rng(2)
    top = {"mixed": 3000, "inline only": ocdbt.MAX_INLINE + 1, "empty": 0}[case]
    items = {f"a/{i:04d}/{'y' * (i % 5)}".encode():
             bytes(rng.integers(0, 256, int(rng.integers(0, top)), dtype=np.uint8))
             for i in range(150 if top else 0)}
    info = ocdbt.write_store(tmp_path / "kv", items)
    assert info["num_keys"] == len(items)
    assert (info["num_indirect_value_bytes"] > 0) == (case == "mixed")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/kv/"}).result()
    assert sorted(kv.list().result()) == sorted(items)
    for k, v in items.items():
        assert kv.read(k).result().value == v
    assert ocdbt.read_store(tmp_path / "kv") == items


DTYPES = [("<f4", np.float32), ("<f2", np.float16), ("<i4", np.int32), ("<i8", np.int64),
          ("|b1", np.bool_), ("bfloat16", None)]


@pytest.mark.parametrize("dtype,np_dtype", DTYPES)
def test_zarr_arrays_both_ways_with_tensorstore(tmp_path, dtype, np_dtype):
    """tensorstore's zarr v2 array in chunks of 3 x 4 over an 7 x 10 shape
    (edge chunks, zstd) reads equal; the port's array reads equal in
    tensorstore."""
    ts = pytest.importorskip("tensorstore")
    rng = np.random.default_rng(3)
    values = rng.integers(-100, 100, (7, 10)) / 4  # exact in every float dtype here
    if dtype == "bfloat16":
        expected = torch.tensor(values, dtype=torch.bfloat16)
        ts_values = jnp.asarray(values, jnp.bfloat16)
    else:
        expected = torch.from_numpy(values.astype(np_dtype))
        ts_values = values.astype(np_dtype)
    kv = {"driver": "ocdbt", "base": f"file://{tmp_path}/a/"}
    arr = ts.open({"driver": "zarr", "kvstore": kv, "path": "x.y",
                   "metadata": {"shape": [7, 10], "chunks": [3, 4], "dtype": dtype,
                                "compressor": {"id": "zstd", "level": 3}}},
                  create=True).result()
    arr.write(ts_values).result()
    got = zarr.read_array(ocdbt.read_store(tmp_path / "a"), "x.y")
    assert got.dtype == expected.dtype and torch.equal(got, expected)
    items = {}
    zarr.write_array(items, "x.y", expected)
    ocdbt.write_store(tmp_path / "b", items)
    back = ts.open({"driver": "zarr", "path": "x.y",
                    "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/b/"}}
                   ).result().read().result()
    np.testing.assert_array_equal(np.asarray(back).astype(np.float64),
                                  expected.to(torch.float64).numpy())


def test_zarr_refuses_what_it_does_not_read():
    items = {}
    zarr.write_array(items, "x", torch.ones(3))
    meta = json.loads(items[b"x/.zarray"])
    for field, value in (("dtype", "<u2"), ("order", "F"), ("filters", [{"id": "delta"}]),
                         ("compressor", {"id": "blosc"})):
        bad = dict(items)
        bad[b"x/.zarray"] = json.dumps(dict(meta, **{field: value})).encode()
        with pytest.raises(ValueError, match=field):
            zarr.read_array(bad, "x")


# ------------------------------------------------------- the Orbax pair


@pytest.fixture(scope="module")
def jax_weights():
    params, state = jax_init(jax.random.PRNGKey(0), NC, aux=False)
    return params, state


def _jax_opt(name, poly):
    return jax_optimizer(name, jax_lr("poly", **LR) if poly else 1e-2)


def _port_opt(name, poly):
    return make_optimizer(name, lr_schedule("poly", **LR) if poly else 1e-2)


def _jax_state(weights, name, poly, steps, seed=0):
    """A JAX TrainState after ``steps`` optimizer updates on seeded
    gradients, its BN statistics moved off their start."""
    opt = _jax_opt(name, poly)
    state = jax_create(JaxFastSCNN(NC, aux=False), opt, params=weights[0],
                       model_state=weights[1])
    rng = np.random.default_rng(seed)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for _ in range(steps):
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), state.params)
        params, opt_state = update(grads, state.opt_state, state.params)
        state = dataclasses.replace(state, params=params, opt_state=opt_state,
                                    step=state.step + 1)
    moved = jax.tree_util.tree_map(  # numpy, then one copy a leaf: no op to compile
        lambda v: jnp.asarray(np.asarray(v) + rng.random(v.shape).astype(np.float32) * steps),
        state.model_state)
    return dataclasses.replace(state, model_state=moved)


def _template(name, poly, warm=False):
    """The port's state for FastSCNN(2); ``warm``: with the optimizer slots
    a first step makes (as a captured step's template has them)."""
    state = create_train_state(FastSCNN(NC, aux=False), _port_opt(name, poly), device="cpu")
    if warm:
        for p in tree_leaves(state.params):
            z = torch.zeros_like(p.detach())
            state.opt_state.state[p] = ({"momentum_buffer": z} if name == "sgd" else
                                        {"step": torch.tensor(0.0), "exp_avg": z.clone(),
                                         "exp_avg_sq": z.clone()})
    return state


def _pointers(state):
    slots = [v for p in tree_leaves(state.params)
             for v in state.opt_state.state.get(p, {}).values()]
    return [t.data_ptr() for t in tree_leaves([state.params, state.model_state]) + slots]


def _jax_slots(jstate, name):
    """(name, leaves) of the JAX optimizer state, as the port names them."""
    if name == "sgd":
        return [("momentum_buffer", jax.tree_util.tree_leaves(jstate.opt_state[1][0].trace))]
    adam = jstate.opt_state[0]
    return [("exp_avg", jax.tree_util.tree_leaves(adam.mu)),
            ("exp_avg_sq", jax.tree_util.tree_leaves(adam.nu))]


def _assert_port_equals_jax(pstate, jstate, name):
    for a, b in zip(jax.tree_util.tree_leaves((jstate.params, jstate.model_state)),
                    tree_leaves([pstate.params, pstate.model_state])):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.detach().numpy(), np.asarray(a))
    leaves = tree_leaves(pstate.params)
    for slot, values in _jax_slots(jstate, name):
        for p, v in zip(leaves, values):
            np.testing.assert_array_equal(pstate.opt_state.state[p][slot].numpy(), np.asarray(v))
    if name == "adamw":
        for p in leaves:
            assert float(pstate.opt_state.state[p]["step"]) == int(jstate.opt_state[0].count)
    assert pstate.step == int(jstate.step)


@pytest.mark.parametrize("steps", [0, 2])
@pytest.mark.parametrize("name,poly", OPTS)
def test_jax_orbax_checkpoint_loads_into_the_port_in_place(jax_weights, tmp_path, name, poly,
                                                          steps):
    jstate = _jax_state(jax_weights, name, poly, steps)
    directory = jax_ckpt.save_train_state_orbax(jstate, str(tmp_path / "ckpt"))
    template = _template(name, poly, warm=steps > 0)
    pointers = _pointers(template)
    assert load_train_state_orbax(directory, template) is template
    _assert_port_equals_jax(template, jstate, name)
    if steps > 0:  # copied into the template's tensors
        assert _pointers(template) == pointers
    else:  # a fresh template's slots, made where torch would make them
        assert _pointers(template)[:len(pointers)] == pointers


@pytest.mark.parametrize("name,poly", OPTS)
def test_port_orbax_checkpoint_restores_in_jax(jax_weights, tmp_path, name, poly):
    """JAX state → the port (loaded) → the port's directory → the JAX
    package's load_train_state_orbax: every leaf, counts included, bit-equal
    to the JAX state."""
    jstate = _jax_state(jax_weights, name, poly, 2, seed=1)
    pstate = load_train_state_orbax(
        jax_ckpt.save_train_state_orbax(jstate, str(tmp_path / "jax")), _template(name, poly))
    directory = save_train_state_orbax(pstate, str(tmp_path / "port"))
    assert directory == str(tmp_path / "port") and os.path.isabs(directory)
    restored = jax_ckpt.load_train_state_orbax(
        directory, _jax_state(jax_weights, name, poly, 0, seed=2))
    got, want = jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(jstate)
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(jstate)
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_round_trip_before_the_first_step_and_replacing_a_directory(tmp_path):
    """A fresh SGD state (no momentum buffers yet: zeros are written, where
    optax's trace starts) and a warm AdamW state, port to port; saving over
    an existing directory replaces it."""
    fresh = _template("sgd", True)
    directory = save_train_state_orbax(fresh, str(tmp_path / "c"))
    tree = read_tree(directory)
    assert tree[("opt_state", "0")] is None and int(tree[("opt_state", "1", "1", "count")]) == 0
    assert all(not t.any() for k, t in tree.items() if k[:4] == ("opt_state", "1", "0", "trace"))
    back = load_train_state_orbax(directory, _template("sgd", True))
    for a, b in zip(tree_leaves(fresh.params), tree_leaves(back.params)):
        assert torch.equal(a, b)

    warm = _template("adamw", False, warm=True)
    g = torch.Generator().manual_seed(4)
    for p in tree_leaves(warm.params):
        s = warm.opt_state.state[p]
        s["step"].fill_(3.0)
        s["exp_avg"].copy_(torch.randn(p.shape, generator=g))
        s["exp_avg_sq"].copy_(torch.rand(p.shape, generator=g))
    warm.step = 3
    os.makedirs(tmp_path / "c" / "stale")
    save_train_state_orbax(warm, directory)
    assert not os.path.exists(tmp_path / "c" / "stale")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["c"]
    back = load_train_state_orbax(directory, _template("adamw", False))
    assert back.step == 3
    for a, b in zip(tree_leaves(warm.params), tree_leaves(back.params)):
        sa, sb = warm.opt_state.state[a], back.opt_state.state[b]
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))


def test_adamw_steps_that_differ_raise(tmp_path):
    state = _template("adamw", True, warm=True)
    state.opt_state.state[tree_leaves(state.params)[0]]["step"].fill_(1.0)
    with pytest.raises(ValueError, match="per-param steps differ"):
        save_train_state_orbax(state, str(tmp_path / "x"))
    assert not os.path.exists(tmp_path / "x")


@pytest.mark.parametrize("case", ["optimizer", "shape"])
def test_a_mismatch_raises_and_leaves_the_template_untouched(jax_weights, tmp_path, case):
    jstate = _jax_state(jax_weights, "adamw" if case == "optimizer" else "sgd", True, 2)
    directory = jax_ckpt.save_train_state_orbax(jstate, str(tmp_path / "ckpt"))
    template = (_template("sgd", True, warm=True) if case == "optimizer" else
                create_train_state(FastSCNN(NC + 1, aux=False), _port_opt("sgd", True),
                                   device="cpu"))
    before = [t.clone() for t in tree_leaves([template.params, template.model_state])]
    slots = {id(p): {k: v.clone() for k, v in template.opt_state.state.get(p, {}).items()}
             for p in tree_leaves(template.params)}
    with pytest.raises(ValueError, match="leaves differ" if case == "optimizer" else "shape"):
        load_train_state_orbax(directory, template)
    for a, b in zip(before, tree_leaves([template.params, template.model_state])):
        assert torch.equal(a, b)
    for p in tree_leaves(template.params):
        assert set(template.opt_state.state.get(p, {})) == set(slots[id(p)])
        assert all(torch.equal(v, slots[id(p)][k])
                   for k, v in template.opt_state.state.get(p, {}).items())
    assert template.step == 0


@pytest.mark.parametrize("part", ["node", "manifest"])
def test_a_corrupt_structure_fails_its_crc(tmp_path, part):
    directory = save_train_state_orbax(_template("sgd", True), str(tmp_path / "c"))
    if part == "manifest":
        path = os.path.join(directory, "manifest.ocdbt")
        at = 30
    else:  # the B-tree node is the data file's tail
        (name,) = os.listdir(os.path.join(directory, "d"))
        path = os.path.join(directory, "d", name)
        at = os.path.getsize(path) - 200
    with open(path, "r+b") as f:
        f.seek(at)
        byte = f.read(1)
        f.seek(at)
        f.write(bytes([byte[0] ^ 0x10]))
    with pytest.raises(ValueError, match="CRC-32C mismatch"):
        load_train_state_orbax(directory, _template("sgd", True))


_RANK_CODE = """
import os, sys, torch
from fastscnn_tpu_torch.parallel.multihost import initialize_multihost
initialize_multihost(device='cpu')
from fastscnn_tpu_torch.models import FastSCNN
from fastscnn_tpu_torch.parallel import create_train_state, make_optimizer
from fastscnn_tpu_torch.utils import lr_schedule
from fastscnn_tpu_torch.utils.checkpoint import save_train_state_orbax, load_train_state_orbax
from fastscnn_tpu_torch.utils.tree import tree_leaves
torch.manual_seed(0)
opt = make_optimizer('sgd', lr_schedule('poly', base_lr=0.01, niters=10))
state = create_train_state(FastSCNN(2, aux=False), opt, device='cpu')
g = torch.Generator().manual_seed(1)
for p in tree_leaves(state.params):
    state.opt_state.state[p]['momentum_buffer'] = torch.randn(p.shape, generator=g)
state.step = 5
directory = save_train_state_orbax(state, sys.argv[1])
back = load_train_state_orbax(directory, create_train_state(FastSCNN(2, aux=False), opt,
                                                            device='cpu'))
pairs = list(zip(tree_leaves(state.params), tree_leaves(back.params)))
ok = back.step == 5 and all(torch.equal(a, b) for a, b in pairs) and all(
    torch.equal(state.opt_state.state[a]['momentum_buffer'],
                back.opt_state.state[b]['momentum_buffer']) for a, b in pairs)
print('RANK', torch.distributed.get_rank(), ok, len(os.listdir(os.path.join(directory, 'd'))))
torch.distributed.destroy_process_group()
sys.exit(0 if ok else 1)
"""


def test_two_gloo_ranks_save_one_directory_and_both_load_it(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    directory = str(tmp_path / "shared")
    outs = multihost.run_local_group(lambda k: ["-c", _RANK_CODE, directory], 2, 240)
    assert "RANK 0 True 1" in outs[0] and "RANK 1 True 1" in outs[1], outs
    assert sorted(os.listdir(tmp_path)) == ["shared"]


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "orbax_fixture", os.path.join(FIXTURE, "make_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_committed_fixture_reads_back_equal_to_its_regeneration():
    fixture = _fixture_module()
    stats = {}
    tree = read_tree(fixture.STATE, stats)
    want = fixture.arrays(fixture.SEED)
    assert set(tree) == set(want)
    for keys, value in want.items():
        got = tree[keys].view(torch.uint16) if keys[-1] == "half" else tree[keys]
        assert got.numpy().dtype == value.dtype
        np.testing.assert_array_equal(got.numpy(), value)
    assert tree[("params", "half")].dtype == torch.bfloat16
    assert all(stats["zstd"][k] > 0 for k in fixture.COVERAGE)
    assert stats["data_files"] >= 2  # the merged process-0 store's
    sizes = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(fixture.STATE) for f in fs)
    assert sizes <= 512 * 1024
    # the two chunks of the sharded leaf
    store = ocdbt.read_store(fixture.STATE)
    assert {b"params.sharded/0.0", b"params.sharded/1.0"} <= set(store)


def test_the_jax_tree_of_the_port_directory_is_orbax_s(jax_weights, tmp_path):
    """The port's _METADATA lists the leaves JAX's does, in its order, with
    its key types and value types."""
    jstate = _jax_state(jax_weights, "sgd", True, 0)
    jdir = jax_ckpt.save_train_state_orbax(jstate, str(tmp_path / "jax"))
    pdir = save_train_state_orbax(_template("sgd", True), str(tmp_path / "port"))
    meta = [json.load(open(os.path.join(d, "_METADATA"))) for d in (jdir, pdir)]
    assert list(meta[0]["tree_metadata"]) == list(meta[1]["tree_metadata"])
    assert meta[0]["tree_metadata"] == meta[1]["tree_metadata"]
    assert {k: v for k, v in meta[0].items() if k != "tree_metadata"} == {
        k: v for k, v in meta[1].items() if k != "tree_metadata"}
    a, b = (json.load(open(os.path.join(d, "_sharding"))) for d in (jdir, pdir))
    assert sorted(a) == sorted(b)
    a, b = ({(m["array_metadata"]["param_name"], tuple(m["array_metadata"]["write_shape"]))
             for m in json.load(open(os.path.join(d, "array_metadatas", "process_0")))[
                 "array_metadatas"]} for d in (jdir, pdir))
    assert a == b
