"""Write the Orbax fixture with the JAX package's ``save_train_state_orbax``.

    python tests/fixtures/orbax/make_fixture.py

Writes ``state/`` beside this script: the Orbax directory (orbax 0.11,
OCDBT, zarr v2, zstd level 1) of a JAX ``TrainState`` whose leaves are
:func:`arrays` of :data:`SEED`, made with numpy. They are chosen so that
orbax's bytes hold every kind of zstd content the port's decoder reads in
a checkpoint: raw blocks (noise), RLE blocks (a constant), compressed
blocks with Huffman literals in 1 and 4 streams and FSE-coded, predefined
and RLE sequence tables, multi-block frames (more than 128 KiB),
an array in two chunks (sharded over two CPU devices), ``bfloat16``, and
the process-0 store merged at the root. The script checks that coverage
with the port's decoder and fails without it.

:func:`arrays` needs numpy alone: the port's tests and the card's smoke
script load this file to regenerate the leaves and hold the port's reader
to them.
"""

from __future__ import annotations

import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
STATE = os.path.join(HERE, "state")
SEED = 23
COVERAGE = ("raw_blocks", "rle_blocks", "compressed_blocks", "multiblock_frames",
            "huffman_1_stream", "huffman_4_streams", "fse_weights", "predefined_tables",
            "rle_tables", "fse_tables")


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """The bfloat16 bits of f32 values that bfloat16 holds exactly."""
    bits = x.astype(np.float32).view(np.uint32)
    assert not (bits & 0xFFFF).any(), "not exact in bfloat16"
    return (bits >> 16).astype(np.uint16)


def arrays(seed: int = SEED) -> dict:
    """{key path: numpy array} of the fixture's leaves (``bfloat16`` leaves
    as their uint16 bits)."""
    rng = np.random.default_rng(seed)
    # five 128 KiB blocks: three of a random walk, two of zeros (a block
    # all of one byte after the first is an RLE block)
    walk = np.zeros(160 * 1024, np.int32)
    walk[:96 * 1024] = np.cumsum(rng.integers(-3, 4, 96 * 1024))
    return {
        ("params", "noise"): rng.standard_normal(3000).astype(np.float32),
        ("params", "zeros"): np.zeros((64, 64), np.float32),
        ("params", "walk"): walk.reshape(640, 256),
        # 200 bytes of few values: too few literals for four streams
        ("params", "small"): rng.choice(8, 200, p=[.4, .2, .1, .1, .05, .05, .05, .05])
        .astype(np.uint8).view(np.int32),
        ("params", "sharded"): np.round(rng.standard_normal((8, 96)), 1).astype(np.float32),
        ("params", "half"): bf16_bits(rng.integers(-64, 64, (32, 48)) / 8.0),
        ("model_state", "mean"): np.linspace(0.0, 1.0, 256, dtype=np.float32),
        ("opt_state", "0", "mask"): (rng.random(200) < 0.3),
        ("opt_state", "0", "count"): np.int64(12345678901).astype(np.int64).reshape(()),
        ("step",): np.array(7, np.int32),
    }


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=2")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from fastscnn_tpu.parallel.train import TrainState
    from fastscnn_tpu.utils.checkpoint import save_train_state_orbax

    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    leaves = {}
    for keys, a in arrays().items():
        if keys[-1] == "half":
            leaf = jax.lax.bitcast_convert_type(jnp.asarray(a), jnp.bfloat16)
        elif keys[-1] == "sharded":
            leaf = jax.device_put(a, NamedSharding(mesh, P("x")))
        else:
            leaf = jnp.asarray(a)
        node = leaves
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    opt_state = (leaves["opt_state"]["0"],)
    state = TrainState(params=leaves["params"], model_state=leaves["model_state"],
                       opt_state=opt_state, step=leaves["step"])
    shutil.rmtree(STATE, ignore_errors=True)
    save_train_state_orbax(state, STATE)

    from fastscnn_tpu_torch.utils.orbax_tree import read_tree

    stats: dict = {}
    tree = read_tree(STATE, stats)
    for keys, want in arrays().items():
        got = tree[keys]
        got = got.view(__import__("torch").uint16) if keys[-1] == "half" else got
        np.testing.assert_array_equal(got.numpy(), want)
    missing = [k for k in COVERAGE if not stats["zstd"].get(k)]
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(STATE) for f in fs)
    print(f"{STATE}: {size} bytes, zstd {stats['zstd']}")
    if missing:
        raise SystemExit(f"the fixture lacks {missing}")
    if size > 512 * 1024:
        raise SystemExit(f"the fixture takes {size} bytes, more than 512 KiB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
