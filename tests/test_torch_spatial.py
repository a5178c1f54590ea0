"""The port's spatial sharding (the mesh's ``space`` axis) on the CPU: the
exchanges of ``ops/halo.py`` over both transports of
``parallel/spatial.py``, the train and eval steps under (1 × 2) and
(2 × 2) meshes of a 4-rank gloo group, the engine under local meshes, and
the refusals.

The multi-process cases run in one 4-rank gloo group for the module
(``tests/torch_spatial_worker.py`` under ``run_local_group``, one torch
thread a rank, a deadline that kills the group), fed by inputs written
here and held here against JAX and against the port in one process. The
group starts in a thread at the module's first test and runs while the
tests that need no group run; a test that reads the ranks' results does
its own work first.
Bounds:

- the exchanges in f64, on equal blocks and on unequal and empty ones
  (``worker.UNEVEN``): the outputs equal to slices of the zero-padded
  whole tensor, bit for bit, and the block gradients equal to the
  whole-tensor op's within 1e-12 (two halo gradients meet in one sum);
  the block convs and row resizes on every level of H = 72 over 4 and
  64 over 8 equal to the whole-tensor ops (the matmul resize within
  1e-12), their gradients within 1e-10;
- the spatial train step (f32, 'ce' = mix OHEM CE, no dropout) under a
  2 × 2 mesh against JAX's ``make_train_step(mesh=make_mesh(2, 2),
  spatial_shard=True)`` on the global batch, stems 'xla' and 'pallas' (B6
  on each block): loss rtol 1e-5, BN statistics 1e-4, the update within
  relative L2 1e-3 or twice the larger of two yardsticks taken here (JAX's
  spatial mesh step against its one-device step, the port's one-process
  step against JAX's one-device step) — the bounds of
  ``test_torch_multidevice.py::test_dp_train_step_matches_the_jax_mesh_step``;
  the same at H = 72, whose levels below the input split unevenly (JAX's
  GSPMD pads them);
- in f64 the same steps (``grad_accum`` 1 and 2, the 1 × 2 mesh with
  dropout, ``spatial_shard=False`` replicated across ``space``, and at
  H = 72 the 1 × 4 mesh, whose third rank holds no row at 1/32, and
  2 × 2 with ``grad_accum`` 2) equal
  to the port's one-process step on the global batch within 1e-5 (the f32
  masters' rounding), the loss within 1e-6 (it is reported in f32), the
  pyramid pooling's running variances (batch statistics over ``data``
  only, on tensors replicated across ``space``) within 1e-9;
- losses and parameters bit-equal across the ranks;
- the eval step under a ``space`` axis: each rank's masks and the
  statistics equal to one process's on its data place's rows;
- the engine under local meshes of two and four CPU entries (and, at
  H = 72 over 2 and 64 over 8, of two and eight): masks equal to the
  meshless engine on every pixel in f32 (the blocks run the meshless
  graph's arithmetic: same weights, same lerps, convs on the same
  windows), and within ``test_torch_engine.py``'s f32 mask bound (1e-3
  of the pixels) of JAX's spatial engine;
- JAX's refusal: an input H not divisible by the ``space`` axis, in the
  step, the engine and ``block_sharding``.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_spatial_worker as worker
from fastscnn_tpu.engine import E2EConfig as JaxE2EConfig
from fastscnn_tpu.engine import InferenceEngine as JaxEngine
from fastscnn_tpu.losses import get_loss_fn as jax_loss_fn
from fastscnn_tpu.models import FastSCNN as JaxFastSCNN
from fastscnn_tpu.models import init_fast_scnn as jax_init
from fastscnn_tpu.parallel import make_mesh as jax_make_mesh
from fastscnn_tpu.parallel.train import create_train_state as jax_create
from fastscnn_tpu.parallel.train import make_optimizer as jax_optimizer
from fastscnn_tpu.parallel.train import make_split_aug_train_step as jax_split_step
from fastscnn_tpu.parallel.train import make_train_step as jax_train_step
from fastscnn_tpu.utils.lr_scheduler import lr_schedule as jax_lr
from fastscnn_tpu_torch.engine import IMAGENET_MEAN, IMAGENET_STD, E2EConfig, InferenceEngine
from fastscnn_tpu_torch.losses import get_loss_fn
from fastscnn_tpu_torch.models import FastSCNN, from_jax_params, to_param_trees
from fastscnn_tpu_torch.models.fast_scnn import space_levels
from fastscnn_tpu_torch.ops import halo
from fastscnn_tpu_torch.ops.resize import (
    resize_bilinear,
    resize_bilinear_matmul,
    resize_rows,
    resize_rows_matmul,
)
from fastscnn_tpu_torch.parallel import (
    create_train_state,
    make_eval_step,
    make_mesh,
    make_optimizer,
    make_split_aug_train_step,
    make_train_step,
    multihost,
)
from fastscnn_tpu_torch.parallel import spatial
from fastscnn_tpu_torch.parallel.mesh import block_sharding, check_spatial_height
from fastscnn_tpu_torch.utils import lr_schedule

HERE = os.path.dirname(os.path.abspath(__file__))
DEADLINE_S = 240
NC = 5
LR = dict(base_lr=1e-2, niters=10)
SHAPE = (4, 64, 64)  # global batch, H, W: H = 32 · n_space for a space axis of 2
# H = 72: levels of 35, 18, 9, 5 and 3 rows, which split unevenly over 2 and
# 4 (over 4 one rank holds no row at 1/32)
SHAPE_72 = (4, 72, 64)
# name: stem, against JAX's 2 × 2 spatial step in f32
JAX_CASES = {"jax-xla": "xla", "jax-pallas": "pallas"}
JAX_72_CASES = {"jax72-xla": "xla", "jax72-pallas": "pallas"}
# name: (mesh, spatial_shard, stem, grad_accum, dropout), f64 against one process
F64_CASES = {
    "f64-2x2-ga1-pallas": ("2x2", True, "pallas", 1, False),
    "f64-2x2-ga2-xla": ("2x2", True, "xla", 2, False),
    "f64-1x2-ga1-dropout": ("1x2", True, "xla", 1, True),
    "f64-2x2-ga1-replicated": ("2x2", False, "xla", 1, False),
}
F64_72_CASES = {
    "f64-1x4-72-pallas": ("1x4", True, "pallas", 1, False),
    "f64-2x2-72-ga2-xla": ("2x2", True, "xla", 2, False),
}
EXCHANGE_SHAPE = (2, 16, 5, 3)
EXCHANGE_SEED = 11


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, n, h, w, nc=NC):
    """Blocky images whose labels are a function of the block, 10 % ignored
    (``test_torch_multidevice.py``'s)."""
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 256, (n, h // 8, w // 8, 3))
    images = np.clip(low.repeat(8, 1).repeat(8, 2) + rng.integers(-20, 21, (n, h, w, 3)), 0, 255)
    targets = (low[..., 0] * nc // 256).repeat(8, 1).repeat(8, 2).astype(np.int32)
    targets[rng.random(targets.shape) < 0.1] = -1
    return images.astype(np.uint8), targets


@pytest.fixture(scope="module")
def jax_init_trees():
    params, state = jax_init(jax.random.PRNGKey(0), NC, aux=True)
    return jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, state)


class _Group:
    """The 4-rank gloo group, run in a thread: ``work`` (its directory) and
    ``read(rank, name)``, which waits for the group and raises what it
    raised."""

    def __init__(self, work, env):
        self.work, self._error = work, None
        self._thread = threading.Thread(target=self._run, args=(env,), daemon=True)
        self._thread.start()

    def _run(self, env):
        try:
            multihost.run_local_group(
                lambda k: [os.path.join(HERE, "torch_spatial_worker.py"), self.work], 4,
                DEADLINE_S, env=env)
        except BaseException as e:  # noqa: BLE001 - raised again in the reading test
            self._error = e

    def read(self, rank, name):
        self._thread.join(DEADLINE_S + 60)
        assert not self._thread.is_alive(), "the gloo group outlived its deadline"
        if self._error is not None:
            raise self._error
        path = os.path.join(self.work, f"rank{rank}", name)
        if name.endswith(".json"):
            with open(path) as f:
                return json.load(f)
        return np.load(path)


@pytest.fixture(autouse=True, scope="module")
def group(tmp_path_factory, jax_init_trees):
    """The 4-rank gloo group (:class:`_Group`), started at the module's
    first test."""
    work = str(tmp_path_factory.mktemp("spatial"))
    torch.save(from_jax_params(*jax_init_trees), os.path.join(work, "init_a.pt"))
    images, targets = _batch(1, *SHAPE)
    np.savez(os.path.join(work, "batch.npz"), images=images, targets=targets)
    images, targets = _batch(2, *SHAPE_72)
    np.savez(os.path.join(work, "batch72.npz"), images=images, targets=targets)
    images, targets = _batch(4, *SHAPE)
    np.savez(os.path.join(work, "eval.npz"), images=images, targets=targets)
    x = np.random.default_rng(EXCHANGE_SEED).normal(size=EXCHANGE_SHAPE)
    np.savez(os.path.join(work, "exchange.npz"), x=x)
    spec = {"train": [], "exchange_seed": EXCHANGE_SEED}
    for name, stem in JAX_CASES.items():
        spec["train"].append({"name": name, "mesh": "2x2", "spatial": True, "stem": stem,
                              "grad_accum": 1, "dropout": False, "dtype": "float32",
                              "batch": "batch.npz"})
    for name, stem in JAX_72_CASES.items():
        spec["train"].append({"name": name, "mesh": "2x2", "spatial": True, "stem": stem,
                              "grad_accum": 1, "dropout": False, "dtype": "float32",
                              "batch": "batch72.npz"})
    for cases, batch in ((F64_CASES, "batch.npz"), (F64_72_CASES, "batch72.npz")):
        for name, (mesh, sp, stem, ga, dropout) in cases.items():
            spec["train"].append({"name": name, "mesh": mesh, "spatial": sp, "stem": stem,
                                  "grad_accum": ga, "dropout": dropout, "dtype": "float64",
                                  "batch": batch})
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump(spec, f)
    return _Group(work, dict(os.environ, OMP_NUM_THREADS="1"))


def _model(jax_init_trees, **options):
    model = FastSCNN(NC, aux=True, **options)
    model.load_state_dict(from_jax_params(*jax_init_trees))
    return model


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _members(mesh):
    return range(2) if mesh == "1x2" else range(4)


# -- (i) the exchanges over local devices, and the block ops ------------------

def _equal_rows(height, n):
    h = height // n
    return tuple((s * h, (s + 1) * h) for s in range(n))


def _exchange_reference(x, n, rows=None):
    """Per rank, what :func:`worker.exchange_case` must give on blocks
    ``rows`` (default: equal ones): slices of the zero-padded whole tensor,
    and the whole-tensor gradients of the ranks' summed objectives."""
    rows = rows or _equal_rows(x.shape[1], n)
    pad = max(max(a, b) for a, b in worker.HALOS)
    xs = torch.from_numpy(x).requires_grad_()
    padded = F.pad(xs, (0, 0, 0, 0, pad, pad))
    outs = []
    for s, (first, stop) in enumerate(rows):
        ws = worker.exchange_weights(EXCHANGE_SEED, (x.shape[0], stop - first, *x.shape[2:]), n,
                                     s, x.shape[1])
        out = {}
        for k, (a, b) in enumerate(worker.HALOS):
            y = padded[:, pad + first - a:pad + stop + b]
            out[f"halo{k}"] = y
        out["gather"] = xs
        outs.append((out, ws))
    grads = {}
    for key in [f"halo{k}" for k in range(len(worker.HALOS))] + ["gather"]:
        obj = 0.0
        for out, ws in outs:
            k = len(worker.HALOS) if key == "gather" else int(key[4:])
            obj = obj + (out[key] * ws[k]).sum()
        (g,) = torch.autograd.grad(obj, xs, retain_graph=True)
        grads[key] = g.numpy()
    return [{k: v.detach().numpy() for k, v in out.items()} for out, _ in outs], grads


def _check_exchange(got, s, n, x, ref, grads, rows=None):
    a, b = (rows or _equal_rows(x.shape[1], n))[s]
    for key in ref[s]:
        np.testing.assert_array_equal(got[key], ref[s][key], err_msg=key)
        np.testing.assert_allclose(got[f"{key}_grad"], grads[key][:, a:b],
                                   rtol=0, atol=1e-12, err_msg=f"{key} gradient")


def _exchanges_over_local_devices(n, rows=None):
    x = np.random.default_rng(EXCHANGE_SEED).normal(size=EXCHANGE_SHAPE)
    ref, grads = _exchange_reference(x, n, rows)
    blocks = rows or _equal_rows(x.shape[1], n)
    spaces = [sp.at(blocks) for sp in spatial.local_spaces(["cpu"] * n)]

    def rank(s):
        block = torch.from_numpy(x[:, slice(*blocks[s])])
        return worker.exchange_case(spaces[s], block, worker.exchange_weights(
            EXCHANGE_SEED, block.shape, n, s, x.shape[1]))

    for s, got in enumerate(spatial.run_spmd(spaces, rank)):
        _check_exchange(got, s, n, x, ref, grads, rows)


@pytest.mark.parametrize("n", [2, 4])
def test_exchanges_over_local_devices(n):
    _exchanges_over_local_devices(n)


@pytest.mark.parametrize("n", [2, 4])
def test_exchanges_on_unequal_and_empty_blocks_over_local_devices(n):
    """Blocks thinner than the halos (and, over 4, an empty one): each row
    comes from whichever rank holds it, bit for bit."""
    _exchanges_over_local_devices(n, worker.UNEVEN[n])


@pytest.mark.parametrize("op", ["conv-s1", "conv-s2", "conv-stem", "resize", "resize-matmul"])
def test_block_ops_equal_the_whole_tensor_ops(op):
    """``conv_rows`` and the row resizes over 4 local ranks, f64: each
    rank's rows of the whole-tensor op (the stem's 15 output rows split
    4/4/4/3: no rank computes a row past the global output)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 32, 9, 4)))
    w = torch.from_numpy(rng.normal(size=(3, 3, 4, 6)))
    n = 4
    if op.startswith("conv"):
        stride, padding = {"conv-s1": (1, 1), "conv-s2": (2, 1), "conv-stem": (2, 0)}[op]

        def conv(t, w, stride, padding):
            return F.conv2d(t.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride,
                            padding=padding).permute(0, 2, 3, 1)

        want = conv(x, w, stride, padding)
        assert torch.equal(halo.conv_rows(conv, x, w, stride, padding, None), want)

        def fn(t, space):
            return halo.conv_rows(conv, t, w, stride, padding, space)
    else:
        size = (128, 20)
        whole = resize_bilinear if op == "resize" else resize_bilinear_matmul
        rows = resize_rows if op == "resize" else resize_rows_matmul
        want = whole(x, size, align_corners=True)
        # the whole-tensor op with no space axis, the block's rows with one
        assert torch.equal(rows(x, size, None), want)

        def fn(t, space):
            return rows(t, (size[0] // n, size[1]), space,
                        space.at(_equal_rows(size[0], n)))

    spaces = [sp.at(_equal_rows(x.shape[1], n)) for sp in spatial.local_spaces(["cpu"] * n)]
    h = x.shape[1] // n
    got = torch.cat(spatial.run_spmd(spaces, lambda s: fn(x[:, s * h:(s + 1) * h], spaces[s])),
                    dim=1)
    if op == "resize-matmul":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("height,n", [(72, 4), (64, 8)])
def test_block_ops_on_the_network_levels(height, n):
    """``conv_rows`` and the row resizes over the unequal (and, over 8,
    empty) blocks of each level of the network (``space_levels``), f64:
    each rank's rows of the whole-tensor op (the matmul resize within
    1e-12, as above), and the gradients within 1e-10 of the whole-tensor
    op's (a conv's dW summed over the ranks)."""
    rng = np.random.default_rng(3)
    base = spatial.local_spaces(["cpu"] * n)
    levels = [lv.rows for lv in space_levels(torch.zeros(1, height // n, 1, 1),
                                             base[0].at(_equal_rows(height, n)))]
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 4)))

    def conv(t, w, stride, padding):
        return F.conv2d(t.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride,
                        padding=padding).permute(0, 2, 3, 1)

    def check(rows, out_rows, fn, whole, exact=True):
        x = torch.from_numpy(rng.normal(size=(2, rows[-1][1], 5, 3)))
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        want = whole(xs, ws)
        weights = torch.from_numpy(rng.normal(size=want.shape))
        (want * weights).sum().backward()
        spaces = [sp.at(rows) for sp in base]

        def rank(s):
            xb, wb = x[:, slice(*rows[s])].clone().requires_grad_(), w.clone().requires_grad_()
            y = fn(xb, wb, spaces[s])
            (y * weights[:, slice(*out_rows[s])]).sum().backward()
            return y.detach(), xb.grad, wb.grad

        got = spatial.run_spmd(spaces, rank)
        y = torch.cat([g[0] for g in got], 1)
        np.testing.assert_allclose(y.numpy(), want.detach().numpy(), rtol=0,
                                   atol=0 if exact else 1e-12)
        np.testing.assert_allclose(torch.cat([g[1] for g in got], 1).numpy(), xs.grad.numpy(),
                                   rtol=0, atol=1e-10)
        if ws.grad is not None:
            np.testing.assert_allclose(sum(g[2] for g in got).numpy(), ws.grad.numpy(),
                                       rtol=0, atol=1e-10)

    for d, padding in enumerate((0, 1, 1, 1, 1)):
        for stride, pad in ((2, padding), (1, 1)):
            check(levels[d], levels[d + 1] if stride == 2 else levels[d],
                  lambda t, w, sp, st=stride, p=pad: halo.conv_rows(conv, t, w, st, p, sp),
                  lambda t, w, st=stride, p=pad: conv(t, w, st, p))
    for src, dst in ((5, 3), (3, 0)):
        out = levels[dst]
        for rows_fn, whole in ((resize_rows, resize_bilinear),
                               (resize_rows_matmul, resize_bilinear_matmul)):
            check(levels[src], out,
                  lambda t, w, sp, f=rows_fn: f(
                      t, (out[sp.index][1] - out[sp.index][0], 7), sp, sp.at(out)),
                  lambda t, w, f=whole: f(t, (out[-1][1], 7), align_corners=True),
                  exact=rows_fn is resize_rows)


# -- (vi) the engine -----------------------------------------------------------

ENGINE_CONFIGS = {
    "hybrid": dict(),
    "matmul-norm": dict(final_upsample="matmul", mean=IMAGENET_MEAN, std=IMAGENET_STD),
    "internal-gather": dict(internal_size=(128, 160), final_upsample="gather"),
    "nbr-exact": dict(final_upsample="nbr-exact"),
}


@pytest.mark.parametrize("config", list(ENGINE_CONFIGS))
@pytest.mark.parametrize("devices", [2, 4])
def test_spatial_engine_equals_the_meshless_engine(jax_init_trees, config, devices):
    """``InferenceEngine`` under a local mesh with ``space`` 2 (one data
    place of two devices, or two of two): equal on every pixel to the
    meshless engine through ``predict``, ``predict_fn`` and
    ``throughput_fn``, f32."""
    model = _model(jax_init_trees)
    cfg = E2EConfig(compute_dtype="float32", **ENGINE_CONFIGS[config])
    images = np.random.default_rng(6).integers(0, 256, (4, 64, 96, 3)).astype(np.uint8)
    single = InferenceEngine(model, device="cpu", config=cfg)
    mesh = make_mesh(n_space=2, devices=["cpu"] * devices)
    sharded = InferenceEngine(model, config=cfg, mesh=mesh)
    assert len(sharded.replicas) == devices // 2
    want = single.predict(images)
    assert torch.equal(sharded.predict(images), want)
    fn = sharded.predict_fn(images.shape)
    assert torch.equal(fn(images), want) and fn.replays == 1
    loop = sharded.throughput_fn(images.shape, iters=2)
    per = 4 // (devices // 2)
    parts = [single.throughput_fn((per, 64, 96, 3), iters=2)(images[k * per:(k + 1) * per])
             for k in range(devices // 2)]
    assert int(loop(images)) == int(sum(parts))


def test_spatial_engine_against_the_jax_spatial_engine(jax_init_trees):
    """The port's engine on ['cpu'] * 4 (2 × 2) against JAX's engine on a
    2 × 2 mesh (H sharded by GSPMD), f32, the default head."""
    model = _model(jax_init_trees)
    images = np.random.default_rng(7).integers(0, 256, (4, 64, 96, 3)).astype(np.uint8)
    eng = InferenceEngine(model, config=E2EConfig(compute_dtype="float32"),
                          mesh=make_mesh(n_space=2, devices=["cpu"] * 4))
    params, state = jax_init_trees
    jeng = JaxEngine(JaxFastSCNN(num_classes=NC, aux=True), params, state,
                     config=JaxE2EConfig(compute_dtype="float32"),
                     mesh=jax_make_mesh(n_data=2, n_space=2, devices=jax.devices()[:4]))
    diff = np.asarray(jeng.predict(images)) != eng.predict(images).numpy()
    assert diff.mean() <= 1e-3


@pytest.mark.parametrize("devices,height", [(2, 72), (8, 64)])
def test_uneven_spatial_engine_equals_meshless_and_jax(jax_init_trees, devices, height):
    """The engine under a local ``space`` mesh whose levels split unevenly:
    72 rows over 2 (5/4 rows at 1/8, 2/1 at 1/32) and 64 over 8 (six empty
    blocks at 1/32), f32: equal to the meshless engine on every pixel, and
    within 1e-3 of the pixels of JAX's spatial engine on a mesh of as many
    devices."""
    model = _model(jax_init_trees)
    cfg = E2EConfig(compute_dtype="float32")
    images = np.random.default_rng(8).integers(0, 256, (2, height, 96, 3)).astype(np.uint8)
    want = InferenceEngine(model, device="cpu", config=cfg).predict(images)
    sharded = InferenceEngine(model, config=cfg,
                              mesh=make_mesh(n_space=devices, devices=["cpu"] * devices))
    got = sharded.predict(images)
    assert torch.equal(got, want)
    params, state = jax_init_trees
    jeng = JaxEngine(JaxFastSCNN(num_classes=NC, aux=True), params, state,
                     config=JaxE2EConfig(compute_dtype="float32"),
                     mesh=jax_make_mesh(n_data=1, n_space=devices,
                                        devices=jax.devices()[:devices]))
    assert (np.asarray(jeng.predict(images)) != got.numpy()).mean() <= 1e-3


# -- (vii) the refusals and the mesh helpers -----------------------------------

def _raised(fn) -> str:
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_refusals_match_jax(jax_init_trees):
    """Where JAX refuses a mesh or option, the port raises its
    ``ValueError`` with its message."""
    params, state = jax_init_trees
    model = _model(jax_init_trees)
    opt = make_optimizer("sgd")
    loss = get_loss_fn("ce")
    jmodel = JaxFastSCNN(NC, aux=True)
    jopt = jax_optimizer("sgd", 0.01)
    jloss = jax_loss_fn("ce")
    jmesh = jax_make_mesh(n_data=2, n_space=2, devices=jax.devices()[:4])
    mesh = make_mesh(n_space=2, devices=["cpu"] * 4)
    assert (_raised(lambda: make_train_step(model, loss, opt, device_aug=lambda *a: a,
                                            spatial_shard=True, device="cpu"))
            == _raised(lambda: jax_train_step(jmodel, jloss, jopt, device_aug=lambda *a: a,
                                              spatial_shard=True)))
    assert (_raised(lambda: make_split_aug_train_step(model, loss, opt, lambda *a: a,
                                                      mesh=mesh, device="cpu"))
            == _raised(lambda: jax_split_step(jmodel, jloss, jopt, lambda *a: a, mesh=jmesh)))
    for options, cfg in (({"folded_dw_impl": "fused-ds"}, {}),
                         ({"folded_dw_impl": "pallas"}, {}),
                         ({}, {"final_upsample": "hybrid-pallas"}),
                         ({}, {"final_upsample": "pallas"})):
        said = _raised(lambda: InferenceEngine(model.with_options(**options),
                                               config=E2EConfig(**cfg), mesh=mesh))
        jax_said = _raised(lambda: JaxEngine(JaxFastSCNN(NC, aux=True, **options), params,
                                             state, config=JaxE2EConfig(**cfg), mesh=jmesh))
        assert said == jax_said
    # the kernel-free configurations are taken, 'taps' too
    InferenceEngine(model.with_options(folded_dw_impl="taps"), config=E2EConfig(), mesh=mesh)


# -- (ii)-(iv) the train step --------------------------------------------------

def _jax_update(params, state, images, targets, mesh, stem, spatial_shard=False):
    model = JaxFastSCNN(NC, aux=True, dropout_rate=0.0, stem_impl=stem)
    opt = jax_optimizer("sgd", jax_lr("poly", **LR))
    jstate = jax_create(model, opt, params=jax.tree_util.tree_map(jnp.asarray, params),
                        model_state=jax.tree_util.tree_map(jnp.asarray, state))
    step = jax_train_step(model, jax_loss_fn("ce", aux=True, num_classes=NC), opt, mesh=mesh,
                          compute_dtype=jnp.float32, spatial_shard=spatial_shard)
    new, metrics = step(jstate, jnp.asarray(images), jnp.asarray(targets), jax.random.PRNGKey(1))

    def flat(tree):
        return np.concatenate([np.asarray(a).ravel() for a in jax.tree_util.tree_leaves(tree)])

    return float(metrics["loss"]), flat(new.params), flat(new.model_state)


def _port_update(trees, images, targets, ga, stem, dtype=torch.float32, dropout=False):
    """The port's step in one process on the global batch: ``(loss, new
    params, new BN state tree)``."""
    model = FastSCNN(NC, aux=True, dropout_rate=0.1 if dropout else 0.0, stem_impl=stem)
    model.load_state_dict(from_jax_params(*trees))
    opt = make_optimizer("sgd", lr_schedule("poly", **LR))
    state = create_train_state(model, opt, device="cpu")
    step = make_train_step(model, get_loss_fn("ce", aux=True, num_classes=NC), opt,
                           compute_dtype=dtype, grad_accum=ga, device="cpu")
    gen = torch.Generator().manual_seed(5) if dropout else None
    state, metrics = step(state, images, targets, gen)
    return float(metrics["loss"]), worker.flat(state.params), state.model_state


def _ppm_vars(model_state) -> np.ndarray:
    ppm = model_state["global_feature_extractor"]["ppm"]
    return np.concatenate([ppm[f"conv{i}"]["bn"]["var"].numpy() for i in range(1, 5)])


def _same_on_every_rank(read, name, ranks):
    got = [read(k, f"train_{name}.npz") for k in ranks]
    for g in got[1:]:
        assert float(g["loss"]).hex() == float(got[0]["loss"]).hex()
        np.testing.assert_array_equal(g["params"], got[0]["params"])
        np.testing.assert_array_equal(g["bn"], got[0]["bn"])
    return got[0]


def _against_the_jax_spatial_step(group, jax_init_trees, case, stem, batch_file):
    params, state = jax_init_trees
    batch = np.load(os.path.join(group.work, batch_file))
    mesh = jax_make_mesh(n_data=2, n_space=2, devices=jax.devices()[:4])
    loss, new, bn = _jax_update(params, state, batch["images"], batch["targets"], mesh, stem,
                                spatial_shard=True)
    p0 = np.concatenate([np.asarray(a).ravel() for a in jax.tree_util.tree_leaves(params)])
    _, one, _ = _jax_update(params, state, batch["images"], batch["targets"], None, stem)
    _, port, _ = _port_update(jax_init_trees, batch["images"], batch["targets"], 1, stem)
    yard = max(_rel(new - p0, one - p0), _rel(port - p0, one - p0))
    got = _same_on_every_rank(group.read, case, range(4))
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-5)
    np.testing.assert_allclose(got["bn"], bn, rtol=1e-4, atol=1e-4)
    assert _rel(got["params"] - p0, new - p0) <= max(1e-3, 2 * yard), yard


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_spatial_train_step_matches_the_jax_spatial_mesh_step(group, jax_init_trees, case):
    """4 gloo ranks, each its (rows, H rows) block, against JAX's 2 × 2
    spatial step on the global batch; stem 'pallas' runs B6's plain
    versions on each block."""
    _against_the_jax_spatial_step(group, jax_init_trees, case, JAX_CASES[case], "batch.npz")


@pytest.mark.parametrize("case", list(JAX_72_CASES))
def test_uneven_spatial_train_step_matches_the_jax_spatial_mesh_step(group, jax_init_trees,
                                                                     case):
    """H = 72 under 2 × 2, which JAX's GSPMD pads at every level below the
    input: the port's unequal blocks (18/17 rows at 1/2, 5/4 at 1/8, 2/1 at
    1/32) against JAX's step, the bounds above."""
    _against_the_jax_spatial_step(group, jax_init_trees, case, JAX_72_CASES[case],
                                  "batch72.npz")


def _f64_against_one_process(group, jax_init_trees, case, spec, batch_file):
    mesh, _, stem, ga, dropout = spec
    batch = np.load(os.path.join(group.work, batch_file))
    p0 = worker.flat(to_param_trees(_model(jax_init_trees))[0])
    loss, one, one_state = _port_update(jax_init_trees, batch["images"], batch["targets"], ga,
                                        stem, torch.float64, dropout)
    got = _same_on_every_rank(group.read, case, _members(mesh))
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=1e-6)
    assert _rel(got["params"] - p0, one - p0) <= 1e-5
    np.testing.assert_allclose(got["bn"], worker.flat(one_state), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["ppm_var"], _ppm_vars(one_state), rtol=1e-9)


@pytest.mark.parametrize("case", list(F64_CASES))
def test_spatial_train_step_in_f64_equals_one_process(group, jax_init_trees, case):
    """In f64 the spatial step (and the step replicated across ``space``)
    equals the port's one-process step on the global batch: the update, the
    loss, the pyramid pooling's running variances (over ``data`` only) and,
    with dropout, the mask (the global batch's, drawn from one generator,
    each rank keeping its block)."""
    _f64_against_one_process(group, jax_init_trees, case, F64_CASES[case], "batch.npz")


@pytest.mark.parametrize("case", list(F64_72_CASES))
def test_uneven_spatial_train_step_in_f64_equals_one_process(group, jax_init_trees, case):
    """H = 72 in f64: under 1 × 4 (blocks of 9/9/9/8 rows at 1/2, 3/2/2/2 at
    1/8, 1/1/0/1 at 1/32: a rank with no row, stem 'pallas' with B6's plain
    versions on the blocks) and under 2 × 2 with ``grad_accum`` 2, equal to
    one process's step within the bounds above."""
    _f64_against_one_process(group, jax_init_trees, case, F64_72_CASES[case], "batch72.npz")


# -- (v) the eval step ---------------------------------------------------------

@pytest.mark.parametrize("mesh", ["2x2", "1x2"])
def test_eval_under_a_space_axis_equals_one_process(group, jax_init_trees, mesh):
    """Replicated across ``space``: every rank returns its data place's
    masks, and the statistics summed over ``data``."""
    batch = np.load(os.path.join(group.work, "eval.npz"))
    model = _model(jax_init_trees)
    params, state = to_param_trees(model)
    step = make_eval_step(model, NC, compute_dtype=torch.float32, device="cpu")
    pred, stats = step(params, state, batch["images"], batch["targets"])
    n_data, n_space = worker.MESHES[mesh]
    per = SHAPE[0] // n_data
    for rank in _members(mesh):
        got = group.read(rank, f"eval_{mesh}.npz")
        d = rank // n_space
        np.testing.assert_array_equal(got["pred"], pred[d * per:(d + 1) * per].numpy())
        for name, s in zip(("correct", "labeled", "inter", "union"), stats):
            np.testing.assert_array_equal(got[name], s.numpy(), err_msg=name)


# -- (i) the exchanges over a process group ----------------------------------

@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_exchanges_over_a_process_group(group, mesh):
    x = np.load(os.path.join(group.work, "exchange.npz"))["x"]
    n = worker.MESHES[mesh][1]
    ref, grads = _exchange_reference(x, n)
    for rank in range(4):
        _check_exchange(group.read(rank, f"exchange_{mesh}.npz"), rank % n, n, x, ref, grads)


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_exchanges_on_unequal_and_empty_blocks_over_a_process_group(group, mesh):
    """As over local devices: gloo's ``all_gather`` of pieces padded to one
    size."""
    x = np.load(os.path.join(group.work, "exchange.npz"))["x"]
    n = worker.MESHES[mesh][1]
    rows = worker.UNEVEN[n]
    ref, grads = _exchange_reference(x, n, rows)
    for rank in range(4):
        _check_exchange(group.read(rank, f"exchange_{mesh}_uneven.npz"), rank % n, n, x, ref,
                        grads, rows)


def test_spatial_height_constraint_and_the_mesh_helpers(jax_init_trees, group):
    """JAX's condition: an input H divisible by the ``space`` axis, and no
    other. H = 96 under 2 (not a multiple of 32 · 2) runs; H = 45 under 2
    is refused, by the train step (blocks of 23 and 22 rows), the engine
    and ``block_sharding``, with a message that names both numbers."""
    check_spatial_height(96, 2)
    check_spatial_height(72, 4)
    check_spatial_height(45, 1)
    with pytest.raises(ValueError, match="divisible by n_space = 2, got H=45"):
        check_spatial_height(45, 2)
    model = _model(jax_init_trees)
    eng = InferenceEngine(model, config=E2EConfig(compute_dtype="float32"),
                          mesh=make_mesh(n_space=2, devices=["cpu"] * 2))
    assert eng.predict(np.zeros((1, 96, 64, 3), np.uint8)).shape == (1, 96, 64)
    with pytest.raises(ValueError, match="divisible by n_space = 2, got H=45"):
        eng.predict(np.zeros((1, 45, 64, 3), np.uint8))
    for rank in range(4):
        said = group.read(rank, "refusals.json")
        assert "divisible by n_space = 2, got H=45" in said["height"]
        assert np.isfinite(said["h96_loss"])
        assert (said["left_out"] is None) == (rank < 2)
        if rank >= 2:
            assert "not in the mesh" in said["left_out"]
    mesh = make_mesh(n_space=2, devices=["cpu"] * 4)
    blocks = block_sharding(mesh, 4, 64)
    assert blocks == [(slice(0, 2), slice(0, 32)), (slice(0, 2), slice(32, 64)),
                      (slice(2, 4), slice(0, 32)), (slice(2, 4), slice(32, 64))]
    with pytest.raises(ValueError, match="must divide the data axis"):
        block_sharding(mesh, 3, 64)
    with pytest.raises(ValueError, match="divisible by n_space = 2, got H=45"):
        block_sharding(mesh, 4, 45)
