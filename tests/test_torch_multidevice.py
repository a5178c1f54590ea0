"""The port's data-parallel steps and engine under a mesh on the CPU: the
train, eval and device-aug steps over a 2-rank gloo group, the losses, the
trainer CLI over two ranks, the engine's replicas and the refusals
(``tests/test_torch_multihost.py`` has the plumbing, the server,
``multihost_smoke`` and ``dryrun_multichip``).

The multi-process cases run in one 2-rank gloo group per module
(``tests/torch_multidevice_worker.py`` under ``run_local_group``, one
torch thread a rank, a deadline that kills the group), fed by inputs
written here and held here against JAX and against the port in one
process. Bounds:

- a dp train step against JAX's ``make_train_step(mesh=...)`` on the same
  global batch, f32, 'ce' (mix OHEM CE), no dropout: loss rtol 1e-5 and BN
  statistics 1e-4 (``tests/test_torch_train_step.py``'s); the param update
  within relative L2 1e-3 (that file's bound), or twice the larger of two
  yardsticks taken in the same test where that is larger: JAX's mesh step
  against its one-device step, and the port's one-process step against
  JAX's one-device step. Batch-stat BN over few values a channel (1/32
  maps of 1x1 to 2x3) turns f32 rounding into update differences of 3e-3
  to 1e-2 at these sizes, for JAX against itself too (measured);
- the same dp step in f64 compute, where that chaos is gone, equal to the
  port's one-process step on the global batch within 1e-5 (the f32
  masters' rounding), for grad_accum 1 and 2;
- the losses and parameters bit-equal across the ranks;
- the losses of the group equal one process's on the global batch within
  f32 reassociation (rtol 1e-6), and each rank's logit gradient N times
  its rows of one process's (autograd differentiates the N ranks' copies
  of the replicated loss; the step divides the summed gradients by N);
- device augmentation: each rank's crops equal one process's on the
  global batch (masks exactly, f32 images within 1e-4), and the dp step
  with the chain against one process's: in f64 within 1e-5, in f32 within
  1e-3 or 4 times that step's own f32-to-f64 distance;
- eval statistics and masks exactly equal to one process's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_multidevice_worker as worker
from fastscnn_tpu.engine import E2EConfig as JaxE2EConfig
from fastscnn_tpu.engine import InferenceEngine as JaxEngine
from fastscnn_tpu.losses import get_loss_fn as jax_loss_fn
from fastscnn_tpu.models import FastSCNN as JaxFastSCNN
from fastscnn_tpu.models import init_fast_scnn as jax_init
from fastscnn_tpu.parallel import make_mesh as jax_make_mesh
from fastscnn_tpu.parallel.train import create_train_state as jax_create
from fastscnn_tpu.parallel.train import make_optimizer as jax_optimizer
from fastscnn_tpu.parallel.train import make_train_step as jax_train_step
from fastscnn_tpu.utils.lr_scheduler import lr_schedule as jax_lr
from fastscnn_tpu_torch.engine import E2EConfig, InferenceEngine
from fastscnn_tpu_torch.losses import get_loss_fn
from fastscnn_tpu_torch.models import FastSCNN, from_jax_params, to_param_trees
from fastscnn_tpu_torch.parallel import (
    Mesh,
    create_train_state,
    make_eval_step,
    make_mesh,
    make_optimizer,
    make_split_aug_train_step,
    make_train_step,
    multihost,
)
from fastscnn_tpu_torch.utils import lr_schedule

HERE = os.path.dirname(os.path.abspath(__file__))
DEADLINE_S = 300
NC = 5
LR = dict(base_lr=1e-2, niters=10)
# name: (JAX mesh devices, global batch, H, W, grad_accum, stem)
TRAIN_CASES = {
    "mesh8-ga1-xla": (8, 16, 32, 32, 1, "xla"),
    "mesh8-ga2-pallas": (8, 16, 32, 32, 2, "pallas"),
    "mesh2-ga1-pallas": (2, 4, 64, 96, 1, "pallas"),
    "mesh2-ga2-xla": (2, 4, 64, 96, 2, "xla"),
}
# name: (global batch, H, W, grad_accum, stem), f64 compute, against the port in one process
F64_CASES = {
    "f64-ga1-xla": (8, 64, 96, 1, "xla"),
    "f64-ga2-pallas": (8, 64, 96, 2, "pallas"),
}
LOSS_SHAPE = (4, 32, 32, NC)
AUG = dict(batch=8, h=96, w=128, base=96, crop=64)
EVAL_SHAPE = (4, 64, 96)
CITYS_VALID = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, n, h, w, nc=NC):
    """Blocky images whose labels are a function of the block (so the
    gradient is not a sum of cancelling noise), 10 % ignored."""
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 256, (n, h // 8, w // 8, 3))
    images = np.clip(low.repeat(8, 1).repeat(8, 2) + rng.integers(-20, 21, (n, h, w, 3)), 0, 255)
    targets = (low[..., 0] * nc // 256).repeat(8, 1).repeat(8, 2).astype(np.int32)
    targets[rng.random(targets.shape) < 0.1] = -1
    return images.astype(np.uint8), targets


def _citys_tree(root):
    rng = np.random.default_rng(0)
    palette = rng.integers(0, 256, (len(CITYS_VALID), 3))
    for split, n in (("train", 4), ("val", 2)):
        for d in ("leftImg8bit", "gtFine"):
            os.makedirs(os.path.join(root, d, split, "c"))
        for i in range(n):
            cls = rng.integers(0, len(CITYS_VALID), (4, 8)).repeat(16, 0).repeat(16, 1)
            img = np.clip(palette[cls] + rng.integers(-20, 21, (64, 128, 3)), 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(
                os.path.join(root, "leftImg8bit", split, "c", f"c_{i:06d}_leftImg8bit.png"))
            Image.fromarray(np.array(CITYS_VALID)[cls].astype(np.uint8)).save(
                os.path.join(root, "gtFine", split, "c", f"c_{i:06d}_gtFine_labelIds.png"))


@pytest.fixture(scope="module")
def jax_init_trees():
    params, state = jax_init(jax.random.PRNGKey(0), NC, aux=True)
    return jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, state)


@pytest.fixture(scope="module")
def group(tmp_path_factory, jax_init_trees):
    """The 2-rank gloo group's results: ``(work dir, read(rank, name))``."""
    work = str(tmp_path_factory.mktemp("group"))
    torch.save(from_jax_params(*jax_init_trees), os.path.join(work, "init_a.pt"))
    spec = {"train": [], "loss_seed": 3, "loss_shape": LOSS_SHAPE, "aug_batch": "aug.npz",
            "aug_base": AUG["base"], "aug_crop": AUG["crop"], "aug_init": "a",
            "eval_init": "a", "eval_batch": "eval.npz"}
    for name, (_, n, h, w, ga, stem) in TRAIN_CASES.items():
        images, targets = _batch(1, n, h, w)
        np.savez(os.path.join(work, f"{name}.npz"), images=images, targets=targets)
        spec["train"].append({"name": name, "init": "a", "batch": f"{name}.npz",
                              "grad_accum": ga, "stem": stem, "dtype": "float32"})
    for name, (n, h, w, ga, stem) in F64_CASES.items():
        images, targets = _batch(1, n, h, w)
        np.savez(os.path.join(work, f"{name}.npz"), images=images, targets=targets)
        spec["train"].append({"name": name, "init": "a", "batch": f"{name}.npz",
                              "grad_accum": ga, "stem": stem, "dtype": "float64"})
    images, targets = _batch(2, AUG["batch"], AUG["h"], AUG["w"])
    np.savez(os.path.join(work, "aug.npz"), images=images, targets=targets)
    images, targets = _batch(4, *EVAL_SHAPE)
    np.savez(os.path.join(work, "eval.npz"), images=images, targets=targets)
    tree = os.path.join(work, "citys")
    _citys_tree(tree)
    spec["trainer_argv"] = [
        "--device", "cpu", "--dataset", "citys", "--data-root", tree, "--base-size", "64",
        "--crop-size", "48", "--batch-size", "4", "--epochs", "1", "--aux", "--loss-type", "ce",
        "--device-aug", "--num-workers", "1", "--no-val", "--no-fp16", "--print-interval", "1",
        "--save-folder", os.path.join(work, "weights")]
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    multihost.run_local_group(lambda k: [os.path.join(HERE, "torch_multidevice_worker.py"),
                                         work], 2, DEADLINE_S, env=env)

    def read(rank, name):
        path = os.path.join(work, f"rank{rank}", name)
        if name.endswith(".json"):
            with open(path) as f:
                return json.load(f)
        return np.load(path)

    return work, read


def _jax_update(params, state, images, targets, mesh, ga, stem):
    model = JaxFastSCNN(NC, aux=True, dropout_rate=0.0, stem_impl=stem)
    opt = jax_optimizer("sgd", jax_lr("poly", **LR))
    jstate = jax_create(model, opt, params=jax.tree_util.tree_map(jnp.asarray, params),
                        model_state=jax.tree_util.tree_map(jnp.asarray, state))
    step = jax_train_step(model, jax_loss_fn("ce", aux=True, num_classes=NC), opt, mesh=mesh,
                          compute_dtype=jnp.float32, grad_accum=ga)
    new, metrics = step(jstate, jnp.asarray(images), jnp.asarray(targets), jax.random.PRNGKey(1))

    def flat(tree):
        return np.concatenate([np.asarray(a).ravel() for a in jax.tree_util.tree_leaves(tree)])

    return float(metrics["loss"]), flat(new.params), flat(new.model_state)


def jax_tree_leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _port_update(trees, images, targets, ga, stem, dtype=torch.float32, aug=None,
                 split=False):
    """The port's step in one process on the global batch: ``(loss, new
    params)``."""
    model = FastSCNN(NC, aux=True, dropout_rate=0.0, stem_impl=stem)
    model.load_state_dict(from_jax_params(*trees))
    opt = make_optimizer("sgd", lr_schedule("poly", **LR))
    state = create_train_state(model, opt, device="cpu")
    loss_fn = get_loss_fn("ce", aux=True, num_classes=NC)
    kwargs = dict(compute_dtype=dtype, grad_accum=ga, device="cpu")
    if split:
        step = make_split_aug_train_step(model, loss_fn, opt, aug, **kwargs)
    else:
        step = make_train_step(model, loss_fn, opt, device_aug=aug, **kwargs)
    state, metrics = step(state, images, targets, None,
                          None if aug is None else torch.Generator().manual_seed(11))
    return float(metrics["loss"]), worker.flat(state.params)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_dp_train_step_matches_the_jax_mesh_step(group, jax_init_trees, case):
    """2 gloo ranks, each its host_shard rows, against JAX's dp mesh step
    on the global batch (grad_accum 1 and 2: JAX's microbatch i is the
    global rows [i·mb, (i+1)·mb), which the port's step regroups)."""
    work, read = group
    n_dev, _, _, _, ga, stem = TRAIN_CASES[case]
    params, state = jax_init_trees
    batch = np.load(os.path.join(work, f"{case}.npz"))
    ranks = [read(k, f"train_{case}.npz") for k in range(2)]
    assert float(ranks[0]["loss"]).hex() == float(ranks[1]["loss"]).hex()
    np.testing.assert_array_equal(ranks[0]["params"], ranks[1]["params"])
    np.testing.assert_array_equal(ranks[0]["bn"], ranks[1]["bn"])
    loss, new, bn = _jax_update(params, state, batch["images"], batch["targets"],
                                jax_make_mesh(n_data=n_dev), ga, stem)
    np.testing.assert_allclose(float(ranks[0]["loss"]), loss, rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["bn"], bn, rtol=1e-4, atol=1e-4)
    p0 = np.concatenate([np.asarray(a).ravel() for a in jax_tree_leaves(params)])
    # the yardsticks: JAX's mesh step against its one-device step, and the
    # port's one-process step against that one-device step
    _, one, _ = _jax_update(params, state, batch["images"], batch["targets"], None, ga, stem)
    _, port = _port_update(jax_init_trees, batch["images"], batch["targets"], ga, stem)
    yard = max(_rel(new - p0, one - p0), _rel(port - p0, one - p0))
    assert _rel(ranks[0]["params"] - p0, new - p0) <= max(1e-3, 2 * yard), yard


@pytest.mark.parametrize("case", list(F64_CASES))
def test_dp_train_step_in_f64_equals_one_process(group, jax_init_trees, case):
    """In f64 compute the f32 chaos of batch-stat BN is gone: the 2-rank
    step equals the port's one-process step on the global batch to the
    rounding of the f32 masters (the loss, reported in f32, to 1e-6)."""
    work, read = group
    _, _, _, ga, stem = F64_CASES[case]
    batch = np.load(os.path.join(work, f"{case}.npz"))
    ranks = [read(k, f"train_{case}.npz") for k in range(2)]
    np.testing.assert_array_equal(ranks[0]["params"], ranks[1]["params"])
    p0 = worker.flat(to_param_trees(_model(jax_init_trees))[0])
    loss, one = _port_update(jax_init_trees, batch["images"], batch["targets"], ga, stem,
                             torch.float64)
    # the step reports its loss in f32
    np.testing.assert_allclose(float(ranks[0]["loss"]), loss, rtol=1e-6)
    assert _rel(ranks[0]["params"] - p0, one - p0) <= 1e-5


def test_losses_are_bit_equal_across_ranks_and_equal_one_process(group):
    _, read = group
    hexes = [read(k, "losses.json") for k in range(2)]
    grads = [read(k, "losses.npz") for k in range(2)]
    assert hexes[0] == hexes[1]
    rng = np.random.default_rng(3)
    n, h, w, c = LOSS_SHAPE
    logits = torch.from_numpy(rng.normal(size=(n, h // 4, w // 4, c)).astype(np.float32))
    binary = torch.from_numpy(rng.normal(size=(n, h // 4, w // 4, 2)).astype(np.float32))
    target = torch.from_numpy(rng.integers(-1, c, (n, h, w)).astype(np.int32))
    target01 = torch.from_numpy(rng.integers(0, 2, (n, h, w)).astype(np.int32))
    cases = worker.seg_cases(logits, binary, target, target01)
    assert {name for name, *_ in cases} == set(hexes[0])
    for name, fn, lg, tg in cases:
        lg = lg.clone().requires_grad_()
        loss = fn(lg, tg)
        loss.backward()
        np.testing.assert_allclose(float.fromhex(hexes[0][name]), float(loss.detach()), rtol=1e-6,
                                   err_msg=name)
        got = np.concatenate([grads[0][name], grads[1][name]])
        np.testing.assert_allclose(got, 2 * lg.grad.numpy(), rtol=1e-5, atol=1e-9, err_msg=name)


def test_device_aug_under_dp_draws_the_global_batch(group):
    """Each rank's crops are its rows of one process's crops of the global
    batch, every chain."""
    work, read = group
    batch = np.load(os.path.join(work, "aug.npz"))
    spec = {"aug_base": AUG["base"], "aug_crop": AUG["crop"]}
    got = [read(k, "aug.npz") for k in range(2)]
    for name, aug in worker.chains(spec).items():
        img, mask = aug(torch.from_numpy(batch["images"]), torch.from_numpy(batch["targets"]),
                        torch.Generator().manual_seed(7))
        np.testing.assert_array_equal(
            np.concatenate([g[f"{name}_mask"] for g in got]), mask.numpy(), err_msg=name)
        np.testing.assert_allclose(np.concatenate([g[f"{name}_img"] for g in got]),
                                   img.numpy(), atol=1e-4, err_msg=name)


@pytest.mark.parametrize("split", [False, True])
def test_device_aug_step_under_dp_matches_one_process(group, jax_init_trees, split):
    """The dp step with the PSP chain (grad_accum 2; fused: a draw a
    microbatch, split: one for the batch) against the port's step in one
    process on the global batch with the same generator: in f64 to the
    masters' rounding (the loss, reported in f32, to 1e-6); in f32 the
    loss to 1e-5 and the update within 1e-3, or 4 times the one-process
    step's own f32-to-f64 distance where that is larger (chip_smoke.py's
    step yardstick)."""
    work, read = group
    batch = np.load(os.path.join(work, "aug.npz"))
    psp = worker.chains({"aug_base": AUG["base"], "aug_crop": AUG["crop"]})["psp"]
    p0 = worker.flat(to_param_trees(_model(jax_init_trees))[0])
    one = {}
    for dtype in ("float32", "float64"):
        ranks = [read(k, f"aug_step_{int(split)}_{dtype}.npz") for k in range(2)]
        np.testing.assert_array_equal(ranks[0]["params"], ranks[1]["params"])
        loss, one[dtype] = _port_update(jax_init_trees, batch["images"], batch["targets"], 2,
                                        "xla", getattr(torch, dtype), psp, split)
        got = ranks[0]["params"] - p0
        if dtype == "float64":
            # the step reports its loss in f32
            np.testing.assert_allclose(float(ranks[0]["loss"]), loss, rtol=1e-6)
            assert _rel(got, one[dtype] - p0) <= 1e-5
        else:
            np.testing.assert_allclose(float(ranks[0]["loss"]), loss, rtol=1e-5)
            f32 = got
    yard = _rel(one["float32"] - p0, one["float64"] - p0)
    assert _rel(f32, one["float32"] - p0) <= max(1e-3, 4 * yard), yard


def test_eval_under_the_mesh_equals_one_process(group, jax_init_trees):
    work, read = group
    batch = np.load(os.path.join(work, "eval.npz"))
    model = FastSCNN(NC, aux=True, dropout_rate=0.0)
    model.load_state_dict(from_jax_params(*jax_init_trees))
    params, state = to_param_trees(model)
    ranks = [read(k, "eval.npz") for k in range(2)]
    for per_sample in (0, 1):
        step = make_eval_step(model, NC, compute_dtype=torch.float32, device="cpu",
                              per_sample_stats=bool(per_sample))
        pred, stats = step(params, state, batch["images"], batch["targets"])
        np.testing.assert_array_equal(
            np.concatenate([r[f"pred_{per_sample}"] for r in ranks]), pred.numpy())
        for name, s in zip(("correct", "labeled", "inter", "union"), stats):
            for r in ranks:
                np.testing.assert_array_equal(r[f"{name}_{per_sample}"], s.numpy(),
                                              err_msg=f"{name} per_sample={per_sample}")


def test_refusals_under_a_gloo_group(group):
    _, read = group
    said = [read(k, "refusals.json") for k in range(2)]
    for s in said:
        assert "gloo" in s["graph_gloo"] and "gloo" in s["eval_graph_gloo"]
    assert said[0]["odd_mesh"] == [1, 0] and said[1]["odd_mesh"] == [1, None]
    assert said[0]["left_out"] is None
    assert "not in the mesh" in said[1]["left_out"]


def test_trainer_cli_over_two_ranks(group):
    """``train.main`` in both ranks: the mesh over the world, each rank's
    loader its half of each global batch, equal states, and the logs and
    checkpoints written by the primary only (rank 1's directory holds no
    ``logs/``)."""
    work, read = group
    runs = [read(k, "trainer.json") for k in range(2)]
    assert runs[0]["params"] == runs[1]["params"] and runs[0]["step"] == runs[1]["step"] == 1
    assert [r["shard"] for r in runs] == [[0, 2], [1, 2]]
    assert runs[0]["mesh"] == {"data": 2, "space": 1}
    assert os.path.exists(os.path.join(work, "rank0", "logs", "training_log_citys.json"))
    assert not os.path.exists(os.path.join(work, "rank1", "logs"))
    assert os.path.exists(os.path.join(work, "weights", "train_state_citys.pt"))


def _model(jax_init_trees, **options):
    model = FastSCNN(NC, aux=True, **options)
    model.load_state_dict(from_jax_params(*jax_init_trees))
    return model


def test_spatial_sharding_and_local_meshes_refuse_the_steps(jax_init_trees):
    """Spatial sharding is ported (``tests/test_torch_spatial.py``): without
    a mesh ``spatial_shard`` is the plain step, as in JAX; a local mesh with
    a space axis refuses the steps as any local mesh of several devices
    does (a step runs one process a device) and serves; the split step
    refuses a space axis with JAX's error."""
    model = _model(jax_init_trees)
    opt = make_optimizer("sgd")
    loss = get_loss_fn("ce")
    sp = make_mesh(n_data=1, n_space=2, devices=["cpu", "cpu"])
    images, targets = _batch(5, 2, 32, 32)
    losses = [float(make_train_step(model, loss, opt, spatial_shard=shard, device="cpu")(
        create_train_state(model, opt, device="cpu"), images, targets)[1]["loss"])
        for shard in (False, True)]
    assert losses[0] == losses[1] and np.isfinite(losses[0])
    for build in (lambda: make_train_step(model, loss, opt, mesh=sp, device="cpu"),
                  lambda: make_eval_step(model, NC, mesh=sp, device="cpu")):
        with pytest.raises(ValueError, match="one process a device"):
            build()
    with pytest.raises(ValueError, match="device_aug is incompatible with spatial sharding"):
        make_split_aug_train_step(model, loss, opt, lambda *a: a, mesh=sp, device="cpu")
    cfg = E2EConfig(compute_dtype="float32")
    frames = np.random.default_rng(8).integers(0, 256, (1, 64, 64, 3)).astype(np.uint8)
    assert torch.equal(InferenceEngine(model, config=cfg, mesh=sp).predict(frames),
                       InferenceEngine(model, device="cpu", config=cfg).predict(frames))
    local = make_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="one process a device"):
        make_train_step(model, loss, opt, mesh=local, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        make_eval_step(model, NC, mesh=object(), device="cpu")
    # a mesh of one device is the single-device step
    one = make_mesh(devices=["cpu"])
    state = create_train_state(model, opt, device="cpu")
    images, targets = _batch(5, 2, 32, 32)
    assert np.isfinite(float(make_train_step(model, loss, opt, mesh=one, device="cpu")(
        state, images, targets)[1]["loss"]))
    pg = Mesh(("cpu", "cpu"), {"data": 2, "space": 1}, group=object(), ranks=(0, 1), index=0)
    with pytest.raises(ValueError, match="local mesh"):
        InferenceEngine(model, config=E2EConfig(), mesh=pg)


def test_engine_replicas_equal_one_engine_and_the_jax_mesh_engine(jax_init_trees):
    """InferenceEngine over devices ['cpu', 'cpu'] against the single
    engine (equal on every pixel, through predict, predict_fn and
    throughput_fn) and against JAX's engine on an 8-device mesh (the f32
    mask bound of ``tests/test_torch_engine.py``)."""
    model = _model(jax_init_trees)
    cfg = E2EConfig(compute_dtype="float32")
    images = np.random.default_rng(6).integers(0, 256, (8, 64, 96, 3)).astype(np.uint8)
    single = InferenceEngine(model, device="cpu", config=cfg)
    mesh = make_mesh(devices=["cpu", "cpu"])
    sharded = InferenceEngine(model, config=cfg, mesh=mesh)
    assert len(sharded.replicas) == 2 and sharded.replicas[1].folded is not single.folded
    want = single.predict(images)
    assert torch.equal(sharded.predict(images), want)
    fn = sharded.predict_fn(images.shape)
    assert torch.equal(fn(images), want) and fn.replays == 1
    assert fn is sharded.predict_fn(images.shape)
    loop = sharded.throughput_fn(images.shape, iters=2)
    halves = [single.throughput_fn((4, 64, 96, 3), iters=2)(images[k * 4:(k + 1) * 4])
              for k in range(2)]
    assert int(loop(images)) == int(sum(halves))
    with pytest.raises(ValueError, match="must divide the data axis"):
        sharded.predict(images[:3])
    params, state = jax_init_trees
    jeng = JaxEngine(JaxFastSCNN(num_classes=NC, aux=True), params, state,
                     config=JaxE2EConfig(compute_dtype="float32"), mesh=jax_make_mesh(n_data=8))
    diff = np.asarray(jeng.predict(images)) != want.numpy()
    assert diff.mean() <= 1e-3
