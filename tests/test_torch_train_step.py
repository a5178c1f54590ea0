"""One train step of the port against one of the JAX package's, from one
JAX initialisation: 19 classes, aux head, the 'ce' loss (mix OHEM CE
with the Cityscapes class weights), poly LR, f32 compute, dropout off on
both sides (its masks come from each framework's own RNG).

The JAX step is ``make_train_step(..., jit=False)`` under ``jax.jit``.

Tolerances, after one step (``tests/test_training_parity.py`` explains
why batch-stat BN makes longer trajectories chaotic):
- loss: rtol 1e-5;
- BN running statistics: 1e-4;
- a step from the JAX trainer's ``.npz`` state (one JAX step's optimizer
  state and step count over the starting weights) is held to the same
  bounds, its Δp taken from the loaded params (which equal the file's
  exactly);
- params: the update Δp = p₁ − p₀ of all params as one vector, relative
  L2 distance ≤ 1e-3 for SGD. AdamW's first update is ≈ lr·sign(g), so an
  element whose gradient is rounding noise (biases ahead of a BN, whose
  exact gradient is 0) may flip sign: ≤ 5e-2 there, and ≥ 95 % of the
  elements within lr/100 of the JAX update.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastscnn_tpu.losses import get_loss_fn as jax_loss_fn
from fastscnn_tpu.models import FastSCNN as JaxFastSCNN
from fastscnn_tpu.models import init_fast_scnn as jax_init
from fastscnn_tpu.parallel.train import create_train_state as jax_create
from fastscnn_tpu.parallel.train import make_optimizer as jax_optimizer
from fastscnn_tpu.parallel.train import make_train_step as jax_train_step
from fastscnn_tpu.utils import checkpoint as jax_ckpt
from fastscnn_tpu.utils.lr_scheduler import lr_schedule as jax_lr
from fastscnn_tpu_torch.losses import get_loss_fn
from fastscnn_tpu_torch.models import FastSCNN, from_jax_params
from fastscnn_tpu_torch.ops.cuda import launch_counts
from fastscnn_tpu_torch.parallel import create_train_state, make_optimizer, make_train_step
from fastscnn_tpu_torch.utils import lr_schedule
from fastscnn_tpu_torch.utils.checkpoint import load_train_state

NUM_CLASSES = 19
LR = dict(base_lr=1e-2, niters=10)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def shared():
    params, state = jax_init(jax.random.PRNGKey(0), NUM_CLASSES, aux=True)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (4, 64, 96, 3)).astype(np.uint8)
    targets = rng.integers(0, NUM_CLASSES, (4, 64, 96)).astype(np.int32)
    targets[rng.random(targets.shape) < 0.15] = -1
    return _np(params), _np(state), images, targets


def _run_both(shared, opt, grad_accum=1, batch=2, stem_impl="xla"):
    params, state, images, targets = shared
    images, targets = images[:batch], targets[:batch]
    jmodel = JaxFastSCNN(NUM_CLASSES, aux=True, dropout_rate=0.0, stem_impl=stem_impl)
    jopt = jax_optimizer(opt, jax_lr("poly", **LR))
    jstate = jax_create(jmodel, jopt, params=jax.tree_util.tree_map(jnp.asarray, params),
                        model_state=jax.tree_util.tree_map(jnp.asarray, state))
    jstep = jax.jit(jax_train_step(
        jmodel, jax_loss_fn("ce", aux=True, num_classes=NUM_CLASSES), jopt,
        compute_dtype=jnp.float32, grad_accum=grad_accum, jit=False))
    jnew, jmetrics = jstep(jstate, jnp.asarray(images), jnp.asarray(targets),
                           jax.random.PRNGKey(1))

    model = FastSCNN(NUM_CLASSES, aux=True, dropout_rate=0.0, stem_impl=stem_impl)
    model.load_state_dict(from_jax_params(params, state))
    popt = make_optimizer(opt, lr_schedule("poly", **LR))
    tstate = create_train_state(model, popt, device="cpu")
    step = make_train_step(model, get_loss_fn("ce", aux=True, num_classes=NUM_CLASSES), popt,
                           compute_dtype=torch.float32, grad_accum=grad_accum, device="cpu")
    before = launch_counts()
    tnew, metrics = step(tstate, images, targets)
    assert launch_counts() == before  # CPU: plain versions only
    assert tnew is tstate and tnew.step == 1
    return params, jnew, jmetrics, tnew, metrics


def _check(run, sgd=True):
    params, jnew, jmetrics, tnew, metrics = run
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(jnew.model_state),
                    jax.tree_util.tree_leaves(tnew.model_state)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-4)
    p0 = jax.tree_util.tree_leaves(params)
    dj = np.concatenate([(np.asarray(a) - z).ravel()
                         for a, z in zip(jax.tree_util.tree_leaves(jnew.params), p0)])
    dt = np.concatenate([(b.detach().numpy() - z).ravel()
                         for b, z in zip(jax.tree_util.tree_leaves(tnew.params), p0)])
    rel = np.linalg.norm(dt - dj) / np.linalg.norm(dj)
    if sgd:
        assert rel <= 1e-3, rel
    else:
        assert rel <= 5e-2, rel
        assert np.mean(np.abs(dt - dj) <= LR["base_lr"] / 100) >= 0.95
    for leaf in jax.tree_util.tree_leaves(tnew.params):
        assert leaf.dtype == torch.float32 and leaf.requires_grad


def test_sgd_step_matches_jax(shared):
    _check(_run_both(shared, "sgd"))


def test_adamw_step_matches_jax(shared):
    _check(_run_both(shared, "adamw"), sgd=False)


def test_grad_accum_step_matches_jax(shared):
    """Batch 4 in 2 microbatches of 2 (BN statistics threaded through)."""
    _check(_run_both(shared, "sgd", grad_accum=2, batch=4))


def test_pallas_stem_step_matches_jax(shared):
    """stem_impl='pallas' in f32: on the CPU the port's B6 runs its plain
    versions and the JAX B6 its XLA fallback, both with the tap backward."""
    _check(_run_both(shared, "sgd", stem_impl="pallas"))


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_a_step_from_a_jax_npz_train_state_matches_jax(shared, tmp_path, opt):
    """The JAX trainer's ``train_state_<dataset>.npz`` written after one JAX
    step (momentum, or Adam's moments and count, past their start) loads
    into the port; one more step on each side then agrees."""
    params, state, images, targets = shared
    images, targets = images[:2], targets[:2]
    jmodel = JaxFastSCNN(NUM_CLASSES, aux=True, dropout_rate=0.0)
    jopt = jax_optimizer(opt, jax_lr("poly", **LR))
    jstep = jax.jit(jax_train_step(jmodel, jax_loss_fn("ce", aux=True, num_classes=NUM_CLASSES),
                                   jopt, compute_dtype=jnp.float32, jit=False))
    jstate = jax_create(jmodel, jopt, params=jax.tree_util.tree_map(jnp.asarray, params),
                        model_state=jax.tree_util.tree_map(jnp.asarray, state))
    batch = (jnp.asarray(images), jnp.asarray(targets), jax.random.PRNGKey(1))
    # the optimizer state and step of one JAX step, over the starting weights:
    # from the stepped weights themselves one f32 step of the two frameworks
    # differs by ~1.6e-2 (a fresh optimizer as much as a loaded one: the
    # chaos of batch-stat BN at that point, not the file)
    j1 = dataclasses.replace(jstep(jstate, *batch)[0], params=jstate.params,
                             model_state=jstate.model_state)
    path = jax_ckpt.save_train_state(j1, str(tmp_path / "train_state_citys.npz"))
    j2, jmetrics = jstep(j1, *batch)

    model = FastSCNN(NUM_CLASSES, aux=True, dropout_rate=0.0)
    popt = make_optimizer(opt, lr_schedule("poly", **LR))
    tstate = load_train_state(path, create_train_state(model, popt, device="cpu"))
    assert tstate.step == 1
    for a, b in zip(jax.tree_util.tree_leaves((j1.params, j1.model_state)),
                    jax.tree_util.tree_leaves((tstate.params, tstate.model_state))):
        np.testing.assert_array_equal(b.detach().numpy(), np.asarray(a))
    step = make_train_step(model, get_loss_fn("ce", aux=True, num_classes=NUM_CLASSES), popt,
                           compute_dtype=torch.float32, device="cpu")
    tnew, metrics = step(tstate, images, targets)
    assert tnew.step == 2
    _check((_np(j1.params), j2, jmetrics, tnew, metrics), sgd=opt == "sgd")
