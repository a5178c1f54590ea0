"""The port's train and eval steps on the committed mini-lane fixture,
from the JAX package's own initialisation.

1. ``test_convergence_to_lane_iou_gate``: the counterpart of
   ``tests/test_training_parity.py::test_convergence_to_lane_iou_gate``,
   with its fixture, recipe and constants (``FastSCNN(2, aux=True,
   dropout_rate=0.0)``, poly LR from 1e-2 over 84 epochs × 6 iterations,
   SGD with momentum 0.9 and weight decay 1e-4, mix Dice with aux weight
   0.4, f32, no normalisation, 500 steps of batch 4 cycling the 24 images
   in order). The JAX gate starts from ``model.init(PRNGKey(3))``; so does
   this one, carried across by ``from_jax_params``. The port's
   ``make_eval_step`` must then give a lane IoU above 0.9.
2. ``test_trajectory_tracks_the_jax_step``: the same recipe from the same
   init, 18 steps of the JAX step (jitted) and of the port's on the same
   batches. Training through batch-stat BN is chaotic (the parity file's
   docstring, lines 27-43: a run restarted from its init perturbed by
   1e-7 drifts to ~1e-2 per-step loss difference by step 5), so the gates
   are the parity file's trainer-driven ones:
   - step 0's loss equal within f32 rounding (relative 1e-5): nothing
     has moved yet;
   - step 1's loss within 5e-3, and every step's within 0.08;
   - the parameter movement from the init (BN affine parameters and
     running statistics excluded, as there) correlated above 0.2 with
     JAX's.
   The port's own chaos floor, measured by this test on every run (the
   port against itself from the init perturbed by 1e-7), is held to the
   same gates. Measured on an x86 CPU (one torch thread): the port
   against its perturbed self differed by 4.4e-4 at step 1 and at most
   5.1e-2 over the 18 steps, with a movement correlation of 0.29; the
   port against JAX by 9.0e-5, 1.9e-2 and 0.36. The two are alike, so
   what separates the port from JAX is the chaos of the step itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastscnn_tpu.losses import get_loss_fn as jax_loss_fn
from fastscnn_tpu.models import FastSCNN as JaxFastSCNN
from fastscnn_tpu.parallel.train import create_train_state as jax_create
from fastscnn_tpu.parallel.train import make_optimizer as jax_optimizer
from fastscnn_tpu.parallel.train import make_train_step as jax_train_step
from fastscnn_tpu.utils.lr_scheduler import lr_schedule as jax_lr
from fastscnn_tpu_torch.losses import get_loss_fn
from fastscnn_tpu_torch.models import FastSCNN, from_jax_params
from fastscnn_tpu_torch.ops.cuda import launch_counts
from fastscnn_tpu_torch.parallel import (
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from fastscnn_tpu_torch.utils import lr_schedule
from tests.fixtures.gen_mini_lane import load as load_fixtures
from tests.test_training_parity import AUX_WEIGHT, BS, LR, _batches

STEPS, NEPOCHS = 500, 84
TRAJECTORY_STEPS = 18
PERTURBATION = 1e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes here are small, and under the
    suite's parallel workers the default pool's spinning threads take the
    cores the other workers need."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fixture_set():
    images, masks = load_fixtures()
    params, state = JaxFastSCNN(num_classes=2, aux=True, dropout_rate=0.0).init(
        jax.random.PRNGKey(3))
    host = jax.tree_util.tree_map(np.asarray, (params, state))
    return images, masks, host


def _schedule_args(images):
    return dict(base_lr=LR, nepochs=NEPOCHS, iters_per_epoch=len(images) // BS, power=0.9)


def _port_run(images, masks, params, state, steps):
    """The recipe on the port from ``params``/``state`` (JAX-layout numpy
    trees): (model, train state, per-step losses)."""
    model = FastSCNN(2, aux=True, dropout_rate=0.0)
    model.load_state_dict(from_jax_params(params, state))
    optimizer = make_optimizer("sgd", lr_schedule("poly", **_schedule_args(images)))
    step = make_train_step(model, get_loss_fn("dice", aux=True, aux_weight=AUX_WEIGHT),
                           optimizer, compute_dtype=torch.float32, mean=None, std=None,
                           device="cpu")
    tstate = create_train_state(model, optimizer, device="cpu")
    losses = []
    for img_u8, tgt in _batches(images, masks, steps, BS):
        tstate, metrics = step(tstate, img_u8, tgt.astype(np.int32))
        losses.append(float(metrics["loss"]))
    return model, tstate, losses


def _movement(params, state, init_sd):
    """Parameter movement from the init as one vector, in state-dict
    order, without BN affine parameters and running statistics."""
    sd = from_jax_params(params, state)
    parts = []
    for k, v in sd.items():
        if "running_" in k or k.rsplit(".", 1)[0] + ".running_mean" in sd:
            continue
        parts.append((v.numpy() - init_sd[k].numpy()).ravel())
    return np.concatenate(parts)


def _gates(ours, theirs, move_ours, move_theirs):
    diff = np.abs(np.asarray(ours) - np.asarray(theirs))
    corr = float(np.dot(move_ours, move_theirs)
                 / (np.linalg.norm(move_ours) * np.linalg.norm(move_theirs) + 1e-12))
    return diff, corr


def test_convergence_to_lane_iou_gate(fixture_set):
    images, masks, (params, state) = fixture_set
    before = launch_counts()
    model, tstate, losses = _port_run(images, masks, params, state, STEPS)
    assert launch_counts() == before  # the CPU runs the plain versions
    assert np.isfinite(losses).all()
    estep = make_eval_step(model, num_classes=2, compute_dtype=torch.float32, mean=None,
                           std=None, device="cpu")
    _, (correct, labeled, inter, union) = estep(tstate.params, tstate.model_state, images,
                                                masks.astype(np.int32))
    iou = inter.double().numpy() / np.maximum(union.double().numpy(), 1)
    assert iou[1] > 0.9, f"lane IoU {iou[1]:.4f} (mIoU {iou.mean():.4f}) below gate"


def test_trajectory_tracks_the_jax_step(fixture_set):
    images, masks, (params, state) = fixture_set
    init_sd = from_jax_params(params, state)

    jmodel = JaxFastSCNN(num_classes=2, aux=True, dropout_rate=0.0)
    jopt = jax_optimizer("sgd", schedule=jax_lr("poly", **_schedule_args(images)))
    jstep = jax_train_step(jmodel, jax_loss_fn("dice", aux=True, aux_weight=AUX_WEIGHT), jopt,
                           compute_dtype=jnp.float32, mean=None, std=None)
    jstate = jax_create(jmodel, jopt, params=jax.tree_util.tree_map(jnp.asarray, params),
                        model_state=jax.tree_util.tree_map(jnp.asarray, state))
    jlosses = []
    rng = jax.random.PRNGKey(0)
    for img_u8, tgt in _batches(images, masks, TRAJECTORY_STEPS, BS):
        jstate, metrics = jstep(jstate, jnp.asarray(img_u8), jnp.asarray(tgt.astype(np.int32)),
                                rng)
        jlosses.append(float(metrics["loss"]))
    jnp_tree = jax.tree_util.tree_map(np.asarray, (jstate.params, jstate.model_state))

    _, tstate, losses = _port_run(images, masks, params, state, TRAJECTORY_STEPS)
    move = _movement(tstate.params, tstate.model_state, init_sd)
    diff, corr = _gates(losses, jlosses, move, _movement(*jnp_tree, init_sd))
    assert abs(losses[0] - jlosses[0]) <= 1e-5 * abs(jlosses[0]), (losses[0], jlosses[0])
    assert diff[1] < 5e-3, f"step-1 divergence {diff[1]:.2e}"
    assert diff.max() < 0.08, f"loss divergence {diff.max():.2e} at step {diff.argmax()}"
    assert corr > 0.2, f"parameter-movement correlation {corr:.3f}"

    # the chaos floor: the port against itself from the init perturbed by 1e-7
    rng = np.random.default_rng(0)
    perturbed = jax.tree_util.tree_map(
        lambda v: (v + PERTURBATION * rng.standard_normal(v.shape)).astype(v.dtype), params)
    _, pstate, plosses = _port_run(images, masks, perturbed, state, TRAJECTORY_STEPS)
    pdiff, pcorr = _gates(losses, plosses, move,
                          _movement(pstate.params, pstate.model_state, init_sd))
    print(f"port vs JAX: step 1 {diff[1]:.2e}, max {diff.max():.2e}, corr {corr:.3f}; "
          f"port vs its perturbed self: step 1 {pdiff[1]:.2e}, max {pdiff.max():.2e}, "
          f"corr {pcorr:.3f}")
    assert pdiff[1] < 5e-3 and pdiff.max() < 0.08 and pcorr > 0.2, (pdiff, pcorr)
