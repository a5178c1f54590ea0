"""The port's train-mode model, gradients and eval step against the JAX
package's, on shared weights (``from_jax_params`` / ``to_param_trees``).

Tolerances:
- train-mode forward in f32: logits within 1e-4 of their largest
  magnitude (batch-stat BN renormalises every layer, so summation-order
  differences of ~1e-7 grow through the ~40 layers), new BN statistics
  1e-5;
- gradients in f64, as ``tests/test_ops.py::test_stem_impl_pallas_model_grads_match``
  takes them: relative L2 distance of all gradients ≤ 1e-5. The losses
  take their logits to f32 in both packages, so the comparison is
  limited by f32 rounding there, amplified through batch-stat BN (the
  measured distance is ~3e-6). 'pallas' is left out: its plain B6
  versions compute in f32 by design; 'taps' and 'taps-packbn' are in (as
  ``tests/test_ops.py`` takes the JAX model's 'taps' stems in f64);
- eval step in f32: masks agree on all but ≤ 0.1 % of pixels (near-ties
  of the two packages' summation orders), and the statistics differ by
  at most the number of differing pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastscnn_tpu.losses import get_loss_fn as jax_loss_fn
from fastscnn_tpu.models import FastSCNN as JaxFastSCNN
from fastscnn_tpu.models import init_fast_scnn as jax_init
from fastscnn_tpu.parallel.train import make_eval_step as jax_eval_step
from fastscnn_tpu_torch.losses import get_loss_fn
from fastscnn_tpu_torch.models import FastSCNN, from_jax_params, to_param_trees
from fastscnn_tpu_torch.parallel import (
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_split_aug_train_step,
    make_train_step,
)

NUM_CLASSES = 19


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def shared():
    params, state = jax_init(jax.random.PRNGKey(3), NUM_CLASSES, aux=True)
    rng = np.random.default_rng(3)

    def perturb(path, v):  # running statistics away from (0, 1): eval-mode BN does work
        name = jax.tree_util.keystr(path)
        if "mean" in name:
            return jnp.asarray(rng.uniform(-0.05, 0.05, v.shape), v.dtype)
        if "var" in name:
            return jnp.asarray(rng.uniform(0.05, 0.2, v.shape), v.dtype)
        return v

    state = jax.tree_util.tree_map_with_path(perturb, state)
    x = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    images = rng.integers(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    targets = rng.integers(0, NUM_CLASSES, (2, 64, 96)).astype(np.int32)
    targets[rng.random(targets.shape) < 0.15] = -1
    return _np(params), _np(state), x, images, targets


def _port_model(params, state, **kw):
    model = FastSCNN(NUM_CLASSES, aux=True, **kw)
    model.load_state_dict(from_jax_params(params, state))
    return model


@pytest.mark.parametrize("stem_impl", ["xla", "tapbwd", "taps", "taps-packbn", "pallas"])
def test_train_mode_forward_matches_jax(shared, stem_impl):
    params, state, x, _, _ = shared
    (ref_main, ref_aux), ref_state = JaxFastSCNN(NUM_CLASSES, aux=True, stem_impl=stem_impl).apply(
        params, state, jnp.asarray(x), training=True, upsample_outputs=False)
    model = _port_model(params, state, stem_impl=stem_impl)
    p, s = to_param_trees(model)
    (main, aux), new_state = model.apply_params(p, s, torch.from_numpy(x), training=True,
                                                upsample_outputs=False)
    for got, ref in ((main, ref_main), (aux, ref_aux)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    ref_leaves = jax.tree_util.tree_leaves(ref_state)
    got_leaves = jax.tree_util.tree_leaves(new_state)
    assert len(ref_leaves) == len(got_leaves) == 90
    for g, r in zip(got_leaves, ref_leaves):
        assert g.dtype == torch.float32 and not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_eval_mode_forward_matches_jax_and_keeps_state(shared):
    params, state, x, _, _ = shared
    (ref_main, _), _ = JaxFastSCNN(NUM_CLASSES, aux=True).apply(params, state, jnp.asarray(x))
    model = _port_model(params, state)
    p, s = to_param_trees(model)
    (main, _), new_state = model.apply_params(p, s, torch.from_numpy(x))
    assert new_state is not None and main.shape == (2, 64, 96, NUM_CLASSES)
    ref = np.asarray(ref_main)
    np.testing.assert_allclose(main.numpy(), ref, rtol=1e-4, atol=2e-5 * np.abs(ref).max())
    # the module's eval-mode forward is the same graph
    with torch.no_grad():
        np.testing.assert_allclose(model.eval()(torch.from_numpy(x))[0].numpy(), main.numpy(),
                                   rtol=1e-4, atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("stem_impl", ["xla", "tapbwd", "taps", "taps-packbn"])
def test_f64_gradients_match_jax(shared, stem_impl):
    params, state, x, _, targets = shared
    jax.config.update("jax_enable_x64", True)
    try:
        p64, s64 = (jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float64), t)
                    for t in (params, state))
        jmodel = JaxFastSCNN(NUM_CLASSES, aux=True, stem_impl=stem_impl)
        jloss = jax_loss_fn("ce", aux=True, num_classes=NUM_CLASSES)

        def loss_of(p):
            outs, _ = jmodel.apply(p, s64, jnp.asarray(x, jnp.float64), training=True,
                                   upsample_outputs=False)
            return jloss(outs, jnp.asarray(targets))

        ref, ref_grads = jax.jit(jax.value_and_grad(loss_of))(p64)
        ref_vec = np.concatenate([np.asarray(g).ravel() for g in jax.tree_util.tree_leaves(ref_grads)])
    finally:
        jax.config.update("jax_enable_x64", False)
    model = FastSCNN(NUM_CLASSES, aux=True, stem_impl=stem_impl)
    tp = jax.tree_util.tree_map(lambda v: torch.tensor(v, dtype=torch.float64, requires_grad=True),
                                params)
    ts = jax.tree_util.tree_map(lambda v: torch.tensor(v, dtype=torch.float64), state)
    outs, _ = model.apply_params(tp, ts, torch.from_numpy(x).double(), training=True,
                                 upsample_outputs=False)
    loss = get_loss_fn("ce", aux=True, num_classes=NUM_CLASSES)(outs, torch.from_numpy(targets))
    loss.backward()
    got_vec = np.concatenate([t.grad.numpy().ravel() for t in jax.tree_util.tree_leaves(tp)])
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    rel = np.linalg.norm(got_vec - ref_vec) / np.linalg.norm(ref_vec)
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("per_sample", [False, True])
def test_eval_step_matches_jax(shared, per_sample):
    params, state, _, images, targets = shared
    jstep = jax.jit(jax_eval_step(JaxFastSCNN(NUM_CLASSES, aux=True), NUM_CLASSES,
                                  compute_dtype=jnp.float32, jit=False,
                                  per_sample_stats=per_sample, pred_dtype=jnp.uint8))
    ref_pred, ref_stats = jstep(params, state, jnp.asarray(images), jnp.asarray(targets))
    model = _port_model(params, state)
    step = make_eval_step(model, NUM_CLASSES, compute_dtype=torch.float32,
                          per_sample_stats=per_sample, pred_dtype=torch.uint8, device="cpu")
    p, s = to_param_trees(model)
    pred, stats = step(p, s, images, targets)
    assert pred.dtype == torch.uint8 and pred.shape == (2, 64, 96)
    ref_pred = np.asarray(ref_pred)
    assert len(np.unique(ref_pred)) > 1
    diff = int((pred.numpy() != ref_pred).sum())
    assert diff <= 1e-3 * ref_pred.size
    for g, r in zip(stats, ref_stats):
        assert g.shape == np.asarray(r).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=diff)


def test_dropout_draws_from_the_generator_only_in_training(shared):
    params, state, _, images, targets = shared
    model = _port_model(params, state, dropout_rate=0.5)
    p, s = to_param_trees(model)
    x = torch.from_numpy(images).float() / 255

    def main(training, generator):
        return model.apply_params(p, s, x, training=training, generator=generator,
                                  upsample_outputs=False)[0][0]

    plain = main(True, None)
    a = main(True, torch.Generator().manual_seed(5))
    b = main(True, torch.Generator().manual_seed(5))
    c = main(True, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, plain) and not torch.equal(a, c)
    assert torch.equal(main(False, torch.Generator().manual_seed(5)), main(False, None))
    no_drop = _port_model(params, state, dropout_rate=0.0)
    d = no_drop.apply_params(p, s, x, training=True, generator=torch.Generator().manual_seed(5),
                             upsample_outputs=False)[0][0]
    assert torch.equal(d, plain)


def test_train_steps_lower_the_loss_on_a_fixed_batch(shared):
    """A few bf16 SGD steps with dropout drawn from a generator: finite
    losses that fall on a batch the model can fit."""
    params, state, _, images, _ = shared
    targets = (images[..., 0] > 127).astype(np.int32) + 2 * (images[..., 1] > 127)
    model = _port_model(params, state, stem_impl="pallas")
    opt = make_optimizer("sgd", 0.05)
    tstate = create_train_state(model, opt, device="cpu")
    step = make_train_step(model, get_loss_fn("ce", aux=True, num_classes=NUM_CLASSES), opt,
                           device="cpu")
    gen = torch.Generator().manual_seed(0)
    losses = [float(step(tstate, images, targets, gen)[1]["loss"]) for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert tstate.step == 6


def test_unported_options_and_devices_raise(shared, monkeypatch):
    model = FastSCNN(NUM_CLASSES)
    opt = make_optimizer("sgd")
    loss = get_loss_fn("ce")
    for kw in ({"mesh": object()}, {"spatial_shard": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md.*multi-device"):
            make_train_step(model, loss, opt, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*multi-device"):
        make_eval_step(model, NUM_CLASSES, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*multi-device"):
        make_split_aug_train_step(model, loss, opt, lambda *a: a, mesh=object(), device="cpu")
    # device_aug and donate_batch are ported: a device-aug step needs its generator
    state = create_train_state(model, opt, device="cpu")
    batch = (np.zeros((1, 8, 8, 3), np.uint8), np.zeros((1, 8, 8), np.int32))
    for build in (lambda: make_train_step(model, loss, opt, device_aug=lambda *a: a,
                                          donate_batch=True, device="cpu"),
                  lambda: make_split_aug_train_step(model, loss, opt, lambda *a: a, device="cpu")):
        with pytest.raises(ValueError, match="aug_generator"):
            build()(state, *batch)
    with pytest.raises(ValueError, match="grad_accum"):
        make_train_step(model, loss, opt, grad_accum=0, device="cpu")
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lamb")
    with pytest.raises(ValueError, match="stem_impl"):
        FastSCNN(NUM_CLASSES, stem_impl="nope")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: make_train_step(model, loss, opt),
                  lambda: make_eval_step(model, NUM_CLASSES),
                  lambda: create_train_state(model, opt)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
