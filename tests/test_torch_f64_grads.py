"""The port's f64 gradients of the train-mode model and the 'ce' loss
against the JAX package's, on shared weights (``from_jax_params``), for
each stem but 'pallas'.

Tolerance: as ``tests/test_ops.py::test_stem_impl_pallas_model_grads_match``
takes them, relative L2 distance of all gradients ≤ 1e-5, the loss within
rtol 1e-5. The losses take their logits to f32 in both packages, so the
comparison is limited by f32 rounding there, amplified through batch-stat
BN (the measured distance is ~3e-6). 'pallas' is left out: its plain B6
versions compute in f32 by design; 'taps' and 'taps-packbn' are in (as
``tests/test_ops.py`` takes the JAX model's 'taps' stems in f64). The
cases are those of ``tests/test_torch_train_grads.py``'s module, on its
``shared`` inputs, in a file of their own so that a parallel run can place
them on another worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastscnn_tpu.losses import get_loss_fn as jax_loss_fn
from fastscnn_tpu.models import FastSCNN as JaxFastSCNN
from fastscnn_tpu.models import init_fast_scnn as jax_init
from fastscnn_tpu_torch.losses import get_loss_fn
from fastscnn_tpu_torch.models import FastSCNN

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
