"""The port's on-device augmentation (``data/device_aug.py``) against the
JAX package's, and the train steps that run it.

JAX's key streams cannot be reproduced in PyTorch, so each chain is
compared on parameters drawn by JAX and handed to both ``apply_*``
functions as arrays. Bounds:

- masks: equal on every pixel (both NEAREST forms are exact);
- f32 images: within 1e-3 on the [0, 255] scale (the two frameworks sum
  the sampling matmuls in different orders; measured ≤ 1.1e-4);
- bf16 images: within 2.0, two bf16 ulps at the top of the scale (each
  of the two bf16 matmuls rounds its output once).

The train step with augmentation: one fixed-parameter augmentation
injected into the JAX step (``make_train_step(device_aug=...)``,
``jit=False`` under ``jax.jit``; the chain's output computed eagerly, as
XLA's fusion of it into the step rounds otherwise and batch-stat BN
amplifies that to 1.0e-2 of the update) and the port's (its own chain
inside the step), f32, no dropout: loss
rtol 1e-5, BN statistics 1e-4 and the param update within relative L2
1e-3, the bounds of ``tests/test_torch_train_step.py``. The port's split
step equals its fused step bit for bit at ``grad_accum=1``.
"""

import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastscnn_tpu.data import device_aug as jaug
from fastscnn_tpu.losses import get_loss_fn as jax_loss_fn
from fastscnn_tpu.models import FastSCNN as JaxFastSCNN
from fastscnn_tpu.models import init_fast_scnn as jax_init
from fastscnn_tpu.parallel.train import create_train_state as jax_create
from fastscnn_tpu.parallel.train import make_optimizer as jax_optimizer
from fastscnn_tpu.parallel.train import make_train_step as jax_train_step
from fastscnn_tpu.utils.lr_scheduler import lr_schedule as jax_lr
from fastscnn_tpu_torch.data import device_aug as taug
from fastscnn_tpu_torch.losses import get_loss_fn
from fastscnn_tpu_torch.models import FastSCNN, from_jax_params
from fastscnn_tpu_torch.parallel import (
    create_train_state,
    make_optimizer,
    make_split_aug_train_step,
    make_train_step,
)
from fastscnn_tpu_torch.utils import lr_schedule
from fastscnn_tpu_torch.utils.tree import tree_leaves

B, H, W, CROP, BASE = 3, 96, 192, 64, 96
SCALES = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0)
F32_BOUND, BF16_BOUND = 1e-3, 2.0
DTYPES = {"f32": (jnp.float32, torch.float32, F32_BOUND),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_BOUND)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes here are small, and under the
    suite's parallel workers the default pool's spinning threads take the
    cores the other workers need."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed, h=H, w=W, labels=(-1, 19)):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(yy * 2 + xx) % 256, (xx * 1.3) % 256, (yy * 2.7) % 256], -1)
    imgs = np.stack([(img + 40 * k + rng.integers(0, 9, img.shape)) % 256 for k in range(B)])
    masks = rng.integers(*labels, (B, h, w)).astype(np.int32)
    return imgs.astype(np.uint8), masks


def _to_torch(params, cls):
    return cls(*[torch.from_numpy(np.array(v)) for v in params])


def _compare(jout, tout, bound):
    (ji, jm), (ti, tm) = jout, tout
    assert ti.dtype == torch.float32 and tm.dtype == torch.int32
    assert tuple(ti.shape) == ji.shape and tuple(tm.shape) == jm.shape
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    err = np.abs(ti.numpy() - np.asarray(ji, np.float32)).max()
    assert err <= bound, err
    assert 0.0 <= ti.min() and ti.max() <= 255.0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_psp_chain_equals_jax_on_jax_draws(seed, dtype):
    """Short edges from 48 to 192 against a 64 crop: pads, up- and
    downscales, flips and blurs; int8 labels as the trainer sends them."""
    jd, td, bound = DTYPES[dtype]
    imgs, masks = _batch(seed)
    p = jaug.draw_params(jax.random.PRNGKey(seed), B, H, W, BASE, CROP)
    kw = dict(crop_size=CROP, base_size=BASE, pad_label=-1)
    jout = jaug.apply_params(jnp.asarray(imgs), jnp.asarray(masks), p, compute_dtype=jd, **kw)
    tout = taug.apply_params(torch.from_numpy(imgs), torch.from_numpy(masks.astype(np.int8)),
                             _to_torch(p, taug.AugParams), compute_dtype=td, **kw)
    _compare(jout, tout, bound)


@pytest.mark.parametrize("case", ["crop-flip", "multi-scale", "guard", "multi-guard"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_custom_chain_equals_jax_on_jax_draws(case, dtype):
    """The custom chain: crop and flip only (the gather path), multi-scale,
    the min-size guard resize of a source smaller than the crop, both."""
    jd, td, bound = DTYPES[dtype]
    h, w = (48, 60) if "guard" in case else (H, W)
    scales = SCALES if "multi" in case else (1.0,)
    imgs, masks = _batch(7, h, w, labels=(0, 2))
    p = jaug.draw_custom_params(jax.random.PRNGKey(len(case)), B, h, w, CROP, scales)
    jout = jaug.apply_custom_params(jnp.asarray(imgs), jnp.asarray(masks), p, crop_size=CROP,
                                    scales=scales, compute_dtype=jd)
    tout = taug.apply_custom_params(torch.from_numpy(imgs), torch.from_numpy(masks),
                                    _to_torch(p, taug.CustomAugParams), crop_size=CROP,
                                    scales=scales, compute_dtype=td)
    _compare(jout, tout, bound)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_custom_keep_original_size_equals_jax(monkeypatch, dtype):
    """Resize to base² and flip: the flips (its only draw) forced alike."""
    jd, td, bound = DTYPES[dtype]
    imgs, masks = _batch(3, labels=(0, 2))
    flips = np.array([True, False, True])
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(flips))
    monkeypatch.setattr(taug, "_bernoulli_half", lambda g, b: torch.from_numpy(flips))
    kw = dict(crop_size=CROP, keep_original_size=True, base_size=80)
    jout = jaug.make_device_augment_custom(compute_dtype=jd, **kw)(
        jnp.asarray(imgs), jnp.asarray(masks), jax.random.PRNGKey(0))
    tout = taug.make_device_augment_custom(compute_dtype=td, **kw)(
        torch.from_numpy(imgs), torch.from_numpy(masks), torch.Generator())
    _compare(jout, tout, bound)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_original_chain_equals_jax_on_jax_draws(dtype):
    jd, td, bound = DTYPES[dtype]
    imgs, masks = _batch(4, 40, 72, labels=(0, 3))
    p = jaug.draw_original_params(jax.random.PRNGKey(2), B, 0.9)
    jout = jaug.apply_original_params(jnp.asarray(imgs), jnp.asarray(masks), p, compute_dtype=jd)
    tout = taug.apply_original_params(torch.from_numpy(imgs), torch.from_numpy(masks),
                                      _to_torch(p, taug.OriginalAugParams), compute_dtype=td)
    _compare(jout, tout, bound)


def test_draws_respect_the_reference_bounds():
    """Inclusive randint bounds (both ends reached), Bernoulli(0.5) and
    Bernoulli(blur_p), radius in [0, 1), on a CPU generator."""
    g = torch.Generator().manual_seed(0)
    n = 4000
    p = taug.draw_params(g, n, H, W, BASE, CROP)
    assert p.short.min() == BASE // 2 and p.short.max() == 2 * BASE
    oh, ow = taug._resized_dims(p.short, H, W)
    ph, pw = torch.clamp(oh, min=CROP), torch.clamp(ow, min=CROP)
    assert (p.y1 >= 0).all() and (p.y1 <= ph - CROP).all() and (p.y1 == ph - CROP).any()
    assert (p.x1 >= 0).all() and (p.x1 <= pw - CROP).all() and (p.x1 == pw - CROP).any()
    assert (p.x1 == 0).sum() > (p.x1 == pw - CROP).sum() // 4
    for flags in (p.flip, p.blur_on):
        assert flags.dtype == torch.bool and 0.45 < flags.float().mean() < 0.55
    assert p.radius.dtype == torch.float32 and 0 <= p.radius.min() and p.radius.max() < 1
    c = taug.draw_custom_params(g, n, H, W, CROP, SCALES)
    assert set(c.scale_k.tolist()) == set(range(len(SCALES)))
    ow = taug._custom_dims(SCALES, W, "cpu")[c.scale_k]
    assert (c.x1 <= torch.clamp(ow, min=CROP) - CROP).all() and 0.45 < c.flip.float().mean() < 0.55
    o = taug.draw_original_params(g, n, 0.3)
    assert 0.26 < o.blur_on.float().mean() < 0.34 and 0.45 < o.flip.float().mean() < 0.55


def test_an_augment_draws_from_its_generator_alone():
    """The same generator state gives the same batch; int8 and int32
    labels give the same masks; the output shapes and dtypes."""
    imgs, masks = _batch(5)
    aug = taug.make_device_augment(base_size=BASE, crop_size=CROP, pad_label=-1)
    a = aug(torch.from_numpy(imgs), torch.from_numpy(masks), torch.Generator().manual_seed(1))
    b = aug(torch.from_numpy(imgs), torch.from_numpy(masks.astype(np.int8)),
            torch.Generator().manual_seed(1))
    c = aug(torch.from_numpy(imgs), torch.from_numpy(masks), torch.Generator().manual_seed(2))
    assert a[0].shape == (B, CROP, CROP, 3) and a[1].shape == (B, CROP, CROP)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


# --- the train steps --------------------------------------------------------------

NUM_CLASSES = 19
LR = dict(base_lr=1e-2, niters=10)


@pytest.fixture(scope="module")
def shared():
    params, state = jax_init(jax.random.PRNGKey(0), NUM_CLASSES, aux=True)
    imgs, masks = _batch(11, labels=(-1, NUM_CLASSES))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    draws = jaug.draw_params(jax.random.PRNGKey(9), B, H, W, BASE, CROP)
    return params, state, imgs[:2], masks[:2], jax.tree_util.tree_map(lambda v: v[:2], draws)


def _port_step(shared, factory=make_train_step, **kw):
    params, state = shared[:2]
    model = FastSCNN(NUM_CLASSES, aux=True, dropout_rate=0.0)
    model.load_state_dict(from_jax_params(params, state))
    opt = make_optimizer("sgd", lr_schedule("poly", **LR))
    step = factory(model, get_loss_fn("ce", aux=True, num_classes=NUM_CLASSES), opt,
                   compute_dtype=torch.float32, device="cpu", **kw)
    return create_train_state(model, opt, device="cpu"), step


def test_device_aug_train_step_matches_jax(shared):
    params, state, imgs, masks, draws = shared
    kw = dict(crop_size=CROP, base_size=BASE, pad_label=-1)
    # JAX's chain runs eagerly and enters its jitted step as constants: inside
    # the step XLA would fuse it with the normalisation and round otherwise
    jout = jaug.apply_params(jnp.asarray(imgs), jnp.asarray(masks), draws,
                             compute_dtype=jnp.float32, **kw)

    def jax_fixed(images, targets, key):
        return jout

    def port_fixed(images, targets, generator):
        return taug.apply_params(images, targets, _to_torch(draws, taug.AugParams),
                                 compute_dtype=torch.float32, **kw)

    jmodel = JaxFastSCNN(NUM_CLASSES, aux=True, dropout_rate=0.0)
    jopt = jax_optimizer("sgd", jax_lr("poly", **LR))
    jstate = jax_create(jmodel, jopt, params=jax.tree_util.tree_map(jnp.asarray, params),
                        model_state=jax.tree_util.tree_map(jnp.asarray, state))
    jstep = jax.jit(jax_train_step(jmodel, jax_loss_fn("ce", aux=True, num_classes=NUM_CLASSES),
                                   jopt, compute_dtype=jnp.float32, device_aug=jax_fixed,
                                   jit=False))
    jnew, jmetrics = jstep(jstate, jnp.asarray(imgs), jnp.asarray(masks), jax.random.PRNGKey(1))

    tstate, step = _port_step(shared, device_aug=port_fixed, donate_batch=True)
    tnew, metrics = step(tstate, imgs, masks.astype(np.int8), None, torch.Generator())
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(jnew.model_state),
                    jax.tree_util.tree_leaves(tnew.model_state)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-4)
    p0 = jax.tree_util.tree_leaves(params)
    dj = np.concatenate([(np.asarray(a) - z).ravel()
                         for a, z in zip(jax.tree_util.tree_leaves(jnew.params), p0)])
    dt = np.concatenate([(b.detach().numpy() - z).ravel()
                         for b, z in zip(jax.tree_util.tree_leaves(tnew.params), p0)])
    assert np.linalg.norm(dt - dj) / np.linalg.norm(dj) <= 1e-3


def test_split_step_equals_fused_step_at_one_microbatch(shared):
    """The same ``aug_generator`` state: the same draws, loss, params and BN
    statistics, bit for bit on the CPU."""
    imgs, masks = shared[2], shared[3]
    aug = taug.make_device_augment(base_size=BASE, crop_size=CROP, pad_label=-1,
                                   compute_dtype=torch.float32)
    runs = []
    for factory in (lambda m, lf, o, **k: make_train_step(m, lf, o, device_aug=aug, **k),
                    lambda m, lf, o, **k: make_split_aug_train_step(m, lf, o, aug, **k)):
        state, step = _port_step(shared, factory)
        state, metrics = step(state, imgs, masks, None, torch.Generator().manual_seed(4))
        runs.append([metrics["loss"], *tree_leaves(state.params), *tree_leaves(state.model_state)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_fused_step_draws_per_microbatch_and_donation_frees_the_batch(shared):
    """With ``grad_accum=2`` the chain runs once per microbatch, on its
    half; with ``donate_batch`` no reference to the native batch is left by
    the time the loss runs, without it the step still holds one."""
    imgs, masks = shared[2], shared[3]
    aug = taug.make_device_augment(base_size=BASE, crop_size=CROP, pad_label=-1,
                                   compute_dtype=torch.float32)
    for donate in (True, False):
        seen = {"batches": [], "alive": []}

        def recording_aug(images, targets, generator):
            base = images._base if images._base is not None else images
            seen["ref"] = weakref.ref(base)
            seen["batches"].append(images.shape[0])
            return aug(images, targets, generator)

        loss = get_loss_fn("ce", aux=True, num_classes=NUM_CLASSES)

        def recording_loss(outputs, targets):
            seen["alive"].append(seen["ref"]() is not None)
            return loss(outputs, targets)

        params, state = shared[:2]
        model = FastSCNN(NUM_CLASSES, aux=True, dropout_rate=0.0)
        model.load_state_dict(from_jax_params(params, state))
        opt = make_optimizer("sgd", lr_schedule("poly", **LR))
        step = make_train_step(model, recording_loss, opt, compute_dtype=torch.float32,
                               grad_accum=2, device_aug=recording_aug, donate_batch=donate,
                               device="cpu")
        tstate = create_train_state(model, opt, device="cpu")
        step(tstate, imgs.copy(), masks.copy(), None, torch.Generator().manual_seed(0))
        assert seen["batches"] == [1, 1]
        assert seen["alive"] == ([True, False] if donate else [True, True])
