"""The port's losses, LR schedules and metric against the JAX package's.

Losses: value and gradient (``torch.autograd`` against
``jax.value_and_grad``) on the same numpy logits and targets, in f32:
rtol 1e-5 on the value, and gradients within 1e-5 of their largest
magnitude (the two frameworks reduce in other orders). Low-resolution
logits exercise the losses' own ``align_corners=True`` upsample.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastscnn_tpu.losses.segmentation as J
import fastscnn_tpu.utils.lr_scheduler as JL
import fastscnn_tpu.utils.metric as JM
import fastscnn_tpu_torch.losses.segmentation as T
from fastscnn_tpu_torch.utils import LRScheduler, SegmentationMetric, lr_schedule, seg_hist_update
from fastscnn_tpu_torch.utils.metric import seg_scores_from_hist


def _check(jax_fn, torch_fn, logits, target):
    ref, gref = jax.value_and_grad(jax_fn)(jnp.asarray(logits), jnp.asarray(target))
    lt = torch.from_numpy(logits).requires_grad_()
    val = torch_fn(lt, torch.from_numpy(target))
    val.backward()
    val = val.detach()
    assert np.isfinite(float(val))
    np.testing.assert_allclose(float(val), float(ref), rtol=1e-5, atol=1e-7)
    gref = np.asarray(gref)
    np.testing.assert_allclose(lt.grad.numpy(), gref, rtol=1e-4,
                               atol=1e-5 * max(np.abs(gref).max(), 1e-12))


def _data(rng, c, low_res=True, n=2, h=16, w=24, ignore=0.15):
    hl, wl = (h // 4, w // 4) if low_res else (h, w)
    logits = (rng.standard_normal((n, hl, wl, c)) * 2).astype(np.float32)
    target = rng.integers(0, c, (n, h, w)).astype(np.int32)
    target[rng.random((n, h, w)) < ignore] = -1
    return logits, target


_SINGLE = {
    "dice": (J.dice_loss, T.dice_loss),
    "focal_dice": (J.focal_dice_loss, T.focal_dice_loss),
    "cross_entropy": (J.cross_entropy_loss, T.cross_entropy_loss),
    "ohem": (J.ohem_cross_entropy_loss, T.ohem_cross_entropy_loss),
}


@pytest.mark.parametrize("low_res", [True, False])
@pytest.mark.parametrize("c", [2, 5])
@pytest.mark.parametrize("name", sorted(_SINGLE))
def test_single_losses_match_jax(rng, name, c, low_res):
    """c=2 takes the logit-difference paths of dice and focal-dice. Dice
    sums raw targets (no ignore masking), so its targets hold no −1."""
    logits, target = _data(rng, c, low_res, ignore=0.0 if name in ("dice", "focal_dice") else 0.15)
    jfn, tfn = _SINGLE[name]
    _check(jfn, tfn, logits, target)


@pytest.mark.parametrize("weighted", [False, True])
def test_class_weights_match_jax(rng, weighted):
    logits, target = _data(rng, 19)
    w = J.CITYSCAPES_CLASS_WEIGHTS if weighted else None
    assert T.CITYSCAPES_CLASS_WEIGHTS == J.CITYSCAPES_CLASS_WEIGHTS
    _check(lambda a, b: J.cross_entropy_loss(a, b, class_weights=w),
           lambda a, b: T.cross_entropy_loss(a, b, class_weights=w), logits, target)
    _check(lambda a, b: J.ohem_cross_entropy_loss(a, b, min_kept=100, class_weights=w),
           lambda a, b: T.ohem_cross_entropy_loss(a, b, min_kept=100, class_weights=w),
           logits, target)


def test_single_channel_and_channel_free_logits_match_jax(rng):
    target = rng.integers(0, 2, (2, 8, 12)).astype(np.int32)
    for shape in ((2, 8, 12, 1), (2, 8, 12)):
        logits = rng.standard_normal(shape).astype(np.float32)
        _check(J.dice_loss, T.dice_loss, logits, target)
    _check(J.focal_dice_loss, T.focal_dice_loss,
           rng.standard_normal((2, 8, 12, 1)).astype(np.float32), target)


def test_ohem_with_tied_probabilities_matches_jax(rng):
    """Many pixels share one logit vector, so their true-class
    probabilities tie exactly at the k-th smallest: the kept set must
    include every tied pixel in both."""
    logits = np.tile(rng.standard_normal((1, 1, 1, 4)).astype(np.float32) * 3, (2, 6, 8, 1))
    logits[0, :2] += rng.standard_normal((2, 8, 4)).astype(np.float32)
    target = np.zeros((2, 6, 8), np.int32)
    target[1, 0, :3] = -1
    for min_kept in (5, 40, 60):
        for thresh in (0.7, 0.01):
            _check(lambda a, b: J.ohem_cross_entropy_loss(a, b, thresh=thresh, min_kept=min_kept),
                   lambda a, b: T.ohem_cross_entropy_loss(a, b, thresh=thresh, min_kept=min_kept),
                   logits, target)


def test_ohem_with_fewer_valid_pixels_than_min_kept_matches_jax(rng):
    logits, target = _data(rng, 5, ignore=0.9)
    assert (target >= 0).sum() < 256
    _check(lambda a, b: J.ohem_cross_entropy_loss(a, b, thresh=0.01),
           lambda a, b: T.ohem_cross_entropy_loss(a, b, thresh=0.01), logits, target)
    _check(lambda a, b: J.ohem_cross_entropy_loss(a, b, min_kept=0),
           lambda a, b: T.ohem_cross_entropy_loss(a, b, min_kept=0), logits, target)


@pytest.mark.parametrize("aux", [False, True])
@pytest.mark.parametrize("name", ["dice", "focal_dice", "ce", "ce_plain"])
def test_get_loss_fn_matches_jax(rng, name, aux):
    """Each registry entry on a (main, aux) pair of low-resolution heads;
    ``aux=False`` must use the main head only."""
    c = 2 if name in ("dice", "focal_dice") else 19
    main, target = _data(rng, c, ignore=0.0 if c == 2 else 0.15)
    auxl = _data(rng, c)[0]
    jfn = J.get_loss_fn(name, aux=aux, num_classes=c)
    tfn = T.get_loss_fn(name, aux=aux, num_classes=c)
    ref, (gm, ga) = jax.value_and_grad(lambda a, b: jfn((a, b), jnp.asarray(target)),
                                       argnums=(0, 1))(jnp.asarray(main), jnp.asarray(auxl))
    mt, at = (torch.from_numpy(v).requires_grad_() for v in (main, auxl))
    val = tfn((mt, at), torch.from_numpy(target))
    val.backward()
    np.testing.assert_allclose(float(val), float(ref), rtol=1e-5)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(gm), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(gm)).max())
    if aux and name != "focal_dice":
        np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga), rtol=1e-4,
                                   atol=1e-5 * np.abs(np.asarray(ga)).max())
    else:
        assert at.grad is None or not at.grad.any()
    with pytest.raises(ValueError, match="unknown loss"):
        T.get_loss_fn("nope", aux=True)


_LR_CASES = [
    ("constant", {}),
    ("linear", {"niters": 11}),
    ("poly", {"niters": 11}),
    ("poly", {"nepochs": 3, "iters_per_epoch": 4, "offset": 2, "target_lr": 1e-4}),
    ("cosine", {"niters": 11}),
    ("step", {"step_iter": [3, 7], "niters": 11}),
    ("step", {"step_epoch": [1, 2], "nepochs": 3, "iters_per_epoch": 4}),
    ("step", {"step_iter": [20]}),
]


@pytest.mark.parametrize("mode,kw", _LR_CASES)
def test_lr_schedule_matches_jax(mode, kw):
    """Every step, past the end too; rtol 1e-6 (JAX computes in f32)."""
    ref = JL.lr_schedule(mode, base_lr=0.02, **kw)
    got = lr_schedule(mode, base_lr=0.02, **kw)
    for k in range(25):
        np.testing.assert_allclose(got(k), float(ref(k)), rtol=1e-6, atol=1e-9)


def test_poly_is_zero_at_the_last_step_and_scheduler_tracks():
    sched = lr_schedule("poly", base_lr=0.01, niters=10)
    assert sched(9) == 0.0 and sched(100) == 0.0 and sched(0) == 0.01
    s = LRScheduler("poly", base_lr=0.01, niters=10)
    assert s.learning_rate == 0.01
    assert s(5) == s.learning_rate == pytest.approx(0.01 * (1 - 5 / 9) ** 0.9)
    with pytest.raises(ValueError):
        lr_schedule("nope")
    with pytest.raises(ValueError):
        lr_schedule("step")


@pytest.mark.parametrize("per_sample", [False, True])
def test_seg_hist_update_matches_jax(rng, per_sample):
    """Negative labels are ignored; predicted ids outside [0, nclass) count
    in no class."""
    pred = rng.integers(-1, 7, (3, 10, 12)).astype(np.int32)
    target = rng.integers(-1, 6, (3, 10, 12)).astype(np.int32)
    ref = JM.seg_hist_update(jnp.asarray(pred), jnp.asarray(target), 6, per_sample=per_sample)
    got = seg_hist_update(torch.from_numpy(pred), torch.from_numpy(target), 6,
                          per_sample=per_sample)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if not per_sample:
        np.testing.assert_allclose(seg_scores_from_hist(*got), JM.seg_scores_from_hist(*ref))


def test_segmentation_metric_matches_jax(rng):
    pred = rng.integers(-1, 7, (3, 10, 12)).astype(np.int32)
    target = rng.integers(-1, 6, (3, 10, 12)).astype(np.int32)
    ref = JM.SegmentationMetric(6)
    ref.update(pred, target)
    ref.update(list(pred), list(target))
    for mode in ("numpy", "tensor", "stats"):
        m = SegmentationMetric(6)
        if mode == "numpy":
            m.update(pred, target)
            m.update(list(pred), list(target))
        elif mode == "tensor":
            m.update(torch.from_numpy(pred), torch.from_numpy(target))
            m.update([torch.from_numpy(p) for p in pred], [torch.from_numpy(t) for t in target])
        else:
            stats = seg_hist_update(torch.from_numpy(pred), torch.from_numpy(target), 6,
                                    per_sample=True)
            for _ in range(2):
                for i in range(3):
                    m.update_stats(*(s[i] for s in stats))
        assert m.get() == pytest.approx(ref.get(), rel=1e-12), mode
        np.testing.assert_allclose(m.per_class_iou(), ref.per_class_iou())
        m.reset()
        assert m.total_label == 0 and not m.total_inter.any()
