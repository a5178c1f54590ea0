"""The port's tools (``fastscnn_tpu_torch/tools``) against the JAX
package's on the same inputs.

Tolerances:
- ``generate_dataset``: the same file names, and every PNG decodes to the
  same array (the JAX tree written by PIL, the port's by ``write_png``);
- ``gen_citys19_scenes``, ``gen_lane2_scenes``, ``confusion_scores``,
  ``boundary_distance_hist``, ``fake_quant_array`` and
  ``quantize_folded_weights`` (on one folded tree): bit-equal;
- ``calibrate_act_scales``: the same 47 sites with the same shapes; the
  scales of the LTD's six sites within 2 bf16 ulps (``2**-7`` relative)
  of JAX's, every scale within ``SCALE_RTOL`` = 8 %. The bf16 forwards
  round at different places (XLA fuses elementwise bf16 chains, PyTorch
  rounds each op), and a site's max |x| is one element, so the
  differences compound with depth: measured 0.7 % at most in the LTD, and
  6.0 % at the PPM's output conv (site 36) on these weights;
- ``_mask_fn`` and ``eval_modes``: first the same graphs in f32 (the
  mask function with the same quantized weights and hook, each mode's
  engine), where rounding hides nothing: the 1/8 logits equal JAX's
  within ``F32_RTOL`` (2e-5) × the largest |logit| (measured 3e-7; the
  int8 grid moves them by 0.19). Then bf16: the port's 1/8 bf16 logits
  no farther from JAX's f32 logits of the same function than
  ``LOGIT_FACTOR`` (2) × JAX's own bf16 logits are: two bf16 computations
  of one f32 function, each rounding at its own places. On these random
  weights bf16 rounding alone moves the logits far (JAX bf16 against JAX
  f32: 15 % of the largest |logit|, more with the w8a8 hook's int8 levels
  flipping; BN statistics from larger batches or floored variances do not
  tame it), so no fixed fraction of the logits would separate a fault
  from rounding; the port measured 0.64× to 1.46× of JAX's distance
  across these cases and torch's thread counts. Then the masks: equal on
  every pixel whose decision is not a near-tie. A pixel may differ only where the JAX bf16 logits,
  interpolated in f64 to the resolution the mode argmaxes at, put the two
  classes within 2 × (the largest |port − JAX| of the 1/8 logits + 2 bf16
  ulps of the largest logit, the rounding of the mask head's two bf16
  interpolation passes). A raw agreement share would not do: bf16
  near-ties on these weights flip pixels in runs (9 % of ``_mask_fn``'s
  bf16 pixels, 26 % with the w8a8 hook, 8-11 % of each ``eval_modes``
  mask, every one within the rule);
- ``compare_backends``: the same pairs as JAX's; the f32 engine against
  the port's own f32 eval-mode ``FastSCNN`` fed NCHW floats, 0 pixels.

The weights are a JAX initialisation with BN statistics taken from one
train-mode pass over a calibration batch, so masks have many classes.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastscnn_tpu.engine.infer import IMAGENET_MEAN, IMAGENET_STD
from fastscnn_tpu.models import FastSCNN as JaxFastSCNN
from fastscnn_tpu.models import fold_inference_params as jax_fold
from fastscnn_tpu.models import init_fast_scnn as jax_init
from fastscnn_tpu.tools import argmax_first_study as jax_afs
from fastscnn_tpu.tools import compare_backends as jax_cb
from fastscnn_tpu.tools import quant_study as jax_qs
from fastscnn_tpu.tools import system_check as jax_sc
from fastscnn_tpu_torch.data import image_io
from fastscnn_tpu_torch.models import FastSCNN, fold_inference_params, to_param_trees
from fastscnn_tpu_torch.ops.cuda import launch_counts
from fastscnn_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from fastscnn_tpu_torch.tools import argmax_first_study as afs
from fastscnn_tpu_torch.tools import compare_backends as cb
from fastscnn_tpu_torch.tools import quant_study as qs
from fastscnn_tpu_torch.tools import system_check as sc
from fastscnn_tpu_torch.utils.tree import tree_leaves

NUM_CLASSES = 19
SHAPE = (2, 64, 128, 3)
SCALE_RTOL = 0.08
LOGIT_FACTOR = 2.0
F32_RTOL = 2e-5
BF16_ULP = 2.0**-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes here are small, and under the
    suite's parallel workers the default pool's spinning threads take the
    cores the other workers need."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# shared weights


@pytest.fixture(scope="module")
def weights():
    """(JAX params, JAX state, the port's model with the same weights,
    images): a JAX init with BN statistics from one train-mode pass of
    the port's model over a calibration batch, carried back to JAX."""
    from fastscnn_tpu_torch.models import from_jax_params

    params, state = jax_init(jax.random.PRNGKey(1), NUM_CLASSES, aux=True)
    model = FastSCNN(NUM_CLASSES, aux=True)
    model.load_state_dict(from_jax_params(*jax.tree_util.tree_map(np.asarray, (params, state))))
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None
    rng = np.random.default_rng(1)
    calib = rng.integers(0, 256, SHAPE).astype(np.float32)
    model.train()
    with torch.no_grad():
        model((torch.from_numpy(calib) / 255 - torch.tensor(IMAGENET_MEAN))
              / torch.tensor(IMAGENET_STD))
    model.eval()
    jparams, jstate = (jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)
                       for tree in to_param_trees(model))
    images = rng.integers(0, 256, SHAPE).astype(np.uint8)
    return jparams, jstate, model, images


@pytest.fixture(scope="module")
def folded(weights):
    """The JAX bf16 folded tree and the port's own, and the JAX model."""
    jparams, jstate, model, _ = weights
    return (JaxFastSCNN(NUM_CLASSES, aux=True), jax_fold(jparams, jstate, dtype=jnp.bfloat16),
            fold_inference_params(model, torch.bfloat16))


def _labels(rng, shape, num_classes):
    labels = rng.integers(0, num_classes, shape).astype(np.int32)
    labels[rng.random(shape) < 0.1] = -1
    return labels


# ---------------------------------------------------------------------------
# generators


def test_generate_dataset_writes_the_jax_tree(tmp_path):
    kw = dict(n_train=3, n_val=2, height=40, width=72, seed=3)
    jax_sc.generate_dataset(str(tmp_path / "jax"), **kw)
    assert sc.generate_dataset(str(tmp_path / "port"), **kw) == str(tmp_path / "port")

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    names = files(tmp_path / "jax")
    assert names == files(tmp_path / "port") and len(names) == 10
    from PIL import Image

    for name in names:
        ref = image_io.read_image(str(tmp_path / "jax" / name))
        got = image_io.read_image(str(tmp_path / "port" / name))
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / name)), ref)


@pytest.mark.parametrize("gen", ["gen_citys19_scenes", "gen_lane2_scenes"])
@pytest.mark.parametrize("seed", [0, 107])
def test_scene_generators_are_bit_equal(gen, seed):
    got = getattr(afs, gen)(3, 40, 72, seed=seed)
    ref = getattr(jax_afs, gen)(3, 40, 72, seed=seed)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# metrics


def _blocky(rng, n, h, w, num_classes, block):
    cells = rng.integers(0, num_classes, (n, h // block, w // block))
    return cells.repeat(block, 1).repeat(block, 2).astype(np.int32)


@pytest.mark.parametrize("num_classes", [2, 19])
def test_confusion_scores_equal_jax(num_classes):
    rng = np.random.default_rng(num_classes)
    gt = _blocky(rng, 3, 48, 64, num_classes, 8)
    gt[rng.random(gt.shape) < 0.1] = -1
    pred = np.where(rng.random(gt.shape) < 0.2, rng.integers(0, num_classes, gt.shape),
                    np.maximum(gt, 0)).astype(np.int32)
    assert afs.confusion_scores(pred, gt, num_classes) == jax_afs.confusion_scores(
        pred, gt, num_classes)


@pytest.mark.parametrize("max_d", [2, 16])
def test_boundary_distance_hist_equals_jax(max_d):
    rng = np.random.default_rng(max_d)
    exact = _blocky(rng, 2, 64, 96, 5, 16)
    exact[0, :4] = -1  # ignore labels are a class of their own here
    other = exact.copy()
    flip = rng.random(exact.shape) < 0.02
    other[flip] = rng.integers(0, 5, int(flip.sum()))
    got = afs.boundary_distance_hist(exact, other, max_d=max_d)
    assert got == jax_afs.boundary_distance_hist(exact, other, max_d=max_d)
    assert got["n_disagree"] > 0 and (max_d == 16 or got["beyond"] > 0)
    same = afs.boundary_distance_hist(exact, exact)
    assert same == jax_afs.boundary_distance_hist(exact, exact) and same["n_disagree"] == 0


# ---------------------------------------------------------------------------
# quant_study


@pytest.mark.parametrize("per_channel", [True, False])
def test_fake_quant_array_is_bit_equal(per_channel):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 3, 16, 24)).astype(np.float32) * 0.3
    w[..., 5] = 0.0  # a zero channel takes the scale of 1
    got = qs.fake_quant_array(w, per_channel)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_qs.fake_quant_array(w, per_channel))


def _paths(tree, path=""):
    """{path of a parent of a 'w' leaf: the leaf} of a folded tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            p = f"{path}/{k}" if path else k
            if k == "w":
                out[path] = v
            else:
                out.update(_paths(v, p))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_paths(v, f"{path}[{i}]"))
    return out


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("skip", [(), "ends"])
def test_quantize_folded_weights_equals_jax(folded, per_channel, skip):
    """One folded tree (JAX's bf16 fold, its leaves carried across exactly)
    through both packages' quantizers: every leaf equal, and with the
    skip-ends paths their kernels untouched."""
    _, jtree, _ = folded
    skip_paths = qs._SKIP_END_PATHS if skip else ()
    ptree = jax.tree_util.tree_map(
        lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16), jtree)
    got = qs.quantize_folded_weights(ptree, per_channel=per_channel, skip_paths=skip_paths)
    ref = jax_qs.quantize_folded_weights(jtree, per_channel=per_channel, skip_paths=skip_paths)
    got_leaves, ref_leaves = tree_leaves(got), jax.tree_util.tree_leaves(ref)
    assert len(got_leaves) == len(ref_leaves) == len(tree_leaves(ptree))
    for a, b in zip(got_leaves, ref_leaves):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(b, np.float32))
    kept = {p: w for p, w in _paths(got).items() if any(s in p for s in skip_paths)}
    assert len(kept) == (3 if skip else 0)
    source = _paths(ptree)
    for p, w in kept.items():
        assert torch.equal(w, source[p])
    changed = [p for p, w in _paths(got).items() if not torch.equal(w, source[p])]
    assert len(changed) > 40 and not set(changed) & set(kept)


def test_skip_end_paths_name_leaves_of_the_ports_folded_tree(folded):
    paths = _paths(folded[2])
    for s in qs._SKIP_END_PATHS:
        assert any(s in p for p in paths), s
    assert qs._SKIP_END_PATHS == jax_qs._SKIP_END_PATHS


def test_calibrate_act_scales_match_jax(weights, folded):
    _, _, model, images = weights
    jmodel, jtree, ptree = folded
    rng = np.random.default_rng(5)
    batches = [images, rng.integers(0, 256, SHAPE).astype(np.uint8)]
    scales, shapes = qs.calibrate_act_scales(model, ptree, batches)
    jscales, jshapes = jax_qs.calibrate_act_scales(jmodel, jtree, batches)
    assert shapes == [tuple(s) for s in jshapes] and len(scales) == len(jscales) == 47
    np.testing.assert_allclose(scales[:6], jscales[:6], rtol=2 * BF16_ULP)
    np.testing.assert_allclose(scales, jscales, rtol=SCALE_RTOL)


def _jax_logits(jmodel, jtree, images, hook=None, dtype=jnp.bfloat16):
    """The JAX mask function's 1/8 logits (its normalisation, its hook),
    in ``dtype`` (the tree's)."""
    qmodel = dataclasses.replace(jmodel, act_fake_quant=hook) if hook else jmodel
    mean = jnp.asarray(IMAGENET_MEAN, dtype)
    std = jnp.asarray(IMAGENET_STD, dtype)

    def fn(x):
        if hook is not None:
            hook._idx = 0
        x = (x.astype(dtype) / 255.0 - mean) / std
        return qmodel.apply_folded(jtree, x, upsample_outputs=False)[0]

    return np.asarray(jax.jit(fn)(jnp.asarray(images)), np.float32)


def _decision_logits(l8, net_size, out_size, argmax_first=False):
    """The JAX 1/8 logits where a mode argmaxes them: interpolated in f64
    (align_corners=True) to the network's input size, or kept at 1/8 for
    'argmax-first'; then expanded nearest to the output size."""
    z = torch.from_numpy(l8).double()
    if not argmax_first:
        z = resize_bilinear(z, net_size, align_corners=True)
    return resize_nearest(z, out_size).numpy()


def _assert_near(got, ref, z, tol):
    """Masks equal on every pixel whose two classes are more than 2·tol
    apart in the decision logits ``z``."""
    assert got.shape == ref.shape and len(np.unique(ref)) > 1
    diff = got != ref
    if diff.any():
        za = np.take_along_axis(z, got[..., None].astype(np.int64), -1)[..., 0][diff]
        zb = np.take_along_axis(z, ref[..., None].astype(np.int64), -1)[..., 0][diff]
        gap = np.abs(za - zb).max()
        print(f"{diff.mean():.4f} of pixels differ, their largest JAX gap {gap:.4g} "
              f"<= {2 * tol:.4g}")
        assert gap <= 2 * tol, (gap, tol, diff.mean())
    return diff.mean()


def _logit_tol(pl, jl, jl32):
    """Gate the port's bf16 1/8 logits ``pl`` against JAX's f32 ones
    ``jl32`` by JAX's own bf16 distance (``jl``); return the tolerance of
    the near-tie rule."""
    ours, theirs = np.abs(pl - jl32).max(), np.abs(jl - jl32).max()
    print(f"bf16 logits against JAX's f32: the port {ours:.4g}, JAX {theirs:.4g} "
          f"({ours / theirs:.3f}x); largest |logit| {np.abs(jl32).max():.4g}")
    assert ours <= LOGIT_FACTOR * theirs, (ours, theirs)
    return np.abs(pl - jl).max() + 2 * BF16_ULP * np.abs(jl).max()


@pytest.mark.parametrize("variant", ["bf16", "w8a8"])
def test_mask_fn_matches_jax(weights, folded, variant):
    """``_mask_fn`` (B2's plain version on the CPU) with and without the
    fake-quant hook: logits and masks against JAX's; with the hook, a
    second call equals the first (the site counter restarts each call)."""
    jparams, jstate, model, images = weights
    jmodel, jtree, ptree = folded
    jtree32 = jax_fold(jparams, jstate, dtype=jnp.float32)
    scales = None
    if variant == "w8a8":
        scales, _ = jax_qs.calibrate_act_scales(jmodel, jtree, [images])
        ptree = qs.quantize_folded_weights(ptree, per_channel=True)
        jtree = jax_qs.quantize_folded_weights(jtree, per_channel=True)
        jtree32 = jax_qs.quantize_folded_weights(jtree32, per_channel=True)
    hook = qs.ActQuantHook(calibrate=False, scales=scales) if scales else None
    before = launch_counts()
    fn = qs._mask_fn(model, ptree, act_hook=hook)
    got = fn(images).numpy()
    assert launch_counts() == before and got.dtype == np.int32
    if hook is not None:
        np.testing.assert_array_equal(fn(torch.from_numpy(images)).numpy(), got)
    ref = np.asarray(jax_qs._mask_fn(
        jmodel, jtree, jax_qs.ActQuantHook(calibrate=False, scales=scales) if scales else None)(
        jnp.asarray(images)))
    jl, jl32 = (_jax_logits(jmodel, tree, images, jax_qs.ActQuantHook(
        calibrate=False, scales=scales) if scales else None, dtype)
        for tree, dtype in ((jtree, jnp.bfloat16), (jtree32, jnp.float32)))
    qmodel = model.with_options(act_fake_quant=hook) if hook else model
    if hook is not None:
        hook._idx = 0
    with torch.inference_mode():
        pl = qmodel.apply_folded(ptree, qs._preprocess(images, "cpu"),
                                 upsample_outputs=False)[0].float().numpy()
    tol = _logit_tol(pl, jl, jl32)
    _assert_near(got, ref, _decision_logits(jl, SHAPE[1:3], SHAPE[1:3]), tol)
    # the same graph in f32, where rounding hides nothing: the port's
    # quantized weights and hook against JAX's f32 logits
    ptree32 = fold_inference_params(model, torch.float32)
    if hook is not None:
        ptree32 = qs.quantize_folded_weights(ptree32, per_channel=True)
        hook._idx = 0
    with torch.inference_mode():
        pl32 = qmodel.apply_folded(ptree32, qs._preprocess(images, "cpu", torch.float32),
                                   upsample_outputs=False)[0].numpy()
    np.testing.assert_allclose(pl32, jl32, rtol=0, atol=F32_RTOL * np.abs(jl32).max())


def test_evaluate_scores_its_masks(weights, folded):
    _, _, model, images = weights
    _, _, ptree = folded
    masks = _labels(np.random.default_rng(3), SHAPE[:3], NUM_CLASSES)
    fn = qs._mask_fn(model, ptree)
    pred, pixacc, miou, iou = qs.evaluate(fn, images, masks, NUM_CLASSES, batch=1)
    np.testing.assert_array_equal(pred, fn(images).numpy())
    ref = jax_qs.evaluate(lambda x: pred, images, masks, NUM_CLASSES, batch=len(images))
    assert (pixacc, miou) == (ref[1], ref[2])
    np.testing.assert_array_equal(iou, ref[3])


# ---------------------------------------------------------------------------
# argmax_first_study.eval_modes


def test_eval_modes_match_jax(weights, monkeypatch):
    """Both packages' ``eval_modes`` on one set of weights: the same rows;
    each mode's mask (captured where it is scored) near JAX's by the
    near-tie rule; and every number of the port's row the JAX metric of
    the port's own masks."""
    jparams, jstate, model, images = weights
    labels = _labels(np.random.default_rng(4), SHAPE[:3], NUM_CLASSES)
    internal = (48, 48)
    seen = {"port": [], "jax": []}
    for mod, key in ((afs, "port"), (jax_afs, "jax")):
        real = mod.confusion_scores
        monkeypatch.setattr(mod, "confusion_scores",
                            lambda pred, gt, n, real=real, key=key: (
                                seen[key].append(np.asarray(pred)), real(pred, gt, n))[1])
    norm = (IMAGENET_MEAN, IMAGENET_STD)
    params, state = to_param_trees(model)
    port_state = types.SimpleNamespace(params=params, model_state=state)
    before = launch_counts()
    got = afs.eval_modes(FastSCNN(NUM_CLASSES, aux=True), port_state, norm, images, labels,
                         NUM_CLASSES, internal, device="cpu")
    assert launch_counts() == before
    jmodel = JaxFastSCNN(NUM_CLASSES, aux=True)
    ref = jax_afs.eval_modes(jmodel, types.SimpleNamespace(params=jparams, model_state=jstate),
                             norm, images, labels, NUM_CLASSES, internal)
    assert list(got) == list(ref) == ["exact", "argmax-first", "ref-deploy"]
    masks = dict(zip(got, seen["port"]))
    for name, row in got.items():
        assert set(row) == set(ref[name])
        assert row == {**jax_afs.confusion_scores(masks[name], labels, NUM_CLASSES),
                       **({} if name == "exact" else {
                           "agreement_vs_exact": float(np.mean(masks[name] == masks["exact"])),
                           "boundary_hist_vs_exact": jax_afs.boundary_distance_hist(
                               masks["exact"], masks[name])})}

    from fastscnn_tpu.engine import E2EConfig as JaxE2EConfig
    from fastscnn_tpu.engine import InferenceEngine as JaxEngine
    from fastscnn_tpu_torch.engine import E2EConfig, InferenceEngine

    for (name, mask), jmask in zip(masks.items(), seen["jax"]):
        cfg = dict(mean=IMAGENET_MEAN, std=IMAGENET_STD, compute_dtype="bfloat16",
                   final_upsample="argmax-first" if name == "argmax-first" else "hybrid",
                   internal_size=internal if name == "ref-deploy" else None)
        jl, jl32 = (np.asarray(jax.jit(lambda x, e=JaxEngine(
            jmodel, jparams, jstate, config=JaxE2EConfig(**{**cfg, "compute_dtype": dtype})):
            e._forward(x, upsample=False))(jnp.asarray(images)), np.float32)
            for dtype in ("bfloat16", "float32"))
        with torch.inference_mode():
            pl, pl32 = (InferenceEngine(model, device="cpu", config=E2EConfig(
                **{**cfg, "compute_dtype": dtype}))._forward(
                torch.from_numpy(images), upsample=False).float().numpy()
                for dtype in ("bfloat16", "float32"))
        np.testing.assert_allclose(pl32, jl32, rtol=0, atol=F32_RTOL * np.abs(jl32).max())
        net = internal if name == "ref-deploy" else SHAPE[1:3]
        z = _decision_logits(jl, net, SHAPE[1:3], argmax_first=name == "argmax-first")
        _assert_near(mask, jmask, z, _logit_tol(pl, jl, jl32))


# ---------------------------------------------------------------------------
# compare_backends


class _NCHW(torch.nn.Module):
    """The port's NHWC FastSCNN as a module fed NCHW floats, logits NCHW."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x):
        return tuple(o.permute(0, 3, 1, 2) for o in self.net(x.permute(0, 2, 3, 1)))


def test_compare_backends_pairs_match_jax(weights):
    jparams, jstate, model, images = weights
    params, state = to_param_trees(model)
    net = FastSCNN(NUM_CLASSES, aux=True)
    net.load_state_dict(model.state_dict())
    torch_model = _NCHW(net.eval())
    got = cb.compare_backends(FastSCNN(NUM_CLASSES, aux=True), params, state, images,
                              IMAGENET_MEAN, IMAGENET_STD, torch_model=torch_model,
                              device="cpu")
    ref = jax_cb.compare_backends(JaxFastSCNN(NUM_CLASSES, aux=True), jparams, jstate, images,
                                  IMAGENET_MEAN, IMAGENET_STD, torch_model=torch_model)
    assert list(got) == list(ref) == ["f32_vs_bf16", "f32_vs_torch", "torch_vs_bf16"]
    assert got["f32_vs_torch"] == 0.0
    assert 0.0 <= got["f32_vs_bf16"] <= 1.0
    plain = cb.compare_backends(FastSCNN(NUM_CLASSES, aux=True), params, state, images,
                                device="cpu")
    assert list(plain) == list(jax_cb.compare_backends(
        JaxFastSCNN(NUM_CLASSES, aux=True), jparams, jstate, images)) == ["f32_vs_bf16"]


def test_compare_backends_export_path_raises(weights, tmp_path):
    """The artifact stage: a ``.pt2`` of the f32 engine (pair 'export') and
    an emitted ``.onnx`` (pair 'onnx', the JAX tool's pair on the same
    file) agree with the f32 engine; a path that is not a file adds no
    pair, as in JAX; an artifact of another batch shape raises."""
    from fastscnn_tpu_torch.engine import E2EConfig, InferenceEngine
    from fastscnn_tpu_torch.engine.export import export_torch
    from fastscnn_tpu_torch.engine.onnx_native import emit_fastscnn_onnx, folded_numpy

    jparams, jstate, model, images = weights
    params, state = to_param_trees(model)
    norm = dict(mean=IMAGENET_MEAN, std=IMAGENET_STD)
    eng = InferenceEngine(model, device="cpu", config=E2EConfig(compute_dtype="float32", **norm))
    pt2 = export_torch(eng, images.shape, str(tmp_path / "m.pt2"))
    onnx = str(tmp_path / "m.onnx")
    emit_fastscnn_onnx(model, folded_numpy(model), (2, 3, 64, 128), onnx, output="mask", **norm)
    for path, pair in ((pt2, "f32_vs_export"), (onnx, "f32_vs_onnx")):
        got = cb.compare_backends(FastSCNN(NUM_CLASSES, aux=True), params, state, images,
                                  export_path=path, device="cpu", **norm)
        assert list(got) == ["f32_vs_bf16", pair] and got[pair] <= 1e-3
    ref = jax_cb.compare_backends(JaxFastSCNN(NUM_CLASSES, aux=True), jparams, jstate, images,
                                  export_path=onnx, **norm)
    assert list(ref) == ["f32_vs_bf16", "f32_vs_onnx"] and ref["f32_vs_onnx"] <= 1e-3
    for path in (str(tmp_path / "missing.onnx"), str(tmp_path)):
        got = cb.compare_backends(FastSCNN(NUM_CLASSES, aux=True), params, state, images,
                                  export_path=path, device="cpu", **norm)
        assert list(got) == ["f32_vs_bf16"]
    with pytest.raises(Exception):
        cb.compare_backends(FastSCNN(NUM_CLASSES, aux=True), params, state, images[:1],
                            export_path=pt2, device="cpu", **norm)


def test_compare_backends_main_reads_weights_and_pngs(weights, tmp_path, capsys):
    """``main`` with ``--weights`` (a ``.pth`` of the port's writer) and
    ``--image-dir`` (PNGs resized bilinearly without PIL): the gate's line
    and the pairs."""
    from fastscnn_tpu_torch.utils.checkpoint import save_pth_checkpoint

    params, state = to_param_trees(weights[2])
    path = save_pth_checkpoint(params, state, str(tmp_path), dataset="citys")
    frames = tmp_path / "frames"
    frames.mkdir()
    for i, img in enumerate(weights[3]):
        image_io.write_png(str(frames / f"f{i}.png"), img)
    argv = ["--dataset", "citys", "--aux", "--weights", path, "--image-dir", str(frames),
            "--height", "32", "--width", "96", "--device", "cpu", "--tolerance", "1.0"]
    out = cb.main(argv)
    assert list(out) == ["f32_vs_bf16"]
    assert "PARITY OK" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="PARITY FAIL"):
        cb.main(argv[:-2] + ["--tolerance", "-1"])


# ---------------------------------------------------------------------------
# the two mains, tiny


def _row_keys(row):
    return {k: (sorted(v) if isinstance(v, dict) else None) for k, v in row.items()}


def test_argmax_first_study_main_quick(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "study.json"
    before = launch_counts()
    report = afs.main(["--quick", "--device", "cpu", "--out", str(out)])
    assert launch_counts() == before
    import json

    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    assert list(report) == ["citys19", "lane2"]
    assert list(report["citys19"]) == ["exact", "argmax-first", "ref-deploy"]
    assert list(report["lane2"]) == ["exact", "argmax-first"]
    # the JAX rows' keys, from the JAX functions that make them
    scores = jax_afs.confusion_scores(np.zeros((2, 2), np.int32), np.zeros((2, 2), np.int32), 2)
    hist = jax_afs.boundary_distance_hist(np.zeros((2, 2), np.int32), np.ones((2, 2), np.int32))
    exact = {k: None for k in scores}
    other = {**exact, "agreement_vs_exact": None, "boundary_hist_vs_exact": sorted(hist)}
    for leg in report.values():
        for name, row in leg.items():
            assert _row_keys(row) == (exact if name == "exact" else other), name
            assert 0.0 <= row["pixAcc"] <= 1.0


def test_quant_study_main_tiny(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    result = qs.main(["--epochs", "1", "--height", "64", "--width", "128", "--n-train", "8",
                      "--n-val", "4", "--workdir", str(tmp_path / "w"), "--device", "cpu"])
    assert set(result) == {"rows", "val_images", "epochs"}
    assert (result["val_images"], result["epochs"]) == (4, 1)
    # the variants of fastscnn_tpu/tools/quant_study.py::main, in its order
    assert [r["variant"] for r in result["rows"]] == [
        "bf16-baseline", "w8-perchan", "w8-pertensor", "w8a8", "w8a8-skip-ends"]
    for row in result["rows"]:
        assert set(row) == {"variant", "mask_agreement", "pixacc", "miou", "miou_delta"}
        assert 0.0 <= row["mask_agreement"] <= 1.0
    assert os.path.exists(tmp_path / "w" / "weights" / "fast_scnn_citys.pth")
