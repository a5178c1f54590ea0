"""The port's Fast-SCNN against the JAX package's, on shared weights.

Weights cross by value: JAX ``init_fast_scnn(PRNGKey(0), ...)`` → numpy
→ ``from_jax_params`` → ``FastSCNN.load_state_dict(strict=True)``. The
input is one numpy batch fed to both. All in f32; tolerance 2e-5 on
logits of magnitude ~0.1: the two packages' convolutions and BN sum in
different orders (measured differences are ~1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastscnn_tpu.models import FastSCNN as JaxFastSCNN
from fastscnn_tpu.models import fold_inference_params as jax_fold
from fastscnn_tpu.models import init_fast_scnn as jax_init
from fastscnn_tpu_torch.models import (
    FastSCNN,
    calibrate_pw_scales,
    fold_inference_params,
    from_jax_params,
    init_fast_scnn,
    load_checkpoint,
    quantized_model,
    to_param_trees,
)
from fastscnn_tpu_torch.models.convert import build_key_map

ATOL = 2e-5


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def shared():
    """JAX (params, state) with perturbed BN statistics, so folding and
    eval-mode BN do real work, and a port model loaded from them."""
    params, state = jax_init(jax.random.PRNGKey(0), 19, aux=True)
    rng = np.random.default_rng(0)

    def perturb(path, v):
        name = jax.tree_util.keystr(path)
        if "mean" in name:
            return jnp.asarray(rng.uniform(-0.1, 0.1, v.shape), v.dtype)
        if "var" in name:
            return jnp.asarray(rng.uniform(0.5, 1.5, v.shape), v.dtype)
        return v

    state = jax.tree_util.tree_map_with_path(perturb, state)
    sd = from_jax_params(_numpy_tree(params), _numpy_tree(state))
    x = rng.standard_normal((2, 64, 128, 3)).astype(np.float32)
    return params, state, sd, x


def _port_model(sd, aux=True, **kw):
    model = FastSCNN(19, aux=aux, **kw)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def test_state_dict_keys_are_the_reference_key_map(shared):
    _, _, sd, _ = shared
    model = FastSCNN(19, aux=True)
    keys = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert keys == {k for k, _, _ in build_key_map(aux=True)} == set(sd)
    no_aux = {k for k in FastSCNN(19).state_dict() if not k.endswith("num_batches_tracked")}
    assert no_aux == {k for k, _, _ in build_key_map(aux=False)}


def test_forward_matches_jax_apply(shared):
    params, state, sd, x = shared
    (ref_main, ref_aux), _ = JaxFastSCNN(19, aux=True).apply(params, state, jnp.asarray(x))
    with torch.no_grad():
        main, aux = _port_model(sd)(torch.from_numpy(x))
    np.testing.assert_allclose(main.numpy(), np.asarray(ref_main), rtol=1e-4, atol=ATOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(ref_aux), rtol=1e-4, atol=ATOL)


@pytest.mark.parametrize("impl", ["conv", "taps", "pallas", "fused-ds", "fused-ds-mr"])
def test_apply_folded_matches_jax(shared, impl):
    """f32 folded graph, each LTD route: on the CPU JAX's 'pallas',
    'fused-ds' and 'fused-ds-mr' take their XLA fallbacks, the port's its
    plain versions; 'taps' is plain code in both."""
    params, state, sd, x = shared
    jmodel = JaxFastSCNN(19, aux=True, folded_dw_impl=impl)
    ref = jmodel.apply_folded(jax_fold(params, state, jnp.float32), jnp.asarray(x))
    model = _port_model(sd, folded_dw_impl=impl)
    got = model.apply_folded(fold_inference_params(model, torch.float32), torch.from_numpy(x))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=ATOL)


def test_apply_folded_fused_ds_mr_equals_conv(shared):
    """f32: the LTD's DSConvs through B5 ('fused-ds-mr') against cuDNN
    ('conv') in the port's own graph, within 1e-5."""
    _, _, sd, x = shared
    base = _port_model(sd)
    folded = fold_inference_params(base, torch.float32)
    with torch.no_grad():
        ref = base.apply_folded(folded, torch.from_numpy(x))
        got = base.with_options(folded_dw_impl="fused-ds-mr").apply_folded(
            folded, torch.from_numpy(x))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


def test_fold_inference_params_matches_jax(shared):
    params, state, sd, _ = shared
    ref = jax_fold(params, state, jnp.float32)
    got = fold_inference_params(_port_model(sd), torch.float32)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    assert ref_def == got_def
    for g, r in zip(got_leaves, ref_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


def test_fold_inference_params_casts(shared):
    folded = fold_inference_params(_port_model(shared[2]), torch.bfloat16)
    leaves = jax.tree_util.tree_leaves(folded)
    assert leaves and all(v.dtype == torch.bfloat16 for v in leaves)


def test_load_checkpoint_accepts_the_three_dialects(shared, tmp_path):
    _, _, sd, _ = shared
    dialects = {
        "raw": sd,
        "module": {f"module.{k}": v for k, v in sd.items()},
        "dict": {"model": sd, "epoch": 3},
    }
    for name, obj in dialects.items():
        path = tmp_path / f"{name}.pth"
        torch.save(obj, path)
        for source in (obj, path):
            got = load_checkpoint(source)
            assert set(got) == set(sd), name
            FastSCNN(19, aux=True).load_state_dict(got, strict=True)
    with pytest.raises(TypeError):
        load_checkpoint([1, 2])


def test_init_fast_scnn_is_seeded_with_torch_default_bounds():
    a = init_fast_scnn(6, generator=torch.Generator().manual_seed(7), device="cpu")
    b = init_fast_scnn(6, generator=torch.Generator().manual_seed(7), device="cpu")
    c = init_fast_scnn(6, generator=torch.Generator().manual_seed(8), device="cpu")
    assert not a.training
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    conv = a.learning_to_downsample.dsconv1.conv[3]  # 1×1, fan_in 32
    assert conv.weight.abs().max() <= 32 ** -0.5
    assert not torch.equal(conv.weight, c.learning_to_downsample.dsconv1.conv[3].weight)
    bn = a.learning_to_downsample.dsconv1.conv[1]
    assert torch.equal(bn.weight, torch.ones(32)) and torch.equal(bn.running_var, torch.ones(32))


@pytest.mark.parametrize(
    "kwargs,item",
    [
        ({"folded_dw_impl": "taps"}, "'taps'"),
        ({"folded_dw_impl": "fused-ds-mr"}, "B5"),
        ({"folded_pw_impl": "int8-a8"}, "int8"),
        ({"act_fake_quant": lambda y: y}, "int8"),
        ({"stem_impl": "taps"}, "'taps'"),
    ],
)
def test_unported_options_name_their_roadmap_item(shared, kwargs, item):
    """Every option of the JAX model is ported now; these once raised,
    naming their ROADMAP.md item. B5's 'fused-ds-mr', the int8 sites of B7
    and the hook construct and serve: finite logits, and the identity hook
    changes nothing. 'taps' (the item ported last): the folded graph's
    masks equal 'conv''s on every pixel in f32, and the stem's train-mode
    forward equals 'xla''s (logits within 1e-4 of their largest
    magnitude; ``tests/test_torch_train_grads.py`` holds each stem to the
    JAX model's)."""
    if item == "'taps'":
        _, _, sd, x = shared
        model = _port_model(sd, **kwargs)
        if "folded_dw_impl" in kwargs:
            folded = fold_inference_params(model, torch.float32)
            with torch.no_grad():
                got = model.apply_folded(folded, torch.from_numpy(x))
                ref = _port_model(sd).apply_folded(folded, torch.from_numpy(x))
            for g, r in zip(got, ref):
                assert torch.equal(g.argmax(-1), r.argmax(-1))
            return
        p, st = to_param_trees(model)
        with torch.no_grad():
            outs = [m.apply_params(p, st, torch.from_numpy(x), training=True,
                                   upsample_outputs=False)[0]
                    for m in (model, model.with_options(stem_impl="xla"))]
        for got, ref in zip(*outs):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                                       atol=1e-4 * ref.abs().max().item())
        return
    _, _, sd, x = shared
    model = _port_model(sd, **kwargs)
    folded = fold_inference_params(model, torch.float32)
    if model.folded_pw_impl != "conv":
        scales = calibrate_pw_scales(model, folded, [x])
        model = quantized_model(model, scales, model.folded_pw_impl)
    with torch.no_grad():
        out = model.apply_folded(folded, torch.from_numpy(x))
        plain = _port_model(sd).apply_folded(folded, torch.from_numpy(x))
    assert len(out) == 2 and all(torch.isfinite(o.float()).all() for o in out)
    if model.act_fake_quant is not None:
        assert all(torch.equal(o, p) for o, p in zip(out, plain))


@pytest.mark.parametrize("impl", ["int8-a8", "int8-w8a8"])
def test_pw_use_pallas_routes_the_int8_sites(shared, impl):
    """``pw_use_pallas``: None and False both run the plain versions on a
    CPU tensor (equal logits; the JAX model's False is its XLA path, and
    the port's plain versions are held to JAX in ``test_torch_int8.py``);
    True on a CPU tensor raises; the option survives ``with_options``."""
    _, _, sd, x = shared
    base = _port_model(sd)
    folded = fold_inference_params(base, torch.float32)
    scales = calibrate_pw_scales(base, folded, [x])
    model = quantized_model(base, scales, impl)
    assert model.pw_use_pallas is None
    off = model.with_options(pw_use_pallas=False)
    assert off.pw_use_pallas is False and off.folded_pw_impl == impl
    with torch.no_grad():
        got = model.apply_folded(folded, torch.from_numpy(x))
        plain = off.apply_folded(folded, torch.from_numpy(x))
    for g, p in zip(got, plain):
        assert torch.isfinite(g.float()).all() and torch.equal(g, p)
    with pytest.raises(ValueError, match="pw_use_pallas=True.*CPU"):
        model.with_options(pw_use_pallas=True).apply_folded(folded, torch.from_numpy(x))
    with pytest.raises(ValueError, match="pw_use_pallas"):
        FastSCNN(19, pw_use_pallas="auto")
