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
    fold_inference_params,
    from_jax_params,
    init_fast_scnn,
    load_checkpoint,
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


@pytest.mark.parametrize("impl", ["conv", "pallas", "fused-ds"])
def test_apply_folded_matches_jax(shared, impl):
    """f32 folded graph, each LTD route: on the CPU JAX's 'pallas' and
    'fused-ds' take their XLA fallbacks, the port's its plain versions."""
    params, state, sd, x = shared
    jmodel = JaxFastSCNN(19, aux=True, folded_dw_impl=impl)
    ref = jmodel.apply_folded(jax_fold(params, state, jnp.float32), jnp.asarray(x))
    model = _port_model(sd, folded_dw_impl=impl)
    got = model.apply_folded(fold_inference_params(model, torch.float32), torch.from_numpy(x))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=ATOL)


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
def test_unported_options_name_their_roadmap_item(kwargs, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        FastSCNN(19, **kwargs)
