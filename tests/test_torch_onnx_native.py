"""The port's self-contained ONNX emitter and evaluator
(``fastscnn_tpu_torch/engine/onnx_native.py``) against the JAX package's,
on the CPU.

The same weights (JAX-initialised, carried over by ``from_jax_params``)
are folded by each package and emitted: the graphs must have the same
nodes, op types, attributes, names, initializer shapes and graph inputs
and outputs, with the initializers equal within f32 rounding (the two
folds round in different orders). The two evaluators must give equal
outputs on the same bytes, and the port's artifact must agree with the
port's engine (masks on ≥ 99.9 % of pixels, probabilities within rtol 1e-4
and atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastscnn_tpu.engine import onnx_native as J
from fastscnn_tpu.models.fast_scnn import FastSCNN as JaxFastSCNN
from fastscnn_tpu.models.fast_scnn import fold_inference_params as jax_fold
from fastscnn_tpu.models.fast_scnn import init_fast_scnn as jax_init
from fastscnn_tpu_torch.engine import IMAGENET_MEAN, IMAGENET_STD, E2EConfig, InferenceEngine
from fastscnn_tpu_torch.engine import onnx_native as P
from fastscnn_tpu_torch.models import FastSCNN, from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes here are small, and under the
    suite's parallel workers the default pool's spinning threads take the
    cores the other workers need."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(num_classes, aux=False, seed=0, **knobs):
    """(JAX model, its folded numpy tree, port model, its folded numpy tree)
    on the same JAX-initialised weights, BN statistics perturbed so the
    masks hold several classes."""
    params, state = jax_init(jax.random.PRNGKey(seed), num_classes, aux)
    rng = np.random.default_rng(seed)

    def perturb(path, v):
        name = jax.tree_util.keystr(path)
        if "mean" in name:
            return jnp.asarray(rng.uniform(-0.05, 0.05, v.shape), v.dtype)
        if "var" in name:
            return jnp.asarray(rng.uniform(0.05, 0.2, v.shape), v.dtype)
        return v

    state = jax.tree_util.tree_map_with_path(perturb, state)
    jm = JaxFastSCNN(num_classes=num_classes, aux=aux, **knobs)
    jf = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      jax_fold(params, state, dtype=jnp.float32))
    pm = FastSCNN(num_classes, aux=aux, **knobs)
    pm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                       jax.tree.map(np.asarray, state)))
    return jm, jf, pm.eval(), P.folded_numpy(pm)


def _uint8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


def _structure(parsed):
    g = parsed.graph
    return (parsed.ir_version, parsed.opset, parsed.producer, g.name,
            [(n.op_type, n.name, n.inputs, n.outputs, n.attrs) for n in g.nodes],
            {k: (v.dtype, v.shape) for k, v in g.initializers.items()},
            [(v.name, v.shape, v.elem_type) for v in g.inputs],
            [(v.name, v.shape, v.elem_type) for v in g.outputs])


CASES = [
    dict(num_classes=2, shape=(1, 3, 64, 128), output="mask"),
    dict(num_classes=19, shape=(2, 3, 64, 128), output="softmax", internal_size=(96, 192),
         mean=IMAGENET_MEAN, std=IMAGENET_STD),
    dict(num_classes=3, aux=True, shape=(1, 3, 96, 128), output="logits", include_aux=True),
    dict(num_classes=4, shape=(1, 3, 192, 384), output="mask"),  # every pool divides
    dict(num_classes=2, shape=(1, 3, 120, 160), output="mask", internal_size=(128, 128)),
    dict(num_classes=5, shape=(1, 3, 256, 512), output="softmax", ppm_sizes=(1, 2, 4, 8),
         ppm_align_corners=False),
]


def _split(case):
    case = dict(case)
    model_kw = {k: case.pop(k) for k in ("num_classes", "aux", "ppm_sizes", "ppm_align_corners")
                if k in case}
    return model_kw, case.pop("shape"), case


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c['num_classes']}cls-{c['output']}"
                         f"-{c['shape'][2]}x{c['shape'][3]}")
def test_emitted_graph_equals_jax_and_evaluators_agree(case):
    """Equal structure, initializers within f32 rounding, and both
    evaluators equal on the port's bytes."""
    model_kw, shape, emit_kw = _split(case)
    jm, jf, pm, pf = _models(seed=model_kw["num_classes"], **model_kw)
    pbytes = P.emit_fastscnn_onnx(pm, pf, shape, **emit_kw)
    jbytes = J.emit_fastscnn_onnx(jm, jf, shape, **emit_kw)
    assert len(pbytes) == len(jbytes)
    pp, jp = P.parse_onnx(pbytes), J.parse_onnx(jbytes)
    assert _structure(pp) == _structure(jp)
    for name, ref in jp.graph.initializers.items():
        got = pp.graph.initializers[name]
        scale = max(float(np.abs(ref).max()), 1.0) if ref.size else 1.0
        np.testing.assert_allclose(got, ref, rtol=0, atol=4 * np.finfo(np.float32).eps * scale,
                                   err_msg=name)
    if shape[2] * shape[3] > 128 * 256:
        return  # structure only at the larger sizes: the evaluator is timed elsewhere
    x = _uint8(shape[:1] + shape[2:] + (3,), seed=1).transpose(0, 3, 1, 2).astype(np.float32)
    got = P.run_onnx(pp, {"images": x})
    ref = J.run_onnx(J.parse_onnx(pbytes), {"images": x})
    assert got.keys() == ref.keys()
    for k in got:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


@pytest.mark.parametrize("mode", ["mask", "softmax"])
@pytest.mark.parametrize("internal", [None, (96, 160)])
def test_artifact_agrees_with_the_ports_engine(mode, internal):
    """The port's artifact through the port's evaluator against the port's
    f32 engine ('gather': the evaluator's two-tap lerp): masks on ≥ 99.9 %
    of pixels (int64 against int32: values compared), probabilities at the
    tolerance the port's engine meets against JAX's (rtol 1e-4, atol 1e-5:
    numpy's and PyTorch's convolutions sum in different orders)."""
    _, _, pm, _ = _models(6, seed=3)
    # moderate logits: BN statistics from one train-mode pass over a
    # calibration batch (the perturbed statistics give logits of ~1e4, where
    # softmax saturates and a near-tie flips a whole probability)
    for bn in (m for m in pm.modules() if isinstance(m, torch.nn.BatchNorm2d)):
        bn.reset_running_stats()
        bn.momentum = None
    calib = torch.from_numpy(_uint8((2, 64, 128, 3), seed=2)).float() / 255
    pm.train()
    with torch.no_grad():
        pm((calib - torch.tensor(IMAGENET_MEAN)) / torch.tensor(IMAGENET_STD))
    pm.eval()
    pf = P.folded_numpy(pm)
    images = _uint8((2, 64, 128, 3), seed=4)
    cfg = dict(internal_size=internal, mean=IMAGENET_MEAN, std=IMAGENET_STD)
    eng = InferenceEngine(pm, device="cpu", config=E2EConfig(
        compute_dtype="float32", final_upsample="gather", softmax=mode == "softmax", **cfg))
    data = P.emit_fastscnn_onnx(pm, pf, (2, 3, 64, 128), output=mode, **cfg)
    out = P.run_onnx(P.parse_onnx(data), {"images": images.transpose(0, 3, 1, 2)
                                          .astype(np.float32)})
    ref = eng.predict(images).numpy()
    if mode == "mask":
        assert out["mask"].dtype == np.int64 and out["mask"].shape == ref.shape
        assert len(np.unique(ref)) > 1
        assert (out["mask"] == ref).mean() >= 0.999
    else:
        np.testing.assert_allclose(out["probs"].transpose(0, 2, 3, 1), ref, rtol=1e-4, atol=1e-5)


def test_onnx_artifact_callable_matches_the_evaluator(tmp_path):
    """``OnnxArtifact`` (no onnxruntime here: the numpy evaluator) takes
    uint8 NHWC and returns the engine's layout."""
    _, _, pm, pf = _models(3, seed=5)
    path = str(tmp_path / "m.onnx")
    for output, key in (("softmax", "probs"), ("mask", "mask")):
        P.emit_fastscnn_onnx(pm, pf, (1, 3, 64, 96), path, output=output)
        art = P.OnnxArtifact(path)
        assert art.shape == (1, 64, 96, 3) and art.backend == "numpy"
        images = _uint8(art.shape, seed=6)
        ref = P.run_onnx(art.model, {"images": images.transpose(0, 3, 1, 2)
                                     .astype(np.float32)})[key]
        got = art(images)
        want = ref.transpose(0, 2, 3, 1) if ref.ndim == 4 else ref
        assert np.array_equal(got, want)


def test_atc_compat_grid_uses_fixed_pools_only():
    """The JAX ``test_atc_compat_grid_uses_fixed_pools_only`` on the port:
    ppm_sizes=(1, 2, 4, 8) at 256×512 (an 8×16 base) emits AveragePool
    only; the training grid at the same size needs the exact MatMul bins."""
    _, _, pm, pf = _models(2, seed=8, ppm_sizes=(1, 2, 4, 8), ppm_align_corners=False)
    ops = {n.op_type for n in P.parse_onnx(
        P.emit_fastscnn_onnx(pm, pf, (1, 3, 256, 512), output="mask")).graph.nodes}
    assert "MatMul" not in ops and "AveragePool" in ops
    resizes = [n for n in P.parse_onnx(P.emit_fastscnn_onnx(pm, pf, (1, 3, 256, 512))).graph.nodes
               if n.op_type == "Resize"]
    assert sum(n.attrs["coordinate_transformation_mode"] == "half_pixel" for n in resizes) == 4
    base = pm.with_options(ppm_sizes=(1, 2, 3, 6), ppm_align_corners=True)
    ops = [n.op_type for n in P.parse_onnx(
        P.emit_fastscnn_onnx(base, pf, (1, 3, 256, 512), output="mask")).graph.nodes]
    assert ops.count("MatMul") == 2 * 2  # bins 3 and 6 do not divide 8 x 16


def test_emission_is_deterministic_and_wellformed():
    _, _, pm, pf = _models(2, seed=7)
    a = P.emit_fastscnn_onnx(pm, pf, (1, 3, 96, 128), output="mask")
    assert a == P.emit_fastscnn_onnx(pm, pf, (1, 3, 96, 128), output="mask")
    parsed = P.parse_onnx(a)
    assert parsed.opset == 13 and parsed.ir_version == 7
    known = {"images", ""} | set(parsed.graph.initializers)
    for node in parsed.graph.nodes:
        for name in node.inputs:
            assert name in known, f"{node.op_type} reads undefined {name!r}"
        known.update(node.outputs)
    with pytest.raises(ValueError, match="mask\\|softmax\\|logits"):
        P.emit_fastscnn_onnx(pm, pf, (1, 3, 96, 128), output="argmax")
    with pytest.raises(ValueError, match="C=3"):
        P.emit_fastscnn_onnx(pm, pf, (1, 1, 96, 128))


def test_folded_numpy_is_the_ports_f32_fold():
    _, _, pm, pf = _models(2, aux=True, seed=9)
    from fastscnn_tpu_torch.models import fold_inference_params
    from fastscnn_tpu_torch.utils.tree import tree_leaves

    ref = tree_leaves(fold_inference_params(pm, dtype=torch.float32))
    got = tree_leaves(pf)
    assert len(got) == len(ref) and "auxlayer" in pf
    assert all(g.dtype == np.float32 and np.array_equal(g, r.numpy()) for g, r in zip(got, ref))
