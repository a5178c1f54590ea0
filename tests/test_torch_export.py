"""The port's export surface on the CPU: the ``torch.export`` artifact
(``engine/export.py``), the model's deployment-graph knobs and the export
CLI (``export_model.py``).

- The ``.pt2`` artifact equals the port's eager engine (masks equal,
  probabilities within 1e-5) and agrees with the JAX engine on the same
  weights at the tolerances of ``tests/test_torch_engine.py``: masks on
  ≥ 99.9 % of pixels in f32, probabilities rtol 1e-4 / atol 1e-5.
- ``ppm_sizes``/``ppm_align_corners`` at the reference's deployed grid,
  (1, 2, 4, 8) and False, match the JAX model's logits through every
  forward (rtol 1e-4), and the defaults are the training graph.
- Every kernel configuration (:data:`KERNEL_OPTIONS`) exports: its graph
  holds the kernel's operator once a call the eager path makes, its CPU
  artifact equals the eager engine bit for bit and agrees with the JAX
  engine on ≥ 99.9 % of pixels in f32 (config A also with the JAX
  package's own StableHLO artifact); a kernel artifact loads through
  ``load_exported``/``load_artifact`` in a fresh interpreter, moves to
  ``meta``, and refuses a bare ``torch.export.load`` without the port (the
  CLI is in ``tests/test_torch_export_cli.py``).
"""

import collections
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastscnn_tpu.engine import E2EConfig as JaxE2EConfig
from fastscnn_tpu.engine import InferenceEngine as JaxEngine
from fastscnn_tpu.models import FastSCNN as JaxFastSCNN
from fastscnn_tpu.engine.export import export_stablehlo
from fastscnn_tpu.engine.export import load_exported as jax_load_exported
from fastscnn_tpu.models import init_fast_scnn as jax_init
from fastscnn_tpu_torch.engine import IMAGENET_MEAN, IMAGENET_STD, E2EConfig, InferenceEngine
from fastscnn_tpu_torch.engine import export as X
from fastscnn_tpu_torch.models import FastSCNN, from_jax_params, to_param_trees
from fastscnn_tpu_torch.ops.cuda import launch_counts

SHAPE = (2, 64, 128, 3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes here are small, and under the
    suite's parallel workers the default pool's spinning threads take the
    cores the other workers need."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _calibrated(num_classes, aux, seed):
    """JAX-initialised weights with BN statistics from one train-mode pass
    of the port's model over a calibration batch (moderate logits, several
    classes in the masks), as (port model, JAX params, JAX state)."""
    params, state = jax_init(jax.random.PRNGKey(seed), num_classes, aux)
    model = FastSCNN(num_classes, aux=aux)
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          jax.tree.map(np.asarray, state)))
    for bn in (m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)):
        bn.reset_running_stats()
        bn.momentum = None
    calib = np.random.default_rng(seed + 100).integers(0, 256, SHAPE).astype(np.float32)
    model.train()
    with torch.no_grad():
        model((torch.from_numpy(calib) / 255 - torch.tensor(IMAGENET_MEAN))
              / torch.tensor(IMAGENET_STD))
    model.eval()
    jparams, jstate = (jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
                       for tree in to_param_trees(model))
    return model, jparams, jstate


CASES = [(2, False, None), (19, True, (48, 96))]


@pytest.mark.parametrize("num_classes, aux, internal", CASES)
def test_pt2_equals_the_eager_engine_and_agrees_with_jax(tmp_path, num_classes, aux, internal):
    model, jparams, jstate = _calibrated(num_classes, aux, seed=num_classes + aux)
    images = np.random.default_rng(num_classes).integers(0, 256, SHAPE, dtype=np.uint8)
    for softmax in (False, True):
        cfg = dict(internal_size=internal, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                   compute_dtype="float32", softmax=softmax)
        eng = InferenceEngine(model, device="cpu", config=E2EConfig(**cfg))
        path = X.export_torch(eng, SHAPE, str(tmp_path / f"m{int(softmax)}.pt2"),
                              metadata={"softmax": softmax})
        art = X.load_exported(path, device="cpu")
        got, eager = art(images), eng.predict(images)
        ref = np.asarray(JaxEngine(JaxFastSCNN(num_classes, aux=aux), jparams, jstate,
                                   config=JaxE2EConfig(**cfg)).predict(images))
        assert got.dtype == eager.dtype and got.shape == eager.shape == ref.shape
        if softmax:
            torch.testing.assert_close(got, eager, rtol=0, atol=1e-5)
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
        else:
            assert torch.equal(got, eager)
            assert len(np.unique(ref)) > 1
            assert (got.numpy() == ref).mean() >= 0.999
        (out,) = art.infer([images])
        assert np.array_equal(out, got.numpy())
        with open(path + ".json") as f:
            meta = json.load(f)
        assert meta["format"] == "torch-export" and meta["softmax"] is softmax
        assert meta["inputs"] == [{"shape": list(SHAPE), "dtype": "uint8"}]
        assert meta["program_bytes"] == os.path.getsize(path)
        assert meta["torch_version"] == torch.__version__ and meta["device"] == "cpu"


def test_the_artifact_is_self_contained_and_moves_devices(tmp_path):
    """Every tensor of the program is a buffer (weights, constants and
    resize tables; none a lifted constant), the mask modes without a kernel
    export, and a load onto another device moves the program (here the
    ``meta`` device: the output's shape and dtype, no data)."""
    model, _, _ = _calibrated(2, False, seed=5)
    images = np.random.default_rng(5).integers(0, 256, SHAPE, dtype=np.uint8)
    for mode in ("nbr-exact", "argmax-first"):
        eng = InferenceEngine(model, device="cpu", config=E2EConfig(
            compute_dtype="bfloat16", final_upsample=mode, mask_dtype="uint8",
            internal_size=(48, 96)))
        path = X.export_torch(eng, SHAPE, str(tmp_path / f"{mode}.pt2"))
        art = X.load_exported(path, device="cpu")
        assert not art.program.constants
        names = set(art.program.state_dict)
        assert sum(n.startswith("table") for n in names) >= 2 and "g__inv255" in names
        got = art(torch.from_numpy(images))
        assert got.dtype == torch.uint8 and torch.equal(got, eng.predict(images)), mode
    moved = X.load_exported(path, device="meta")
    out = moved(images)
    assert out.device.type == "meta" and out.shape == SHAPE[:3] and out.dtype == torch.uint8
    assert X.load_artifact(path, device="cpu").shape == SHAPE


KERNEL_CASES = [(k, v) for k, vs in X.KERNEL_OPTIONS.items() for v in vs]


def _kernel_engines(option, value, model, jparams, jstate, **cfg):
    """The port's and the JAX package's engines (f32) with ``option`` set
    to ``value`` on ``model``'s weights: the model option, or the engine's
    ``final_upsample``; the int8 impls with one int8 site at scale 0.05."""
    opts = {option: value} if option != "final_upsample" else {}
    if value.startswith("int8"):
        opts["pw_act_scales"] = (("gfe/ppm/out", 0.05),)
    if option == "final_upsample":
        cfg["final_upsample"] = value
    cfg = dict(mean=IMAGENET_MEAN, std=IMAGENET_STD, compute_dtype="float32", **cfg)
    port = InferenceEngine(model.with_options(**opts), device="cpu", config=E2EConfig(**cfg))
    jax_engine = JaxEngine(JaxFastSCNN(model.num_classes, **opts), jparams, jstate,
                           config=JaxE2EConfig(**cfg))
    return port, jax_engine


class _OperatorCalls(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the calls of each ``fastscnn::`` operator under the mode."""

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "fastscnn":
            self.calls[f"fastscnn.{func.__name__}"] += 1
        return func(*args, **(kwargs or {}))


def _graph_operators(program):
    return collections.Counter(str(n.target) for n in program.graph.nodes
                               if str(n.target).startswith("fastscnn."))


@pytest.fixture(scope="module")
def kernel_weights():
    return _calibrated(2, False, seed=11)


@pytest.mark.parametrize("option, value", KERNEL_CASES)
def test_kernel_configurations_export_and_agree_with_jax(tmp_path, kernel_weights, option, value):
    """Each engine option whose path runs a kernel exports on the CPU: the
    program holds the kernel's operator once for each call the eager path
    makes (and no launch is counted), the artifact's masks equal the eager
    engine's bit for bit and agree with the JAX engine of the same
    configuration on ≥ 99.9 % of pixels (f32)."""
    model, jparams, jstate = kernel_weights
    eng, jeng = _kernel_engines(option, value, model, jparams, jstate)
    images = np.random.default_rng(12).integers(0, 256, SHAPE, dtype=np.uint8)
    path = X.export_torch(eng, SHAPE, str(tmp_path / "m.pt2"))
    art = X.load_exported(path, device="cpu")
    with _OperatorCalls() as seen:
        eager = eng.predict(images)
    got = art(images)
    assert seen.calls and _graph_operators(art.program) == seen.calls
    assert sum(launch_counts().values()) == 0
    assert got.dtype == eager.dtype and torch.equal(got, eager)
    ref = np.asarray(jeng.predict(images))
    assert len(np.unique(ref)) > 1
    assert (got.numpy() == ref).mean() >= 0.999


def test_config_a_artifact_agrees_with_the_jax_stablehlo_artifact(tmp_path, kernel_weights):
    """Config A ('fused-ds' + 'pallas': B3, B1) exported by both packages:
    the port's ``.pt2`` and the JAX package's ``export_stablehlo`` of its
    engine's ``predict_fn``, each loaded back, agree on ≥ 99.9 % of pixels
    (f32), and the JAX artifact equals its engine."""
    model, jparams, jstate = kernel_weights
    eng, jeng = _kernel_engines("folded_dw_impl", "fused-ds", model, jparams, jstate,
                                final_upsample="pallas")
    assert eng.model.folded_dw_impl == jeng.model.folded_dw_impl == "fused-ds"
    images = np.random.default_rng(13).integers(0, 256, SHAPE, dtype=np.uint8)
    got = X.load_exported(X.export_torch(eng, SHAPE, str(tmp_path / "a.pt2")), device="cpu")(images)
    jpath = export_stablehlo(jeng.predict_fn(SHAPE), (images,), str(tmp_path / "a.stablehlo"),
                             platforms=("cpu",))
    ref = np.asarray(jax_load_exported(jpath)(images))
    assert np.array_equal(ref, np.asarray(jeng.predict(images)))
    assert len(np.unique(ref)) > 1 and (got.numpy() == ref).mean() >= 0.999


def _run(code, *args):
    return subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, capture_output=True,
                          text=True, timeout=300)


def test_kernel_artifact_loads_in_a_fresh_interpreter(tmp_path, kernel_weights):
    """A process that imports nothing of the port but the loader loads a
    kernel artifact (config C's operators: B5, B7 once, B1) with
    ``load_exported`` and ``load_artifact`` and gives the exporting
    engine's masks; a bare ``torch.export.load`` of it, without the port,
    raises; a kernel-free artifact loads bare."""
    model, jparams, jstate = kernel_weights
    eng, _ = _kernel_engines("folded_pw_impl", "int8-a8", model.with_options(
        folded_dw_impl="fused-ds-mr"), jparams, jstate, final_upsample="pallas")
    images = np.random.default_rng(14).integers(0, 256, SHAPE, dtype=np.uint8)
    path = X.export_torch(eng, SHAPE, str(tmp_path / "c.pt2"))
    assert set(_graph_operators(X.load_exported(path, device="cpu").program)) == {
        "fastscnn.ds_conv3x3_pw_multirow.default", "fastscnn.pw_conv_a8.default",
        "fastscnn.upsample_argmax.default"}
    np.save(tmp_path / "images.npy", images)
    np.save(tmp_path / "want.npy", eng.predict(images).numpy())
    proc = _run(
        "import sys, numpy as np\n"
        "from fastscnn_tpu_torch.engine.export import load_artifact, load_exported\n"
        "path, d = sys.argv[1], sys.argv[2]\n"
        "images, want = np.load(d + '/images.npy'), np.load(d + '/want.npy')\n"
        "for load in (load_exported, load_artifact):\n"
        "    got = load(path, device='cpu')(images).numpy()\n"
        "    assert np.array_equal(got, want), load.__name__\n"
        "print('ok')\n", path, str(tmp_path))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr
    plain = X.export_torch(InferenceEngine(model, device="cpu", config=E2EConfig(
        compute_dtype="float32")), SHAPE, str(tmp_path / "plain.pt2"))
    bare = ("import sys, torch\n"
            "torch.export.load(sys.argv[1])\n"
            "assert not [m for m in sys.modules if m.startswith('fastscnn')]\n"
            "print('loaded')\n")
    proc = _run(bare, path)
    assert proc.returncode != 0 and "fastscnn" in proc.stderr and "loaded" not in proc.stdout
    assert "not registered" in proc.stderr
    proc = _run(bare, plain)
    assert proc.returncode == 0 and proc.stdout.strip() == "loaded", proc.stderr


def test_kernel_artifact_moves_to_meta(tmp_path, kernel_weights):
    """A kernel artifact (config D's operators: B4, B8, B2) loaded onto the
    ``meta`` device runs the operators' fake implementations: the mask's
    shape and dtype, no data, nothing launched."""
    model, jparams, jstate = kernel_weights
    eng, _ = _kernel_engines("folded_pw_impl", "int8-w8a8", model.with_options(
        folded_dw_impl="pallas"), jparams, jstate, final_upsample="hybrid-pallas",
        mask_dtype="uint8")
    path = X.export_torch(eng, SHAPE, str(tmp_path / "d.pt2"))
    moved = X.load_exported(path, device="meta")
    assert set(_graph_operators(moved.program)) == {
        "fastscnn.dw_conv3x3.default", "fastscnn.pw_conv_w8a8.default",
        "fastscnn.h_lerp_argmax.default"}
    out = moved(np.zeros(SHAPE, np.uint8))
    assert out.device.type == "meta" and out.shape == SHAPE[:3] and out.dtype == torch.uint8
    assert sum(launch_counts().values()) == 0


@pytest.fixture(scope="module")
def knob_weights():
    params, state = jax_init(jax.random.PRNGKey(7), 3, True)
    rng = np.random.default_rng(7)

    def perturb(path, v):
        name = jax.tree_util.keystr(path)
        if "mean" in name:
            return jnp.asarray(rng.uniform(-0.05, 0.05, v.shape), v.dtype)
        if "var" in name:
            return jnp.asarray(rng.uniform(0.5, 2.0, v.shape), v.dtype)
        return v

    state = jax.tree_util.tree_map_with_path(perturb, state)
    sd = from_jax_params(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    x = np.random.default_rng(8).uniform(-1, 1, (1, 256, 256, 3)).astype(np.float32)
    return params, state, sd, x


@pytest.mark.parametrize("sizes, align", [((1, 2, 4, 8), False), ((1, 2, 3, 6), True)])
def test_ppm_knobs_match_the_jax_model(knob_weights, sizes, align):
    """The unfolded forward, ``apply_params`` (eval) and ``apply_folded``
    (f32) of the port's model with the knobs against the JAX model's
    ``apply`` and ``apply_folded``: logits rtol 1e-4 (atol 2e-5 of their
    largest magnitude). The knobs travel with ``with_options``."""
    from fastscnn_tpu.models.fast_scnn import fold_inference_params as jax_fold
    from fastscnn_tpu_torch.models import fold_inference_params

    params, state, sd, x = knob_weights
    jm = JaxFastSCNN(3, aux=True, ppm_sizes=sizes, ppm_align_corners=align)
    ref = np.asarray(jax.jit(lambda p, s, v: jm.apply(p, s, v, training=False)[0][0])(
        params, state, jnp.asarray(x)))
    ref_folded = np.asarray(jax.jit(lambda f, v: jm.apply_folded(f, v)[0])(
        jax_fold(params, state, dtype=jnp.float32), jnp.asarray(x)))
    model = FastSCNN(3, aux=True)
    model.load_state_dict(sd)
    model = model.eval().with_options(ppm_sizes=sizes, ppm_align_corners=align)
    assert model.ppm_sizes == sizes and model.ppm_align_corners is align
    xt = torch.from_numpy(x)
    with torch.no_grad():
        p, s = to_param_trees(model)
        outs = {"forward": model(xt)[0],
                "apply_params": model.apply_params(p, s, xt)[0][0],
                "apply_folded": model.apply_folded(fold_inference_params(model, torch.float32),
                                                   xt)[0]}
    for name, got in outs.items():
        want = ref_folded if name == "apply_folded" else ref
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=2e-5 * np.abs(want).max(), err_msg=name)
    default = FastSCNN(3, aux=True)
    assert (default.ppm_sizes, default.ppm_align_corners) == ((1, 2, 3, 6), True)
    with pytest.raises(ValueError, match="4 pyramid"):
        FastSCNN(3, ppm_sizes=(1, 2, 4))


def test_default_knobs_leave_every_forward_as_the_training_graph(knob_weights):
    """Passing the defaults explicitly changes nothing, bit for bit, and
    the deployed grid changes the logits."""
    _, _, sd, x = knob_weights
    xt = torch.from_numpy(x)
    outs = []
    for kw in ({}, {"ppm_sizes": (1, 2, 3, 6), "ppm_align_corners": True},
               {"ppm_sizes": (1, 2, 4, 8), "ppm_align_corners": False}):
        model = FastSCNN(3, aux=True, **kw)
        model.load_state_dict(sd)
        with torch.no_grad():
            outs.append(model.eval()(xt)[0])
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
