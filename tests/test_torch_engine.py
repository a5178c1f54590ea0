"""The port's InferenceEngine against the JAX package's, on shared weights
and the same uint8 batch, in every mask mode the port supports.

Tolerances: in f32 masks are equal except at near-ties (pixels whose two
best classes differ by < 1e-5 in the JAX engine's f32 logits; the
packages' convolutions sum in different orders). In bf16 the packages
round at different places (XLA fuses elementwise bf16 chains, PyTorch
rounds each op), so masks must agree on ≥ 99.5 % of pixels — the JAX
package's bf16 mask gate. BN statistics are perturbed so the masks have
more than one class.
"""

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
from fastscnn_tpu.models import init_fast_scnn as jax_init
from fastscnn_tpu_torch import resolve_device
from fastscnn_tpu_torch.engine import (
    FINAL_UPSAMPLE_MODES,
    IMAGENET_MEAN,
    IMAGENET_STD,
    E2EConfig,
    InferenceEngine,
)
from fastscnn_tpu_torch.models import FastSCNN, from_jax_params, to_param_trees

NUM_CLASSES = 6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def shared():
    params, state = jax_init(jax.random.PRNGKey(1), NUM_CLASSES)
    rng = np.random.default_rng(1)

    def perturb(path, v):
        name = jax.tree_util.keystr(path)
        if "mean" in name:
            return jnp.asarray(rng.uniform(-0.05, 0.05, v.shape), v.dtype)
        if "var" in name:
            return jnp.asarray(rng.uniform(0.05, 0.2, v.shape), v.dtype)
        return v

    state = jax.tree_util.tree_map_with_path(perturb, state)
    sd = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                         jax.tree_util.tree_map(np.asarray, state))
    images = rng.integers(0, 256, (2, 64, 128, 3)).astype(np.uint8)
    return params, state, sd, images


@pytest.fixture(scope="module")
def calibrated(shared):
    """Moderate logits for the softmax and logits paths: the shared
    fixture's logits are ~1e4, where softmax saturates and near-ties flip
    whole probabilities. BN statistics are taken from one train-mode pass
    of the port's model over a calibration batch, then carried back to the
    JAX layout by ``to_param_trees``."""
    params, state, sd, images = shared
    model = FastSCNN(NUM_CLASSES)
    model.load_state_dict(sd)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None
    calib = np.random.default_rng(2).integers(0, 256, images.shape).astype(np.float32)
    model.train()
    with torch.no_grad():
        model((torch.from_numpy(calib) / 255 - torch.tensor(IMAGENET_MEAN)) / torch.tensor(IMAGENET_STD))
    model.eval()
    jparams, jstate = (jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)
                       for tree in to_param_trees(model))
    return jparams, jstate, model.state_dict(), images


def _engines(shared, impl, **cfg):
    params, state, sd, _ = shared
    jeng = JaxEngine(JaxFastSCNN(NUM_CLASSES, folded_dw_impl=impl), params, state,
                     config=JaxE2EConfig(mean=IMAGENET_MEAN, std=IMAGENET_STD, **cfg))
    model = FastSCNN(NUM_CLASSES, folded_dw_impl=impl)
    model.load_state_dict(sd, strict=True)
    peng = InferenceEngine(model, device="cpu",
                           config=E2EConfig(mean=IMAGENET_MEAN, std=IMAGENET_STD, **cfg))
    return jeng, peng


# the LTD route of each mode: the kernel modes go with their kernel routes
_IMPL = {"matmul": "conv", "gather": "conv", "pallas": "fused-ds", "hybrid": "conv",
         "hybrid-pallas": "pallas", "nbr-exact": "conv", "argmax-first": "conv"}


@pytest.mark.parametrize("mode", FINAL_UPSAMPLE_MODES)
def test_masks_match_jax_f32(shared, mode):
    jeng, peng = _engines(shared, _IMPL[mode], compute_dtype="float32", final_upsample=mode)
    images = shared[3]
    ref = np.asarray(jeng.predict(images))
    got = peng.predict(images)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    got = got.numpy()
    diff = got != ref
    assert len(np.unique(ref)) > 1  # a constant mask would prove nothing
    if diff.any():
        logits = np.asarray(jeng.logits(images))
        za = np.take_along_axis(logits, got[..., None], -1)[..., 0]
        zb = np.take_along_axis(logits, ref[..., None], -1)[..., 0]
        assert np.abs(za - zb)[diff].max() < 1e-5
    assert diff.mean() <= 1e-3


@pytest.mark.parametrize("mode", FINAL_UPSAMPLE_MODES)
def test_masks_match_jax_bf16(shared, mode):
    jeng, peng = _engines(shared, _IMPL[mode], compute_dtype="bfloat16", final_upsample=mode,
                          mask_dtype="uint8")
    images = shared[3]
    ref = np.asarray(jeng.predict(images))
    got = peng.predict(images)
    assert got.dtype == torch.uint8
    if mode == "argmax-first":
        _assert_argmax_first_near(jeng, peng, images, got.numpy(), ref)
    else:
        assert (got.numpy() == ref).mean() >= 0.995


def _assert_argmax_first_near(jeng, peng, images, got, ref):
    """'argmax-first' in bf16: each 1/8-resolution decision fills an 8x8
    block, so one bf16 near-tie that the packages round apart moves 64
    pixels (0.39 % of this batch) and the 99.5 %-of-pixels gate measures
    the decisions' granularity, not the port. The mask is gated where it
    is decided: it is the nearest expansion of its 1/8 decisions; they
    agree on ≥ 99 %; and every decision that differs is a bf16 near-tie,
    its two best classes in the JAX engine's (jitted) 1/8 logits closer
    than the largest difference between the two packages' 1/8 logits."""
    cells_got, cells_ref = got[:, ::8, ::8], ref[:, ::8, ::8]
    np.testing.assert_array_equal(got, cells_got.repeat(8, 1).repeat(8, 2))
    differ = cells_got != cells_ref
    assert differ.mean() <= 0.01
    if differ.any():
        jl = np.asarray(jax.jit(lambda x: jeng._forward(x, upsample=False))(jnp.asarray(images)),
                        np.float32)
        with torch.inference_mode():
            pl = peng._forward(torch.from_numpy(images), upsample=False).float().numpy()
        noise = np.abs(jl - pl).max()
        top2 = np.sort(jl[differ], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).max() < noise, (top2, noise)


def test_logits_softmax_and_internal_size_match_jax(calibrated):
    """The non-mask paths in f32: logits at the input size (resized back
    from an internal backbone size), softmax probabilities, and ``infer``;
    tolerance 2e-5 of the logits' largest magnitude (f32 summation order
    through ~40 layers)."""
    images = calibrated[3]
    cfg = dict(compute_dtype="float32", internal_size=(48, 96))
    jeng, peng = _engines(calibrated, "conv", **cfg)
    ref = np.asarray(jeng.logits(images))
    atol = 2e-5 * np.abs(ref).max()
    np.testing.assert_allclose(peng.logits(images).numpy(), ref, rtol=1e-4, atol=atol)
    nchw = np.transpose(images, (0, 3, 1, 2)).astype(np.float32)
    np.testing.assert_allclose(peng.infer([nchw])[0], jeng.infer([nchw])[0], rtol=1e-4, atol=atol)
    jeng, peng = _engines(calibrated, "conv", softmax=True, **cfg)
    np.testing.assert_allclose(peng.predict(images).numpy(), np.asarray(jeng.predict(images)),
                               rtol=1e-4, atol=1e-5)
    jeng, peng = _engines(calibrated, "conv", final_upsample="pallas", **cfg)
    got, ref = peng.predict(images[0]), np.asarray(jeng.predict(images[0]))  # single HWC frame
    assert got.shape == ref.shape == images.shape[1:3]
    assert (got.numpy() == ref).mean() >= 0.999


def test_predict_fn_is_cached_per_shape_equals_predict_and_copies(shared):
    """On the CPU ``predict_fn`` runs eagerly with the card's contract: one
    callable per shape, the output of ``predict``, a new tensor a call (a
    later call leaves an earlier result as it was), and a batch of another
    shape refused."""
    _, peng = _engines(shared, "fused-ds", compute_dtype="float32", final_upsample="pallas",
                       mask_dtype="uint8")
    images = shared[3]
    fn = peng.predict_fn(images.shape)
    assert peng.predict_fn(tuple(images.shape)) is fn
    assert peng.predict_fn((1, *images.shape[1:])) is not fn
    first = fn(images)
    kept = first.clone()
    assert first.dtype == torch.uint8 and torch.equal(first, peng.predict(images))
    second = fn(torch.from_numpy(images[::-1].copy()))
    assert second.data_ptr() != first.data_ptr() and torch.equal(first, kept)
    assert torch.equal(second, peng.predict(images[::-1].copy()))
    assert fn.replays == 2 and fn.launches == {} and fn.pool_bytes == 0
    with pytest.raises(ValueError, match="predict_fn"):
        fn(images[:1])
    with pytest.raises(ValueError, match="predict_fn"):
        fn(images.astype(np.float32))


def test_predict_fn_holds_its_engine(shared):
    """A callable of ``predict_fn`` or ``throughput_fn`` outlives the
    engine reference it came from: on the card its graph reads the
    engine's folded weights by address, so ``fn.engine`` holds the engine
    (a graph of a dropped engine read freed memory: 0.22 of config A's
    pixels in the export check of ``chip_smoke.py`` 10b)."""
    import gc
    import weakref

    _, peng = _engines(shared, "conv", compute_dtype="float32")
    images = shared[3]
    want = peng.predict(images)
    fns = (peng.predict_fn(images.shape), peng.throughput_fn(images.shape, iters=1))
    alive = weakref.ref(peng)
    del peng
    gc.collect()
    assert alive() is not None and all(fn.engine is alive() for fn in fns)
    assert torch.equal(fns[0](images), want)


@pytest.mark.parametrize("mode", ["pallas", "hybrid"])
def test_throughput_fn_checksum_matches_jax(shared, mode):
    """``throughput_fn(iters=3)`` on the same f32 weights and input gives
    the JAX ``throughput_fn``'s checksum: three forwards chained through
    pixel (0, 0) of the first image, summing its class."""
    jeng, peng = _engines(shared, _IMPL[mode], compute_dtype="float32", final_upsample=mode)
    images = shared[3]
    ref = int(jeng.throughput_fn(images.shape, iters=3)(jnp.asarray(images)))
    fn = peng.throughput_fn(images.shape, iters=3)
    got = fn(images)
    assert got.shape == () and got.dtype == torch.int32
    assert int(got) == ref
    assert peng.throughput_fn(images.shape, iters=3) is fn
    assert peng.throughput_fn(images.shape, iters=4) is not fn
    # the chain is real work: pixel (0, 0) moves with each odd class
    m0 = int(peng.predict(images)[0, 0, 0])
    assert int(peng.throughput_fn(images.shape, iters=1)(images)) == m0


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(FastSCNN(NUM_CLASSES))
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter (this test process has jax loaded already),
    importing every module of the port loads no jax, no fastscnn_tpu and
    none of the packages the card's machine lacks — PIL, OpenCV,
    scikit-learn, matplotlib, tensorflow, grain, orbax, tensorstore,
    zstandard (only the functions that need one import it; the Orbax
    checkpoints need none)."""
    code = (
        "import sys, pkgutil, importlib, fastscnn_tpu_torch\n"
        "for m in pkgutil.walk_packages(fastscnn_tpu_torch.__path__, 'fastscnn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "banned = ('jax', 'fastscnn_tpu', 'PIL', 'cv2', 'sklearn', 'matplotlib', 'tensorflow',\n"
        "          'grain', 'orbax', 'tensorstore', 'zstandard')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in banned]\n"
        "n = sum(m.startswith('fastscnn_tpu_torch') for m in sys.modules)\n"
        "need = {'fastscnn_tpu_torch.' + m for m in ('parallel.train', 'losses.segmentation',\n"
        "        'utils.lr_scheduler', 'utils.metric', 'ops.cuda.dw_conv', 'ops.cuda.int8_pw',\n"
        "        'models.fast_scnn', 'models.quantize', 'serving', 'bench', 'utils.visualize',\n"
        "        'utils.system_monitor', 'models.registry', 'data.image_io', 'data.decoded_cache',\n"
        "        'data.transforms', 'data.cityscapes', 'data.tusimple', 'data.bdd100k',\n"
        "        'data.custom', 'data.loader', 'data.device_aug', 'data.pil_ops',\n"
        "        'data.grain_loader', 'train', 'eval',\n"
        "        'train_presets', 'utils.checkpoint', 'utils.monitor', 'tools.system_check',\n"
        "        'tools.argmax_first_study', 'tools.quant_study', 'tools.compare_backends',\n"
        "        'bench_train', 'bench_eval', 'bench_latency', 'bench_input', 'tools.ab_int8_e2e',\n"
        "        'utils.cuda_graph', 'pipeline', 'perception', 'perception.calibration',\n"
        "        'perception.transform', 'perception.path_planning', 'perception.preprocessing',\n"
        "        'control', 'control.visual_controller', 'interfaces', 'interfaces.realtime',\n"
        "        'interfaces.web_interface', 'serialbridge', 'control_dashboard', 'demo',\n"
        "        'demo_tusimple', 'utils.profiling', 'serialbridge.mcu',\n"
        "        'serialbridge.rich_protocol', 'tools.manual_control', 'tools.analyzers',\n"
        "        'engine.export', 'engine.onnx_native', 'export_model', 'data.jpeg',\n"
        "        'utils.native', 'parallel.mesh', 'parallel.multihost', 'ops.collectives',\n"
        "        'tools.multihost_smoke', 'entry', 'utils.zstd', 'utils.ocdbt', 'utils.zarr',\n"
        "        'utils.orbax_tree', 'tools.check_dw_impls', 'tools.ab_int8_pw',\n"
        "        'tools.ab_report', 'examples.car_control_example')}\n"
        "print(n, bad, need - set(sys.modules))\n"
        "sys.exit(1 if bad or n < 20 or need - set(sys.modules) else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_serves_one_full_size_frame_on_the_cpu():
    """``entry()`` builds the kernel configuration (fused-ds + pallas); on
    the CPU its wrappers run their plain versions and count no launch."""
    from fastscnn_tpu_torch.entry import SHAPE, entry
    from fastscnn_tpu_torch.ops.cuda import launch_counts

    before = launch_counts()
    fn, (example,) = entry(device="cpu")
    assert tuple(example.shape) == SHAPE and example.dtype == torch.uint8
    model = fn.__self__.model
    assert model.folded_dw_impl == "fused-ds" and fn.__self__.config.final_upsample == "pallas"
    mask = fn(example)
    assert mask.shape == SHAPE[:3] and mask.dtype == torch.int32
    assert launch_counts() == before


def test_bench_sweeps_throughput_fn_on_the_cpu(monkeypatch, capsys):
    """``python -m fastscnn_tpu_torch.bench``'s sweep at a small size on
    the CPU: the root bench's knobs, one line of fields per the docstring
    (speed on the CPU means nothing; the card's numbers are in PERF.md)."""
    from fastscnn_tpu_torch import bench

    for knob, value in (("BENCH_BATCHES", "1,2"), ("BENCH_ITERS", "2"), ("BENCH_TRIALS", "1"),
                        ("BENCH_DW_IMPL", "fused-ds"), ("BENCH_UPSAMPLE", "pallas")):
        monkeypatch.setenv(knob, value)
    out = bench.run(device="cpu", size=(32, 64))
    assert out["metric"] == "cityscapes_32x64_bf16_e2e_inference_throughput"
    assert out["unit"] == "fps/card" and out["device"] == "cpu"
    assert out["batch"] in (1, 2) and out["value"] > 0
    assert (out["dw_impl"], out["upsample"]) == ("fused-ds", "pallas")
    err = capsys.readouterr().err
    assert "batch 1:" in err and "batch 2:" in err
