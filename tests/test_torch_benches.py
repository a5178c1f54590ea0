"""The port's training-side benches (``fastscnn_tpu_torch/bench_train.py``,
``bench_eval.py``, ``bench_latency.py``, ``bench_input.py`` and
``tools/ab_int8_e2e.py``) against the repo root's, on the CPU.

- ``bench_train``'s knobs and metric names are the root bench's own code,
  read from ``bench_train.py`` and run on a table of environments;
- the eval device loop (``bench_eval.device_loop``) sums the same
  ``correct`` counts as the root bench's ``fori_loop`` body over the JAX
  ``make_eval_step`` (same weights, f32, 64×128, 3 iterations): its masks
  agree with JAX's but at near-ties, which no pixel of this input is;
- the 19-class engine takes a 640×360 frame (360 is not a multiple of
  32) as the JAX engine does: f32 masks equal but at near-ties (the logit
  gap below 1e-5), and ``throughput_fn``'s checksum equal;
- each bench runs end to end at a tiny size with PIL blocked and gives its
  JSON line the root bench's keys, less those each module's docstring
  leaves out (speed on the CPU means nothing; the card's numbers are
  PERF.md's); ``bench_latency``'s realtime legs give the keys of the root
  bench's own ``realtime_loop`` and ``realtime_stage_breakdown`` run on a
  shared session.
"""

import ast
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastscnn_tpu.engine import E2EConfig as JaxE2EConfig
from fastscnn_tpu.engine import InferenceEngine as JaxEngine
from fastscnn_tpu.models import FastSCNN as JaxFastSCNN
from fastscnn_tpu.models import init_fast_scnn as jax_init
from fastscnn_tpu.parallel.train import make_eval_step as jax_eval_step
from fastscnn_tpu_torch import bench_eval, bench_input, bench_latency, bench_train
from fastscnn_tpu_torch.engine import E2EConfig, InferenceEngine
from fastscnn_tpu_torch.models import FastSCNN, from_jax_params, to_param_trees
from fastscnn_tpu_torch.parallel import make_eval_step
from fastscnn_tpu_torch.tools import ab_int8_e2e

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES = 19


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_pil(tmp_path, monkeypatch):
    """PIL and matplotlib blocked here and in spawned workers: a stub
    package that raises ahead on ``sys.path``, and ``sys.modules``."""
    stub = tmp_path / "stub"
    (stub / "PIL").mkdir(parents=True)
    (stub / "PIL" / "__init__.py").write_text("raise ImportError('PIL is blocked')\n")
    monkeypatch.syspath_prepend(str(stub))
    for top in ("PIL", "matplotlib"):
        monkeypatch.setitem(__import__("sys").modules, top, None)


@pytest.fixture(scope="module")
def shared():
    """JAX weights with BN statistics away from (0, 1), so masks are not
    one class, and the port's state dict of them."""
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
    return params, state, sd


# ---------------------------------------------------------------------------
# bench_train: knobs and metric names from the root bench's own code
# ---------------------------------------------------------------------------


def _root_bench_train():
    """The root ``bench_train.main``'s knob statements (up to the model)
    and its ``metric`` expression, compiled from the file."""
    tree = ast.parse(open(os.path.join(REPO, "bench_train.py")).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    knob_stmts = []
    for stmt in main.body:
        if isinstance(stmt, ast.Assign) and ast.unparse(stmt.targets[0]) == "model":
            break
        if not isinstance(stmt, (ast.Import, ast.ImportFrom)):
            knob_stmts.append(stmt)
    metric = next(v for n in ast.walk(main) if isinstance(n, ast.Dict)
                  for k, v in zip(n.keys, n.values)
                  if isinstance(k, ast.Constant) and k.value == "metric")
    return (compile(ast.Module(knob_stmts, []), "bench_train.py", "exec"),
            compile(ast.Expression(metric), "bench_train.py", "eval"))


KNOB_TABLE = [
    {},
    {"BENCH_TRAIN_CLASSES": "19", "BENCH_TRAIN_LOSS": "ce", "BENCH_TRAIN_CROP": "768",
     "BENCH_TRAIN_BATCHES": "16", "BENCH_TRAIN_STEM": "pallas"},
    {"BENCH_TRAIN_DEVICE_AUG": "1"},
    {"BENCH_TRAIN_DEVICE_AUG": "2", "BENCH_TRAIN_GRAD_ACCUM": "2"},
    {"BENCH_TRAIN_DEVICE_AUG": "1", "BENCH_TRAIN_AUG_CHAIN": "custom-ms"},
    {"BENCH_TRAIN_DEVICE_AUG": "2", "BENCH_TRAIN_AUG_CHAIN": "custom"},
    {"BENCH_TRAIN_DEVICE_AUG": "1", "BENCH_TRAIN_AUG_CHAIN": "original",
     "BENCH_TRAIN_SRC": "720x1280"},
    {"BENCH_TRAIN_NATIVE": "1", "BENCH_TRAIN_SRC": "360x640"},
    {"BENCH_TRAIN_SIZE": "360x640", "BENCH_TRAIN_OPT": "adamw", "BENCH_TRAIN_CLASSES": "3"},
    {"BENCH_TRAIN_CLASSES": "19", "BENCH_TRAIN_LOSS": "focal_dice", "BENCH_TRAIN_OPT": "adamw",
     "BENCH_TRAIN_DEVICE_AUG": "2", "BENCH_TRAIN_BASE": "520", "BENCH_TRAIN_ITERS": "5"},
]


@pytest.mark.parametrize("env", KNOB_TABLE, ids=lambda e: ",".join(
    f"{k[12:]}={v}" for k, v in e.items()) or "defaults")
def test_bench_train_knobs_and_metric_are_the_root_bench_s(env):
    knob_code, metric_code = _root_bench_train()
    ns = {"os": types.SimpleNamespace(environ=dict(env)), "np": np}
    exec(knob_code, ns)
    k = bench_train.knobs(env)
    for name in ("crop", "batches", "iters", "num_classes", "loss_name", "device_aug_on",
                 "device_aug_split", "aug_chain", "native_ctl", "src_h", "src_w", "base_size",
                 "train_h", "train_w", "opt_name", "stem_impl", "grad_accum"):
        assert k[name] == ns[name], name
    assert bench_train.metric_name(k) == eval(metric_code, ns)


TRAIN_RUNS = [
    {"BENCH_TRAIN_CROP": "64", "BENCH_TRAIN_BATCHES": "1,2"},
    {"BENCH_TRAIN_CLASSES": "19", "BENCH_TRAIN_LOSS": "ce", "BENCH_TRAIN_CROP": "64",
     "BENCH_TRAIN_BATCHES": "2", "BENCH_TRAIN_STEM": "pallas", "BENCH_TRAIN_GRAD_ACCUM": "2"},
    {"BENCH_TRAIN_DEVICE_AUG": "1", "BENCH_TRAIN_SRC": "64x128", "BENCH_TRAIN_BASE": "64",
     "BENCH_TRAIN_CROP": "64", "BENCH_TRAIN_BATCHES": "2"},
    {"BENCH_TRAIN_DEVICE_AUG": "2", "BENCH_TRAIN_SRC": "64x128", "BENCH_TRAIN_CROP": "48",
     "BENCH_TRAIN_BATCHES": "2", "BENCH_TRAIN_AUG_CHAIN": "custom", "BENCH_TRAIN_OPT": "adamw"},
    {"BENCH_TRAIN_NATIVE": "1", "BENCH_TRAIN_SRC": "64x96", "BENCH_TRAIN_BATCHES": "2"},
]


@pytest.mark.parametrize("env", TRAIN_RUNS, ids=["default", "recipe-accum2", "devaug",
                                                 "split-custom-adamw", "native"])
def test_bench_train_runs_on_the_cpu(env, no_pil, capsys):
    line = bench_train.run(device="cpu", env=dict(env, BENCH_TRAIN_ITERS="1"))
    json.dumps(line)
    k = bench_train.knobs(env)
    assert line == {
        "metric": bench_train.metric_name(k), "value": line["value"],
        "unit": "samples/sec/chip", "batch": line["batch"], "stem_impl": k["stem_impl"],
        "grad_accum": k["grad_accum"], "graph": False, "device": "cpu"}
    assert line["value"] > 0 and line["batch"] in k["batches"]
    err = capsys.readouterr().err
    assert all(f"batch {b}:" in err for b in k["batches"])
    assert ("the chain alone" in err) == k["device_aug_split"]


# ---------------------------------------------------------------------------
# bench_eval
# ---------------------------------------------------------------------------


def test_eval_device_loop_sums_what_the_root_bench_s_loop_sums(shared):
    params, state, sd = shared
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (2, 64, 128, 3), dtype=np.uint8)
    t = rng.integers(-1, NUM_CLASSES, (2, 64, 128)).astype(np.int32)
    iters = 3
    jstep = jax_eval_step(JaxFastSCNN(NUM_CLASSES), NUM_CLASSES, compute_dtype=jnp.float32,
                          jit=False)

    def body(i, carry):  # root bench_eval.py:122-126
        xi, acc = carry
        pred, (correct, labeled, inter, union) = jstep(params, state, xi, jnp.asarray(t))
        xi = xi.at[0, 0, 0, 0].add((pred[0, 0, 0] % 2).astype(xi.dtype))
        return (xi, acc + correct)

    ref = jax.jit(lambda xi: jax.lax.fori_loop(0, iters, body, (xi, jnp.float32(0)))[1])(
        jnp.asarray(x))
    model = FastSCNN(NUM_CLASSES)
    model.load_state_dict(sd)
    p, s = to_param_trees(model)
    step = make_eval_step(model, NUM_CLASSES, compute_dtype=torch.float32, device="cpu")
    got = bench_eval.device_loop(step, p, s, torch.from_numpy(x), torch.from_numpy(t), iters)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == float(ref) > 0
    masks = step(p, s, x, t)[0]
    assert len(np.unique(masks.numpy())) > 1  # a constant mask would prove little


def test_bench_eval_quick_runs_the_protocol_on_the_cpu(no_pil, capsys):
    line = bench_eval.main(["--quick", "--n-uniform", "2", "--n-mixed", "1"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert set(line) == {"metric", "value", "unit", "device", "detail"}
    assert line["metric"] == "eval_testval_images_per_s" and line["device"] == "cpu"
    detail = line["detail"]
    assert set(detail) == {"ref_faithful_bs1_f32_dump", "tpu_native_bs8_bf16_nodump",
                           "metric_update_ms_per_image", "device_loop_images_per_s_bs8_bf16",
                           "mixed_res", "tpu_native_bs8_bf16_nodump_decoded_cache"}
    for leg in ("ref_faithful_bs1_f32_dump", "tpu_native_bs8_bf16_nodump"):
        assert set(detail[leg]) == {"images", "cold_s", "steady_s", "images_per_s"}
        assert detail[leg]["images"] == 2
    assert set(detail["mixed_res"]) == {"images", "buckets", "cold_s", "steady_s",
                                        "compile_s_total", "padding_waste_pct", "images_per_s"}
    # 128x256, 96x192 and 100x200 pad to 128x256, 128x192 and 128x256
    assert detail["mixed_res"]["images"] == 3 and detail["mixed_res"]["buckets"] == 2
    assert set(detail["tpu_native_bs8_bf16_nodump_decoded_cache"]) == {
        "images", "cache_warmup_s", "steady_s", "images_per_s"}
    assert line["value"] == detail["tpu_native_bs8_bf16_nodump"]["images_per_s"] > 0
    from fastscnn_tpu_torch.data import decoded_cache

    assert decoded_cache.get_cache_dir() is None


# ---------------------------------------------------------------------------
# bench_latency: the 640x360 frame
# ---------------------------------------------------------------------------


def test_the_engine_takes_a_640x360_frame_as_the_jax_engine_does(shared):
    params, state, sd = shared
    frame = np.random.default_rng(3).integers(0, 256, (1, 360, 640, 3)).astype(np.uint8)
    jeng = JaxEngine(JaxFastSCNN(NUM_CLASSES), params, state,
                     config=JaxE2EConfig(compute_dtype="float32"))
    model = FastSCNN(NUM_CLASSES)
    model.load_state_dict(sd)
    peng = InferenceEngine(model, device="cpu", config=E2EConfig(compute_dtype="float32"))
    ref = np.asarray(jeng.predict(frame))
    got = peng.predict(frame).numpy()
    assert got.shape == ref.shape == (1, 360, 640) and len(np.unique(ref)) > 1
    diff = got != ref
    if diff.any():
        logits = np.asarray(jeng.logits(frame))
        za = np.take_along_axis(logits, got[..., None], -1)[..., 0]
        zb = np.take_along_axis(logits, ref[..., None], -1)[..., 0]
        assert np.abs(za - zb)[diff].max() < 1e-5
    assert diff.mean() <= 1e-3
    ref_sum = int(jeng.throughput_fn(frame.shape, iters=2)(jnp.asarray(frame)))
    assert int(peng.throughput_fn(frame.shape, iters=2)(frame)) == ref_sum


def _root_bench_latency():
    """The repo root's ``bench_latency.py`` as a module (it imports JAX
    only inside its functions)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("root_bench_latency",
                                                  os.path.join(REPO, "bench_latency.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _BandSession:
    """A ``.predict`` session whose mask is the synthetic camera's road band."""

    def predict(self, rgb):
        return (np.asarray(rgb)[..., 0] == 60).astype(np.uint8)


def test_bench_latency_runs_on_the_cpu(no_pil, capsys, monkeypatch):
    sizes = (("64x128", (1, 64, 128, 3)), ("72x136", (1, 72, 136, 3)))
    line = bench_latency.run(device="cpu", sizes=sizes, iters=2, calls=2, realtime_frames=2,
                             stage_frames=2)
    json.dumps(line)
    assert set(line) == {"metric", "unit", "value", "device", "device_loop_ms_64x128",
                         "host_predict_ms_64x128", "device_loop_ms_72x136",
                         "host_predict_ms_72x136", "realtime_loop", "realtime_stage_ms"}
    assert line["metric"] == "single_frame_latency" and line["unit"] == "ms"
    assert line["value"] == line["device_loop_ms_64x128"] > 0 and line["device"] == "cpu"
    assert [size for size, _ in bench_latency.SIZES] == ["1024x2048", "640x360"]
    err = capsys.readouterr().err
    assert "batch-1 72x136" in err and "realtime loop 640x360 (2-class)" in err
    # the realtime legs under the root bench's keys: its own functions on a
    # shared session give the same keys (OpenCV off, the port's branch)
    import fastscnn_tpu.perception.path_planning as jax_planning
    import fastscnn_tpu.perception.preprocessing as jax_pre
    import fastscnn_tpu.perception.transform as jax_transform

    for mod in (jax_transform, jax_pre, jax_planning):
        monkeypatch.setattr(mod, "_HAS_CV2", False)
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    root = _root_bench_latency()
    root_loop = root.realtime_loop(_BandSession(), frames=2)
    root_stages = root.realtime_stage_breakdown(_BandSession(), frames=2)
    loop, stages = line["realtime_loop"], line["realtime_stage_ms"]
    assert set(loop) == set(root_loop) and loop["frames"] == root_loop["frames"] == 2
    assert loop["fps"] > 0 and loop["frame_time_ms"] > 0 and loop["last_frame_ms"] > 0
    assert list(stages) == list(root_stages) == ["preprocess", "inference", "postprocess",
                                                 "bird_eye_transform", "path_planning", "control"]
    assert all(v >= 0 for v in stages.values()) and stages["inference"] > 0
    port_loop = bench_latency.realtime_loop(_BandSession(), frames=2)
    assert set(port_loop) == set(root_loop)


# ---------------------------------------------------------------------------
# bench_input and ab_int8_e2e
# ---------------------------------------------------------------------------


def test_bench_input_runs_on_the_cpu_without_pil(no_pil, tmp_path, capsys):
    table = {
        "citys_ce19": dict(dataset="citys", height=64, width=128, base_size=64, crop_size=48,
                           n=4, loss="ce", aux=True),
        "custom_dice2": dict(dataset="custom", height=72, width=128, base_size=64,
                             crop_size=48, n=4, loss="dice", aux=True),
    }
    out = bench_input.run(str(tmp_path), table, batch_size=2, workers=2, train_epochs=1,
                          device="cpu")
    json.dumps(out)
    assert set(out) == {"metric", "cpu_cores", "device", "graphed", "recipes"}
    assert out["metric"] == "input_pipeline" and out["device"] == "cpu"
    assert out["graphed"] is False  # the trainer's steps run eagerly on the CPU
    keys = {"threads_sps", "threads_cache_fill_sps", "threads_cached_sps", "grain_sps",
            "threads_device_aug_sps", "threads_device_aug_cached_sps", "e2e_train_sps",
            "e2e_train_cached_sps", "e2e_train_device_aug_cached_sps"}
    for name in table:
        assert set(out["recipes"][name]) == keys
        assert all(v > 0 for v in out["recipes"][name].values())
    # the custom recipe's images are JPEGs at quality 90, as the root bench writes them
    assert sorted(os.listdir(tmp_path / "custom_72" / "images"))[0] == "f00000.jpg"
    from fastscnn_tpu_torch.data import image_io, jpeg

    first = tmp_path / "custom_72" / "images" / "f00000.jpg"
    seeded = np.random.default_rng(0).integers(0, 256, (72, 128, 3), dtype=np.uint8)
    assert first.read_bytes() == jpeg.encode_jpeg(seeded, 90)
    assert image_io.read_image(str(first)).shape == (72, 128, 3)
    assert (tmp_path / "logs" / "training_log_custom.json").exists()  # the trainer's, there
    from fastscnn_tpu_torch.data import decoded_cache

    assert decoded_cache.get_cache_dir() is None
    assert bench_input.recipes(2)["citys_ce19"]["crop_size"] == 384


def test_ab_int8_e2e_runs_on_the_cpu(no_pil, capsys):
    out = ab_int8_e2e.main(["--hw", "64x128", "--batches", "2", "--iters", "2", "--trials", "1",
                            "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert set(out) == {"hw", "iters", "trials", "num_classes", "results"}
    assert set(out["results"]) == {"conv", "int8-a8", "int8-w8a8"}
    for impl, row in out["results"].items():
        assert set(row) == {"mask_agreement", "batches"}
        assert 0 < row["mask_agreement"] <= 1 and (impl != "conv" or row["mask_agreement"] == 1)
        assert set(row["batches"]["2"]) == {"fps", "ms_iter"} and row["batches"]["2"]["fps"] > 0
