"""The port's export CLI (``export_model.py``) and what runs on its
artifacts — ``pipeline --export-path``, ``compare_backends --export-path``
and ``tools/system_check.main`` — on the CPU: each passes its own parity
gate in ``pt2`` and ``onnx``, the formats the port does not have raise,
and the check's six stages run on a small tree.
"""

import functools
import json

import numpy as np
import pytest
import torch

from fastscnn_tpu_torch import export_model
from fastscnn_tpu_torch.engine import E2EConfig, InferenceEngine
from fastscnn_tpu_torch.engine import export as X
from fastscnn_tpu_torch.models import init_fast_scnn, to_param_trees


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes here are small, and under the
    suite's parallel workers the default pool's spinning threads take the
    cores the other workers need."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("fmt, extra", [("pt2", ["--argmax"]), ("pt2", ["--atc-compat"]),
                                        ("onnx", []), ("onnx", ["--argmax", "--normalize"])])
def test_export_model_main_passes_its_gate(tmp_path, capsys, fmt, extra):
    out = str(tmp_path / f"m.{fmt}")
    argv = ["--device", "cpu", "--format", fmt, "--input-height", "48", "--input-width", "80",
            "--internal-size", "64", "--output", out, *extra]
    assert export_model.main(argv) == out
    text = capsys.readouterr().out
    assert "artifact parity vs in-process engine: 100.000% pixels agree" in text
    assert "exporting random init" in text
    with open(out + ".json") as f:
        meta = json.load(f)
    assert meta["atc_compat"] is ("--atc-compat" in extra)
    assert meta["softmax"] is ("--argmax" not in extra)
    if fmt == "onnx":
        assert "float32 (was bfloat16)" in text and meta["opset"] == 13
        assert "backend: numpy" in text
    else:
        assert meta["compute_dtype"] == "bfloat16" and meta["format"] == "torch-export"


def test_export_model_main_loads_weights(tmp_path, capsys):
    from fastscnn_tpu_torch.utils.checkpoint import save_pth_checkpoint

    model = init_fast_scnn(2, True, generator=torch.Generator().manual_seed(11), device="cpu")
    path = save_pth_checkpoint(*to_param_trees(model), str(tmp_path), dataset="custom")
    out = str(tmp_path / "w.pt2")
    export_model.main(["--device", "cpu", "--weights", path, "--aux", "--argmax", "--dtype",
                       "float32", "--input-height", "64", "--input-width", "128",
                       "--internal-size", "0", "--output", out])
    assert f"loaded {path}" in capsys.readouterr().out
    eng = InferenceEngine(model, device="cpu", config=E2EConfig(compute_dtype="float32"))
    images = np.random.default_rng(12).integers(0, 256, (1, 64, 128, 3), dtype=np.uint8)
    assert torch.equal(X.load_exported(out, device="cpu")(images), eng.predict(images))


@pytest.mark.parametrize("argv, why", [
    (["--format", "stablehlo"], "JAX package's own"),
    (["--format", "tflite"], "tensorflow"),
    (["--format", "savedmodel"], "tensorflow"),
    (["--fp16", "--int8"], "mutually exclusive"),
    (["--fp16"], "tflite only"),
    (["--format", "onnx", "--int8"], "tflite only"),
    (["--calib-images", "d"], "only applies with --int8"),
    (["--format", "tflite", "--int8", "--calib-images", "d"], "tensorflow"),
])
def test_export_model_refuses(argv, why):
    with pytest.raises(SystemExit, match=why):
        export_model.main(["--device", "cpu", *argv])


def test_calibration_batches_read_pngs_without_pil(tmp_path):
    from fastscnn_tpu_torch.data import image_io, pil_ops

    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (30, 50, 3), dtype=np.uint8) for _ in range(5)]
    for i, f in enumerate(frames):
        image_io.write_png(str(tmp_path / f"f{i}.png"), f)
    batches = export_model._calibration_batches(str(tmp_path), (2, 24, 40, 3), rng)
    assert len(batches) == 2 and batches[0].shape == (2, 24, 40, 3)
    assert np.array_equal(batches[1][0], pil_ops.resize(frames[2], (40, 24), "bicubic"))
    synth = export_model._calibration_batches(None, (1, 8, 8, 3), rng)
    assert len(synth) == 8 and synth[0].dtype == np.uint8


def test_system_check_runs_its_six_stages(tmp_path, monkeypatch, capsys):
    """``system_check.main`` on the CPU, on a smaller tree and export shape
    (8 train and 2 val scenes; a 96x160 artifact): one epoch, so the
    accuracy gate fails as in the JAX check and the reference-layout
    cross-check runs; the artifact's stages pass."""
    from fastscnn_tpu_torch.tools import system_check as sc

    monkeypatch.setattr(sc, "EXPORT_SHAPE", (1, 96, 160, 3))
    monkeypatch.setattr(sc, "generate_dataset",
                        functools.partial(sc.generate_dataset, n_train=8, n_val=2))
    cwd = str(tmp_path)
    monkeypatch.chdir(cwd)
    assert sc.main(["--epochs", "1", "--device", "cpu", "--workdir", "check"]) == 1
    out = capsys.readouterr().out
    assert "[1/6] synthetic 19-class Cityscapes-format dataset at " + str(tmp_path / "check")
    assert "WARNING: pixAcc below 60%" in out
    mismatch = float(out.split("worst mask mismatch ")[1].split("%")[0])
    assert mismatch < 0.5
    assert "[5/6] torch.export artifact ok" in out and "[6/6] perception pipeline" in out
    assert out.rstrip().endswith("SYSTEM CHECK: FAIL") and str(tmp_path) == cwd


def test_entry_points_default_to_the_card_and_raise_without_one(tmp_path, monkeypatch):
    """``device=None`` (no ``--device``) means the CUDA card: without one,
    the export CLI, loading an artifact, the pipeline's artifact session and
    the system check raise before doing any work."""
    from fastscnn_tpu_torch import pipeline
    from fastscnn_tpu_torch.tools import system_check

    path = str(tmp_path / "m.pt2")
    model = init_fast_scnn(2, generator=torch.Generator().manual_seed(0), device="cpu")
    eng = InferenceEngine(model, device="cpu", config=E2EConfig(compute_dtype="float32"))
    X.export_torch(eng, (1, 32, 64, 3), path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: export_model.main(["--output", str(tmp_path / "x.pt2")]),
                 lambda: X.load_exported(path),
                 lambda: pipeline.ArtifactSession(path),
                 lambda: system_check.main(["--quick", "--workdir", str(tmp_path / "sc")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "x.pt2").exists() and not (tmp_path / "sc").exists()
