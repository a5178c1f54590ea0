"""The JAX package's public surface in the port: every public top-level
name of every JAX module, read by AST, has a counterpart of the same name
in the port's module of the same path, but for a fixed list of
exceptions (the renames, which the README's port section lists, and what
ROADMAP item 5 leaves out, each with its reason); and the last names to
come over against the JAX functions: ``_entry.py``'s console shims,
``data/grain_loader.py::make_grain_loader`` and
``data/transforms.py::to_numpy_pair``.
"""

import ast
import os

import numpy as np
import pytest

import fastscnn_tpu._entry as jax_entry
import fastscnn_tpu_torch._entry as entry
from fastscnn_tpu.data import get_segmentation_dataset as jax_dataset
from fastscnn_tpu.data.grain_loader import make_grain_loader as jax_make_grain_loader
from fastscnn_tpu.data.transforms import to_numpy_pair as jax_to_numpy_pair
from fastscnn_tpu_torch.data import get_segmentation_dataset
from fastscnn_tpu_torch.data.grain_loader import GrainDataLoader, make_grain_loader
from fastscnn_tpu_torch.data.image_io import save_image
from fastscnn_tpu_torch.data.transforms import to_numpy_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX modules whose port has another path
MODULE_RENAMES = {
    "ops/pallas/__init__.py": "ops/cuda/__init__.py",
    "ops/pallas/dw_conv.py": "ops/cuda/dw_conv.py",
    "ops/pallas/int8_pw.py": "ops/cuda/int8_pw.py",
    "ops/pallas/upsample_argmax.py": "ops/cuda/upsample_argmax.py",
    "models/import_torch.py": "models/convert.py",
}
# (JAX module, name): its counterpart in the port, or why there is none
EXCEPTIONS = {
    ("engine/export.py", "export_stablehlo"): "engine/export.py::export_torch",
    ("engine/export.py", "export_onnx"): "engine/onnx_native.py::emit_fastscnn_onnx",
    ("engine/export.py", "export_tflite"): "item 5 (b): tensorflow",
    ("engine/export.py", "export_savedmodel"): "item 5 (b): tensorflow",
    ("engine/export.py", "TFLiteModel"): "item 5 (b): tensorflow",
    ("models/import_torch.py", "import_torch_state_dict"): "models/convert.py::to_param_trees",
    ("models/import_torch.py", "load_torch_checkpoint"): "models/convert.py::load_checkpoint",
    ("models/import_torch.py", "export_torch_state_dict"): "models/convert.py::from_jax_params",
    ("models/import_torch.py", "TORCH_KEY_MAP"): "models/convert.py::build_key_map",
    ("models/fast_scnn.py", "Params"): "a type alias: the port's trees are dicts of tensors",
    ("ops/conv.py", "f32_precision"): "__init__.py::f32_precision",
    ("ops/pallas/dw_conv.py", "dw_conv3x3_pallas"): "ops/cuda/dw_conv.py::dw_conv3x3",
    ("ops/pallas/dw_conv.py", "dw_conv3x3_pallas_vjp"): "ops/cuda/dw_conv.py::dw_conv3x3_vjp",
    ("ops/pallas/dw_conv.py", "ds_conv3x3_pw_pallas"): "ops/cuda/dw_conv.py::ds_conv3x3_pw",
    ("ops/pallas/dw_conv.py", "ds_conv3x3_pw_pallas_multirow"):
        "ops/cuda/dw_conv.py::ds_conv3x3_pw_multirow",
    ("tools/xplane.py", "MXU_TFLOPS_BF16"): "tools/xplane.py::TC_TFLOPS_BF16 (the card's peak)",
}
SHIMS = ("train", "evaluate", "demo", "export_model", "pipeline", "dashboard")


def _public_names(path: str) -> set:
    """The module's public top-level definitions and assignments."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _port_has(target: str) -> bool:
    """Whether ``module/path.py::name`` is a public name of the port."""
    path, name = target.split(" ")[0].split("::")
    return name in _public_names(os.path.join(ROOT, "fastscnn_tpu_torch", path))


def test_every_public_jax_name_has_a_port_counterpart():
    missing, used = [], set()
    jax_root = os.path.join(ROOT, "fastscnn_tpu")
    for folder, _, files in os.walk(jax_root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(folder, f), jax_root)
            port = os.path.join(ROOT, "fastscnn_tpu_torch", MODULE_RENAMES.get(rel, rel))
            if not os.path.exists(port):
                missing.append(rel)
                continue
            for name in sorted(_public_names(os.path.join(folder, f)) - _public_names(port)):
                if (rel, name) in EXCEPTIONS:
                    used.add((rel, name))
                else:
                    missing.append(f"{rel}::{name}")
    assert not missing, missing
    assert used == set(EXCEPTIONS), set(EXCEPTIONS) - used  # no stale exception
    for reason in EXCEPTIONS.values():  # each rename names a name the port has
        assert "item 5" in reason or "alias" in reason or _port_has(reason), reason


@pytest.mark.parametrize("name", SHIMS)
def test_console_shims_run_the_entry_points_as_the_jax_shims_do(name, monkeypatch):
    """Each shim calls its package's entry point with no arguments (the
    process's own) and returns 0, whatever the entry point returns."""
    calls = []
    for module, shim in (("fastscnn_tpu", jax_entry), ("fastscnn_tpu_torch", entry)):
        target = {"evaluate": "eval", "dashboard": "control_dashboard"}.get(name, name)
        mod = __import__(f"{module}.{target}", fromlist=["_"])
        fn = "demo" if name == "demo" else "main"
        monkeypatch.setattr(mod, fn, lambda *a, _m=module, **k: calls.append((_m, a, k)) or "x")
        assert getattr(shim, name)() == 0
    assert calls == [("fastscnn_tpu", (), {}), ("fastscnn_tpu_torch", (), {})]
    assert entry.__all__ == list(SHIMS)


@pytest.fixture(scope="module")
def citys(tmp_path_factory):
    """A Cityscapes tree of 4 train pairs of 40 × 72."""
    root = tmp_path_factory.mktemp("citys")
    rng = np.random.default_rng(0)
    for d in ("leftImg8bit", "gtFine"):
        (root / d / "train" / "c").mkdir(parents=True)
    for i in range(4):
        save_image(str(root / "leftImg8bit" / "train" / "c" / f"c_{i:06d}_leftImg8bit.png"),
                   rng.integers(0, 256, (40, 72, 3), dtype=np.uint8))
        save_image(str(root / "gtFine" / "train" / "c" / f"c_{i:06d}_gtFine_labelIds.png"),
                   rng.choice([0, 7, 8, 26, 33], size=(40, 72)).astype(np.uint8))
    return str(root)


def test_make_grain_loader_matches_jax(citys):
    """The port's loader from the same arguments (it never returns None:
    it needs no grain) gives each epoch the records of the JAX grain
    loader's, in its own order."""
    kw = dict(split="train", mode="train", base_size=40, crop_size=32)
    args = dict(batch_size=2, shuffle=True, num_workers=0, seed=3, num_epochs=2)
    jax_loader = jax_make_grain_loader(jax_dataset("citys", root=citys, **kw), **args)
    loader = make_grain_loader(get_segmentation_dataset("citys", root=citys, **kw), **args)
    assert isinstance(loader, GrainDataLoader) and len(loader) == len(jax_loader) == 4

    def epochs(batches):
        return [{(a.tobytes(), b.tobytes()) for im, tg in batches[e * 2:(e + 1) * 2]
                 for a, b in zip(im, tg)} for e in range(2)]

    got, want = list(loader), list(jax_loader)
    assert epochs(got) == epochs(want)
    assert all(im.dtype == np.uint8 and tg.dtype == np.int32 for im, tg in got)


def test_to_numpy_pair_matches_jax():
    """uint8 image and int32 mask, from arrays (the port reads no PIL
    image), equal to the JAX function's arrays."""
    rng = np.random.default_rng(1)
    for img, mask in ((rng.integers(0, 256, (5, 7, 3)).astype(np.uint8),
                       rng.integers(0, 256, (5, 7)).astype(np.uint8)),
                      (rng.integers(0, 256, (4, 6, 3)).astype(np.int64),
                       rng.integers(-1, 19, (4, 6)).astype(np.int64))):
        got, want = to_numpy_pair(img, mask), jax_to_numpy_pair(img, mask)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
