"""The port's trainer CLI and what it stands on, on the CPU: checkpoints
across both packages, the monitor's log, the presets, and ``train.main``
/ ``eval.main`` on a small synthetic Cityscapes tree (``--device cpu``).

Bounds:
- ``.pth`` files cross both ways with equal params (exact: a transpose);
- save → load → step equals the uninterrupted step bit for bit;
- ``eval.main`` of the port and of the JAX package on one tree and one
  ``.pth``, in f32, in ``testval`` and ``val`` mode: the FINAL pixAcc and
  mIoU within 1e-4 (one pixel of the 2 × 64 × 128 evaluated is 6.1e-5 of
  pixAcc, so a single near-tie argmax flip stays inside), and the colour
  dumps equal where the masks are;
- ``--resume`` by suffix, the JAX trainer's ``.npz`` files included, and a
  run with PIL blocked (host augmentation, the worker-process loader,
  ``val`` mode, ``eval.main`` with dumps).
"""

import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from fastscnn_tpu import eval as jax_eval
from fastscnn_tpu import train_presets as jax_presets
from fastscnn_tpu.models import init_fast_scnn as jax_init
from fastscnn_tpu.models.import_torch import export_torch_state_dict
from fastscnn_tpu.utils import checkpoint as jax_ckpt
from fastscnn_tpu.utils import monitor as jax_monitor
from fastscnn_tpu_torch import eval as port_eval
from fastscnn_tpu_torch import train, train_presets
from fastscnn_tpu_torch.data import decoded_cache
from fastscnn_tpu_torch.losses import get_loss_fn
from fastscnn_tpu_torch.models import init_fast_scnn, to_param_trees
from fastscnn_tpu_torch.parallel import create_train_state, make_optimizer, make_train_step
from fastscnn_tpu_torch.utils import checkpoint, lr_schedule, monitor
from fastscnn_tpu_torch.utils.tree import tree_leaves

_VALID = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the shapes here are small, and under the
    suite's parallel workers the default pool's spinning threads take the
    cores the other workers need."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves_np(tree):
    return [np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v)
            for v in jax.tree_util.tree_leaves(tree)]


# --- checkpoints -----------------------------------------------------------------


def test_pth_files_cross_both_ways(tmp_path):
    """A port ``.pth`` loads into the JAX loader with the port's params,
    and a JAX ``.pth`` into the port's loader with JAX's (aux included)."""
    model = init_fast_scnn(19, aux=True, generator=torch.Generator().manual_seed(3), device="cpu")
    params, state = to_param_trees(model)
    path = checkpoint.save_pth_checkpoint(params, state, str(tmp_path / "port"), dataset="citys")
    assert os.path.basename(path) == "fast_scnn_citys.pth"
    jp, js = jax_ckpt.load_pth_checkpoint(path, 19)
    for a, b in zip(_leaves_np((params, state)), _leaves_np((jp, js))):
        np.testing.assert_array_equal(a, b)

    jp, js = jax_init(jax.random.PRNGKey(1), 19, aux=True)
    path = jax_ckpt.save_pth_checkpoint(jp, js, str(tmp_path / "jax"), dataset="citys",
                                        is_best=True)
    tp, ts = checkpoint.load_pth_checkpoint(path, 19)
    assert "auxlayer" in tp
    for a, b in zip(_leaves_np((jp, js)), _leaves_np((tp, ts))):
        np.testing.assert_array_equal(a, b)
    best = checkpoint.save_pth_checkpoint(tp, ts, str(tmp_path / "again"), dataset="x",
                                          is_best=True, aux=False)
    assert os.path.exists(os.path.join(tmp_path, "again", "fast_scnn_x_best_model.pth"))
    assert not any(k.startswith("auxlayer.") for k in torch.load(best, weights_only=True))


def test_partial_load_19_to_2_classes_keeps_the_jax_leaves(tmp_path):
    """The custom_finetune load: a 19-class checkpoint into a 2-class model
    keeps exactly the leaves JAX's loader keeps (all but the classifier's
    last conv); without ``allow_shape_mismatch`` both raise."""
    jp, js = jax_init(jax.random.PRNGKey(2), 19, aux=False)
    path = jax_ckpt.save_pth_checkpoint(jp, js, str(tmp_path), dataset="bdd100k")
    src = _leaves_np((jp, js))
    kept = []
    for loader in (jax_ckpt.load_pth_checkpoint, checkpoint.load_pth_checkpoint):
        with pytest.raises(ValueError, match="shape mismatch"):
            loader(path, 2)
        out = _leaves_np(loader(path, 2, allow_shape_mismatch=True))
        assert len(out) == len(src)
        kept.append([a.shape == b.shape and np.array_equal(a, b) for a, b in zip(src, out)])
    assert kept[0] == kept[1] and sum(kept[0]) == len(src) - 2
    # the JAX package's torch-free weights file: the same partial load
    npz = str(tmp_path / "fast_scnn_bdd100k.pth.npz")
    np.savez(npz, **export_torch_state_dict(jp, js))
    out = _leaves_np(checkpoint.load_pth_checkpoint(npz, 2, allow_shape_mismatch=True))
    assert [a.shape == b.shape and np.array_equal(a, b) for a, b in zip(src, out)] == kept[0]


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_save_load_step_equals_the_uninterrupted_step(tmp_path, opt_name):
    """Two steps in a row against one step, save, a fresh state loaded, and
    the second step: params, BN statistics, optimizer state and step count
    bit for bit (momentum / Adam moments included)."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, 32, 48, 3)).astype(np.uint8)
    targets = rng.integers(-1, 19, (2, 32, 48)).astype(np.int32)

    def fresh():
        model = init_fast_scnn(19, aux=True, generator=torch.Generator().manual_seed(0),
                               device="cpu")
        opt = make_optimizer(opt_name, lr_schedule("poly", base_lr=1e-2, niters=10))
        step = make_train_step(model, get_loss_fn("ce", aux=True, num_classes=19), opt,
                               compute_dtype=torch.float32, device="cpu")
        return create_train_state(model, opt, device="cpu"), step

    state, step = fresh()
    step(state, images, targets)
    path = checkpoint.save_train_state(state, str(tmp_path / "train_state_citys.pt"))
    step(state, images, targets)
    resumed, step2 = fresh()
    resumed = checkpoint.load_train_state(path, resumed)
    assert resumed.step == 1
    step2(resumed, images, targets)
    assert resumed.step == state.step == 2
    for a, b in zip(tree_leaves(state.params) + tree_leaves(state.model_state),
                    tree_leaves(resumed.params) + tree_leaves(resumed.model_state)):
        assert torch.equal(a, b)
    for a, b in zip(state.opt_state.state.values(), resumed.opt_state.state.values()):
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
    torch.load(path, weights_only=True)  # tensors and numbers only


# --- monitor and presets ------------------------------------------------------------


def test_monitor_log_and_report_equal_jax(tmp_path, monkeypatch, capsys):
    """The same records give the same JSON log, best epochs and report
    (the clock held still in both); no matplotlib or TensorBoard: one line
    each and the run goes on."""
    for mod in (jax_monitor, monitor):
        monkeypatch.setattr(mod.time, "time", lambda: 1000.0)
    records = [(0, 2.5, 0.01, None, None, 10.0), (1, 2.0, 0.008, 0.5, 0.2, 11.0),
               (2, 1.8, 0.006, 0.6, 0.3, None), (3, 1.9, 0.004, 0.55, 0.25, 12.0),
               (4, 1.7, 0.002, None, None, None), (5, 1.75, 0.0, 0.7, 0.4, 9.0)]
    mons = [mod.TrainingMonitor(str(tmp_path / name / "log.json"), experiment_name="e")
            for mod, name in ((jax_monitor, "jax"), (monitor, "port"))]
    for epoch, loss, lr, acc, miou, sps in records:
        best = [m.log_epoch(epoch, loss, lr, pix_acc=acc, miou=miou, samples_per_sec=sps)
                for m in mons]
        assert best[0] == best[1]
    logs = [json.load(open(m.log_path)) for m in mons]
    assert logs[0] == logs[1] and mons[0].best == mons[1].best
    assert mons[0].report() == mons[1].report()
    resumed = monitor.TrainingMonitor(mons[1].log_path, experiment_name="e", resume=True)
    assert resumed.records == logs[1] and resumed.best == mons[1].best
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    quiet = monitor.TrainingMonitor(str(tmp_path / "q" / "log.json"),
                                    tensorboard_dir=str(tmp_path / "tb"))
    quiet.log_epoch(0, 1.0, 0.1)
    assert quiet.plot_curves() is None
    out = capsys.readouterr().out
    assert "no matplotlib" in out and "tensorboard" in out


def test_presets_equal_jax_and_put_user_flags_last(monkeypatch):
    assert train_presets.PRESETS == jax_presets.PRESETS
    seen = []
    monkeypatch.setattr(train, "main", lambda argv: seen.append(argv))
    train_presets.main(["custom_finetune", "--lr", "5e-4"])
    assert seen[0][-2:] == ["--lr", "5e-4"] and seen[0][:2] == ["--dataset", "custom"]
    assert train.parse_args(seen[0]).lr == 5e-4
    with pytest.raises(SystemExit, match="usage"):
        train_presets.main(["nope"])


def test_flags_and_defaults_equal_jax():
    """Every flag of the JAX trainer and evaluator, with its default; the
    port adds ``--device``."""
    from fastscnn_tpu import train as jax_train

    for ours, theirs in ((train.parse_args([]), jax_train.parse_args([])),
                         (port_eval.parse_args([]), jax_eval.parse_args([]))):
        a, b = vars(ours), vars(theirs)
        assert a.pop("device") is None and a == b
    exp = train.parse_args(["--experiment"])
    assert (exp.sample_ratio, exp.epochs, exp.batch_size, exp.val_epoch) == (0.05, 20, 4, 2)


# --- the CLIs on a synthetic Cityscapes tree --------------------------------------------


@pytest.fixture(scope="module")
def citys(tmp_path_factory):
    """4 train and 2 val pairs at 64×128: RGB PNGs, labelIds of every
    valid class and of ignored ids, each label a block function of its
    image so that a model can learn it."""
    root = tmp_path_factory.mktemp("citys")
    rng = np.random.default_rng(0)
    palette = rng.integers(0, 256, (len(_VALID) + 2, 3))
    ids = np.array(_VALID + (0, 4))
    for split, n in (("train", 4), ("val", 2)):
        for d in ("leftImg8bit", "gtFine"):
            (root / d / split / "c").mkdir(parents=True)
        for i in range(n):
            cls = rng.integers(0, len(ids), (4, 8)).repeat(16, 0).repeat(16, 1)
            img = np.clip(palette[cls] + rng.integers(-20, 21, (64, 128, 3)), 0, 255)
            Image.fromarray(img.astype(np.uint8)).save(
                root / "leftImg8bit" / split / "c" / f"c_{i:06d}_leftImg8bit.png")
            Image.fromarray(ids[cls].astype(np.uint8)).save(
                root / "gtFine" / split / "c" / f"c_{i:06d}_gtFine_labelIds.png")
    return str(root)


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    """Runs in a fresh directory (the trainer writes ``logs/`` there) with
    the decoded cache off and its counts at 0."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(decoded_cache, "_cache_dir", None)
    monkeypatch.setattr(decoded_cache, "_hits", 0)
    monkeypatch.setattr(decoded_cache, "_misses", 0)
    return tmp_path


def _train(citys, *flags):
    return train.main(["--device", "cpu", "--dataset", "citys", "--data-root", citys,
                       "--base-size", "64", "--crop-size", "48", "--batch-size", "2",
                       "--num-workers", "1", "--print-interval", "1", "--aux",
                       "--loss-type", "ce", *flags])


def _losses(out):
    return [float(v) for v in re.findall(r" loss (\S+) lr", out)]


def test_train_two_epochs_then_auto_resume(citys, workdir, capsys):
    """2 epochs through --device-aug, the B6 stem and the decoded cache
    (the second epoch all hits), the JAX trainer's file names; then
    --epochs 3 --auto-resume goes on at step 4, epoch 2, to step 6, its
    learning rate the 3-epoch poly schedule's."""
    trainer = _train(citys, "--epochs", "2", "--device-aug", "--stem-impl", "pallas",
                     "--decoded-cache", "cache", "--save-epoch", "1", "--save-folder", "S")
    out = capsys.readouterr().out
    assert trainer.state.step == 4 and len(_losses(out)) == 4
    assert all(np.isfinite(_losses(out)))
    # 4 train and 2 val pairs decoded once each, then read back from the cache
    assert decoded_cache.stats()["misses"] == 12 and decoded_cache.stats()["hits"] == 12
    for name in ("fast_scnn_citys.pth", "fast_scnn_citys_best_model.pth",
                 "train_state_citys.pt"):
        assert os.path.exists(os.path.join("S", name)), name
    log = json.load(open("logs/training_log_citys.json"))
    assert [r["epoch"] for r in log] == [0, 1] and "pix_acc" in log[0]
    resumed = _train(citys, "--epochs", "3", "--device-aug", "--stem-impl", "pallas",
                     "--save-folder", "S", "--auto-resume", "--no-val")
    out = capsys.readouterr().out
    assert "resumed full train state from S/train_state_citys.pt (step 4)" in out
    assert re.findall(r"epoch (\d) iter", out) == ["2", "2"]
    assert resumed.state.step == 6
    sched = lr_schedule("poly", base_lr=1e-2, nepochs=3, iters_per_epoch=2, power=0.9)
    lrs = [float(v) for v in re.findall(r" iter \S+ loss \S+ lr (\S+) ", out)]
    np.testing.assert_allclose(lrs, [round(sched(5), 5), round(sched(6), 5)])
    assert [r["epoch"] for r in json.load(open("logs/training_log_citys.json"))] == [0, 1, 2]


def test_eval_flag_and_host_augmentation(citys, workdir, capsys):
    """--eval validates and returns (val mode resizes with PIL); a run
    without --device-aug trains on the host transforms."""
    _train(citys, "--epochs", "1", "--save-folder", "S")
    assert os.path.exists("S/fast_scnn_citys.pth")
    _train(citys, "--eval", "--resume", "S/fast_scnn_citys.pth")
    out = capsys.readouterr().out
    assert "resumed weights from S/fast_scnn_citys.pth" in out
    assert re.search(r"val pixAcc \d+\.\d+% mIoU \d+\.\d+%", out)


def test_split_aug_with_grad_accum_and_the_same_seed_twice(citys, workdir, capsys):
    """--device-aug-split --grad-accum 2 trains; two runs with the same
    flags and seed print the same losses, another seed other losses."""
    flags = ["--epochs", "1", "--device-aug", "--device-aug-split", "--grad-accum", "2",
             "--no-val", "--stem-impl", "pallas"]
    runs = []
    for seed in ("0", "0", "1"):
        _train(citys, *flags, "--seed", seed, "--save-folder", f"S{len(runs)}")
        runs.append(_losses(capsys.readouterr().out))
    assert len(runs[0]) == 2 and runs[0] == runs[1] != runs[2]


def test_cli_refusals(citys, workdir):
    """The split flag alone warns (and trains on the host transforms)."""
    with pytest.warns(UserWarning, match="--device-aug-split"):
        _train(citys, "--epochs", "1", "--no-val", "--device-aug-split", "--save-folder", "S")


def _jax_train_state(optimizer, step):
    """The JAX trainer's ``create_train_state`` for the CLI's model (19
    classes, aux), its step count set to ``step``."""
    import dataclasses

    import jax.numpy as jnp

    from fastscnn_tpu.models import FastSCNN as JaxFastSCNN
    from fastscnn_tpu.parallel.train import create_train_state as jax_create
    from fastscnn_tpu.parallel.train import make_optimizer as jax_optimizer
    from fastscnn_tpu.utils.lr_scheduler import lr_schedule as jax_lr

    schedule = jax_lr("poly", base_lr=1e-2, nepochs=2, iters_per_epoch=2, power=0.9)
    state = jax_create(JaxFastSCNN(19, aux=True), jax_optimizer(optimizer, schedule),
                       key=jax.random.PRNGKey(4))
    return dataclasses.replace(state, step=jnp.asarray(step, jnp.int32))


def test_resume_routes_by_suffix(citys, workdir, capsys):
    """``.pth.npz`` (the JAX package's torch-free weights file) resumes as
    weights with JAX's params; any other ``.npz`` as the JAX trainer's full
    state, going on from its step; ``--auto-resume`` takes only the port's
    ``.pt``, never a JAX ``.npz`` in the same folder."""
    jp, js = jax_init(jax.random.PRNGKey(6), 19, aux=True)
    os.makedirs("W")
    np.savez("W/fast_scnn_citys.pth.npz", **export_torch_state_dict(jp, js))
    trainer = _train(citys, "--eval", "--resume", "W/fast_scnn_citys.pth.npz")
    assert "resumed weights from W/fast_scnn_citys.pth.npz" in capsys.readouterr().out
    want = _leaves_np(jax_ckpt.load_pth_checkpoint("W/fast_scnn_citys.pth.npz", 19))
    for a, b in zip(want, _leaves_np((trainer.state.params, trainer.state.model_state))):
        np.testing.assert_array_equal(a, b)

    jax_ckpt.save_train_state(_jax_train_state("sgd", 2), "W/train_state_citys.npz")
    trainer = _train(citys, "--epochs", "2", "--device-aug", "--no-val", "--save-folder", "W",
                     "--resume", "W/train_state_citys.npz")
    out = capsys.readouterr().out
    assert "resumed full train state from W/train_state_citys.npz (step 2)" in out
    assert re.findall(r"epoch (\d) iter", out) == ["1", "1"] and trainer.state.step == 4
    os.remove("W/train_state_citys.pt")
    trainer = _train(citys, "--epochs", "1", "--device-aug", "--no-val", "--save-folder", "W",
                     "--auto-resume")
    assert "resumed" not in capsys.readouterr().out and trainer.state.step == 2


def test_a_pil_blocked_run_trains_validates_and_evaluates(citys, workdir, capsys, monkeypatch,
                                                          tmp_path):
    """With PIL blocked (``sys.modules``, and a stub that raises on import
    ahead of it on the path the loader's worker processes inherit) and
    matplotlib too: one
    host-augmented epoch through ``--loader grain`` with 2 workers and
    validation in ``val`` mode, then ``eval.main --mode val`` with its
    colour dumps, each read back with the port's decoder; FINAL equals the
    host metric of the dumped masks."""
    stub = tmp_path / "stub"
    (stub / "PIL").mkdir(parents=True)
    (stub / "PIL" / "__init__.py").write_text("raise ImportError('PIL is blocked')\n")
    monkeypatch.syspath_prepend(str(stub))
    # the card's machine has neither PIL nor matplotlib (which imports PIL)
    for top in ("PIL", "matplotlib"):
        for name in [m for m in sys.modules if m == top or m.startswith(top + ".")]:
            monkeypatch.setitem(sys.modules, name, None)
        monkeypatch.setitem(sys.modules, top, None)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    _train(citys, "--epochs", "1", "--loader", "grain", "--num-workers", "2",
           "--save-folder", "S")
    out = capsys.readouterr().out
    assert len(_losses(out)) == 2 and all(np.isfinite(_losses(out)))
    assert re.search(r"epoch 0: val pixAcc \d+\.\d+% mIoU \d+\.\d+%", out)
    evaluator = port_eval.main(["--device", "cpu", "--dataset", "citys", "--data-root", citys,
                                "--weights", "S/fast_scnn_citys.pth", "--aux", "--mode", "val",
                                "--base-size", "64", "--crop-size", "48", "--outdir", "dumps"])
    pix_acc, miou = evaluator.metric.get()
    assert f"FINAL pixAcc {pix_acc * 100:.3f}% mIoU {miou * 100:.3f}%" in capsys.readouterr().out
    from fastscnn_tpu_torch.data import get_segmentation_dataset, image_io
    from fastscnn_tpu_torch.utils.metric import SegmentationMetric

    ds = get_segmentation_dataset("citys", root=citys, split="val", mode="val", base_size=64,
                                  crop_size=48)
    host = SegmentationMetric(19)
    for i in range(len(ds)):
        mask, mode = image_io.decode(f"dumps/seg_{i}.png")
        assert mode == "P" and mask.shape == (48, 48)
        host.update(mask.astype(np.int64), ds[i][1])
    assert host.get() == (pix_acc, miou)


@pytest.mark.parametrize("mode", ["testval", "val"])
def test_eval_main_matches_jax(citys, workdir, capsys, mode):
    """One .pth (a short port run), batch 2, f32, in ``testval`` and in
    ``val`` mode (resize and centre crop on the host): the port's and
    JAX's FINAL pixAcc/mIoU within 1e-4 and their colour dumps equal (the
    same indices and palette); the port's FINAL equals the host metric
    recomputed from its masks."""
    _train(citys, "--epochs", "2", "--device-aug", "--no-val", "--save-folder", "S",
           "--lr", "0.05")
    capsys.readouterr()
    flags = ["--dataset", "citys", "--data-root", citys, "--weights", "S/fast_scnn_citys.pth",
             "--aux", "--batch-size", "2", "--per-class", "--mode", mode, "--base-size", "64",
             "--crop-size", "48"]
    evaluator = port_eval.main(["--device", "cpu", "--outdir", "port", *flags])
    ours = capsys.readouterr().out
    jax_eval.main(["--outdir", "jax", *flags])
    theirs = capsys.readouterr().out
    final = [re.search(r"FINAL pixAcc (\S+)% mIoU (\S+)%", o).groups() for o in (ours, theirs)]
    np.testing.assert_allclose(np.array(final[0], float), np.array(final[1], float), atol=1e-2)
    pix_acc, miou = evaluator.metric.get()
    assert 0.0 < pix_acc and final[0] == (f"{pix_acc * 100:.3f}", f"{miou * 100:.3f}")
    assert ours.count("IoU") == theirs.count("IoU")
    from fastscnn_tpu_torch.data import get_segmentation_dataset
    from fastscnn_tpu_torch.utils.metric import SegmentationMetric

    ds = get_segmentation_dataset("citys", root=citys, split="val", mode=mode, base_size=64,
                                  crop_size=48)
    host = SegmentationMetric(19)
    for i in range(len(ds)):
        a, b = Image.open(f"port/seg_{i}.png"), Image.open(f"jax/seg_{i}.png")
        assert a.getpalette() == b.getpalette()
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == ds[i][1].shape and (a != b).sum() <= 1  # a near-tie flip at most
        host.update(a.astype(np.int64), ds[i][1])
    assert host.get() == (pix_acc, miou)
