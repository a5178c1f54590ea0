"""The port's CLIs on their graphed steps, checked where no card is
(``parallel/train.py``'s ``make_eval_step(graph=True)``, ``train.Trainer``,
``eval.Evaluator``, ``tools/argmax_first_study.train_model``, and the
in-place ``utils/checkpoint.load_train_state`` a graphed resume needs):

- a ``.pt`` of one state and a JAX ``.npz`` load into a template whose
  groups read their rate on the card (fused SGD, capturable AdamW, a rate
  tensor): every tensor a graph reads keeps its address, the options stay
  the template's, the values are the file's (the JAX leaves);
- the graphed forms against the eager ones, bit for bit, with the capture
  replaced by a stand-in that replays the body eagerly (as
  ``tests/test_torch_graph_step.py`` does; the real capture runs only on
  the card, in ``chip_smoke.py``): the eval step (masks and per-sample
  statistics, one capture a key, a refusal of rebound params); the
  trainer for 2 epochs with validation, and a run stopped after epoch 1
  and resumed, against the uninterrupted run (saved state, losses, val
  scores); ``eval.main`` against the JAX ``eval.main``'s per-sample lines
  on the same weights, at batch 1 and at batch 2 with a partial batch;
  the study's ``train_model`` for 3 steps.

The stand-in runs on the CPU, where the SGD groups are marked ``fused``
(the capture refuses an update that reads a host rate; torch's fused SGD
runs on the CPU too) for the eager and the graphed runs alike.
"""

import contextlib
import functools
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from fastscnn_tpu import eval as jax_eval
from fastscnn_tpu.models import FastSCNN as JaxFastSCNN
from fastscnn_tpu.models import init_fast_scnn as jax_init
from fastscnn_tpu.parallel.train import create_train_state as jax_create
from fastscnn_tpu.parallel.train import make_optimizer as jax_optimizer
from fastscnn_tpu.utils import checkpoint as jax_ckpt
from fastscnn_tpu.utils.lr_scheduler import lr_schedule as jax_lr
from fastscnn_tpu_torch import eval as port_eval
from fastscnn_tpu_torch import train
from fastscnn_tpu_torch.data import decoded_cache
from fastscnn_tpu_torch.data.image_io import write_png
from fastscnn_tpu_torch.losses import get_loss_fn
from fastscnn_tpu_torch.models import from_jax_params, init_fast_scnn, to_param_trees
from fastscnn_tpu_torch.parallel import (
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from fastscnn_tpu_torch.parallel import train as train_mod
from fastscnn_tpu_torch.tools import argmax_first_study as study
from fastscnn_tpu_torch.utils import checkpoint, lr_schedule
from fastscnn_tpu_torch.utils.cuda_graph import Captured
from fastscnn_tpu_torch.utils.tree import tree_leaves, tree_map

CPU = torch.device("cpu")
_VALID = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the stand-in capture ------------------------------------------------------------


class _Stream:
    def wait_stream(self, other):
        pass


class _Replayed:
    """A stand-in for a CUDA graph: ``replay`` runs the body again and
    copies its results into the first pass's outputs, as a replay rewrites
    the captured outputs in place."""

    def __init__(self, body, out):
        self.body, self.out = body, out

    def replay(self):
        for dst, src in zip(self._flat(self.out), self._flat(self.body())):
            dst.copy_(src)

    @staticmethod
    def _flat(out):
        return list(out) if isinstance(out, tuple) else [out]


@pytest.fixture
def stand_in_capture(monkeypatch):
    """The graphed steps on the CPU: streams and pools that do nothing, the
    capture replaced by :class:`_Replayed`, and SGD's groups fused (the
    update a card's optimizer runs). Yields the captures' generators."""
    captures = []

    def fake_capture(body, device, pool, stream, generators=()):
        captures.append(list(generators))
        out = body()
        return Captured(_Replayed(body, out), out, {}, 0, [])

    real_init = train_mod.Optimizer.init

    def fused_init(self, params):
        opt = real_init(self, params)
        for group in opt.param_groups:
            group["fused"] = self.name == "sgd" or None
        return opt

    monkeypatch.setattr(train_mod, "capture", fake_capture)
    monkeypatch.setattr(train_mod.Optimizer, "init", fused_init)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(train_mod, "_step_device", lambda device, graph: CPU)
    return captures


# --- the in-place resume ---------------------------------------------------------------


def _template(opt_name, num_classes=4, seed=0):
    """A stepped state (its optimizer slots made) whose groups then read
    their rate as the card's do: fused SGD or capturable AdamW, the rate a
    0-dim tensor."""
    model = init_fast_scnn(num_classes, aux=True, generator=torch.Generator().manual_seed(seed),
                           device="cpu")
    opt = make_optimizer(opt_name, lr_schedule("poly", base_lr=1e-2, niters=10))
    state = create_train_state(model, opt, device="cpu")
    step = make_train_step(model, get_loss_fn("ce", aux=True, num_classes=num_classes), opt,
                           compute_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(seed)
    step(state, rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8),
         rng.integers(-1, num_classes, (2, 32, 32)).astype(np.int32))
    for group in state.opt_state.param_groups:
        group["fused" if opt_name == "sgd" else "capturable"] = True
        group["lr"] = torch.tensor(0.5)
    return state


def _options(opt):
    return [{k: v for k, v in g.items() if k != "params"} for g in opt.param_groups]


def _check_in_place(state, before, options, rates):
    assert [t.data_ptr() for t in train_mod._state_tensors(state)] == before
    assert _options(state.opt_state) == options
    assert [g["lr"] for g in state.opt_state.param_groups] == rates  # the same tensors
    assert all(g["lr"] is r for g, r in zip(state.opt_state.param_groups, rates))


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_a_pt_loads_in_place_into_a_graph_template(tmp_path, opt_name):
    """A ``.pt`` of another run (its groups: CPU options, a float rate)
    restores the values into the template's own tensors."""
    saved = _template(opt_name, seed=1)
    for group in saved.opt_state.param_groups:  # what a CPU run's file holds
        group.update(lr=0.01, fused=None, capturable=False)
    saved.step = 7
    path = checkpoint.save_train_state(saved, str(tmp_path / "train_state_citys.pt"))
    state = _template(opt_name, seed=2)
    before = [t.data_ptr() for t in train_mod._state_tensors(state)]
    options = _options(state.opt_state)
    rates = [g["lr"] for g in state.opt_state.param_groups]
    assert checkpoint.load_train_state(path, state) is state and state.step == 7
    _check_in_place(state, before, options, rates)
    for a, b in zip(tree_leaves(saved.params) + tree_leaves(saved.model_state),
                    tree_leaves(state.params) + tree_leaves(state.model_state)):
        assert torch.equal(a, b)
    saved_slots = [saved.opt_state.state[p] for p in tree_leaves(saved.params)]
    slots = [state.opt_state.state[p] for p in tree_leaves(state.params)]
    assert all(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
               for a, b in zip(saved_slots, slots))


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_a_jax_npz_loads_in_place_into_a_graph_template(tmp_path, opt_name):
    """The JAX trainer's ``.npz``, every leaf drawn at random: the masters,
    BN statistics, momentum (or Adam's moments and count) and step are the
    JAX leaves, in the template's own tensors."""
    jstate = jax_create(JaxFastSCNN(4, aux=True),
                        jax_optimizer(opt_name, jax_lr("poly", base_lr=1e-2, niters=10)),
                        key=jax.random.PRNGKey(3))
    leaves, treedef = jax.tree_util.tree_flatten(jstate)
    rng = np.random.default_rng(4)
    leaves = [rng.integers(1, 50, np.shape(v)).astype(np.asarray(v).dtype)
              if np.issubdtype(np.asarray(v).dtype, np.integer)
              else rng.standard_normal(np.shape(v)).astype(np.float32) for v in leaves]
    jstate = jax.tree_util.tree_unflatten(treedef, leaves)
    path = jax_ckpt.save_train_state(jstate, str(tmp_path / "train_state_citys.npz"))
    state = _template(opt_name)
    before = [t.data_ptr() for t in train_mod._state_tensors(state)]
    options = _options(state.opt_state)
    rates = [g["lr"] for g in state.opt_state.param_groups]
    checkpoint.load_train_state(path, state)
    _check_in_place(state, before, options, rates)
    assert state.step == int(jstate.step)
    params = tree_leaves(state.params)
    if opt_name == "sgd":
        want = {"momentum_buffer": jstate.opt_state[1][0].trace}
    else:
        adam = jstate.opt_state[0]
        want = {"exp_avg": adam.mu, "exp_avg_sq": adam.nu}
        assert all(float(state.opt_state.state[p]["step"]) == float(adam.count) for p in params)
    pairs = [(jstate.params, state.params), (jstate.model_state, state.model_state)]
    pairs += [(tree, [state.opt_state.state[p][k] for p in params]) for k, tree in want.items()]
    for jtree, ttree in pairs:
        for a, b in zip(jax.tree_util.tree_leaves(jtree), tree_leaves(ttree)):
            np.testing.assert_array_equal(b.detach().numpy(), np.asarray(a))


# --- the graphed eval step ---------------------------------------------------------------


def test_graphed_eval_step_equals_eager_and_refuses_other_params(stand_in_capture):
    """Masks and per-sample statistics bit-equal to the eager step's at two
    input shapes, each captured once; other params raise; ``graph=True``
    off the card raises."""
    model = init_fast_scnn(19, aux=True, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    params, model_state = to_param_trees(model)
    kw = dict(compute_dtype=torch.float32, per_sample_stats=True, pred_dtype=torch.uint8,
              device="cpu")
    eager = make_eval_step(model, 19, **kw)
    graphed = make_eval_step(model, 19, graph=True, **kw)
    rng = np.random.default_rng(0)
    for hw in ((64, 64), (64, 128), (64, 64)):
        images = rng.integers(0, 256, (2, *hw, 3)).astype(np.uint8)
        targets = rng.integers(-1, 19, (2, *hw)).astype(np.int8)
        (pe, se), (pg, sg) = (f(params, model_state, images, targets) for f in (eager, graphed))
        assert pg.dtype == torch.uint8 and torch.equal(pe, pg)
        assert len(sg) == 4 and all(torch.equal(a, b) for a, b in zip(se, sg))
    assert len(stand_in_capture) == 2 and len(graphed.graphs) == 2 and graphed.replays == 3
    with pytest.raises(ValueError, match="not the tensors"):
        graphed(tree_map(torch.clone, params), model_state, images, targets)


def test_graph_true_eval_step_raises_on_the_cpu():
    model = init_fast_scnn(2, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        make_eval_step(model, 2, device="cpu", graph=True)


# --- the trainer and the evaluator on a synthetic Cityscapes tree ---------------------------


@pytest.fixture(scope="module")
def citys(tmp_path_factory):
    """4 train pairs at 64×128 and 3 val pairs (two at 64×128, one at 48×96,
    which pads into their bucket), labelIds of valid and ignored ids, each
    label a block function of its image."""
    root = tmp_path_factory.mktemp("citys")
    rng = np.random.default_rng(0)
    ids = np.array(_VALID + (0, 4))
    palette = rng.integers(0, 256, (len(ids), 3))
    for split, sizes in (("train", [(64, 128)] * 4), ("val", [(64, 128), (64, 128), (48, 96)])):
        for d in ("leftImg8bit", "gtFine"):
            (root / d / split / "c").mkdir(parents=True)
        for i, (h, w) in enumerate(sizes):
            cls = rng.integers(0, len(ids), (h // 16, w // 16)).repeat(16, 0).repeat(16, 1)
            img = np.clip(palette[cls] + rng.integers(-20, 21, (h, w, 3)), 0, 255)
            write_png(str(root / "leftImg8bit" / split / "c" / f"c_{i:06d}_leftImg8bit.png"),
                      img.astype(np.uint8))
            write_png(str(root / "gtFine" / split / "c" / f"c_{i:06d}_gtFine_labelIds.png"),
                      ids[cls].astype(np.uint8))
    return str(root)


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(decoded_cache, "_cache_dir", None)
    return tmp_path


def _flags(citys, *extra):
    return train.parse_args(["--device", "cpu", "--dataset", "citys", "--data-root", citys,
                             "--base-size", "64", "--crop-size", "48", "--batch-size", "2",
                             "--num-workers", "1", "--print-interval", "1", "--aux",
                             "--loss-type", "ce", "--stem-impl", "pallas", "--no-fp16",
                             "--device-aug", "--save-epoch", "1", "--save-folder", "S", *extra])


def _run(where, citys, graph, *extra, stop_after=None):
    """A ``Trainer`` run in its own directory; ``stop_after`` epochs: a run
    stopped there (its schedule still the whole run's). Returns the
    trainer, the saved train state and the epoch log."""
    os.makedirs(where, exist_ok=True)
    with contextlib.chdir(where):
        trainer = train.Trainer(_flags(citys, *extra), graph=graph)
        if stop_after is not None:
            trainer.args.epochs = stop_after
        trainer.train()
        saved = torch.load("S/train_state_citys.pt", weights_only=True)
        with open("logs/training_log_citys.json") as f:
            log = json.load(f)
    return trainer, saved, log


def _same_saved(a, b):
    ta = tree_leaves(a["params"]) + tree_leaves(a["model_state"])
    tb = tree_leaves(b["params"]) + tree_leaves(b["model_state"])
    assert len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))
    sa, sb = a["opt_state"]["state"], b["opt_state"]["state"]
    assert sa.keys() == sb.keys() and all(
        torch.equal(sa[i]["momentum_buffer"], sb[i]["momentum_buffer"]) for i in sa)
    assert a["step"] == b["step"]


def _scores(log):
    return [(r["epoch"], r["train_loss"], r["lr"], r.get("pix_acc"), r.get("miou")) for r in log]


@pytest.mark.parametrize("form", ["fused", "split-accum2"])
def test_graphed_trainer_equals_eager_and_resumes_exactly(citys, workdir, stand_in_capture,
                                                          capsys, form):
    """2 epochs with validation, eager and graphed: the saved state
    (masters, BN statistics, momentum, step), the epoch losses and the val
    pixAcc/mIoU bit-equal; one train capture (two for the split form), one
    eval capture. Then a graphed run stopped after epoch 1 and resumed with
    ``--auto-resume`` ends where the uninterrupted run did, bit for bit."""
    extra = ["--epochs", "2"] + (["--device-aug-split", "--grad-accum", "2"]
                                 if form == "split-accum2" else [])
    _, eager, eager_log = _run("eager", citys, False, *extra)
    trainer, graphed, graphed_log = _run("graphed", citys, True, *extra)
    out = capsys.readouterr().out
    _same_saved(eager, graphed)
    assert graphed["step"] == 4 and _scores(eager_log) == _scores(graphed_log)
    assert all(r["pix_acc"] is not None for r in graphed_log)
    assert len(trainer.train_step.graphs) == (2 if form == "split-accum2" else 1)
    assert trainer.train_step.replays == 4
    assert len(trainer.eval_step.graphs) == 1 and trainer.eval_step.replays == 2 * 3
    assert "train step 1 CUDA graph captures" in out or "train step 2 CUDA graph" in out

    _run("resumed", citys, True, *extra, stop_after=1)
    trainer, resumed, resumed_log = _run("resumed", citys, True, *extra, "--auto-resume")
    assert "resumed full train state from S/train_state_citys.pt (step 2)" in capsys.readouterr().out
    assert trainer.train_step.replays == 2
    _same_saved(graphed, resumed)
    assert _scores(resumed_log) == _scores(graphed_log)


def _eval_lines(out):
    return re.findall(r"^(?:sample \d+:|FINAL) pixAcc \S+ mIoU \S+$", out, re.M)


@pytest.mark.parametrize("batch", [1, 2])
def test_graphed_eval_main_equals_jax_eval_main(citys, workdir, stand_in_capture, capsys,
                                                monkeypatch, batch):
    """One ``.pth`` of JAX weights (``from_jax_params``), f32, testval: the
    graphed ``eval.main``'s per-sample lines and FINAL equal the JAX
    ``eval.main``'s, its dumps the eager port's byte for byte; at batch 2
    the third image is a partial batch, padded into the one bucket's
    capture."""
    jp, js = jax_init(jax.random.PRNGKey(5), 19, aux=True)
    torch.save(from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                               jax.tree_util.tree_map(np.asarray, js)), "w.pth")
    flags = ["--dataset", "citys", "--data-root", citys, "--weights", "w.pth", "--aux",
             "--batch-size", str(batch), "--mode", "testval"]
    with monkeypatch.context() as m:
        m.setattr(port_eval, "Evaluator", functools.partial(port_eval.Evaluator, graph=True))
        evaluator = port_eval.main(["--device", "cpu", "--outdir", "g", *flags])
    ours = capsys.readouterr().out
    port_eval.main(["--device", "cpu", "--outdir", "e", *flags])
    eager = capsys.readouterr().out
    jax_eval.main(["--outdir", "j", *flags])
    theirs = capsys.readouterr().out
    lines = _eval_lines(ours)
    assert len(lines) == 4 and lines == _eval_lines(theirs) == _eval_lines(eager)
    assert "eval step: 1 CUDA graph captures for 1 padded shapes" in ours
    assert len(stand_in_capture) == 1 and evaluator.eval_step.replays == -(-3 // batch)
    for i in range(3):
        with open(f"g/seg_{i}.png", "rb") as a, open(f"e/seg_{i}.png", "rb") as b:
            assert a.read() == b.read()


def test_graphed_study_train_model_equals_eager(stand_in_capture):
    """3 steps of the study's loop, its generator reseeded each step: the
    graphed step's weights, BN statistics and momentum equal the eager
    step's bit for bit, its one generator the one captured."""
    images, labels = study.gen_lane2_scenes(6, 48, 64, seed=7)
    runs = []
    for graph in (False, True):
        _, state, _ = study.train_model(2, images, labels, steps=3, batch=2, crop=None,
                                        loss_type="ce", lr=0.05, device="cpu", graph=graph)
        params = tree_leaves(state.params)
        runs.append(params + tree_leaves(state.model_state)
                    + [state.opt_state.state[p]["momentum_buffer"] for p in params])
    assert all(torch.equal(a, b) for a, b in zip(*runs)) and len(runs[0]) == len(runs[1])
    assert len(stand_in_capture) == 1 and len(stand_in_capture[0]) == 1

