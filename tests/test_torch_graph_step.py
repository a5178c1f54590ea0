"""What a CUDA graph of the port's train step needs, checked where no card
is (``fastscnn_tpu_torch/parallel/train.py``):

- the eager step keeps every tensor of the state where it is: after 3
  steps the masters, their gradient buffers, the BN statistics and the
  optimizer's state (made at the first step) have the storage they had,
  for SGD and AdamW, ``grad_accum`` 1 and 2, with and without the PSP
  chain; and from the second step on the step makes no host tensor but
  its input batch (``_Normalize``'s constants and the class weights are
  copied to the device once);
- ``graph=True`` raises on the CPU;
- the graphed step's own logic (warm-up steps undone, generators put
  back, the batch copied into fixed inputs, the refusals) against the
  eager step, bit for bit, with the capture replaced by a stand-in that
  records the body and replays it eagerly (the real capture runs only on
  the card, in ``chip_smoke.py`` phase 8);
- ``holding_tables`` collects the device tables a capture reads.

There is no JAX counterpart for any of this (JAX's state is immutable and
its ``jit`` has no capture): the step against the JAX step is
``test_torch_train_step.py``'s and ``test_torch_device_aug.py``'s.
"""

import contextlib
import sys

import numpy as np
import pytest
import torch

from fastscnn_tpu_torch.data import device_aug
from fastscnn_tpu_torch.losses import get_loss_fn
from fastscnn_tpu_torch.models import init_fast_scnn
from fastscnn_tpu_torch.ops import resize
from fastscnn_tpu_torch.parallel import (
    create_train_state,
    make_optimizer,
    make_split_aug_train_step,
    make_train_step,
)
from fastscnn_tpu_torch.parallel import train as train_mod
from fastscnn_tpu_torch.utils import lr_schedule
from fastscnn_tpu_torch.utils.cuda_graph import Captured
from fastscnn_tpu_torch.utils.tree import tree_leaves, tree_map

NUM_CLASSES = 19
N, SIZE, SRC = 2, 64, (64, 128)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed, hw=(SIZE, SIZE), label_dtype=np.int32):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (N, *hw, 3)).astype(np.uint8)
    targets = rng.integers(-1, NUM_CLASSES, (N, *hw)).astype(label_dtype)
    return images, targets


def _setup(opt_name="sgd", aug=False, split=False, grad_accum=1, fused=False, graph=False):
    model = init_fast_scnn(NUM_CLASSES, aux=True, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    opt = make_optimizer(opt_name, lr_schedule("poly", base_lr=1e-2, niters=10))
    state = create_train_state(model, opt, device="cpu")
    if fused:  # the update the card's optimizer runs (fused SGD), here on the CPU
        for group in state.opt_state.param_groups:
            group["fused"] = True
    chain = (device_aug.make_device_augment(base_size=SRC[0], crop_size=SIZE, pad_label=-1,
                                            compute_dtype=torch.float32) if aug else None)
    loss = get_loss_fn("ce", aux=True, num_classes=NUM_CLASSES)
    kw = dict(compute_dtype=torch.float32, grad_accum=grad_accum, device="cpu", graph=graph)
    if split:
        step = make_split_aug_train_step(model, loss, opt, chain, **kw)
    else:
        step = make_train_step(model, loss, opt, device_aug=chain, **kw)
    return model, opt, state, step


def _tensors(state):
    params = tree_leaves(state.params)
    opt_state = [v for p in params for _, v in sorted(state.opt_state.state[p].items())
                 if isinstance(v, torch.Tensor)]
    return (params + [p.grad for p in params] + tree_leaves(state.model_state) + opt_state)


@pytest.mark.parametrize("aug", [False, True], ids=["crops", "psp"])
@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_eager_steps_keep_the_state_storage_and_make_no_host_tensor(opt_name, grad_accum, aug,
                                                                    monkeypatch):
    _, _, state, step = _setup(opt_name, aug=aug, grad_accum=grad_accum)
    images, targets = _batch(1, SRC if aug else (SIZE, SIZE), np.int8 if aug else np.int32)
    gen = torch.Generator().manual_seed(5)
    assert all(p.grad is None for p in tree_leaves(state.params))
    state, _ = step(state, images, targets, gen, gen)
    storage = [t.untyped_storage().data_ptr() for t in _tensors(state)]
    assert len(storage) == len(set(storage))  # one buffer each
    n_state = len(tree_leaves(state.params)) * (2 + (1 if opt_name == "sgd" else 3))
    assert len(storage) == n_state + len(tree_leaves(state.model_state))

    made = []
    for name in ("tensor", "as_tensor", "from_numpy"):
        real = getattr(torch, name)

        def counting(*args, _real=real, **kwargs):
            caller = sys._getframe(1).f_code
            made.append((caller.co_filename.replace("\\", "/").split("/")[-2:], caller.co_name))
            return _real(*args, **kwargs)

        monkeypatch.setattr(torch, name, counting)
    for _ in range(2):
        state, metrics = step(state, images, targets, gen, gen)
    monkeypatch.undo()
    assert [t.untyped_storage().data_ptr() for t in _tensors(state)] == storage
    assert np.isfinite(float(metrics["loss"])) and state.step == 3
    # the input batch (images, targets) of each step and nothing else
    assert made == [(["parallel", "train.py"], "step")] * 4


def test_graph_true_raises_on_the_cpu():
    model = init_fast_scnn(2, aux=True, generator=torch.Generator().manual_seed(0), device="cpu")
    opt = make_optimizer("sgd", 1e-2)
    loss = get_loss_fn("dice", aux=True, num_classes=2)
    chain = device_aug.make_device_augment(base_size=64, crop_size=48, pad_label=-1)
    with pytest.raises(ValueError, match="CUDA device"):
        make_train_step(model, loss, opt, device="cpu", graph=True)
    with pytest.raises(ValueError, match="CUDA device"):
        make_split_aug_train_step(model, loss, opt, chain, device="cpu", graph=True)


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
        new = self.body()
        for dst, src in zip(self._flat(self.out), self._flat(new)):
            dst.copy_(src)

    @staticmethod
    def _flat(out):
        return list(out) if isinstance(out, tuple) else [out]


@pytest.fixture
def stand_in_capture(monkeypatch):
    """``_GraphedStep`` on the CPU: streams and pools that do nothing, and
    the capture replaced by :class:`_Replayed` (its pass runs the body
    once, as a capture records it once; the step undoes its effects as it
    undoes the warm-up's)."""
    captures = []

    def fake_capture(body, device, pool, stream, generators=()):
        captures.append([g for g in generators])
        out = body()
        return Captured(_Replayed(body, out), out, {}, 0, [])

    monkeypatch.setattr(train_mod, "capture", fake_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(train_mod, "_step_device", lambda device, graph: CPU)
    return captures


@pytest.mark.parametrize("form", ["crops", "psp-fused-accum2", "psp-split"])
def test_graphed_steps_equal_eager_steps_bit_for_bit(form, stand_in_capture):
    aug, split, accum = {"crops": (False, False, 1), "psp-fused-accum2": (True, False, 2),
                         "psp-split": (True, True, 1)}[form]
    runs = []
    for graphed in (False, True):
        _, _, state, step = _setup(aug=aug, split=split, grad_accum=accum, fused=True,
                                   graph=graphed)
        gen, aug_gen = torch.Generator().manual_seed(7), torch.Generator().manual_seed(8)
        losses = []
        for i in range(3):
            images, targets = _batch(10 + i, SRC if aug else (SIZE, SIZE))
            state, metrics = step(state, images, targets, gen, aug_gen if aug else None)
            losses.append(metrics["loss"])
        assert state.step == 3
        runs.append((losses, _tensors(state), gen.get_state(), aug_gen.get_state()))
    (l0, t0, g0, a0), (l1, t1, g1, a1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))  # each loss its own copy
    assert len(t0) == len(t1) and all(torch.equal(a, b) for a, b in zip(t0, t1))
    assert torch.equal(g0, g1) and torch.equal(a0, a1)
    assert len(stand_in_capture) == (2 if split else 1)  # one shape: captured once


def test_graphed_step_refuses_another_state_or_generator(stand_in_capture):
    _, opt, state, step = _setup(fused=True, graph=True)
    gen = torch.Generator().manual_seed(1)
    images, targets = _batch(3)
    state, _ = step(state, images, targets, gen)
    with pytest.raises(ValueError, match="generator"):
        step(state, images, targets, torch.Generator().manual_seed(1))
    state.model_state = tree_map(torch.clone, state.model_state)  # a load that rebinds
    with pytest.raises(ValueError, match="not the ones"):
        step(state, images, targets, gen)
    other = create_train_state(init_fast_scnn(NUM_CLASSES, aux=True,
                                              generator=torch.Generator().manual_seed(0),
                                              device="cpu"), opt, device="cpu")
    with pytest.raises(ValueError, match="optimizer"):
        step(other, images, targets, gen)
    assert len(stand_in_capture) == 1


def test_holding_tables_collects_the_tables_a_block_reads():
    cpu = torch.device("cpu")
    outer, inner = [], []
    resize.interp_matrix(5, 9, True, torch.float32, cpu)
    with resize.holding_tables(outer):
        a = resize.interp_matrix(5, 9, True, torch.float32, cpu)  # cached: no build
        with resize.holding_tables(inner):
            b = resize.nearest_index(4, 7, cpu)
    resize.lerp_tables(3, 6, False, cpu)
    assert [t is a for t in outer] == [True, False] and outer[1] is b
    assert len(inner) == 1 and inner[0] is b
    assert resize.interp_matrix.cache_info().hits >= 1
