"""One rank of ``tests/test_torch_multidevice.py``'s 2-rank gloo group.

Run as ``python tests/torch_multidevice_worker.py WORK`` in each process
of ``parallel.multihost.run_local_group`` (which sets the coordinator's
variables). It reads the inputs the test wrote under ``WORK`` (``spec.json``,
``init_*.pt`` weights, ``*.npz`` batches), runs every data-parallel case on
this rank's rows and writes ``WORK/rank<k>/*.npz`` and ``*.json``. It
imports the port and torch only (no JAX), one torch thread.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from fastscnn_tpu_torch.data import device_aug
from fastscnn_tpu_torch.losses import get_loss_fn
from fastscnn_tpu_torch.losses import segmentation as seg
from fastscnn_tpu_torch.models import FastSCNN
from fastscnn_tpu_torch.parallel import (
    create_train_state,
    make_eval_step,
    make_mesh,
    make_mesh_for_batch,
    make_optimizer,
    make_split_aug_train_step,
    make_train_step,
)
from fastscnn_tpu_torch.parallel.multihost import host_shard, initialize_multihost, process_index
from fastscnn_tpu_torch.utils import lr_schedule
from fastscnn_tpu_torch.utils.tree import tree_leaves


def flat(tree) -> np.ndarray:
    return np.concatenate([t.detach().numpy().ravel() for t in tree_leaves(tree)])


def model_of(work, name, **options):
    sd = torch.load(os.path.join(work, f"init_{name}.pt"))
    nc = sd["classifier.conv.1.weight"].shape[0]
    model = FastSCNN(nc, aux=True, dropout_rate=0.0, **options)
    model.load_state_dict(sd)
    return model, nc


def train_cases(work, spec, mesh, out):
    for case in spec["train"]:
        model, nc = model_of(work, case["init"], stem_impl=case["stem"])
        batch = np.load(os.path.join(work, case["batch"]))
        images, targets = host_shard(batch["images"], batch["targets"])
        opt = make_optimizer("sgd", lr_schedule("poly", base_lr=1e-2, niters=10))
        state = create_train_state(model, opt, device="cpu")
        step = make_train_step(model, get_loss_fn("ce", aux=True, num_classes=nc), opt,
                               mesh=mesh, compute_dtype=getattr(torch, case["dtype"]),
                               grad_accum=case["grad_accum"], device="cpu")
        state, metrics = step(state, images, targets)
        np.savez(os.path.join(out, f"train_{case['name']}.npz"), loss=float(metrics["loss"]),
                 params=flat(state.params), bn=flat(state.model_state))


def loss_cases(spec, group, out):
    """Every loss of ``losses/`` on this rank's rows of seeded global
    logits, with the group."""
    rng = np.random.default_rng(spec["loss_seed"])
    n, h, w, c = spec["loss_shape"]
    logits = torch.from_numpy(rng.normal(size=(n, h // 4, w // 4, c)).astype(np.float32))
    binary = torch.from_numpy(rng.normal(size=(n, h // 4, w // 4, 2)).astype(np.float32))
    target = torch.from_numpy(rng.integers(-1, c, (n, h, w)).astype(np.int32))
    target01 = torch.from_numpy(rng.integers(0, 2, (n, h, w)).astype(np.int32))
    mine = torch.as_tensor(host_shard(np.arange(n)))
    values = {}
    for name, fn, lg, tg in seg_cases(logits, binary, target, target01):
        lg_local = lg[mine].clone().requires_grad_()
        loss = fn(lg_local, tg[mine], group=group)
        loss.backward()
        values[name] = (float(loss.detach()).hex(), lg_local.grad.numpy())
    np.savez(os.path.join(out, "losses.npz"), **{k: v[1] for k, v in values.items()})
    with open(os.path.join(out, "losses.json"), "w") as f:
        json.dump({k: v[0] for k, v in values.items()}, f)


def seg_cases(logits, binary, target, target01):
    """(name, loss(logits, target, group=...), logits, target) — shared with
    the test, which computes each on the global batch in one process."""
    return [
        ("ce", lambda lg, t, group=None: seg.cross_entropy_loss(lg, t, group=group),
         logits, target),
        ("ce_weighted", lambda lg, t, group=None: seg.cross_entropy_loss(
            lg, t, class_weights=(0.5, 1.0, 1.5, 2.0, 0.75), group=group), logits, target),
        ("ohem", lambda lg, t, group=None: seg.ohem_cross_entropy_loss(
            lg, t, min_kept=300, thresh=0.2, group=group), logits, target),
        ("dice", lambda lg, t, group=None: seg.dice_loss(lg, t, group=group), binary, target01),
        ("dice_multi", lambda lg, t, group=None: seg.dice_loss(lg, t, group=group), logits,
         target01),
        ("focal_dice", lambda lg, t, group=None: seg.focal_dice_loss(lg, t, group=group),
         binary, target01),
        ("focal_dice_multi", lambda lg, t, group=None: seg.focal_dice_loss(lg, t, group=group),
         logits, target01),
        ("mix_ohem", lambda lg, t, group=None: seg.mix_ohem_cross_entropy_loss(
            (lg, lg * 0.5), t, min_kept=300, group=group), logits, target),
    ]


def aug_cases(work, spec, mesh, out):
    """Each chain's crops of this rank's rows (parameters of the global
    batch), and a device-aug train step (``grad_accum=2``)."""
    batch = np.load(os.path.join(work, spec["aug_batch"]))
    images = torch.from_numpy(host_shard(batch["images"]))
    masks = torch.from_numpy(host_shard(batch["targets"]))
    shard = (mesh.index, mesh.size)
    crops = {}
    for name, aug in chains(spec).items():
        img, mask = aug(images, masks, torch.Generator().manual_seed(7), shard=shard)
        crops[f"{name}_img"], crops[f"{name}_mask"] = img.numpy(), mask.numpy()
    np.savez(os.path.join(out, "aug.npz"), **crops)
    model, nc = model_of(work, spec["aug_init"])
    opt = make_optimizer("sgd", lr_schedule("poly", base_lr=1e-2, niters=10))
    for split in (False, True):
        for dtype in ("float32", "float64"):
            state = create_train_state(model, opt, device="cpu")
            kwargs = dict(mesh=mesh, compute_dtype=getattr(torch, dtype), grad_accum=2,
                          device="cpu")
            loss_fn = get_loss_fn("ce", aux=True, num_classes=nc)
            psp = chains(spec)["psp"]
            step = (make_split_aug_train_step(model, loss_fn, opt, psp, **kwargs) if split
                    else make_train_step(model, loss_fn, opt, device_aug=psp, **kwargs))
            state, metrics = step(state, images, masks, None, torch.Generator().manual_seed(11))
            np.savez(os.path.join(out, f"aug_step_{int(split)}_{dtype}.npz"),
                     loss=float(metrics["loss"]), params=flat(state.params))


def chains(spec):
    base, crop = spec["aug_base"], spec["aug_crop"]
    return {
        "psp": device_aug.make_device_augment(base_size=base, crop_size=crop, pad_label=-1,
                                              compute_dtype=torch.float32),
        "custom": device_aug.make_device_augment_custom(crop_size=crop, multi_scale=True,
                                                        compute_dtype=torch.float32),
        "original": device_aug.make_device_augment_original(compute_dtype=torch.float32),
    }


def eval_cases(work, spec, mesh, out):
    model, nc = model_of(work, spec["eval_init"])
    batch = np.load(os.path.join(work, spec["eval_batch"]))
    images, targets = host_shard(batch["images"], batch["targets"])
    from fastscnn_tpu_torch.models import to_param_trees

    params, state = to_param_trees(model)
    result = {}
    for per_sample in (False, True):
        step = make_eval_step(model, nc, mesh=mesh, compute_dtype=torch.float32, device="cpu",
                              per_sample_stats=per_sample)
        pred, stats = step(params, state, images, targets)
        result[f"pred_{int(per_sample)}"] = pred.numpy()
        for name, s in zip(("correct", "labeled", "inter", "union"), stats):
            result[f"{name}_{int(per_sample)}"] = s.numpy()
    np.savez(os.path.join(out, "eval.npz"), **result)


def refusals(work, spec, mesh, out):
    model, nc = model_of(work, spec["eval_init"])
    opt = make_optimizer("sgd", 0.01)
    loss = get_loss_fn("ce", aux=True, num_classes=nc)
    said = {}
    for name, build in (
            ("graph_gloo", lambda: make_train_step(model, loss, opt, mesh=mesh, graph=True,
                                                   device="cpu")),
            ("eval_graph_gloo", lambda: make_eval_step(model, nc, mesh=mesh, graph=True,
                                                       device="cpu"))):
        try:
            build()
            said[name] = None
        except ValueError as e:
            said[name] = str(e)
    odd = make_mesh_for_batch(3)  # 3 rows divide over 1 rank: rank 1 is left out
    said["odd_mesh"] = [odd.shape["data"], odd.index]
    try:
        make_train_step(model, loss, opt, mesh=odd, device="cpu")
        said["left_out"] = None
    except ValueError as e:
        said["left_out"] = str(e)
    with open(os.path.join(out, "refusals.json"), "w") as f:
        json.dump(said, f)


def trainer_case(work, spec, out):
    """``train.main`` of the spec's flags in this rank's own directory
    (``logs/`` lands there), the checkpoints in the shared save folder."""
    from fastscnn_tpu_torch import train

    os.chdir(out)
    trainer = train.main(spec["trainer_argv"])
    with open(os.path.join(out, "trainer.json"), "w") as f:
        json.dump({"step": trainer.state.step, "mesh": dict(trainer.mesh.shape),
                   "shard": trainer.train_loader.shard,
                   "params": float(flat(trainer.state.params).sum()).hex()}, f)


def main(work: str) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    assert initialize_multihost(device="cpu")
    mesh = make_mesh()
    out = os.path.join(work, f"rank{process_index()}")
    os.makedirs(out, exist_ok=True)
    train_cases(work, spec, mesh, out)
    loss_cases(spec, mesh.group, out)
    aug_cases(work, spec, mesh, out)
    eval_cases(work, spec, mesh, out)
    refusals(work, spec, mesh, out)
    if spec.get("trainer_argv"):
        trainer_case(work, spec, out)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
