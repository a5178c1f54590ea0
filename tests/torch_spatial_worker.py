"""One rank of ``tests/test_torch_spatial.py``'s 4-rank gloo group.

Run as ``python tests/torch_spatial_worker.py WORK`` in each process of
``parallel.multihost.run_local_group``. Every rank builds the spec's meshes
(a 2 × 2 mesh over the four ranks, a 1 × 2 mesh over ranks 0 and 1 and a
1 × 4 mesh, every group made by every rank), runs each case on the meshes
it is a member of, on its block of the inputs the test wrote under
``WORK``, and writes ``WORK/rank<k>/*.npz`` and ``*.json``. It imports the
port and torch only (no JAX), one torch thread.
"""

from __future__ import annotations

import json
import os
import sys
import warnings

import numpy as np
import torch

from fastscnn_tpu_torch.losses import get_loss_fn
from fastscnn_tpu_torch.models import FastSCNN, to_param_trees
from fastscnn_tpu_torch.parallel import (
    create_train_state,
    make_eval_step,
    make_mesh,
    make_optimizer,
    make_train_step,
)
from fastscnn_tpu_torch.parallel.mesh import host_block
from fastscnn_tpu_torch.parallel.multihost import initialize_multihost, process_index
from fastscnn_tpu_torch.ops.halo import gather_rows_h, halo_rows, space_rows
from fastscnn_tpu_torch.parallel.spatial import GroupTransport, Space
from fastscnn_tpu_torch.utils import lr_schedule
from fastscnn_tpu_torch.utils.tree import tree_leaves

MESHES = {"2x2": (2, 2), "1x2": (1, 2), "1x4": (1, 4)}
# (above, below) halos of the exchange cases
HALOS = ((1, 1), (2, 0), (0, 1), (3, 2))
# unequal blocks of the exchange cases' 16 rows, by the size of the space
# axis: blocks thinner than the halos, and an empty one
UNEVEN = {2: ((0, 1), (1, 16)), 4: ((0, 3), (3, 3), (3, 4), (4, 16))}


def flat(tree) -> np.ndarray:
    return np.concatenate([t.detach().numpy().ravel() for t in tree_leaves(tree)])


def model_of(work, name, **options):
    sd = torch.load(os.path.join(work, f"init_{name}.pt"))
    nc = sd["classifier.conv.1.weight"].shape[0]
    model = FastSCNN(nc, aux=True, **options)
    model.load_state_dict(sd)
    return model, nc


def exchange_case(space, x, weights):
    """``halo_rows`` for each of :data:`HALOS` and ``gather_rows_h`` on
    this rank's block ``x`` (f64): each output, and the gradient of
    ``sum(output * weight)`` on the block (``weights``: one a case, shaped
    as this rank's output). Shared with the test, which runs it over the
    local transport and computes the whole-tensor reference."""
    out = {}
    for k, (above, below) in enumerate(HALOS):
        xb = x.clone().requires_grad_()
        y = halo_rows(xb, above, below, space)
        (y * weights[k]).sum().backward()
        out[f"halo{k}"], out[f"halo{k}_grad"] = y.detach().numpy(), xb.grad.numpy()
    xb = x.clone().requires_grad_()
    y = gather_rows_h(xb, space)
    (y * weights[len(HALOS)]).sum().backward()
    out["gather"], out["gather_grad"] = y.detach().numpy(), xb.grad.numpy()
    return out


def exchange_weights(seed, shape, n, index, height=None):
    """The weights of :func:`exchange_case` for rank ``index`` of ``n``, on
    blocks of ``shape`` (of a tensor of ``height`` rows; default: ``n``
    equal blocks)."""
    rng = np.random.default_rng(seed + index)
    ws = [rng.normal(size=(shape[0], shape[1] + a + b, *shape[2:])) for a, b in HALOS]
    ws.append(rng.normal(size=(shape[0], height or shape[1] * n, *shape[2:])))
    return [torch.from_numpy(w) for w in ws]


def exchange_cases(spec, meshes, out):
    whole = torch.from_numpy(np.load(os.path.join(spec["work"], "exchange.npz"))["x"])
    for name in ("1x4", "2x2"):
        mesh = meshes[name]
        n = mesh.shape["space"]
        for tag, rows in (("", None), ("_uneven", UNEVEN[n])):
            rows = rows or space_rows(n, whole.shape[1])
            space = Space(GroupTransport(mesh.space_group), mesh.space_index, n, rows=rows)
            a, b = rows[mesh.space_index]
            x = whole[:, a:b]
            got = exchange_case(space, x, exchange_weights(spec["exchange_seed"], x.shape, n,
                                                           mesh.space_index, whole.shape[1]))
            np.savez(os.path.join(out, f"exchange_{name}{tag}.npz"), **got)


def train_cases(work, spec, meshes, out):
    for case in spec["train"]:
        mesh = meshes[case["mesh"]]
        if not mesh.is_member:
            continue
        model, nc = model_of(work, "a", stem_impl=case["stem"],
                             dropout_rate=0.1 if case["dropout"] else 0.0)
        batch = np.load(os.path.join(work, case["batch"]))
        images, targets = host_block(mesh, batch["images"], batch["targets"],
                                     spatial=case["spatial"])
        opt = make_optimizer("sgd", lr_schedule("poly", base_lr=1e-2, niters=10))
        state = create_train_state(model, opt, device="cpu")
        step = make_train_step(model, get_loss_fn("ce", aux=True, num_classes=nc), opt,
                               mesh=mesh, compute_dtype=getattr(torch, case["dtype"]),
                               spatial_shard=case["spatial"], grad_accum=case["grad_accum"],
                               device="cpu")
        gen = torch.Generator().manual_seed(5) if case["dropout"] else None
        state, metrics = step(state, images, targets, gen)
        ppm = state.model_state["global_feature_extractor"]["ppm"]
        np.savez(os.path.join(out, f"train_{case['name']}.npz"), loss=float(metrics["loss"]),
                 params=flat(state.params), bn=flat(state.model_state),
                 ppm_var=flat([ppm[f"conv{i}"]["bn"]["var"] for i in range(1, 5)]))


def eval_cases(work, spec, meshes, out):
    model, nc = model_of(work, "a")
    params, state = to_param_trees(model)
    batch = np.load(os.path.join(work, "eval.npz"))
    for name in ("2x2", "1x2"):
        mesh = meshes[name]
        if not mesh.is_member:
            continue
        images, targets = host_block(mesh, batch["images"], batch["targets"], spatial=False)
        step = make_eval_step(model, nc, mesh=mesh, compute_dtype=torch.float32, device="cpu")
        pred, stats = step(params, state, images, targets)
        np.savez(os.path.join(out, f"eval_{name}.npz"), pred=pred.numpy(),
                 **{k: s.numpy() for k, s in zip(("correct", "labeled", "inter", "union"),
                                                  stats)})


def refusals(work, meshes, out):
    model, nc = model_of(work, "a")
    opt = make_optimizer("sgd", 0.01)
    loss = get_loss_fn("ce", aux=True, num_classes=nc)
    said = {}
    mesh = meshes["2x2"]
    step = make_train_step(model, loss, opt, mesh=mesh, spatial_shard=True, device="cpu")
    state = create_train_state(model, opt, device="cpu")
    # H = 45 over the space axis of 2: blocks of 23 and 22 rows
    h = 23 - mesh.space_index
    try:
        step(state, np.zeros((1, h, 32, 3), np.uint8), np.zeros((1, h, 32), np.int32))
        said["height"] = None
    except ValueError as e:
        said["height"] = str(e)
    # H = 96: not a multiple of 32 · 2, and taken
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, 96, 32, 3)).astype(np.uint8)
    targets = rng.integers(-1, nc, (2, 96, 32)).astype(np.int32)
    _, metrics = step(state, *host_block(mesh, images, targets))
    said["h96_loss"] = float(metrics["loss"])
    try:
        make_train_step(model, loss, opt, mesh=meshes["1x2"], spatial_shard=True, device="cpu")
        said["left_out"] = None
    except ValueError as e:
        said["left_out"] = str(e)
    with open(os.path.join(out, "refusals.json"), "w") as f:
        json.dump(said, f)


def main(work: str) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    spec["work"] = work
    assert initialize_multihost(device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the 1 × 2 mesh uses 2 of the 4 ranks
        meshes = {k: make_mesh(n_data=nd, n_space=ns) for k, (nd, ns) in MESHES.items()}
    out = os.path.join(work, f"rank{process_index()}")
    os.makedirs(out, exist_ok=True)
    exchange_cases(spec, meshes, out)
    train_cases(work, spec, meshes, out)
    eval_cases(work, spec, meshes, out)
    refusals(work, meshes, out)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
