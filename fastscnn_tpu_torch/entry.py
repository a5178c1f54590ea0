"""``entry()``: the port's single-card serving step on the flagship model;
``dryrun_multichip(n)``: the data-parallel surface over n processes.

The analogue of the repo root's ``__graft_entry__.entry()``: the 19-class
Fast-SCNN (Cityscapes), random weights from a fixed seed, the bf16
end-to-end graph uint8 → normalise → network → argmax mask — here in the
kernel configuration, ``folded_dw_impl='fused-ds'`` (kernel B3) and
``final_upsample='pallas'`` (kernel B1).

:func:`dryrun_multichip` is the counterpart of the root's
``dryrun_multichip``, on the ``data`` axis: the JAX function runs its legs
in one controller over n virtual devices; here n processes, one a device
(``parallel/multihost.py``), run them SPMD and the caller compares what
they wrote. On a machine with fewer cards than processes they share a card
over gloo.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch

from fastscnn_tpu_torch import resolve_device
from fastscnn_tpu_torch.engine import IMAGENET_MEAN, IMAGENET_STD, E2EConfig, InferenceEngine
from fastscnn_tpu_torch.models import init_fast_scnn

__all__ = ["entry", "dryrun_multichip", "NUM_CLASSES", "SHAPE"]

NUM_CLASSES = 19
SHAPE = (1, 1024, 2048, 3)


def entry(device=None):
    """Returns ``(fn, (example,))``: ``fn`` maps a (1, 1024, 2048, 3)
    uint8 tensor on ``device`` (None: the CUDA card) to its (1, 1024,
    2048) int32 mask; ``example`` is such a tensor of zeros."""
    device = resolve_device(device)
    model = init_fast_scnn(
        NUM_CLASSES, generator=torch.Generator().manual_seed(0), device=device,
        folded_dw_impl="fused-ds",
    )
    engine = InferenceEngine(
        model, device=device,
        config=E2EConfig(mean=IMAGENET_MEAN, std=IMAGENET_STD, compute_dtype="bfloat16",
                         final_upsample="pallas"),
    )
    return engine.predict, (torch.zeros(SHAPE, dtype=torch.uint8, device=device),)


DRYRUN_DEADLINE_S = 600.0  # each spawned group of dryrun_multichip, killed past it


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The JAX ``dryrun_multichip``'s data-axis legs, in ``n_devices``
    processes on ``device`` (None: the CUDA card(s), raising without one;
    ranks share a card over gloo when there are fewer cards than ranks):

    - the dp train step: 19 classes, aux, OHEM CE (sync-BN, the global
      k-th smallest), ``grad_accum=2``, a global batch of 2n at 64x64;
    - the eval step under the mesh: the statistics equal to one process's
      over the global batch and each rank's mask equal to one process's of
      its rows (one process steps the global batch a shard at a time, so
      that every convolution has the shapes of the sharded run: a card's
      libraries may pick another algorithm for another batch size);
    - sharded serving: ``InferenceEngine`` under a local mesh of n replicas
      equal on every pixel to the single engine on each shard, also with
      B3 (``folded_dw_impl='fused-ds'``) under the data mesh;
    - device augmentation under the mesh (``grad_accum=2``, native 64x128);
    - a checkpoint saved by the primary and loaded by every rank: the
      restored state equal leaf for leaf and its next step's loss equal to
      the uninterrupted state's, bit for bit;
    - a ``space`` axis (dp×sp): with an even n, the spatial train step
      (``spatial_shard=True``, ``grad_accum=2``) under an (n/2 × 2) mesh,
      each rank its block of a 72x64 global batch (levels of 35, 18, 9,
      5 and 3 rows, which split unevenly), its loss equal across the
      ranks.

    Then, unless ``FASTSCNN_DRYRUN_MULTIPROC=0``, the 2-process stage:
    ``tools/multihost_smoke.py`` in 2 processes, their loss histories
    bit-equal. Every spawned group has :data:`DRYRUN_DEADLINE_S` and is
    killed on any exit. Raises on any failure; returns the ranks' results."""
    from fastscnn_tpu_torch import resolve_device
    from fastscnn_tpu_torch.parallel.multihost import backend_for, run_local_group

    device = resolve_device(device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = "gloo" if cards < n_devices else backend_for(device)
    with tempfile.TemporaryDirectory() as work:
        run_local_group(
            lambda k: ["-m", "fastscnn_tpu_torch.entry", "--dryrun-rank", "--device",
                       str(device), "--backend", backend, "--workdir", work],
            n_devices, DRYRUN_DEADLINE_S)
        ranks = []
        for k in range(n_devices):
            with open(os.path.join(work, f"rank{k}.json")) as f:
                ranks.append(json.load(f))
    first = ranks[0]
    for r in ranks[1:]:
        for key in ("train_loss", "aug_loss", "resumed_loss", "stats", "params", "space_loss"):
            if r[key] != first[key]:
                raise AssertionError(f"dryrun_multichip: rank {r['rank']}'s {key} differs from "
                                     f"rank 0's: {r[key]} vs {first[key]}")
    print(f"dryrun_multichip(n={n_devices}): {backend} on {device}, losses and params bit-equal "
          f"across the ranks (train {first['train_loss']}, device-aug {first['aug_loss']})")
    stage = "2-process stage disabled via FASTSCNN_DRYRUN_MULTIPROC=0"
    if os.environ.get("FASTSCNN_DRYRUN_MULTIPROC", "1") != "0":
        _two_process_stage(device, backend, DRYRUN_DEADLINE_S)
        stage = "real 2-process run"
    print(f"dryrun_multichip(n={n_devices}): surfaces exercised = [dp train step (sync-BN, "
          "OHEM-CE, grad-accum=2), eval statistics (== one process), sharded serve (== one "
          "engine), B3 serve under the data mesh, device-aug train under dp, checkpoint "
          f"save/resume under the mesh, dp×sp spatial train step, {stage}]")
    return {"ranks": ranks, "backend": backend}


def _two_process_stage(device, backend: str, deadline_s: float) -> list:
    """``tools/multihost_smoke.py`` in 2 processes: both see the world, and
    their loss histories and param fingerprints agree bit for bit. Returns
    their results."""
    from fastscnn_tpu_torch.parallel.multihost import run_local_group

    with tempfile.TemporaryDirectory() as work:
        run_local_group(
            lambda k: ["-m", "fastscnn_tpu_torch.tools.multihost_smoke", "--platform",
                       str(device), "--backend", backend, "--steps", "4", "--batch", "8",
                       "--size", "32", "--out", os.path.join(work, f"p{k}.json")],
            2, deadline_s)
        results = []
        for k in range(2):
            with open(os.path.join(work, f"p{k}.json")) as f:
                results.append(json.load(f))
    if results[0]["losses"] != results[1]["losses"]:
        raise AssertionError(f"2-process loss histories diverge: {results}")
    if results[0]["param_fingerprint"] != results[1]["param_fingerprint"]:
        raise AssertionError(f"2-process params diverge: {results}")
    if not all(r["process_count"] == 2 and r["final_step"] == 4 for r in results):
        raise AssertionError(f"2-process run incomplete: {results}")
    print(f"dryrun_multichip: real 2-process run ok (losses bit-equal across the processes: "
          f"{results[0]['losses']})")
    return results


def _dryrun_rank(device: str, backend: str, work: str) -> None:
    """One rank of :func:`dryrun_multichip` (its legs); writes
    ``rank<k>.json`` under ``work``."""
    import torch.distributed as dist

    from fastscnn_tpu_torch.data.device_aug import make_device_augment
    from fastscnn_tpu_torch.engine import E2EConfig
    from fastscnn_tpu_torch.losses import get_loss_fn
    from fastscnn_tpu_torch.models import FastSCNN, from_jax_params
    from fastscnn_tpu_torch.parallel import (
        create_train_state,
        make_eval_step,
        make_mesh,
        make_optimizer,
        make_train_step,
    )
    from fastscnn_tpu_torch.parallel.multihost import (
        host_shard,
        initialize_multihost,
        process_count,
        process_index,
    )
    from fastscnn_tpu_torch.parallel.mesh import host_block
    from fastscnn_tpu_torch.utils import lr_schedule
    from fastscnn_tpu_torch.utils.checkpoint import load_train_state, save_train_state
    from fastscnn_tpu_torch.utils.tree import tree_leaves

    dev = torch.device(device)
    if not initialize_multihost(device=dev, backend=backend):
        raise RuntimeError("a dryrun rank runs in a process group")
    n, rank = process_count(), process_index()
    mesh = make_mesh()

    def model_of(seed):
        return init_fast_scnn(NUM_CLASSES, aux=True,
                              generator=torch.Generator().manual_seed(seed), device=dev)

    def hexes(t):
        return [float(v).hex() for v in torch.as_tensor(t).reshape(-1).tolist()]

    model = model_of(0)
    optimizer = make_optimizer("sgd", lr_schedule("poly", base_lr=1e-2, niters=100, power=0.9))
    state = create_train_state(model, optimizer, device=dev)
    loss_fn = get_loss_fn("ce", aux=True, num_classes=NUM_CLASSES)
    step = make_train_step(model, loss_fn, optimizer, mesh=mesh, grad_accum=2, device=dev)
    batch, h, w = 2 * n, 64, 64
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    targets = rng.integers(-1, NUM_CLASSES, (batch, h, w)).astype(np.int32)
    mine = host_shard(np.arange(batch))

    def generator(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    state, metrics = step(state, images[mine], targets[mine], generator(1))
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    assert state.step == 1
    print(f"[rank {rank}] dp train step (mesh {mesh.shape}): loss {loss:.4f}", flush=True)

    # the space axis: H over pairs of ranks, the batch over the pairs, at an
    # H whose levels split unevenly (72: 35, 18, 9, 5 and 3 rows)
    space_loss = None
    if n % 2 == 0:
        sp_mesh = make_mesh(n_data=n // 2, n_space=2)
        sp_state = create_train_state(model, optimizer, device=dev)
        sp_step = make_train_step(model, loss_fn, optimizer, mesh=sp_mesh, spatial_shard=True,
                                  grad_accum=2, device=dev)
        sp_rng = np.random.default_rng(1)
        sp_images, sp_targets = host_block(
            sp_mesh, sp_rng.integers(0, 256, (n, 72, w, 3), dtype=np.uint8),
            sp_rng.integers(-1, NUM_CLASSES, (n, 72, w)).astype(np.int32))
        sp_state, sp_metrics = sp_step(sp_state, sp_images, sp_targets, generator(1))
        space_loss = float(sp_metrics["loss"])
        assert np.isfinite(space_loss), f"non-finite spatial loss {space_loss}"
        print(f"[rank {rank}] dp×sp train step (mesh {sp_mesh.shape}): loss {space_loss:.4f}",
              flush=True)

    # eval under the mesh: the statistics of the global batch
    eval_m = make_eval_step(model, NUM_CLASSES, mesh=mesh, compute_dtype=torch.float32,
                            device=dev)
    eval_1 = make_eval_step(model, NUM_CLASSES, compute_dtype=torch.float32, device=dev)
    pred_m, stats_m = eval_m(state.params, state.model_state, images[mine], targets[mine])
    per = batch // n
    shards = [eval_1(state.params, state.model_state, images[k * per:(k + 1) * per],
                     targets[k * per:(k + 1) * per]) for k in range(n)]
    assert torch.equal(pred_m, shards[rank][0]), "sharded eval mask drift"
    for i, name in enumerate(("correct", "labeled", "inter", "union")):
        assert torch.equal(stats_m[i], sum(s[1][i] for s in shards)), \
            f"sharded eval statistic '{name}' drift"
    print(f"[rank {rank}] eval statistics under the mesh equal one process's", flush=True)

    # sharded serving: n replicas on this rank's device (no collectives)
    from fastscnn_tpu_torch.engine import InferenceEngine

    trained = FastSCNN(NUM_CLASSES, aux=True)
    trained.load_state_dict(from_jax_params(state.params, state.model_state))
    cfg = E2EConfig(compute_dtype="float32")
    local = make_mesh(devices=[dev] * n)

    def by_shards(engine):
        return torch.cat([engine.predict(images[k * per:(k + 1) * per]) for k in range(n)])

    mask_1 = by_shards(InferenceEngine(trained, device=dev, config=cfg))
    mask_m = InferenceEngine(trained, config=cfg, mesh=local).predict(images)
    assert torch.equal(mask_m, mask_1), "sharded predict mask drift"
    b3 = trained.with_options(folded_dw_impl="fused-ds")
    mask_b3 = by_shards(InferenceEngine(b3, device=dev, config=cfg))
    mask_b3m = InferenceEngine(b3, config=cfg, mesh=local).predict(images)
    assert torch.equal(mask_b3m, mask_b3), "B3 serving under the data mesh drifts"
    print(f"[rank {rank}] sharded serve equal to one engine (and with B3)", flush=True)

    # device augmentation under the mesh: batch = grad_accum × n
    aug = make_device_augment(base_size=h, crop_size=32, pad_label=-1)
    step_aug = make_train_step(model, loss_fn, optimizer, mesh=mesh, device_aug=aug,
                               grad_accum=2, device=dev)
    state_aug = create_train_state(model_of(2), optimizer, device=dev)
    native = rng.integers(0, 256, (2 * n, h, 2 * w, 3), dtype=np.uint8)
    native_t = rng.integers(-1, NUM_CLASSES, (2 * n, h, 2 * w)).astype(np.int32)
    rows = host_shard(np.arange(2 * n))
    state_aug, metrics_aug = step_aug(state_aug, native[rows], native_t[rows], generator(3),
                                      generator(5))
    aug_loss = float(metrics_aug["loss"])
    assert np.isfinite(aug_loss), f"non-finite device-aug loss {aug_loss}"
    print(f"[rank {rank}] device-aug train step under dp: loss {aug_loss:.4f}", flush=True)

    # checkpoint: the primary saves, every rank loads, the next step equal
    path = os.path.join(work, "train_state_citys.pt")
    if rank == 0:
        save_train_state(state, path)
    dist.barrier()
    restored = load_train_state(path, create_train_state(model_of(9), optimizer, device=dev))
    for a, b in zip(tree_leaves(restored.params) + tree_leaves(restored.model_state),
                    tree_leaves(state.params) + tree_leaves(state.model_state), strict=True):
        assert torch.equal(a, b), "lossy train-state restore"
    _, m_resumed = step(restored, images[mine], targets[mine], generator(4))
    _, m_cont = step(state, images[mine], targets[mine], generator(4))
    assert restored.step == state.step == 2
    resumed = float(m_resumed["loss"])
    assert resumed == float(m_cont["loss"]), (resumed, float(m_cont["loss"]))
    print(f"[rank {rank}] checkpoint save/resume under the mesh: continued loss "
          f"{resumed:.4f}, bit-equal", flush=True)

    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "train_loss": loss.hex(), "aug_loss": aug_loss.hex(),
                   "resumed_loss": resumed.hex(), "stats": [hexes(s) for s in stats_m],
                   "space_loss": None if space_loss is None else space_loss.hex(),
                   "params": [hexes(p.detach().abs().sum()) for p in tree_leaves(state.params)]},
                  f)
    dist.barrier()
    dist.destroy_process_group()


def _main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="one rank of dryrun_multichip")
    p.add_argument("--dryrun-rank", action="store_true", required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--backend", required=True)
    p.add_argument("--workdir", required=True)
    a = p.parse_args(argv)
    torch.set_num_threads(1)  # the ranks share the host's cores
    _dryrun_rank(a.device, a.backend, a.workdir)


if __name__ == "__main__":
    _main(sys.argv[1:])
