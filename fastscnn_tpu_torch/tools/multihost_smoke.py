"""A real multi-process data-parallel run on one machine.

Counterpart of ``fastscnn_tpu/tools/multihost_smoke.py``, with its flags
and the keys of the JSON it writes. N local processes join a 127.0.0.1
coordinator (``parallel/multihost.py``: gloo on the CPU, NCCL on cards, or
``--backend``), build one global data-parallel mesh over the ranks and
run the sharded train step (``parallel.train.make_train_step``) for a few
steps on deterministic synthetic data: every process derives the same
global batch and keeps its ``host_shard`` rows.

Each process writes a JSON result (its loss history and a fingerprint of
the params); ``tests/test_torch_multidevice.py`` and
``entry.dryrun_multichip`` launch 2 processes and a single-process control
on the same global batches and hold: both ranks see the whole world, the
loss histories agree bit for bit across the ranks (the same replicated
global computation), and the losses and params agree with the control to
reduction-order tolerance.

Usage (one line a process)::

    COORDINATOR_ADDRESS=127.0.0.1:<port> NUM_PROCESSES=2 PROCESS_ID=<k> \\
      python -m fastscnn_tpu_torch.tools.multihost_smoke --platform cpu \\
        --steps 4 --out /tmp/proc<k>.json

or with ``--coordinator 127.0.0.1:<port> --num-processes 2 --process-id
<k>``. Without any of them the run is the single-process control.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

__all__ = ["run", "main"]


def run(num_processes: int, process_id: int, coordinator: str | None, steps: int = 4,
        batch: int = 8, size: int = 32, out: str | None = None, platform: str | None = None,
        backend: str | None = None):
    """One process of the run (``num_processes`` 1: the control). ``platform``:
    the device to run on ('cpu', 'cuda' or 'cuda:<k>'; None: the card
    ``rank % cards``, raising without one)."""
    import torch

    from fastscnn_tpu_torch import resolve_device
    from fastscnn_tpu_torch.losses import get_loss_fn
    from fastscnn_tpu_torch.models import init_fast_scnn
    from fastscnn_tpu_torch.parallel import create_train_state, make_mesh, make_optimizer
    from fastscnn_tpu_torch.parallel import make_train_step
    from fastscnn_tpu_torch.parallel.multihost import (
        global_device_count,
        host_shard,
        initialize_multihost,
        local_device,
        process_count,
    )
    from fastscnn_tpu_torch.utils import lr_schedule
    from fastscnn_tpu_torch.utils.tree import tree_leaves

    joined = False
    if num_processes > 1 or coordinator is not None:
        joined = initialize_multihost(coordinator, num_processes, process_id,
                                      device=platform or "cuda", backend=backend)
        if not joined or process_count() != num_processes:
            raise RuntimeError(f"joined {process_count()} of {num_processes} processes")
    device = resolve_device(platform if platform is not None or not joined
                            else local_device() if torch.cuda.is_available() else None)
    mesh = make_mesh() if joined else None
    mesh_shape = dict(mesh.shape) if mesh is not None else {"data": 1, "space": 1}
    print(f"[proc {process_id}] joined: process_count={process_count()} "
          f"global_devices={global_device_count()} mesh={mesh_shape} device={device}", flush=True)

    model = init_fast_scnn(2, aux=True, generator=torch.Generator().manual_seed(0),
                           device=device, dropout_rate=0.0)
    optimizer = make_optimizer("sgd", lr_schedule("poly", base_lr=1e-2, niters=100, power=0.9),
                               momentum=0.9, weight_decay=1e-4)
    step_fn = make_train_step(model, get_loss_fn("dice", aux=True), optimizer, mesh=mesh,
                              mean=None, std=None, compute_dtype=torch.float32, device=device)
    state = create_train_state(model, optimizer, device=device)

    losses = []
    for k in range(steps):
        # every process derives the same global batch and keeps its rows
        rng = np.random.default_rng(1000 + k)
        g_img = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
        g_tgt = (rng.random((batch, size, size)) > 0.5).astype(np.int32)
        l_img, l_tgt = host_shard(g_img, g_tgt)
        state, metrics = step_fn(state, l_img, l_tgt)
        losses.append(float(metrics["loss"]))
        print(f"[proc {process_id}] step {k}: loss {losses[-1]:.6f}", flush=True)

    fingerprint = float(sum(float(leaf.detach().abs().sum()) for leaf in tree_leaves(state.params)))
    result = {
        "process_id": process_id,
        "process_count": process_count(),
        "device_count": global_device_count(),
        "mesh_shape": mesh_shape,
        "losses": losses,
        "param_fingerprint": fingerprint,
        "final_step": int(state.step),
    }
    if out:
        with open(out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result))
    if joined:
        import torch.distributed as dist

        dist.destroy_process_group()
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=32)
    p.add_argument("--out", default=None, help="write the result JSON here")
    p.add_argument("--platform", default=None,
                   help="the device to run on ('cpu', 'cuda', 'cuda:<k>'; default: the card "
                        "rank %% cards)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="the process group's backend (default: NCCL on a card, gloo on the "
                        "CPU; gloo lets several ranks share one card)")
    a = p.parse_args(argv)
    import os

    num = a.num_processes or int(os.environ.get("NUM_PROCESSES", "1"))
    pid = a.process_id if a.process_id is not None else int(os.environ.get("PROCESS_ID", "0"))
    coordinator = a.coordinator or os.environ.get("COORDINATOR_ADDRESS")
    run(num, pid, coordinator, a.steps, a.batch, a.size, a.out, platform=a.platform,
        backend=a.backend)


if __name__ == "__main__":
    main()
