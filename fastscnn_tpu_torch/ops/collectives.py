"""The few collectives the data-parallel steps need, over a
``torch.distributed`` group.

Every function takes ``group`` explicitly; ``group=None`` means one
process, and then each returns its input (no collective, no copy). A group
reduces equal shards: every rank holds the same number of rows.

The differentiable sums use ``torch.distributed.nn.functional.all_reduce``,
whose backward all-reduces the incoming gradient. Every rank computes the
same (replicated) loss from the reduced sums, so autograd differentiates
the sum of the ranks' copies, N times the global loss: the step divides
the all-reduced gradients by N (``parallel/train.py``).
"""

from __future__ import annotations

import torch

__all__ = ["group_size", "group_rank", "global_sum", "global_sums", "sum_", "gather_rows",
           "broadcast_"]


def group_size(group) -> int:
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def group_rank(group) -> int:
    if group is None:
        return 0
    import torch.distributed as dist

    return dist.get_rank(group)


def global_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the group's ranks, differentiable."""
    if group is None:
        return t
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, op=dist.ReduceOp.SUM, group=group)


def global_sums(*ts: torch.Tensor, group):
    """Several same-dtype scalars (or equal-shape tensors) summed over the
    group in one differentiable all-reduce."""
    if group is None:
        return ts
    return tuple(global_sum(torch.stack(ts), group).unbind(0))


def sum_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place all-reduce sum of ``t`` (no autograd); returns ``t``."""
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along axis 0, in rank order (no
    autograd)."""
    if group is None:
        return t
    import torch.distributed as dist

    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def broadcast_(ts: list, group, src: int) -> None:
    """Each of the tensors ``ts`` (of one dtype) set in place to its value
    on global rank ``src`` of the group, in one broadcast (no autograd)."""
    if group is None:
        return
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.broadcast(flat, src=src, group=group)
    torch._foreach_copy_(ts, [v.view_as(t) for v, t in
                              zip(flat.split([t.numel() for t in ts]), ts)])
