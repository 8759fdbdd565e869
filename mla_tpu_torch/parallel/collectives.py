"""Reductions over the global batch, with gradients.

Under GSPMD the JAX package computes a few statistics over the whole
(global) batch: the point tokenizer's batch norm, the contrastive loss's
[B*N, B*N] negatives, and the denominators of the losses whose count
depends on the batch's contents (valid labels, ROI pixels). With one
process per card each rank holds only its rows, so these call the helpers
here, which reduce across the ranks of the group the train step sets with
`batch_group` (the mesh's data group: the dp * fsdp ranks that share a tp
index, the world at tp 1; the ranks of a tp group hold the same rows, so
each row counts once), and are the identity without one or at size 1 (so
a one-card step runs the very same ops).

The objective of a distributed step is the mean over ranks of the
per-rank losses (the step averages the ranks' gradients), so:
  * `all_sum` is an all-reduce whose backward all-reduces the incoming
    gradients (every rank's loss reads the sum);
  * `all_gather_rows` concatenates the ranks' rows; its backward sums the
    ranks' gradients of the gathered tensor and keeps this rank's rows;
  * `share(count)` is a global count over the group's size: a rank's
    `local_sum / share` averages over ranks to `global_sum / global_count`.

Each call names its reduction ("batch_norm", "contrastive",
"label_count", "mask_count") to `active`, the one place that decides
whether it spans the group.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Optional

import torch

_GROUP: Optional[Any] = None


@contextlib.contextmanager
def batch_group(group: Any) -> Iterator[None]:
    """Reduce over `group` (a process group spanning the global batch)
    inside the block."""
    global _GROUP
    prev, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = prev


def _size(group: Any) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group) if group is not None else 1


def active(what: str) -> Optional[Any]:
    """The group to reduce `what` over, or None (no group or world size
    1)."""
    if _GROUP is None or _size(_GROUP) == 1:
        return None
    return _GROUP


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        import torch.distributed as dist

        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        import torch.distributed as dist

        ctx.group, ctx.rank, ctx.rows = group, dist.get_rank(group), x.shape[0]
        parts = [torch.empty_like(x) for _ in range(_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, 0)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(0, ctx.rank * ctx.rows, ctx.rows), None


def all_sum(x: torch.Tensor, what: str) -> torch.Tensor:
    """x summed over the ranks (differentiable); x where `what` is local."""
    group = active(what)
    return x if group is None else _AllSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, what: str) -> torch.Tensor:
    """The ranks' x concatenated on dim 0 in rank order (differentiable)."""
    group = active(what)
    return x if group is None else _AllGatherRows.apply(x, group)


def row_offset(rows: int, what: str) -> int:
    """Where this rank's `rows` start in all_gather_rows' output."""
    import torch.distributed as dist

    group = active(what)
    return 0 if group is None else dist.get_rank(group) * rows


def global_count(count: torch.Tensor, what: str) -> torch.Tensor:
    """A count summed over the ranks (no gradient)."""
    import torch.distributed as dist

    group = active(what)
    if group is None:
        return count
    total = count.detach().clone()
    dist.all_reduce(total, group=group)
    return total


def share(count: torch.Tensor, what: str) -> torch.Tensor:
    """A global count (already clamped by the caller) over the group's size:
    the denominator of one rank's part of a mean over the global batch."""
    group = active(what)
    return count if group is None else count / _size(group)
