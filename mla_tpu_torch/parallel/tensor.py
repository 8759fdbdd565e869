"""Megatron's operations over a tensor-parallel (tp) group.

A policy served over a tp group of T processes holds on each rank only its
part of the decoder, split by JAX's `_TP_RULES` (parallel/sharding.py):
q/k/v and gate/up on their output dim (column-parallel), o and down on
their input dim (row-parallel), the embedding and the lm_head on the
vocabulary. The decoder then needs four operations over the group:

  * `copy_to_tp`: identity forward, all-reduce of the gradient backward
    (the input of a column-parallel layer);
  * `reduce_from_tp`: all-reduce SUM forward, identity backward (the output
    of a row-parallel layer);
  * `gather_from_tp`: the ranks' slices concatenated on the last dim (a
    vocab-split lm_head's logits); backward keeps this rank's slice;
  * `vocab_parallel_embedding`: the rows of this rank's vocabulary slice,
    zeros for the other ids, summed over the group (exact: one rank
    contributes each row);
and `all_reduce_max` of a row vector (the W8A8 row scale of a row-parallel
product, ops/quantization.w8a8_matmul_rowpar), and for training
`vocab_parallel_cross_entropy`, Megatron's cross-entropy of vocab-split
logits (the [.., V] logits are never gathered).

The first three are torch.autograd.Functions, so a training step uses
them too: copy_to_tp enters every column-parallel product and the
vocab-split lm_head, so the gradient of what feeds them (and of every
leaf a rank holds whole) arrives whole, the same on every rank.
`tp_group(group, split)` makes a group active inside a block,
with the TP_RULES keys whose leaves the ranks hold in part
(params.tp_local); the layers ask `split(key)` which of their products
are row-parallel or vocab-split. `group()` is None without a group or at
T = 1, `split` is then False and every operation the identity, so
one-process serving runs the very same ops.

Gloo takes CPU tensors. Where the caller names gloo for ranks that share
one card (NCCL refuses two ranks on one device), a CUDA tensor is staged
through the host explicitly for each collective; NCCL reduces on the card.
"""

from __future__ import annotations

import contextlib
from typing import Any, FrozenSet, Iterable, Iterator, Optional

import torch

_GROUP: Optional[Any] = None
_SPLIT: FrozenSet[str] = frozenset()


@contextlib.contextmanager
def tp_group(group: Any, split: Iterable[str] = ()) -> Iterator[None]:
    """Run the decoder's tp operations over `group` inside the block, its
    leaves of the TP_RULES keys in `split` held in part by each rank."""
    global _GROUP, _SPLIT
    prev, (_GROUP, _SPLIT) = (_GROUP, _SPLIT), (group, frozenset(split))
    try:
        yield
    finally:
        _GROUP, _SPLIT = prev


def _size(group: Any) -> int:
    import torch.distributed as dist

    return dist.get_world_size(group) if group is not None else 1


def group() -> Optional[Any]:
    """The active tp group, or None (no group, or a group of one)."""
    if _GROUP is None or _size(_GROUP) == 1:
        return None
    return _GROUP


def size() -> int:
    """T, the active group's size (1 without one)."""
    g = group()
    return 1 if g is None else _size(g)


def split(rule: str) -> bool:
    """True where the active group's ranks hold the leaves of the TP_RULES
    key `rule` in part."""
    return group() is not None and rule in _SPLIT


def rank() -> int:
    """This process's rank in the active group (0 without one)."""
    import torch.distributed as dist

    g = group()
    return 0 if g is None else dist.get_rank(g)


def _staged(t: torch.Tensor, g: Any) -> bool:
    import torch.distributed as dist

    return t.is_cuda and dist.get_backend(g) == "gloo"


def all_reduce(t: torch.Tensor, g: Any, op=None) -> torch.Tensor:
    """t reduced in place over g (SUM by default; a CUDA tensor over gloo
    staged through the host); returns t."""
    import torch.distributed as dist

    op = dist.ReduceOp.SUM if op is None else op
    if _staged(t, g):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=g)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=g)
    return t


def _all_gather_last(t: torch.Tensor, g: Any) -> torch.Tensor:
    import torch.distributed as dist

    src = t.contiguous().cpu() if _staged(t, g) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(_size(g))]
    dist.all_gather(parts, src, group=g)
    return torch.cat(parts, dim=-1).to(t.device)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, g: Any) -> torch.Tensor:
        ctx.group = g
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, g: Any) -> torch.Tensor:
        return all_reduce(x.contiguous().clone(), g)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, g: Any) -> torch.Tensor:
        import torch.distributed as dist

        ctx.rank, ctx.width = dist.get_rank(g), x.shape[-1]
        return _all_gather_last(x, g)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.narrow(-1, ctx.rank * ctx.width, ctx.width), None


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    g = group()
    return x if g is None else _CopyToTP.apply(x, g)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """x summed over the tp group (in x's dtype: int32 sums are exact)."""
    g = group()
    return x if g is None else _ReduceFromTP.apply(x, g)


def gather_from_tp(x: torch.Tensor) -> torch.Tensor:
    """The group's slices of the last dim, concatenated in rank order."""
    g = group()
    return x if g is None else _GatherFromTP.apply(x, g)


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of x over the tp group (no gradient)."""
    import torch.distributed as dist

    g = group()
    return x if g is None else all_reduce(x.detach().contiguous().clone(), g, dist.ReduceOp.MAX)


def vocab_parallel_embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of a vocab-split table [V / T, D] for global ids: this rank's
    rows where the id falls in its slice, zeros elsewhere, summed over the
    group. Without a group, table[ids]."""
    if group() is None:
        return table[ids]
    start = rank() * table.shape[0]
    local = ids - start
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(mine, local, 0)]
    return reduce_from_tp(torch.where(mine[..., None], rows, torch.zeros_like(rows)))


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits: torch.Tensor, target: torch.Tensor, g: Any) -> torch.Tensor:
        import torch.distributed as dist

        vl = logits.shape[-1]
        local = target - dist.get_rank(g) * vl
        mine = (local >= 0) & (local < vl)
        idx = torch.where(mine, local, 0)
        m = all_reduce(logits.detach().amax(-1), g, dist.ReduceOp.MAX)
        z = logits.detach() - m[..., None]
        exp = z.exp()
        picked = torch.where(mine, z.gather(-1, idx[..., None])[..., 0], 0.0)
        sums = all_reduce(torch.stack([picked, exp.sum(-1)]), g)
        ctx.save_for_backward(exp.div_(sums[1][..., None]), idx, mine)
        return sums[1].log() - sums[0]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        softmax, idx, mine = ctx.saved_tensors
        g = softmax.scatter_add(-1, idx[..., None], -mine[..., None].to(softmax.dtype))
        return g * grad[..., None], None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[target] per row under the active tp group, the
    logits [..., V / T] this rank's slice of the vocabulary (fp32), target
    [...] global ids: Megatron's form, the row max, the sum of exp and the
    target's logit (from the rank that holds it) all-reduced over the
    group; backward softmax minus the target's one-hot on this rank's
    slice."""
    return _VocabParallelCE.apply(logits, target, group())
