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

Gloo takes CPU tensors. `all_reduce`, `all_gather` and `reduce_scatter`
are the port's collectives of tensors over any group (these operations,
the layer gathers of parallel/fsdp.py and the checkpoint gathers of
training/strategy.py), and `_run` is the one place that routes them:
where the caller names gloo for ranks that share one card (NCCL refuses
two ranks on one device), through `SharedCard`, buffers on the card that
each rank opens of the others' (CUDA IPC), ordered by the group's
barriers, no byte through the host (gloo's own path, over TCP between the
processes, is the slow part of such a step: PERF.md section 6); a CUDA
tensor over gloo between cards staged through the host; torch.distributed's
own collective otherwise (NCCL on the card, gloo on CPU tensors).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, FrozenSet, Iterable, Iterator, List, Optional

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


class SharedCard:
    """All-reduce (SUM or MAX), all-gather and reduce-scatter for the ranks
    of a gloo group that share one card (gloo moves a card tensor only
    through the host, over TCP; NCCL refuses two ranks on one device):
    each rank keeps two buffers on the card, which the others open through
    CUDA IPC (the handles exchanged over the group whenever one grows). A
    device synchronize and a barrier of the group (the fence) order every
    write before the reads of the same call. The calls alternate between
    the two sets of buffers, so a call writes the set that the call before
    last read: every rank has passed the last call's fence, which waited
    for its own device, so those reads are done, and no fence follows the
    reads. This holds across policy calls too (a serving host keeps two in
    flight): every rank issues the same collectives in the same order. A
    set grows to its largest call (a bucket-4 prefill's row-parallel W8A8
    partials: 2136 x 4096 int32, 35 MB). Each output is a new tensor, never
    a view of a buffer."""

    def __init__(self, group: Any, device: torch.device):
        import torch.distributed as dist

        self.group, self.device = group, device
        self.size, self.rank = dist.get_world_size(group), dist.get_rank(group)
        self.mine: List[Optional[torch.Tensor]] = [None, None]
        self.peers: List[List[torch.Tensor]] = [[], []]
        self.turn = 0

    def _buffers(self, nbytes: int) -> List[torch.Tensor]:
        """Every rank's buffer of this call's set, at least nbytes long
        (this rank's own); the next call takes the other set. A set that
        grows replaces buffers whose reads are done, as a write would."""
        import torch.distributed as dist
        from torch.multiprocessing.reductions import reduce_tensor

        k, self.turn = self.turn, 1 - self.turn
        if self.mine[k] is None or self.mine[k].numel() < nbytes:
            self.peers[k] = []
            self.mine[k] = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=self.device)
            shared: List[Any] = [None] * self.size
            dist.all_gather_object(shared, reduce_tensor(self.mine[k]), group=self.group)
            self.peers[k] = [self.mine[k] if r == self.rank else fn(*args) for r, (fn, args) in enumerate(shared)]
        return [p[:nbytes] for p in self.peers[k]]

    def _fence(self) -> None:
        import torch.distributed as dist

        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)

    def all_gather(self, mine: torch.Tensor) -> torch.Tensor:
        bufs = self._buffers(mine.numel() * mine.element_size())
        bufs[self.rank].view(mine.dtype).copy_(mine)
        self._fence()
        return torch.cat([b.view(mine.dtype) for b in bufs])

    def all_reduce(self, t: torch.Tensor, op: Any) -> torch.Tensor:
        """t reduced over the group in place (SUM in rank order, or MAX)."""
        import torch.distributed as dist

        bufs = self._buffers(t.numel() * t.element_size())
        bufs[self.rank].view(t.dtype).copy_(t.reshape(-1))
        self._fence()
        got = [b.view(t.dtype).view(t.shape) for b in bufs]
        out = got[0].clone()
        for g in got[1:]:
            if op == dist.ReduceOp.MAX:
                torch.maximum(out, g, out=out)
            else:
                out += g
        return t.copy_(out)

    def reduce_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        bufs = self._buffers(flat.numel() * flat.element_size())
        bufs[self.rank].view(flat.dtype).copy_(flat)
        self._fence()
        n = flat.numel() // self.size
        out = bufs[0].view(flat.dtype)[self.rank * n : (self.rank + 1) * n].clone()
        for b in bufs[1:]:
            out += b.view(flat.dtype)[self.rank * n : (self.rank + 1) * n]
        return out


_SHARED: Dict[Any, Optional[SharedCard]] = {}  # gloo group -> its shared card, or None (ranks on several)


def shared_card(t: torch.Tensor, group: Any) -> Optional[SharedCard]:
    """The SharedCard of `group` where t lies on the card, the group runs
    gloo and its ranks all hold that one card (decided with the group, once),
    else None."""
    import torch.distributed as dist

    if not (t.is_cuda and dist.get_backend(group) == "gloo"):
        return None
    if group not in _SHARED:
        uuid = str(torch.cuda.get_device_properties(t.device).uuid)
        every: List[Any] = [None] * dist.get_world_size(group)
        dist.all_gather_object(every, uuid, group=group)
        _SHARED[group] = SharedCard(group, t.device) if len(set(every)) == 1 else None
    return _SHARED[group]


def _run(t: torch.Tensor, g: Any, on_card: Callable[[SharedCard, torch.Tensor], torch.Tensor],
         native: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """One collective of t over g, routed by where the group's ranks are:
    on_card through the group's SharedCard where gloo ranks share t's card;
    native (torch.distributed's own) otherwise, on a host copy of a CUDA
    tensor over gloo between cards, its result moved back to t's device."""
    import torch.distributed as dist

    card = shared_card(t, g)
    if card is not None:
        return on_card(card, t)
    if t.is_cuda and dist.get_backend(g) == "gloo":
        return native(t.cpu()).to(t.device)
    return native(t)


def all_reduce(t: torch.Tensor, g: Any, op=None) -> torch.Tensor:
    """t reduced in place over g (SUM by default); returns t."""
    import torch.distributed as dist

    op = dist.ReduceOp.SUM if op is None else op

    def native(x):
        dist.all_reduce(x, op=op, group=g)
        return x

    out = _run(t, g, lambda card, x: card.all_reduce(x, op), native)
    return out if out is t else t.copy_(out)


def all_gather(t: torch.Tensor, g: Any, dim: int = 0) -> torch.Tensor:
    """The group's tensors t (one shape on every rank) concatenated along
    `dim` in rank order."""
    import torch.distributed as dist

    n = _size(g)

    def native(x):
        out = x.new_empty((n, *x.shape))
        dist.all_gather(list(out.unbind(0)), x, group=g)
        return out

    parts = _run(t.contiguous(), g, lambda card, x: card.all_gather(x.reshape(-1)).view(n, *x.shape), native)
    return parts.flatten(0, 1) if dim == 0 else torch.cat(parts.unbind(0), dim)


def reduce_scatter(flat: torch.Tensor, g: Any) -> torch.Tensor:
    """This rank's segment of the 1-D `flat` (the group's size of equal
    segments), summed over g."""
    import torch.distributed as dist

    n = _size(g)

    def native(x):
        out = x.new_empty(x.numel() // n)
        dist.reduce_scatter(out, list(x.chunk(n)), group=g)
        return out

    return _run(flat, g, lambda card, x: card.reduce_scatter(x), native)


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
        return all_gather(x, g, -1)

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
