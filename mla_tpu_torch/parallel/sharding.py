"""Which rank holds which part of each trainable leaf's master weights and
optimizer state, and which rows of the global batch.

Counterpart of mla_tpu/parallel/sharding.py (fsdp rules only; its tp
rules are ROADMAP item 13). JAX shards each leaf's largest dim that
divides by the fsdp size and keeps the stacked [L] axis of the decoder
leaves whole (sharding it would all-gather inside the layer scan). The
port's optimizer step is per element and its layer loop indexes a whole
leaf, so it may cut the [L] axis too. Adafactor's factored moments need
whole rows and columns in a slice, so its two factored dims are never cut
(a stacked decoder leaf is then cut along L). A leaf with no dim to cut
is owned whole by one rank, picked to balance the bytes, so a rank holds
at most total / fsdp plus the largest such leaf.

`shard_batch` gives rank r the rows [r * b, (r + 1) * b) of each global
micro-batch, the layout `make_array_from_process_local_data` assembles in
JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Spec:
    """A leaf cut along `dim` into fsdp equal slices (slice i on fsdp rank
    i), or held whole by fsdp rank `owner` (dim None)."""

    dim: Optional[int] = None
    owner: int = 0


def shard_dim(shape: Sequence[int], fsdp: int, keep_whole: Iterable[int] = ()) -> Optional[int]:
    """JAX's rule: the largest dim (the first of equal ones) that divides
    by fsdp, skipping the dims in keep_whole; None if there is none."""
    keep = set(keep_whole)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if i not in keep and shape[i] % fsdp == 0 and shape[i] >= fsdp:
            return i
    return None


def plan(leaves: Sequence[Tuple[str, Tuple[int, ...], int]], fsdp: int,
         keep_whole=lambda shape: ()) -> Dict[str, Spec]:
    """{path: Spec} for (path, shape, bytes) leaves. keep_whole(shape) names
    the dims that must stay whole (Adafactor's factored dims). Leaves with
    no dim to cut go whole to the fsdp rank holding the fewest such bytes
    so far, largest first."""
    specs: Dict[str, Spec] = {}
    whole = []
    for path, shape, nbytes in leaves:
        d = shard_dim(shape, fsdp, keep_whole(shape)) if fsdp > 1 else None
        if d is None:
            whole.append((path, nbytes))
        else:
            specs[path] = Spec(dim=d)
    held = [0] * fsdp
    for path, nbytes in sorted(whole, key=lambda x: -x[1]):
        owner = int(np.argmin(held))
        held[owner] += nbytes
        specs[path] = Spec(owner=owner)
    return specs


def local_part(t: torch.Tensor, spec: Spec, fsdp_rank: int, fsdp: int) -> Optional[torch.Tensor]:
    """This rank's part of a whole leaf (a view): its slice, the whole leaf
    for its owner, None for the others."""
    if spec.dim is None:
        return t if spec.owner == fsdp_rank else None
    n = t.shape[spec.dim] // fsdp
    return t.narrow(spec.dim, fsdp_rank * n, n)


def shard_batch(batch: Any, rank: int, world: int, accum: int = 1, blocks: int = 1) -> Any:
    """Rank `rank`'s rows of a global batch (a tree of arrays or tensors;
    0-d leaves kept): the batch is `accum` micro-batches, each of `blocks`
    equal blocks (mla_train_loss's repeated_diffusion_steps copies, for
    its draws), and the rank takes rows [r * b, (r + 1) * b) of every
    block, in order."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, world, accum, blocks) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, rank, world, accum, blocks) for v in batch)
    if getattr(batch, "ndim", 0) == 0:
        return batch
    n = batch.shape[0]
    per = n // (accum * blocks)
    if per * accum * blocks != n or per % world:
        raise ValueError(f"{n} rows do not split into {accum} x {blocks} blocks over {world} ranks")
    b = per // world
    parts = [batch[blk * per + rank * b : blk * per + (rank + 1) * b] for blk in range(accum * blocks)]
    if isinstance(batch, torch.Tensor):
        return torch.cat(parts, 0)
    return np.concatenate(parts, 0)
