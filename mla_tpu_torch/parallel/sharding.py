"""Which rank holds which part of each trainable leaf (its master weight,
gradient and optimizer state), and which rows of the global batch.

Counterpart of mla_tpu/parallel/sharding.py. Its tp rules (`TP_RULES`,
`tp_dim`) are JAX's `_TP_RULES` and the tp branch of `_spec_for_leaf`, rule
for rule: the serving decoder's q/k/v/gate/up split on the output dim, o
and down on the input dim, the embedding and the lm_head on the
vocabulary (params.tp_local takes a rank's part; `tp_split_dims` says,
for every leaf, which dim the tp ranks split or that each holds it
whole, and every reduction of the train step reads it; `serving_tp_dim`
says it for the serving tree's fused leaves). The port serves over tp
composed with fsdp (dp = 1, parallel/mesh.serving_mesh) and trains over
tp composed with fsdp and dp.

For fsdp, JAX shards each leaf's largest dim that divides by the fsdp
size and keeps the stacked [L] axis of the decoder leaves whole (sharding
it would all-gather inside the layer scan); under tp it takes the largest
dim the tp rule left whole (`_spec_for_leaf`). `plan` takes a rank's
tp-local shapes and the same rule: the tp dim stays whole. A rank keeps
only its part of every trainable leaf, and the step gathers the compute
tensors from the parts (parallel/fsdp.py: the decoder one layer at a
time), so the plan may cut the [L] axis too: layer i of such a leaf lies
whole on one rank, whose gather hands it to the others. The optimizer step
is per element, but Adafactor's factored moments need whole rows and
columns in a slice, so its two factored dims (of the whole leaf) are never
cut (a stacked decoder leaf is then cut along L). A leaf with no dim to
cut is owned whole by one rank, picked to balance the bytes, so a rank
holds at most total / fsdp plus the largest such leaf. A rank's master part
is its fsdp slice of its tp slice.

`shard_batch` gives rank r the rows [r * b, (r + 1) * b) of each global
micro-batch, the layout `make_array_from_process_local_data` assembles in
JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch


# llama leaf paths (suffix match) -> tp dim counted from the END, as in JAX
# (negative indexing serves stacked [L, in, out] and flat [in, out] leaves)
TP_RULES = {
    "layers/attn/q/w": -1,
    "layers/attn/k/w": -1,
    "layers/attn/v/w": -1,
    "layers/attn/o/w": -2,
    "layers/mlp/gate/w": -1,
    "layers/mlp/up/w": -1,
    "layers/mlp/down/w": -2,
    "embed/table": -2,   # vocab dim of [V, D]
    "lm_head/w": -1,     # vocab dim of [D, V]
}


def tp_rule(path: str) -> Optional[str]:
    """The TP_RULES key that the leaf at `path` falls under (an int8 leaf's
    w_q and w_scale under their w's), or None."""
    base = path
    for tail in ("/w_q", "/w_scale"):
        if path.endswith(tail):
            base = path[: -len(tail)] + "/w"
    return next((suffix for suffix in TP_RULES if base.endswith(suffix)), None)


def tp_dim(path: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The dim (counted from 0) that a leaf at `path` splits over a tp axis
    of `tp`, or None when it stays whole: JAX's rule. An int8 leaf follows
    its bf16 leaf's rule, w_q [.., K, N] like w; the per-output-channel
    w_scale [.., 1, N] splits only under the N-split (-1) rules and stays
    whole under the K-split ones. int4 (w_q4, w_scale4) and the int8
    embedding (table_q, table_scale: 'embed/table' does not match their
    paths) stay whole, as does a leaf whose dim does not divide by tp."""
    ndim, rule = len(shape), tp_rule(path)
    if tp <= 1 or ndim == 0 or rule is None:
        return None
    if path.endswith("/w_scale"):
        if TP_RULES[rule] != -1:
            return None
        d = ndim - 1
    else:
        d = ndim + TP_RULES[rule]
    return d if 0 <= d < ndim and shape[d] % tp == 0 else None


# the serving tree's fused leaves (models/llama.fuse_for_serving) and the
# leaf whose TP_RULES key each holds
_FUSED = {"/attn/qkv_fused/": "/attn/q/", "/mlp/gateup_fused/": "/mlp/gate/"}


def serving_tp_dim(path: str, ndim: int, split: Iterable[str]) -> Optional[int]:
    """The dim of a serving tree's leaf (tp-local, fused; params.tp_local
    then llama.fuse_for_serving) that the tp ranks hold a slice of, or None
    where each holds it whole: its TP_RULES key's dim where that key is in
    `split`, a fused leaf under its q's or gate's key, the K-major w_qt
    [.., out, in] under its w_q's with the last two dims swapped, a
    per-output-channel w_scale only under the N-split (-1) rules."""
    base = path
    for fused, one in _FUSED.items():
        base = base.replace(fused, one)
    k_major = base.endswith("/w_qt")
    if k_major:
        base = base[: -len("/w_qt")] + "/w_q"
    rule = tp_rule(base)
    if rule is None or rule not in set(split):
        return None
    if base.endswith("/w_scale") and TP_RULES[rule] != -1:
        return None
    d = -1 if base.endswith("/w_scale") else TP_RULES[rule]
    return ndim + (-3 - d if k_major else d)


def tp_split_dims(leaves: Iterable[Tuple[str, Sequence[int]]], tp: int) -> Dict[str, Optional[int]]:
    """{path: the dim that the tp ranks hold a slice of, or None where each
    holds the leaf whole} for (path, WHOLE shape) pairs: tp_dim leaf for
    leaf. A reduction over the tp group sums a split leaf's partial
    statistics and leaves a whole leaf's alone (the ranks hold the same
    copy: its gradient arrives whole on each, through copy_to_tp's
    all-reduce)."""
    return {path: tp_dim(path, tuple(shape), tp) for path, shape in leaves}


def tp_part(t: torch.Tensor, dim: Optional[int], tp_rank: int, tp: int) -> torch.Tensor:
    """Slice tp_rank of `t` along `dim` (a view), or `t` itself (dim None)."""
    if dim is None:
        return t
    n = t.shape[dim] // tp
    return t.narrow(dim, tp_rank * n, n)


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
         keep_whole=lambda path, shape: ()) -> Dict[str, Spec]:
    """{path: Spec} for (path, shape, bytes) leaves, shapes tp-local.
    keep_whole(path, shape) names the dims that must stay whole (the tp
    dim, Adafactor's factored dims). Leaves with no dim to cut go whole to
    the fsdp rank holding the fewest such bytes so far, largest first."""
    specs: Dict[str, Spec] = {}
    whole = []
    for path, shape, nbytes in leaves:
        d = shard_dim(shape, fsdp, keep_whole(path, shape)) if fsdp > 1 else None
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
