"""Layer-wise parameter gathering over the fsdp group (ZeRO-3).

What GSPMD does with the JAX package's fsdp shardings
(mla_tpu/parallel/sharding.py `_spec_for_leaf`, mla_tpu/training/strategy.py
`shard_train_state`): every trainable leaf lies in parts over the fsdp
group, and the jitted step all-gathers each layer's weights where they are
used and reduce-scatters their gradients. Here a rank keeps only its master
part of each trainable leaf (parallel/sharding.plan: a slice along one dim,
or the whole leaf on one owner) and a `Gatherer` builds the compute tensors
from the parts when they are used:

  * the decoder's stacked layer leaves (`LAYERS`) one layer at a time,
    inside llama.run_layers (`layer_gather`). Under remat the gather runs
    inside the checkpointed function, so the backward gathers the layer
    again instead of keeping it; without remat autograd keeps every
    gathered layer until the backward;
  * every other trainable leaf (the embedding, lm_head, tokenizers,
    projectors, heads) whole, once per micro-batch (`Gatherer.tree`), in
    runs of at most BUCKET_ELEMS elements.

One `_Gather` call moves every leaf it is given in one collective each way
(FSDP's flat parameter). Forward: this rank's pieces, cast to their compute
dtype, are packed as bytes into one segment and all-gathered; a leaf cut
along a dim is the ranks' slices concatenated, a piece that one rank holds
whole (a stacked leaf cut along its [L] axis, or a leaf owned whole) comes
from its owner's segment, a broadcast in effect. Backward: the whole
gradients, in fp32, laid out as the ranks' segments and reduce-scattered;
this rank's segment is added into the accumulators (`Gatherer.acc`, one
per master part, fp32 wherever anything is summed), where the
micro-batches' gradients sum. The Function's autograd input is an anchor
scalar, not the parts: the gradient lands straight in the accumulator's
slice of the layer, so no stacked gradient of a leaf is ever built.

At fsdp 1 the collectives are the identity: the forward casts (a piece
already in its compute dtype is handed out as a view) and the backward
adds the gradient into the accumulator. Every rank runs the same gathers
in the same order: the layer loop's forward, the autograd engine's
backward, as parallel/tensor.py's row-parallel sums rely on. The
collectives are parallel/tensor.py's (all_gather, reduce_scatter), which
route them by backend and card (tensor.SharedCard for ranks that share
one card over gloo).

A serving policy over a mesh with fsdp > 1 (models/mla.py MLAPolicy)
holds its tree the same way, forward only (`serving_parts`,
`ServingGatherer`): each leaf of the tree it serves (tp-local, fused,
int8 where quantized) cut by the same plan, gathered as bytes in its own
dtype, the layers inside llama.run_layers in the prefill, every suffix
evaluation and every decode step, the other leaves once a call.

`counts` tallies the layer gathers and reduce-scatters, the outer
gathers, and the whole layers alive at once (each layer gather's outputs
watched with weakref.finalize) with their most.
"""

from __future__ import annotations

import contextlib
import math
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from mla_tpu_torch.parallel import tensor as tp_mod
from mla_tpu_torch.parallel.sharding import Spec
from mla_tpu_torch.params import tree_items, tree_map

LAYERS = "llm_backbone/layers/"  # the stacked decoder leaves, gathered layer by layer
BUCKET_ELEMS = 1 << 25  # elements per outer gather and per gradient all-reduce (128 MiB of fp32)
_ALIGN = 16  # bytes: each piece starts at a multiple in its segment, so its bytes view as its dtype

counts = {"layer_gathers": 0, "layer_reduce_scatters": 0, "gathers": 0, "reduce_scatters": 0, "live_layers": 0,
          "max_live_layers": 0}


def reset_counts() -> None:
    """Zero the tallies (the layers alive now stay counted as alive)."""
    for k in counts:
        if k != "live_layers":
            counts[k] = 0
    counts["max_live_layers"] = counts["live_layers"]


def buckets(ks: Sequence[int], numel: Callable[[int], int]) -> Iterator[List[int]]:
    """Consecutive runs of ks of at most BUCKET_ELEMS elements together (a
    larger leaf alone)."""
    run: List[int] = []
    elems = 0
    for k in ks:
        if run and elems + numel(k) > BUCKET_ELEMS:
            yield run
            run, elems = [], 0
        run.append(k)
        elems += numel(k)
    if run:
        yield run


@dataclass
class Leaf:
    """A trainable leaf as the gather sees it: its path, fsdp Spec, whole
    (tp-local) shape, compute dtype, this rank's master part (None where
    another rank owns it), the tensor that stands for it in the state's
    tree (the part, or an empty placeholder) and its accumulator's
    index."""

    path: str
    spec: Spec
    shape: Tuple[int, ...]
    dtype: torch.dtype
    part: Optional[torch.Tensor]
    held: torch.Tensor
    k: int


@dataclass
class _Piece:
    """What one gather moves of a leaf: the whole piece's shape and compute
    dtype; the dim its slices are cut along (each rank holds one), or None
    with the rank that holds it whole; the accumulator and, `sel`, the
    index into the part's dim 0 that reaches this piece (None: the whole
    part)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    dim: Optional[int]
    owner: int
    k: int
    sel: Optional[int]


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor: torch.Tensor, g: "Gatherer", pieces: Tuple[_Piece, ...], layer: bool):
        ctx.g, ctx.pieces, ctx.layer = g, pieces, layer
        ctx.set_materialize_grads(False)
        counts["layer_gathers" if layer else "gathers"] += 1
        return tuple(g._gather(pieces))

    @staticmethod
    def backward(ctx, *grads):
        counts["layer_reduce_scatters" if ctx.layer else "reduce_scatters"] += 1
        ctx.g._scatter(ctx.pieces, grads)
        return None, None, None, None


def _live_layer_freed() -> None:
    counts["live_layers"] -= 1


class _Gathers:
    """What the training and the serving gathers share: the leaves held in
    parts over `group` (this rank `rank` of `size`; None: a group of one),
    the pieces of a gather, and the compute tree built from them on
    `device`. A subclass's `_apply` runs one gather."""

    def __init__(self, leaves: List[Leaf], group: Any, rank: int, size: int, device: torch.device):
        self.leaves, self.group, self.rank, self.size, self.device = leaves, group, rank, size, device
        self.by_id = {id(leaf.held): leaf for leaf in leaves}

    # -- what a gather moves ---------------------------------------------------
    def _piece(self, leaf: Leaf, i: Optional[int]) -> _Piece:
        """Leaf `leaf` whole (i None) or layer i of a stacked leaf."""
        spec = leaf.spec
        shape = leaf.shape if i is None else leaf.shape[1:]
        if spec.dim is not None and not (i is not None and spec.dim == 0):
            return _Piece(shape, leaf.dtype, spec.dim - (i is not None), 0, leaf.k, i)
        if spec.dim is None:
            return _Piece(shape, leaf.dtype, None, spec.owner, leaf.k, i)
        n = leaf.shape[0] // self.size  # a stacked leaf cut along [L]: layer i on rank i // n
        return _Piece(shape, leaf.dtype, None, i // n, leaf.k, i % n)

    def _source(self, p: _Piece) -> torch.Tensor:
        part = self.leaves[p.k].part
        return part if p.sel is None else part[p.sel]

    def _segments(self, pieces: Sequence[_Piece], itemsize: Callable[[_Piece], int], align: int):
        """Per rank, [(piece index, offset, elements)] of its segment, and
        the segment length (the longest rank's, in units of 1 byte when
        itemsize gives bytes, else of elements)."""
        segs: List[List[Tuple[int, int, int]]] = [[] for _ in range(self.size)]
        ends = [0] * self.size
        for j, p in enumerate(pieces):
            n = math.prod(p.shape)
            for r in (range(self.size) if p.dim is not None else (p.owner,)):
                elems = n // self.size if p.dim is not None else n
                segs[r].append((j, ends[r], elems))
                ends[r] = -(-(ends[r] + elems * itemsize(p)) // align) * align
        return segs, max(ends)

    def _slice_shape(self, p: _Piece) -> Tuple[int, ...]:
        if p.dim is None:
            return p.shape
        return tuple(n // self.size if d == p.dim else n for d, n in enumerate(p.shape))

    def _gather(self, pieces: Sequence[_Piece]) -> List[torch.Tensor]:
        if self.size == 1:
            # a view where no cast is needed: never the part itself, a leaf
            return [self._source(p).to(p.dtype).view(p.shape) for p in pieces]
        item = lambda p: p.dtype.itemsize  # noqa: E731
        segs, nbytes = self._segments(pieces, item, _ALIGN)
        mine = torch.zeros(nbytes, dtype=torch.uint8, device=self.device)
        for j, off, elems in segs[self.rank]:
            p = pieces[j]
            mine[off : off + elems * item(p)].view(p.dtype).copy_(self._source(p).reshape(-1))
        buf = tp_mod.all_gather(mine, self.group)
        got: List[List[torch.Tensor]] = [[] for _ in pieces]
        for r, seg in enumerate(segs):
            for j, off, elems in seg:
                p = pieces[j]
                at = r * nbytes + off
                got[j].append(buf[at : at + elems * item(p)].view(p.dtype).view(self._slice_shape(p)))
        return [torch.cat(parts, p.dim) if p.dim is not None else parts[0].clone() for p, parts in zip(pieces, got)]

    def _apply(self, pieces: List[_Piece], layer: bool) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    # -- the compute tree --------------------------------------------------------
    def tree(self, params: Any) -> Any:
        """`params` (the state's tree) with every leaf held in parts outside
        LAYERS gathered whole; the stacked layer leaves stay the parts that
        layer_gather recognises, the other leaves as they are."""
        outer = [leaf for leaf in self.leaves if not leaf.path.startswith(LAYERS)]
        whole: Dict[int, torch.Tensor] = {}
        for run in buckets(range(len(outer)), lambda j: math.prod(outer[j].shape)):
            got = self._apply([self._piece(outer[j], None) for j in run], False)
            whole.update({id(outer[j].held): t for j, t in zip(run, got)})

        return tree_map(lambda t: whole.get(id(t), t), params)

    def layer(self, layers: Dict[str, Any], i: int) -> Dict[str, Any]:
        """Layer i of the stacked tree `layers`: its leaves held in parts
        gathered in one call, the others indexed."""
        pieces: List[_Piece] = []

        def pick(t):
            leaf = self.by_id.get(id(t))
            if leaf is None:
                return t[i]
            pieces.append(self._piece(leaf, i))
            return len(pieces) - 1

        slots = tree_map(pick, layers)
        got = self._apply(pieces, True)
        counts["live_layers"] += 1
        counts["max_live_layers"] = max(counts["max_live_layers"], counts["live_layers"])
        weakref.finalize(got[0], _live_layer_freed)

        return tree_map(lambda x: got[x] if isinstance(x, int) else x, slots)


class Gatherer(_Gathers):
    """The compute tensors of a sharded state's trainable leaves, gathered
    over `group` on `device`, their gradients reduce-scattered back.
    `acc` (set by the step) holds one accumulator per leaf index, the shape
    of its master part, or None where this rank holds none."""

    def __init__(self, leaves: List[Leaf], group: Any, rank: int, size: int, device: torch.device):
        super().__init__(leaves, group, rank, size, device)
        self.anchor = torch.zeros((), device=device, requires_grad=True)
        self.acc: List[Optional[torch.Tensor]] = [None] * len(leaves)

    def _dest(self, p: _Piece) -> Optional[torch.Tensor]:
        acc = self.acc[p.k]
        return acc if acc is None or p.sel is None else acc[p.sel]

    def _scatter(self, pieces: Sequence[_Piece], grads: Sequence[Optional[torch.Tensor]]) -> None:
        if self.size == 1:
            for p, g in zip(pieces, grads):
                if g is not None:
                    self._dest(p).add_(g)
            return
        segs, n = self._segments(pieces, lambda p: 1, 1)
        flat = torch.zeros(self.size * n, dtype=torch.float32, device=self.device)
        for r, seg in enumerate(segs):
            for j, off, elems in seg:
                p, g = pieces[j], grads[j]
                if g is None:
                    continue
                if p.dim is not None:
                    w = p.shape[p.dim] // self.size
                    g = g.narrow(p.dim, r * w, w)
                flat[r * n + off : r * n + off + elems].view(g.shape).copy_(g)
        out = tp_mod.reduce_scatter(flat, self.group)
        for j, off, elems in segs[self.rank]:
            dest = self._dest(pieces[j])
            dest.add_(out[off : off + elems].view(dest.shape))

    def _apply(self, pieces: List[_Piece], layer: bool) -> Tuple[torch.Tensor, ...]:
        return _Gather.apply(self.anchor, self, tuple(pieces), layer)


class ServingGatherer(_Gathers):
    """The forward-only gather of a serving policy's tree (models/mla.py
    MLAPolicy over a mesh with fsdp > 1): every leaf held in parts in its
    serving dtype (int8 w_q / w_qt / table_q, their fp32 or bf16 scales,
    the float leaves), gathered as bytes, so each gathered leaf equals the
    one-process leaf bit for bit. No masters, no accumulators, no autograd
    Function: the decoder's layers one at a time inside llama.run_layers
    (prefill, every suffix evaluation and every decode step), the other
    leaves once a call (`tree`)."""

    def _apply(self, pieces: List[_Piece], layer: bool) -> Tuple[torch.Tensor, ...]:
        counts["layer_gathers" if layer else "gathers"] += 1
        return tuple(self._gather(pieces))

    def layer_bytes(self) -> Dict[str, int]:
        """The decoder's layer stack (LAYERS) on this rank: 'held', the
        bytes of the storages its parts lie in (each once: a view into a
        whole leaf would count the whole); 'stack', the whole stack's
        (fused, tp-local); 'unit', the largest stacked leaf one rank owns
        whole."""
        held, stack, unit, seen = 0, 0, 0, set()
        for leaf in self.leaves:
            if not leaf.path.startswith(LAYERS):
                continue
            nbytes = math.prod(leaf.shape) * leaf.dtype.itemsize
            stack += nbytes
            if leaf.spec.dim is None:
                unit = max(unit, nbytes)
            if leaf.part is not None and leaf.part.untyped_storage().data_ptr() not in seen:
                seen.add(leaf.part.untyped_storage().data_ptr())
                held += leaf.part.untyped_storage().nbytes()
        return {"held": held, "stack": stack, "unit": unit}


def serving_parts(params: Any, mesh: Any, tp_dim: Callable[[str, int], Optional[int]]) -> Tuple[Any, ServingGatherer]:
    """(this rank's tree, its ServingGatherer) for a serving tree over
    mesh's fsdp group. The tree is the one the rank serves (tp-local and
    fused, its K-major w_qt included), because that is the tensor a gather
    must give back bit for bit: each leaf is cut by parallel/sharding.plan,
    JAX's fsdp rule (the largest dim that fsdp divides, the dim tp_dim(path,
    ndim) names and a stacked leaf's [L] axis kept whole); a leaf with no
    such dim is owned whole by one rank. The tree holds this rank's parts
    (contiguous copies, or the leaf itself for its owner) and an empty
    placeholder where another rank owns a leaf; the caller frees the
    whole tree."""
    from mla_tpu_torch.parallel import sharding
    from mla_tpu_torch.utils.tree import map_with_path

    items = tree_items(params)

    def keep(path, shape):
        d = tp_dim(path, len(shape))
        return ({0} if path.startswith(LAYERS) else set()) | ({d} if d is not None else set())

    specs = sharding.plan([(p, tuple(t.shape), t.numel() * t.element_size()) for p, t in items], mesh.fsdp, keep)
    leaves, held = [], {}
    for k, (path, t) in enumerate(items):
        part = sharding.local_part(t, specs[path], mesh.fsdp_rank, mesh.fsdp)
        if part is not None and specs[path].dim is not None:
            part = part.clone(memory_format=torch.contiguous_format)
        held[path] = part if part is not None else t.new_empty(0)
        leaves.append(Leaf(path, specs[path], tuple(t.shape), t.dtype, part, held[path], k))
    device = items[0][1].device
    return (map_with_path(lambda path, _: held[path], params),
            ServingGatherer(leaves, mesh.fsdp_group, mesh.fsdp_rank, mesh.fsdp, device))


_ACTIVE: Optional[_Gathers] = None


@contextlib.contextmanager
def gathering(g: _Gathers) -> Iterator[None]:
    """Gather the layer stacks that `g` holds in parts inside the block."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, g
    try:
        yield
    finally:
        _ACTIVE = prev


def layer_gather(layers: Dict[str, Any]) -> Optional[Tuple[int, Callable[[int], Dict[str, Any]]]]:
    """(L, i -> layer i of `layers`) where the active gatherer holds leaves
    of the stacked tree `layers` in parts, else None."""
    g = _ACTIVE
    if g is None:
        return None
    held: List[Leaf] = []
    tree_map(lambda t: held.append(g.by_id[id(t)]) if id(t) in g.by_id else None, layers)
    if not held:
        return None
    return held[0].shape[0], lambda i: g.layer(layers, i)
