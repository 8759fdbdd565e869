"""The training step: gradient accumulation, clipping, the optimizer, step
count and EMA over a mesh of processes (one process by default); and the
visualization forward.

Counterpart of mla_tpu/training/strategy.py. `init_train_state` lays the
state out over the mesh (parallel/mesh.py; JAX's init_train_state and
shard_train_state, `use_tp` on when the mesh has a tp axis);
`make_train_step` returns train_step(state, batch) -> (state, metrics).

A rank holds every trainable leaf only in part, as GSPMD holds JAX's
fsdp-sharded leaves: its fsdp slice (parallel/sharding.plan), or the whole
leaf on its owner, of its tp slice (params.tp_local: JAX's `_TP_RULES`
split q/k/v/gate/up on the output dim, o/down on the input dim, the
embedding and the lm_head on the vocabulary; the whole leaf at tp 1). That
part is the master weight the optimizer steps and what state['params']
holds (an empty placeholder on the ranks that hold none of a leaf; the
frozen leaves whole). The step builds the compute tensors from the parts
(parallel/fsdp.py): the decoder's layers one at a time inside the layer
loop (llama.run_layers; under remat the backward gathers each again), the
other trainable leaves whole once per micro-batch; the decoder's layer
matrices in the decoder's compute dtype (bf16) where the caller asks for
it, every other leaf in its master's dtype. Each gather's backward
reduce-scatters the fp32 gradients back to the parts, into one
accumulator a part (the master's .grad for an fp32 master), where the
micro-batches' gradients sum: no whole weight or gradient of a leaf
outlives its use.

A step runs this rank's rows of each global micro-batch
(sharding.shard_batch by the data rank: the ranks of a tp group hold the
same rows and draw the same noise, t, FPS starts and heads' dropout) with
the global-batch reductions over the data group (parallel/collectives.py)
and the decoder's tp operations over the tp group (parallel/tensor.py).
With grad_accumulation_steps > 1 the rows are cut into that many
micro-batches along dim 0, their losses averaged, and the point
tokenizer's batch-norm state threads from one micro-batch to the next, as
the JAX lax.scan carry does. The reduce-scatters sum over the fsdp group;
the dp replicas of a part are then summed over the replica group (in fp32
buckets) and the sum divided by data world x accumulation. A leaf the tp
ranks hold whole already has its whole gradient on each of them
(copy_to_tp's backward all-reduced the gradients entering the
column-parallel products), so it is not summed over tp again. The step
takes the global norm of the sharded gradients (a tp-split leaf's squares
summed over the tp group, a whole one's counted once) and steps only its
own masters (Adafactor's statistics across a tp-split leaf, optim.py); the
next gather reads the updated parts. With remat each layer's forward runs
again in the backward, its gather and row-parallel all-reduces included,
in the same order on every rank. On one process, and at fsdp 1, the
gathers are the identity: the masters are the tree's own leaves and (on
one process) the optimizer the caller's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mla_tpu_torch.diffusion import gaussian as gd
from mla_tpu_torch.models import mla as mla_mod
from mla_tpu_torch.models import prismatic
from mla_tpu_torch.parallel import collectives
from mla_tpu_torch.parallel import fsdp
from mla_tpu_torch.parallel import mesh as mesh_mod
from mla_tpu_torch.parallel import sharding as shard_mod
from mla_tpu_torch.parallel import tensor as tp_mod
from mla_tpu_torch.params import tp_local, tree_items, tree_map
from mla_tpu_torch.training import optim as optim_mod
from mla_tpu_torch.training.optim import Optimizer
from mla_tpu_torch.utils.tree import map_with_path


@dataclass
class TrainConfig:
    """The JAX package's fields. The step reads grad_accumulation_steps,
    repeated_diffusion_steps, ema_decay and enable_gradient_checkpointing;
    `optimizer_settings()` gives optim.make_optimizer the rest but use_ema,
    which goes to init_train_state."""

    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    lr_scheduler_type: str = "constant"
    warmup_ratio: float = 0.0
    num_training_steps: int = 1000
    grad_accumulation_steps: int = 1
    repeated_diffusion_steps: int = 4
    stage: str = "pretrain"
    use_ema: bool = False
    ema_decay: float = 0.9999
    enable_gradient_checkpointing: bool = True

    def optimizer_settings(self) -> Dict[str, Any]:
        """optim.make_optimizer's keywords, from these fields."""
        return {"learning_rate": self.learning_rate, "weight_decay": self.weight_decay,
                "max_grad_norm": self.max_grad_norm, "lr_scheduler_type": self.lr_scheduler_type,
                "warmup_ratio": self.warmup_ratio, "num_training_steps": self.num_training_steps,
                "stage": self.stage}


def as_tensors(tree: Any, device) -> Any:
    """A batch of numpy arrays (or tensors) as tensors on `device`: integer
    arrays as int64 (token ids index the embedding), bool and float kept."""
    if isinstance(tree, dict):
        return {k: as_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    a = np.asarray(tree)
    t = torch.from_numpy(np.array(a))
    if a.dtype.kind in "iu":
        t = t.long()
    return t.to(device)


def _micro(tree: Any, accum: int, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _micro(v, accum, i) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dim() > 0:
        n = tree.shape[0] // accum
        return tree[i * n : (i + 1) * n]
    return tree


ROADMAP_TP_TRAIN = "ROADMAP.md queue 1, item 16 {}"


def check_tp(cfg: prismatic.MLAModelConfig, tp: int) -> None:
    """Raise unless the port can train `cfg`'s decoder over a tp group of
    `tp`: a llama decoder (phi keeps its q bias whole while q/w is split)
    whose head counts T divides (the port's layer splits whole heads)."""
    if tp <= 1:
        return
    if cfg.llm_family != "llama":
        raise NotImplementedError(f"a {cfg.llm_family} decoder over a tp group of {tp}: " + ROADMAP_TP_TRAIN.format(
            "(c): mla-phi, whose q bias is kept whole while q/w is split"))
    H, Hkv = cfg.llama.num_heads, cfg.llama.num_kv_heads
    if H % tp or Hkv % tp:
        raise NotImplementedError(f"{H} heads and {Hkv} kv heads over tp {tp}: T must divide both ("
                                  + ROADMAP_TP_TRAIN.format("(e): heads that T does not divide") + ")")


def init_train_state(params: Any, optimizer: Optimizer, model_state: Any, use_ema: bool = False, mesh: Any = None,
                     compute_dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The train state of `params` (the whole tree of leaf tensors),
    `optimizer` (optim.make_optimizer's over them, not yet stepped) and the
    model state, laid out over `mesh` (one process and no group when None).
    Under a tp axis a rank keeps its tp-local tree (params.tp_local; the
    caller frees the whole one). Each trainable leaf's master part on this
    rank (sharding.plan over the fsdp group on the tp-local shapes; the tp
    dim and Adafactor's factored dims of the whole leaf kept whole): at
    fsdp 1 the tree's own leaf, else a copy of this rank's slice of its tp
    slice, or of the whole tp slice on its owner; the optimizer over those
    parts (`optimizer` itself on one process); state['params'] the tree the
    step consumes: the master parts (an empty placeholder where another
    rank owns a leaf) and the frozen leaves. The step gathers the
    decoder's layer matrices in `compute_dtype` when given, every other
    leaf in its master's dtype. EMA parts with use_ema."""
    mesh = mesh if mesh is not None else mesh_mod.Mesh(1, 1, 1, rank=0)
    if any(optimizer.state_dict()["leaves"].values()):
        raise ValueError("init_train_state takes a fresh optimizer; load a checkpoint into the state instead")
    whole = dict(zip(optimizer.paths, optimizer.trainable))
    tp_dims = shard_mod.tp_split_dims([(p, t.shape) for p, t in tree_items(params)], mesh.tp)
    split: frozenset = frozenset()
    if mesh.tp > 1:
        params, split = tp_local(tree_map(lambda t: t.detach(), params), mesh)
        for path, leaf in tree_items(params):
            leaf.requires_grad_(path in whole)
    local = dict(tree_items(params))
    paths = [p for p in local if p in whole]
    adafactor = isinstance(optimizer, optim_mod.Adafactor)

    def keep(path, shape):
        dims = set(optim_mod.factored_dims(tuple(whole[path].shape)) or ()) if adafactor else set()
        return dims | ({tp_dims[path]} if tp_dims[path] is not None else set())

    specs = shard_mod.plan([(p, tuple(local[p].shape), local[p].numel() * local[p].element_size()) for p in paths],
                           mesh.fsdp, keep)
    fr, fs = mesh.fsdp_rank, mesh.fsdp

    def part(p: str) -> Optional[torch.Tensor]:
        got = shard_mod.local_part(local[p].detach(), specs[p], fr, fs)
        return got.clone().contiguous() if got is not None else None

    if fs == 1:
        masters = {p: local[p] for p in paths}
    else:
        masters = {p: part(p) for p in paths}
    if fs > 1 or mesh.tp > 1:
        optimizer = optimizer.over([masters[p] for p in optimizer.paths], mesh.fsdp_group,
                                   mesh.tp_group, [tp_dims[p] for p in optimizer.paths])
    held = {p: masters[p] if masters[p] is not None else local[p].new_empty(0) for p in paths}
    ema = frozen_ema = None
    if use_ema:
        ema = [part(p) for p in paths]
        frozen_ema = {p: t.detach().clone() for p, t in local.items() if p not in whole}
    leaves = [fsdp.Leaf(p, specs[p], tuple(local[p].shape), _compute_copy_dtype(p, local[p], compute_dtype),
                        masters[p], held[p], k) for k, p in enumerate(paths)]
    device = next(iter(local.values())).device if local else torch.device("cpu")
    tree = map_with_path(lambda path, leaf: held.get(path, leaf), params)
    shards = ShardedState(mesh, leaves, optimizer, ema, frozen_ema, tp_dims, split,
                          {p: tuple(whole[p].shape) for p in paths}, device)
    return {"params": tree, "optimizer": optimizer, "model_state": model_state, "step": 0, "shards": shards}


def make_train_step(cfg: prismatic.MLAModelConfig, train_cfg: TrainConfig, sched: gd.Schedule) -> Callable:
    """train_step(state, batch, generator=None, draws=None) -> (state,
    metrics) over init_train_state's state. `batch` is this rank's rows of
    the global batch (shard_batch; all of it on one process), numpy arrays
    or tensors (moved to the parameters' device); its leading dim must
    divide by grad_accumulation_steps. `generator` draws the global
    micro-batch's diffusion noise, t and FPS starts on every rank (each
    takes its rows); `draws`, one dict per global micro-batch of
    mla_train_loss's override_noise / override_t / fps_start, replaces
    them. metrics: the global batch's loss dict (averaged over
    micro-batches) and grad_norm, the global norm of the averaged
    gradients before clipping."""
    accum = train_cfg.grad_accumulation_steps
    rep = train_cfg.repeated_diffusion_steps if cfg.use_diff else 1

    def train_step(state: Dict[str, Any], batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                   draws: Optional[List[Dict[str, Any]]] = None):
        import torch.distributed as dist

        sh: ShardedState = state["shards"]
        mesh = sh.mesh
        world, rank = mesh.data_world, mesh.data_rank
        dev = sh.device
        batch = as_tensors(batch, dev)
        global_rows = batch["input_ids"].shape[0] // accum * world
        fwd_gen = generator
        if generator is not None and rank != 0:
            fwd_gen = torch.Generator(device=generator.device).manual_seed(
                (generator.initial_seed() + 0x9E3779B97F4A7C15 * rank) % (1 << 63))
        sh.zero_accumulators(sums=accum > 1 or world > 1)
        mstate, loss_sum = state["model_state"], None
        with collectives.batch_group(mesh.data_group), tp_mod.tp_group(mesh.tp_group, sh.tp_split), \
                fsdp.gathering(sh.gatherer):
            for i in range(accum):
                if draws is not None:
                    overrides = shard_mod.shard_batch(draws[i], rank, world, 1, rep)
                elif generator is not None:
                    overrides = shard_mod.shard_batch(mla_mod.draw_train_randomness(
                        cfg, sched, global_rows, generator, dev,
                        repeated_diffusion_steps=train_cfg.repeated_diffusion_steps), rank, world, 1, rep)
                else:
                    overrides = {}
                total, (loss_dict, mstate) = mla_mod.mla_train_loss(
                    sh.gatherer.tree(state["params"]), mstate, cfg, sched,
                    _micro(batch, accum, i) if accum > 1 else batch, fwd_gen,
                    repeated_diffusion_steps=train_cfg.repeated_diffusion_steps,
                    remat=train_cfg.enable_gradient_checkpointing, **overrides,
                )
                if total.requires_grad:  # not when no trained leaf is on the path (vlm-align, language-only)
                    total.backward()
                # rank 0's forward drew from the step's generator: every rank
                # continues from its state, so the next global draws agree
                if generator is not None and mesh.world > 1 and i + 1 < accum:
                    _sync_generator(generator, mesh)
                loss_dict = {k: v.detach() for k, v in loss_dict.items()}
                loss_sum = loss_dict if loss_sum is None else {k: loss_sum[k] + v for k, v in loss_dict.items()}
                del total
        sh.reduce_gradients(world * accum)
        keys = sorted(loss_sum)
        losses = torch.stack([loss_sum[k] for k in keys])
        if mesh.data_group is not None:
            dist.all_reduce(losses, group=mesh.data_group)
        metrics = dict(zip(keys, (losses / (world * accum)).unbind(0)))
        opt = sh.optimizer
        metrics["grad_norm"] = opt.global_norm()
        opt.step(metrics["grad_norm"])
        opt.zero_grad()
        if sh.ema is not None:
            d = train_cfg.ema_decay
            with torch.no_grad():
                for e, m in zip(sh.ema, sh.masters):
                    if e is not None:
                        e.mul_(d).add_(m, alpha=1 - d)
                params = dict(tree_items(state["params"]))
                for path, e in sh.frozen_ema.items():
                    e.mul_(d).add_(params[path], alpha=1 - d)
        return {**state, "model_state": mstate, "step": state["step"] + 1}, metrics

    return train_step


def make_visualize_step(cfg: prismatic.MLAModelConfig, sched: gd.Schedule) -> Callable:
    """viz_step(state, batch, generator) -> the generation heads' outputs:
    the training forward (noise, t and the FPS starts drawn from
    `generator`, remat off; the weights gathered as the step gathers them)
    without gradients, for the trainer's visualization cadence (JAX
    make_visualize_step)."""

    @torch.no_grad()
    def viz_step(state: Dict[str, Any], batch: Dict[str, Any], generator: Optional[torch.Generator] = None):
        sh: ShardedState = state["shards"]
        with tp_mod.tp_group(sh.mesh.tp_group, sh.tp_split), fsdp.gathering(sh.gatherer):
            return _viz(sh.gatherer.tree(state["params"]), state, as_tensors(batch, sh.device), generator)

    def _viz(params, state, b, generator):
        rows = b["input_ids"].shape[0]
        if cfg.use_diff:
            future = b["actions"][:, -cfg.action_horizon :, :].float()
            noise = torch.randn(future.shape, generator=generator, device=future.device)
            t = torch.randint(0, sched.num_timesteps, (rows,), generator=generator, device=future.device)
            b = {**b, "x": gd.q_sample(sched, future, t, noise), "t": t}
            b.pop("labels", None)
        outputs, _ = prismatic.vlm_forward(
            params, state["model_state"], cfg, b, training=True, use_diff=cfg.use_diff, generator=generator,
            remat=False, fps_start=mla_mod.fps_starts(cfg, None, rows, generator, b["input_ids"].device),
        )
        return outputs.get("generation_outputs", {})

    return viz_step


# --------------------------------------------------------------------------- #
# the sharded state
# --------------------------------------------------------------------------- #

def _compute_copy_dtype(path: str, leaf: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.dtype:
    """The dtype the gather hands a leaf out in: the decoder's compute dtype
    for its layer matrices (every use casts them to it first), else the
    leaf's own."""
    if (compute_dtype is not None and path.startswith(fsdp.LAYERS) and path.endswith("/w")
            and leaf.is_floating_point()):
        return compute_dtype
    return leaf.dtype


class ShardedState:
    """The sharded half of a train state over a mesh: the gatherer that
    builds the compute tensors from this rank's master parts
    (parallel/fsdp.py), whose leaves (in the optimizer's order) are the one
    record of each trainable leaf's path, Spec, tp-local whole shape and
    master part (None where another rank owns the leaf); the optimizer over
    the master parts; EMA parts; per leaf of the tree its tp split dim
    (sharding.tp_split_dims, None: held whole), the TP_RULES keys the ranks
    hold in part and the trainable leaves' whole shapes."""

    def __init__(self, mesh: Any, leaves: List[fsdp.Leaf], optimizer: Optimizer,
                 ema: Optional[List[Optional[torch.Tensor]]], frozen_ema: Optional[Dict[str, torch.Tensor]],
                 tp_dims: Dict[str, Optional[int]], tp_split: frozenset, whole_shapes: Dict[str, Tuple[int, ...]],
                 device: torch.device):
        self.mesh, self.optimizer = mesh, optimizer
        self.ema, self.frozen_ema = ema, frozen_ema
        self.tp_dims, self.tp_split, self.whole_shapes = tp_dims, tp_split, whole_shapes
        self.device = device
        self.gatherer = fsdp.Gatherer(leaves, mesh.fsdp_group, mesh.fsdp_rank, mesh.fsdp, device)

    @property
    def leaves(self) -> List[fsdp.Leaf]:
        return self.gatherer.leaves

    @property
    def paths(self) -> List[str]:
        return [leaf.path for leaf in self.leaves]

    @property
    def shapes(self) -> List[Tuple[int, ...]]:
        return [leaf.shape for leaf in self.leaves]

    @property
    def masters(self) -> List[Optional[torch.Tensor]]:
        return [leaf.part for leaf in self.leaves]

    @property
    def specs(self) -> Dict[str, shard_mod.Spec]:
        return {leaf.path: leaf.spec for leaf in self.leaves}

    # -- gradients -----------------------------------------------------------
    def zero_accumulators(self, sums: bool) -> None:
        """A zero accumulator for each master part this rank holds: fp32,
        or the master's own dtype where nothing is summed (one micro-batch
        on one data rank) and the gather hands the leaf out in it."""
        self.gatherer.acc = [
            None if leaf.part is None else torch.zeros(
                leaf.part.shape, dtype=leaf.part.dtype if not sums and leaf.part.dtype == leaf.dtype else torch.float32,
                device=leaf.part.device)
            for leaf in self.leaves]

    def reduce_gradients(self, divisor: int) -> None:
        """Sum the accumulators (the step's reduce-scattered gradients) over
        the replica group in fp32 buckets, divide them by `divisor` and hand
        each master its own as .grad (in the master's dtype)."""
        acc, self.gatherer.acc = self.gatherer.acc, [None] * len(self.leaves)
        held = [k for k, a in enumerate(acc) if a is not None]
        if self.mesh.replica_group is not None:
            for run in fsdp.buckets(held, lambda k: acc[k].numel()):
                flat = tp_mod.all_reduce(torch.cat([acc[k].reshape(-1) for k in run]), self.mesh.replica_group)
                off = 0
                for k in run:
                    acc[k].copy_(flat[off : off + acc[k].numel()].view(acc[k].shape))
                    off += acc[k].numel()
        for k in held:
            m = self.leaves[k].part
            m.grad = acc[k].div_(divisor).to(m.dtype)

    def _fsdp(self) -> bool:
        return self.mesh.fsdp > 1

    def layer_bytes(self, params: Any) -> Dict[str, Any]:
        """The decoder's layer stack (fsdp.LAYERS) on this rank: 'held',
        the bytes of the tensors state['params'] keeps for it (each storage
        once); 'stack', the whole stack's (tp-local, in the masters'
        dtypes); 'unit', the largest stacked leaf that one rank owns whole;
        'whole_copies', the cut leaves this rank holds a whole copy of."""
        held, seen = 0, set()
        for path, t in tree_items(params):
            if path.startswith(fsdp.LAYERS) and t.numel() and t.untyped_storage().data_ptr() not in seen:
                seen.add(t.untyped_storage().data_ptr())
                held += t.untyped_storage().nbytes()
        trained = {leaf.path: leaf for leaf in self.leaves}
        stack, unit, copies = 0, 0, []
        for path, t in tree_items(params):
            if not path.startswith(fsdp.LAYERS):
                continue
            leaf = trained.get(path)
            nbytes = (math.prod(leaf.shape) if leaf is not None else t.numel()) * t.element_size()
            stack += nbytes
            if leaf is not None and leaf.spec.dim is None:
                unit = max(unit, nbytes)
            if leaf is not None and leaf.spec.dim is not None and tuple(t.shape) == leaf.shape:
                copies.append(path)
        return {"held": held, "stack": stack, "unit": unit, "whole_copies": copies}

    def _fsdp_whole(self, k: int, t: Any, dim: Optional[int]) -> Any:
        """Leaf k's tensor whole over the fsdp group, on every rank of it:
        `t` is this rank's piece, cut along `dim` (None: not cut, a 0-d
        count), or for a leaf owned whole the owner's tensor (or dict of
        tensors; None elsewhere), broadcast to host memory."""
        import torch.distributed as dist

        spec = self.leaves[k].spec
        if not self._fsdp():
            return t
        if spec.dim is None:
            obj = [_to_host(t)]
            dist.broadcast_object_list(obj, src=self.mesh.fsdp_peer(spec.owner), group=self.mesh.fsdp_group,
                                       device=self.device)
            return obj[0]
        if dim is None:
            return t
        return tp_mod.all_gather(t.detach(), self.mesh.fsdp_group, dim)

    def _tp_whole(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """t whole over the tp group, cut along `dim` (None: held whole)."""
        if dim is None or self.mesh.tp == 1:
            return t
        return tp_mod.all_gather(t.detach(), self.mesh.tp_group, dim)

    def _host0(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        return t.detach().to("cpu", copy=True) if self.mesh.rank == 0 else None

    def _state_dims(self, k: int, name: str, t: torch.Tensor) -> Tuple[Optional[int], Optional[int]]:
        """Where leaf k's fsdp cut and tp split lie in its optimizer state
        tensor `name` (None: not cut; a factored statistic that reduces over
        the tp-split dim is the same on every tp rank)."""
        path = self.leaves[k].path
        d, td = self.leaves[k].spec.dim, self.tp_dims[path]
        shape = self.whole_shapes[path]
        if t.dim() == 0:
            return None, None
        if t.dim() == len(shape):
            return d, td
        d1, d0 = optim_mod.factored_dims(shape)
        removed = d0 if name == "v_row" else d1

        def shift(dim):
            return None if dim is None or dim == removed else dim - (1 if removed < dim else 0)

        return shift(d), shift(td)

    # -- checkpoints -----------------------------------------------------------
    def host_state(self, train_state: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """A one-device run's checkpoint blob, gathered on rank 0 (None on
        the other ranks, which take part in the gathers): the whole masters
        as 'params' (gathered over fsdp, then over tp), the optimizer's
        state_dict of whole leaves, EMA."""
        trained = set(self.paths)
        whole = {}
        for k, leaf in enumerate(self.leaves):
            m = self._fsdp_whole(k, leaf.part, leaf.spec.dim)
            whole[leaf.path] = self._host0(self._tp_whole(m, self.tp_dims[leaf.path]))
        opt = self.optimizer.state_dict()
        leaves = {}
        for k, leaf in enumerate(self.leaves):
            path = leaf.path
            mine = opt["leaves"].get(path, {}) if leaf.part is not None else None
            if leaf.spec.dim is None:
                st = self._fsdp_whole(k, mine, None)
            else:
                st = {name: self._fsdp_whole(k, v, self._state_dims(k, name, v)[0]) for name, v in sorted(mine.items())}
            leaves[path] = {name: self._host0(self._tp_whole(v, self._state_dims(k, name, v)[1]))
                            for name, v in sorted(st.items())}
        frozen = {path: self._host0(self._tp_whole(t, self.tp_dims[path]))
                  for path, t in tree_items(train_state["params"]) if path not in trained}
        ema = None
        if self.ema is not None:
            ema = {leaf.path: self._host0(self._tp_whole(self._fsdp_whole(k, self.ema[k], leaf.spec.dim),
                                                         self.tp_dims[leaf.path]))
                   for k, leaf in enumerate(self.leaves)}
            ema.update({path: self._host0(self._tp_whole(t, self.tp_dims[path]))
                        for path, t in self.frozen_ema.items()})
        if self.mesh.rank != 0:
            return None
        whole.update(frozen)
        out = {
            "params": map_with_path(lambda p, t: whole[p], train_state["params"]),
            "opt_state": {"count": opt["count"], "leaves": leaves},
            "model_state": tree_map(lambda t: t.detach().to("cpu", copy=True), train_state["model_state"]),
            "step": int(train_state["step"]),
        }
        if ema is not None:
            out["ema_params"] = map_with_path(lambda p, t: ema[p], train_state["params"])
        return out

    def load(self, blob: Dict[str, Any], train_state: Dict[str, Any]) -> None:
        """Copy a one-device checkpoint blob (whole leaves, any mesh's save)
        into this rank's frozen leaves, master parts, optimizer state and
        EMA: cut by this mesh's tp rule, then by its fsdp plan."""
        saved = dict(tree_items(blob["params"]))
        trained = {leaf.path: leaf for leaf in self.leaves}
        T, tr = self.mesh.tp, self.mesh.tp_rank
        fr, fs = self.mesh.fsdp_rank, self.mesh.fsdp

        def tp_cut(path: str, t: torch.Tensor, dim: Optional[int] = -1) -> torch.Tensor:
            return shard_mod.tp_part(t, self.tp_dims[path] if dim == -1 else dim, tr, T)

        with torch.no_grad():
            for path, t in tree_items(train_state["params"]):
                s = tp_cut(path, saved[path])
                if path in trained:  # the tree holds this rank's part (an empty placeholder: none)
                    s = shard_mod.local_part(s, trained[path].spec, fr, fs)
                shape = tuple(s.shape) if s is not None else (0,)
                if shape != tuple(t.shape):
                    raise ValueError(f"params/{path}: checkpoint {shape} (this rank's part), live {tuple(t.shape)}")
                if path not in trained:
                    t.copy_(s)
            held = {}
            ema_saved = dict(tree_items(blob["ema_params"])) if "ema_params" in blob else {}
            for k, leaf in enumerate(self.leaves):
                if leaf.part is None:
                    continue
                path, spec = leaf.path, leaf.spec
                leaf.part.copy_(shard_mod.local_part(tp_cut(path, saved[path]), spec, fr, fs))
                held[path] = {}
                for name, v in blob["opt_state"]["leaves"][path].items():
                    fd, td = self._state_dims(k, name, v)
                    v = tp_cut(path, v, td)
                    held[path][name] = v if fd is None else shard_mod.local_part(v, shard_mod.Spec(dim=fd), fr, fs)
                if self.ema is not None:
                    self.ema[k].copy_(shard_mod.local_part(tp_cut(path, ema_saved[path]), spec, fr, fs))
            self.optimizer.load_state_dict({"count": blob["opt_state"]["count"], "leaves": held})
            if self.frozen_ema is not None:
                for path, t in self.frozen_ema.items():
                    t.copy_(tp_cut(path, ema_saved[path]))

    def optimizer_bytes(self) -> Dict[str, int]:
        """This rank's bytes of master parts and optimizer state, and the
        largest leaf it holds whole ('unit': masters + state)."""
        state = self.optimizer.state_dict()["leaves"]
        held, unit = 0, 0
        for leaf in self.leaves:
            m = leaf.part
            if m is None:
                continue
            b = m.numel() * m.element_size() + sum(v.numel() * v.element_size()
                                                   for v in state.get(leaf.path, {}).values())
            held += b
            if leaf.spec.dim is None:
                unit = max(unit, b)
        return {"held": held, "unit": unit}


def _to_host(obj: Any) -> Any:
    """Tensors (in dicts) copied to host memory."""
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj.detach().to("cpu", copy=True) if isinstance(obj, torch.Tensor) else obj


def _sync_generator(gen: torch.Generator, mesh: Any) -> None:
    """Give every rank rank 0's generator state."""
    import torch.distributed as dist

    st = gen.get_state()
    dev = torch.device("cuda", torch.cuda.current_device()) if gen.device.type == "cuda" else torch.device("cpu")
    buf = st.to(dev)
    dist.broadcast(buf, src=0, group=mesh.group)
    gen.set_state(buf.cpu())
