"""The training step: gradient accumulation, clipping, the optimizer, step
count and EMA over a mesh of processes (one process by default); and the
visualization forward.

Counterpart of mla_tpu/training/strategy.py. `init_train_state` lays the
state out over the mesh (parallel/mesh.py; JAX's init_train_state and
shard_train_state, `use_tp` on when the mesh has a tp axis);
`make_train_step` returns train_step(state, batch) -> (state, metrics).

Each rank keeps its compute parameters whole over fsdp: its tp-local tree
(params.tp_local: JAX's `_TP_RULES` split q/k/v/gate/up on the output
dim, o/down on the input dim, the embedding and the lm_head on the
vocabulary; the whole tree at tp 1), the decoder's layer matrices in the
decoder's compute dtype (bf16) where the tree holds fp32 masters and the
caller asks for it, every other leaf as the tree holds it. The master
weights, the optimizer state and the reduced gradients are sharded over
the fsdp group (parallel/sharding.py): a rank's master part is its fsdp
slice of its tp slice. A step runs this rank's rows of each global
micro-batch (sharding.shard_batch by the data rank: the ranks of a tp
group hold the same rows and draw the same noise, t, FPS starts and
heads' dropout) with the global-batch reductions over the data group
(parallel/collectives.py) and the decoder's tp operations over the tp
group (parallel/tensor.py). With grad_accumulation_steps > 1 the rows are
cut into that many micro-batches along dim 0; their gradients are summed
in fp32 (in .grad itself for fp32 leaves, in an fp32 buffer for the
others), their losses averaged, and the point tokenizer's batch-norm
state threads from one micro-batch to the next, as the JAX lax.scan
carry does. The gradients are then all-reduced over the data group in
fp32 buckets and divided by data world x accumulation (an all-reduce,
then each rank keeps its slice: one collective whatever the cut dim). A
leaf the tp ranks hold whole already has its whole gradient on each of
them (copy_to_tp's backward all-reduced the gradients entering the
column-parallel products), so it is not summed over tp again. The step
takes the global norm of the sharded gradients (a tp-split leaf's squares
summed over the tp group, a whole one's counted once), steps only its own
masters (Adafactor's statistics across a tp-split leaf, optim.py), and
re-assembles the compute parameters on every rank (all-gather of the
fsdp slices, broadcast of the leaves owned whole, in buckets). The layer
loop (llama.run_layers) is untouched: with remat each layer's forward
runs again in the backward, its row-parallel all-reduces included, in
the same order on every rank of the tp group, as Megatron's does. On one
process there is no collective: the masters are the tree's own leaves and
the optimizer the caller's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from mla_tpu_torch.diffusion import gaussian as gd
from mla_tpu_torch.models import mla as mla_mod
from mla_tpu_torch.models import prismatic
from mla_tpu_torch.parallel import collectives
from mla_tpu_torch.parallel import mesh as mesh_mod
from mla_tpu_torch.parallel import sharding as shard_mod
from mla_tpu_torch.parallel import tensor as tp_mod
from mla_tpu_torch.params import tp_local, tree_items, tree_leaves, tree_map
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
    Under a tp axis the compute tree is this rank's tp-local tree
    (params.tp_local; the caller frees the whole one). Each trainable
    leaf's master part on this rank (sharding.plan over the fsdp group on
    the tp-local shapes; the tp dim and Adafactor's factored dims of the
    whole leaf kept whole): on one process the tree's own leaf, else a
    copy of this rank's slice of its tp slice, or of the whole tp slice on
    its owner; the optimizer over those parts (`optimizer` itself on one
    process); state['params'] the compute tensors (the decoder's layer
    matrices in `compute_dtype` when given, else the masters themselves);
    EMA parts with use_ema."""
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
    compute: Dict[str, torch.Tensor] = {}

    def swap(path, leaf):
        if path not in whole:
            return leaf
        dt = _compute_copy_dtype(path, leaf, compute_dtype)
        compute[path] = leaf.detach().to(dt).requires_grad_(True) if dt != leaf.dtype else leaf
        return compute[path]

    ema = frozen_ema = None
    if use_ema:
        ema = [part(p) for p in paths]
        frozen_ema = {p: t.detach().clone() for p, t in local.items() if p not in whole}
    tree = map_with_path(swap, params)
    shards = ShardedState(mesh, paths, specs, [compute[p] for p in paths], [masters[p] for p in paths], optimizer,
                          ema, frozen_ema, tp_dims, split, {p: tuple(whole[p].shape) for p in paths})
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
        leaves = sh.compute
        dev = leaves[0].device
        batch = as_tensors(batch, dev)
        global_rows = batch["input_ids"].shape[0] // accum * world
        fwd_gen = generator
        if generator is not None and rank != 0:
            fwd_gen = torch.Generator(device=generator.device).manual_seed(
                (generator.initial_seed() + 0x9E3779B97F4A7C15 * rank) % (1 << 63))
        for p in leaves:
            p.grad = None
        # fp32 leaves sum their micro-batch gradients in .grad (backward adds
        # into it); the others in an fp32 buffer
        acc = ([None if p.dtype == torch.float32 else torch.zeros(p.shape, dtype=torch.float32, device=dev)
                for p in leaves] if accum > 1 else None)
        mstate, loss_sum = state["model_state"], None
        with collectives.batch_group(mesh.data_group), tp_mod.tp_group(mesh.tp_group, sh.tp_split):
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
                    state["params"], mstate, cfg, sched, _micro(batch, accum, i) if accum > 1 else batch, fwd_gen,
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
                if acc is not None:
                    for a, p in zip(acc, leaves):
                        if a is not None and p.grad is not None:
                            a += p.grad.float()
                            p.grad = None
        sh.reduce_gradients(acc, world * accum)
        del acc
        keys = sorted(loss_sum)
        losses = torch.stack([loss_sum[k] for k in keys])
        if mesh.data_group is not None:
            dist.all_reduce(losses, group=mesh.data_group)
        metrics = dict(zip(keys, (losses / (world * accum)).unbind(0)))
        opt = sh.optimizer
        metrics["grad_norm"] = opt.global_norm()
        opt.step(metrics["grad_norm"])
        opt.zero_grad()
        sh.assemble()
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
    `generator`, remat off) without gradients, for the trainer's
    visualization cadence (JAX make_visualize_step)."""

    @torch.no_grad()
    def viz_step(state: Dict[str, Any], batch: Dict[str, Any], generator: Optional[torch.Generator] = None):
        params = state["params"]
        b = as_tensors(batch, tree_leaves(params)[0].device)
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

BUCKET_ELEMS = 1 << 25  # elements per gradient all-reduce (128 MiB of fp32) and per re-assembly gather


def _buckets(ks: List[int], numel: Callable[[int], int]) -> Iterator[List[int]]:
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


def _compute_copy_dtype(path: str, leaf: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.dtype:
    """The dtype a rank keeps the whole leaf in: the decoder's compute dtype
    for its layer matrices (every use casts them to it first), else the
    leaf's own."""
    if (compute_dtype is not None and path.startswith("llm_backbone/layers/") and path.endswith("/w")
            and leaf.is_floating_point()):
        return compute_dtype
    return leaf.dtype


class ShardedState:
    """The sharded half of a train state over a mesh: per trainable leaf
    (in the optimizer's order) its path, Spec, compute tensor (in
    state['params']; tp-local) and this rank's master part (None where
    another rank owns the leaf); the optimizer over the master parts; EMA
    parts; per leaf of the tree its tp split dim (sharding.tp_split_dims,
    None: held whole), the TP_RULES keys the ranks hold in part and the
    trainable leaves' whole shapes."""

    def __init__(self, mesh: Any, paths: List[str], specs: Dict[str, shard_mod.Spec], compute: List[torch.Tensor],
                 masters: List[Optional[torch.Tensor]], optimizer: Optimizer,
                 ema: Optional[List[Optional[torch.Tensor]]], frozen_ema: Optional[Dict[str, torch.Tensor]],
                 tp_dims: Dict[str, Optional[int]], tp_split: frozenset, whole_shapes: Dict[str, Tuple[int, ...]]):
        self.mesh, self.paths, self.specs = mesh, paths, specs
        self.compute, self.masters, self.optimizer = compute, masters, optimizer
        self.ema, self.frozen_ema = ema, frozen_ema
        self.shapes = [tuple(c.shape) for c in compute]
        self.tp_dims, self.tp_split, self.whole_shapes = tp_dims, tp_split, whole_shapes
        self.device = compute[0].device if compute else torch.device("cpu")

    # -- collectives ---------------------------------------------------------
    def _fsdp(self) -> bool:
        return self.mesh.fsdp > 1

    def reduce_gradients(self, acc: Optional[List[Optional[torch.Tensor]]], divisor: int) -> None:
        """Sum this rank's gradients (acc[k] where the step accumulated in a
        buffer, else the compute leaf's .grad) over the data group in fp32
        buckets, divide, and hand each master part its slice (in the
        master's dtype). Each gradient is copied into its bucket and freed
        (its .grad and its buffer) as the bucket fills: no whole fp32
        gradient beyond the buffers and one bucket exists."""
        import torch.distributed as dist

        dev = self.compute[0].device
        for run in _buckets(list(range(len(self.paths))), lambda k: self.compute[k].numel()):
            flat = torch.empty(sum(self.compute[k].numel() for k in run), dtype=torch.float32, device=dev)
            off = 0
            for k in run:
                c = self.compute[k]
                src = acc[k] if acc is not None and acc[k] is not None else c.grad
                view = flat[off : off + c.numel()]
                if src is None:
                    view.zero_()
                else:
                    view.copy_(src.reshape(-1))
                c.grad = None
                if acc is not None:
                    acc[k] = None
                off += c.numel()
            if self.mesh.data_group is not None:
                dist.all_reduce(flat, group=self.mesh.data_group)
            flat.div_(divisor)
            off = 0
            for k in run:
                size = self.compute[k].numel()
                if self.masters[k] is not None:
                    g = flat[off : off + size].view(self.shapes[k])
                    part = shard_mod.local_part(g, self.specs[self.paths[k]], self.mesh.fsdp_rank, self.mesh.fsdp)
                    self.masters[k].grad = part.to(self.masters[k].dtype).contiguous()
                off += size

    def assemble(self) -> None:
        """Copy the updated masters into every rank's compute tensors (whole
        over fsdp, tp-local):
        slices are all-gathered, owned leaves broadcast by their owner,
        packed per dtype (and owner) in buckets of BUCKET_ELEMS."""
        import torch.distributed as dist

        with torch.no_grad():
            if not self._fsdp():
                for c, m in zip(self.compute, self.masters):
                    if c is not m:
                        c.copy_(m)
                return
            fs = self.mesh.fsdp
            cut = [k for k, p in enumerate(self.paths) if self.specs[p].dim is not None]
            for dt in sorted({self.compute[k].dtype for k in cut}, key=str):
                for ks in _buckets([k for k in cut if self.compute[k].dtype == dt], lambda k: self.compute[k].numel()):
                    dims = [self.specs[self.paths[k]].dim for k in ks]
                    mine = torch.cat([self.masters[k].to(dt).movedim(d, 0).reshape(-1) for k, d in zip(ks, dims)])
                    parts = [torch.empty_like(mine) for _ in range(fs)]
                    dist.all_gather(parts, mine, group=self.mesh.fsdp_group)
                    off = 0
                    for k, d in zip(ks, dims):
                        moved = self.compute[k].movedim(d, 0)
                        size = moved.numel() // fs
                        shape = (moved.shape[0] // fs,) + tuple(moved.shape[1:])
                        self.compute[k].copy_(torch.cat([p[off : off + size].view(shape) for p in parts], 0).movedim(0, d))
                        off += size
            owned = [k for k, p in enumerate(self.paths) if self.specs[p].dim is None]
            for owner in range(fs):
                for dt in sorted({self.compute[k].dtype for k in owned}, key=str):
                    mine = [k for k in owned if self.specs[self.paths[k]].owner == owner and self.compute[k].dtype == dt]
                    for ks in _buckets(mine, lambda k: self.compute[k].numel()):
                        if owner == self.mesh.fsdp_rank:
                            flat = torch.cat([self.masters[k].to(dt).reshape(-1) for k in ks])
                        else:
                            flat = torch.empty(sum(self.compute[k].numel() for k in ks), dtype=dt,
                                               device=self.compute[ks[0]].device)
                        dist.broadcast(flat, src=self.mesh.fsdp_peer(owner), group=self.mesh.fsdp_group)
                        off = 0
                        for k in ks:
                            c = self.compute[k]
                            c.copy_(flat[off : off + c.numel()].view(c.shape))
                            off += c.numel()

    def _fsdp_whole(self, k: int, t: Any, dim: Optional[int]) -> Any:
        """Leaf k's tensor whole over the fsdp group, on every rank of it:
        `t` is this rank's piece, cut along `dim` (None: not cut, a 0-d
        count), or for a leaf owned whole the owner's tensor (or dict of
        tensors; None elsewhere), broadcast to host memory."""
        import torch.distributed as dist

        spec = self.specs[self.paths[k]]
        if not self._fsdp():
            return t
        if spec.dim is None:
            obj = [_to_host(t)]
            dist.broadcast_object_list(obj, src=self.mesh.fsdp_peer(spec.owner), group=self.mesh.fsdp_group,
                                       device=self.device)
            return obj[0]
        if dim is None:
            return t
        return _all_gather_cat(t, self.mesh.fsdp_group, dim, self.device)

    def _tp_whole(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """t whole over the tp group, cut along `dim` (None: held whole)."""
        if dim is None or self.mesh.tp == 1:
            return t
        return _all_gather_cat(t, self.mesh.tp_group, dim, self.device)

    def _host0(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        return t.detach().to("cpu", copy=True) if self.mesh.rank == 0 else None

    def _state_dims(self, k: int, name: str, t: torch.Tensor) -> Tuple[Optional[int], Optional[int]]:
        """Where leaf k's fsdp cut and tp split lie in its optimizer state
        tensor `name` (None: not cut; a factored statistic that reduces over
        the tp-split dim is the same on every tp rank)."""
        path = self.paths[k]
        d, td = self.specs[path].dim, self.tp_dims[path]
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
        for k, path in enumerate(self.paths):
            m = self._fsdp_whole(k, self.masters[k], self.specs[path].dim)
            whole[path] = self._host0(self._tp_whole(m, self.tp_dims[path]))
        opt = self.optimizer.state_dict()
        leaves = {}
        for k, path in enumerate(self.paths):
            mine = opt["leaves"].get(path, {}) if self.masters[k] is not None else None
            if self.specs[path].dim is None:
                st = self._fsdp_whole(k, mine, None)
            else:
                st = {name: self._fsdp_whole(k, v, self._state_dims(k, name, v)[0]) for name, v in sorted(mine.items())}
            leaves[path] = {name: self._host0(self._tp_whole(v, self._state_dims(k, name, v)[1]))
                            for name, v in sorted(st.items())}
        frozen = {path: self._host0(self._tp_whole(t, self.tp_dims[path]))
                  for path, t in tree_items(train_state["params"]) if path not in trained}
        ema = None
        if self.ema is not None:
            ema = {path: self._host0(self._tp_whole(self._fsdp_whole(k, self.ema[k], self.specs[path].dim),
                                                    self.tp_dims[path])) for k, path in enumerate(self.paths)}
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
        into this rank's compute tensors, master parts, optimizer state and
        EMA: cut by this mesh's tp rule, then by its fsdp plan."""
        saved = dict(tree_items(blob["params"]))
        live = dict(tree_items(train_state["params"]))
        T, tr = self.mesh.tp, self.mesh.tp_rank

        def tp_cut(path: str, t: torch.Tensor, dim: Optional[int] = -1) -> torch.Tensor:
            return shard_mod.tp_part(t, self.tp_dims[path] if dim == -1 else dim, tr, T)

        with torch.no_grad():
            for path, t in live.items():
                s = tp_cut(path, saved[path])
                if tuple(s.shape) != tuple(t.shape):
                    raise ValueError(f"params/{path}: checkpoint {tuple(s.shape)} (this rank's part), live "
                                     f"{tuple(t.shape)}")
                t.copy_(s)
            fr, fs = self.mesh.fsdp_rank, self.mesh.fsdp
            held = {}
            ema_saved = dict(tree_items(blob["ema_params"])) if "ema_params" in blob else {}
            for k, path in enumerate(self.paths):
                if self.masters[k] is None:
                    continue
                spec = self.specs[path]
                self.masters[k].copy_(shard_mod.local_part(tp_cut(path, saved[path]), spec, fr, fs))
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
        for k, path in enumerate(self.paths):
            m = self.masters[k]
            if m is None:
                continue
            b = m.numel() * m.element_size() + sum(v.numel() * v.element_size() for v in state.get(path, {}).values())
            held += b
            if self.specs[path].dim is None:
                unit = max(unit, b)
        return {"held": held, "unit": unit}


def _all_gather_cat(t: torch.Tensor, group: Any, dim: int, device: torch.device) -> torch.Tensor:
    """The group's pieces of a tensor concatenated along `dim`, on every
    rank: through host memory over gloo (which gathers no CUDA tensor), on
    `device` over NCCL."""
    import torch.distributed as dist

    src = t.detach().contiguous()
    src = src.cpu() if dist.get_backend(group) == "gloo" else src.to(device)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim)


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
