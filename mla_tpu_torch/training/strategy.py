"""The training step: gradient accumulation, clipping, the optimizer, step
count and EMA, on one device; and the visualization forward.

Counterpart of mla_tpu/training/strategy.py without the mesh: sharding
(FSDP) is not ported yet. `make_train_step` returns train_step(state,
batch) -> (state, metrics). With grad_accumulation_steps > 1 the batch is
cut into that many micro-batches along dim 0; their gradients are summed in
fp32 (in .grad itself for fp32 leaves, in an fp32 buffer for the others)
and averaged, their losses averaged, and the point tokenizer's batch-norm
state threads from one micro-batch to the next, as the JAX lax.scan carry
does. The parameters are updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from mla_tpu_torch.diffusion import gaussian as gd
from mla_tpu_torch.models import mla as mla_mod
from mla_tpu_torch.models import prismatic
from mla_tpu_torch.params import tree_leaves, tree_map
from mla_tpu_torch.training.optim import Optimizer


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


def init_train_state(params: Any, optimizer: Optimizer, model_state: Any, use_ema: bool = False) -> Dict[str, Any]:
    state = {"params": params, "optimizer": optimizer, "model_state": model_state, "step": 0}
    if use_ema:
        state["ema_params"] = tree_map(lambda p: p.detach().clone(), params)
    return state


def make_train_step(
    cfg: prismatic.MLAModelConfig, train_cfg: TrainConfig, optimizer: Optimizer, sched: gd.Schedule,
) -> Callable:
    """train_step(state, batch, generator=None, draws=None) -> (state,
    metrics). `batch` holds numpy arrays or tensors (moved to the
    parameters' device); its leading dim must divide by
    grad_accumulation_steps. `generator` draws the diffusion noise, t and
    the FPS starts; `draws`, one dict per micro-batch of mla_train_loss's
    override_noise / override_t / fps_start, replaces them. metrics: the
    loss dict (averaged over micro-batches) and grad_norm, the global norm
    of the averaged gradients before clipping."""
    accum = train_cfg.grad_accumulation_steps

    def train_step(state: Dict[str, Any], batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                   draws: Optional[List[Dict[str, Any]]] = None):
        params = state["params"]
        leaves = [p for p in tree_leaves(params) if p.requires_grad]
        batch = as_tensors(batch, leaves[0].device)
        optimizer.zero_grad()
        # fp32 leaves sum their micro-batch gradients in .grad (backward adds
        # into it); the others in an fp32 buffer
        acc = ([None if p.dtype == torch.float32 else torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves] if accum > 1 else None)
        mstate, loss_sum = state["model_state"], None
        for i in range(accum):
            mbatch = _micro(batch, accum, i) if accum > 1 else batch
            total, (loss_dict, mstate) = mla_mod.mla_train_loss(
                params, mstate, cfg, sched, mbatch, generator,
                repeated_diffusion_steps=train_cfg.repeated_diffusion_steps,
                remat=train_cfg.enable_gradient_checkpointing, **(draws[i] if draws else {}),
            )
            if total.requires_grad:  # not when no trained leaf is on the path (vlm-align, language-only)
                total.backward()
            loss_dict = {k: v.detach() for k, v in loss_dict.items()}
            loss_sum = loss_dict if loss_sum is None else {k: loss_sum[k] + v for k, v in loss_dict.items()}
            if acc is not None:
                for a, p in zip(acc, leaves):
                    if a is not None and p.grad is not None:
                        a += p.grad.float()
                        p.grad = None
        if acc is not None:
            with torch.no_grad():
                for a, p in zip(acc, leaves):
                    if a is not None:
                        p.grad = (a / accum).to(p.dtype)
                    elif p.grad is not None:
                        p.grad.div_(accum)
        metrics = {k: v / accum for k, v in loss_sum.items()} if accum > 1 else loss_sum
        metrics["grad_norm"] = optimizer.global_norm()
        optimizer.step(metrics["grad_norm"])
        new_state = {**state, "model_state": mstate, "step": state["step"] + 1}
        if "ema_params" in state:
            d = train_cfg.ema_decay
            with torch.no_grad():
                for e, p in zip(tree_leaves(state["ema_params"]), tree_leaves(params)):
                    e.mul_(d).add_(p, alpha=1 - d)
        return new_state, metrics

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
