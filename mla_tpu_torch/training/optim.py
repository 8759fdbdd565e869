"""AdamW with decay / no-decay groups, a constant or warmup-cosine learning
rate, clipping by global norm, and stage-wise freezing.

Counterpart of mla_tpu/training/optim.py (the AdamW branch; Adafactor is not
ported yet). `make_optimizer` turns off requires_grad on frozen leaves and
gives torch.optim.AdamW two parameter groups, decayed and not. `Optimizer`
wraps it so that a step means what the JAX chain
masked(clip_by_global_norm -> adamw) does:
  * the learning rate is the schedule at the number of steps taken so far;
  * a trainable leaf that got no gradient (the LM head in diffusion mode)
    gets a zero one, so AdamW still decays it, as optax does (torch's AdamW
    skips a parameter whose .grad is None);
  * gradients are clipped as optax clips: g / norm * max_norm, and only
    when norm >= max_norm (clip_grad_norm_ would add 1e-6 to the norm).
AdamW's moments take the parameter dtype (bf16 for bf16 leaves), as
optax's do; there are no fp32 master weights, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from mla_tpu_torch.params import tree_items

# no decay: biases ('b'), norm scales and biases, the vision tokenizer's
# embeddings and the CFG vector, and every leaf of effective ndim <= 1
_NO_DECAY_KEYS = ("scale", "bias", "class_embedding", "split_embedding", "uncondition")

# stage -> top-level modules frozen (the reference's freeze_backbones)
STAGE_FROZEN_MODULES = {
    "pretrain": (),
    "finetune": ("vision_tower_2d", "vision_tower_3d"),
    "post-training": ("vision_tower_2d", "vision_tower_3d"),
    "vlm-align": ("vision_tower_2d", "vision_tower_3d", "llm_backbone"),
    "vlm-finetune": ("vision_tower_2d", "vision_tower_3d"),
}


def is_no_decay(path: str, leaf: torch.Tensor) -> bool:
    """The JAX package's rule; the decoder's layer leaves are stacked on a
    leading [L] axis, so their effective ndim is one less."""
    last = path.rsplit("/", 1)[-1]
    if last == "b" or last in _NO_DECAY_KEYS:
        return True
    return leaf.dim() - (1 if "llm_backbone/layers/" in path else 0) <= 1


def trainable_mask(params: Any, stage: str = "pretrain", extra_frozen: Sequence[str] = ()) -> Dict[str, bool]:
    """{path: trained?}. A frozen module name matches any path segment; the
    CFG `uncondition` vector is always frozen (a buffer in the reference)."""
    if stage not in STAGE_FROZEN_MODULES:
        raise ValueError(f"unknown stage {stage!r}; expected one of {sorted(STAGE_FROZEN_MODULES)}")
    frozen = set(STAGE_FROZEN_MODULES[stage]) | set(extra_frozen)
    return {
        path: not (any(seg in frozen for seg in path.split("/")) or path.endswith("uncondition"))
        for path, _ in tree_items(params)
    }


def make_lr_schedule(
    lr_scheduler_type: str, learning_rate: float, num_training_steps: int, warmup_ratio: float = 0.0,
) -> Callable[[int], float]:
    """step -> learning rate: 'constant', or 'linear-warmup+cosine-decay',
    the function of optax.warmup_cosine_decay_schedule(0, lr, max(warmup,
    1), num_training_steps, 0): linear from 0 over the warmup, then cosine
    to 0 at num_training_steps."""
    if lr_scheduler_type == "constant":
        return lambda step: learning_rate
    if lr_scheduler_type != "linear-warmup+cosine-decay":
        raise ValueError(f"LR schedule `{lr_scheduler_type}` is not supported!")
    warmup = max(int(num_training_steps * warmup_ratio), 1)
    decay = num_training_steps - warmup

    def schedule(step: int) -> float:
        if step < warmup:
            return learning_rate * step / warmup
        frac = min(step - warmup, decay) / decay
        return learning_rate * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule


class Optimizer:
    """torch.optim.AdamW over the trainable leaves, stepped with optax's
    clipping and schedule semantics (see the module docstring)."""

    def __init__(self, adamw: torch.optim.AdamW, schedule: Callable[[int], float], max_grad_norm: float,
                 trainable: List[torch.Tensor]):
        self.adamw, self.schedule, self.max_grad_norm = adamw, schedule, max_grad_norm
        self.trainable = trainable
        self.count = 0

    def global_norm(self) -> torch.Tensor:
        """Global norm of the trainable leaves' gradients, each leaf's norm
        reduced in fp32."""
        norms = [torch.linalg.vector_norm(p.grad, dtype=torch.float32) for p in self.trainable if p.grad is not None]
        return torch.linalg.vector_norm(torch.stack(norms)) if norms else torch.zeros(())

    def step(self, norm: Optional[torch.Tensor] = None) -> None:
        """One update; `norm` is global_norm() if the caller has it."""
        norm = self.global_norm() if norm is None else norm
        for p in self.trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            if norm >= self.max_grad_norm:
                for p in self.trainable:
                    p.grad.div_(norm.to(p.grad.dtype)).mul_(self.max_grad_norm)
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)


def make_optimizer(
    params: Any, *, learning_rate: float = 2e-5, weight_decay: float = 0.0, max_grad_norm: float = 1.0,
    lr_scheduler_type: str = "constant", warmup_ratio: float = 0.0, num_training_steps: int = 1000,
    stage: str = "pretrain", extra_frozen: Sequence[str] = (), b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8, optimizer: str = "adamw",
) -> Tuple[Optimizer, Callable[[int], float], Dict[str, bool]]:
    """(optimizer, schedule, {path: trained?}) for a tree of leaf tensors.
    Frozen leaves get requires_grad_(False): they get no gradient, no update
    and no decay. Trainable leaves get requires_grad_(True)."""
    if optimizer != "adamw":
        raise NotImplementedError(f"optimizer {optimizer!r} is not ported yet (AdamW only)")
    schedule = make_lr_schedule(lr_scheduler_type, learning_rate, num_training_steps, warmup_ratio)
    mask = trainable_mask(params, stage, extra_frozen)
    decay, no_decay = [], []
    for path, leaf in tree_items(params):
        leaf.requires_grad_(mask[path])
        if mask[path]:
            (no_decay if is_no_decay(path, leaf) else decay).append(leaf)
    groups = [{"params": decay, "weight_decay": weight_decay}, {"params": no_decay, "weight_decay": 0.0}]
    adamw = torch.optim.AdamW(groups, lr=schedule(0), betas=(b1, b2), eps=eps)
    return Optimizer(adamw, schedule, max_grad_norm, decay + no_decay), schedule, mask
