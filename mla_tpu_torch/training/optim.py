"""AdamW or Adafactor with decay / no-decay groups, a constant or
warmup-cosine learning rate, clipping by global norm, and stage-wise
freezing.

Counterpart of mla_tpu/training/optim.py. `make_optimizer` turns off
requires_grad on frozen leaves and returns an optimizer over the trainable
ones whose step means what the JAX chain masked(clip_by_global_norm ->
adamw | adafactor) does:
  * the learning rate is the schedule at the number of steps taken so far;
  * a trainable leaf that got no gradient (the LM head in diffusion mode)
    gets a zero one, so AdamW still decays it, as optax does (torch's AdamW
    skips a parameter whose .grad is None);
  * gradients are clipped as optax clips: g / norm * max_norm, and only
    when norm >= max_norm (clip_grad_norm_ would add 1e-6 to the norm).
AdamW is torch.optim.AdamW over two parameter groups, decayed and not; its
moments take the parameter dtype, as optax's do. Adafactor is optax's
adafactor with its defaults, written out here (`Adafactor`). The moments are
those of the parameters the caller built: the trainer builds fp32 master
weights (train.py), the timing entry point bf16 ones (train_step.py).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
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
    """The trainable leaves, stepped with optax's clipping and schedule
    semantics (see the module docstring); `_update(lr)` applies the rule to
    the clipped gradients."""

    def __init__(self, schedule: Callable[[int], float], max_grad_norm: float,
                 trainable: List[torch.Tensor], paths: List[str]):
        self.schedule, self.max_grad_norm = schedule, max_grad_norm
        self.trainable, self.paths = trainable, paths
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
            self._update(self.schedule(self.count))
        self.count += 1

    def zero_grad(self) -> None:
        for p in self.trainable:
            p.grad = None

    def _update(self, lr: float) -> None:
        raise NotImplementedError

    def _leaf_state(self, p: torch.Tensor, create: bool = False) -> Dict[str, torch.Tensor]:
        """The rule's state of leaf p: empty before the first step, unless
        `create` allocates it (zeros) first."""
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        """{'count', 'leaves': {path: {name: tensor}}}, the live tensors."""
        leaves = {path: self._leaf_state(p) for path, p in zip(self.paths, self.trainable)}
        return {"count": self.count, "leaves": leaves}

    def load_state_dict(self, saved: Dict[str, Any]) -> None:
        """Copy a state_dict() (host tensors) into this optimizer's state,
        allocating each leaf's state where it is not yet allocated."""
        if sorted(saved["leaves"]) != sorted(self.paths):
            raise ValueError("the saved optimizer state is of other trainable leaves than this optimizer's")
        self.count = int(saved["count"])
        for path, p in zip(self.paths, self.trainable):
            live = self._leaf_state(p, create=bool(saved["leaves"][path]))
            for name, t in saved["leaves"][path].items():
                live[name].copy_(t)


class AdamW(Optimizer):
    """torch.optim.AdamW over the trainable leaves."""

    def __init__(self, adamw: torch.optim.AdamW, schedule, max_grad_norm, trainable, paths):
        super().__init__(schedule, max_grad_norm, trainable, paths)
        self.adamw = adamw

    def _update(self, lr: float) -> None:
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()

    def _leaf_state(self, p: torch.Tensor, create: bool = False) -> Dict[str, torch.Tensor]:
        st = self.adamw.state[p]
        if create and not st:
            # the layout torch.optim.AdamW makes at its first step
            st.update(step=torch.tensor(0.0, dtype=torch.float32), exp_avg=torch.zeros_like(p),
                      exp_avg_sq=torch.zeros_like(p))
        return st


def factored_dims(shape: Sequence[int], min_dim_size_to_factor: int = 128) -> Optional[Tuple[int, int]]:
    """optax's rule: (d1, d0), the second-largest and the largest dims (by a
    numpy argsort of the shape), when the second-largest is at least
    min_dim_size_to_factor; else None (a full second moment)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(Optimizer):
    """optax.adafactor(learning_rate=schedule) with its defaults: the second
    moment factored over the two largest dims when both are >= 128 (one row
    and one column statistic), else kept whole; decay 1 - (t + 1)^-0.8 at
    step t; eps 1e-30 added to the squared gradient; the update clipped to
    block RMS 1, scaled by the learning rate and by the parameter's RMS
    (floored at 1e-3); no momentum, no weight decay. The statistics are kept
    in the parameter dtype and their decay is computed in fp32, as optax's
    are."""

    DECAY_RATE, EPS, CLIP, MIN_SCALE = 0.8, 1e-30, 1.0, 1e-3

    def __init__(self, schedule, max_grad_norm, trainable, paths):
        super().__init__(schedule, max_grad_norm, trainable, paths)
        self.state: Dict[int, Dict[str, torch.Tensor]] = {}

    def _leaf_state(self, p: torch.Tensor, create: bool = False) -> Dict[str, torch.Tensor]:
        st = self.state.setdefault(id(p), {})
        if create and not st:
            dims = factored_dims(p.shape)
            if dims is None:
                st["v"] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                st["v_row"] = p.new_zeros(p.shape[:d0] + p.shape[d0 + 1 :])
                st["v_col"] = p.new_zeros(p.shape[:d1] + p.shape[d1 + 1 :])
        return st

    def _update(self, lr: float) -> None:
        t = torch.tensor(float(self.count + 1), dtype=torch.float32)
        decay = float(1.0 - t ** -self.DECAY_RATE)
        for p in self.trainable:
            g, st = p.grad, self._leaf_state(p, create=True)
            dt = p.dtype
            g_sq = g * g + self.EPS
            dims = factored_dims(p.shape)
            if dims is not None:
                d1, d0 = dims
                st["v_row"].copy_(decay * st["v_row"].float() + (1.0 - decay) * g_sq.mean(dim=d0).float())
                st["v_col"].copy_(decay * st["v_col"].float() + (1.0 - decay) * g_sq.mean(dim=d1).float())
                r1 = d1 - 1 if d1 > d0 else d1
                row = (st["v_row"] / st["v_row"].mean(dim=r1, keepdim=True)) ** -0.5
                u = g * row.unsqueeze(d0) * (st["v_col"] ** -0.5).unsqueeze(d1)
            else:
                st["v"].copy_(decay * st["v"].float() + (1.0 - decay) * g_sq.float())
                u = g * st["v"] ** -0.5
            u = u / torch.clamp(torch.sqrt((u * u).mean()) / self.CLIP, min=1.0)
            u = torch.tensor(lr, dtype=u.dtype, device=u.device) * u
            rms = torch.sqrt((p * p).mean())
            u = u * torch.where(rms > self.MIN_SCALE, rms, torch.tensor(self.MIN_SCALE, dtype=dt, device=p.device))
            p.add_((-u).to(dt))


def make_optimizer(
    params: Any, *, learning_rate: float = 2e-5, weight_decay: float = 0.0, max_grad_norm: float = 1.0,
    lr_scheduler_type: str = "constant", warmup_ratio: float = 0.0, num_training_steps: int = 1000,
    stage: str = "pretrain", extra_frozen: Sequence[str] = (), b1: float = 0.9, b2: float = 0.999,
    eps: float = 1e-8, optimizer: str = "adamw",
) -> Tuple[Optimizer, Callable[[int], float], Dict[str, bool]]:
    """(optimizer, schedule, {path: trained?}) for a tree of leaf tensors.
    Frozen leaves get requires_grad_(False): they get no gradient, no update
    and no decay. Trainable leaves get requires_grad_(True). optimizer is
    'adamw' or 'adafactor'; Adafactor refuses weight_decay, as the JAX
    package does (optax's adafactor decay is a constant per-step shrink,
    not AdamW's learning-rate-scaled decoupled decay)."""
    if optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if optimizer == "adafactor" and weight_decay:
        raise ValueError(
            "weight_decay with optimizer='adafactor' is not supported: optax.adafactor's weight_decay_rate is a "
            "constant per-step shrink, not adamw's lr-scaled decoupled decay. Use adamw, or set weight_decay=0 "
            "and add schedule-scaled decay explicitly.")
    schedule = make_lr_schedule(lr_scheduler_type, learning_rate, num_training_steps, warmup_ratio)
    mask = trainable_mask(params, stage, extra_frozen)
    decay, no_decay = [], []
    for path, leaf in tree_items(params):
        leaf.requires_grad_(mask[path])
        if mask[path]:
            (no_decay if is_no_decay(path, leaf) else decay).append((path, leaf))
    paths = [p for p, _ in decay + no_decay]
    leaves = [l for _, l in decay + no_decay]
    if optimizer == "adafactor":
        return Adafactor(schedule, max_grad_norm, leaves, paths), schedule, mask
    groups = [{"params": [l for _, l in decay], "weight_decay": weight_decay},
              {"params": [l for _, l in no_decay], "weight_decay": 0.0}]
    adamw = torch.optim.AdamW(groups, lr=schedule(0), betas=(b1, b2), eps=eps)
    return AdamW(adamw, schedule, max_grad_norm, leaves, paths), schedule, mask
