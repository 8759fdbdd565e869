"""Metrics tracking: JSON lines and optional W&B sinks, the VLA metric set,
and the training throughput accounting.

Counterpart of mla_tpu/training/metrics.py: the Tracker protocol with
JSONLinesTracker and WeightsBiasesTracker, and VLAMetrics (windowed
total / contrastive / diffusion / AR / generation losses, grad norm,
learning rate, step time, tokens/s and MFU, with rank-zero gating), writing
the same keys and the same push() line. MFU is taken against the card's
dense bf16 peak (`bf16_peak_flops`).
"""

from __future__ import annotations

import json
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Any, Dict, Optional, Protocol, Union

import numpy as np

from mla_tpu_torch.params import tree_leaves
from mla_tpu_torch.utils.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)

# dense bf16 tensor-core peaks (NVIDIA data sheets), by device-name fragment
BF16_PEAK_FLOPS = {"H100 PCIe": 756e12, "H100": 989e12, "H200": 989e12}


def decoder_flops_per_token(llm_params: Dict[str, Any], use_diff: bool) -> float:
    """Model FLOPs per decoder token, 6N (remat recompute not counted). N
    counts what runs per token: the decoder without the embedding table (a
    lookup) and, in diffusion mode, without the LM head (never projected).
    The front-ends run once per frame and are left out, so MFU is a slight
    undercount."""
    skip = {"embed"} | ({"lm_head"} if use_diff else set())
    return 6.0 * sum(l.numel() for k, sub in llm_params.items() if k not in skip for l in tree_leaves(sub))


def bf16_peak_flops(device_name: str) -> Optional[float]:
    """The card's dense bf16 peak from its name, or None if unknown."""
    for frag, peak in BF16_PEAK_FLOPS.items():
        if frag in device_name:
            return peak
    return None


class Tracker(Protocol):
    def write_hyperparameters(self, hparams: Dict[str, Any]) -> None: ...

    def write(self, global_step: int, metrics: Dict[str, Any]) -> None: ...

    def finalize(self) -> None: ...


class JSONLinesTracker:
    """run-metrics.jsonl (run id and hyperparameters) and <run_id>.jsonl (one
    line per push) in the run dir."""

    def __init__(self, run_id: str, run_dir: Union[str, Path], hparams: Dict[str, Any]) -> None:
        self.run_id, self.run_dir, self.hparams = run_id, Path(run_dir), hparams
        self.run_dir.mkdir(parents=True, exist_ok=True)

    def write_hyperparameters(self, hparams: Optional[Dict[str, Any]] = None) -> None:
        if not overwatch.is_rank_zero():
            return
        with open(self.run_dir / "run-metrics.jsonl", "w") as f:
            json.dump({"run_id": self.run_id, "hparams": hparams or self.hparams}, f, default=str)
            f.write("\n")

    def write(self, global_step: int, metrics: Dict[str, Any]) -> None:
        if not overwatch.is_rank_zero():
            return
        with open(self.run_dir / f"{self.run_id}.jsonl", "a") as f:
            json.dump(metrics, f, default=float)
            f.write("\n")

    def finalize(self) -> None:
        pass


class WeightsBiasesTracker:
    """Optional W&B sink; warns and does nothing when wandb is not installed
    or does not start."""

    def __init__(self, run_id: str, run_dir: Union[str, Path], hparams: Dict[str, Any]) -> None:
        self.run_id, self.run_dir, self.hparams = run_id, Path(run_dir), hparams
        self._run = None
        if not overwatch.is_rank_zero():
            return
        try:
            import wandb

            self._run = wandb.init(name=run_id, dir=str(run_dir), config=hparams, project="mla-tpu",
                                   group="vla-train")
        except Exception as e:  # an optional sink: training goes on without it
            overwatch.warning(f"wandb unavailable ({e}); tracker disabled")

    def write_hyperparameters(self, hparams: Optional[Dict[str, Any]] = None) -> None:
        if self._run is not None:
            self._run.config.update(hparams or self.hparams, allow_val_change=True)

    def write(self, global_step: int, metrics: Dict[str, Any]) -> None:
        if self._run is not None:
            self._run.log(metrics, step=global_step)

    def finalize(self) -> None:
        if self._run is not None:
            self._run.finish()


TRACKERS = {"jsonl": JSONLinesTracker, "wandb": WeightsBiasesTracker}

_VLA_LOSS_KEYS = (
    "total_loss", "img_pc_contrastive_loss", "tactile_contrastive_loss",
    "diff_loss", "ar_loss", "image_gen_loss", "point_cloud_gen_loss",
    "tactile_gen_loss", "grad_norm",
)


class VLAMetrics:
    """Windowed trackers for the MLA loss set and timing. With
    flops_per_token (6N) and the devices' total peak_flops, push() derives
    tokens/s and MFU from the step window."""

    def __init__(
        self,
        active_trackers,
        run_id: str,
        run_dir: Union[str, Path],
        hparams: Dict[str, Any],
        window_size: int = 10,
        resume_step: Optional[int] = None,
        resume_epoch: Optional[int] = None,
        flops_per_token: Optional[float] = None,
        peak_flops: Optional[float] = None,
    ) -> None:
        self.flops_per_token = flops_per_token
        self.peak_flops = peak_flops
        self.run_id, self.run_dir = run_id, Path(run_dir)
        self.trackers = []
        for t in active_trackers:
            tracker = TRACKERS[t](run_id, run_dir, hparams)
            tracker.write_hyperparameters(hparams)
            self.trackers.append(tracker)

        self.global_step = 0 if resume_step is None else resume_step
        self.epoch = 0 if resume_epoch is None else resume_epoch
        self.start_time = time.time()
        self.step_start_time = time.time()
        self.windows = defaultdict(lambda: deque(maxlen=window_size))

    def commit(self, *, global_step: Optional[int] = None, epoch: Optional[int] = None,
               lr: Optional[float] = None, update_step_time: bool = False,
               tokens: Optional[int] = None, **losses) -> None:
        """Record one step; each loss is a number or a 0-d tensor (read to
        the host here)."""
        if global_step is not None:
            self.global_step = global_step
        if epoch is not None:
            self.epoch = epoch
        if lr is not None:
            self.windows["lr"].append(lr)
        if tokens is not None:
            self.windows["tokens"].append(float(tokens))
        if update_step_time:
            self.windows["step_time"].append(time.time() - self.step_start_time)
            self.step_start_time = time.time()
        for k, v in losses.items():
            self.windows[k].append(float(v))

    def push(self) -> str:
        metrics = {"VLA Train/Step": self.global_step, "VLA Train/Epoch": self.epoch}
        for k in _VLA_LOSS_KEYS:
            if self.windows[k]:
                metrics[f"VLA Train/{k}"] = float(np.mean(self.windows[k]))
        if self.windows["lr"]:
            metrics["VLA Train/Learning Rate"] = float(self.windows["lr"][-1])
        if self.windows["step_time"]:
            metrics["VLA Train/Step Time"] = float(np.mean(self.windows["step_time"]))
        if self.windows["tokens"] and self.windows["step_time"]:
            tps = float(np.mean(self.windows["tokens"])) / max(float(np.mean(self.windows["step_time"])), 1e-9)
            metrics["VLA Train/Tokens per Sec"] = tps
            if self.flops_per_token and self.peak_flops:
                metrics["VLA Train/MFU"] = tps * self.flops_per_token / self.peak_flops
        for t in self.trackers:
            t.write(self.global_step, metrics)
        loss = metrics.get("VLA Train/total_loss", float("nan"))
        lr = metrics.get("VLA Train/Learning Rate", 0.0)
        st = metrics.get("VLA Train/Step Time", 0.0)
        return (
            f"=>> [Epoch {self.epoch:03d}] Global Step {self.global_step:06d} "
            f"=>> LR :: {lr:.6f} -- Step Time :: {st:.3f}s -- Loss :: {loss:.4f}"
        )

    def finalize(self) -> None:
        for t in self.trackers:
            t.finalize()
