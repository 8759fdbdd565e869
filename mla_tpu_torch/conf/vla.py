"""VLA training-experiment registry.

Counterpart of mla_tpu/conf/vla.py, field for field: a plain dataclass
registry (the reference's conf/vla.py uses draccus) selecting the data
mixture and optimization hyperparameters per experiment;
mla_tpu_torch/train.py parses `--key value` overrides onto it.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Dict, Optional


@dataclass
class VLATrainConfig:
    vla_id: str = "prism-dinosiglip-224px+oxe+diffusion"
    base_vlm: str = "mla-7b"

    # freezing (reference: freeze_vision_tower / freeze_llm_backbone)
    freeze_vision_tower: bool = False
    freeze_llm_backbone: bool = False
    unfreeze_last_llm_layer: bool = False

    # data
    data_mix: str = "rlbench"
    shuffle_buffer_size: int = 10_000
    camera_name: str = "rlbench_front"

    # optimization (reference conf/vla.py:33-56)
    epochs: int = 100
    max_steps: Optional[int] = None
    expected_world_size: int = 1
    global_batch_size: int = 64
    per_device_batch_size: int = 8
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    lr_scheduler_type: str = "constant"
    warmup_ratio: float = 0.0
    train_strategy: str = "fsdp-full-shard"
    enable_gradient_checkpointing: bool = True
    enable_mixed_precision_training: bool = True
    reduce_in_full_precision: bool = True

    # MLA stage flags (reference scripts/train.py flag matrix + launch
    # scripts scripts/{pretrain,sft_*,post_*}.sh)
    use_diff: bool = True
    # splice discretized AR action tokens into the prompt/labels (reference
    # scripts/train.py:93 `action_tokenizer_exist`, default False: the
    # reference's default RLDS training supervises the diffusion head only)
    action_tokenizer_exist: bool = False
    use_pointcloud: bool = True
    use_tactile: bool = False
    use_contrastive: bool = True
    use_generation: bool = False
    gen_image: bool = False
    use_roi: bool = False
    gen_pointcloud: bool = False
    gen_tactile: bool = False
    repeated_diffusion_steps: int = 4
    future_action_window_size: int = 15
    past_action_window_size: int = 0
    action_dim: int = 7
    class_dropout_prob: float = 0.0
    use_ema: bool = False
    num_extra_views: int = 0  # wrist cameras (franka mixes use 1)

    # run management
    run_root_dir: str = "runs"
    run_id: Optional[str] = None
    seed: int = 42
    save_interval: int = 2500
    # post-training generation visualization cadence (0 = off); panels land
    # in <run_dir>/visualizations (reference dumps from inside the forward
    # with a hardcoded path, prismatic.py:1129-1135)
    visualize_interval: int = 0
    pretrained_checkpoint: Optional[str] = None
    resume_step: Optional[int] = None
    resume_epoch: Optional[int] = None
    is_resume: bool = False
    async_checkpoints: bool = False  # overlap checkpoint writes with training
    trackers: str = "jsonl"  # comma-separated: jsonl,wandb

    @property
    def stage(self) -> str:
        """Reference stage inference from flags (scripts/train.py:310-321)."""
        if self.use_generation:
            return "post-training"
        if self.freeze_vision_tower:
            return "finetune"
        return "pretrain"


# === experiment registry (reference conf/vla.py:60-126) ===

VLA_REGISTRY: Dict[str, VLATrainConfig] = {
    "siglip-224px+mx-bridge": VLATrainConfig(
        vla_id="siglip-224px+mx-bridge",
        base_vlm="mla-7b",
        data_mix="bridge",
        shuffle_buffer_size=256_000,
        epochs=1000,
        global_batch_size=256,
        per_device_batch_size=32,
    ),
    "prism-dinosiglip-224px+oxe+diffusion": VLATrainConfig(
        vla_id="prism-dinosiglip-224px+oxe+diffusion",
        base_vlm="mla-7b",
        data_mix="rlbench",
        shuffle_buffer_size=10_000,
        epochs=100,
        global_batch_size=256,
        per_device_batch_size=16,
    ),
    "mla-tiny-debug": VLATrainConfig(
        vla_id="mla-tiny-debug",
        base_vlm="mla-tiny",
        data_mix="dummy",
        shuffle_buffer_size=100,
        epochs=1,
        max_steps=10,
        global_batch_size=8,
        per_device_batch_size=8,
    ),
}


def get_vla_config(vla_id: str, **overrides) -> VLATrainConfig:
    if vla_id not in VLA_REGISTRY:
        raise ValueError(f"Unknown VLA config `{vla_id}`. Available: {list(VLA_REGISTRY)}")
    cfg = VLA_REGISTRY[vla_id]
    valid = {f.name for f in fields(VLATrainConfig)}
    bad = set(overrides) - valid
    if bad:
        raise ValueError(f"Unknown config overrides: {bad}")
    return replace(cfg, **overrides)
