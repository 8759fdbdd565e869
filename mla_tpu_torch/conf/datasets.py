"""VLM-pretraining dataset registry (the LLaVA-era variants).

Counterpart of mla_tpu/conf/datasets.py, the port's own copy: a dataset id
-> (annotation json, image dir) pairs for the two VLM pretraining stages
("align", the projector warm-up, and "finetune", instruct tuning) under a
dataset root. The trainer's --vlm_dataset picks one
(vla/vlm_datasets.get_vlm_dataset_and_collator). The robot-learning path
uses the RLDS data mixes instead (vla/rlds/).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Tuple

# (annotation json, image directory), both relative to dataset_root_dir
StageComponents = Tuple[str, str]

_ALIGN_558K: StageComponents = (
    "download/llava-laion-cc-sbu-558k/chat.json",
    "download/llava-laion-cc-sbu-558k/",
)


@dataclass(frozen=True)
class DatasetConfig:
    dataset_id: str
    align_stage_components: StageComponents
    finetune_stage_components: StageComponents
    dataset_root_dir: str = "datasets/prismatic-vlms"

    def components_for_stage(self, stage: str) -> StageComponents:
        """Stage name -> (annotation json, image dir). The reference indexes
        the tuple fields directly per stage (conf/datasets.py:26-27)."""
        if stage in ("align", "projector"):
            return self.align_stage_components
        if stage in ("finetune", "full-finetune", "pretrain"):
            return self.finetune_stage_components
        raise ValueError(f"unknown VLM pretraining stage {stage!r}")


def _llava(dataset_id: str, finetune_json: str) -> DatasetConfig:
    return DatasetConfig(
        dataset_id=dataset_id,
        align_stage_components=_ALIGN_558K,
        finetune_stage_components=(finetune_json, "download/llava-v1.5-instruct/"),
    )


# reference conf/datasets.py:33-124 variant-for-variant
DATASET_REGISTRY: Dict[str, DatasetConfig] = {
    c.dataset_id: c
    for c in [
        _llava("llava-v15", "download/llava-v1.5-instruct/llava_v1_5_mix665k.json"),
        _llava("llava-multimodal",
               "download/llava-v1.5-instruct/llava_v1_5_stripped625k.json"),
        _llava("llava-lvis4v",
               "download/llava-v1.5-instruct/llava_v1_5_lvis4v_mix888k.json"),
        _llava("llava-lrv",
               "download/llava-v1.5-instruct/llava_v1_5_lrv_mix1008k.json"),
        _llava("llava-lvis4v-lrv",
               "download/llava-v1.5-instruct/llava_v1_5_lvis4v_lrv_mix1231k.json"),
    ]
}


def get_dataset_config(dataset_id: str, **overrides) -> DatasetConfig:
    if dataset_id not in DATASET_REGISTRY:
        raise ValueError(
            f"unknown dataset {dataset_id!r} (valid: {sorted(DATASET_REGISTRY)})"
        )
    cfg = DATASET_REGISTRY[dataset_id]
    return replace(cfg, **overrides) if overrides else cfg
