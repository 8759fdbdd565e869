"""Dataset and collator factory.

Counterpart of mla_tpu/vla/materialize.py. Two paths:
  * data_root_dir set: the RLDS pipeline (vla/rlds/dataset.py), each frame
    through RLDSBatchTransform in the frame stage's pool of threads, and the
    fixed-shape collator; the trainer's thread only collates.
  * data_root_dir None: the synthetic DummyDataset (batches come assembled,
    no collator) and the JAX package's statistics dict.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from mla_tpu_torch.utils.overwatch import initialize_overwatch
from mla_tpu_torch.vla.dummy import DummyDataset

overwatch = initialize_overwatch(__name__)


def get_vla_dataset_and_collator(
    *,
    data_root_dir: Optional[str],
    data_mix: str,
    model_cfg,
    per_host_batch_size: int,
    shuffle_buffer_size: int = 10_000,
    action_tokenizer_exist: bool = False,
    base_tokenizer=None,
    max_prompt_len: int = 192,
    augment: bool = False,
    seed: int = 0,
) -> Tuple[Any, Optional[Any], Dict, Optional[int]]:
    """(frame iterable, collator or None, dataset statistics, dataset length
    or None). The length is the interleaved mixture's effective transition
    count; the synthetic DummyDataset has no collator and no length. With
    action_tokenizer_exist false the discretized action tokens are left out
    of prompt and labels (diffusion-only supervision, the default)."""
    if data_root_dir is None:
        overwatch.info(f"data: DummyDataset (no data_root_dir) mix={data_mix}")
        ad = model_cfg.action_dim
        stats = {
            data_mix: {
                "action": {"q01": [-1.0] * ad, "q99": [1.0] * ad},
                "proprio": {"q01": [-1.0] * ad, "q99": [1.0] * ad},
            }
        }
        return DummyDataset(model_cfg, batch_size=per_host_batch_size, seed=seed), None, stats, None

    from mla_tpu_torch.vla.action_tokenizer import ActionTokenizer
    from mla_tpu_torch.vla.datasets import PaddedCollatorForActionPrediction, RLDSBatchTransform
    from mla_tpu_torch.vla.rlds.dataset import make_interleaved_dataset
    from mla_tpu_torch.vla.rlds.stream import AUTOTUNE
    from mla_tpu_torch.vla.tokenizer import SimpleTokenizer

    base_tokenizer = base_tokenizer or SimpleTokenizer()
    action_tokenizer = ActionTokenizer(base_tokenizer, vocab_size=32000) if action_tokenizer_exist else None
    ds, dataset_len, stats = make_interleaved_dataset(
        data_mix, data_root_dir,
        train=True,
        shuffle_buffer_size=shuffle_buffer_size,
        window_size=model_cfg.past_action_window_size + 1,
        future_action_window_size=model_cfg.future_action_window_size,
        load_pointcloud=model_cfg.use_pointcloud,
        load_tactile=model_cfg.use_tactile,
        image_size=model_cfg.vision.image_size,
        augment=augment,
        seed=seed,
    )
    transform = RLDSBatchTransform(
        action_tokenizer=action_tokenizer,
        base_tokenizer=base_tokenizer,
        image_size=model_cfg.vision.image_size,
        use_pointcloud=model_cfg.use_pointcloud,
        use_tactile=model_cfg.use_tactile,
        num_points=model_cfg.point.input_points,
    )
    collator = PaddedCollatorForActionPrediction(max_prompt_len=max_prompt_len, training=True)
    return ds.map(transform, num_parallel_calls=AUTOTUNE), collator, stats, int(dataset_len) if dataset_len else None
