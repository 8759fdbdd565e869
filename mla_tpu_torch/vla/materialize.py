"""Dataset and collator factory.

Counterpart of mla_tpu/vla/materialize.py. Without a data root it returns
the synthetic DummyDataset (batches come assembled, no collator) and the
JAX package's statistics dict. The RLDS pipeline is not ported: a data root
raises.
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
    seed: int = 0,
) -> Tuple[Any, Optional[Any], Dict, Optional[int]]:
    """(frame iterable, collator or None, dataset statistics, dataset length
    or None); the synthetic DummyDataset has no collator and no length."""
    if data_root_dir is not None:
        raise NotImplementedError(
            f"data_root_dir={data_root_dir!r}: the RLDS data pipeline is not ported yet (ROADMAP.md queue 1, "
            "item 6); leave --data_root_dir unset to train on the synthetic DummyDataset")
    overwatch.info(f"data: DummyDataset (no data_root_dir) mix={data_mix}")
    ad = model_cfg.action_dim
    stats = {
        data_mix: {
            "action": {"q01": [-1.0] * ad, "q99": [1.0] * ad},
            "proprio": {"q01": [-1.0] * ad, "q99": [1.0] * ad},
        }
    }
    return DummyDataset(model_cfg, batch_size=per_host_batch_size, seed=seed), None, stats, None
