"""Host utilities: the rank-aware logger, seeding and visualization."""

from mla_tpu_torch.utils.overwatch import initialize_overwatch
from mla_tpu_torch.utils.seed import set_global_seed, step_generator

__all__ = ["initialize_overwatch", "set_global_seed", "step_generator"]
