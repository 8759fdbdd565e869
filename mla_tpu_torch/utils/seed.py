"""Global seeding and the per-step generator.

Counterpart of mla_tpu/utils/seed.py. `set_global_seed` seeds Python's and
numpy's generators for host-side data code and returns the seed, folded
with the process index as the JAX package folds it. `step_generator` is the
counterpart of `jax.random.fold_in(rng, step)`: a torch.Generator whose seed
depends on (seed, step) alone, so a resumed run draws at a step what an
uninterrupted run draws there.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from mla_tpu_torch.utils.overwatch import process_index

_MASK64 = (1 << 64) - 1


def set_global_seed(seed: int) -> int:
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed must fit in uint32, got {seed}")
    seed = (seed + 1_000_003 * process_index()) % (2**32)
    random.seed(seed)
    np.random.seed(seed)
    # fixed at interpreter start-up for this process: this only makes child
    # processes (data workers) deterministic
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def step_generator(seed: int, step: int, device="cpu") -> torch.Generator:
    """A generator on `device` seeded from (seed, step) alone."""
    mixed = _splitmix64((_splitmix64(seed) + step) & _MASK64)
    return torch.Generator(device=torch.device(device)).manual_seed(mixed >> 1)
