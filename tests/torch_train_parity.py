"""Shared set-up of the training parity tests (tests/test_torch_train_*):
one mla-tiny model initialized by the JAX package and carried across with
params.from_jax, one synthetic batch, and the random draws the JAX training
step makes from its key, replayed into the port."""

import jax
import jax.numpy as jnp
import numpy as np

from mla_tpu.conf.models import get_model_config as jconfig
from mla_tpu.diffusion import gaussian as jgd
from mla_tpu.vla.dummy import synthetic_batch as jbatch
from mla_tpu_torch.conf.models import get_model_config as tconfig
from mla_tpu_torch.diffusion import gaussian as tgd
from mla_tpu_torch.params import from_jax, tree_items
from mla_tpu_torch.vla.dummy import synthetic_batch as tbatch
from torch_policy_parity import model

__all__ = ["model", "jconfig", "tconfig", "jbatch", "tbatch", "jgd", "tgd", "from_jax", "tree_items",
           "jax_draws", "batch", "trainable", "TEXT_LEN"]

TEXT_LEN = 16


def batch(B: int, seed: int = 3):
    """The same synthetic batch from both packages (asserted identical)."""
    jb, tb = jbatch(jconfig("mla-tiny"), B=B, L=TEXT_LEN, seed=seed), tbatch(tconfig("mla-tiny"), B=B, L=TEXT_LEN, seed=seed)
    for path, leaf in tree_items(tb):
        want = dict(tree_items(jb))[path]
        assert leaf.dtype == want.dtype and np.array_equal(leaf, want), path
    return jb


def jax_draws(rng, cfg, rows: int):
    """The noise, t and FPS starts that mla_train_loss draws from `rng` for
    `rows` = B * repeated_diffusion_steps rows: split(rng, 3) -> (noise, t,
    model) keys; the FPS key is fold_in(model, 0), stage s draws
    randint(fold_in(fps, s), [rows], 0, N_s)."""
    k_noise, k_t, k_model = jax.random.split(rng, 3)
    noise = np.asarray(jax.random.normal(k_noise, (rows, cfg.action_horizon, cfg.action_dim), jnp.float32))
    t = np.asarray(jax.random.randint(k_t, (rows,), 0, 100))
    fps_key = jax.random.fold_in(k_model, 0)
    starts = [
        np.asarray(jax.random.randint(jax.random.fold_in(fps_key, si), (rows,), 0, cfg.point.input_points >> si,
                                      dtype=jnp.int32))
        for si in range(cfg.point.num_stages)
    ]
    return {"override_noise": noise, "override_t": t, "fps_start": starts}


def trainable(tree):
    """from_jax(tree) with requires_grad on every leaf."""
    t = from_jax(tree)
    for _, leaf in tree_items(t):
        leaf.requires_grad_(True)
    return t
