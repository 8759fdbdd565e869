"""The port's flash route against JAX's shape rule: the kernel takes a causal
self-attending block of at least 256 queries with head_dim 64 or 128, and
anything shorter or of another head_dim goes to the reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mla_tpu.ops.flash_attention as jflash
from mla_tpu.ops import attention as jattn
from mla_tpu_torch.ops import attention as tattn


@pytest.mark.parametrize("seq_len", [255, 256])
@pytest.mark.parametrize("head_dim", [64, 80, 128])
def test_flash_route_matches_jax(monkeypatch, seq_len, head_dim):
    """JAX's sdpa on a backend it takes for a TPU reaches its flash kernel
    exactly where the port's flash_fits says so."""
    taken = []
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jflash, "flash_attention", lambda q, k, v, mask=None: taken.append(q.shape) or q)
    q = jnp.zeros((1, 2, seq_len, head_dim), jnp.float32)
    jattn.sdpa(q, q, q)
    assert tattn.flash_fits(seq_len, head_dim) is bool(taken)
    assert tattn.flash_fits(seq_len, head_dim) is (seq_len >= 256 and head_dim in (64, 128))


@pytest.mark.parametrize("seq_len", [255, 256])
def test_cpu_tensor_takes_the_reference(monkeypatch, seq_len):
    """A CPU tensor takes the reference at any length."""
    monkeypatch.setattr(tattn, "flash_attention", lambda *a, **k: pytest.fail("the CPU took the flash kernel"))
    q = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 2, seq_len, 64)).astype(np.float32))
    np.testing.assert_array_equal(tattn.sdpa(q, q, q).numpy(), tattn.sdpa_reference(q, q, q).numpy())
