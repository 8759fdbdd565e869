"""MLAPolicy.dispatch_action_diff_batched of the port against the JAX
package's serving graph (MLAPolicy._diff_fn) on mla-tiny in fp32: the same
weights, a batch of two observations with their own prompts and proprio
rows (one None), and the same x_T, which the port draws from its CPU
generator and JAX is fed; DDIM-8 (the policy's respacing), DDIM-10 and
DPM-Solver++ with 4 and 6 evaluations, and the bf16 prefill score tensor
of the plain attention (both packages attend without flash on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_policy_parity as tpp
from mla_tpu.conf.models import get_model_config as jconfig
from mla_tpu.models import mla as jmla
from mla_tpu_torch.conf.models import get_model_config as tconfig
from mla_tpu_torch.models import mla as tmla
from mla_tpu_torch.params import from_jax

SEED = 11


@pytest.fixture(scope="module")
def weights():
    return tpp.model()


def _batch(cfg):
    rng = np.random.default_rng(4)
    size = cfg.vision.image_size
    imgs = rng.integers(0, 256, size=(2, 3, size, size), dtype=np.uint8)
    pcs = rng.uniform(-0.3, 0.7, size=(2, cfg.point.input_points, 3)).astype(np.float32)
    ids = np.array([[1, 500, 600, 700, 800, 29871], [1, 900, 650, 710, 820, 29871]], np.int32)
    states = [rng.uniform(-0.5, 0.5, size=7).astype(np.float32), None]
    return imgs, pcs, ids, states


def _jax_run(jpol, imgs, pcs, ids, states, x_t, **kw):
    """JAX's serving graph on the same inputs, fed x_T."""
    pstats = jpol.get_proprio_stats(None)
    proprio = np.stack([jmla.normalize_proprio(s, pstats) if s is not None else np.zeros(7, np.float32)
                        for s in states])[:, None, :]
    fn = jpol._diff_fn(ids.shape[1] - 1, 1, use_ddpm=False, **kw)
    out = fn(jpol.params, jpol.state, jnp.asarray(ids[:, :-1]), jnp.asarray(ids[:, -1:]),
             {"front_image": jnp.asarray(imgs)}, jnp.asarray(pcs), jnp.asarray(proprio),
             jnp.asarray(x_t), jax.random.PRNGKey(0))
    return np.asarray(out)


@pytest.mark.parametrize("kw", [
    {"sampler": "ddim"},
    {"sampler": "ddim", "num_ddim_steps": 10},
    {"sampler": "dpm", "num_dpm_steps": 4},
    {"sampler": "dpm", "num_dpm_steps": 6},
], ids=["ddim8", "ddim10", "dpm4", "dpm6"])
def test_dispatch_matches_jax_diff_fn(weights, kw, record_property):
    jpol, tpol = tpp.policies(*weights, quantized=False)
    imgs, pcs, ids, states = _batch(tpol.cfg)
    finalize = tpol.dispatch_action_diff_batched(imgs, pcs, input_ids=ids, cur_robot_states=states, seed=SEED,
                                                 return_normalized=True, **kw)
    t = finalize()
    x_t = torch.randn((2, 16, 7), generator=torch.Generator().manual_seed(SEED)).numpy()
    j = _jax_run(jpol, imgs, pcs, ids, states, x_t, **kw)
    assert t.shape == (2, 16, 7) and np.isfinite(t).all()
    record_property("max_abs_err", float(np.abs(t - j).max()))
    # fp32 end to end (test_torch_policy_fp32's tolerance)
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
    # the blocking form is dispatch(...)() with unnormalization on top
    u = tpol.predict_action_diff_batched(imgs, pcs, input_ids=ids, cur_robot_states=states, seed=SEED, **kw)
    np.testing.assert_array_equal(u, np.stack([tmla.unnormalize_actions(r, tpol.get_action_stats()) for r in t]))


def test_bf16_prefill_scores_match_jax(weights, record_property):
    """prefill_scores_dtype=bf16 on both sides (the plain attention: JAX's
    flash kernel is off on the CPU, and so is the port's): the score tensor
    is rounded to bf16 at the same places, so the chunk agrees with JAX's
    at the fp32 tolerance, and differs from the fp32-score chunk."""
    params, state = weights
    cfg = tconfig("mla-tiny")
    tpol = tmla.MLAPolicy(from_jax(params), from_jax(state), cfg, norm_stats=tpp.STATS, device="cpu",
                          prefill_scores_dtype=torch.bfloat16)
    jpol = jmla.MLAPolicy(params, state, jconfig("mla-tiny"), norm_stats=tpp.STATS, prefill_scores_dtype=jnp.bfloat16)
    imgs, pcs, ids, states = _batch(cfg)
    kw = {"sampler": "dpm", "num_dpm_steps": 4}
    t = tpol.predict_action_diff_batched(imgs, pcs, input_ids=ids, cur_robot_states=states, seed=SEED,
                                         return_normalized=True, **kw)
    x_t = torch.randn((2, 16, 7), generator=torch.Generator().manual_seed(SEED)).numpy()
    j = _jax_run(jpol, imgs, pcs, ids, states, x_t, **kw)
    record_property("max_abs_err", float(np.abs(t - j).max()))
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
    fp32 = tpp.policies(params, state, quantized=False)[1].predict_action_diff_batched(
        imgs, pcs, input_ids=ids, cur_robot_states=states, seed=SEED, return_normalized=True, **kw)
    assert np.abs(t - fp32).max() > 1e-6


def test_scores_dtype_comes_from_the_environment(weights, monkeypatch):
    params, state = weights
    for value, want in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        monkeypatch.setenv("MLA_PREFILL_SCORES", value)
        pol = tmla.MLAPolicy(from_jax(params), from_jax(state), tconfig("mla-tiny"), device="cpu")
        assert pol.prefill_scores_dtype is want
    # a dtype the caller names wins over the environment
    monkeypatch.setenv("MLA_PREFILL_SCORES", "bf16")
    pol = tmla.MLAPolicy(from_jax(params), from_jax(state), tconfig("mla-tiny"), device="cpu",
                         prefill_scores_dtype=torch.float32)
    assert pol.prefill_scores_dtype is torch.float32


def test_policy_options(weights):
    """num_ddim_steps and cache_margin as in JAX's constructor: the policy's
    DDIM respacing when a call names none, the KV cache's spare slots."""
    params, state = weights
    cfg = tconfig("mla-tiny")
    pol = tmla.MLAPolicy(from_jax(params), from_jax(state), cfg, norm_stats=tpp.STATS, device="cpu",
                         num_ddim_steps=10, cache_margin=5)
    assert pol.cache_margin == 5 and len(pol.sched_ddim.timestep_map) == 10
    img, pc, ids, noise, _ = tpp.request()
    kw = dict(input_ids=ids, noise=noise, return_normalized=True)
    a = pol.predict_action_diff(img, pc, "", **kw)
    b = tpp.policies(params, state, quantized=False)[1].predict_action_diff(img, pc, "", num_ddim_steps=10, **kw)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
