"""The whole slice on mla-tiny in fp32: predict_action_diff of the port
against the JAX package (same weights, ids and noise), plus the port's own
serving contracts (prefix-cache exactness, batched serving, device choice)."""

import numpy as np
import pytest
import torch

import torch_policy_parity as tpp
from mla_tpu_torch.models import llama as tllama
from mla_tpu_torch.models import mla as tmla
from mla_tpu_torch.params import from_jax


@pytest.fixture(scope="module")
def fp32_pair():
    params, state = tpp.model()
    return tpp.policies(params, state, quantized=False)


@pytest.mark.parametrize("sampler,cfg_scale", [("ddim", 0.0), ("ddim", 3.0), ("dpm", 0.0), ("dpm", 3.0)])
def test_predict_action_diff_matches_jax_fp32(fp32_pair, sampler, cfg_scale, record_property):
    jpol, tpol = fp32_pair
    j, t = tpp.both(jpol, tpol, sampler=sampler, cfg_scale=cfg_scale, return_normalized=True)
    assert t.shape == (16, 7) and np.isfinite(t).all()
    # fp32 end to end; matmul summation order differs between XLA and
    # PyTorch (~1e-7 relative), and the first denoise step scales eps by up
    # to 1/sqrt(alpha_bar) ~ 10^2 on the 100-step cosine schedule
    record_property("max_abs_err", float(np.abs(t - j).max()))
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


def test_unnormalized_chunk_matches_jax(fp32_pair):
    jpol, tpol = fp32_pair
    j, t = tpp.both(jpol, tpol)
    # clip, gripper binarize and q01/q99 map on top of the normalized chunk
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
    assert set(np.unique(t[:, 6])) <= {0.0, 1.0}


def test_prefix_cache_diffusion_is_exact(record_property):
    """The cached read-only suffix forward equals one causal forward over
    [prefix | proprio, t, x] (the contract of test_model.py's prefix-cache
    test, on the port's own decoder)."""
    params, state = tpp.model()
    cfg = tpp.tconfig("mla-tiny")
    tp, ts = from_jax(params), from_jax(state)
    img, pc, ids, noise, _ = tpp.request()
    x = torch.from_numpy(noise)[None]
    t = torch.tensor([42])
    proprio = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, size=(1, 1, 7)).astype(np.float32))
    prefix = tmla.build_prefix_embeds(tp, ts, cfg, torch.from_numpy(ids[:, :-1]).long(),
                                      {"front_image": torch.from_numpy(img)[None]}, torch.from_numpy(pc)[None])
    P = prefix.shape[1]
    kv, _ = tmla.prefill(tp, cfg, prefix, P + 2 + cfg.action_horizon + 9, compute_logits=False)
    eps_cached = tmla.make_suffix_denoise_fn(tp, cfg, kv, P, proprio)(x, t)

    emb = tmla.embedders
    suffix = torch.cat([emb.action_embedder(tp["proprio_embedder"], proprio),
                        emb.timestep_embedder(tp["t_embedder"], t)[:, None], emb.action_embedder(tp["x_embedder"], x)], 1)
    full = tllama.llama_forward(tp["llm_backbone"], cfg.llama, torch.cat([prefix, suffix], 1), compute_logits=False)
    eps_full = emb.final_layer(tp["final_layer"], full["last_hidden"][:, P + 2:])
    record_property("max_abs_err", float((eps_cached - eps_full).abs().max()))
    np.testing.assert_allclose(eps_cached.numpy(), eps_full.numpy(), atol=2e-5, rtol=1e-5)


def test_batched_and_ddpm_serving(fp32_pair):
    _, tpol = fp32_pair
    img, pc, ids, noise, rstate = tpp.request()
    out = tpol.predict_action_diff_batched(np.stack([img, img]), np.stack([pc, pc]), input_ids=ids,
                                           cur_robot_states=[rstate, None], sampler="dpm")
    assert out.shape == (2, 16, 7) and np.isfinite(out).all()
    ddpm = tpol.predict_action_diff(img, pc, "", input_ids=ids, use_ddim=False, seed=3, return_normalized=True)
    assert ddpm.shape == (16, 7) and np.isfinite(ddpm).all()
    with pytest.raises(ValueError):
        tpol.predict_action_diff(img, pc, "", input_ids=ids, use_ddim=False, sampler="dpm")


def test_prompt_ids_take_any_tokenizer():
    def tok(prompt, add_special_tokens=True):
        return {"input_ids": [1] + [100 + len(w) for w in prompt.split()]}

    diff, ar = tmla.build_prompt_ids(tok, "Close the box"), tmla.build_prompt_ids(tok, "Close the box", mode="ar")
    assert diff[0, -1] == tmla.EMPTY_ID and ar[0, -1] == tmla.EMPTY_ID and diff.dtype == np.int32


def test_policy_defaults_to_the_card(monkeypatch):
    params, state = tpp.model()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmla.MLAPolicy(from_jax(params), from_jax(state), tpp.tconfig("mla-tiny"))
