"""The serving slice on the phi decoder family: a tiny composed model with a
Phi decoder (mla-tiny's front-ends; the decoder of tests/test_phi.py's
composed model: hidden 64, 4 layers, 4 heads, partial_rotary_factor 0.5),
initialized by the JAX package and carried across with params.from_jax.
The port's MLAPolicy on the CPU against the JAX package's: predict_action_diff
(DDIM-8 and DPM-4, with and without guidance, explicit noise),
predict_action_ar ids and probabilities, greedy and beam generate_text,
predict_action_diff_ar, the cognition feature of predict_action_batch, and
the KV cache left bitwise unchanged by a chunk. Also the mla-phi preset."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_policy_parity as tpp
from mla_tpu.conf.models import get_model_config as jconfig
from mla_tpu.models import mla as jmla
from mla_tpu.models import phi as jphi
from mla_tpu.models import prismatic as jprismatic
from mla_tpu_torch.conf.models import get_model_config as tconfig
from mla_tpu_torch.models import mla as tmla
from mla_tpu_torch.models import phi as tphi
from mla_tpu_torch.models import prismatic as tprismatic
from mla_tpu_torch.params import from_jax

PHI_FIELDS = dict(vocab_size=32064, hidden_size=64, intermediate_size=128, num_layers=4, num_heads=4,
                  contrastive_layer=2, partial_rotary_factor=0.5)


def phi_configs(**flags):
    """(JAX, port) mla-tiny configs with the tiny Phi decoder."""
    j, t = jconfig("mla-tiny", **flags), tconfig("mla-tiny", **flags)
    return (dataclasses.replace(j, llm_family="phi", llama=jphi.PhiConfig(**PHI_FIELDS, compute_dtype=jnp.float32)),
            dataclasses.replace(t, llm_family="phi", llama=tphi.PhiConfig(**PHI_FIELDS, compute_dtype=torch.float32)))


def phi_model(jcfg, seed: int = 0):
    """JAX (params, state) with a live diffusion head and CFG vector (both
    zero in the reference init) and live decoder biases and LayerNorms
    (JAX's phi_init sets them to zero and one)."""
    params, state = jprismatic.mla_model_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 100)
    fc2 = params["final_layer"]["mlp"]["fc2"]
    fc2["w"] = jnp.asarray(rng.normal(size=fc2["w"].shape).astype(np.float32) * 0.05)
    params["z_embedder"]["uncondition"] = jnp.asarray(rng.normal(size=(1, jcfg.token_size)).astype(np.float32))
    bb = params["llm_backbone"]
    for path in (("layers", "attn", "o", "b"), ("layers", "attn", "q", "b"), ("layers", "mlp", "fc1", "b"),
                 ("layers", "ln", "bias"), ("final_ln", "bias"), ("lm_head", "b")):
        node = bb
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = node[path[-1]] + jnp.asarray(rng.normal(size=node[path[-1]].shape).astype(np.float32) * 0.02)
    return params, state


class ToyTokenizer:
    """A callable word tokenizer: BOS, then one id per word."""

    def __call__(self, text, add_special_tokens=True):
        return {"input_ids": [1] + [100 + sum(map(ord, w)) % 900 for w in text.split()]}

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = phi_configs()
    params, state = phi_model(jcfg)
    return jcfg, tcfg, params, state


@pytest.fixture(scope="module")
def pair(model):
    jcfg, tcfg, params, state = model
    tok = ToyTokenizer()
    jpol = jmla.MLAPolicy(params, state, jcfg, tokenizer=tok, norm_stats=tpp.STATS)
    tpol = tmla.MLAPolicy(from_jax(params), from_jax(state), tcfg, tokenizer=tok, norm_stats=tpp.STATS, device="cpu")
    return jpol, tpol


def _np(t):
    return t.detach().float().numpy()


def test_mla_phi_preset():
    """mla-phi as test_phi.py's test_phi_and_mistral_registry_presets holds
    JAX's: the phi family at Phi-2's width, the heads at 2560."""
    cfg = tconfig("mla-phi")
    assert cfg.llm_family == "phi" and isinstance(cfg.llama, tphi.PhiConfig)
    assert cfg.token_size == 2560 and cfg.gen.token_size == 2560
    assert (cfg.llama.head_dim, cfg.llama.rotary_dim, cfg.llama.num_layers) == (80, 32, 32)
    assert cfg.llama.param_dtype == torch.bfloat16
    assert tprismatic.get_decoder(cfg) is tphi
    assert tconfig("mla-mistral").llama.num_kv_heads == 8


def test_phi_policy_serves_the_tree_unfused(pair):
    """JAX fuses q|k|v and gate|up for llama only; the phi tree is served
    as it is. The action tokens sit below id 32000 on Phi's vocabulary too,
    as in JAX."""
    jpol, tpol = pair
    assert set(tpol.params["llm_backbone"]["layers"]["attn"]) == {"q", "k", "v", "o"}
    assert set(tpol.params["llm_backbone"]["layers"]["mlp"]) == {"fc1", "fc2"}
    assert tpol.action_tokenizer.action_token_begin_idx == jpol.action_tokenizer.action_token_begin_idx


@pytest.mark.parametrize("sampler,cfg_scale", [("ddim", 0.0), ("ddim", 3.0), ("dpm", 0.0), ("dpm", 3.0)])
def test_predict_action_diff_matches_jax(pair, sampler, cfg_scale, record_property):
    """fp32 end to end (tests/test_torch_policy_fp32.py's tolerance): sums
    in another order, and the first denoise step scales eps by up to
    1/sqrt(alpha_bar) ~ 10^2 on the 100-step cosine schedule."""
    jpol, tpol = pair
    j, t = tpp.both(jpol, tpol, sampler=sampler, cfg_scale=cfg_scale, return_normalized=True)
    assert t.shape == (16, 7) and np.isfinite(t).all()
    record_property("max_abs_err", float(np.abs(t - j).max()))
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


def test_kv_cache_unchanged_by_a_chunk(model, record_property):
    """A DDIM-8 chunk's 8 read-only suffix evaluations leave the prefix
    cache bitwise as the prefill wrote it, and the cached eps equals one
    causal forward over [prefix | proprio, t, x]."""
    _, tcfg, params, state = model
    tp, ts = from_jax(params), from_jax(state)
    img, pc, ids, noise, _ = tpp.request()
    prefix = tmla.build_prefix_embeds(tp, ts, tcfg, torch.from_numpy(ids[:, :-1]).long(),
                                      {"front_image": torch.from_numpy(img)[None]}, torch.from_numpy(pc)[None])
    P = prefix.shape[1]
    kv, _ = tmla.prefill(tp, tcfg, prefix, P + 2 + tcfg.action_horizon + 9, compute_logits=False)
    before = {k: v.clone() for k, v in kv.items()}
    proprio = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, size=(1, 1, 7)).astype(np.float32))
    sched = tmla.gd.create_schedule("ddim8", diffusion_steps=100)
    out = tmla.ddim_denoise_actions(tp, tcfg, sched, kv, P, proprio, torch.from_numpy(noise)[None])
    assert out.shape == (1, 16, 7)
    for k in ("k", "v"):
        assert torch.equal(kv[k], before[k]), k
    assert float(kv["k"][:, :, :, P:].abs().max()) == 0.0

    x, t = torch.from_numpy(noise)[None], torch.tensor([42])
    eps_cached = tmla.make_suffix_denoise_fn(tp, tcfg, kv, P, proprio)(x, t)
    emb = tmla.embedders
    suffix = torch.cat([emb.action_embedder(tp["proprio_embedder"], proprio),
                        emb.timestep_embedder(tp["t_embedder"], t)[:, None], emb.action_embedder(tp["x_embedder"], x)], 1)
    full = tphi.phi_forward(tp["llm_backbone"], tcfg.llama, torch.cat([prefix, suffix], 1), compute_logits=False)
    eps_full = emb.final_layer(tp["final_layer"], full["last_hidden"][:, P + 2:])
    record_property("max_abs_err", float((eps_cached - eps_full).abs().max()))
    np.testing.assert_allclose(_np(eps_cached), _np(eps_full), atol=2e-5, rtol=1e-5)


def test_predict_action_ar_matches_jax(pair, record_property):
    """Greedy AR decode of 7 action tokens over Phi's 32064-id vocabulary:
    the same ids and actions as JAX, the per-token probabilities within
    rtol 1e-5 (tests/test_torch_ar.py's tolerance)."""
    jpol, tpol = pair
    img, pc, ids, *_ = tpp.request()
    ja, jprobs = jpol.predict_action_ar(img, pc, "", input_ids=ids, return_probs=True)
    ta, tprobs = tpol.predict_action_ar(img, pc, "", input_ids=ids, return_probs=True)
    np.testing.assert_array_equal(ta, np.asarray(ja))
    record_property("max_rel_err_probs", float(np.max(np.abs(np.array(tprobs) - jprobs) / np.array(jprobs))))
    np.testing.assert_allclose(tprobs, jprobs, rtol=1e-5)

    jprefix = jmla.build_prefix_embeds(jpol.params, jpol.state, jpol.cfg, jnp.asarray(ids),
                                       {"front_image": jnp.asarray(img)[None]}, jnp.asarray(pc)[None])
    jkv, jlast = jmla.prefill(jpol.params, jpol.cfg, jprefix, jprefix.shape[1] + 7 + 32)
    jtoks, _ = jmla.greedy_decode_actions(jpol.params, jpol.cfg, jkv, jprefix.shape[1], jlast, 7)
    tprefix = tmla.build_prefix_embeds(tpol.params, tpol.state, tpol.cfg, torch.from_numpy(ids).long(),
                                       {"front_image": torch.from_numpy(img)[None]}, torch.from_numpy(pc)[None])
    tkv, tlast = tmla.prefill(tpol.params, tpol.cfg, tprefix, tprefix.shape[1] + 7 + 32)
    np.testing.assert_allclose(_np(tlast), np.asarray(jlast), rtol=1e-5, atol=1e-5)
    ttoks, _ = tmla.greedy_decode_actions(tpol.params, tpol.cfg, tkv, tprefix.shape[1], tlast, 7)
    np.testing.assert_array_equal(ttoks[0].numpy(), np.asarray(jtoks)[0])


@pytest.mark.parametrize("num_beams", [1, 3])
def test_generate_text_matches_jax(pair, num_beams):
    """Greedy and beam generate_text, and generate_text_batch over prompts
    of two token lengths, give JAX's strings."""
    jpol, tpol = pair
    (i0, p0), (i1, p1) = (tpp.request(s)[:2] for s in (1, 2))
    prompts = ["close the box", "open the top drawer"]
    kw = dict(max_new_tokens=5, num_beams=num_beams)
    assert tpol.generate_text(i0, p0, prompts[0], **kw) == jpol.generate_text(i0, p0, prompts[0], **kw)
    assert tpol.generate_text_batch([i0, i1], [p0, p1], prompts, **kw) == \
        jpol.generate_text_batch([i0, i1], [p0, p1], prompts, **kw)


def test_predict_action_diff_ar_matches_jax(pair, record_property):
    """The AR half equals JAX's; the diffusion half equals the port's own
    predict_action_diff at the same seed (the packages' noise generators
    differ)."""
    jpol, tpol = pair
    img, pc, _, _, rstate = tpp.request()
    j = jpol.predict_action_diff_ar(img, pc, "close the box", cur_robot_state=rstate, seed=5)
    t = tpol.predict_action_diff_ar(img, pc, "close the box", cur_robot_state=rstate, seed=5)
    np.testing.assert_array_equal(t["ar_actions"], np.asarray(j["ar_actions"]))
    record_property("max_rel_err_probs",
                    float(np.max(np.abs(np.array(t["ar_max_probs"]) - j["ar_max_probs"]) / j["ar_max_probs"])))
    np.testing.assert_allclose(t["ar_max_probs"], j["ar_max_probs"], rtol=1e-5)
    own = tpol.predict_action_diff(img, pc, "close the box", cur_robot_state=rstate, seed=5)
    np.testing.assert_array_equal(t["actions"], own)


def test_cognition_feature_matches_jax(model, record_property):
    """predict_action_batch's condition: the phi decoder's final-normed
    hidden state at the last position of [BOS | fused | ids[1:]]."""
    jcfg, tcfg, params, state = model
    tp, ts = from_jax(params), from_jax(state)
    (i0, p0), (i1, p1) = (tpp.request(s)[:2] for s in (1, 2))
    ids = np.array([[1, 500, 600, 700, 29871], [1, 510, 610, 29871, tmla.PAD_ID]], np.int32)
    imgs, pcs = np.stack([i0, i1]), np.stack([p0, p1])
    jprefix = jmla.build_prefix_embeds(params, state, jcfg, jnp.asarray(ids), {"front_image": jnp.asarray(imgs)},
                                       jnp.asarray(pcs))
    jz = np.asarray(jphi.phi_forward(params["llm_backbone"], jcfg.llama, jprefix,
                                     compute_logits=False)["last_hidden"][:, -1:])
    tz = tmla.cognition_feature(tp, ts, tcfg, torch.from_numpy(ids).long(), {"front_image": torch.from_numpy(imgs)},
                                torch.from_numpy(pcs))
    assert tz.shape == (2, 1, 64) and tz.dtype == torch.float32
    record_property("max_abs_err", float(np.abs(_np(tz) - jz).max()))
    np.testing.assert_allclose(_np(tz), jz, rtol=1e-5, atol=1e-5)
