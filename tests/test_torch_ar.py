"""The autoregressive heads of the port against the JAX package on the CPU:
the cached decode step, the action tokenizer, predict_action_ar, beam
search, text generation, predict_action_diff_ar and predict_action_batch
(cognition feature and DiT head). The models are mla-tiny widened to a
128-multiple decoder (hidden 128, intermediate 384, 4 heads), so that JAX's
weight-only kernel (MLA_INT8_MODE=pallas, K and N multiples of 128) fires
on every decoder linear; JAX's int8_matmul then runs in interpret mode.
Token selection needs no random draws in greedy decoding and beam search,
so those compare ids exactly; sampling is tested by its properties."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_policy_parity as tpp
from mla_tpu.conf.models import get_model_config as jconfig
from mla_tpu.models import action_model as jam
from mla_tpu.models import llama as jllama
from mla_tpu.models import mla as jmla
from mla_tpu.models import prismatic as jprismatic
from mla_tpu.ops import quantization as jq
from mla_tpu.vla.action_tokenizer import ActionTokenizer as JActionTokenizer
from mla_tpu_torch.conf.models import get_model_config as tconfig
from mla_tpu_torch.models import action_model as tam
from mla_tpu_torch.models import llama as tllama
from mla_tpu_torch.models import mla as tmla
from mla_tpu_torch.ops import quantization as tq
from mla_tpu_torch.params import from_jax, tree_items
from mla_tpu_torch.vla.action_tokenizer import ActionTokenizer as TActionTokenizer

WIDE = dict(hidden_size=128, intermediate_size=384, num_heads=4, num_kv_heads=4)
JAX_MODE = {"none": "dequant", "w8a8": "w8a8", "weight_only": "pallas"}


class ToyTokenizer:
    """A callable word tokenizer: BOS, then one id per word."""

    def __call__(self, text, add_special_tokens=True):
        return {"input_ids": [1] + [100 + sum(map(ord, w)) % 900 for w in text.split()]}

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


def _configs():
    j, t = jconfig("mla-tiny"), tconfig("mla-tiny")
    return dataclasses.replace(j, llama=dataclasses.replace(j.llama, **WIDE)), \
        dataclasses.replace(t, llama=dataclasses.replace(t.llama, **WIDE))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _configs()
    params, state = jprismatic.mla_model_init(jax.random.PRNGKey(7), jcfg)
    return jcfg, tcfg, params, state


def _trees(model, mode):
    """(JAX params, state, port params, state), both quantized by their own
    quantize_model unless mode is 'none'."""
    _, _, params, state = model
    tp, ts = from_jax(params), from_jax(state)
    if mode != "none":
        params, tp = jq.quantize_model(params), tq.quantize_model(tp)
    return params, state, tp, ts


def _policies(monkeypatch, model, mode, tokenizer=None):
    jcfg, tcfg = model[:2]
    params, state, tp, ts = _trees(model, mode)
    # the env must be set before the JAX policy first traces its graphs
    monkeypatch.setenv("MLA_INT8_MODE", JAX_MODE[mode])
    jpol = jmla.MLAPolicy(params, state, jcfg, tokenizer=tokenizer, norm_stats=tpp.STATS)
    tpol = tmla.MLAPolicy(tp, ts, tcfg, tokenizer=tokenizer, norm_stats=tpp.STATS, device="cpu",
                          int8_mode="weight_only" if mode == "weight_only" else "w8a8")
    return jpol, tpol


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def _obs(seed):
    img, pc, *_ = tpp.request(seed)
    return img, pc


def _np(t):
    return t.detach().float().numpy()


# --------------------------------------------------------------------------- #
# The cached decode step
# --------------------------------------------------------------------------- #


def _small_llama(num_kv_heads):
    jcfg = jllama.LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=384, num_layers=3, num_heads=4,
                              num_kv_heads=num_kv_heads, max_position_embeddings=64, contrastive_layer=1,
                              compute_dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
                                 if f.name not in ("param_dtype", "compute_dtype")}, compute_dtype=torch.float32)
    return jcfg, tcfg, jllama.llama_init(jax.random.PRNGKey(1), jcfg)


@pytest.mark.parametrize("mode,num_kv_heads", [("none", 4), ("none", 2), ("weight_only", 4)])
def test_decode_step_matches_jax(monkeypatch, mode, num_kv_heads, record_property):
    """A 3-token block written at cache_len > 0 and attended over the whole
    cache: last_hidden, logits and the written cache against JAX
    llama_forward (write-then-attend, causal from cache_len)."""
    monkeypatch.setenv("MLA_INT8_MODE", JAX_MODE[mode])
    jcfg, tcfg, jp = _small_llama(num_kv_heads)
    if mode != "none":
        jp = jq.quantize_llama(jp)
    jp = jllama.fuse_for_serving(jp)
    tp = from_jax(jp)
    P, S, Smax = 9, 3, 20
    rng = np.random.default_rng(num_kv_heads)
    prefix, block = rng.normal(size=(2, P, 128)).astype(np.float32), rng.normal(size=(2, S, 128)).astype(np.float32)
    km = np.arange(Smax)[None, :].repeat(2, 0) < P
    km2 = np.arange(Smax)[None, :].repeat(2, 0) < P + S
    jk = jllama.llama_forward(jp, jcfg, jnp.asarray(prefix), kv_cache=jllama.init_kv_cache(jcfg, 2, Smax),
                              key_mask=jnp.asarray(km), compute_logits=False, use_flash=False)["kv_cache"]
    jout = jllama.llama_forward(jp, jcfg, jnp.asarray(block), kv_cache=jk, cache_len=P, key_mask=jnp.asarray(km2))
    calls = _spy(monkeypatch, tq, "int8_matmul")
    tk = tllama.init_kv_cache(tcfg, 2, Smax)
    tllama.llama_forward(tp, tcfg, torch.from_numpy(prefix), kv_cache=tk, key_mask=torch.from_numpy(km),
                         compute_logits=False, int8_mode="weight_only")
    tout = tllama.llama_forward(tp, tcfg, torch.from_numpy(block), kv_cache=tk, cache_len=P,
                                key_mask=torch.from_numpy(km2), int8_mode="weight_only")
    # 2 forwards x 4 linears x 3 layers, and the int8 lm_head (fp32) of the
    # second forward
    assert len(calls) == (2 * 4 * 3 + 1 if mode == "weight_only" else 0)
    err = max(float(np.abs(_np(tout[k]) - np.asarray(jout[k])).max()) for k in ("last_hidden", "logits"))
    record_property("max_abs_err", err)
    # fp32: summation order only, through 3 layers
    for key in ("last_hidden", "logits"):
        np.testing.assert_allclose(_np(tout[key]), np.asarray(jout[key]), rtol=1e-4, atol=1e-5, err_msg=key)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tout["kv_cache"][key]), np.asarray(jout["kv_cache"][key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)


def test_cached_decode_equals_full_forward(model, record_property):
    """[prefix | t0 t1 t2] through the cache (static prefill, then one
    decode step per token) equals one causal forward over the whole
    sequence: the contract of test_prefix_cache_diffusion_is_exact for the
    write-then-attend path."""
    _, tcfg, params, _ = model
    bb = from_jax(params)["llm_backbone"]
    P, T = 11, 3
    seq = torch.from_numpy(np.random.default_rng(2).normal(size=(2, P + T, 128)).astype(np.float32))
    full = tllama.llama_forward(bb, tcfg.llama, seq)
    cache = tllama.init_kv_cache(tcfg.llama, 2, P + T + 4)
    tllama.llama_forward(bb, tcfg.llama, seq[:, :P], kv_cache=cache, key_mask=torch.arange(P + T + 4)[None] < P,
                         compute_logits=False)
    err = 0.0
    for i in range(T):
        km = (torch.arange(P + T + 4)[None] < P + i + 1).expand(2, -1)
        step = tllama.llama_forward(bb, tcfg.llama, seq[:, P + i : P + i + 1], kv_cache=cache, cache_len=P + i,
                                    key_mask=km)
        for key in ("last_hidden", "logits"):
            err = max(err, float((step[key][:, 0] - full[key][:, P + i]).abs().max()))
            np.testing.assert_allclose(_np(step[key][:, 0]), _np(full[key][:, P + i]), rtol=1e-5, atol=1e-5)
    record_property("max_abs_err", err)


def test_action_tokenizer_matches_jax():
    j, t = JActionTokenizer(vocab_size=32000), TActionTokenizer(vocab_size=32000)
    ids = np.arange(-5, 32064 + 5)
    np.testing.assert_array_equal(t.decode_token_ids_to_actions(ids), j.decode_token_ids_to_actions(ids))
    actions = np.linspace(-1.2, 1.2, 2001)
    np.testing.assert_array_equal(t.encode_to_ids(actions), j.encode_to_ids(actions))
    assert t.vocab_size == j.vocab_size and t.action_token_begin_idx == j.action_token_begin_idx


# --------------------------------------------------------------------------- #
# AR actions
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mode", ["none", "w8a8", "weight_only"])
def test_predict_action_ar_matches_jax(monkeypatch, model, mode, record_property):
    """The AR head in fp32: the port's predict_action_ar gives the actions
    and the per-token probabilities (rtol 1e-5) of JAX's greedy decode over
    the same policy weights, and its decode gives the same 7 token ids."""
    jpol, tpol = _policies(monkeypatch, model, mode)
    jcalls = _spy(monkeypatch, jq, "int8_matmul")
    tcalls = _spy(monkeypatch, tq, "int8_matmul")
    img, pc, ids, *_ = tpp.request()
    # int8 embedding rows are bf16 (rows * scale rounded to bf16) in both
    # packages; inside one jitted graph XLA may skip that rounding (excess
    # precision), which moves the decode steps' logits by ~1e-4. Op by op,
    # JAX rounds as written: run its int8 side so.
    with jax.disable_jit() if mode != "none" else contextlib.nullcontext():
        jprefix = jmla.build_prefix_embeds(jpol.params, jpol.state, jpol.cfg, jnp.asarray(ids),
                                           {"front_image": jnp.asarray(img)[None]}, jnp.asarray(pc)[None])
        jkv, jlast = jmla.prefill(jpol.params, jpol.cfg, jprefix, ids.shape[1] + jpol.cfg.fused_len + 7 + 32)
        jtoks, jprobs = jmla.greedy_decode_actions(jpol.params, jpol.cfg, jkv, jprefix.shape[1], jlast, 7)
    jtoks, jprobs = np.asarray(jtoks)[0], np.asarray(jprobs)[0]
    ta, tprobs = tpol.predict_action_ar(img, pc, "", input_ids=ids, return_probs=True)
    # the port's int8 lm_head (JAX's formula, in fp32) runs through
    # int8_matmul once per forward: the prefill and 7 decode steps
    heads = 0 if mode == "none" else 8
    if mode == "weight_only":
        # JAX ran its weight-only kernel (interpret mode) for every decoder
        # linear; the port ran int8_matmul for 4 linears x 4 layers x 8
        # forwards, and for the heads
        assert len(jcalls) == 4 * 4 * 8 and len(tcalls) == 4 * 4 * 8 + heads
    else:
        assert not jcalls and len(tcalls) == heads
    want = jmla.unnormalize_actions(jpol.action_tokenizer.decode_token_ids_to_actions(jtoks),
                                    jpol.get_action_stats())
    np.testing.assert_array_equal(ta, want)
    record_property("max_rel_err_probs", float(np.max(np.abs(np.array(tprobs) - jprobs) / jprobs)))
    np.testing.assert_allclose(tprobs, jprobs, rtol=1e-5)

    tprefix = tmla.build_prefix_embeds(tpol.params, tpol.state, tpol.cfg, torch.from_numpy(ids).long(),
                                       {"front_image": torch.from_numpy(img)[None]}, torch.from_numpy(pc)[None])
    tkv, tlast = tmla.prefill(tpol.params, tpol.cfg, tprefix, tprefix.shape[1] + 7 + 32, int8_mode=tpol.int8_mode)
    ttoks, _ = tmla.greedy_decode_actions(tpol.params, tpol.cfg, tkv, tprefix.shape[1], tlast, 7,
                                          int8_mode=tpol.int8_mode)
    np.testing.assert_array_equal(ttoks[0].numpy(), jtoks)


def test_predict_action_diff_weight_only_matches_jax(monkeypatch, model, record_property):
    """The diffusion head through the weight-only products (prefill and the
    read-only suffix steps) against JAX under MLA_INT8_MODE=pallas."""
    jpol, tpol = _policies(monkeypatch, model, "weight_only")
    tcalls = _spy(monkeypatch, tq, "int8_matmul")
    j, t = tpp.both(jpol, tpol, return_normalized=True)
    assert len(tcalls) == 4 * 4 * (1 + 8)  # 4 linears x 4 layers x (prefill + 8 DDIM steps)
    # exact int8 products in fp32; the bf16 int8 embedding rows may skip a
    # rounding inside JAX's jitted graph (see the AR test), and the first
    # denoise step scales eps by up to 1/sqrt(alpha_bar) ~ 10^2
    record_property("max_abs_err", float(np.abs(t - j).max()))
    np.testing.assert_allclose(t, j, rtol=1e-3, atol=1e-3)


# --------------------------------------------------------------------------- #
# Beam search and sampling
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def prefixes(model):
    """Two rows of [BOS | fused | ids[1:]] on both sides, fp32 weights."""
    jcfg, tcfg, params, state = model
    tp, ts = from_jax(params), from_jax(state)
    (i0, p0), (i1, p1) = _obs(1), _obs(2)
    ids = tpp.request()[2]
    ids2 = np.repeat(ids, 2, 0)
    jprefix = jmla.build_prefix_embeds(params, state, jcfg, jnp.asarray(ids2),
                                       {"front_image": jnp.asarray(np.stack([i0, i1]))}, jnp.asarray(np.stack([p0, p1])))
    tprefix = tmla.build_prefix_embeds(tp, ts, tcfg, torch.from_numpy(ids2).long(),
                                       {"front_image": torch.from_numpy(np.stack([i0, i1]))},
                                       torch.from_numpy(np.stack([p0, p1])))
    np.testing.assert_allclose(_np(tprefix), np.asarray(jprefix), rtol=1e-5, atol=1e-5)
    return jprefix, tprefix, tp


@pytest.mark.parametrize("K,with_eos,penalty", [(1, False, 1.0), (3, False, 1.0), (3, True, 1.0), (3, True, 2.0)])
def test_beam_search_matches_jax(model, prefixes, K, with_eos, penalty, record_property):
    """Two rows, K beams, 5 tokens: ids identical, scores within rtol 1e-5.
    With EOS set to row 0's second greedy token, a beam finishes mid-decode
    and must pad with EOS at a frozen score; the length penalty re-ranks."""
    jcfg, tcfg, params, _ = model
    jprefix, tprefix, tp = prefixes
    P, T = tprefix.shape[1], 5
    eos = -1
    if with_eos:
        kv, last = tmla.prefill(tp, tcfg, tprefix, P + T + 1)
        eos = int(tmla.greedy_decode_actions(tp, tcfg, kv, P, last, 2)[0][0, 1])
    jkv, jlast = jmla.prefill(params, jcfg, jprefix, P + T + 1)
    jt, js = jmla.beam_search_decode(params, jcfg, jkv, P, jlast, T, num_beams=K, eos_id=eos, length_penalty=penalty)
    tkv, tlast = tmla.prefill(tp, tcfg, tprefix, P + T + 1)
    tt, ts = tmla.beam_search_decode(tp, tcfg, tkv, P, tlast, T, num_beams=K, eos_id=eos, length_penalty=penalty)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    record_property("max_rel_err_scores", float(np.max(np.abs(ts.numpy() - np.asarray(js)) / np.abs(np.asarray(js)))))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    for row in tt.numpy():
        if eos in row:
            first = list(row).index(eos)
            assert (row[first:] == eos).all()
    if K == 1:
        kv, last = tmla.prefill(tp, tcfg, tprefix, P + T + 1)
        greedy, _ = tmla.greedy_decode_actions(tp, tcfg, kv, P, last, T)
        np.testing.assert_array_equal(tt.numpy(), greedy.numpy())


def test_sampling_properties(model, prefixes):
    """top_k=1 is greedy; every draw lies in its step's top-k; a seeded
    generator repeats its draws."""
    _, tcfg, _, _ = model
    _, tprefix, tp = prefixes
    P, T = tprefix.shape[1], 6

    def run(**kw):
        kv, last = tmla.prefill(tp, tcfg, tprefix, P + T + 1)
        return tmla.greedy_decode_actions(tp, tcfg, kv, P, last, T, **kw)[0]

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    greedy = run()
    np.testing.assert_array_equal(run(temperature=0.7, top_k=1, generator=gen(0)).numpy(), greedy.numpy())
    drawn = run(temperature=1.5, top_k=5, generator=gen(3))
    np.testing.assert_array_equal(run(temperature=1.5, top_k=5, generator=gen(3)).numpy(), drawn.numpy())
    kv, logits = tmla.prefill(tp, tcfg, tprefix, P + T + 1)
    for i in range(T):
        top = torch.topk(logits, 5, dim=-1).indices
        assert bool((top == drawn[:, i : i + 1]).any(-1).all()), i
        logits = tmla.decode_step(tp, tcfg, kv, P + i, drawn[:, i])
    assert not torch.equal(drawn, greedy)
    with pytest.raises(ValueError, match="Generator"):
        run(temperature=1.0)


# --------------------------------------------------------------------------- #
# Text generation and the combined heads
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("num_beams", [1, 2])
def test_generate_text_matches_jax(monkeypatch, model, num_beams):
    """generate_text and generate_text_batch (prompts of two token lengths,
    grouped into two batches) give JAX's strings."""
    jpol, tpol = _policies(monkeypatch, model, "none", tokenizer=ToyTokenizer())
    (i0, p0), (i1, p1), (i2, p2) = _obs(1), _obs(2), _obs(3)
    prompts = ["close the box", "open the drawer", "open it"]
    kw = dict(max_new_tokens=4, num_beams=num_beams)
    tb = tpol.generate_text_batch([i0, i1, i2], [p0, p1, p2], prompts, **kw)
    assert tb == jpol.generate_text_batch([i0, i1, i2], [p0, p1, p2], prompts, **kw)
    assert tpol.generate_text(i2, p2, prompts[2], **kw) == tb[2]
    assert all(len(s.split()) <= 4 for s in tb)


def test_generate_text_sampled_and_to_eos(model):
    _, tcfg, params, state = model
    tpol = tmla.MLAPolicy(from_jax(params), from_jax(state), tcfg, tokenizer=ToyTokenizer(), device="cpu")
    img, pc = _obs(1)
    a = tpol.generate_text(img, pc, "close the box", max_new_tokens=4, temperature=0.9, top_k=4, seed=3)
    assert a == tpol.generate_text(img, pc, "close the box", max_new_tokens=4, temperature=0.9, top_k=4, seed=3)
    assert tpol._decode_to_eos(np.array([5, 6, tmla.EOS_ID, 7])) == "5 6"
    with pytest.raises(ValueError, match="mutually exclusive"):
        tpol.generate_text(img, pc, "close the box", num_beams=2, temperature=0.5)


def test_predict_action_diff_ar(monkeypatch, model, record_property):
    """The AR half equals JAX's; the diffusion half equals the port's own
    predict_action_diff at the same seed (the JAX package draws its noise
    from its own generator, which the port cannot reproduce)."""
    jpol, tpol = _policies(monkeypatch, model, "none", tokenizer=ToyTokenizer())
    img, pc, _, _, rstate = tpp.request()
    j = jpol.predict_action_diff_ar(img, pc, "close the box", cur_robot_state=rstate, seed=5)
    t = tpol.predict_action_diff_ar(img, pc, "close the box", cur_robot_state=rstate, seed=5)
    np.testing.assert_array_equal(t["ar_actions"], np.asarray(j["ar_actions"]))
    record_property("max_rel_err_probs",
                    float(np.max(np.abs(np.array(t["ar_max_probs"]) - j["ar_max_probs"]) / j["ar_max_probs"])))
    np.testing.assert_allclose(t["ar_max_probs"], j["ar_max_probs"], rtol=1e-5)
    own = tpol.predict_action_diff(img, pc, "close the box", cur_robot_state=rstate, seed=5)
    np.testing.assert_array_equal(t["actions"], own)
    assert t["actions"].shape == (16, 7) and len(t["timings"]) == 2 and min(t["timings"]) > 0


@pytest.mark.parametrize("steps", [dict(sampler="dpm", num_dpm_steps=3), dict(num_ddim_steps=5)],
                         ids=["dpm3", "ddim5"])
def test_predict_action_diff_ar_step_counts(monkeypatch, model, steps, record_property):
    """num_dpm_steps and num_ddim_steps reach the diffusion half as in JAX:
    the same x_T injected into both policies' predict_action_diff (and the
    chunk returned before the clip, which saturates mla-tiny's), a live
    final layer (the init's zero fc2 makes eps 0), and the chunk held at the
    fp32 chunk tolerance of tests/test_torch_policy_fp32.py (1e-4); the AR
    half as in test_predict_action_diff_ar. The default step count gives
    another chunk, so the argument is not ignored."""
    jcfg, tcfg, params, state = model
    params = jax.tree_util.tree_map(lambda x: x, params)
    fc2 = params["final_layer"]["mlp"]["fc2"]
    fc2["w"] = jnp.asarray(np.random.default_rng(11).normal(size=fc2["w"].shape).astype(np.float32) * 0.05)
    monkeypatch.setenv("MLA_INT8_MODE", JAX_MODE["none"])
    jpol = jmla.MLAPolicy(params, state, jcfg, tokenizer=ToyTokenizer(), norm_stats=tpp.STATS)
    tpol = tmla.MLAPolicy(from_jax(params), from_jax(state), tcfg, tokenizer=ToyTokenizer(), norm_stats=tpp.STATS,
                          device="cpu")
    img, pc, _, noise, rstate = tpp.request()
    for pol in (jpol, tpol):
        real = pol.predict_action_diff
        monkeypatch.setattr(pol, "predict_action_diff", lambda *a, real=real, **k: real(*a, noise=noise, return_normalized=True, **k))
    j = jpol.predict_action_diff_ar(img, pc, "close the box", cur_robot_state=rstate, unnorm_key="rlbench", **steps)
    t = tpol.predict_action_diff_ar(img, pc, "close the box", cur_robot_state=rstate, unnorm_key="rlbench", **steps)
    np.testing.assert_array_equal(t["ar_actions"], np.asarray(j["ar_actions"]))
    np.testing.assert_allclose(t["ar_max_probs"], j["ar_max_probs"], rtol=1e-5)
    record_property("max_abs_err", float(np.abs(t["actions"] - np.asarray(j["actions"])).max()))
    np.testing.assert_allclose(t["actions"], np.asarray(j["actions"]), rtol=1e-4, atol=1e-4)
    default = tpol.predict_action_diff_ar(img, pc, "close the box", cur_robot_state=rstate, unnorm_key="rlbench",
                                          sampler=steps.get("sampler", "ddim"))
    assert np.abs(default["actions"] - t["actions"]).max() > 1e-3


# --------------------------------------------------------------------------- #
# predict_action_batch: cognition feature and DiT head
# --------------------------------------------------------------------------- #


def _dit(token_size):
    jcfg = jam.dit_config("DiT-S", token_size=token_size, in_channels=7, future_action_window_size=15)
    tcfg = tam.dit_config("DiT-S", token_size=token_size, in_channels=7, future_action_window_size=15)
    params = jam.dit_init(jax.random.PRNGKey(9), jcfg)
    # the reference zero-inits the final fc2; a live one makes eps depend on x
    fc2 = params["final_layer"]["mlp"]["fc2"]
    fc2["w"] = jnp.asarray(np.random.default_rng(9).normal(size=fc2["w"].shape).astype(np.float32) * 0.05)
    return jcfg, tcfg, params


def test_predict_action_batch_parts_match_jax(model, record_property):
    jcfg, tcfg, params, state = model
    tp, ts = from_jax(params), from_jax(state)
    tok = ToyTokenizer()
    ids_list = [jmla.build_prompt_ids(tok, s, mode="ar") for s in ("close the box", "open the top drawer now")]
    ids = np.full((2, max(x.shape[1] for x in ids_list)), tmla.PAD_ID, np.int32)
    for i, x in enumerate(ids_list):
        ids[i, : x.shape[1]] = x[0]
    (i0, p0), (i1, p1) = _obs(1), _obs(2)
    imgs, pcs = np.stack([i0, i1]), np.stack([p0, p1])
    jprefix = jmla.build_prefix_embeds(params, state, jcfg, jnp.asarray(ids), {"front_image": jnp.asarray(imgs)},
                                       jnp.asarray(pcs))
    jz = np.asarray(jllama.llama_forward(params["llm_backbone"], jcfg.llama, jprefix,
                                         compute_logits=False)["last_hidden"][:, -1:])
    tz = tmla.cognition_feature(tp, ts, tcfg, torch.from_numpy(ids).long(), {"front_image": torch.from_numpy(imgs)},
                                torch.from_numpy(pcs))
    assert tz.shape == (2, 1, 128) and tz.dtype == torch.float32
    errs = {"cognition": float(np.abs(_np(tz) - jz).max())}
    np.testing.assert_allclose(_np(tz), jz, rtol=1e-5, atol=1e-5)

    djcfg, dtcfg, dparams = _dit(128)
    dtp = from_jax(dparams)
    rng = np.random.default_rng(11)
    x, z = rng.normal(size=(2, 16, 7)).astype(np.float32), rng.normal(size=(2, 1, 128)).astype(np.float32)
    t = np.array([3, 70], np.int32)
    jeps = np.asarray(jam.dit_forward(dparams, djcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(z)))
    teps = _np(tam.dit_forward(dtp, dtcfg, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(z)))
    errs["dit_forward"] = float(np.abs(teps - jeps).max())
    np.testing.assert_allclose(teps, jeps, rtol=1e-5, atol=1e-5)
    x2, t2 = np.concatenate([x, x]), np.concatenate([t, t])
    z2 = np.concatenate([z, np.repeat(np.asarray(dparams["uncondition"])[None], 2, 0)])
    jg = np.asarray(jam.dit_forward_with_cfg(dparams, djcfg, jnp.asarray(x2), jnp.asarray(t2), jnp.asarray(z2), 1.5))
    tg = _np(tam.dit_forward_with_cfg(dtp, dtcfg, *(torch.from_numpy(a) for a in (x2, t2, z2)), 1.5))
    errs["dit_forward_with_cfg"] = float(np.abs(tg - jg).max())
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5)
    record_property("max_abs_err", errs)

    pol = tmla.MLAPolicy(tp, ts, tcfg, tokenizer=tok, norm_stats=tpp.STATS, device="cpu")
    out = pol.predict_action_batch([i0, i1], [p0, p1], ["close the box", "open the top drawer now"],
                                   action_model_params=dtp, action_model_cfg=dtcfg, num_ddim_steps=3)
    assert out.shape == (2, 16, 7) and np.isfinite(out).all()


def test_dit_init_has_the_jax_layout():
    def shapes(tree):
        return {path: (tuple(t.shape), t.dtype) for path, t in tree_items(tree)}

    jp = from_jax(jam.dit_init(jax.random.PRNGKey(0), jam.dit_config("DiT-S", token_size=64)))
    tp = tam.dit_init(tam.dit_config("DiT-S", token_size=64), seed=0, device="cpu")
    assert shapes(tp) == shapes(jp)
    assert float(tp["final_layer"]["mlp"]["fc2"]["w"].abs().max()) == 0.0
