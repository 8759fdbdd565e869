"""mla-mistral's decoder shape, GQA, against the JAX package on the CPU: a
composed mla-tiny widened to hidden 128 / intermediate 384 with 4 query
heads over 1 KV head (Mistral-7B's 32 over 8 is 4:1 too), served in each
int8 mode of the port against JAX's (the chunk within 1e-4, W8A8's within
5e-3 of its scale, its decoder exact on equal inputs; W8A8: JAX's Pallas W8A8 in interpret
mode on the leaves it takes, MLA_INT8_MODE=w8a8_pallas; weight-only: its
weight-only kernel in interpret mode, MLA_INT8_MODE=pallas; dequant), the
AR ids of the weight-only policy, and the GQA training loss with each
gradient leaf within 1e-6 + 1e-4 of its own scale (tests/
test_torch_post_train.py's rule), the repeat's backward summing the query
heads' dK/dV into their KV head."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_policy_parity as tpp
from mla_tpu.conf.models import get_model_config as jconfig
from mla_tpu.models import llama as jllama
from mla_tpu.models import mla as jmla
from mla_tpu.models import prismatic as jprismatic
from mla_tpu.ops import quantization as jq
from mla_tpu_torch.conf.models import get_model_config as tconfig
from mla_tpu_torch.models import llama as tllama
from mla_tpu_torch.models import mla as tmla
from mla_tpu_torch.ops import quantization as tq
from mla_tpu_torch.training.strategy import as_tensors
from torch_train_parity import batch, from_jax, jax_draws, jgd, tgd, trainable, tree_items

GQA = dict(hidden_size=128, intermediate_size=384, num_heads=4, num_kv_heads=1)
JAX_MODE = {"w8a8": "w8a8_pallas", "weight_only": "pallas", "dequant": "dequant"}
REP, B = 2, 2


def configs(**fields):
    j, t = jconfig("mla-tiny"), tconfig("mla-tiny")
    return (dataclasses.replace(j, llama=dataclasses.replace(j.llama, **fields)),
            dataclasses.replace(t, llama=dataclasses.replace(t.llama, **fields)))


def test_mistral_preset_is_gqa_and_matches_jax():
    j, t = jconfig("mla-mistral").llama, tconfig("mla-mistral").llama
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads", "num_kv_heads",
              "max_position_embeddings", "rope_theta", "rms_eps", "contrastive_layer"):
        assert getattr(t, f) == getattr(j, f), f
    assert (t.num_heads, t.num_kv_heads, t.intermediate_size) == (32, 8, 14336)


@pytest.fixture(scope="module")
def gqa_model():
    jcfg, tcfg = configs(**GQA)
    params, state = jprismatic.mla_model_init(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(103)
    fc2 = params["final_layer"]["mlp"]["fc2"]
    fc2["w"] = jnp.asarray(rng.normal(size=fc2["w"].shape).astype(np.float32) * 0.05)
    params["z_embedder"]["uncondition"] = jnp.asarray(rng.normal(size=(1, jcfg.token_size)).astype(np.float32))
    assert params["llm_backbone"]["layers"]["attn"]["k"]["w"].shape == (4, 128, 32)
    return jcfg, tcfg, params, state


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def _policies(monkeypatch, gqa_model, mode):
    jcfg, tcfg, params, state = gqa_model
    tp, ts = tq.quantize_model(from_jax(params)), from_jax(state)
    # the env must be set before the JAX policy first traces its graphs
    monkeypatch.setenv("MLA_INT8_MODE", JAX_MODE[mode])
    jpol = jmla.MLAPolicy(jq.quantize_model(params), state, jcfg, norm_stats=tpp.STATS)
    tpol = tmla.MLAPolicy(tp, ts, tcfg, norm_stats=tpp.STATS, device="cpu", int8_mode=mode)
    return jpol, tpol


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
@pytest.mark.parametrize("mode", ["w8a8", "weight_only", "dequant"])
def test_gqa_policy_chunk_matches_jax(monkeypatch, gqa_model, mode, sampler, record_property):
    jpol, tpol = _policies(monkeypatch, gqa_model, mode)
    jw8a8, jwo = _spy(monkeypatch, jq, "w8a8_matmul"), _spy(monkeypatch, jq, "int8_matmul")
    tw8a8, two = _spy(monkeypatch, tq, "w8a8_matmul"), _spy(monkeypatch, tq, "int8_matmul")
    with jax.disable_jit() if mode != "w8a8" else contextlib.nullcontext():
        j, t = tpp.both(jpol, tpol, sampler=sampler, return_normalized=True)
    evals = 8 if sampler == "ddim" else 4
    if mode == "w8a8":
        # the port: 4 linears x 4 layers x (prefill + evaluations); JAX's
        # Pallas W8A8 on the 2-D leaves it takes (o, gate|up, down; N = 192
        # of q|k|v is no multiple of 128) at the suffix's 18 rows, traced
        # once per graph
        assert len(tw8a8) == 4 * 4 * (1 + evals) and not two
        assert jw8a8
    elif mode == "weight_only":
        # the same rule in both: o, gate|up and down through the kernel
        assert len(two) == 3 * 4 * (1 + evals) == len(jwo) and not tw8a8
    else:
        assert not (tw8a8 or two or jwo)
    assert t.shape == (16, 7) and np.isfinite(t).all()
    scale = float(np.abs(j).max())
    record_property("max_abs_err", float(np.abs(t - j).max()))
    record_property("max_err_of_scale", float(np.abs(t - j).max()) / scale)
    if mode == "w8a8":
        # the decoder is exact on equal inputs (test_gqa_w8a8_decoder_matches_
        # jax_exactly), but W8A8 quantizes every suffix row of every step: the
        # denoise loop's fp32 updates differ in the last bits between the
        # packages, which moves a rare activation across a rounding boundary
        # of its int8 quantization (one step is 1/127 of its row's max), and
        # the first DDIM steps scale eps by up to 1/sqrt(alpha_bar) ~ 10^2
        assert float(np.abs(t - j).max()) <= 5e-3 * scale
    else:
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


def test_gqa_w8a8_decoder_matches_jax_exactly(monkeypatch, record_property):
    """The GQA decoder under W8A8 on equal inputs: the static prefill, its
    KV cache and a read-only 18-row suffix against JAX's w8a8 branch; the
    cache is left untouched by the suffix."""
    monkeypatch.setenv("MLA_INT8_MODE", "w8a8")
    jcfg, tcfg = configs(**GQA)
    params, _ = jprismatic.mla_model_init(jax.random.PRNGKey(3), jcfg)
    jp = jllama.fuse_for_serving(jq.quantize_llama(params["llm_backbone"]))
    tp = tllama.fuse_for_serving(tq.quantize_llama(from_jax(params["llm_backbone"])), k_major=True)
    assert tp["layers"]["attn"]["qkv_fused"]["w_qt"].shape == (4, 128 + 2 * 32, 128)
    lc, tc = jcfg.llama, tcfg.llama
    P, S, Smax = 40, 18, 80
    rng = np.random.default_rng(0)
    x, suf = rng.normal(size=(2, P, 128)).astype(np.float32), rng.normal(size=(2, S, 128)).astype(np.float32)
    km, km2 = np.arange(Smax)[None].repeat(2, 0) < P, np.arange(Smax)[None].repeat(2, 0) < P + S
    jo = jllama.llama_forward(jp, lc, jnp.asarray(x), kv_cache=jllama.init_kv_cache(lc, 2, Smax),
                              key_mask=jnp.asarray(km), compute_logits=False, use_flash=False)
    cache = tllama.init_kv_cache(tc, 2, Smax)
    to = tllama.llama_forward(tp, tc, torch.from_numpy(x), kv_cache=cache, key_mask=torch.from_numpy(km),
                              compute_logits=False)
    js = jllama.llama_forward(jp, lc, jnp.asarray(suf), kv_cache=jo["kv_cache"], cache_len=P,
                              key_mask=jnp.asarray(km2), compute_logits=False, cache_read_only=True)
    before = {k: v.clone() for k, v in cache.items()}
    ts = tllama.llama_forward(tp, tc, torch.from_numpy(suf), kv_cache=cache, cache_len=P,
                              key_mask=torch.from_numpy(km2), compute_logits=False, cache_read_only=True)
    for k in ("k", "v"):
        assert cache[k].shape == (4, 2, 1, Smax, 32) and torch.equal(cache[k], before[k])
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jo["kv_cache"][k]), rtol=1e-5, atol=1e-6)
    err = max(float(np.abs(to["last_hidden"].numpy() - np.asarray(jo["last_hidden"])).max()),
              float(np.abs(ts["last_hidden"].numpy() - np.asarray(js["last_hidden"])).max()))
    record_property("max_abs_err", err)
    # fp32 summation order only: no activation crosses an int8 rounding step
    for got, want in ((to, jo), (ts, js)):
        np.testing.assert_allclose(got["last_hidden"].numpy(), np.asarray(want["last_hidden"]), rtol=1e-5, atol=1e-5)


def test_gqa_policy_ar_ids_match_jax(monkeypatch, gqa_model, record_property):
    jpol, tpol = _policies(monkeypatch, gqa_model, "weight_only")
    img, pc, ids, *_ = tpp.request()
    with jax.disable_jit():
        jprefix = jmla.build_prefix_embeds(jpol.params, jpol.state, jpol.cfg, jnp.asarray(ids),
                                           {"front_image": jnp.asarray(img)[None]}, jnp.asarray(pc)[None])
        jkv, jlast = jmla.prefill(jpol.params, jpol.cfg, jprefix, jprefix.shape[1] + 7 + 32)
        jtoks, jprobs = jmla.greedy_decode_actions(jpol.params, jpol.cfg, jkv, jprefix.shape[1], jlast, 7)
    ta, tprobs = tpol.predict_action_ar(img, pc, "", input_ids=ids, return_probs=True)
    want = jmla.unnormalize_actions(jpol.action_tokenizer.decode_token_ids_to_actions(np.asarray(jtoks)[0]),
                                    jpol.get_action_stats())
    np.testing.assert_array_equal(ta, want)
    record_property("max_rel_err_probs", float(np.max(np.abs(np.array(tprobs) - np.asarray(jprobs)[0])
                                                      / np.asarray(jprobs)[0])))
    np.testing.assert_allclose(tprobs, np.asarray(jprobs)[0], rtol=1e-5)


@pytest.fixture(scope="module")
def jax_train_run():
    jcfg, _ = configs(num_kv_heads=1)
    params, state = jprismatic.mla_model_init(jax.random.PRNGKey(6), jcfg)
    rng = np.random.default_rng(106)
    fc2 = params["final_layer"]["mlp"]["fc2"]
    fc2["w"] = jnp.asarray(rng.normal(size=fc2["w"].shape).astype(np.float32) * 0.05)
    b = batch(B)
    key = jax.random.PRNGKey(9)
    sched = jgd.create_schedule("", diffusion_steps=100)

    def loss(p, s, bb, r):
        return jmla.mla_train_loss(p, s, jcfg, sched, bb, r, repeated_diffusion_steps=REP, remat=True)

    (total, (ldict, new_state)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params, state, jax.tree_util.tree_map(jnp.asarray, b), key
    )
    return {"params": params, "state": state, "batch": b, "draws": jax_draws(key, jcfg, B * REP),
            "losses": {k: float(v) for k, v in ldict.items()}, "grads": from_jax(jax.device_get(grads)),
            "new_state": from_jax(jax.device_get(new_state))}


@pytest.mark.parametrize("remat", [False, True], ids=["remat-off", "remat-on"])
def test_gqa_train_loss_and_grads_match_jax(jax_train_run, remat, record_property):
    _, tcfg = configs(num_kv_heads=1)
    params = trainable(jax_train_run["params"])
    total, (ldict, new_state) = tmla.mla_train_loss(
        params, from_jax(jax_train_run["state"]), tcfg, tgd.create_schedule("", diffusion_steps=100),
        as_tensors(jax_train_run["batch"], "cpu"), repeated_diffusion_steps=REP, remat=remat,
        **jax_train_run["draws"],
    )
    total.backward()
    for k in ("total_loss", "diff_loss", "img_pc_contrastive_loss"):
        assert jax_train_run["losses"][k] > 0, k
        record_property(f"rel_err_{k}", abs(float(ldict[k].detach()) / jax_train_run["losses"][k] - 1))
        np.testing.assert_allclose(float(ldict[k].detach()), jax_train_run["losses"][k], rtol=1e-5, err_msg=k)
    want = dict(tree_items(jax_train_run["grads"]))
    assert sorted(p for p, _ in tree_items(params)) == sorted(want)
    worst = 0.0
    for path, leaf in tree_items(params):
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        err, scale = float((g - want[path]).abs().max()), float(want[path].abs().max())
        worst = max(worst, err / (1e-6 + 1e-4 * scale))
        assert err <= 1e-6 + 1e-4 * scale, (path, err, scale)
    # one KV head of 16: the k and v gradients are [L, 64, 16], each the sum
    # of the four query heads' dK / dV, and live
    for name in ("k", "v"):
        g = params["llm_backbone"]["layers"]["attn"][name]["w"].grad
        assert g.shape == (4, 64, 16) and float(g.abs().max()) > 0
    record_property("max_grad_err_share_of_tolerance", worst)
    got_state, want_state = dict(tree_items(new_state)), dict(tree_items(jax_train_run["new_state"]))
    for path, leaf in want_state.items():
        np.testing.assert_allclose(got_state[path].numpy(), leaf.numpy(), rtol=1e-5, atol=1e-6, err_msg=path)
