"""The port's layer library, quantizers, RoPE, decoder, configs and parameter
bridge against the JAX package on the CPU (same inputs from numpy seeds,
same weights through params.from_jax)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu import nn as jnn
from mla_tpu.conf.models import MODEL_REGISTRY as JREG
from mla_tpu.models import llama as jllama
from mla_tpu.models import prismatic as jprismatic
from mla_tpu.ops import quantization as jq
from mla_tpu.ops import rope as jrope
from mla_tpu_torch import nn as tnn
from mla_tpu_torch import params as tparams
from mla_tpu_torch.conf.models import MODEL_REGISTRY as TREG
from mla_tpu_torch.models import llama as tllama
from mla_tpu_torch.ops import quantization as tq
from mla_tpu_torch.ops import rope as trope


def _t(a):
    return tparams.from_jax(a)


def _np(t):
    return t.detach().float().numpy()


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


# --------------------------------------------------------------------------- #
# nn
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nn_ops_match_jax(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    # fp32: summation order only; bf16: one rounding of the output
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    x = _rand((3, 5, 32), 0)
    xj, xt = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    lin = {"w": _rand((32, 48), 1, 0.1), "b": _rand((48,), 2)}
    ln = {"scale": _rand((32,), 3), "bias": _rand((32,), 4)}
    pairs = [
        (jnn.linear(jax.tree_util.tree_map(jnp.asarray, lin), xj), tnn.linear(_t(lin), xt)),
        (jnn.layer_norm(jax.tree_util.tree_map(jnp.asarray, ln), xj), tnn.layer_norm(_t(ln), xt)),
        (jnn.rms_norm({"scale": jnp.asarray(ln["scale"])}, xj, 1e-5), tnn.rms_norm({"scale": _t(ln["scale"])}, xt, 1e-5)),
        (jnn.gelu_exact(xj), tnn.gelu_exact(xt)),
        (jnn.gelu_tanh(xj), tnn.gelu_tanh(xt)),
        (jnn.silu(xj), tnn.silu(xt)),
    ]
    mg = jnn.mlp_gelu_init(jax.random.PRNGKey(0), 32, 16, depth=3)
    pairs.append((jnn.mlp_gelu(mg, xj), tnn.mlp_gelu(_t(mg), xt)))
    bn_p = {"scale": _rand((32,), 5), "bias": _rand((32,), 6)}
    bn_s = {"mean": _rand((32,), 7), "var": np.abs(_rand((32,), 8)) + 0.5}
    jbn, _ = jnn.batch_norm(jax.tree_util.tree_map(jnp.asarray, bn_p), jax.tree_util.tree_map(jnp.asarray, bn_s), xj, training=False)
    pairs.append((jbn, tnn.batch_norm(_t(bn_p), _t(bn_s), xt)[0]))
    for j, t in pairs:
        assert t.dtype == tdt
        np.testing.assert_allclose(_np(t), np.asarray(j, np.float32), **tol)
    table = _rand((50, 8), 9)
    ids = np.array([[3, 49, 0]])
    np.testing.assert_array_equal(_np(tnn.embedding({"table": _t(table)}, torch.from_numpy(ids))),
                                  np.asarray(jnn.embedding({"table": jnp.asarray(table)}, jnp.asarray(ids))))


def test_int8_linear_branches_match_jax(monkeypatch):
    w = _rand((64, 128), 10, 0.05)
    x = _rand((2, 7, 64), 11)
    pj = jq.quantize_weight(jnp.asarray(w))
    pt = tq.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(pt["w_q"].numpy(), np.asarray(pj["w_q"]))
    np.testing.assert_array_equal(pt["w_scale"].numpy(), np.asarray(pj["w_scale"]))
    monkeypatch.setenv("MLA_INT8_MODE", "w8a8")
    # same int32 product, ~1 ulp from the rescale order
    np.testing.assert_allclose(_np(tnn.linear(pt, torch.from_numpy(x))), np.asarray(jnn.linear(pj, jnp.asarray(x))),
                               rtol=3e-7, atol=1e-7)
    monkeypatch.setenv("MLA_INT8_MODE", "dequant")
    np.testing.assert_allclose(_np(tnn.linear(pt, torch.from_numpy(x), int8_mode="dequant")),
                               np.asarray(jnn.linear(pj, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_rope_matches_jax():
    cj, sj = jrope.rope_tables(64, 100)
    ct, st = trope.rope_tables(64, 100)
    np.testing.assert_array_equal(ct, cj)
    q, k = _rand((2, 3, 9, 64), 12), _rand((2, 3, 9, 64), 13)
    pos = np.arange(9) + 40
    jq_, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(cj), jnp.asarray(sj), jnp.asarray(pos))
    tq_, tk = trope.apply_rope(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(ct), torch.from_numpy(st),
                               torch.from_numpy(pos))
    np.testing.assert_allclose(_np(tq_), np.asarray(jq_), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tk), np.asarray(jk), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------- #
# Decoder
# --------------------------------------------------------------------------- #


def _small_llama(num_kv_heads=4):
    jcfg = jllama.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=3, num_heads=4,
        num_kv_heads=num_kv_heads, max_position_embeddings=64, contrastive_layer=1,
        compute_dtype=jnp.float32,
    )
    tcfg = tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
                                 if f.name not in ("param_dtype", "compute_dtype")},
                              compute_dtype=torch.float32)
    params = jllama.llama_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params


@pytest.mark.parametrize("quantized,num_kv_heads", [(False, 4), (False, 2), (True, 4)])
def test_llama_prefill_and_readonly_suffix_match_jax(monkeypatch, quantized, num_kv_heads, record_property):
    monkeypatch.setenv("MLA_INT8_MODE", "w8a8")
    jcfg, tcfg, jp = _small_llama(num_kv_heads)
    if quantized:
        jp = jq.quantize_llama(jp)
    jp = jllama.fuse_for_serving(jp)
    tp = _t(jp)
    P, S, Smax = 11, 6, 24
    prefix = _rand((2, P, 64), 14)
    suffix = _rand((2, S, 64), 15)
    km = np.arange(Smax)[None, :].repeat(2, 0) < P
    jout = jllama.llama_forward(jp, jcfg, jnp.asarray(prefix), kv_cache=jllama.init_kv_cache(jcfg, 2, Smax),
                                cache_len=0, key_mask=jnp.asarray(km), compute_logits=True, use_flash=False,
                                scan_unroll=jcfg.num_layers)
    tout = tllama.llama_forward(tp, tcfg, torch.from_numpy(prefix), kv_cache=tllama.init_kv_cache(tcfg, 2, Smax),
                                cache_len=0, key_mask=torch.from_numpy(km), compute_logits=True)
    # fp32: summation order (and for int8 the odd activation that rounds to
    # the next int8 step), through 3 layers
    tol = dict(rtol=1e-4, atol=1e-4) if not quantized else dict(rtol=2e-3, atol=2e-3)
    for key in ("last_hidden", "hidden_mid", "logits"):
        np.testing.assert_allclose(_np(tout[key]), np.asarray(jout[key]), **tol, err_msg=key)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tout["kv_cache"][key]), np.asarray(jout["kv_cache"][key]), **tol, err_msg=key)

    km2 = np.arange(Smax)[None, :].repeat(2, 0) < P + S
    js = jllama.llama_forward(jp, jcfg, jnp.asarray(suffix), kv_cache=jout["kv_cache"], cache_len=P,
                              key_mask=jnp.asarray(km2), compute_logits=False, cache_read_only=True)
    ts = tllama.llama_forward(tp, tcfg, torch.from_numpy(suffix), kv_cache=tout["kv_cache"], cache_len=P,
                              key_mask=torch.from_numpy(km2), compute_logits=False, cache_read_only=True)
    record_property("max_abs_err", max(float(np.abs(_np(tout["last_hidden"]) - np.asarray(jout["last_hidden"])).max()),
                                       float(np.abs(_np(ts["last_hidden"]) - np.asarray(js["last_hidden"])).max())))
    np.testing.assert_allclose(_np(ts["last_hidden"]), np.asarray(js["last_hidden"]), **tol)
    # read-only: the cache is untouched past the prefix
    assert float(ts["kv_cache"]["k"][:, :, :, P:].abs().max()) == 0.0


def test_llama_readonly_equals_full_forward():
    """The contract of test_llama.py: [prefix | suffix] through the cache
    (read-only suffix) equals one causal pass over the whole sequence."""
    _, tcfg, jp = _small_llama()
    tp = _t(jp)
    P, S = 9, 5
    seq = torch.from_numpy(_rand((1, P + S, 64), 16))
    full = tllama.llama_forward(tp, tcfg, seq, compute_logits=False)["last_hidden"]
    cache = tllama.init_kv_cache(tcfg, 1, 20)
    km = torch.arange(20)[None] < P
    tllama.llama_forward(tp, tcfg, seq[:, :P], kv_cache=cache, key_mask=km, compute_logits=False)
    km2 = torch.arange(20)[None] < P + S
    suf = tllama.llama_forward(tp, tcfg, seq[:, P:], kv_cache=cache, cache_len=P, key_mask=km2,
                               compute_logits=False, cache_read_only=True)["last_hidden"]
    np.testing.assert_allclose(_np(suf), _np(full[:, P:]), rtol=1e-5, atol=1e-5)


def test_embed_tokens_and_lm_head_int8_match_jax():
    jcfg, tcfg, jp = _small_llama()
    qj = jq.quantize_llama(jp)
    qt = tq.quantize_llama(_t(jp))
    for path in (("embed", "table_q"), ("embed", "table_scale"), ("lm_head", "w_q"), ("lm_head", "w_scale")):
        np.testing.assert_array_equal(qt[path[0]][path[1]].numpy(), np.asarray(qj[path[0]][path[1]]))
    for k in ("q", "k", "v", "o"):
        np.testing.assert_array_equal(qt["layers"]["attn"][k]["w_q"].numpy(), np.asarray(qj["layers"]["attn"][k]["w_q"]))
        np.testing.assert_array_equal(qt["layers"]["attn"][k]["w_scale"].numpy(), np.asarray(qj["layers"]["attn"][k]["w_scale"]))
    ids = np.array([[3, 17, 42, 9, 127]])
    je = jllama.embed_tokens(qj, jnp.asarray(ids))
    te = tllama.embed_tokens(qt, torch.from_numpy(ids))
    assert te.dtype == torch.bfloat16 and je.dtype == jnp.bfloat16  # bf16 rows, as in JAX
    np.testing.assert_array_equal(_np(te), np.asarray(je, np.float32))
    h = _rand((1, 5, 64), 17)
    np.testing.assert_allclose(_np(tllama.lm_head_logits(qt, torch.from_numpy(h))),
                               np.asarray(jllama.lm_head_logits(qj, jnp.asarray(h))), rtol=1e-5, atol=1e-5)
    host = tq.quantize_model_host({"llm_backbone": _t(jp)})["llm_backbone"]
    np.testing.assert_array_equal(host["layers"]["mlp"]["down"]["w_q"].numpy(), np.asarray(qj["layers"]["mlp"]["down"]["w_q"]))


# --------------------------------------------------------------------------- #
# Configs and parameter bridge
# --------------------------------------------------------------------------- #


def _torch_dtype_name(v):
    return str(v).replace("torch.", "") if isinstance(v, torch.dtype) else jnp.dtype(v).name


def _same_config(t, j, where):
    """Field for field, into nested configs (the gen config's heads);
    dtypes by name."""
    for f in dataclasses.fields(t):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(a):
            _same_config(a, b, where + (f.name,))
        elif f.name.endswith("dtype"):
            assert _torch_dtype_name(a) == _torch_dtype_name(b), where + (f.name,)
        else:
            assert a == b, where + (f.name,)


@pytest.mark.parametrize("name", sorted(TREG))
def test_presets_match_jax(name):
    """Every preset as it is and with the post-training flags (the gen
    config at the preset's width, mla-tiny's small one)."""
    post = dict(use_pointcloud=True, use_tactile=True, use_generation=True, use_roi=True, num_extra_views=1)
    for flags in ({}, post):
        jcfg, tcfg = JREG[name](**flags), TREG[name](**flags)
        _same_config(tcfg, jcfg, (name,))
        assert tcfg.fused_len == jcfg.fused_len and tcfg.action_horizon == jcfg.action_horizon


def test_from_jax_roundtrip_bitexact():
    tree = {"a": jnp.asarray(_rand((3, 4), 18)).astype(jnp.bfloat16), "b": [jnp.arange(5, dtype=jnp.int32)],
            "c": {"d": jnp.asarray(np.array([-127, 5], np.int8)), "e": jnp.asarray(_rand((2,), 19))}}
    t = tparams.from_jax(tree)
    assert t["a"].dtype == torch.bfloat16 and t["c"]["d"].dtype == torch.int8
    np.testing.assert_array_equal(t["a"].view(torch.int16).numpy(), np.asarray(tree["a"]).view(np.int16))
    np.testing.assert_array_equal(t["b"][0].numpy(), np.arange(5))
    np.testing.assert_array_equal(t["c"]["e"].numpy(), np.asarray(tree["c"]["e"]))


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}/{i}"))
        return out
    dt = str(tree.dtype).replace("torch.", "")
    return {prefix: (tuple(tree.shape), dt)}


def test_init_has_the_jax_layout():
    """params.init builds every module of the ported paths (serving, the
    diffusion training step and the post-training heads, contrastive heads
    included) with the JAX tree's keys, shapes and dtypes, for mla-tiny as
    it is and with the generation heads (ROI, tactile input and the tactile
    head) on; the same for the state (the point head's batch norm)."""
    for flags in ({}, dict(use_generation=True, use_roi=True, use_tactile=True)):
        jp, js = jprismatic.mla_model_init(jax.random.PRNGKey(0), JREG["mla-tiny"](**flags))
        tp, ts = tparams.init(TREG["mla-tiny"](**flags), seed=0, device="cpu")
        assert _shapes(tp) == _shapes(tparams.from_jax(jp)), flags
        assert _shapes(ts) == _shapes(tparams.from_jax(js)), flags
        assert float(tp["final_layer"]["mlp"]["fc2"]["w"].abs().max()) == 0.0
    assert {"generation_manager", "tactile_embedder"} <= set(tp) and "tactile" in tp["contrastive"]
    assert set(tp["generation_manager"]) == {"image_gen_module", "pointcloud_gen_module", "tactile_gen_module"}
    assert "pred_bn" in ts["generation_manager"]["pointcloud_gen_module"]
    assert torch.equal(tp["generation_manager"]["image_gen_module"]["mae_alpha_head"]["b"], torch.full((1,), -3.0))
