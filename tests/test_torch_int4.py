"""The int4 weight path of the port against the JAX package on the CPU: the
packed bytes and group scales, the unpack, int4_linear's integer partial
sums and output, stacked leaves, the fused serving concat, the int4
lm_head, the refusal of a phi tree, and an int4 mla-tiny policy (JAX runs
its int8-arithmetic unpack off the TPU, `native=False`)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_policy_parity as tpp
from mla_tpu import nn as jnn
from mla_tpu.conf.models import get_model_config as jconfig
from mla_tpu.models import llama as jllama
from mla_tpu.models import mla as jmla
from mla_tpu.models import phi as jphi
from mla_tpu.ops import quantization as jq
from mla_tpu_torch import nn as tnn
from mla_tpu_torch.conf.models import get_model_config as tconfig
from mla_tpu_torch.models import llama as tllama
from mla_tpu_torch.models import mla as tmla
from mla_tpu_torch.ops import quantization as tq
from mla_tpu_torch.params import from_jax

GROUP = 32  # mla-tiny's hidden is 64: two groups on its K = 64 linears


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("shape,group", [((256, 96), 32), ((256, 96), 128), ((256, 96), 0), ((3, 128, 64), 32)])
def test_quantize_weight_int4_bytes_equal_jax(shape, group):
    w = _rand(shape, 0, 0.05)
    j = jq.quantize_weight_int4(jnp.asarray(w), group)
    t = tq.quantize_weight_int4(torch.from_numpy(w), group)
    assert t["w_q4"].dtype == torch.int8 and t["w_scale4"].dtype == torch.float32
    np.testing.assert_array_equal(t["w_q4"].numpy(), np.asarray(j["w_q4"]))
    np.testing.assert_array_equal(t["w_scale4"].numpy(), np.asarray(j["w_scale4"]))
    np.testing.assert_array_equal(tq.unpack_int4(t["w_q4"]).numpy(), np.asarray(jq.unpack_int4_reference(j["w_q4"])))
    np.testing.assert_array_equal(_np(tq.dequantize_weight_int4(t, torch.float32)),
                                  np.asarray(jq.dequantize_weight_int4(j, jnp.float32)))


def test_pack_int4_every_nibble_pair():
    """All 256 (even, odd) pairs of [-8, 7] pack to JAX's byte and back."""
    a, b = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8), indexing="ij")
    q = np.stack([a.ravel(), b.ravel()], -1).astype(np.int8)[None]  # [1, 256, 2]
    jp = np.asarray(jq.pack_int4(jnp.asarray(q)))
    tp = tq.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(tp.numpy(), jp)
    assert len(np.unique(jp)) == 256
    np.testing.assert_array_equal(tq.unpack_int4(tp).numpy(), q)


def _jax_partials(xq, w4, groups):
    """JAX's int32 partial sums, as its int4_linear forms them."""
    w = jq.unpack_int4_reference(jnp.asarray(w4))
    xq = jnp.asarray(xq)
    if groups == 1:
        return np.asarray(jax.lax.dot_general(xq, w, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32))[None]
    K, N = w.shape
    xg, wg = xq.reshape(-1, groups, K // groups), w.reshape(groups, K // groups, N)
    return np.asarray(jax.lax.dot_general(xg, wg, (((2,), (1,)), ((1,), (0,))), preferred_element_type=jnp.int32))


@pytest.mark.parametrize("group", [32, 0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_linear_partials_exact_and_output(group, dtype, record_property):
    K, N = 256, 96
    p = {"w": _rand((K, N), 1, 0.05), "b": _rand((N,), 2, 0.1)}
    jp = {**jq.quantize_weight_int4(jnp.asarray(p["w"]), group), "b": jnp.asarray(p["b"])}
    tp = from_jax(jp)
    x = _rand((2, 5, K), 3)
    xj, xt = jnp.asarray(x).astype(getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    # the integer partials: int8 rows (both packages' quantizers) x nibbles
    xq, _ = tq.quantize_rows(xt.reshape(-1, K))
    groups = tp["w_scale4"].shape[0]
    got = tq.int4_partials(xq, tq.unpack_int4(tp["w_q4"]), groups)
    want = _jax_partials(xq.numpy(), np.asarray(jp["w_q4"]), groups)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want.astype(np.int64))
    y_t, y_j = tq.int4_linear(tp, xt), jq.int4_linear(jp, xj, native=False)
    assert y_t.dtype == xt.dtype
    err = float(np.max(np.abs(_np(y_t) - np.asarray(y_j, np.float32)) / (np.abs(np.asarray(y_j, np.float32)) + 1e-3)))
    record_property("max_rel_err", err)
    # fp32: the group sum's order; bf16: one rounding of the output apart
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=8e-3, atol=1e-2)
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j, np.float32), **tol)
    # nn.linear takes the int4 branch whatever the int8 mode
    for mode in tnn.INT8_MODES:
        np.testing.assert_array_equal(_np(tnn.linear(tp, xt, int8_mode=mode)), _np(y_t))
    np.testing.assert_allclose(_np(tnn.linear(tp, xt)), np.asarray(jnn.linear(jp, xj), np.float32), **tol)


def _small_llama():
    import dataclasses

    jcfg = jllama.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=3, num_heads=4,
                              num_kv_heads=2, max_position_embeddings=64, contrastive_layer=1,
                              compute_dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
                                 if f.name not in ("param_dtype", "compute_dtype")}, compute_dtype=torch.float32)
    return jcfg, tcfg, jllama.llama_init(jax.random.PRNGKey(0), jcfg)


def test_quantize_llama_int4_stacked_and_fused_match_jax():
    jcfg, tcfg, jp = _small_llama()
    qj = jq.quantize_llama_int4(jp, GROUP)
    qt = tq.quantize_llama_int4(from_jax(jp), GROUP)
    # the bridge carries an int4 tree leaf for leaf: w_q4 int8, w_scale4 fp32
    bridged = from_jax(qj)
    for group in ("attn", "mlp"):
        for k, leaf in qt["layers"][group].items():
            assert leaf["w_q4"].shape[0] == 3 and leaf["w_q4"].dtype == torch.int8
            for key in ("w_q4", "w_scale4"):
                np.testing.assert_array_equal(leaf[key].numpy(), np.asarray(qj["layers"][group][k][key]))
                assert bridged["layers"][group][k][key].dtype == leaf[key].dtype
    np.testing.assert_array_equal(qt["embed"]["table_q"].numpy(), np.asarray(qj["embed"]["table_q"]))
    np.testing.assert_array_equal(qt["lm_head"]["w_q4"].numpy(), np.asarray(qj["lm_head"]["w_q4"]))
    # the fused serving tree: packed bytes and scales concatenated on the out dim
    fj, ft = jllama.fuse_for_serving(qj), tllama.fuse_for_serving(qt, k_major=True)
    for group, name, width in (("attn", "qkv_fused", 64 + 2 * 32), ("mlp", "gateup_fused", 2 * 128)):
        leaf = ft["layers"][group][name]
        assert set(leaf) == {"w_q4", "w_scale4"}
        assert leaf["w_q4"].shape[-1] == width // 2 and leaf["w_scale4"].shape[-1] == width
        for key in ("w_q4", "w_scale4"):
            np.testing.assert_array_equal(leaf[key].numpy(), np.asarray(fj["layers"][group][name][key]))
    assert "w_qt" not in ft["layers"]["attn"]["o"] and "w_qt" not in ft["layers"]["mlp"]["down"]
    # the int4 decoder forward and its fp32 logits (the head dequantized)
    x = _rand((2, 7, 64), 4)
    jout = jllama.llama_forward(fj, jcfg, jnp.asarray(x), compute_logits=True, use_flash=False)
    tout = tllama.llama_forward(ft, tcfg, torch.from_numpy(x), compute_logits=True)
    for key in ("last_hidden", "logits"):
        np.testing.assert_allclose(_np(tout[key]), np.asarray(jout[key]), rtol=1e-4, atol=1e-4, err_msg=key)


def test_int4_lm_head_logits_match_jax(record_property):
    _, _, jp = _small_llama()
    qj = jq.quantize_llama_int4(jp, GROUP)
    qt = from_jax(qj)
    h = _rand((3, 5, 64), 5)
    for dtype in (jnp.float32, jnp.bfloat16):
        want = np.asarray(jllama.lm_head_logits(qj, jnp.asarray(h).astype(dtype)))
        got = tllama.lm_head_logits(qt, torch.from_numpy(np.array(jnp.asarray(h).astype(dtype), np.float32)))
        assert got.dtype == torch.float32
        record_property(f"max_abs_err_{jnp.dtype(dtype).name}", float(np.abs(_np(got) - want).max()))
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def test_quantize_int4_refuses_a_phi_tree():
    cfg = jphi.PHI_TEST
    params = from_jax(jphi.phi_init(jax.random.PRNGKey(0), cfg))
    with pytest.raises(ValueError, match="phi"):
        tq.quantize_llama_int4(params)
    with pytest.raises(ValueError, match="phi"):
        tq.quantize_model_int4({"llm_backbone": params})


# --------------------------------------------------------------------------- #
# The int4 mla-tiny policy
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def int4_policies():
    params, state = tpp.model(seed=5)
    tp, ts = from_jax(params), from_jax(state)
    jpol = jmla.MLAPolicy(jq.quantize_model_int4(params, GROUP), state, jconfig("mla-tiny"), norm_stats=tpp.STATS)
    tpol = tmla.MLAPolicy(tq.quantize_model_int4(tp, GROUP), ts, tconfig("mla-tiny"), norm_stats=tpp.STATS,
                          device="cpu")
    return jpol, tpol


@pytest.mark.parametrize("sampler", ["ddim", "dpm"])
def test_int4_policy_chunk_matches_jax(monkeypatch, int4_policies, sampler, record_property):
    jpol, tpol = int4_policies
    calls = []
    real = tq.int4_linear
    monkeypatch.setattr(tq, "int4_linear", lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tnn, "int4_linear", tq.int4_linear)
    for name in ("w8a8_matmul", "int8_matmul"):
        monkeypatch.setattr(tq, name, lambda *a, **k: pytest.fail(f"{name} reached by an int4 tree"))
    # op by op, so that JAX rounds the int8 embedding rows to bf16 as written
    with jax.disable_jit():
        j, t = tpp.both(jpol, tpol, sampler=sampler, return_normalized=True)
    evals = 8 if sampler == "ddim" else 4
    assert len(calls) == 4 * 4 * (1 + evals)  # 4 fused linears x 4 layers x (prefill + evaluations)
    assert t.shape == (16, 7) and np.isfinite(t).all()
    record_property("max_abs_err", float(np.abs(t - j).max()))
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


def test_int4_policy_ar_ids_match_jax(int4_policies, record_property):
    jpol, tpol = int4_policies
    img, pc, ids, *_ = tpp.request()
    with jax.disable_jit():
        ja = np.asarray(jpol.predict_action_ar(img, pc, "", input_ids=ids))
        jprefix = jmla.build_prefix_embeds(jpol.params, jpol.state, jpol.cfg, jnp.asarray(ids),
                                           {"front_image": jnp.asarray(img)[None]}, jnp.asarray(pc)[None])
        jkv, jlast = jmla.prefill(jpol.params, jpol.cfg, jprefix, jprefix.shape[1] + 7 + 32)
        jtoks, jprobs = jmla.greedy_decode_actions(jpol.params, jpol.cfg, jkv, jprefix.shape[1], jlast, 7)
    ta, tprobs = tpol.predict_action_ar(img, pc, "", input_ids=ids, return_probs=True)
    np.testing.assert_array_equal(ta, ja)
    tprefix = tmla.build_prefix_embeds(tpol.params, tpol.state, tpol.cfg, torch.from_numpy(ids).long(),
                                       {"front_image": torch.from_numpy(img)[None]}, torch.from_numpy(pc)[None])
    tkv, tlast = tmla.prefill(tpol.params, tpol.cfg, tprefix, tprefix.shape[1] + 7 + 32)
    ttoks, _ = tmla.greedy_decode_actions(tpol.params, tpol.cfg, tkv, tprefix.shape[1], tlast, 7)
    np.testing.assert_array_equal(ttoks[0].numpy(), np.asarray(jtoks)[0])
    record_property("max_rel_err_probs", float(np.max(np.abs(np.array(tprobs) - np.asarray(jprobs)[0])
                                                      / np.asarray(jprobs)[0])))
    np.testing.assert_allclose(tprobs, np.asarray(jprobs)[0], rtol=1e-4)
