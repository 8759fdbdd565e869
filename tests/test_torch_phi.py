"""The port's Phi-2 decoder (mla_tpu_torch/models/phi.py) against the JAX
package's on the CPU: phi_forward on PHI_TEST in fp32 (logits,
hidden_mid, the prefill into a cache, a decode step, the read-only suffix
against JAX's write-then-attend), a bf16 case, partial RoPE, the sdpa
routing predicate, from_jax on a JAX phi tree, the seeded init, the MFU
parameter count and the refusal to quantize a phi tree. Weights come from
the JAX init through params.from_jax, inputs from numpy seeds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu.models import phi as jphi
from mla_tpu.ops import rope as jrope
from mla_tpu_torch import params as tparams
from mla_tpu_torch.models import phi as tphi
from mla_tpu_torch.ops import attention as tattn
from mla_tpu_torch.ops import quantization as tq
from mla_tpu_torch.ops import rope as trope
from mla_tpu_torch.training import metrics

# fp32 end to end: the two frameworks differ in the order of their sums only
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().float().numpy()


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _tcfg(jcfg, **kw):
    """The port's PhiConfig with the JAX config's fields (dtypes by name)."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if not f.name.endswith("dtype")}
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    fields.update(param_dtype=dt[jnp.dtype(jcfg.param_dtype).name], compute_dtype=dt[jnp.dtype(jcfg.compute_dtype).name])
    return tphi.PhiConfig(**{**fields, **kw})


@pytest.fixture(scope="module")
def small():
    """PHI_TEST with a live init: JAX zero-inits the biases and sets the
    LayerNorms to one and zero, which would leave those paths untested."""
    jcfg = jphi.PHI_TEST
    params = jphi.phi_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(lambda x: x + jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * 0.02),
                                    params)
    return jcfg, _tcfg(jcfg), params


def test_phi_config_matches_jax():
    for jc, tc in ((jphi.PHI_2, tphi.PHI_2), (jphi.PHI_TEST, tphi.PHI_TEST)):
        assert _tcfg(jc) == tc
        assert (tc.head_dim, tc.rotary_dim) == (jc.head_dim, jc.rotary_dim)
    assert (tphi.PHI_2.head_dim, tphi.PHI_2.rotary_dim) == (80, 32)
    assert tphi.init is tphi.phi_init and tphi.forward is tphi.phi_forward and tphi.Config is tphi.PhiConfig


@pytest.mark.parametrize("B,S", [(1, 7), (2, 12)])
def test_phi_forward_matches_jax(small, B, S, record_property):
    """The uncached forward: logits, last_hidden and hidden_mid (after
    contrastive_layer = 2 of 4 layers), with and without a key mask."""
    jcfg, tcfg, jp = small
    tp = tparams.from_jax(jp)
    x = _rand((B, S, jcfg.hidden_size), 10 + S)
    km = np.ones((B, S), bool)
    km[-1, -3:] = False
    for mask in (None, km):
        jout = jphi.phi_forward(jp, jcfg, jnp.asarray(x), key_mask=None if mask is None else jnp.asarray(mask))
        tout = tphi.phi_forward(tp, tcfg, torch.from_numpy(x), key_mask=None if mask is None else torch.from_numpy(mask))
        record_property("max_abs_err", float(np.abs(_np(tout["logits"]) - np.asarray(jout["logits"])).max()))
        for key in ("last_hidden", "hidden_mid", "logits"):
            assert tout[key].shape == jout[key].shape, key
            np.testing.assert_allclose(_np(tout[key]), np.asarray(jout[key]), **TOL, err_msg=key)
    assert tout["logits"].dtype == torch.float32


def test_phi_prefill_and_decode_match_jax(small, record_property):
    """The static prefill writes its k/v into the cache in place; then a
    3-token block written at cache_len and attended over the whole cache,
    causal from cache_len: logits and the cache against JAX's."""
    jcfg, tcfg, jp = small
    tp = tparams.from_jax(jp)
    P, S, Smax = 9, 3, 20
    prefix, block = _rand((2, P, 64), 20), _rand((2, S, 64), 21)
    km = np.arange(Smax)[None].repeat(2, 0) < P
    km2 = np.arange(Smax)[None].repeat(2, 0) < P + S
    jpre = jphi.phi_forward(jp, jcfg, jnp.asarray(prefix), kv_cache=jphi.init_kv_cache(jcfg, 2, Smax),
                            key_mask=jnp.asarray(km), use_flash=False)
    tcache = tphi.init_kv_cache(tcfg, 2, Smax)
    tpre = tphi.phi_forward(tp, tcfg, torch.from_numpy(prefix), kv_cache=tcache, key_mask=torch.from_numpy(km))
    assert tpre["kv_cache"] is tcache  # written in place
    for key in ("logits", "hidden_mid"):
        np.testing.assert_allclose(_np(tpre[key]), np.asarray(jpre[key]), **TOL, err_msg=key)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[key]), np.asarray(jpre["kv_cache"][key]), **TOL, err_msg=key)
    jstep = jphi.phi_forward(jp, jcfg, jnp.asarray(block), kv_cache=jpre["kv_cache"], cache_len=P,
                             key_mask=jnp.asarray(km2))
    tstep = tphi.phi_forward(tp, tcfg, torch.from_numpy(block), kv_cache=tcache, cache_len=P,
                             key_mask=torch.from_numpy(km2))
    record_property("max_abs_err", float(np.abs(_np(tstep["logits"]) - np.asarray(jstep["logits"])).max()))
    np.testing.assert_allclose(_np(tstep["logits"]), np.asarray(jstep["logits"]), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[key]), np.asarray(jstep["kv_cache"][key]), **TOL, err_msg=key)


def test_phi_readonly_suffix_matches_jax_write_then_attend(small, record_property):
    """JAX's phi_forward ignores cache_read_only: it writes the suffix into
    a functional copy of the cache and attends over it. The port's
    read-only branch gives the same values (rtol / atol 1e-5) and leaves
    the cache bitwise as it was."""
    jcfg, tcfg, jp = small
    tp = tparams.from_jax(jp)
    P, S, Smax = 11, 6, 24
    prefix, suffix = _rand((2, P, 64), 30), _rand((2, S, 64), 31)
    km = np.arange(Smax)[None].repeat(2, 0) < P
    km2 = np.arange(Smax)[None].repeat(2, 0) < P + S
    jpre = jphi.phi_forward(jp, jcfg, jnp.asarray(prefix), kv_cache=jphi.init_kv_cache(jcfg, 2, Smax),
                            key_mask=jnp.asarray(km), compute_logits=False)
    jsuf = jphi.phi_forward(jp, jcfg, jnp.asarray(suffix), kv_cache=jpre["kv_cache"], cache_len=P,
                            key_mask=jnp.asarray(km2), compute_logits=False, cache_read_only=True)
    tcache = tphi.init_kv_cache(tcfg, 2, Smax)
    tphi.phi_forward(tp, tcfg, torch.from_numpy(prefix), kv_cache=tcache, key_mask=torch.from_numpy(km),
                     compute_logits=False)
    before = {k: v.clone() for k, v in tcache.items()}
    tsuf = tphi.phi_forward(tp, tcfg, torch.from_numpy(suffix), kv_cache=tcache, cache_len=P,
                            key_mask=torch.from_numpy(km2), compute_logits=False, cache_read_only=True)
    record_property("max_abs_err", float(np.abs(_np(tsuf["last_hidden"]) - np.asarray(jsuf["last_hidden"])).max()))
    np.testing.assert_allclose(_np(tsuf["last_hidden"]), np.asarray(jsuf["last_hidden"]), **TOL)
    for k in ("k", "v"):
        assert torch.equal(tcache[k], before[k]), k
        # JAX's copy holds the suffix: the port wrote none of it
        assert float(np.abs(np.asarray(jsuf["kv_cache"][k])[:, :, :, P : P + S]).max()) > 0


def test_phi_readonly_equals_full_forward(small):
    """[prefix | suffix] through the cache (read-only suffix) equals one
    causal forward over the whole sequence."""
    _, tcfg, jp = small
    tp = tparams.from_jax(jp)
    P, S = 9, 5
    seq = torch.from_numpy(_rand((1, P + S, 64), 32))
    full = tphi.phi_forward(tp, tcfg, seq, compute_logits=False)["last_hidden"]
    cache = tphi.init_kv_cache(tcfg, 1, 20)
    tphi.phi_forward(tp, tcfg, seq[:, :P], kv_cache=cache, key_mask=torch.arange(20)[None] < P, compute_logits=False)
    suf = tphi.phi_forward(tp, tcfg, seq[:, P:], kv_cache=cache, cache_len=P, key_mask=torch.arange(20)[None] < P + S,
                           compute_logits=False, cache_read_only=True)["last_hidden"]
    np.testing.assert_allclose(_np(suf), _np(full[:, P:]), rtol=1e-5, atol=1e-5)


def test_phi_bf16_matches_jax(small, record_property):
    """bf16 parameters and compute in both packages: each product rounds to
    bf16 at other points of XLA's and PyTorch's kernels, so the fp32 logits
    agree to 2e-2 of their largest |value| (a few bf16 ulps through 4
    layers), not elementwise."""
    jcfg, _, jp = small
    jcfg = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    tcfg = _tcfg(jcfg)
    tp = tparams.from_jax(jp)
    x = _rand((2, 10, 64), 40)
    jl = np.asarray(jphi.phi_forward(jp, jcfg, jnp.asarray(x))["logits"])
    tout = tphi.phi_forward(tp, tcfg, torch.from_numpy(x))
    assert tout["last_hidden"].dtype == torch.bfloat16 and tout["logits"].dtype == torch.float32
    err, scale = float(np.abs(_np(tout["logits"]) - jl).max()), float(np.abs(jl).max())
    record_property("rel_err", err / scale)
    assert err <= 2e-2 * scale, (err, scale)


def test_partial_rope_matches_jax():
    """Phi-2's split: the first 32 of 80 dims rotated with rotate_half
    within them (tables of width 32), the other 48 passed through bitwise."""
    rd, hd = tphi.PHI_2.rotary_dim, tphi.PHI_2.head_dim
    cj, sj = jrope.rope_tables(rd, 64)
    ct, st = trope.rope_tables_on(rd, 64, 10000.0, "cpu")
    np.testing.assert_array_equal(ct.numpy(), cj)
    q, k = _rand((2, 3, 9, hd), 50), _rand((2, 3, 9, hd), 51)
    pos = np.arange(9) + 30
    jq_, jk = jphi._apply_partial_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(cj), jnp.asarray(sj),
                                       jnp.asarray(pos), rd)
    tq_, tk = tphi.apply_partial_rope(torch.from_numpy(q), torch.from_numpy(k), ct, st, torch.from_numpy(pos), rd)
    np.testing.assert_allclose(_np(tq_), np.asarray(jq_), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tk), np.asarray(jk), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_np(tq_)[..., rd:], q[..., rd:])
    assert not np.allclose(_np(tq_)[..., :rd], q[..., :rd])


@pytest.mark.parametrize("head_dim,kernel", [(32, False), (64, True), (80, False), (96, False), (128, True),
                                             (256, False)])
def test_sdpa_routing_predicate(monkeypatch, head_dim, kernel):
    """JAX's shape rule: head_dim 64 and 128 go to the flash kernel (at S =
    256), any other to the reference; a CPU tensor always takes the
    reference."""
    assert tattn.flash_fits(256, head_dim) is kernel
    monkeypatch.setattr(tattn, "flash_attention", lambda *a, **k: pytest.fail("the CPU took the flash kernel"))
    q = torch.from_numpy(_rand((1, 2, 5, head_dim), head_dim))
    np.testing.assert_array_equal(_np(tattn.sdpa(q, q, q)), _np(tattn.sdpa_reference(q, q, q)))


def test_from_jax_phi_tree():
    """A JAX phi tree (fp32 and bf16) carries across leaf for leaf, bitwise,
    with the layout of the port's own phi init."""
    jp = jphi.phi_init(jax.random.PRNGKey(3), jphi.PHI_TEST)
    ours = tphi.phi_init(tphi.PHI_TEST, seed=3, device="cpu")
    for tree in (jp, jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)):
        tp = tparams.from_jax(tree)
        want = dict(tparams.tree_items(tparams.from_jax(jax.device_get(tree))))
        items = tparams.tree_items(tp)
        assert sorted(p for p, _ in items) == sorted(p for p, _ in tparams.tree_items(ours))
        for path, leaf in items:
            src = np.asarray(jax.device_get(dict(_jax_items(tree))[path]))
            assert leaf.shape == src.shape and str(leaf.dtype).endswith(src.dtype.name), path
            assert torch.equal(leaf, want[path]), path
            if src.dtype.name == "bfloat16":
                np.testing.assert_array_equal(leaf.view(torch.int16).numpy(), src.view(np.int16))
            else:
                np.testing.assert_array_equal(leaf.numpy(), src)


def _jax_items(tree, prefix=""):
    if isinstance(tree, dict):
        return [i for k, v in tree.items() for i in _jax_items(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def test_phi_init_has_the_jax_layout_and_distributions():
    """The port's seeded phi tree: JAX phi_init's keys, shapes and dtypes;
    normal(0.02) weights, zero biases, LayerNorms of scale one and bias
    zero, a biased lm_head."""
    cfg = dataclasses.replace(tphi.PHI_TEST, hidden_size=128, num_heads=4, intermediate_size=256)
    jcfg = dataclasses.replace(jphi.PHI_TEST, hidden_size=128, num_heads=4, intermediate_size=256)
    tp = tphi.init(cfg, seed=0, device="cpu")
    jp = tparams.from_jax(jax.device_get(jphi.phi_init(jax.random.PRNGKey(0), jcfg)))
    shapes = {p: (tuple(l.shape), l.dtype) for p, l in tparams.tree_items(tp)}
    assert shapes == {p: (tuple(l.shape), l.dtype) for p, l in tparams.tree_items(jp)}
    for path, leaf in tparams.tree_items(tp):
        if path.endswith("/b") or path.endswith("ln/bias"):
            assert float(leaf.abs().max()) == 0.0, path
        elif path.endswith("ln/scale"):
            assert bool((leaf == 1).all()), path
        else:
            assert abs(float(leaf.std()) - 0.02) < 2e-3, path
    bf = tphi.init(dataclasses.replace(cfg, param_dtype=torch.bfloat16), seed=0, device="cpu")
    assert all(l.dtype == torch.bfloat16 for l in tparams.tree_leaves(bf))


def test_phi2_decoder_flops_count():
    """MFU's N for Phi-2 (training/metrics.py, embedding and lm_head left
    out in diffusion mode): 78.67 M a layer, 2.517 B for 32 layers with the
    final LayerNorm; counted on one full-width layer."""
    one = tphi.init(dataclasses.replace(tphi.PHI_2, num_layers=1, vocab_size=8, param_dtype=torch.bfloat16),
                    device="cpu")
    D, I = 2560, 10240
    per_layer = 4 * D * D + 2 * D * I + 4 * D + I + D + 2 * D
    assert per_layer == 78_671_360
    assert metrics.decoder_flops_per_token(one, use_diff=True) == 6.0 * (per_layer + 2 * D)
    assert 32 * per_layer + 2 * D == 2_517_488_640


def test_quantizing_a_phi_tree_names_the_family(small):
    """The JAX package quantizes llama trees only; the port refuses a phi
    tree with a ValueError that names the family, on the card's path and
    the host's."""
    _, _, jp = small
    tp = tparams.from_jax(jp)
    with pytest.raises(ValueError, match="phi tree"):
        tq.quantize_model({"llm_backbone": tp})
    with pytest.raises(ValueError, match="phi tree"):
        tq.quantize_model_host({"llm_backbone": tp})
    with pytest.raises(ValueError, match="phi tree"):
        tq.quantize_llama(tp)


def test_phi_matches_hf():
    """The port's phi_forward against transformers' PhiForCausalLM on the
    same weights (converted by the port's own convert_hf_phi), as
    tests/test_phi.py holds the JAX decoder."""
    hf = pytest.importorskip("transformers")
    cfg = tphi.PHI_TEST
    config = hf.PhiConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        max_position_embeddings=cfg.max_position_embeddings, partial_rotary_factor=cfg.partial_rotary_factor,
        layer_norm_eps=cfg.ln_eps, tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    model = hf.PhiForCausalLM(config).eval()
    tp = tphi.convert_hf_phi({k: v.detach() for k, v in model.state_dict().items()}, cfg.num_layers)
    ids = torch.tensor([[3, 17, 42, 9, 88, 200]])
    with torch.no_grad():
        want = model(ids).logits
    got = tphi.phi_forward(tp, cfg, tphi.embed_tokens(tp, ids))["logits"]
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_phi_remat_keeps_values_and_gradients(small):
    """remat checkpoints each layer; the loss and every gradient are those
    of the plain forward."""
    _, tcfg, jp = small
    x = torch.from_numpy(_rand((2, 8, 64), 60))
    grads = []
    for remat in (False, True):
        tp = tparams.from_jax(jp)
        for leaf in tparams.tree_leaves(tp):
            leaf.requires_grad_(True)
        loss = tphi.phi_forward(tp, tcfg, x, remat=remat)["logits"].square().mean()
        loss.backward()
        # the embedding table is not on this path (the input is embeddings)
        grads.append((float(loss.detach()), {p: l.grad.clone() for p, l in tparams.tree_items(tp) if p != "embed/table"}))
    assert grads[0][0] == grads[1][0]
    for path, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][path]), path
