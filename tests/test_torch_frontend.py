"""The port's front-end (vision and point tokenizers, embedders, fused
tokens, prefix embeds) and diffusion samplers against the JAX package on the
CPU, from the same JAX-initialized weights and numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu.conf.models import get_model_config as jconfig
from mla_tpu.diffusion import dpm_solver as jdpm
from mla_tpu.diffusion import gaussian as jgd
from mla_tpu.models import embedders as jemb
from mla_tpu.models import mla as jmla
from mla_tpu.models import point_tokenizer as jpt
from mla_tpu.models import prismatic as jprismatic
from mla_tpu.models import vision_tokenizer as jvt
from mla_tpu_torch.conf.models import get_model_config as tconfig
from mla_tpu_torch.diffusion import dpm_solver as tdpm
from mla_tpu_torch.diffusion import gaussian as tgd
from mla_tpu_torch.models import embedders as temb
from mla_tpu_torch.models import mla as tmla
from mla_tpu_torch.models import point_tokenizer as tpt
from mla_tpu_torch.models import prismatic as tprismatic
from mla_tpu_torch.models import vision_tokenizer as tvt
from mla_tpu_torch.params import from_jax


def _np(t):
    return t.detach().float().numpy()


def _tcfg(jc):
    return tvt.VisionTokenizerConfig(**{k: getattr(jc, k) for k in ("image_size", "patch_stride", "conv_stride", "hidden_dim", "num_heads")})


@pytest.mark.parametrize("full,dtype", [(False, "float32"), (False, "bfloat16"), (True, "float32")])
def test_vision_tokenizer_matches_jax(full, dtype, record_property):
    jc = jvt.VisionTokenizerConfig() if full else jvt.VisionTokenizerConfig(image_size=168, hidden_dim=32, num_heads=4)
    params = jvt.vision_tokenizer_init(jax.random.PRNGKey(0), jc)
    px = np.random.default_rng(1).normal(size=(1, 4, jc.image_size, jc.image_size)).astype(np.float32)
    jx = jnp.asarray(px).astype(getattr(jnp, dtype))
    want = np.asarray(jvt.vision_tokenizer(params, jx, jc), np.float32)
    got = tvt.vision_tokenizer(from_jax(params), torch.from_numpy(px).to(getattr(torch, dtype)), _tcfg(jc))
    assert got.shape == want.shape
    # fp32: summation order over K = 588 and C; bf16: a few output roundings
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else dict(rtol=5e-2, atol=5e-2)
    record_property("max_abs_err", float(np.abs(_np(got) - want).max()))
    np.testing.assert_allclose(_np(got), want, **tol)


@pytest.mark.parametrize("full", [False, True])
def test_point_tokenizer_matches_jax(full, record_property):
    jc = jpt.PointTokenizerConfig() if full else jpt.PointTokenizerConfig(
        input_points=64, embed_dim=12, k_neighbors=8, lga_blocks=(2, 1), dim_expansion=(2, 2), out_dim=24)
    tc = tpt.PointTokenizerConfig(**{k: getattr(jc, k) for k in (
        "input_points", "num_stages", "embed_dim", "k_neighbors", "alpha", "beta", "lga_blocks", "dim_expansion", "out_dim")})
    params, state = jpt.point_tokenizer_init(jax.random.PRNGKey(2), jc)
    # non-trivial running stats, so eval-mode batch norm is exercised
    state = jax.tree_util.tree_map(lambda a: a + 0.1 * jnp.abs(jax.random.normal(jax.random.PRNGKey(3), a.shape)), state)
    pc = np.random.default_rng(4).uniform([-0.3, -0.45, 0.75], [0.7, 0.45, 1.6], size=(2, jc.input_points, 3)).astype(np.float32)
    jtok, jcen, _ = jpt.point_tokenizer(params, state, jnp.asarray(pc), jc, training=False)
    ttok, tcen, _ = tpt.point_tokenizer(from_jax(params), from_jax(state), torch.from_numpy(pc), tc)
    # FPS indices are identical, so the centers are exact; the kNN order may
    # differ but the max-pool over neighbours is order-invariant
    np.testing.assert_array_equal(_np(tcen), np.asarray(jcen))
    record_property("max_abs_err", float(np.abs(_np(ttok) - np.asarray(jtok)).max()))
    np.testing.assert_allclose(_np(ttok), np.asarray(jtok), rtol=1e-4, atol=1e-4)


def test_embedders_match_jax():
    D = 32
    k = jax.random.split(jax.random.PRNGKey(5), 4)
    tp, ap = jemb.timestep_embedder_init(k[0], D), jemb.action_embedder_init(k[1], 7, D)
    fp, mp = jemb.final_layer_init(k[2], D, 7), jemb.mlp_projector_init(k[3], 24, D)
    fp["mlp"]["fc2"]["w"] = jax.random.normal(k[3], fp["mlp"]["fc2"]["w"].shape) * 0.02
    t = np.array([0, 17, 99])
    x7, xD, x24 = (np.random.default_rng(i).normal(size=(3, 5, n)).astype(np.float32) for i, n in ((6, 7), (7, D), (8, 24)))
    pairs = [
        (jemb.timestep_embedder(tp, jnp.asarray(t)), temb.timestep_embedder(from_jax(tp), torch.from_numpy(t))),
        (jemb.action_embedder(ap, jnp.asarray(x7)), temb.action_embedder(from_jax(ap), torch.from_numpy(x7))),
        (jemb.final_layer(fp, jnp.asarray(xD)), temb.final_layer(from_jax(fp), torch.from_numpy(xD))),
        (jemb.mlp_projector(mp, jnp.asarray(x24)), temb.mlp_projector(from_jax(mp), torch.from_numpy(x24))),
    ]
    for j, tt in pairs:
        np.testing.assert_allclose(_np(tt), np.asarray(j), rtol=1e-5, atol=1e-5)
    zp = {"uncondition": np.random.default_rng(9).normal(size=(1, D)).astype(np.float32)}
    drop = np.array([1, 0, 1])
    np.testing.assert_array_equal(
        _np(temb.label_embedder(from_jax(zp), torch.from_numpy(xD), force_drop_ids=torch.from_numpy(drop))),
        np.asarray(jemb.label_embedder(jax.tree_util.tree_map(jnp.asarray, zp), jnp.asarray(xD), force_drop_ids=jnp.asarray(drop))))


@pytest.fixture(scope="module")
def tiny():
    jc, tc = jconfig("mla-tiny"), tconfig("mla-tiny")
    params, state = jprismatic.mla_model_init(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(10)
    params["z_embedder"]["uncondition"] = jnp.asarray(rng.normal(size=(1, jc.token_size)).astype(np.float32))
    img = rng.integers(0, 256, size=(2, 3, 168, 168), dtype=np.uint8)
    pc = rng.uniform(-0.3, 0.7, size=(2, 64, 3)).astype(np.float32)
    ids = np.array([[1, 500, 600, 700], [1, 9, 99, 999]], np.int32)
    return jc, tc, params, state, img, pc, ids


def test_fused_tokens_and_prefix_match_jax(tiny):
    jc, tc, params, state, img, pc, ids = tiny
    tp, ts = from_jax(params), from_jax(state)
    clip = jmla._device_clip_preprocess(jnp.asarray(img))
    np.testing.assert_allclose(_np(tmla._device_clip_preprocess(torch.from_numpy(img))), np.asarray(clip), rtol=1e-6, atol=1e-6)
    jf = jprismatic.get_fused_tokens(params, state, jc, {"front_image": clip}, jnp.asarray(pc), None, None)
    tf = tprismatic.get_fused_tokens(tp, ts, tc, {"front_image": torch.from_numpy(np.array(clip))}, torch.from_numpy(pc))
    assert tf["fused"].shape == (2, tc.fused_len, tc.token_size)
    np.testing.assert_allclose(_np(tf["fused"]), np.asarray(jf["fused"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(_np(tf["centers"]), np.asarray(jf["centers"]))
    for uncond in (False, True):
        jp = jmla.build_prefix_embeds(params, state, jc, jnp.asarray(ids), {"front_image": jnp.asarray(img)},
                                      jnp.asarray(pc), with_uncond=uncond)
        tpre = tmla.build_prefix_embeds(tp, ts, tc, torch.from_numpy(ids).long(), {"front_image": torch.from_numpy(img)},
                                        torch.from_numpy(pc), with_uncond=uncond)
        assert tpre.shape == jp.shape and tpre.dtype == torch.float32
        np.testing.assert_allclose(_np(tpre), np.asarray(jp), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# Diffusion
# --------------------------------------------------------------------------- #


def _eps_pair(seed):
    """The same smooth eps model in both frameworks."""
    W = np.random.default_rng(seed).normal(size=(7, 7)).astype(np.float32) * 0.1

    def jfn(x, t):
        return jnp.tanh(x @ jnp.asarray(W)) + 0.01 * t.astype(jnp.float32)[:, None, None]

    def tfn(x, t):
        return torch.tanh(x @ torch.from_numpy(W)) + 0.01 * t.float()[:, None, None]

    return jfn, tfn


def test_clip_scaling_matches_both_jax_graphs():
    """The frame's uint8 -> [0, 1] scaling. XLA compiles x / 255.0 into x *
    fl(1/255), so JAX's jitted serving graph multiplies by the reciprocal
    (as PyTorch's CUDA kernel does for a Python-scalar divisor), while JAX
    run op by op divides exactly (as the port does on the CPU, which
    test_fused_tokens_and_prefix_match_jax holds at 1e-6): the two differ by
    one ulp in 126 of the 256 byte values."""
    a = np.arange(256, dtype=np.uint8)
    jitted = np.asarray(jax.jit(lambda v: v.astype(jnp.float32) / 255.0)(jnp.asarray(a)))
    exact = (a.astype(np.float64) / 255.0).astype(np.float32)
    np.testing.assert_array_equal(jitted, a.astype(np.float32) * np.float32(1.0 / 255.0))
    assert int((jitted != exact).sum()) == 126
    with jax.disable_jit():
        eager = np.asarray(jnp.asarray(a).astype(jnp.float32) / 255.0)
    np.testing.assert_array_equal(eager, exact)
    np.testing.assert_array_equal((torch.from_numpy(a).float() / 255.0).numpy(), exact)


@pytest.mark.parametrize("respacing", ["", "ddim8", "ddim4", "ddim1"])
def test_schedules_match_jax(respacing):
    js, ts = jgd.create_schedule(respacing), tgd.create_schedule(respacing)
    for name in ("betas", "timestep_map", "alphas_cumprod", "posterior_log_variance_clipped", "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))


def test_samplers_match_jax():
    jfn, tfn = _eps_pair(11)
    noise = np.random.default_rng(12).normal(size=(2, 16, 7)).astype(np.float32)
    # fp32 arithmetic in the same order; the eps model's matmul may sum in
    # another order, and the first DDIM step amplifies eps by ~1/sqrt(acp)
    tol = dict(rtol=1e-4, atol=1e-4)
    s8 = jgd.create_schedule("ddim8")
    np.testing.assert_allclose(
        _np(tgd.ddim_sample_loop(tgd.create_schedule("ddim8"), tfn, torch.from_numpy(noise))),
        np.asarray(jgd.ddim_sample_loop(s8, jfn, jnp.asarray(noise))), **tol)
    full_j, full_t = jgd.create_schedule(""), tgd.create_schedule("")
    np.testing.assert_allclose(
        _np(tdpm.dpm_solver_pp_2m(full_t, tfn, torch.from_numpy(noise), num_steps=4)),
        np.asarray(jdpm.dpm_solver_pp_2m(full_j, jfn, jnp.asarray(noise), num_steps=4)), **tol)


def test_ddpm_step_with_the_jax_draws():
    """ddpm_step takes its draw z as an argument: fed the draws the JAX loop
    makes from its key, the port's loop reproduces the JAX sample."""
    jfn, tfn = _eps_pair(13)
    sched_j, sched_t = jgd.create_schedule("ddim8"), tgd.create_schedule("ddim8")
    noise = np.random.default_rng(14).normal(size=(1, 16, 7)).astype(np.float32)
    key = jax.random.PRNGKey(15)
    want = np.asarray(jgd.ddpm_sample_loop(sched_j, jfn, jnp.asarray(noise), key=key))
    keys = jax.random.split(key, sched_j.num_timesteps)
    x = torch.from_numpy(noise)
    for i, t_scalar in enumerate(range(sched_t.num_timesteps - 1, -1, -1)):
        z = torch.from_numpy(np.asarray(jax.random.normal(keys[i], noise.shape, jnp.float32)))
        x = tgd.ddpm_step(sched_t, tfn, x, t_scalar, z)
    np.testing.assert_allclose(_np(x), want, rtol=1e-4, atol=1e-4)
    g = torch.Generator().manual_seed(0)
    assert torch.isfinite(tgd.ddpm_sample_loop(sched_t, tfn, torch.from_numpy(noise), generator=g)).all()
