"""The diffusion modules beside the policy's sampler, against the JAX package
on the CPU: the named beta schedules and IDDPM respacing
(diffusion/gaussian.py), the timestep samplers (diffusion/timestep_sampler.py),
the variational bound (diffusion/likelihood.py: every function, every mean
and variance type, training_losses with gradients, the bpd loop with JAX's
per-step noise replayed) and the DiT head's training loss and condition
dropout (models/action_model.py)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mla_tpu.diffusion import gaussian as jgd
from mla_tpu.diffusion import likelihood as jlk
from mla_tpu.diffusion import timestep_sampler as jts
from mla_tpu.models import action_model as jam
from mla_tpu_torch.diffusion import gaussian as tgd
from mla_tpu_torch.diffusion import likelihood as tlk
from mla_tpu_torch.diffusion import timestep_sampler as tts
from mla_tpu_torch.models import action_model as tam
from mla_tpu_torch.params import from_jax, tree_items

# fp32 on both sides: XLA and PyTorch differ only in summation order and in
# their exp / log / tanh, each within a few ulps; the bound's terms divide
# by posterior variances down to ~1e-4 of the signal, which scales those
# ulps up to ~1e-6 of a term's size
RTOL, ATOL = 2e-5, 2e-6


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


# The decoder's likelihood at t = 0 is log(cdf_plus - cdf_min). Where a
# bin's mass is tiny but the fp32 cdfs are not yet saturated, the difference
# is a few ulps of ~1 and has no correct digit in either package (each
# rounds its own tanh): such elements are held only to a mass under
# ILL_MASS in both, and a row's mean over them to the widest gap that
# allows. Elsewhere the usual tolerance holds.
ILL_MASS = 1e-5
ILL_GAP = np.log(ILL_MASS) + 1.0 - np.log(1e-12)  # nats between the clip and ILL_MASS (+1 for rounding)


def _bin_mass(x, means, log_scales):
    """The discretized likelihood's bin mass in float64."""
    x, m, s = (np.asarray(a.detach() if isinstance(a, torch.Tensor) else a, np.float64) for a in (x, means, log_scales))

    def cdf(v):
        return 0.5 * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (v + 0.044715 * v**3)))

    plus, minus = cdf(np.exp(-s) * (x - m + 1 / 255)), cdf(np.exp(-s) * (x - m - 1 / 255))
    return np.where(x < -0.999, plus, np.where(x > 0.999, 1 - minus, plus - minus))


def _ill(x, means, log_scales):
    return _bin_mass(x, means, log_scales) < ILL_MASS


def _close_decoder(got, want, ill, what=""):
    """Elementwise log-likelihoods: the tolerance where well conditioned,
    both under log(ILL_MASS) + 1 where ill conditioned."""
    got, want = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got), np.asarray(want)
    _close(got[~ill], want[~ill], what=what)
    assert (got[ill] <= np.log(ILL_MASS) + 1).all() and (want[ill] <= np.log(ILL_MASS) + 1).all(), what


def _close_bits(got, want, ill, what=""):
    """Per-row bits whose rows average decoder terms (ill [rows, ...] marks
    the ill-conditioned elements of each row; all False for a KL row)."""
    got, want = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got), np.asarray(want)
    ill = np.asarray(ill).reshape(len(got), -1)
    slack = ill.sum(1) * ILL_GAP / (ill.shape[1] * np.log(2.0))
    assert (np.abs(got - want) <= RTOL * np.abs(want) + ATOL + slack).all(), (what, got, want, slack)


# --------------------------------------------------------------------------- #
# schedules and respacing
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name,steps", [("linear", 1000), ("linear", 100), ("squaredcos_cap_v2", 100),
                                        ("squaredcos_cap_v2", 37)])
def test_named_beta_schedules(name, steps):
    np.testing.assert_array_equal(tgd.get_named_beta_schedule(name, steps), jgd.get_named_beta_schedule(name, steps))


def test_unknown_schedule_raises_as_jax():
    for mod in (jgd, tgd):
        with pytest.raises(NotImplementedError, match="unknown beta schedule: cosine"):
            mod.get_named_beta_schedule("cosine", 10)


SPACINGS = [(100, "ddim8"), (100, "ddim1"), (40, "ddim1"), (100, "ddim100"), (100, "10,10,10"), (100, "1,2,3"),
            (10, "10"), (101, "7,0,5"), (1000, "250"), (100, [5, 25]), (17, [3, 3, 3, 3])]


@pytest.mark.parametrize("steps,spacing", SPACINGS, ids=[f"{s}-{p}" for s, p in SPACINGS])
def test_space_timesteps(steps, spacing):
    assert tgd.space_timesteps(steps, spacing) == jgd.space_timesteps(steps, spacing)


@pytest.mark.parametrize("steps,spacing,msg", [(100, "ddim11", "cannot create exactly 11 steps"),
                                               (10, "6,6", "cannot divide section of 5 steps into 6"),
                                               (100, "a,b", "invalid literal")])
def test_space_timesteps_errors(steps, spacing, msg):
    for mod in (jgd, tgd):
        with pytest.raises(ValueError, match=msg):
            mod.space_timesteps(steps, spacing)


@pytest.mark.parametrize("respacing,noise_schedule,steps", [("", "linear", 1000), ("10,20", "linear", 100),
                                                            ("25", "squaredcos_cap_v2", 100),
                                                            ([4, 4], "squaredcos_cap_v2", 100)]
                         + [(f"ddim{n}", "squaredcos_cap_v2", 100) for n in (1, 2, 4, 5, 8, 10, 20, 50)])
def test_create_schedule_tables(respacing, noise_schedule, steps):
    """Every table of the schedule, float64, bit for bit; the policy's
    ddimN schedules (default arguments) among them."""
    j = jgd.create_schedule(respacing, noise_schedule, steps)
    t = tgd.create_schedule(respacing, noise_schedule, steps)
    for name in ("betas", "timestep_map", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod", "posterior_variance", "posterior_log_variance_clipped",
                 "posterior_mean_coef1", "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    if noise_schedule == "squaredcos_cap_v2" and steps == 100:
        np.testing.assert_array_equal(tgd.create_schedule(respacing, diffusion_steps=100).betas, t.betas)


# --------------------------------------------------------------------------- #
# timestep samplers
# --------------------------------------------------------------------------- #


def test_uniform_sample():
    g = torch.Generator().manual_seed(0)
    t, w = tts.uniform_sample(g, 4096, 100)
    jt, jw = jts.uniform_sample(jax.random.PRNGKey(0), 4096, 100)
    assert t.shape == jt.shape and int(t.min()) >= 0 and int(t.max()) < 100
    assert w.dtype == torch.float32 and (w == 1).all() and (np.asarray(jw) == 1).all()
    assert len(torch.unique(t)) == 100  # every timestep drawn


def _state_equal(t_state, j_state):
    np.testing.assert_array_equal(t_state["loss_history"].numpy(), np.asarray(j_state["loss_history"]))
    np.testing.assert_array_equal(t_state["loss_counts"].numpy(), np.asarray(j_state["loss_counts"]))


def test_loss_second_moment_update_with_duplicates():
    """A run of updates whose batches repeat timesteps: the port's state
    equals JAX's after every update (the last occurrence's loss wins, the
    count rises once), through the warm-up and the full-history shifts."""
    T, H = 12, 4
    rng = np.random.default_rng(0)
    js, ts = jts.init_loss_second_moment_state(T, H), tts.init_loss_second_moment_state(T, H)
    for step in range(14):
        t = rng.integers(0, T, size=9)
        t[-1] = t[0]  # at least one repeat in every batch
        losses = rng.uniform(0.1, 2.0, size=9).astype(np.float32)
        js = jts.update_loss_second_moment(js, jnp.asarray(t, jnp.int32), jnp.asarray(losses))
        ts = tts.update_loss_second_moment(ts, torch.from_numpy(t), torch.from_numpy(losses))
        _state_equal(ts, js)
    assert (ts["loss_counts"] == H).all()


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_loss_second_moment_sample(warm, record_property):
    """Weights of JAX's draws: the port's weights at JAX's t (override_t)
    equal JAX's within fp32 reduction order (1e-6); the port's own draws
    follow its probabilities (chi-square of 20 000 draws)."""
    T, H = 10, 3
    js, ts = jts.init_loss_second_moment_state(T, H), tts.init_loss_second_moment_state(T, H)
    if warm:
        rng = np.random.default_rng(1)
        hist = rng.uniform(0.05, 3.0, size=(T, H)).astype(np.float32)
        hist[3] *= 10  # one timestep with large losses
        js = {"loss_history": jnp.asarray(hist), "loss_counts": jnp.full((T,), H, jnp.int32)}
        ts = {"loss_history": torch.from_numpy(hist), "loss_counts": torch.full((T,), H, dtype=torch.int32)}
    jt, jw = jts.loss_second_moment_sample(js, jax.random.PRNGKey(3), 4096)
    t, w = tts.loss_second_moment_sample(ts, None, 4096, override_t=torch.from_numpy(np.array(jt)))
    record_property("max_rel_err", float(np.max(np.abs(w.numpy() - np.asarray(jw)) / np.asarray(jw))))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    probs = tts.loss_second_moment_probs(ts)
    np.testing.assert_allclose(probs.sum().item(), 1.0, rtol=1e-6)
    if not warm:
        assert (probs == 1.0 / T).all()
    n = 20000
    t, _ = tts.loss_second_moment_sample(ts, torch.Generator().manual_seed(0), n)
    counts = np.bincount(t.numpy(), minlength=T)
    expected = probs.numpy().astype(np.float64) * n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 40.0, chi2  # 9 degrees of freedom: p < 1e-5


# --------------------------------------------------------------------------- #
# likelihood: a small model of both packages
# --------------------------------------------------------------------------- #

B, TT, C = 3, 16, 7  # actions [B, horizon, action_dim]; the learned variance doubles axis 1


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(C, C)) * 0.4).astype(np.float32),
            "wv": (rng.normal(size=(C, C)) * 0.4).astype(np.float32),
            "tw": rng.normal(size=(C,)).astype(np.float32)}


def _model(weights, learned, xp):
    """(x, t_model) -> output; a second half on axis 1 in [-1, 1] when
    learned. xp is jnp or torch, weights of that package."""
    tanh = jnp.tanh if xp is jnp else torch.tanh
    cat = (lambda a: jnp.concatenate(a, axis=1)) if xp is jnp else (lambda a: torch.cat(a, dim=1))

    def fn(x, t):
        tt = t.astype(jnp.float32) if xp is jnp else t.float()
        temb = tt[:, None, None] * 0.01 * weights["tw"]
        mean = tanh(x @ weights["w"] + temb)
        return cat([mean, tanh(x @ weights["wv"] - temb)]) if learned else mean

    return fn


def _both_models(learned, seed=0):
    w = _weights(seed)
    return _model({k: jnp.asarray(v) for k, v in w.items()}, learned, jnp), \
        _model({k: torch.from_numpy(v) for k, v in w.items()}, learned, torch)


def _inputs(seed=0, T=100):
    rng = np.random.default_rng(seed)
    x0 = np.clip(rng.normal(size=(B, TT, C)) * 0.5, -1, 1).astype(np.float32)
    x0[0, 0, :3] = [-1.0, 1.0, 0.9995]  # the open-ended edge bins
    noise = rng.normal(size=(B, TT, C)).astype(np.float32)
    t = np.array([0, 1, T - 1], np.int32)
    return x0, noise, t


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_elementwise_terms():
    rng = np.random.default_rng(2)
    a, b, c, d = (rng.normal(size=(4, 5)).astype(np.float32) for _ in range(4))
    _close(tlk.normal_kl(*_t(a, b, c, d)), jlk.normal_kl(*_j(a, b, c, d)))
    _close(tlk.normal_kl(torch.from_numpy(a), torch.from_numpy(b), 0.0, 0.0), jlk.normal_kl(a, b, 0.0, 0.0))
    x = rng.uniform(-4, 4, size=(6, 7)).astype(np.float32)
    _close(tlk.approx_standard_normal_cdf(torch.from_numpy(x)), jlk.approx_standard_normal_cdf(jnp.asarray(x)))
    means, scales = rng.normal(size=(6, 7)).astype(np.float32) * 0.3, rng.uniform(-3, 0, (6, 7)).astype(np.float32)
    xs = np.clip(rng.normal(size=(6, 7)), -1, 1).astype(np.float32)
    xs[0, :2] = [-1.0, 1.0]
    for name in ("continuous_gaussian_log_likelihood", "discretized_gaussian_log_likelihood"):
        got = getattr(tlk, name)(torch.from_numpy(xs), means=torch.from_numpy(means), log_scales=torch.from_numpy(scales))
        want = getattr(jlk, name)(jnp.asarray(xs), means=jnp.asarray(means), log_scales=jnp.asarray(scales))
        ill = _ill(xs, means, scales) if name.startswith("discretized") else np.zeros(xs.shape, bool)
        _close_decoder(got, want, ill, what=name)
    _close(tlk.mean_flat(torch.from_numpy(means)), jlk.mean_flat(jnp.asarray(means)))


@pytest.mark.parametrize("respacing", ["", "ddim10"])
def test_q_and_inversions(respacing):
    sj, st = jgd.create_schedule(respacing), tgd.create_schedule(respacing)
    x0, noise, t = _inputs(T=st.num_timesteps)
    for got, want in zip(tlk.q_mean_variance(st, *_t(x0, t)), jlk.q_mean_variance(sj, *_j(x0, t))):
        _close(got, want)
    _close(tlk.pred_xstart_from_xprev(st, *_t(noise, t, x0)), jlk.pred_xstart_from_xprev(sj, *_j(noise, t, x0)))
    _close(tlk.pred_eps_from_xstart(st, *_t(noise, t, x0)), jlk.pred_eps_from_xstart(sj, *_j(noise, t, x0)))


MEAN_TYPES = list(tlk.ModelMeanType)
VAR_TYPES = list(tlk.ModelVarType)


def _jtype(e):
    """The JAX package's member of the same enum."""
    return getattr(getattr(jlk, type(e).__name__), e.name)


@pytest.mark.parametrize("mean_type,var_type", list(itertools.product(MEAN_TYPES, VAR_TYPES)),
                         ids=lambda e: e.name)
def test_p_mean_variance_and_vb_terms(mean_type, var_type):
    """Every mean and variance type, clipped and not, on a respaced
    schedule (the model sees the original timesteps): the moments, x_0 and
    the vb term in bits, t = 0 (the decoder's likelihood) included; the
    model_output short-circuit gives the same as the call."""
    learned = var_type in (tlk.ModelVarType.LEARNED, tlk.ModelVarType.LEARNED_RANGE)
    jfn, tfn = _both_models(learned)
    sj, st = jgd.create_schedule("ddim10"), tgd.create_schedule("ddim10")
    x0, xt, t = _inputs(1, T=st.num_timesteps)
    kw_t = dict(mean_type=mean_type, var_type=var_type)
    kw_j = dict(mean_type=_jtype(mean_type), var_type=_jtype(var_type))
    for clip in (True, False):
        got = tlk.p_mean_variance(st, tfn, *_t(xt, t), clip_denoised=clip, **kw_t)
        want = jlk.p_mean_variance(sj, jfn, *_j(xt, t), clip_denoised=clip, **kw_j)
        for k in ("mean", "variance", "log_variance", "pred_xstart"):
            _close(got[k], want[k], what=f"{k} clip={clip}")
    got = tlk.vb_terms_bpd(st, tfn, *_t(x0, xt, t), **kw_t)
    want = jlk.vb_terms_bpd(sj, jfn, *_j(x0, xt, t), **kw_j)
    moments = tlk.p_mean_variance(st, tfn, *_t(xt, t), **kw_t)
    ill = _ill(x0, moments["mean"], 0.5 * moments["log_variance"]) & (t == 0)[:, None, None]
    _close_bits(got["output"], want["output"], ill, what="vb")
    _close(got["pred_xstart"], want["pred_xstart"], what="vb pred_xstart")
    out = tfn(torch.from_numpy(xt), tlk._t_model(st, torch.from_numpy(t)))
    short = tlk.vb_terms_bpd(st, None, *_t(x0, xt, t), model_output=out, **kw_t)
    assert torch.equal(short["output"], got["output"])


LOSS_CASES = ([(lt, vt, tlk.ModelMeanType.EPSILON) for lt in tlk.LossType
               for vt in (tlk.ModelVarType.FIXED_SMALL, tlk.ModelVarType.LEARNED_RANGE, tlk.ModelVarType.LEARNED)]
              + [(tlk.LossType.MSE, tlk.ModelVarType.FIXED_LARGE, mt) for mt in tlk.ModelMeanType])


@pytest.mark.parametrize("loss_type,var_type,mean_type", LOSS_CASES,
                         ids=[f"{a.name}-{b.name}-{c.name}" for a, b, c in LOSS_CASES])
def test_training_losses_and_gradients(loss_type, var_type, mean_type):
    """Each loss type's terms on the 100-step schedule and their gradients
    with respect to the model's weights (torch autograd against jax.grad,
    each leaf within RTOL of its own scale). With a learned variance the vb
    term reaches the mean's weights through nothing (.detach(), JAX's
    stop_gradient): their gradient is the mse term's alone."""
    learned = var_type in (tlk.ModelVarType.LEARNED, tlk.ModelVarType.LEARNED_RANGE)
    w = _weights(3)
    sj, st = jgd.create_schedule(""), tgd.create_schedule("")
    x0, noise, t = _inputs(2)
    kw_t = dict(mean_type=mean_type, var_type=var_type, loss_type=loss_type)
    kw_j = dict(mean_type=_jtype(mean_type), var_type=_jtype(var_type), loss_type=_jtype(loss_type))

    def jloss(jw):
        terms = jlk.training_losses(sj, _model(jw, learned, jnp), *_j(x0, t, noise), **kw_j)
        return terms["loss"].sum(), terms

    (_, jterms), jgrads = jax.value_and_grad(jloss, has_aux=True)({k: jnp.asarray(v) for k, v in w.items()})
    tw = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    tfn = _model(tw, learned, torch)
    terms = tlk.training_losses(st, tfn, *_t(x0, t, noise), **kw_t)
    assert sorted(terms) == sorted(jterms)
    ill = np.zeros(x0.shape, bool)
    if "vb" in terms or loss_type.is_vb():
        with torch.no_grad():
            xt = tgd.q_sample(st, *_t(x0, t, noise))
            moments = tlk.p_mean_variance(st, tfn, xt, torch.from_numpy(t), mean_type=mean_type, var_type=var_type,
                                          clip_denoised=False)
        ill = _ill(x0, moments["mean"], 0.5 * moments["log_variance"]) & (t == 0)[:, None, None]
    for k in terms:
        _close_bits(terms[k], jterms[k], ill if k in ("loss", "vb") else np.zeros_like(ill), what=k)
    # the gradient of a t = 0 row runs through the decoder's log(cdf_plus -
    # cdf_min) and inherits its ill-conditioned elements: held on t > 0
    jgrads = jax.grad(lambda jw: jloss(jw)[1]["loss"][1:].sum())({k: jnp.asarray(v) for k, v in w.items()})
    assert t[0] == 0 and (t[1:] > 0).all()
    terms["loss"][1:].sum().backward()
    for k in w:
        g = tw[k].grad.numpy() if tw[k].grad is not None else np.zeros_like(w[k])
        jg = np.asarray(jgrads[k])
        scale = max(float(np.abs(jg).max()), 1e-12)
        assert float(np.abs(g - jg).max()) <= RTOL * scale + ATOL, k
    if learned and not loss_type.is_vb():
        tw2 = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
        mse = tlk.training_losses(st, _model(tw2, learned, torch), *_t(x0, t, noise), **kw_t)["mse"]
        mse[1:].sum().backward()
        torch.testing.assert_close(tw2["w"].grad, tw["w"].grad, rtol=1e-6, atol=1e-7)
        assert float(tw["wv"].grad.abs().max()) > 0


@pytest.mark.parametrize("respacing,var_type", [("", tlk.ModelVarType.FIXED_SMALL),
                                                ("10,10", tlk.ModelVarType.LEARNED_RANGE),
                                                ("10,10", tlk.ModelVarType.FIXED_LARGE)],
                         ids=["full-fixed_small", "20-learned_range", "20-fixed_large"])
def test_calc_bpd_loop_with_jax_noise(respacing, var_type, record_property):
    """JAX's per-step draws (jax.random.split(key, T), then normal per key)
    replayed through `noise`: every output of the loop, and the prior."""
    learned = var_type == tlk.ModelVarType.LEARNED_RANGE
    jfn, tfn = _both_models(learned, seed=4)
    sj, st = jgd.create_schedule(respacing), tgd.create_schedule(respacing)
    x0, _, _ = _inputs(5)
    key = jax.random.PRNGKey(6)
    want = jlk.calc_bpd_loop(sj, jfn, jnp.asarray(x0), key, var_type=_jtype(var_type))
    noise = np.stack([np.asarray(jax.random.normal(k, x0.shape, jnp.float32))
                      for k in jax.random.split(key, st.num_timesteps)])
    got = tlk.calc_bpd_loop(st, tfn, torch.from_numpy(x0), noise=torch.from_numpy(noise), var_type=var_type)
    assert got["vb"].shape == (B, st.num_timesteps)
    record_property("max_abs_err_total_bpd", float(np.abs(got["total_bpd"].numpy() - np.asarray(want["total_bpd"])).max()))
    # the last column (t = 0) is the decoder's term
    t0 = torch.zeros(B, dtype=torch.long)
    x1 = tgd.q_sample(st, torch.from_numpy(x0), t0, torch.from_numpy(noise[-1]))
    moments = tlk.p_mean_variance(st, tfn, x1, t0, var_type=var_type)
    ill = _ill(x0, moments["mean"], 0.5 * moments["log_variance"])
    for k in ("prior_bpd", "xstart_mse", "mse"):
        _close(got[k], want[k], what=k)
    _close(got["vb"][:, :-1], np.asarray(want["vb"])[:, :-1], what="vb, t > 0")
    _close_bits(got["vb"][:, -1], np.asarray(want["vb"])[:, -1], ill, what="vb, t = 0")
    _close_bits(got["total_bpd"], want["total_bpd"], ill, what="total_bpd")
    record_property("ill_conditioned_decoder_elements", int(ill.sum()))
    _close(tlk.prior_bpd(st, torch.from_numpy(x0)), jlk.prior_bpd(sj, jnp.asarray(x0)))
    drawn = tlk.calc_bpd_loop(st, tfn, torch.from_numpy(x0), torch.Generator().manual_seed(0), var_type=var_type)
    assert torch.isfinite(drawn["total_bpd"]).all() and torch.equal(drawn["prior_bpd"], got["prior_bpd"])


# --------------------------------------------------------------------------- #
# the DiT head's training loss and condition dropout
# --------------------------------------------------------------------------- #


def _dit(dropout=0.1):
    kw = dict(depth=2, hidden_size=64, num_heads=4, token_size=32, in_channels=7, future_action_window_size=15,
              class_dropout_prob=dropout)
    jcfg, tcfg = jam.dit_config("DiT-S", **kw), tam.dit_config("DiT-S", **kw)
    params = jam.dit_init(jax.random.PRNGKey(2), jcfg)
    fc2 = params["final_layer"]["mlp"]["fc2"]
    fc2["w"] = jnp.asarray(np.random.default_rng(2).normal(size=fc2["w"].shape).astype(np.float32) * 0.05)
    return jcfg, tcfg, params


def test_dit_loss_with_replayed_draws(record_property):
    """JAX's dit_loss (noise, t and the condition dropout from split(rng,
    3)) against the port's with the three draws replayed: the loss within
    RTOL, each gradient leaf within RTOL of its own scale."""
    jcfg, tcfg, params = _dit(dropout=0.5)
    sched_j, sched_t = jgd.create_schedule(""), tgd.create_schedule("")
    rng = np.random.default_rng(8)
    x = np.clip(rng.normal(size=(8, 16, 7)), -1, 1).astype(np.float32)
    z = rng.normal(size=(8, 1, 32)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    jl, jg = jax.value_and_grad(lambda p: jam.dit_loss(p, jcfg, sched_j, jnp.asarray(x), jnp.asarray(z), key))(params)
    k1, k2, k3 = jax.random.split(key, 3)
    noise = np.array(jax.random.normal(k1, x.shape, jnp.float32))
    t = np.array(jax.random.randint(k2, (8,), 0, 100))
    drop = np.asarray(jax.random.uniform(k3, (8,)) < jcfg.class_dropout_prob).astype(np.int64)
    assert 0 < drop.sum() < 8  # both kinds of row
    tp = from_jax(params)
    leaves = dict(tree_items(tp))
    for v in leaves.values():
        v.requires_grad_()
    loss = tam.dit_loss(tp, tcfg, sched_t, torch.from_numpy(x), torch.from_numpy(z), None,
                        override_noise=torch.from_numpy(noise), override_t=torch.from_numpy(t),
                        override_drop=torch.from_numpy(drop))
    record_property("loss_abs_err", abs(loss.item() - float(jl)))
    assert loss.item() == pytest.approx(float(jl), rel=RTOL)
    loss.backward()
    jleaves = dict(tree_items(jax.tree_util.tree_map(np.asarray, jg)))
    assert sorted(jleaves) == sorted(leaves)
    for k, v in leaves.items():
        scale = max(float(np.abs(jleaves[k]).max()), 1e-12)
        assert float(np.abs(v.grad.numpy() - jleaves[k]).max()) <= RTOL * scale + ATOL, k
    assert float(leaves["uncondition"].grad.abs().max()) > 0  # the dropped rows train it


def test_dit_forward_training_dropout():
    """dit_forward in training with a forced drop mask: JAX's rows (the
    mask its key draws) exactly reproduced; dropped rows are the
    inference forward on the uncondition vector, kept rows the plain
    forward. With a generator the draw is the port's own, and without one
    (or out of training) nothing is dropped, as in JAX."""
    jcfg, tcfg, params = _dit(dropout=0.5)
    tp = from_jax(params)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(8, 16, 7)).astype(np.float32)
    z = rng.normal(size=(8, 1, 32)).astype(np.float32)
    t = rng.integers(0, 100, size=8).astype(np.int32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jam.dit_forward(params, jcfg, *_j(x, t, z), training=True, key=key))
    drop = np.asarray(jax.random.uniform(key, (8,)) < 0.5).astype(np.int64)
    assert 0 < drop.sum() < 8
    got = tam.dit_forward(tp, tcfg, *_t(x, t, z), training=True, force_drop_ids=torch.from_numpy(drop))
    _close(got, want, rtol=1e-5, atol=1e-5)
    plain = tam.dit_forward(tp, tcfg, *_t(x, t, z))
    uncond = tam.dit_forward(tp, tcfg, *_t(x, t), tp["uncondition"][None].expand(8, 1, 32))
    rows = torch.from_numpy(drop.astype(bool))
    # row for row the same inputs; the products' blocking may differ with the batch's other rows
    torch.testing.assert_close(got[rows], uncond[rows], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[~rows], plain[~rows], rtol=1e-6, atol=1e-6)
    assert torch.equal(tam.dit_forward(tp, tcfg, *_t(x, t, z), training=True), plain)
    assert torch.equal(tam.dit_forward(tp, tcfg, *_t(x, t, z), generator=torch.Generator().manual_seed(0)), plain)
    g1 = tam.dit_forward(tp, tcfg, *_t(x, t, z), training=True, generator=torch.Generator().manual_seed(1))
    g2 = tam.dit_forward(tp, tcfg, *_t(x, t, z), training=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(g1, g2) and not torch.equal(g1, plain)
