"""The variational bound and likelihoods of Gaussian diffusion.

Counterpart of mla_tpu/diffusion/likelihood.py (IDDPM's
gaussian_diffusion.py and diffusion_utils.py): the KL and discretized
Gaussian log-likelihood terms, p(x_{t-1} | x_t) for every mean and variance
type, the variational-bound training losses (KL, RESCALED_KL, and the
learned variance's `vb` term beside MSE) and the bits-per-dim loop.

MLA's own configuration (EPSILON mean, FIXED_SMALL variance, MSE loss)
trains without this module; it serves likelihood evaluation. The tables
stay float64 numpy, gathered as fp32; the bpd loop is a Python loop over
the timesteps T-1..0 on the tensors' device. A learned variance is split
off on axis 1, JAX's (and IDDPM's image) channel convention: for an action
tensor [B, T, action_dim] that axis is the chunk's time, as in JAX.
"""

from __future__ import annotations

import enum
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from mla_tpu_torch.diffusion.gaussian import Schedule, _extract, pred_xstart_from_eps, q_posterior_mean, q_sample


class ModelMeanType(enum.Enum):
    PREVIOUS_X = enum.auto()
    START_X = enum.auto()
    EPSILON = enum.auto()


class ModelVarType(enum.Enum):
    LEARNED = enum.auto()
    FIXED_SMALL = enum.auto()
    FIXED_LARGE = enum.auto()
    LEARNED_RANGE = enum.auto()


class LossType(enum.Enum):
    MSE = enum.auto()
    RESCALED_MSE = enum.auto()
    KL = enum.auto()
    RESCALED_KL = enum.auto()

    def is_vb(self) -> bool:
        return self in (LossType.KL, LossType.RESCALED_KL)


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes."""
    return x.reshape(x.shape[0], -1).mean(dim=1)


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL(N(mean1, var1) || N(mean2, var2)) in nats, elementwise; at least
    one argument is a tensor, the others may be floats."""
    ref = next(a for a in (mean1, logvar1, mean2, logvar2) if isinstance(a, torch.Tensor))
    mean1, logvar1, mean2, logvar2 = (torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
                                      for a in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + torch.square(mean1 - mean2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def continuous_gaussian_log_likelihood(x, *, means, log_scales) -> torch.Tensor:
    z = (x - means) * torch.exp(-log_scales)
    return -0.5 * (z**2 + math.log(2 * math.pi))


def discretized_gaussian_log_likelihood(x, *, means, log_scales) -> torch.Tensor:
    """Log-likelihood of values discretized into 256 uint8 bins rescaled to
    [-1, 1], the edge bins open-ended."""
    inv_stdv = torch.exp(-log_scales)
    centered = x - means
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus, torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


# --------------------------------------------------------------------------- #
# q and p distributions
# --------------------------------------------------------------------------- #


def q_mean_variance(sched: Schedule, x_start, t):
    """Mean, variance and log variance of q(x_t | x_0)."""
    mean = _extract(sched.sqrt_alphas_cumprod, t, x_start.shape) * x_start
    variance = _extract(1.0 - sched.alphas_cumprod, t, x_start.shape)
    log_variance = _extract(np.log(1.0 - sched.alphas_cumprod), t, x_start.shape)
    return mean, variance, log_variance


def pred_xstart_from_xprev(sched: Schedule, x_t, t, xprev):
    """x_0 from a PREVIOUS_X model's posterior mean."""
    c1 = _extract(sched.posterior_mean_coef1, t, x_t.shape)
    c2 = _extract(sched.posterior_mean_coef2, t, x_t.shape)
    return xprev / c1 - (c2 / c1) * x_t


def pred_eps_from_xstart(sched: Schedule, x_t, t, x0):
    return (_extract(sched.sqrt_recip_alphas_cumprod, t, x_t.shape) * x_t - x0) / _extract(
        sched.sqrt_recipm1_alphas_cumprod, t, x_t.shape)


# model_fn: (x, t_model) -> model output, with twice x's channels on axis 1
# when the variance is learned
ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _t_model(sched: Schedule, t: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(sched.timestep_map, np.int64), device=t.device)[t.long()]


def p_mean_variance(sched: Schedule, model_fn: Optional[ModelFn], x: torch.Tensor, t: torch.Tensor, *,
                    mean_type: ModelMeanType = ModelMeanType.EPSILON,
                    var_type: ModelVarType = ModelVarType.FIXED_SMALL, clip_denoised: bool = True,
                    denoised_fn: Optional[Callable] = None,
                    model_output: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Mean, variance and log variance of p(x_{t-1} | x_t), and the x_0
    prediction. A given `model_output` stands in for the model's call (the
    frozen-mean output of the learned variance's vb term)."""
    if model_output is None:
        model_output = model_fn(x, _t_model(sched, t))

    if var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
        C = x.shape[1]
        model_output, var_values = model_output[:, :C], model_output[:, C:]
        if var_type == ModelVarType.LEARNED:
            log_variance = var_values
        else:
            min_log = _extract(sched.posterior_log_variance_clipped, t, x.shape)
            max_log = _extract(np.log(sched.betas), t, x.shape)
            frac = (var_values + 1) / 2  # [-1, 1] -> [min, max]
            log_variance = frac * max_log + (1 - frac) * min_log
        variance = torch.exp(log_variance)
    elif var_type == ModelVarType.FIXED_LARGE:
        # the first entry is the posterior's, so the decoder's likelihood
        # stays finite
        var_table = np.append(sched.posterior_variance[1], sched.betas[1:])
        variance = _extract(var_table, t, x.shape)
        log_variance = _extract(np.log(var_table), t, x.shape)
    else:
        variance = _extract(sched.posterior_variance, t, x.shape)
        log_variance = _extract(sched.posterior_log_variance_clipped, t, x.shape)

    def process(x0):
        if denoised_fn is not None:
            x0 = denoised_fn(x0)
        return torch.clamp(x0, -1, 1) if clip_denoised else x0

    if mean_type == ModelMeanType.START_X:
        pred_xstart = process(model_output)
    elif mean_type == ModelMeanType.PREVIOUS_X:
        pred_xstart = process(pred_xstart_from_xprev(sched, x, t, model_output))
    else:
        pred_xstart = process(pred_xstart_from_eps(sched, x, t, model_output))
    mean = q_posterior_mean(sched, pred_xstart, x, t)
    return {"mean": mean, "variance": variance, "log_variance": log_variance, "pred_xstart": pred_xstart}


def vb_terms_bpd(sched: Schedule, model_fn: Optional[ModelFn], x_start: torch.Tensor, x_t: torch.Tensor,
                 t: torch.Tensor, *, mean_type: ModelMeanType = ModelMeanType.EPSILON,
                 var_type: ModelVarType = ModelVarType.FIXED_SMALL, clip_denoised: bool = True,
                 model_output: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One term of the variational bound in bits: the KL to the true
    posterior, or the decoder's negative log-likelihood at t = 0."""
    true_mean = q_posterior_mean(sched, x_start, x_t, t)
    true_log_var = _extract(sched.posterior_log_variance_clipped, t, x_t.shape)
    out = p_mean_variance(sched, model_fn, x_t, t, mean_type=mean_type, var_type=var_type,
                          clip_denoised=clip_denoised, model_output=model_output)
    kl = mean_flat(normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])) / math.log(2.0)
    decoder_nll = -mean_flat(discretized_gaussian_log_likelihood(
        x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])) / math.log(2.0)
    return {"output": torch.where(t == 0, decoder_nll, kl), "pred_xstart": out["pred_xstart"]}


def training_losses(sched: Schedule, model_fn: ModelFn, x_start: torch.Tensor, t: torch.Tensor,
                    noise: torch.Tensor, *, mean_type: ModelMeanType = ModelMeanType.EPSILON,
                    var_type: ModelVarType = ModelVarType.FIXED_SMALL,
                    loss_type: LossType = LossType.MSE) -> Dict[str, torch.Tensor]:
    """Per-example losses at timesteps t from the given noise: "loss", and
    "mse" and (learned variance) "vb" for the MSE types."""
    x_t = q_sample(sched, x_start, t, noise)
    terms: Dict[str, torch.Tensor] = {}
    if loss_type.is_vb():
        terms["loss"] = vb_terms_bpd(sched, model_fn, x_start, x_t, t, mean_type=mean_type, var_type=var_type,
                                     clip_denoised=False)["output"]
        if loss_type == LossType.RESCALED_KL:
            terms["loss"] = terms["loss"] * sched.num_timesteps
        return terms

    model_output = model_fn(x_t, _t_model(sched, t))
    if var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
        C = x_t.shape[1]
        mean_out, var_values = model_output[:, :C], model_output[:, C:]
        # the variance learns through the vb term alone: the mean is frozen there
        frozen = torch.cat([mean_out.detach(), var_values], dim=1)
        terms["vb"] = vb_terms_bpd(sched, model_fn, x_start, x_t, t, mean_type=mean_type, var_type=var_type,
                                   clip_denoised=False, model_output=frozen)["output"]
        if loss_type == LossType.RESCALED_MSE:
            terms["vb"] = terms["vb"] * (sched.num_timesteps / 1000.0)
        model_output = mean_out

    if mean_type == ModelMeanType.PREVIOUS_X:
        target = q_posterior_mean(sched, x_start, x_t, t)
    elif mean_type == ModelMeanType.START_X:
        target = x_start
    else:
        target = noise
    terms["mse"] = mean_flat((target - model_output) ** 2)
    terms["loss"] = terms["mse"] + terms["vb"] if "vb" in terms else terms["mse"]
    return terms


def prior_bpd(sched: Schedule, x_start: torch.Tensor) -> torch.Tensor:
    """KL(q(x_T | x_0) || N(0, I)) in bits per dimension."""
    t = torch.full((x_start.shape[0],), sched.num_timesteps - 1, dtype=torch.long, device=x_start.device)
    qt_mean, _, qt_log_var = q_mean_variance(sched, x_start, t)
    return mean_flat(normal_kl(qt_mean, qt_log_var, 0.0, 0.0)) / math.log(2.0)


def calc_bpd_loop(sched: Schedule, model_fn: ModelFn, x_start: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *, noise: Optional[torch.Tensor] = None,
                  mean_type: ModelMeanType = ModelMeanType.EPSILON,
                  var_type: ModelVarType = ModelVarType.FIXED_SMALL,
                  clip_denoised: bool = True) -> Dict[str, torch.Tensor]:
    """The whole variational bound in bits per dimension: a loop over
    t = T-1 down to 0, each step's x_t drawn from `generator`, or taken from
    `noise` [T, *x_start.shape] (row i at t = T-1-i, the order of JAX's
    per-step keys). vb, xstart_mse and mse are [B, T], column i at t = T-1-i."""
    B, T = x_start.shape[0], sched.num_timesteps
    vb, xstart_mse, mse = [], [], []
    for i in range(T):
        t = torch.full((B,), T - 1 - i, dtype=torch.long, device=x_start.device)
        eps = (torch.randn(x_start.shape, generator=generator, dtype=x_start.dtype, device=x_start.device)
               if noise is None else noise[i])
        x_t = q_sample(sched, x_start, t, eps)
        out = vb_terms_bpd(sched, model_fn, x_start, x_t, t, mean_type=mean_type, var_type=var_type,
                           clip_denoised=clip_denoised)
        vb.append(out["output"])
        xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
        mse.append(mean_flat((pred_eps_from_xstart(sched, x_t, t, out["pred_xstart"]) - eps) ** 2))
    vb, xstart_mse, mse = (torch.stack(v, dim=1) for v in (vb, xstart_mse, mse))
    prior = prior_bpd(sched, x_start)
    return {"total_bpd": vb.sum(dim=1) + prior, "prior_bpd": prior, "vb": vb, "xstart_mse": xstart_mse, "mse": mse}
