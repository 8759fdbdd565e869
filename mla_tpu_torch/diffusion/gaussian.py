"""Gaussian diffusion schedules and samplers for the action head.

Counterpart of mla_tpu/diffusion/gaussian.py (the sampling side and the
training forward process `q_sample`): squaredcos_cap_v2 betas, 100 train
steps, epsilon prediction, FIXED_SMALL variance, "ddimN" respacing (the
only respacing the policy uses). The
schedule tables are float64 numpy, cast to fp32 at use. The loops are
Python loops over a denoise closure.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch


def betas_for_alpha_bar(num_steps: int, alpha_bar: Callable[[float], float], max_beta: float = 0.999) -> np.ndarray:
    betas = []
    for i in range(num_steps):
        t1, t2 = i / num_steps, (i + 1) / num_steps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas, dtype=np.float64)


def cosine_betas(num_steps: int) -> np.ndarray:
    """The squaredcos_cap_v2 schedule."""
    return betas_for_alpha_bar(num_steps, lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2)


def space_timesteps(num_timesteps: int, respacing: str) -> set:
    """The original timesteps a "ddimN" respacing keeps (IDDPM respace)."""
    if not respacing.startswith("ddim"):
        raise ValueError(f"unsupported respacing {respacing!r}: only 'ddimN' is ported")
    desired_count = int(respacing[len("ddim"):])
    if desired_count == 1:
        return {50} if num_timesteps > 50 else {num_timesteps // 2}
    for i in range(1, num_timesteps):
        if len(range(0, num_timesteps, i)) == desired_count:
            return set(range(0, num_timesteps, i))
    raise ValueError(f"cannot create exactly {desired_count} steps with an integer stride")


@dataclass(frozen=True)
class Schedule:
    """Precomputed diffusion quantities (float64 numpy)."""

    betas: np.ndarray
    timestep_map: np.ndarray
    alphas_cumprod: np.ndarray = field(init=False)
    alphas_cumprod_prev: np.ndarray = field(init=False)
    sqrt_alphas_cumprod: np.ndarray = field(init=False)
    sqrt_one_minus_alphas_cumprod: np.ndarray = field(init=False)
    sqrt_recip_alphas_cumprod: np.ndarray = field(init=False)
    sqrt_recipm1_alphas_cumprod: np.ndarray = field(init=False)
    posterior_variance: np.ndarray = field(init=False)
    posterior_log_variance_clipped: np.ndarray = field(init=False)
    posterior_mean_coef1: np.ndarray = field(init=False)
    posterior_mean_coef2: np.ndarray = field(init=False)

    def __post_init__(self):
        betas = np.asarray(self.betas, dtype=np.float64)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas, axis=0)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        values = {
            "alphas_cumprod": acp,
            "alphas_cumprod_prev": acp_prev,
            "sqrt_alphas_cumprod": np.sqrt(acp),
            "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - acp),
            "sqrt_recip_alphas_cumprod": np.sqrt(1.0 / acp),
            "sqrt_recipm1_alphas_cumprod": np.sqrt(1.0 / acp - 1),
            "posterior_variance": post_var,
            "posterior_log_variance_clipped": (
                np.log(np.append(post_var[1], post_var[1:])) if len(post_var) > 1 else np.array([])
            ),
            "posterior_mean_coef1": betas * np.sqrt(acp_prev) / (1.0 - acp),
            "posterior_mean_coef2": (1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp),
        }
        for name, value in values.items():
            object.__setattr__(self, name, value)

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def create_schedule(timestep_respacing: str = "", diffusion_steps: int = 100) -> Schedule:
    """The cosine schedule, respaced when asked: respaced schedules
    recompute betas from the kept alphas_cumprod and carry the
    original-timestep map."""
    base_betas = cosine_betas(diffusion_steps)
    if not timestep_respacing:
        return Schedule(betas=base_betas, timestep_map=np.arange(diffusion_steps))
    use_timesteps = sorted(space_timesteps(diffusion_steps, timestep_respacing))
    base_acp = np.cumprod(1.0 - base_betas)
    last_acp, new_betas = 1.0, []
    for i in use_timesteps:
        new_betas.append(1 - base_acp[i] / last_acp)
        last_acp = base_acp[i]
    return Schedule(betas=np.array(new_betas), timestep_map=np.array(use_timesteps))


def _extract(arr: np.ndarray, t, broadcast_shape, device=None) -> torch.Tensor:
    """arr[t] as fp32, broadcastable to broadcast_shape: a tensor t [B]
    gathers on t's device; a Python int t (the samplers' loop index) fills
    [B, 1, ...] on `device` with the one value, so no table is copied to the
    card inside a serving call."""
    if isinstance(t, int):
        shape = (broadcast_shape[0],) + (1,) * (len(broadcast_shape) - 1)
        return torch.full(shape, float(np.float32(arr[t])), dtype=torch.float32, device=device)
    out = torch.as_tensor(np.asarray(arr, np.float32), device=t.device)[t.long()]
    return out.reshape(out.shape + (1,) * (len(broadcast_shape) - out.dim()))


def q_sample(sched: Schedule, x_start, t, noise):
    """A draw of q(x_t | x_0) from the given noise."""
    return (
        _extract(sched.sqrt_alphas_cumprod, t, x_start.shape) * x_start
        + _extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.shape) * noise
    )


def pred_xstart_from_eps(sched: Schedule, x_t, t, eps):
    return (
        _extract(sched.sqrt_recip_alphas_cumprod, t, x_t.shape, x_t.device) * x_t
        - _extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.shape, x_t.device) * eps
    )


def q_posterior_mean(sched: Schedule, x_start, x_t, t):
    return (
        _extract(sched.posterior_mean_coef1, t, x_t.shape, x_t.device) * x_start
        + _extract(sched.posterior_mean_coef2, t, x_t.shape, x_t.device) * x_t
    )


# denoise_fn: (x, t_model) -> eps, with t_model the original-process timestep [B]
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _model_eps(sched: Schedule, denoise_fn: DenoiseFn, x, t_scalar: int):
    """eps at local step t_scalar: the model sees the original timestep."""
    t_model = torch.full((x.shape[0],), int(sched.timestep_map[t_scalar]), dtype=torch.int32, device=x.device)
    return denoise_fn(x, t_model)


def ddim_sample_loop(sched: Schedule, denoise_fn: DenoiseFn, noise: torch.Tensor) -> torch.Tensor:
    """Deterministic DDIM (eta = 0) from t = T-1 down to 0."""
    x = noise
    for t in range(sched.num_timesteps - 1, -1, -1):
        eps = _model_eps(sched, denoise_fn, x, t)
        x0 = pred_xstart_from_eps(sched, x, t, eps)
        eps = (_extract(sched.sqrt_recip_alphas_cumprod, t, x.shape, x.device) * x - x0) / _extract(
            sched.sqrt_recipm1_alphas_cumprod, t, x.shape, x.device
        )
        alpha_bar_prev = _extract(sched.alphas_cumprod_prev, t, x.shape, x.device)
        x = x0 * torch.sqrt(alpha_bar_prev) + torch.sqrt(1 - alpha_bar_prev) * eps
    return x


def ddpm_step(sched: Schedule, denoise_fn: DenoiseFn, x: torch.Tensor, t_scalar: int, z: torch.Tensor) -> torch.Tensor:
    """One ancestral (DDPM, FIXED_SMALL) step at local timestep t_scalar with
    the given standard-normal draw z."""
    eps = _model_eps(sched, denoise_fn, x, t_scalar)
    x0 = pred_xstart_from_eps(sched, x, t_scalar, eps)
    mean = q_posterior_mean(sched, x0, x, t_scalar)
    log_var = _extract(sched.posterior_log_variance_clipped, t_scalar, x.shape, x.device)
    nonzero = float(t_scalar != 0)
    return mean + nonzero * torch.exp(0.5 * log_var) * z


def ddpm_sample_loop(sched: Schedule, denoise_fn: DenoiseFn, noise: torch.Tensor, *,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Ancestral sampler; the per-step draws come from `generator`."""
    x = noise
    for t_scalar in range(sched.num_timesteps - 1, -1, -1):
        z = torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        x = ddpm_step(sched, denoise_fn, x, t_scalar, z)
    return x
