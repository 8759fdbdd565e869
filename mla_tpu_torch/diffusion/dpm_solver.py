"""DPM-Solver++(2M) for the action head.

Counterpart of mla_tpu/diffusion/dpm_solver.py: a second-order multistep
solver in data-prediction form (Lu et al., arXiv 2211.01095) with
`num_steps` model evaluations over the training schedule's noise levels;
the final step returns the x0 estimate.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from mla_tpu_torch.diffusion.gaussian import Schedule


def dpm_solver_pp_2m(sched: Schedule, denoise_fn: Callable, noise: torch.Tensor, *, num_steps: int = 4) -> torch.Tensor:
    """Evaluations uniform over the discrete training timesteps (the JAX
    package's default 'index' spacing; 4 over 100: 99, 66, 33, 0)."""
    n_train = len(sched.timestep_map)
    acp_all = np.asarray(sched.alphas_cumprod, np.float64)
    ts = np.unique(np.linspace(0, n_train - 1, num_steps).round().astype(int))[::-1]
    t_model_map = np.asarray(sched.timestep_map)[ts]
    acp = acp_all[ts]
    alpha, sigma = np.sqrt(acp), np.sqrt(1.0 - acp)
    lam = np.log(alpha / sigma)

    B = noise.shape[0]
    x = noise.float()
    x0_prev = h_prev = None
    for i in range(len(ts)):
        t_model = torch.full((B,), int(t_model_map[i]), dtype=torch.int32, device=x.device)
        eps = denoise_fn(x, t_model).float()
        x0 = (x - float(sigma[i]) * eps) / float(alpha[i])
        if i == len(ts) - 1:
            return x0
        h = lam[i + 1] - lam[i]
        if x0_prev is None:
            D = x0
        else:
            r = float(h_prev / h)
            D = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * x0_prev
        x = float(sigma[i + 1] / sigma[i]) * x - float(alpha[i + 1] * (np.exp(-h) - 1.0)) * D
        x0_prev, h_prev = x0, h
    return x
