"""Timestep samplers for diffusion training.

Counterpart of mla_tpu/diffusion/timestep_sampler.py: the uniform sampler
and the loss-second-moment resampler (timesteps drawn in proportion to the
root mean square of their recent losses once every timestep has a full
history, with importance weights 1 / (T p[t])). The resampler's state is a
dict of tensors, passed in and returned anew; the draws come from an
explicit torch.Generator.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def uniform_sample(generator: Optional[torch.Generator], batch: int, num_timesteps: int,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t [B] int64 uniform in [0, T), weights [B] = 1)."""
    t = torch.randint(0, num_timesteps, (batch,), generator=generator, device=device)
    return t, torch.ones((batch,), dtype=torch.float32, device=device)


def init_loss_second_moment_state(num_timesteps: int, history: int = 10, device=None) -> Dict[str, torch.Tensor]:
    return {
        "loss_history": torch.zeros((num_timesteps, history), dtype=torch.float32, device=device),
        "loss_counts": torch.zeros((num_timesteps,), dtype=torch.int32, device=device),
    }


def loss_second_moment_probs(state: Dict[str, torch.Tensor], uniform_prob: float = 0.001) -> torch.Tensor:
    """p [T]: sqrt(E[loss^2]) per timestep, normalized and mixed with
    `uniform_prob` of the uniform distribution, once every timestep's
    history is full; uniform before that."""
    hist = state["loss_history"]
    T, H = hist.shape
    if not bool((state["loss_counts"] == H).all()):
        return torch.full((T,), 1.0 / T, dtype=torch.float32, device=hist.device)
    w = torch.sqrt(torch.mean(hist**2, dim=-1))
    p = w / torch.clamp(w.sum(), min=1e-12)
    return p * (1 - uniform_prob) + uniform_prob / T


def loss_second_moment_sample(state: Dict[str, torch.Tensor], generator: Optional[torch.Generator], batch: int,
                              uniform_prob: float = 0.001,
                              override_t: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t [B], importance weights 1 / (T p[t])); `override_t` replaces the
    draw (the tests replay JAX's)."""
    probs = loss_second_moment_probs(state, uniform_prob)
    if override_t is None:
        t = torch.multinomial(probs, batch, replacement=True, generator=generator)
    else:
        t = torch.as_tensor(override_t, device=probs.device).long()
    return t, 1.0 / (probs.shape[0] * probs[t])


def update_loss_second_moment(state: Dict[str, torch.Tensor], t: torch.Tensor,
                              losses: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The new state with each timestep's latest losses: a row with a full
    history shifts left and takes the loss last, else the loss goes to its
    count's slot. A timestep drawn more than once in the batch takes the
    loss of its last occurrence and its count rises once (JAX's scatter,
    whose last write wins; here written out, since a repeated index in a
    CUDA index_put has no defined order)."""
    hist, counts = state["loss_history"].clone(), state["loss_counts"].clone()
    H = hist.shape[1]
    t = t.long().to(hist.device)
    order = torch.arange(t.shape[0], device=t.device)
    later_twin = ((t[:, None] == t[None, :]) & (order[None, :] > order[:, None])).any(dim=1)
    t, losses = t[~later_twin], losses.to(hist)[~later_twin]
    n = counts[t]
    rows = hist[t]
    shifted = torch.cat([rows[:, 1:], losses[:, None]], dim=1)
    appended = rows.clone()
    appended[torch.arange(t.shape[0], device=t.device), torch.clamp(n, max=H - 1).long()] = losses
    hist[t] = torch.where((n == H)[:, None], shifted, appended)
    counts[t] = torch.clamp(n + 1, max=H)
    return {"loss_history": hist, "loss_counts": counts}
