"""Action/timestep/condition embedders, the final layer and the point
projector of the diffusion head.

Counterpart of mla_tpu/models/embedders.py.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from mla_tpu_torch import nn


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """DiT sinusoidal embedding: [cos | sin] blocks."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def timestep_embedder(p: Dict[str, Any], t: torch.Tensor, freq_dim: int = 256) -> torch.Tensor:
    """t [B] -> [B, hidden]: sinusoidal -> Linear -> SiLU -> Linear."""
    return nn.linear(p["fc2"], nn.silu(nn.linear(p["fc1"], timestep_embedding(t, freq_dim))))


def action_embedder(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    return nn.mlp(p, x, act=nn.gelu_tanh)


def label_embedder(
    p: Dict[str, Any], conditions: torch.Tensor, *, dropout_prob: float = 0.0, training: bool = False,
    generator: Optional[torch.Generator] = None, force_drop_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """conditions [B, S, D]: replace whole rows' condition sequences by the
    broadcast `uncondition` vector: the rows with force_drop_ids == 1, or in
    training with dropout_prob > 0 the rows whose uniform draw from
    `generator` falls under dropout_prob."""
    if force_drop_ids is not None:
        drop = force_drop_ids == 1
    elif training and dropout_prob > 0:
        drop = torch.rand((conditions.shape[0],), generator=generator, device=conditions.device) < dropout_prob
    else:
        return conditions
    return torch.where(drop[:, None, None], p["uncondition"].to(conditions.dtype)[None], conditions)


def final_layer(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """RMSNorm (eps 1e-6) -> Mlp(hidden -> hidden -> out), GELU(tanh)."""
    return nn.mlp(p["mlp"], nn.rms_norm(p["norm"], x, 1e-6), act=nn.gelu_tanh)


def mlp_projector(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """gelu-mlp projector: Linear -> GELU(exact) -> Linear."""
    return nn.linear(p["fc2"], nn.gelu_exact(nn.linear(p["fc1"], x)))
