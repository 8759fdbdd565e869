"""Standalone DiT action head (the legacy CogACT path).

Counterpart of mla_tpu/models/action_model.py: a small conditional DiT that
denoises action chunks from one LLM condition token, used by
MLAPolicy.predict_action_batch. x/t/z embedders -> [c | x tokens] + a
learned positional embedding -> pre-norm self-attention blocks -> the final
RMSNorm + MLP head; classifier-free guidance by the doubled batch.
`dit_init` draws the JAX init's distributions from a torch.Generator (the
values differ from JAX's); `params.from_jax` carries a JAX tree across.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import torch

from mla_tpu_torch import nn
from mla_tpu_torch.models import embedders


@dataclass(frozen=True)
class DiTConfig:
    in_channels: int = 7
    hidden_size: int = 384
    depth: int = 6
    num_heads: int = 4
    mlp_ratio: float = 4.0
    token_size: int = 4096           # condition width from the LLM
    future_action_window_size: int = 15
    past_action_window_size: int = 0
    class_dropout_prob: float = 0.1

    @property
    def seq_len(self) -> int:
        # the condition token and the current-action slot
        return self.future_action_window_size + self.past_action_window_size + 2


DIT_SIZES = {
    "DiT-S": dict(depth=6, hidden_size=384, num_heads=4),
    "DiT-B": dict(depth=12, hidden_size=768, num_heads=12),
    "DiT-L": dict(depth=24, hidden_size=1024, num_heads=16),
}


def dit_config(model_type: str = "DiT-B", **kw) -> DiTConfig:
    return DiTConfig(**{**DIT_SIZES[model_type], **kw})


def dit_init(cfg: DiTConfig, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """DiT parameters in the JAX tree's layout, drawn on `device` (the
    final fc2 is zero, as in the reference)."""
    g = torch.Generator(device=device).manual_seed(seed)
    D, C, hidden = cfg.hidden_size, cfg.in_channels, int(cfg.hidden_size * cfg.mlp_ratio)

    def normal(shape, std):
        return torch.randn(shape, generator=g, device=device) * std

    def linear(i, o, w_init="xavier", std=0.02):
        if w_init == "xavier":
            bound = math.sqrt(6.0 / (i + o))
            w = torch.rand((i, o), generator=g, device=device) * (2 * bound) - bound
        else:
            w = normal((i, o), std)
        return {"w": w, "b": torch.zeros((o,), device=device)}

    def block():
        return {"attn": {"qkv": linear(D, 3 * D), "proj": linear(D, D)},
                "fc1": linear(D, hidden), "fc2": linear(hidden, D)}

    return {
        "x_embedder": {"fc1": linear(C, D, "normal"), "fc2": linear(D, D, "normal")},
        "t_embedder": {"fc1": linear(256, D, "normal"), "fc2": linear(D, D, "normal")},
        "z_proj": linear(cfg.token_size, D, "normal"),
        "pos_embed": normal((cfg.seq_len, D), D**-0.5),
        "blocks": [block() for _ in range(cfg.depth)],
        # the reference zero-inits the final fc2
        "final_layer": {"norm": {"scale": torch.ones((D,), device=device)},
                        "mlp": {"fc1": linear(D, D), "fc2": {"w": torch.zeros((D, C), device=device),
                                                             "b": torch.zeros((C,), device=device)}}},
        "uncondition": (normal((1, cfg.token_size), 0.02) if cfg.class_dropout_prob > 0
                        else torch.zeros((1, cfg.token_size), device=device)),
    }


def dit_forward(params: Dict[str, Any], cfg: DiTConfig, x: torch.Tensor, t: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    """x [B, T, in_ch] noised actions, t [B], z [B, 1, token_size] the
    condition -> eps [B, T, in_ch] (inference: no condition dropout)."""
    xe = embedders.action_embedder(params["x_embedder"], x)
    te = embedders.timestep_embedder(params["t_embedder"], t)
    c = te[:, None, :] + nn.linear(params["z_proj"], z)
    h = torch.cat([c, xe], dim=1) + params["pos_embed"][None]
    for bp in params["blocks"]:
        h = h + nn.mha(bp["attn"], nn.layer_norm_noaffine(h), cfg.num_heads)
        hn = nn.layer_norm_noaffine(h)
        h = h + nn.linear(bp["fc2"], nn.gelu_tanh(nn.linear(bp["fc1"], hn)))
    return embedders.final_layer(params["final_layer"], h)[:, 1:, :]


def dit_forward_with_cfg(params: Dict[str, Any], cfg: DiTConfig, x: torch.Tensor, t: torch.Tensor,
                         z: torch.Tensor, cfg_scale: float) -> torch.Tensor:
    """Doubled-batch classifier-free guidance: the first half of z carries
    the condition, the second the uncondition."""
    half = x[: x.shape[0] // 2]
    eps = dit_forward(params, cfg, torch.cat([half, half], dim=0), t, z)
    cond, uncond = eps.chunk(2, dim=0)
    guided = uncond + cfg_scale * (cond - uncond)
    return torch.cat([guided, guided], dim=0)
