"""Encoder-free 3D point tokenizer (Point-PN), inference mode.

Counterpart of mla_tpu/models/point_tokenizer.py: raw-point embed (1x1 conv
+ BN + ReLU), two FPS+kNN stages with trigonometric positional geometry and
residual 1x1-conv blocks, a max-pool over neighbours, then Linear 384->768.
Runs in fp32 whatever the compute dtype, as the JAX version does; batch
norm uses its running statistics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from mla_tpu_torch import nn
from mla_tpu_torch.ops import pointops


@dataclass(frozen=True)
class PointTokenizerConfig:
    input_points: int = 1024
    num_stages: int = 2
    embed_dim: int = 96
    k_neighbors: int = 81
    alpha: float = 1000.0
    beta: float = 100.0
    lga_blocks: Tuple[int, ...] = (2, 1)
    dim_expansion: Tuple[int, ...] = (2, 2)
    out_dim: int = 768

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        dims, d = [], self.embed_dim
        for e in self.dim_expansion[: self.num_stages]:
            d *= e
            dims.append(d)
        return tuple(dims)

    @property
    def encoder_out_dim(self) -> int:
        return self.stage_dims[-1]

    @property
    def num_tokens(self) -> int:
        return self.input_points // (2**self.num_stages)


def _pose_geo(knn_xyz: torch.Tensor, out_dim: int, alpha: float, beta: float) -> torch.Tensor:
    """[B,G,K,3] normalized offsets -> [B,G,K,out_dim], coord-major x
    (sin block, cos block)."""
    feat_dim = out_dim // 6
    feat_range = torch.arange(feat_dim, dtype=torch.float32, device=knn_xyz.device)
    dim_embed = torch.pow(torch.tensor(alpha, dtype=torch.float32), feat_range / feat_dim)
    div = beta * knn_xyz[..., None] / dim_embed
    pos = torch.cat([torch.sin(div), torch.cos(div)], dim=-1)
    B, G, K = knn_xyz.shape[:3]
    return pos.reshape(B, G, K, out_dim)


def _conv_bn(p, s, x):
    return nn.batch_norm(p["bn"], s["bn"], nn.linear(p["conv"], x))


def _linear2(p, s, x):
    y = torch.relu(_conv_bn(p["net1"], s["net1"], x))
    y = _conv_bn(p["net2"], s["net2"], y)
    return torch.relu(y + x)


def point_tokenizer(
    params: Dict[str, Any], state: Dict[str, Any], pointcloud: torch.Tensor, cfg: PointTokenizerConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """pointcloud [B, N, 3] -> (tokens [B, 256, out_dim], centers [B, 256, 3]).
    FPS starts at point 0 (the JAX package's deterministic serving mode)."""
    xyz = pointcloud.float()
    x = torch.relu(_conv_bn(params["raw_embed"], state["raw_embed"], xyz))
    group_num = cfg.input_points
    for si in range(cfg.num_stages):
        group_num //= 2
        lc_xyz, lc_x, knn_xyz, knn_x = pointops.fps_knn(xyz, x, group_num, cfg.k_neighbors)
        offsets = knn_xyz - lc_xyz[:, :, None, :]
        max_vals = offsets.abs().amax(dim=2, keepdim=True)
        offsets = offsets / max_vals.clamp_min(1e-6)
        B, G, K, C = knn_x.shape
        expanded = torch.cat([knn_x, lc_x[:, :, None, :].expand(B, G, K, C)], dim=-1)
        w = expanded + _pose_geo(offsets, cfg.stage_dims[si], cfg.alpha, cfg.beta).to(expanded.dtype)
        for bi in range(cfg.lga_blocks[si]):
            w = _linear2(params["stages"][si]["blocks"][bi], state["stages"][si]["blocks"][bi], w)
        x = w.amax(dim=2)
        xyz = lc_xyz
    return nn.linear(params["proj"], x), xyz
