"""Encoder-free 3D point tokenizer (Point-PN).

Counterpart of mla_tpu/models/point_tokenizer.py: raw-point embed (1x1 conv
+ BN + ReLU), two FPS+kNN stages with trigonometric positional geometry and
residual 1x1-conv blocks, a max-pool over neighbours, then Linear 384->768.
Runs in fp32 whatever the compute dtype, as the JAX version does. Serving
normalizes with the running statistics and starts FPS at point 0; training
normalizes with batch statistics, returns the moved running state, and
takes per-stage FPS start indices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

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


def _conv_bn(p, s, x, training):
    y, bn = nn.batch_norm(p["bn"], s["bn"], nn.linear(p["conv"], x), training)
    return y, {"bn": bn}


def _linear2(p, s, x, training):
    y, s1 = _conv_bn(p["net1"], s["net1"], x, training)
    y, s2 = _conv_bn(p["net2"], s["net2"], torch.relu(y), training)
    return torch.relu(y + x), {"net1": s1, "net2": s2}


def point_tokenizer(
    params: Dict[str, Any], state: Dict[str, Any], pointcloud: torch.Tensor, cfg: PointTokenizerConfig,
    *, training: bool = False, fps_start: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """pointcloud [B, N, 3] -> (tokens [B, 256, out_dim], centers [B, 256, 3],
    new_state). fps_start[stage] [B] are FPS start indices (default 0, the
    JAX package's deterministic serving mode)."""
    xyz = pointcloud.float()
    x, raw_s = _conv_bn(params["raw_embed"], state["raw_embed"], xyz, training)
    x = torch.relu(x)
    stages_s = []
    group_num = cfg.input_points
    for si in range(cfg.num_stages):
        group_num //= 2
        start = None if fps_start is None else fps_start[si]
        lc_xyz, lc_x, knn_xyz, knn_x = pointops.fps_knn(xyz, x, group_num, cfg.k_neighbors, start)
        offsets = knn_xyz - lc_xyz[:, :, None, :]
        max_vals = offsets.abs().amax(dim=2, keepdim=True)
        offsets = offsets / max_vals.clamp_min(1e-6)
        B, G, K, C = knn_x.shape
        expanded = torch.cat([knn_x, lc_x[:, :, None, :].expand(B, G, K, C)], dim=-1)
        w = expanded + _pose_geo(offsets, cfg.stage_dims[si], cfg.alpha, cfg.beta).to(expanded.dtype)
        blocks_s = []
        for bi in range(cfg.lga_blocks[si]):
            w, bs = _linear2(params["stages"][si]["blocks"][bi], state["stages"][si]["blocks"][bi], w, training)
            blocks_s.append(bs)
        stages_s.append({"blocks": blocks_s})
        x = w.amax(dim=2)
        xyz = lc_xyz
    return nn.linear(params["proj"], x), xyz, {"raw_embed": raw_s, "stages": stages_s}
