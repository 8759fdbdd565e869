"""The composed multimodal model: config and the fused-token front-end
(inference side, llama family).

Counterpart of mla_tpu/models/prismatic.py. The 3D->2D camera projection
and the contrastive and generation heads feed only training and are left to
the training slice, as is the generation config.

Fused block layout: [256 PC | 256 img | extra views.. | tactile], the same
order as the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from mla_tpu_torch import nn
from mla_tpu_torch.models import embedders
from mla_tpu_torch.models import llama as llama_mod
from mla_tpu_torch.models import point_tokenizer as pt_mod
from mla_tpu_torch.models import vision_tokenizer as vt_mod


@dataclass(frozen=True)
class MLAModelConfig:
    llm_family: str = "llama"
    llama: llama_mod.LlamaConfig = field(default_factory=lambda: llama_mod.LLAMA2_7B)
    vision: vt_mod.VisionTokenizerConfig = field(default_factory=vt_mod.VisionTokenizerConfig)
    point: pt_mod.PointTokenizerConfig = field(default_factory=pt_mod.PointTokenizerConfig)

    action_dim: int = 7
    future_action_window_size: int = 15
    past_action_window_size: int = 0
    class_dropout_prob: float = 0.0
    tactile_dim: int = 12

    use_diff: bool = True
    use_pointcloud: bool = True
    use_tactile: bool = False
    use_contrastive: bool = True
    use_generation: bool = False
    use_roi: bool = False

    camera_name: str = "rlbench_front"
    image_hidden_dim: int = 1024
    point_token_dim: int = 768
    num_extra_views: int = 0

    def __post_init__(self):
        if self.use_tactile and not self.use_pointcloud:
            raise ValueError(
                "use_tactile=True requires use_pointcloud=True: tactile "
                "contrastive positives are nearest point-cloud tokens"
            )

    @property
    def token_size(self) -> int:
        return self.llama.hidden_size

    @property
    def n_arms(self) -> int:
        return max(self.action_dim // 7, 1)

    @property
    def n_tac_tokens(self) -> int:
        return self.n_arms if self.use_tactile else 1

    @property
    def num_image_tokens(self) -> int:
        return self.vision.num_tokens

    @property
    def num_pc_tokens(self) -> int:
        return self.point.num_tokens

    @property
    def fused_len(self) -> int:
        return self.num_pc_tokens + self.num_image_tokens * (1 + self.num_extra_views) + self.n_tac_tokens

    @property
    def diff_block_len(self) -> int:
        return 2 + (self.future_action_window_size + 1)

    @property
    def action_horizon(self) -> int:
        return self.future_action_window_size + 1


def get_fused_tokens(
    params: Dict[str, Any], state: Dict[str, Any], cfg: MLAModelConfig,
    images: Dict[str, torch.Tensor], point_cloud: Optional[torch.Tensor],
) -> Dict[str, Any]:
    """images: {'front_image': [B, 4, S, S], extra views...}. Returns
    {'fused', 'img_tokens', 'centers'}. The image path computes in the
    decoder's compute dtype, the point path in fp32; the fused block takes
    their promoted dtype, as jnp.concatenate does. Inference requests carry
    no tactile reading, so the tactile slot is the zero token, as in JAX."""
    cdt = cfg.llama.compute_dtype
    images = {k: v.to(cdt) for k, v in images.items()}
    front = images["front_image"]
    B, D = front.shape[0], cfg.token_size
    img_tokens = nn.mlp_gelu(params["projector_2d"], vt_mod.vision_tokenizer(params["vision_tower_2d"], front, cfg.vision))

    centers = None
    if cfg.use_pointcloud and point_cloud is not None:
        pc_raw, centers = pt_mod.point_tokenizer(
            params["vision_tower_3d"], state["vision_tower_3d"], point_cloud, cfg.point
        )
        pc_tokens = embedders.mlp_projector(params["projector_3d"], pc_raw)
    else:
        pc_tokens = torch.zeros((B, cfg.num_pc_tokens, D), dtype=img_tokens.dtype, device=front.device)

    parts = [pc_tokens, img_tokens]
    for view_key in sorted(k for k in images if k != "front_image"):
        view_raw = vt_mod.vision_tokenizer(params["vision_tower_2d"], images[view_key], cfg.vision)
        parts.append(nn.mlp_gelu(params["projector_2d"], view_raw))
    parts.append(torch.zeros((B, 1, D), dtype=img_tokens.dtype, device=front.device))
    dtype = parts[0].dtype
    for p in parts[1:]:
        dtype = torch.promote_types(dtype, p.dtype)
    fused = torch.cat([p.to(dtype) for p in parts], dim=1)
    return {"fused": fused, "img_tokens": img_tokens, "centers": centers}
