"""Encoder-free 2D vision tokenizer (inference).

Counterpart of mla_tpu/models/vision_tokenizer.py: 672x672 RGB (+ mask
channel) -> 14x14 patchify as a matmul (48x48 grid at C=1024) -> windowed
3x3 local-attention pooling -> 16x16 = 256 tokens. The class-token global
attention is computed and discarded by the reference, so its parameters are
kept for layout parity and not run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from mla_tpu_torch import nn


@dataclass(frozen=True)
class VisionTokenizerConfig:
    image_size: int = 672
    patch_stride: int = 14
    conv_stride: int = 3
    hidden_dim: int = 1024
    num_heads: int = 8

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_stride

    @property
    def out_grid(self) -> int:
        return self.grid // self.conv_stride

    @property
    def num_tokens(self) -> int:
        return self.out_grid**2


def patchify(images: torch.Tensor, cfg: VisionTokenizerConfig) -> torch.Tensor:
    """[B, 3, S, S] -> [B, g, g, 3*p*p], flattened (c, kh, kw) like a torch
    Conv2d kernel."""
    B = images.shape[0]
    g, p = cfg.grid, cfg.patch_stride
    x = images.reshape(B, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, g, g, 3 * p * p)


def local_attention(p: Dict[str, Any], feats: torch.Tensor, cfg: VisionTokenizerConfig) -> torch.Tensor:
    """feats [B, 48, 48, C] -> [B, 256, C]: queries are the 3x3-averaged
    features, keys/values the 9 window elements, scale C**-0.5."""
    B, _, _, C = feats.shape
    s, og, H = cfg.conv_stride, cfg.out_grid, cfg.num_heads
    hd = C // H
    win = feats.reshape(B, og, s, og, s, C).permute(0, 1, 3, 2, 4, 5).reshape(B, og * og, s * s, C)
    reduced = win.mean(dim=2)
    q = nn.linear(p["q"], nn.layer_norm(p["q_ln"], reduced))
    kv = nn.linear(p["kv"], nn.layer_norm(p["kv_ln"], win))
    k, v = kv[..., :C], kv[..., C:]
    q = q.reshape(B, og * og, H, hd)
    k = k.reshape(B, og * og, s * s, H, hd)
    v = v.reshape(B, og * og, s * s, H, hd)
    scores = torch.einsum("bphd,bpnhd->bphn", (q * C**-0.5).float(), k.float())
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    agg = torch.einsum("bphn,bpnhd->bphd", attn, v).reshape(B, og * og, C)
    return reduced + nn.linear(p["proj"], agg)


def vision_tokenizer(params: Dict[str, Any], pixel_values: torch.Tensor, cfg: VisionTokenizerConfig) -> torch.Tensor:
    """pixel_values [B, 4, S, S] (RGB + full-frame mask) -> [B, 256, C]."""
    patches = patchify(pixel_values[:, :3], cfg)
    embeds = patches @ params["patch_embedding"]["w"].to(patches.dtype)
    return local_attention(params["local_attention"], embeds, cfg)
