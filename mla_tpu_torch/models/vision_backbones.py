"""Legacy ViT vision backbones (CLIP, SigLIP, DINOv2 and the fused
DinoSigLIP).

Counterpart of mla_tpu/models/vision_backbones.py: the timm ViTs of the
Prismatic lineage that `models/load.load_openvla` returns in its `legacy`
tree. No prediction path runs them, in JAX or here; the composed model is
encoder-free (models/vision_tokenizer.py).

A functional ViT in timm's parameterization, so timm and OpenVLA state
dicts convert one to one (`convert_timm_vit`): a patchify linear, optional
cls and register tokens, learned position embeddings, pre-norm blocks, and
features taken from the second-to-last block (the Prismatic convention)
with the prefix tokens dropped. `vit_image_transform` resizes with the
port's Pillow-exact bicubic (vla/datasets.resize_bicubic), no Pillow.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from mla_tpu_torch import nn
from mla_tpu_torch import params as P


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    use_cls_token: bool = True
    num_reg_tokens: int = 0          # DINOv2 register tokens
    use_quick_gelu: bool = False     # CLIP's x * sigmoid(1.702 x)
    no_embed_class: bool = False     # timm: pos_embed covers the patches only, added before the prefix tokens
    use_layerscale: bool = False     # timm LayerScale (DINOv2, init_values 1e-5)
    pre_norm: bool = False           # timm norm_pre before block 0 (OpenAI CLIP)
    ln_eps: float = 1e-6

    @property
    def grid(self) -> int:
        # timm's stride-p convolution floors (384 // 14 = 27, the last 6 px unread)
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid**2

    @property
    def num_prefix_tokens(self) -> int:
        return int(self.use_cls_token) + self.num_reg_tokens


def _dino_cfg(image_size: int) -> ViTConfig:
    # timm vit_large_patch14_reg4_dinov2: 4 registers, no_embed_class, LayerScale
    return ViTConfig(image_size=image_size, width=1024, depth=24, num_heads=16,
                     num_reg_tokens=4, no_embed_class=True, use_layerscale=True)


VIT_CONFIGS: Dict[str, ViTConfig] = {
    # the Prismatic backbone ids
    "clip-vit-l": ViTConfig(width=1024, depth=24, num_heads=16, use_quick_gelu=True, pre_norm=True),
    "clip-vit-l-336px": ViTConfig(image_size=336, width=1024, depth=24, num_heads=16,
                                  use_quick_gelu=True, pre_norm=True),
    "siglip-vit-so400m": ViTConfig(width=1152, depth=27, num_heads=16, mlp_ratio=3.7362, use_cls_token=False),
    "siglip-vit-so400m-384px": ViTConfig(image_size=384, width=1152, depth=27, num_heads=16,
                                         mlp_ratio=3.7362, use_cls_token=False),
    "dinov2-vit-l": _dino_cfg(224),
    # a fused backbone builds both towers at its own resolution (equal
    # patch counts): 384 / 14 -> 27^2 = 729 as siglip-384, 336 -> 24^2 as clip-336
    "dinov2-vit-l-384px": _dino_cfg(384),
    "dinov2-vit-l-336px": _dino_cfg(336),
    "in1k-vit-l": ViTConfig(width=1024, depth=24, num_heads=16, patch_size=16),
}

# fused backbones: the two towers' ids, features concatenated in this order
# (dino first, as the reference concatenates)
FUSED_BACKBONES: Dict[str, Tuple[str, str]] = {
    "dinosiglip-vit-so-224px": ("dinov2-vit-l", "siglip-vit-so400m"),
    "dinosiglip-vit-so-384px": ("dinov2-vit-l-384px", "siglip-vit-so400m-384px"),
    "dinoclip-vit-l-336px": ("dinov2-vit-l-336px", "clip-vit-l-336px"),
}


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def vit_init(cfg: ViTConfig, seed: int = 0, device="cpu") -> Dict[str, Any]:
    """A seeded ViT tree with JAX vit_init's distributions (the values
    differ: the generators differ): torch-uniform patchify, normal(0.02)
    position, cls and register embeddings, xavier block linears with zero
    biases, unit norms, LayerScale gains of 1e-5."""
    it = P._Init(seed, device)
    n_pos = cfg.num_patches + (0 if cfg.no_embed_class else cfg.num_prefix_tokens)
    hidden = int(cfg.width * cfg.mlp_ratio)
    params: Dict[str, Any] = {
        "patch_embed": it.linear(3 * cfg.patch_size**2, cfg.width, w_init="torch"),
        "pos_embed": it.normal((1, n_pos, cfg.width), 0.02),
        "norm": it.norm(cfg.width),
    }
    blocks = []
    for _ in range(cfg.depth):
        bp = {"norm1": it.norm(cfg.width), "attn": P._mha(it, cfg.width), "norm2": it.norm(cfg.width),
              "fc1": it.linear(cfg.width, hidden), "fc2": it.linear(hidden, cfg.width)}
        if cfg.use_layerscale:
            bp["ls1"] = torch.full((cfg.width,), 1e-5, device=it.device)
            bp["ls2"] = torch.full((cfg.width,), 1e-5, device=it.device)
        blocks.append(bp)
    params["blocks"] = blocks
    if cfg.pre_norm:
        params["norm_pre"] = it.norm(cfg.width)
    if cfg.use_cls_token:
        params["cls_token"] = it.normal((1, 1, cfg.width), 0.02)
    if cfg.num_reg_tokens:
        params["reg_token"] = it.normal((1, cfg.num_reg_tokens, cfg.width), 0.02)
    return params


def _patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    B = images.shape[0]
    g, p = cfg.grid, cfg.patch_size
    # timm's stride-p convolution floors: the trailing pixels are cropped
    images = images[:, :, : g * p, : g * p]
    x = images.reshape(B, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, g * g, 3 * p * p)


def vit_forward(params: Dict[str, Any], cfg: ViTConfig, images: torch.Tensor, *, feature_layer: int = -2) -> torch.Tensor:
    """images [B, 3, H, W], normalized -> patch features [B, num_patches,
    width] from block `feature_layer` (the second-to-last by default),
    prefix tokens dropped."""
    B = images.shape[0]
    x = nn.linear(params["patch_embed"], _patchify(images, cfg))
    if cfg.no_embed_class:
        # positions cover the patches only and are added before the prefix
        # tokens, which get none
        x = x + params["pos_embed"].to(x.dtype)
    prefix = []
    if cfg.use_cls_token:
        prefix.append(params["cls_token"].expand(B, 1, cfg.width))
    if cfg.num_reg_tokens:
        prefix.append(params["reg_token"].expand(B, cfg.num_reg_tokens, cfg.width))
    if prefix:
        x = torch.cat([t.to(x.dtype) for t in prefix] + [x], dim=1)
    if not cfg.no_embed_class:
        x = x + params["pos_embed"].to(x.dtype)
    if cfg.pre_norm:
        x = nn.layer_norm(params["norm_pre"], x, cfg.ln_eps)

    act = _quick_gelu if cfg.use_quick_gelu else nn.gelu_exact
    n_blocks = cfg.depth + feature_layer + 1 if feature_layer < 0 else feature_layer + 1
    for bp in params["blocks"][:n_blocks]:
        h = nn.layer_norm(bp["norm1"], x, cfg.ln_eps)
        a = nn.mha(bp["attn"], h, cfg.num_heads)
        x = x + (a * bp["ls1"].to(a.dtype) if "ls1" in bp else a)
        h = nn.layer_norm(bp["norm2"], x, cfg.ln_eps)
        m = nn.linear(bp["fc2"], act(nn.linear(bp["fc1"], h)))
        x = x + (m * bp["ls2"].to(m.dtype) if "ls2" in bp else m)
    return x[:, cfg.num_prefix_tokens :]


def fused_vit_forward(params: Dict[str, Dict], cfgs: Dict[str, ViTConfig], images: Dict[str, torch.Tensor]):
    """The fused (DinoSigLIP-style) backbone: each tower on its own
    normalized view, features concatenated on the channel dim, the dino
    tower's first whatever the names' order."""
    names = sorted(params, key=lambda n: (0 if "dino" in n else 1, n))
    return torch.cat([vit_forward(params[n], cfgs[n], images[n]) for n in names], dim=-1)


def convert_timm_vit(sd, cfg: ViTConfig, prefix: str = "") -> Dict[str, Any]:
    """timm VisionTransformer state dict -> the ViT tree, each leaf in its
    source dtype. Keys: patch_embed.proj.{weight [W, 3, p, p], bias},
    cls_token, reg_token, pos_embed, norm_pre, blocks.N.{norm1, attn.qkv,
    attn.proj, norm2, mlp.fc1, mlp.fc2, ls1.gamma, ls2.gamma}, norm."""
    from mla_tpu_torch.models.convert import _lin, _ln

    def k(s):
        return f"{prefix}{s}"

    pw = sd[k("patch_embed.proj.weight")]  # [W, 3, p, p]
    params: Dict[str, Any] = {
        "patch_embed": {"w": pw.reshape(pw.shape[0], -1).t().contiguous(), "b": sd[k("patch_embed.proj.bias")]},
        "pos_embed": sd[k("pos_embed")],
        "norm": _ln(sd, k("norm")),
        "blocks": [],
    }
    if cfg.use_cls_token and k("cls_token") in sd:
        params["cls_token"] = sd[k("cls_token")]
    if cfg.num_reg_tokens and k("reg_token") in sd:
        params["reg_token"] = sd[k("reg_token")]
    if cfg.pre_norm and k("norm_pre.weight") in sd:
        params["norm_pre"] = _ln(sd, k("norm_pre"))
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        bp = {
            "norm1": _ln(sd, k(f"{b}.norm1")),
            "attn": {"qkv": _lin(sd, k(f"{b}.attn.qkv")), "proj": _lin(sd, k(f"{b}.attn.proj"))},
            "norm2": _ln(sd, k(f"{b}.norm2")),
            "fc1": _lin(sd, k(f"{b}.mlp.fc1")),
            "fc2": _lin(sd, k(f"{b}.mlp.fc2")),
        }
        if k(f"{b}.ls1.gamma") in sd:  # DINOv2's LayerScale gains
            bp["ls1"] = sd[k(f"{b}.ls1.gamma")]
            bp["ls2"] = sd[k(f"{b}.ls2.gamma")]
        params["blocks"].append(bp)
    return params


# --- image transforms (the reference's resize strategies) --------------------

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
SIGLIP_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
SIGLIP_STD = np.array([0.5, 0.5, 0.5], np.float32)


def vit_image_transform(
    image: np.ndarray, size: int, strategy: str = "resize-naive",
    mean: np.ndarray = CLIP_MEAN, std: np.ndarray = CLIP_STD,
) -> np.ndarray:
    """uint8 [H, W, 3] -> normalized float32 [3, size, size]: 'resize-naive'
    squashes, 'letterbox' first pads to a square with the mean colour
    (each channel int(mean * 255)) centered as Pillow's paste places it;
    then Pillow's bicubic resize, in the port's exact copy."""
    from mla_tpu_torch.vla.datasets import resize_bicubic

    if image.dtype != np.uint8:
        image = np.clip(image, 0, 255).astype(np.uint8)
    if strategy == "letterbox":
        h, w = image.shape[:2]
        m = max(w, h)
        canvas = np.empty((m, m, 3), np.uint8)
        canvas[:] = np.array([int(c * 255) for c in mean], np.uint8)
        top, left = (m - h) // 2, (m - w) // 2
        canvas[top:top + h, left:left + w] = image
        image = canvas
    arr = resize_bicubic(image, size, size).astype(np.float32) / 255.0
    return ((arr - mean) / std).transpose(2, 0, 1)
