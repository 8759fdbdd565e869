"""Future multisensory generation heads of the post-training stage.

Counterpart of mla_tpu/models/generation.py. Three heads read the
decoder's final hidden states:
  * image: 128 learnable intent queries -> a 2-layer transformer decoder
    over the hidden states -> an MAE-style decoder over the 256 patch slots
    (mask tokens at the ROI) -> delta / alpha / offset heads -> a warp and
    blend of the current frame's 42 x 42 patches into the next frame's;
  * point cloud: project the hidden states to 1024, mean-pool, expand to
    128 group features, 4 pre-norm transformer blocks, a 1x1-conv head with
    batch norm -> 128 x 8 future points (plus the FPS centers of a current
    cloud, when one is given);
  * tactile: one query, a 2-layer decoder -> the 12-d next reading.
The decoder layers are post-norm with exact GELU (torch's
TransformerDecoderLayer); attention is the plain `nn.mha`, never the flash
kernel. Dropout is live only when a torch.Generator is given, as JAX's is
only with a key. The losses use masked means of static shape where the
reference indexes by the ROI.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from mla_tpu_torch import nn
from mla_tpu_torch.ops.chamfer import chamfer_distance_l2
from mla_tpu_torch.ops.pointops import furthest_point_sample, index_points


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: each entry kept with probability 1 - rate (a draw
    from `generator`) and scaled by 1 / (1 - rate); identity without a
    generator or at rate 0."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def decoder_layer(p, tgt, memory, num_heads: int, dropout: float = 0.1, generator=None):
    """Post-norm decoder layer: self-attention, cross-attention over
    `memory`, then linear2(dropout(gelu(linear1(x)))), each added and
    layer-normed."""
    x = nn.layer_norm(p["norm1"], tgt + _dropout(nn.mha(p["self_attn"], tgt, num_heads), dropout, generator))
    x = nn.layer_norm(
        p["norm2"], x + _dropout(nn.mha(p["cross_attn"], x, num_heads, kv=memory), dropout, generator)
    )
    ff = nn.linear(p["linear2"], _dropout(nn.gelu_exact(nn.linear(p["linear1"], x)), dropout, generator))
    return nn.layer_norm(p["norm3"], x + _dropout(ff, dropout, generator))


def transformer_decoder(layers: List[Dict[str, Any]], tgt, memory, num_heads, dropout=0.1, generator=None):
    x = tgt
    for lp in layers:
        x = decoder_layer(lp, x, memory, num_heads, dropout, generator)
    return x


def pc_block(p, x, pos, num_heads, dropout=0.1, generator=None):
    """Pre-norm self-attention block of the point head; `pos` is added to
    the attention's input only."""
    x_norm = nn.layer_norm(p["norm1"], x + pos if pos is not None else x)
    x = x + _dropout(nn.mha(p["attn"], x_norm, num_heads), dropout, generator)
    h = nn.linear(p["fc2"], _dropout(nn.gelu_exact(nn.linear(p["fc1"], nn.layer_norm(p["norm2"], x))), dropout,
                                     generator))
    return x + h


# --------------------------------------------------------------------------- #
# patch <-> image utilities
# --------------------------------------------------------------------------- #


def images_to_patches(images: torch.Tensor, patch_size: int = 42) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/p)(W/p), C p p], each patch flattened channel
    first."""
    B, C, H, W = images.shape
    g = H // patch_size
    x = images.reshape(B, C, g, patch_size, g, patch_size).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, g * g, C * patch_size * patch_size)


def patches_to_images(patches: torch.Tensor, patch_size: int = 42) -> torch.Tensor:
    B, num_patches, patch_dim = patches.shape
    g = math.isqrt(num_patches)
    C = patch_dim // (patch_size * patch_size)
    x = patches.reshape(B, g, g, C, patch_size, patch_size).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(B, C, g * patch_size, g * patch_size)


def dilate_mask(mask: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Boolean [B, H, W] max-pool dilation with same-size output (the
    padding never wins a max, as JAX's -inf padding)."""
    pad = (kernel_size - 1) // 2
    out = F.max_pool2d(mask.float()[:, None], kernel_size, stride=1, padding=pad)[:, 0]
    return out > 0.0


def create_roi_mask_from_indices(patch_indices: torch.Tensor, grid: int = 16) -> torch.Tensor:
    """[B, N, 2] (row, col) -> [B, grid, grid] bool, True at every listed
    patch (invalid points included: their indices are clamped to the
    grid)."""
    B, N, _ = patch_indices.shape
    b = torch.arange(B, device=patch_indices.device).repeat_interleave(N)
    mask = torch.zeros((B, grid, grid), dtype=torch.bool, device=patch_indices.device)
    mask[b, patch_indices[..., 0].reshape(-1).long(), patch_indices[..., 1].reshape(-1).long()] = True
    return mask


def translate_patches(patches_img: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Bilinear translation with border clamping: patches_img [P, C, ps,
    ps], offsets [P, 2] (tx, ty) in pixels; out(y, x) = in(y + ty, x + tx)."""
    P, C, ps, _ = patches_img.shape
    dev = patches_img.device
    yy = torch.arange(ps, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(ps, dtype=torch.float32, device=dev)[None, :]
    src_y = yy[None] + offsets[:, 1][:, None, None]
    src_x = xx[None] + offsets[:, 0][:, None, None]
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy, wx = (src_y - y0)[..., None], (src_x - x0)[..., None]

    def clampi(v):
        return v.clamp(0, ps - 1).long()

    y0i, y1i, x0i, x1i = clampi(y0), clampi(y0 + 1), clampi(x0), clampi(x0 + 1)
    pidx = torch.arange(P, device=dev)[:, None, None]

    def gather(yi, xi):
        return patches_img[pidx, :, yi, xi]  # [P, ps, ps, C]

    out = (gather(y0i, x0i) * (1 - wy) * (1 - wx) + gather(y0i, x1i) * (1 - wy) * wx
           + gather(y1i, x0i) * wy * (1 - wx) + gather(y1i, x1i) * wy * wx)
    return out.permute(0, 3, 1, 2)


# --------------------------------------------------------------------------- #
# image generation
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class ImageGenConfig:
    token_size: int = 4096
    num_gen_queries: int = 128
    decoder_layers: int = 3
    decoder_heads: int = 8
    image_patch_size: int = 42
    use_roi: bool = True
    roi_dilation_kernel_size: int = 3
    gen_delta_clip: float = 5.0
    max_patch_shift_pixels: int = 8
    use_patch_offset: bool = True
    num_patches: int = 256
    dropout: float = 0.1

    @property
    def patch_dim(self) -> int:
        return self.image_patch_size**2 * 3


def image_gen_forward(
    params: Dict[str, Any], cfg: ImageGenConfig, llm_hidden_states: torch.Tensor,
    current_image_features: torch.Tensor, current_images_patches: torch.Tensor, roi_mask_2d: torch.Tensor,
    *, generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """llm_hidden_states [B, S, D], current_image_features [B, 256, D] (the
    projected image tokens), current_images_patches [B, 256, patch_dim],
    roi_mask_2d [B, 16, 16] bool -> the generated patches and the heads'
    outputs."""
    B, D = llm_hidden_states.shape[0], cfg.token_size
    intent_q = params["image_gen_queries"].expand(B, cfg.num_gen_queries, D)
    intent = transformer_decoder(params["intent_decoder"], intent_q, llm_hidden_states, cfg.decoder_heads,
                                 cfg.dropout, generator)
    if cfg.use_roi:
        roi = dilate_mask(roi_mask_2d, cfg.roi_dilation_kernel_size).reshape(B, -1)
    else:
        roi = torch.ones((B, cfg.num_patches), dtype=torch.bool, device=llm_hidden_states.device)
    dec_in = torch.where(roi[..., None], params["mae_mask_token"].reshape(1, 1, D), current_image_features)
    dec_in = dec_in + params["mae_pos_embed"]
    feats = transformer_decoder(params["mae_decoder"], dec_in, intent, cfg.decoder_heads, cfg.dropout, generator)
    fn = nn.layer_norm(params["mae_patch_norm"], feats)
    delta = torch.tanh(nn.linear(params["mae_delta_head"], fn)) * cfg.gen_delta_clip
    alpha = torch.sigmoid(nn.linear(params["mae_alpha_head"], fn)[..., 0])
    offset = torch.tanh(nn.linear(params["mae_offset_head"], fn)) * float(cfg.max_patch_shift_pixels)
    return {
        "image_generation": _compose_patches(cfg, current_images_patches, delta, alpha, offset, roi),
        "generation_roi_mask": roi, "delta_all": delta, "alpha_all": alpha, "offset_all": offset,
    }


def _compose_patches(cfg: ImageGenConfig, curr_patches, delta, alpha, offset, roi):
    """Warp and blend: ROI patches become 0.05 (current + delta) + 0.95
    delta, the others the current patch shifted by `offset` (in fp32) plus
    delta; alpha (1 in the ROI) blends the prediction with the current
    patch."""
    B, P, _ = curr_patches.shape
    ps = cfg.image_patch_size
    curr_img = curr_patches.reshape(B * P, 3, ps, ps)
    if cfg.use_patch_offset:
        warped = translate_patches(curr_img.float(), offset.reshape(B * P, 2)).to(curr_img.dtype)
    else:
        warped = curr_img
    delta_img = delta.reshape(B * P, 3, ps, ps)
    gen_weight = 0.95
    roi_pred = (1 - gen_weight) * (curr_img + delta_img) + gen_weight * delta_img
    pred = torch.where(roi.reshape(B * P, 1, 1, 1), roi_pred, warped + delta_img)
    alpha_eff = torch.where(roi, torch.ones_like(alpha), alpha).reshape(B * P, 1, 1, 1)
    return (alpha_eff * pred + (1.0 - alpha_eff) * curr_img).reshape(B, P, -1)


# --------------------------------------------------------------------------- #
# point-cloud generation
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class PointGenConfig:
    token_size: int = 4096
    trans_dim: int = 1024
    decoder_layers: int = 4
    decoder_heads: int = 8
    group_size: int = 8
    num_groups: int = 128
    use_geometric_prior: bool = True
    dropout: float = 0.1


def point_gen_forward(
    params: Dict[str, Any], state: Dict[str, Any], cfg: PointGenConfig, last_hidden: torch.Tensor,
    current_pointcloud: Optional[torch.Tensor] = None, *, training: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """last_hidden [B, S, D] -> ({'pointcloud_coord_generation': [B, G *
    group_size, 3]}, new_state). The projected states are mean-pooled over
    all S positions, padding included. With a current cloud the deltas are
    offsets from its FPS centers (start 0)."""
    B = last_hidden.shape[0]
    agg = nn.linear(params["feature_projector"], last_hidden).mean(dim=1)
    x = nn.linear(params["seq_to_patch"], agg).reshape(B, cfg.num_groups, cfg.trans_dim)
    pos = params["pos_embed"].expand(B, cfg.num_groups, cfg.trans_dim)
    for bp in params["blocks"]:
        x = pc_block(bp, x, pos, cfg.decoder_heads, cfg.dropout, generator)
    h, new_bn = nn.batch_norm(params["pred_bn"], state["pred_bn"], nn.linear(params["pred_conv1"], x), training)
    deltas = nn.linear(params["pred_conv2"], torch.relu(h)).reshape(B, cfg.num_groups, cfg.group_size, 3)
    if cfg.use_geometric_prior and current_pointcloud is not None:
        centers = index_points(current_pointcloud, furthest_point_sample(current_pointcloud, cfg.num_groups).long())
        deltas = deltas + centers[:, :, None, :]
    return {"pointcloud_coord_generation": deltas.reshape(B, cfg.num_groups * cfg.group_size, 3)}, {"pred_bn": new_bn}


# --------------------------------------------------------------------------- #
# tactile generation
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class TactileGenConfig:
    token_size: int = 4096
    tactile_dim: int = 12
    decoder_layers: int = 2
    decoder_heads: int = 4
    dropout: float = 0.1


def tactile_gen_forward(
    params: Dict[str, Any], cfg: TactileGenConfig, llm_hidden_states: torch.Tensor,
    *, generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    B = llm_hidden_states.shape[0]
    query = params["tactile_query"].expand(B, 1, cfg.token_size)
    memory = nn.linear(params["feature_projector"], llm_hidden_states)
    dec = transformer_decoder(params["decoder"], query, memory, cfg.decoder_heads, cfg.dropout, generator)
    return {"tactile_generation": nn.linear(params["output_head"], dec[:, 0])}


# --------------------------------------------------------------------------- #
# the manager and the losses
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class GenerationConfig:
    token_size: int = 4096
    use_image: bool = False
    use_pointcloud: bool = False
    use_tactile: bool = False
    image: ImageGenConfig = field(default_factory=ImageGenConfig)
    point: PointGenConfig = field(default_factory=PointGenConfig)
    tactile: TactileGenConfig = field(default_factory=TactileGenConfig)


def generation_manager_forward(
    params: Dict[str, Any], state: Dict[str, Any], cfg: GenerationConfig, llm_hidden_states: torch.Tensor,
    current_image_features: Optional[torch.Tensor] = None, current_images_patches: Optional[torch.Tensor] = None,
    current_point_cloud: Optional[torch.Tensor] = None, roi_mask_2d: Optional[torch.Tensor] = None,
    *, training: bool = False, generator: Optional[torch.Generator] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """The enabled heads' outputs and the point head's new batch-norm
    state."""
    outs: Dict[str, torch.Tensor] = {}
    new_state: Dict[str, Any] = {}
    if cfg.use_image:
        outs.update(image_gen_forward(params["image_gen_module"], cfg.image, llm_hidden_states,
                                      current_image_features, current_images_patches, roi_mask_2d,
                                      generator=generator))
    if cfg.use_pointcloud:
        pc_out, new_state["pointcloud_gen_module"] = point_gen_forward(
            params["pointcloud_gen_module"], state["pointcloud_gen_module"], cfg.point, llm_hidden_states,
            current_point_cloud, training=training, generator=generator,
        )
        outs.update(pc_out)
    if cfg.use_tactile:
        outs.update(tactile_gen_forward(params["tactile_gen_module"], cfg.tactile, llm_hidden_states,
                                        generator=generator))
    return outs, new_state


def _masked_mean(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of the rows of err [B, P, D] where mask [B, P] is set: sum over
    them / max(count * D, 1)."""
    w = mask.to(err.dtype)[..., None]
    return (err * w).sum() / (w.sum() * err.shape[-1]).clamp_min(1.0)


def compute_generation_losses(
    cfg: GenerationConfig, generation_outputs: Dict[str, torch.Tensor], next_images: Optional[torch.Tensor] = None,
    next_point_cloud: Optional[torch.Tensor] = None, next_tactile: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """ROI MSE + 0.5 ROI L1, 0.01 background L1 and a -0.1 |delta| reward
    (image_gen_loss), the Chamfer L2 distance (point_cloud_gen_loss) and the
    tactile MSE, each in fp32, and their sum."""
    losses: Dict[str, torch.Tensor] = {}
    dev = next(iter(generation_outputs.values())).device if generation_outputs else None
    total = torch.zeros((), dtype=torch.float32, device=dev)
    out = generation_outputs
    if cfg.use_image and next_images is not None and "image_generation" in out:
        diff = out["image_generation"].float() - images_to_patches(next_images, cfg.image.image_patch_size).float()
        roi = out["generation_roi_mask"]
        roi_loss = _masked_mean(diff**2, roi) + 0.5 * _masked_mean(diff.abs(), roi)
        bg_l1 = 0.01 * _masked_mean(diff.abs(), ~roi)
        delta_reward = -0.1 * out["delta_all"].float().abs().mean()
        losses.update(image_roi_generation_loss=roi_loss, bg_consistency_loss=bg_l1,
                      delta_magnitude_reward=delta_reward, image_gen_loss=roi_loss + bg_l1 + delta_reward)
        total = total + roi_loss + bg_l1 + delta_reward
    if cfg.use_pointcloud and next_point_cloud is not None and "pointcloud_coord_generation" in out:
        losses["point_cloud_gen_loss"] = chamfer_distance_l2(out["pointcloud_coord_generation"].float(),
                                                             next_point_cloud.float())
        total = total + losses["point_cloud_gen_loss"]
    if cfg.use_tactile and next_tactile is not None and "tactile_generation" in out:
        losses["tactile_gen_loss"] = ((out["tactile_generation"].float() - next_tactile.float()) ** 2).mean()
        total = total + losses["tactile_gen_loss"]
    losses["total_generation_loss"] = total
    return losses
