r"""The composed multimodal model: config, the decoder family, the
fused-token front-end, the static splice and the full forward.

Counterpart of mla_tpu/models/prismatic.py. Token layout:

    [BOS | 256 PC | 256 img | extra views.. | tactile | prompt..]
           \________________ fused block _______________/

Diffusion mode splices [proprio, t, x_0..x_15] right before the tag token
(in training the last EOS) and reads noise_pred at the x positions. As in
the JAX package the sequence is assembled with one gather through an index
map from the batch's `splice_idx`, so every shape is static. In training
the contrastive losses read the decoder's contrastive-layer hidden states
and, in the post-training stage, the generation heads read its final ones.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import ModuleType
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from mla_tpu_torch import nn
from mla_tpu_torch.models import contrastive as contrastive_mod
from mla_tpu_torch.models import embedders
from mla_tpu_torch.models import generation as gen_mod
from mla_tpu_torch.models import llama as llama_mod
from mla_tpu_torch.models import phi as phi_mod
from mla_tpu_torch.models import point_tokenizer as pt_mod
from mla_tpu_torch.models import vision_tokenizer as vt_mod
from mla_tpu_torch.ops import pointops
from mla_tpu_torch.ops import projection as proj_ops


DECODERS = {"llama": llama_mod, "phi": phi_mod}


def get_decoder(cfg: "MLAModelConfig") -> ModuleType:
    """The decoder module of cfg.llm_family: 'llama' (Llama-2, and Mistral
    through GQA) or 'phi' (Phi-2). Each has init_kv_cache, forward,
    lm_head_logits and embed_tokens with llama's interface."""
    return DECODERS[cfg.llm_family]


@dataclass(frozen=True)
class MLAModelConfig:
    # the decoder's config: a LlamaConfig for llm_family 'llama', a
    # PhiConfig for 'phi' (the field name is the JAX package's)
    llm_family: str = "llama"
    llama: Any = field(default_factory=lambda: llama_mod.LLAMA2_7B)
    vision: vt_mod.VisionTokenizerConfig = field(default_factory=vt_mod.VisionTokenizerConfig)
    point: pt_mod.PointTokenizerConfig = field(default_factory=pt_mod.PointTokenizerConfig)
    gen: gen_mod.GenerationConfig = field(default_factory=gen_mod.GenerationConfig)

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
    tactile: Optional[torch.Tensor] = None, gripper_xyz: Optional[torch.Tensor] = None,
    *, training: bool = False, fps_start: Optional[Sequence[torch.Tensor]] = None,
) -> Dict[str, Any]:
    """images: {'front_image': [B, 4, S, S], extra views...}; tactile [B,
    n_arms * tactile_dim]?, gripper_xyz [B, n_arms * 3]?. Returns {'fused',
    'img_tokens', 'centers', 'patch_indices', 'valid_mask',
    'positive_pc_idx', 'positive_img_idx', 'state'}: the point centers'
    image patches and their validity pair the contrastive loss; with a
    tactile reading and gripper positions, each gripper's nearest point
    token (first on ties) and that token's image patch, [B, n_arms, 1], are
    the tactile loss's positives (else None); 'state' carries the point
    tokenizer's batch-norm state (moved in training). The image path
    computes in the decoder's compute dtype, the point and tactile paths in
    the dtype of their inputs; the fused block takes their promoted dtype,
    as jnp.concatenate does. Without a tactile reading the tactile slot is
    one zero token."""
    cdt = cfg.llama.compute_dtype
    images = {k: v.to(cdt) for k, v in images.items()}
    front = images["front_image"]
    B, D = front.shape[0], cfg.token_size
    img_tokens = nn.mlp_gelu(params["projector_2d"], vt_mod.vision_tokenizer(params["vision_tower_2d"], front, cfg.vision))

    new_state = dict(state)
    centers = None
    if cfg.use_pointcloud and point_cloud is not None:
        pc_raw, centers, new_state["vision_tower_3d"] = pt_mod.point_tokenizer(
            params["vision_tower_3d"], state["vision_tower_3d"], point_cloud, cfg.point,
            training=training, fps_start=fps_start,
        )
        pc_tokens = embedders.mlp_projector(params["projector_3d"], pc_raw)
        patch_indices, valid_mask = proj_ops.project_3d_to_2d(
            centers, proj_ops.get_camera_params(cfg.camera_name), (cfg.vision.image_size,) * 2,
            cfg.vision.patch_stride, cfg.vision.conv_stride,
        )
    else:
        pc_tokens = torch.zeros((B, cfg.num_pc_tokens, D), dtype=img_tokens.dtype, device=front.device)
        patch_indices = torch.zeros((B, cfg.num_pc_tokens, 2), dtype=torch.int32, device=front.device)
        valid_mask = torch.zeros((B, cfg.num_pc_tokens), dtype=torch.bool, device=front.device)

    parts = [pc_tokens, img_tokens]
    for view_key in sorted(k for k in images if k != "front_image"):
        view_raw = vt_mod.vision_tokenizer(params["vision_tower_2d"], images[view_key], cfg.vision)
        parts.append(nn.mlp_gelu(params["projector_2d"], view_raw))
    positive_pc_idx = positive_img_idx = None
    if cfg.use_tactile and tactile is not None:
        n = cfg.n_arms
        parts.append(embedders.action_embedder(params["tactile_embedder"], tactile.reshape(B, n, cfg.tactile_dim)))
        if centers is not None and gripper_xyz is not None:
            d = pointops.square_distance(gripper_xyz.reshape(B, n, 3), centers)
            positive_pc_idx = torch.argmin(d, dim=-1)[..., None]
            pi = torch.gather(patch_indices, 1, positive_pc_idx.expand(-1, -1, 2))
            positive_img_idx = (pi[..., 0] * cfg.vision.out_grid + pi[..., 1]).long()[..., None]
    else:
        parts.append(torch.zeros((B, 1, D), dtype=img_tokens.dtype, device=front.device))
    dtype = parts[0].dtype
    for p in parts[1:]:
        dtype = torch.promote_types(dtype, p.dtype)
    fused = torch.cat([p.to(dtype) for p in parts], dim=1)
    return {"fused": fused, "img_tokens": img_tokens, "centers": centers, "patch_indices": patch_indices,
            "valid_mask": valid_mask, "positive_pc_idx": positive_pc_idx, "positive_img_idx": positive_img_idx,
            "state": new_state}


def build_splice_map(L: int, F: int, d: int, splice_idx: torch.Tensor) -> torch.Tensor:
    """Index map [B, L + F + d] into the source [text(L) | fused(F) | diff(d)]:
    position 0 is text 0 (BOS), 1..F the fused block, then text 1..s-1, the
    d diffusion tokens, and text s..L-1, for splice_idx s."""
    j = torch.arange(L + F + d, device=splice_idx.device)[None, :]
    s = splice_idx.long()[:, None]
    idx = torch.zeros_like(j * s)
    idx = torch.where((j >= 1) & (j <= F), L + (j - 1), idx)
    idx = torch.where((j > F) & (j < F + s), j - F, idx)
    idx = torch.where((j >= F + s) & (j < F + s + d), L + F + (j - F - s), idx)
    return torch.where(j >= F + s + d, j - F - d, idx)


def _gather_seq(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src [B, N, ...], idx [B, S] -> [B, S, ...]."""
    if src.dim() == 2:
        return torch.gather(src, 1, idx)
    return torch.gather(src, 1, idx[..., None].expand(-1, -1, *src.shape[2:]))


def generation_block(
    params: Dict[str, Any], state: Dict[str, Any], cfg: MLAModelConfig, batch: Dict[str, Any],
    last_hidden: torch.Tensor, img_tokens: torch.Tensor, patch_indices: torch.Tensor,
    *, generator: Optional[torch.Generator] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Dict[str, Any]]:
    """The generation heads in training on the decoder's final hidden
    states: (outputs, losses, the heads' new state). The image head warps
    the front frame's patches; with cfg.use_roi its ROI is every point
    center's patch (dilated in the head), else the whole frame."""
    B, grid = last_hidden.shape[0], cfg.vision.out_grid
    roi_2d = torch.ones((B, grid, grid), dtype=torch.bool, device=last_hidden.device)
    curr_patches = None
    if cfg.gen.use_image:
        curr_patches = gen_mod.images_to_patches(batch["images"]["front_image"][:, :3], cfg.gen.image.image_patch_size)
        if cfg.use_roi:
            roi_2d = gen_mod.create_roi_mask_from_indices(patch_indices, grid)
    # as in the JAX package, the point head gets no current cloud
    outs, new_state = gen_mod.generation_manager_forward(
        params["generation_manager"], state.get("generation_manager", {}), cfg.gen, last_hidden,
        current_image_features=img_tokens, current_images_patches=curr_patches, current_point_cloud=None,
        roi_mask_2d=roi_2d, training=True, generator=generator,
    )
    losses = gen_mod.compute_generation_losses(
        cfg.gen, outs, next_images=batch.get("next_images"), next_point_cloud=batch.get("next_point_cloud"),
        next_tactile=batch.get("next_tactile"),
    )
    return outs, losses, new_state


def _logits_split(decoder: ModuleType, for_loss: bool) -> Dict[str, Any]:
    """A llama decoder's logits for the loss stay this rank's vocabulary
    slice under a tp group that split the lm_head (causal_lm_loss reduces
    them over the group); no tp group splits a phi head."""
    return {"gather_logits": not for_loss} if decoder is llama_mod else {}


def vlm_forward(
    params: Dict[str, Any], state: Dict[str, Any], cfg: MLAModelConfig, batch: Dict[str, Any],
    *, training: bool = False, use_diff: Optional[bool] = None, generator: Optional[torch.Generator] = None,
    remat: bool = False, fps_start: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The composed model on a batch of tensors: input_ids [B, L],
    attention_mask [B, L] bool, splice_idx [B], images {name: [B, 4, S, S]},
    point_cloud [B, N, 3]?, tactile?, gripper_xyz?, labels [B, L]?, in
    diffusion mode x [B, 16, action_dim], t [B], proprio [B, 1,
    action_dim], and for the generation heads next_images / next_point_cloud
    / next_tactile. A batch without images runs the language-only forward.
    `generator` draws the condition dropout (when cfg.class_dropout_prob >
    0) and the generation heads' dropout; `fps_start` are the point
    tokenizer's FPS starts. Returns (outputs, new_state): last_hidden,
    seq_mask, logits? (with labels under a tp group that split the lm_head,
    this rank's vocabulary slice), lm_loss?, in training img_pc_contrastive_loss,
    tactile_contrastive_loss (with tactile positives), generation_outputs
    and generation_losses (cfg.use_generation), and noise_pred
    (diffusion)."""
    use_diff = cfg.use_diff if use_diff is None else use_diff
    input_ids = batch["input_ids"]
    B, L = input_ids.shape
    bb = params["llm_backbone"]
    decoder = get_decoder(cfg)

    if not batch.get("images"):
        text_emb = decoder.embed_tokens(bb, input_ids)
        out = decoder.forward(bb, cfg.llama, text_emb, key_mask=batch["attention_mask"].bool(), remat=remat,
                              **_logits_split(decoder, batch.get("labels") is not None))
        outputs = {"last_hidden": out["last_hidden"], "logits": out["logits"]}
        if batch.get("labels") is not None:
            outputs["lm_loss"] = llama_mod.causal_lm_loss(out["logits"], batch["labels"])
        return outputs, state

    F = cfg.fused_len
    fused_out = get_fused_tokens(
        params, state, cfg, batch["images"], batch.get("point_cloud"), batch.get("tactile"),
        batch.get("gripper_xyz"), training=training, fps_start=fps_start,
    )
    new_state = fused_out["state"]
    fused = fused_out["fused"]
    if fused.shape[1] != F:
        raise ValueError(f"fused length {fused.shape[1]} != cfg.fused_len {F}")
    text_emb = decoder.embed_tokens(bb, input_ids)

    if use_diff and training and cfg.class_dropout_prob > 0:
        # condition dropout: the text and fused segments of a row share one
        # draw (the JAX package draws both from one key)
        cond = embedders.label_embedder(
            params["z_embedder"], torch.cat([text_emb, fused.to(text_emb.dtype)], dim=1),
            dropout_prob=cfg.class_dropout_prob, training=True, generator=generator,
        )
        text_emb, fused = cond[:, :L], cond[:, L:]

    if use_diff:
        proprio = embedders.action_embedder(params["proprio_embedder"], batch["proprio"].to(text_emb.dtype))
        x_emb = embedders.action_embedder(params["x_embedder"], batch["x"].to(text_emb.dtype))
        t_emb = embedders.timestep_embedder(params["t_embedder"], batch["t"])[:, None, :]
        diff_block = torch.cat([proprio, t_emb.to(text_emb.dtype), x_emb], dim=1)
    else:
        diff_block = text_emb.new_zeros((B, 0, cfg.token_size))
    d_len = diff_block.shape[1]

    splice_idx = batch["splice_idx"]
    idx_map = build_splice_map(L, F, d_len, splice_idx)
    seq_emb = _gather_seq(torch.cat([text_emb, fused.to(text_emb.dtype), diff_block], dim=1), idx_map)
    ones = torch.ones((B, F + d_len), dtype=torch.bool, device=seq_emb.device)
    seq_mask = _gather_seq(torch.cat([batch["attention_mask"].bool(), ones], dim=1), idx_map)
    labels = batch.get("labels")
    seq_labels = None
    if labels is not None:
        pad = torch.full((B, F + d_len), -100, dtype=labels.dtype, device=labels.device)
        seq_labels = _gather_seq(torch.cat([labels, pad], dim=1), idx_map)

    out = decoder.forward(
        bb, cfg.llama, seq_emb, key_mask=seq_mask, remat=remat,
        compute_logits=(seq_labels is not None) or not use_diff, **_logits_split(decoder, seq_labels is not None),
    )
    outputs: Dict[str, Any] = {"last_hidden": out["last_hidden"], "seq_mask": seq_mask}
    if "logits" in out:
        outputs["logits"] = out["logits"]
    if seq_labels is not None:
        outputs["lm_loss"] = llama_mod.causal_lm_loss(out["logits"], seq_labels)

    if cfg.use_contrastive and training:
        hmid = out["hidden_mid"]
        pc_end = 1 + cfg.num_pc_tokens
        img_end = pc_end + cfg.num_image_tokens
        pc_feats, img_feats = hmid[:, 1:pc_end], hmid[:, pc_end:img_end]
        outputs["img_pc_contrastive_loss"] = contrastive_mod.coordinate_contrastive_loss(
            params["contrastive"]["coord"], img_feats, pc_feats, fused_out["patch_indices"], fused_out["valid_mask"],
        )
        if cfg.use_tactile and fused_out["positive_pc_idx"] is not None:
            # the tactile slot follows the extra views
            tac_start = img_end + cfg.num_image_tokens * cfg.num_extra_views
            outputs["tactile_contrastive_loss"] = contrastive_mod.tactile_contrastive_loss(
                params["contrastive"]["tactile"], hmid[:, tac_start : tac_start + cfg.n_arms], pc_feats, img_feats,
                fused_out["positive_pc_idx"], fused_out["positive_img_idx"],
            )

    if cfg.use_generation and training:
        gen_outs, outputs["generation_losses"], gen_state = generation_block(
            params, state, cfg, batch, out["last_hidden"], fused_out["img_tokens"], fused_out["patch_indices"],
            generator=generator,
        )
        new_state = {**new_state, "generation_manager": gen_state}
        outputs["generation_outputs"] = gen_outs

    if use_diff:
        # final_layer is position-wise: read the 16 x-token hiddens first
        pos = (F + splice_idx.long() + 2)[:, None] + torch.arange(cfg.action_horizon, device=seq_emb.device)[None, :]
        x_hidden = _gather_seq(out["last_hidden"], pos)
        outputs["noise_pred"] = embedders.final_layer(params["final_layer"], x_hidden)
    return outputs, new_state
