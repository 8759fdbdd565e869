r"""The composed multimodal model (llama family): config, the fused-token
front-end, the static splice and the full forward.

Counterpart of mla_tpu/models/prismatic.py. Token layout:

    [BOS | 256 PC | 256 img | extra views.. | tactile | prompt..]
           \________________ fused block _______________/

Diffusion mode splices [proprio, t, x_0..x_15] right before the tag token
(in training the last EOS) and reads noise_pred at the x positions. As in
the JAX package the sequence is assembled with one gather through an index
map from the batch's `splice_idx`, so every shape is static. The generation
heads and the tactile contrastive loss are not ported yet; vlm_forward
raises on a config that needs them in training.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from mla_tpu_torch import nn
from mla_tpu_torch.models import contrastive as contrastive_mod
from mla_tpu_torch.models import embedders
from mla_tpu_torch.models import llama as llama_mod
from mla_tpu_torch.models import point_tokenizer as pt_mod
from mla_tpu_torch.models import vision_tokenizer as vt_mod
from mla_tpu_torch.ops import projection as proj_ops


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
    *, training: bool = False, fps_start: Optional[Sequence[torch.Tensor]] = None,
) -> Dict[str, Any]:
    """images: {'front_image': [B, 4, S, S], extra views...}. Returns
    {'fused', 'img_tokens', 'centers', 'patch_indices', 'valid_mask',
    'state'}: the point centers' image patches and their validity pair the
    contrastive loss; 'state' carries the point tokenizer's batch-norm
    state (moved in training). The image path computes in the decoder's
    compute dtype, the point path in fp32; the fused block takes their
    promoted dtype, as jnp.concatenate does. The tactile slot is the zero
    token, as in JAX when no tactile reading is given."""
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
    parts.append(torch.zeros((B, 1, D), dtype=img_tokens.dtype, device=front.device))
    dtype = parts[0].dtype
    for p in parts[1:]:
        dtype = torch.promote_types(dtype, p.dtype)
    fused = torch.cat([p.to(dtype) for p in parts], dim=1)
    return {"fused": fused, "img_tokens": img_tokens, "centers": centers, "patch_indices": patch_indices,
            "valid_mask": valid_mask, "state": new_state}


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


def vlm_forward(
    params: Dict[str, Any], state: Dict[str, Any], cfg: MLAModelConfig, batch: Dict[str, Any],
    *, training: bool = False, use_diff: Optional[bool] = None, generator: Optional[torch.Generator] = None,
    remat: bool = False, fps_start: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The composed model on a batch of tensors: input_ids [B, L],
    attention_mask [B, L] bool, splice_idx [B], images {name: [B, 4, S, S]},
    point_cloud [B, N, 3]?, labels [B, L]?, and in diffusion mode x [B, 16,
    action_dim], t [B], proprio [B, 1, action_dim]. A batch without images
    runs the language-only forward. `generator` draws the condition dropout
    (when cfg.class_dropout_prob > 0); `fps_start` are the point tokenizer's
    FPS starts. Returns (outputs, new_state): last_hidden, seq_mask,
    logits?, lm_loss?, img_pc_contrastive_loss (training), noise_pred
    (diffusion)."""
    use_diff = cfg.use_diff if use_diff is None else use_diff
    input_ids = batch["input_ids"]
    B, L = input_ids.shape
    bb = params["llm_backbone"]

    if not batch.get("images"):
        text_emb = llama_mod.embed_tokens(bb, input_ids)
        out = llama_mod.llama_forward(bb, cfg.llama, text_emb, key_mask=batch["attention_mask"].bool(), remat=remat)
        outputs = {"last_hidden": out["last_hidden"], "logits": out["logits"]}
        if batch.get("labels") is not None:
            outputs["lm_loss"] = llama_mod.causal_lm_loss(out["logits"], batch["labels"])
        return outputs, state

    if training and (cfg.use_generation or cfg.use_tactile):
        raise NotImplementedError("training with the generation heads or the tactile loss is not ported yet")
    F = cfg.fused_len
    fused_out = get_fused_tokens(
        params, state, cfg, batch["images"], batch.get("point_cloud"), training=training, fps_start=fps_start,
    )
    fused = fused_out["fused"]
    if fused.shape[1] != F:
        raise ValueError(f"fused length {fused.shape[1]} != cfg.fused_len {F}")
    text_emb = llama_mod.embed_tokens(bb, input_ids)

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

    out = llama_mod.llama_forward(
        bb, cfg.llama, seq_emb, key_mask=seq_mask, remat=remat,
        compute_logits=(seq_labels is not None) or not use_diff,
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
        outputs["img_pc_contrastive_loss"] = contrastive_mod.coordinate_contrastive_loss(
            params["contrastive"]["coord"], hmid[:, pc_end:img_end], hmid[:, 1:pc_end],
            fused_out["patch_indices"], fused_out["valid_mask"],
        )

    if use_diff:
        # final_layer is position-wise: read the 16 x-token hiddens first
        pos = (F + splice_idx.long() + 2)[:, None] + torch.arange(cfg.action_horizon, device=seq_emb.device)[None, :]
        x_hidden = _gather_seq(out["last_hidden"], pos)
        outputs["noise_pred"] = embedders.final_layer(params["final_layer"], x_hidden)
    return outputs, fused_out["state"]
