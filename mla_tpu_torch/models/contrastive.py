"""Positional-correspondence contrastive losses on the decoder's
contrastive-layer hidden states.

Counterpart of mla_tpu/models/contrastive.py:
  * `coordinate_contrastive_loss`: InfoNCE between each valid point-cloud
    token and the image token at its 3D->2D-projected patch, over the whole
    batch. As in the JAX package the [B*N, B*N] logits keep their static
    shape: invalid columns are masked before the row log-sum-exp and
    invalid rows leave the mean, which equals the cross-entropy over the
    compacted matrix of valid pairs.
  * `tactile_contrastive_loss`: each tactile token against its sample's
    point-cloud tokens (positive: the one nearest the gripper) and image
    tokens (positive: that point's patch).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from mla_tpu_torch import nn

NEG_INF = -1e9


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def _masked_infonce(logits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Cross-entropy against the diagonal over valid rows and columns;
    logits [M, M] fp32, valid [M] bool. Mean over valid rows (0 if none)."""
    logits = torch.where(valid[None, :], logits, NEG_INF)
    per_row = torch.logsumexp(logits, dim=-1) - torch.diagonal(logits)
    return torch.where(valid, per_row, 0.0).sum() / valid.sum().clamp_min(1)


def coordinate_contrastive_loss(
    params: Dict[str, Any], image_features: torch.Tensor, pointcloud_features: torch.Tensor,
    patch_indices: torch.Tensor, valid_mask: torch.Tensor, temperature: float = 0.07,
) -> torch.Tensor:
    """image/pointcloud features [B, N, D] (N = 256 on the 16 x 16 grid),
    patch_indices [B, N, 2] (row, col), valid_mask [B, N] -> scalar loss,
    the mean of the point->image and image->point directions."""
    B, N, _ = image_features.shape
    patch_w = int(N**0.5)
    img = _l2norm(nn.proj_head(params["image_head"], image_features).float())
    pc = _l2norm(nn.proj_head(params["pointcloud_head"], pointcloud_features).float())
    idx = (patch_indices[..., 0] * patch_w + patch_indices[..., 1]).long()
    target = torch.gather(img, 1, idx[..., None].expand(-1, -1, img.shape[-1]))
    valid = valid_mask.reshape(B * N)
    logits = (pc.reshape(B * N, -1) @ target.reshape(B * N, -1).T) / temperature
    loss = (_masked_infonce(logits, valid) + _masked_infonce(logits.T, valid)) / 2.0
    return torch.where(valid.sum() > 0, loss, 0.0)


def tactile_contrastive_loss(
    params: Dict[str, Any], tac_features: torch.Tensor, pc_features: torch.Tensor, img_features: torch.Tensor,
    positive_pc_indices: torch.Tensor, positive_img_indices: torch.Tensor, temperature: float = 0.07,
) -> torch.Tensor:
    """tac_features [B, n_arms, D], pc/img features [B, 256, D], positive
    indices [B, n_arms, 1] -> scalar: the mean of the tactile->point and
    tactile->image cross-entropies."""
    tac = _l2norm(nn.proj_head(params["tactile_head"], tac_features).float())
    pc = _l2norm(nn.proj_head(params["pointcloud_head"], pc_features).float())
    img = _l2norm(nn.proj_head(params["image_head"], img_features).float())

    def ce(logits, labels):
        pos = torch.gather(logits, -1, labels.long())[..., 0]
        return (torch.logsumexp(logits, dim=-1) - pos).mean()

    loss_pc = ce(tac @ pc.transpose(1, 2) / temperature, positive_pc_indices)
    loss_img = ce(tac @ img.transpose(1, 2) / temperature, positive_img_indices)
    return (loss_pc + loss_img) / 2.0
